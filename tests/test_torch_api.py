"""The port's training API on the CPU against the JAX package's:
validation sets loaded from text files, early stopping (param and
callback, ``first_metric_only``, ``min_delta``), the callbacks,
``feval`` and a callable objective, continued training
(``init_model``), ``pred_leaf`` and the bin-space traversal
``ops/predict.py:predict_leaf_binned`` that scores the validation sets.

Pairs, as in tests/test_torch_train.py: the port's mega path against
the JAX mega path in its XLA form (``tpu_megakernel=xla``,
``tpu_frontier_k=1``, ``min_data_in_leaf`` 10), and the port's
subtraction path against JAX's (``tpu_megakernel=off``,
``min_data_in_leaf`` 5: ROADMAP C's tie-free size).

Tolerances: leaf indices, ``best_iteration`` and tree structure
identical; eval histories and best scores rtol 1e-5 (f32 scores that
agree to atol 1e-5; AUC's sums run in f32 in JAX, f64 in the port);
leaf values rtol 1e-4 / atol 1e-5 and raw scores atol 1e-5 (the repo's
bar, __graft_entry__.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops.predict import predict_leaf_binned as jax_leaf_binned
from lightgbm_tpu.utils import log as jlog
from lightgbm_tpu_torch.ops.predict import (predict_leaf_binned,
                                            predict_leaf_binned_t)
from lightgbm_tpu_torch.utils import log as tlog
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# binary.train at 31 leaves meets an f32 tie (tests/test_torch_train.py)
CASES = {
    "binary": ("binary_classification/binary",
               {"objective": "binary", "num_leaves": 15,
                "metric": "binary_logloss,auc,binary_error"}, 14),
    "regression": ("regression/regression",
                   {"objective": "regression", "num_leaves": 31,
                    "lambda_l2": 1.0, "metric": "l2,l1,rmse"}, 10),
}
BODIES = {"mega": ({"tpu_megakernel": "xla", "tpu_frontier_k": 1}, {}, 10),
          "sub": ({"tpu_megakernel": "off", "tpu_frontier_k": 1},
                  {"tpu_megakernel": "off"}, 5)}


def _path(case, split):
    return os.path.join(ROOT, "examples", f"{CASES[case][0]}.{split}")


def _params(case, body):
    _, params, _ = CASES[case]
    jax_kw, port_kw, mdl = BODIES[body]
    base = dict(params, verbosity=-1, min_data_in_leaf=mdl)
    return dict(base, **jax_kw), dict(base, device_type="cpu", **port_kw)


def _train(mod, params, case, rounds, callbacks=(), **kw):
    """Train on ``case``'s .train file with its .test file (and the
    training set) as validation sets, both loaded by ``mod``'s own text
    loader; returns the booster and the record_evaluation dict."""
    d = mod.Dataset(_path(case, "train"))
    v = mod.Dataset(_path(case, "test"), reference=d)
    ev = {}
    b = mod.train(params, d, rounds, valid_sets=[d, v],
                  callbacks=[mod.record_evaluation(ev), *callbacks], **kw)
    b.num_trees()                     # materialize JAX's lagged trees
    return b, ev


def _valid_x(case):
    return np.loadtxt(_path(case, "test"))[:, 1:]


def _structure(t):
    n = t.num_nodes()
    return (t.num_leaves, t.split_feature[:n].tolist(),
            t.threshold_bin[:n].tolist(), t.threshold[:n].tolist(),
            t.decision_type[:n].tolist(), t.left_child[:n].tolist(),
            t.right_child[:n].tolist(), t.leaf_count.tolist(),
            t.internal_count.tolist())


def _same_trees(ja, tb):
    jt, tt = ja._gbdt.models, tb._gbdt.models
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        assert _structure(a) == _structure(b)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)


def _same_history(je, te):
    assert list(je) == list(te)
    for name in je:
        assert list(je[name]) == list(te[name])
        for metric in je[name]:
            np.testing.assert_allclose(te[name][metric], je[name][metric],
                                       rtol=1e-5)


# ---------------------------------------------------------------------------
# early stopping as a param, on both examples and both split paths
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module",
                params=[(c, b) for c in sorted(CASES) for b in BODIES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def es(request):
    case, body = request.param
    jp, tp = _params(case, body)
    rounds = CASES[case][2]
    jb, je = _train(lgb, dict(jp, early_stopping_round=3), case, rounds)
    tb, te = _train(lgt, dict(tp, early_stopping_round=3), case, rounds)
    return case, jb, je, tb, te


def test_early_stopping_eval_history_matches(es):
    case, jb, je, tb, te = es
    _same_history(je, te)
    assert list(te) == ["training", "valid_1"]
    metrics = CASES[case][1]["metric"].split(",")
    assert list(te["valid_1"]) == metrics


def test_early_stopping_best_iteration_and_score(es):
    case, jb, je, tb, te = es
    assert tb.best_iteration == jb.best_iteration > 0
    if case == "binary":              # it stops before its last round
        assert len(te["valid_1"]["auc"]) < CASES[case][2]
    assert list(tb.best_score) == list(jb.best_score)
    for name in jb.best_score:
        for metric, val in jb.best_score[name].items():
            np.testing.assert_allclose(tb.best_score[name][metric], val,
                                       rtol=1e-5)


def test_early_stopping_trees_match(es):
    _, jb, _, tb, _ = es
    _same_trees(jb, tb)


def test_valid_scores_match_predict_and_jax(es):
    """The validation scores, grown a tree at a time on the device,
    equal a fresh raw prediction of the validation rows and JAX's."""
    case, jb, _, tb, _ = es
    Xv = _valid_x(case)
    vs = tb._gbdt.valid_scores[0].numpy()
    np.testing.assert_allclose(
        vs, tb.predict(Xv, raw_score=True, num_iteration=-1), rtol=0,
        atol=1e-5)
    np.testing.assert_allclose(vs, np.asarray(jb._gbdt.valid_scores[0]),
                               rtol=0, atol=1e-5)


def test_pred_leaf_equals_jax(es):
    case, jb, _, tb, _ = es
    Xv = _valid_x(case)
    for kw in ({}, {"start_iteration": 2, "num_iteration": 3}):
        got = tb.predict(Xv, pred_leaf=True, **kw)
        want = np.asarray(jb.predict(Xv, pred_leaf=True, **kw))
        assert got.dtype == np.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# callbacks: early stopping as a callback with first_metric_only and
# min_delta, record_evaluation, log_evaluation and reset_parameter
# ---------------------------------------------------------------------------
def _lr(i):
    return 0.2 * 0.9 ** i


# JAX's fused iteration bakes the learning rate in when it is set up, so
# reset_parameter reaches its trees' shrinkage but not its train and
# valid scores (ROADMAP C); its eager iteration (tpu_fused_iteration
# off) moves the scores by the new rate, as the reference and the port do
@pytest.fixture(scope="module")
def cb():
    out = {}
    for name, mod, log in (("jax", lgb, jlog), ("port", lgt, tlog)):
        lines = []
        log.register_callback(lines.append)
        try:
            jp, tp = _params("binary", "mega")
            params = dict(dict(jp, tpu_fused_iteration=False)
                          if name == "jax" else tp, verbosity=1,
                          metric="auc,binary_logloss")
            b, ev = _train(mod, params, "binary", 30, callbacks=[
                mod.early_stopping(4, first_metric_only=True,
                                   verbose=False, min_delta=2e-3),
                mod.log_evaluation(2),
                mod.reset_parameter(learning_rate=_lr)])
        finally:
            log.register_callback(None)
            log.set_verbosity(-1)
        evals = [ln.split("[Info] ", 1)[1].rstrip("\n") for ln in lines
                 if "[Info] [" in ln and "\t" in ln]
        out[name] = (b, ev, evals)
    return out


def test_callbacks_record_and_stop_as_jax(cb):
    (jb, je, _), (tb, te, _) = cb["jax"], cb["port"]
    _same_history(je, te)
    assert tb.best_iteration == jb.best_iteration > 0
    # first_metric_only: auc of the validation set decides, and with
    # min_delta the run stops well before its 30 rounds
    assert len(te["valid_1"]["auc"]) < 30
    assert set(tb.best_score["valid_1"]) == set(jb.best_score["valid_1"])


def test_log_evaluation_lines_as_jax(cb):
    (_, _, jl), (_, _, tl) = cb["jax"], cb["port"]
    assert len(tl) == len(jl) > 2
    for a, b in zip(jl, tl):
        assert a.split("\t")[0] == b.split("\t")[0]
        ja = [float(x.rsplit(": ", 1)[1]) for x in a.split("\t")[1:]]
        tb_ = [float(x.rsplit(": ", 1)[1]) for x in b.split("\t")[1:]]
        np.testing.assert_allclose(tb_, ja, rtol=1e-5)
    assert tl[0].startswith("[2]\ttraining's auc: ")


def test_reset_parameter_gives_jax_trees(cb):
    (jb, _, _), (tb, _, _) = cb["jax"], cb["port"]
    _same_trees(jb, tb)
    assert [t.shrinkage for t in tb._gbdt.models] == pytest.approx(
        [_lr(i) for i in range(tb.num_trees())])
    assert tb._gbdt.learner.cfg.learning_rate == 0.1   # captured params


# ---------------------------------------------------------------------------
# feval and a callable objective
# ---------------------------------------------------------------------------
def _fobj(seen):
    def fobj(score, dataset):
        seen.append(np.array(score))
        y = dataset.get_label()
        p = 1.0 / (1.0 + np.exp(-np.asarray(score, np.float64)))
        return p - y, p * (1.0 - p)
    return fobj


def _feval(score, dataset):
    y = dataset.get_label()
    p = 1.0 / (1.0 + np.exp(-np.asarray(score, np.float64)))
    return [("my_error", float(np.mean((p > 0.5) != (y > 0.5))), False),
            ("my_mean", float(np.mean(score)), True)]


@pytest.fixture(scope="module")
def custom():
    out = {}
    for name, mod in (("jax", lgb), ("port", lgt)):
        jp, tp = _params("binary", "mega")
        seen = []
        params = dict(jp if name == "jax" else tp, objective=_fobj(seen),
                      metric="None")
        b, ev = _train(mod, params, "binary", 4, feval=_feval)
        out[name] = (b, ev, seen)
    return out


def test_custom_objective_and_feval_as_jax(custom):
    (jb, je, js), (tb, te, ts) = custom["jax"], custom["port"]
    _same_trees(jb, tb)
    _same_history(je, te)
    assert list(te["valid_1"]) == ["my_error", "my_mean"]
    assert len(ts) == len(js) == 4
    for a, b in zip(js, ts):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def test_fobj_sees_scores_in_user_order(custom):
    """After 3 trees the carrier's rows are permuted three times; the
    scores handed to fobj are still in the user's row order."""
    tb, _, seen = custom["port"]
    X = np.loadtxt(_path("binary", "train"))[:, 1:]
    np.testing.assert_allclose(
        seen[3], tb.predict(X, raw_score=True, num_iteration=3), rtol=0,
        atol=1e-5)
    assert tb._gbdt.objective is None and tb._gbdt.init_scores == [0.0]


def test_objective_none_without_fobj_raises():
    d = lgt.Dataset(np.random.RandomState(0).normal(size=(50, 3)),
                    label=np.arange(50) % 2)
    b = lgt.Booster({"objective": "none", "device_type": "cpu",
                     "verbosity": -1}, d)
    with pytest.raises(ValueError, match="fobj"):
        b.update()


# ---------------------------------------------------------------------------
# init_model: continued training
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cont(tmp_path_factory):
    jp, tp = _params("binary", "mega")
    X = np.loadtxt(_path("binary", "train"))[:, 1:]
    tbase, _ = _train(lgt, tp, "binary", 3)
    jbase, _ = _train(lgb, jp, "binary", 3)
    path = str(tmp_path_factory.mktemp("cont") / "port.txt")
    tbase.save_model(path)
    port_str, jax_str = tbase.model_to_string(), jbase.model_to_string()
    runs = {}
    for name, init in (("string", port_str), ("file", path),
                       ("booster", tbase), ("jax_model", jax_str)):
        runs[name] = _train(lgt, tp, "binary", 3, init_model=init)[0]
    for name, init in (("jax_from_port", port_str),
                       ("jax_from_jax", jax_str)):
        runs[name] = _train(lgb, jp, "binary", 3, init_model=init)[0]
    return X, runs


def test_continued_training_forms_agree(cont):
    """From a string, a file or a Booster: the same model text for the
    three trees taken over (a tree loaded from text has no bin
    thresholds) and the same three new trees."""
    _, runs = cont
    ref = runs["string"]
    assert ref.num_trees() == 6
    for name in ("file", "booster"):
        b = runs[name]
        assert [t.to_string(i) for i, t in enumerate(b._gbdt.models[:3])] == \
            [t.to_string(i) for i, t in enumerate(ref._gbdt.models[:3])]
        for x, y in zip(ref._gbdt.models[3:], b._gbdt.models[3:]):
            assert _structure(x) == _structure(y)
            np.testing.assert_array_equal(x.leaf_value, y.leaf_value)


@pytest.mark.parametrize("port,jax", [("string", "jax_from_port"),
                                      ("jax_model", "jax_from_jax")])
def test_continued_training_matches_jax(cont, port, jax):
    X, runs = cont
    tb, jb = runs[port], runs[jax]
    _same_trees(jb, tb)
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["string", "jax_model"])
def test_continued_scores_equal_predict(cont, name):
    X, runs = cont
    tb = runs[name]
    np.testing.assert_allclose(tb._gbdt.scores.numpy(),
                               tb.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tb._gbdt.valid_scores[0].numpy(),
                               tb.predict(_valid_x("binary"), raw_score=True),
                               rtol=0, atol=1e-5)


def test_valid_set_on_continued_gbdt_needs_init_predictions(cont):
    _, runs = cont
    g = runs["string"]._gbdt
    with pytest.raises(ValueError, match="continued booster"):
        g.add_valid_data(runs["string"]._valid_sets[0]._inner)


# ---------------------------------------------------------------------------
# predict_leaf_binned against JAX's on synthetic trees
# ---------------------------------------------------------------------------
def _random_tree(rng, nn, nbins, chain=False):
    """Node arrays of a random tree of ``nn`` internal nodes over groups
    of ``nbins`` bins (a chain when ``chain``: depth nn)."""
    left, right = np.zeros(nn, np.int32), np.zeros(nn, np.int32)
    slots = []
    for i in range(nn):
        if i:
            p, side = slots.pop(-1 if chain else rng.randint(len(slots)))
            (left if side == 0 else right)[p] = i
        slots += [(i, 0), (i, 1)]
    for leaf, (p, side) in enumerate(slots):
        (left if side == 0 else right)[p] = -(leaf + 1)
    col = rng.randint(len(nbins), size=nn).astype(np.int32)
    nb = nbins[col]
    return {"col": col, "left": left, "right": right,
            "bin_start": rng.randint(0, 4, nn).astype(np.int32),
            "is_bundled": (rng.rand(nn) < 0.3).astype(np.int32),
            "num_bin": nb.astype(np.int32),
            "default_bin": rng.randint(0, nb).astype(np.int32),
            "missing_type": rng.randint(0, 3, nn).astype(np.int32),
            "threshold": rng.randint(0, nb - 1).astype(np.int32),
            "default_left": rng.rand(nn) < 0.5}


@pytest.mark.parametrize("nn,chain", [(0, False), (1, False), (14, False),
                                      (30, False), (12, True)])
def test_predict_leaf_binned_equals_jax(nn, chain):
    """Exact leaf indices for missing types none / zero / NaN (the NaN
    bin num_bin - 1 occurs), bundled columns, a stump and a chain of
    depth 12."""
    rng = np.random.RandomState(nn + 100 * chain)
    nbins = np.asarray([2, 5, 17, 64, 255])
    binned = np.stack([rng.randint(0, b, 700) for b in nbins], 1).astype(
        np.uint8)
    # a stump's JAX record keeps its arrays at their full length
    node = _random_tree(rng, max(nn, 1), nbins, chain)
    want = np.asarray(jax_leaf_binned(
        jnp.asarray(binned), dict({k: jnp.asarray(v) for k, v in node.items()},
                                  num_nodes=jnp.int32(nn))))
    node = {k: v[:nn] for k, v in node.items()}
    got = predict_leaf_binned(torch.as_tensor(binned), node)
    np.testing.assert_array_equal(got.numpy(), want)
    got_t = predict_leaf_binned_t(torch.as_tensor(binned.T.copy()), node)
    np.testing.assert_array_equal(got_t.numpy(), want)
    if nn:
        assert len(np.unique(want)) > 1


# ---------------------------------------------------------------------------
# AUC and average precision against a numpy float64 oracle and JAX's
# ---------------------------------------------------------------------------
def _np_auc(s, y, w):
    """Weighted AUC by pairs in float64: a positive above a negative
    counts its weights' product, a tie half of it."""
    pos, neg = y > 0, y <= 0
    sp, sn = s[pos][:, None], s[neg][None, :]
    wpn = w[pos][:, None] * w[neg][None, :]
    return float(np.sum(wpn * ((sp > sn) + 0.5 * (sp == sn))) / np.sum(wpn))


def _np_ap(s, y, w):
    order = np.argsort(-s, kind="stable")
    yy, ww = y[order], w[order]
    pw = ww * (yy > 0)
    return float(np.sum(np.cumsum(pw) / np.cumsum(ww) * pw) / np.sum(pw))


@pytest.mark.parametrize("weighted", [False, True])
def test_auc_and_average_precision_against_numpy_f64(weighted):
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.dataset import Metadata as JMeta
    from lightgbm_tpu.models import metric as jm
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.dataset import Metadata
    from lightgbm_tpu_torch.models import metric as tm
    rng = np.random.RandomState(5)
    n = 1500
    y = (rng.rand(n) < 0.3).astype(np.float32)
    # coarse scores: many ties within and across the labels
    s = (np.round(rng.normal(size=n) + y, 1)).astype(np.float32)
    w = (rng.uniform(0.2, 3.0, n).astype(np.float32) if weighted
         else np.ones(n, np.float32))
    for name, oracle, tol in (("auc", _np_auc, 1e-12),
                              ("average_precision", _np_ap, 1e-12)):
        md, jmd = Metadata(n), JMeta(n)
        for m in (md, jmd):
            m.set_label(y)
            m.set_weight(w if weighted else None)
        tmet = tm.create_metrics(Config({"metric": name}))[0]
        tmet.init(md, "cpu")
        got = tmet.eval(torch.as_tensor(s), None)[0][1]
        want = oracle(s.astype(np.float64), y, w.astype(np.float64))
        np.testing.assert_allclose(got, want, rtol=tol)
        jmet = jm.create_metrics(JConfig({"metric": name}))[0]
        jmet.init(jmd)
        np.testing.assert_allclose(
            got, jmet.eval(jnp.asarray(s), None)[0][1], rtol=1e-5)


def test_named_training_set_and_create_valid():
    """A user-named training set keeps its name in the eval rows, and
    early stopping never stops on it; ``create_valid`` bins like the
    training set."""
    rng = np.random.RandomState(2)
    X = rng.normal(size=(600, 4))
    y = (X[:, 0] + 0.3 * rng.normal(size=600) > 0).astype(float)
    d = lgt.Dataset(X[:400], label=y[:400])
    v = d.create_valid(X[400:], label=y[400:])
    ev = {}
    b = lgt.train({"objective": "binary", "num_leaves": 7, "verbosity": -1,
                   "device_type": "cpu", "metric": "binary_logloss",
                   "early_stopping_round": 2, "first_metric_only": True},
                  d, 40, valid_sets=[d, v], valid_names=["train", "test"],
                  callbacks=[lgt.record_evaluation(ev)])
    assert list(ev) == ["train", "test"] and b._train_data_name == "train"
    test_loss = ev["test"]["binary_logloss"]
    assert b.best_iteration == int(np.argmin(test_loss)) + 1
    assert len(test_loss) == b.best_iteration + 2 < 40
    assert b.best_score["test"]["binary_logloss"] == min(test_loss)
    assert v._inner.bin_mappers is d._inner.bin_mappers
    np.testing.assert_array_equal(
        v._inner.binned, d._inner.bin_matrix(X[400:]))
