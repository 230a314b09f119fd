"""Learning to rank end to end: ``lightgbm_tpu_torch.train``
(``device_type`` cpu) against the JAX package on ``examples/lambdarank``
(a LibSVM file with ``qid:`` runs) and ``examples/xendcg`` (a TSV file
with ``rank.train.query`` as ``group``), 10 trees each: lambdarank,
lambdarank with positions, with bagging, with GOSS and with quantized
gradients, and rank_xendcg plain and quantized with bagging, each port
booster on the mega body (K=1, and the frontier at K=4 once) and on the
histogram-subtraction body against one JAX booster (its default K=1
trees).  The query groups come from the ``qid:`` file path,
``Dataset(group=)`` and ``Dataset.set_group``.

``compare`` walks the trees in the order made, with the repo's tie rule
(ROADMAP section C) and two more causes a ranking run can meet, each
ending the walk where it is met:

  * every split partitions the training rows as JAX's does and every
    tree has its leaf values within rtol 1e-4 / atol 1e-5; the first
    split that parts must tie exactly, its two choices' gains recounted
    in f64 from the gradients the port's tree summed agreeing to 1e-9 of
    the gains' mass;
  * an order tie (lambdarank, whose lambdas follow each query's sorted
    order; XE-NDCG's softmax does not sort): before a tree, the two
    packages' training scores rank some query's documents in another
    order.  Each pair ranked apart
    must tie to f32 resolution in both packages (scores within 1e-6):
    documents in leaves whose values are equal in exact arithmetic, which
    each package's f32 rounding orders (the lambdas follow the order, so
    the trees part after it);
  * quantized, the trees before the walk ends have both packages'
    integer carriers equal.

``CASES`` records what each case meets; where it meets nothing, the raw
predictions agree to atol 1e-5 and the model text loads both ways.
"""

import contextlib
import os
from unittest import mock

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.models import boosting as jboosting
from lightgbm_tpu_torch.models.boosting import GBDT, scores_from_phys
from lightgbm_tpu_torch.models.learner import SerialTreeLearner

from test_torch_categorical_trees import _gain64
from test_torch_train import _leaf_sets
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 10
LIBSVM = os.path.join(ROOT, "examples", "lambdarank", "rank.train")
LIBSVM_TEST = os.path.join(ROOT, "examples", "lambdarank", "rank.test")
LAMBDARANK = {"objective": "lambdarank", "num_leaves": 15,
              "learning_rate": 0.1, "min_data_in_leaf": 5, "verbosity": -1}
XENDCG = {"objective": "rank_xendcg", "num_leaves": 31,
          "learning_rate": 0.05, "min_data_in_leaf": 5, "verbosity": -1}
BAG = {"bagging_fraction": 0.7, "bagging_freq": 1}
RUNS = {
    "lambdarank": ("libsvm", LAMBDARANK),
    "lambdarank_positions": ("libsvm_positions", LAMBDARANK),
    "lambdarank_bagging": ("libsvm", dict(LAMBDARANK, **BAG)),
    "lambdarank_goss": ("libsvm", dict(LAMBDARANK,
                                       data_sample_strategy="goss")),
    "lambdarank_quantized": ("libsvm", dict(LAMBDARANK,
                                            use_quantized_grad=True)),
    "xendcg": ("tsv", XENDCG),
    "xendcg_quantized_bagging": ("tsv", dict(
        XENDCG, use_quantized_grad=True, bagging_fraction=0.8,
        bagging_freq=2)),
}
MEGA, K4, SUB = {}, {"tpu_frontier_k": 4}, {"tpu_megakernel": "off"}
# case: (run, port body, how the port gets its groups, what compare meets)
CASES = {
    "lambdarank-mega-file": ("lambdarank", MEGA, "file", None),
    "lambdarank-k4-group": ("lambdarank", K4, "group", None),
    "lambdarank-sub-set_group": ("lambdarank", SUB, "set_group", None),
    "positions-mega": ("lambdarank_positions", MEGA, "group", None),
    "positions-sub": ("lambdarank_positions", SUB, "group", None),
    # tree 8 split 11: equal f64 gains 0.6695857329311099 in both packages
    "bagging-mega": ("lambdarank_bagging", MEGA, "group", (8, 11)),
    "bagging-sub": ("lambdarank_bagging", SUB, "set_group", (8, 11)),
    # before tree 1 two documents of query 1 score 0.20000008 and
    # 0.20000003 in JAX, 0.2 and 0.20000003 in the port (both 0.2 in
    # exact arithmetic: GOSS's scaled leaves)
    "goss-sub": ("lambdarank_goss", SUB, "group", ("order", 1)),
    # before tree 4 documents of a query tie to f32 resolution (the
    # quantized leaves' values sit on the scale's grid)
    "quantized-mega": ("lambdarank_quantized", MEGA, "group", ("order", 4)),
    "quantized-sub": ("lambdarank_quantized", SUB, "set_group",
                      ("order", 4)),
    "xendcg-mega-set_group": ("xendcg", MEGA, "set_group", None),
    "xendcg-sub-group": ("xendcg", SUB, "group", None),
    # tree 3 split 9: equal f64 gains 2.2278279188434773
    "xendcg-quantized-mega": ("xendcg_quantized_bagging", MEGA, "group",
                              (3, 9)),
    "xendcg-quantized-sub": ("xendcg_quantized_bagging", SUB, "group",
                             (3, 9)),
}


def _data(kind):
    """(X, label, group, position) of an example."""
    from lightgbm_tpu_torch.utils.textio import load_text_file
    if kind.startswith("libsvm"):
        f = load_text_file(LIBSVM)
        pos = (np.random.RandomState(0).randint(0, 5, len(f.label))
               if kind.endswith("positions") else None)
        return f.X, f.label, f.group, pos
    d = np.loadtxt(os.path.join(ROOT, "examples", "xendcg", "rank.train"))
    g = np.loadtxt(os.path.join(ROOT, "examples", "xendcg",
                                "rank.train.query")).astype(int)
    return d[:, 1:], d[:, 0], g, None


def _order_recorder(out):
    """A before-iteration callback keeping the training scores."""
    def cb(env):
        s = env.model._gbdt.scores
        out.append(np.asarray(s.cpu() if isinstance(s, torch.Tensor) else s,
                              np.float32).copy())
    cb.before_iteration = True
    return cb


@contextlib.contextmanager
def _port_recording():
    """Per tree the port grows: the f64 grad and hess its histograms sum
    (payload rows 0 and 1 in original row order, carriers times their
    scale), and with quantized gradients the carriers and scale of each
    discretization."""
    sums, quant = [], []
    build, qz = SerialTreeLearner.build_tree, GBDT._quantize

    def rec_build(self, pb, ghi, *a, **k):
        s = self.qscale.double() if self.qscale is not None else None
        sums.append(tuple(
            (scores_from_phys(ghi, self.N, r).double()
             * (s[r] if s is not None else 1.0)).numpy() for r in (0, 1)))
        return build(self, pb, ghi, *a, **k)

    def rec_quant(self, ghi, eager):
        qz(self, ghi, eager)
        quant.append(([scores_from_phys(ghi, self.num_data, r).numpy()
                       for r in (0, 1)], self.learner.qscale.numpy().copy()))

    with mock.patch.object(SerialTreeLearner, "build_tree", rec_build), \
            mock.patch.object(GBDT, "_quantize", rec_quant):
        yield sums, quant


@contextlib.contextmanager
def _jax_quant_recording():
    """The JAX package's eager discretizations: (carriers, scale)."""
    out = []
    orig = jboosting.GBDT._discretize_gradients

    def rec(self, grad, hess, row_sampling=False):
        ig, ih, scale = orig(self, grad, hess, row_sampling)
        out.append(([np.asarray(ig), np.asarray(ih)], np.asarray(scale)))
        return ig, ih, scale

    with mock.patch.object(jboosting.GBDT, "_discretize_gradients", rec):
        yield out


@pytest.fixture(scope="module")
def jax_runs():
    return {}


def _jax(run, jax_runs):
    """One JAX booster a run, its scores before each tree and its
    discretizations."""
    if run not in jax_runs:
        kind, params = RUNS[run]
        X, y, g, pos = _data(kind)
        scores = []
        with _jax_quant_recording() as quant:
            jb = lgb.train(dict(params, tpu_frontier_k=1),
                           lgb.Dataset(X, label=y, group=g, position=pos),
                           ROUNDS, callbacks=[_order_recorder(scores)])
            jb.num_trees()
        jax_runs[run] = (jb, scores, quant)
    return jax_runs[run]


def _port(run, body, how):
    kind, params = RUNS[run]
    X, y, g, pos = _data(kind)
    params = dict(params, device_type="cpu", **body)
    if how == "file":
        ds = lgt.Dataset(LIBSVM)
    elif how == "group":
        ds = lgt.Dataset(X, label=y, group=g, position=pos)
    else:
        ds = lgt.Dataset(X, label=y, position=pos).set_group(g)
    scores = []
    with _port_recording() as (sums, quant):
        tb = lgt.train(params, ds, ROUNDS,
                       callbacks=[_order_recorder(scores)])
    return tb, scores, sums, quant


def _order_tie(sj, st, group):
    """True when the two score vectors rank every query's documents in
    one order; else assert every pair ranked apart ties to 1e-6 in both
    and return False."""
    lo = 0
    same = True
    for n in group:
        a, b = sj[lo:lo + n], st[lo:lo + n]
        oa = np.argsort(-a, kind="stable")
        ob = np.argsort(-b, kind="stable")
        if not np.array_equal(oa, ob):
            same = False
            ra, rb = np.argsort(oa), np.argsort(ob)
            for i in range(n):
                for j in range(n):
                    if ra[i] < ra[j] and rb[i] > rb[j]:
                        for s in (a, b):
                            assert abs(float(s[i]) - float(s[j])) <= 1e-6 * \
                                max(1.0, abs(float(s[i])))
        lo += n
    return same


def _same_carriers(jq, tq):
    """Both packages' integer carriers of a tree equal, their scales to
    rtol 1e-4 (the lambdas' f32 residues)."""
    (jcar, js), (tcar, ts) = jq, tq
    np.testing.assert_allclose(ts, js, rtol=1e-4)
    for r in (0, 1):
        np.testing.assert_array_equal(tcar[r], jcar[r])


def compare(X, group, jrun, prun, params):
    """What the walk meets first (see the module doc): None, (tree,
    split) of an exact tie, or ("order", tree)."""
    jb, jscores, jquant = jrun
    tb, tscores, sums, tquant = prun
    port_in_jax = lgb.Booster(model_str=tb.model_to_string())
    leaves_j = np.asarray(jb.predict(X, pred_leaf=True))
    leaves_t = np.asarray(port_in_jax.predict(X, pred_leaf=True))
    np.testing.assert_array_equal(leaves_t, tb.predict(X, pred_leaf=True))
    assert len(jb._gbdt.models) == len(tb._gbdt.models) == len(sums)
    assert len(jquant) == len(tquant)
    for t, (a, b) in enumerate(zip(jb._gbdt.models, tb._gbdt.models)):
        np.testing.assert_allclose(tscores[t], jscores[t], rtol=0, atol=1e-5)
        if params["objective"] == "lambdarank" and not _order_tie(
                jscores[t], tscores[t], group):
            return "order", t
        if tquant:
            _same_carriers(jquant[t], tquant[t])
        g, h = sums[t]
        sets = [[(np.isin(lv, list(u)), np.isin(lv, list(v)))
                 for u, v in _leaf_sets(tree)]
                for tree, lv in ((a, leaves_j[:, t]), (b, leaves_t[:, t]))]
        for s in range(max(len(sets[0]), len(sets[1]))):
            (rj, lj), (rt, lt) = (x[s] if s < len(x) else (None, None)
                                  for x in sets)
            if (rj is not None and rt is not None
                    and np.array_equal(rj, rt) and np.array_equal(lj, lt)):
                continue
            l2 = params.get("lambda_l2", 0.0)
            vj, mj = _gain64(rj, lj, g, h, l2, params)
            vt, mt = _gain64(rt, lt, g, h, l2, params)
            assert abs(vj - vt) <= 1e-9 * max(1.0, mj, mt), (
                f"tree {t} split {s}: the packages split differently with "
                f"f64 gains {vj!r} (JAX) and {vt!r} (port)")
            return t, s
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)
    return None


@pytest.mark.parametrize("case", list(CASES))
def test_rank_trees_match_jax(case, jax_runs):
    run, body, how, meets = CASES[case]
    kind, params = RUNS[run]
    X, y, group, _ = _data(kind)
    prun = _port(run, body, how)
    tb = prun[0]
    lr = tb._gbdt.learner
    assert lr.subtract == (body is SUB)
    assert lr.K == (4 if body is K4 else 1)
    assert not tb._gbdt.objective.reference_fused
    assert tb._gbdt._eager_quant == bool(params.get("use_quantized_grad"))
    jrun = _jax(run, jax_runs)
    assert compare(X, group, jrun, prun, params) == meets
    if meets is not None:
        return
    jb = jrun[0]
    pj = jb.predict(X, raw_score=True)
    np.testing.assert_allclose(tb.predict(X, raw_score=True), pj, rtol=0,
                               atol=1e-5)
    jax_in_port = lgt.Booster(model_str=jb.model_to_string(),
                              params={"device_type": "cpu"})
    np.testing.assert_allclose(jax_in_port.predict(X, raw_score=True), pj,
                               rtol=0, atol=1e-5)
    assert f"objective={RUNS[run][1]['objective']}" in tb.model_to_string()
    port_in_jax = lgb.Booster(model_str=tb.model_to_string())
    np.testing.assert_allclose(port_in_jax.predict(X, raw_score=True),
                               tb.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)


def test_validation_and_early_stopping_match_jax():
    """``rank.test`` as a validation set (its own ``qid:`` runs), ndcg
    and map at 1,3,5, early stopping on the first metric: the same best
    iteration and eval history (1e-6) as the JAX package, and the port's
    validation NDCG equal to a numpy float64 evaluation of its validation
    scores after the last iteration."""
    from test_torch_rank_metric import map64, ndcg64
    params = dict(LAMBDARANK, metric="ndcg,map", eval_at="1,3,5",
                  early_stopping_round=5, first_metric_only=True)
    out = {}
    for name, mod, extra in (("jax", lgb, {"tpu_frontier_k": 1}),
                             ("port", lgt, {"device_type": "cpu"})):
        dt = mod.Dataset(LIBSVM)
        dv = mod.Dataset(LIBSVM_TEST, reference=dt)
        ev = {}
        bst = mod.train(dict(params, **extra), dt, 40, valid_sets=[dv],
                        valid_names=["v"],
                        callbacks=[mod.record_evaluation(ev)])
        out[name] = (bst, ev["v"])
    (jb, jev), (tb, tev) = out["jax"], out["port"]
    assert tb.best_iteration == jb.best_iteration
    assert tb.num_trees() == jb.num_trees() < 40
    assert list(tev) == list(jev) == ["ndcg@1", "ndcg@3", "ndcg@5", "map@1",
                                      "map@3", "map@5"]
    for k in jev:
        np.testing.assert_allclose(tev[k], jev[k], rtol=0, atol=1e-6)
        assert tb.best_score["v"][k] == tev[k][tb.best_iteration - 1]
    vd = tb._valid_sets[0]._inner.metadata
    sizes = np.diff(vd.query_boundaries)
    s = tb._gbdt.valid_score(0).numpy()
    for k in (1, 3, 5):
        assert abs(tev[f"ndcg@{k}"][-1]
                   - ndcg64(s, vd.label, sizes, k,
                            2.0 ** np.arange(32) - 1.0)) <= 1e-6
        assert abs(tev[f"map@{k}"][-1] - map64(s, vd.label, sizes, k)) \
            <= 1e-6
    from lightgbm_tpu_torch.utils.textio import load_text_file
    Xv = load_text_file(LIBSVM_TEST).X
    np.testing.assert_allclose(tb.predict(Xv), jb.predict(Xv), rtol=0,
                               atol=1e-5)


def test_bagging_by_query_warns_and_is_ignored():
    msgs = []
    from lightgbm_tpu_torch.utils import log
    log.register_callback(msgs.append)
    try:
        X, y, g, _ = _data("libsvm")
        a = lgt.train(dict(LAMBDARANK, device_type="cpu", verbosity=0,
                           bagging_by_query=True),
                      lgt.Dataset(X, label=y, group=g), 2)
    finally:
        log.register_callback(None)
    assert any("bagging_by_query" in m for m in msgs)
    b = lgt.train(dict(LAMBDARANK, device_type="cpu"),
                  lgt.Dataset(X, label=y, group=g), 2)
    np.testing.assert_array_equal(a.predict(X, raw_score=True),
                                  b.predict(X, raw_score=True))


def test_ranking_needs_query_groups():
    X, y, _, _ = _data("libsvm")
    for obj in ("lambdarank", "rank_xendcg"):
        with pytest.raises(Exception, match="query"):
            lgt.train(dict(LAMBDARANK, objective=obj, device_type="cpu"),
                      lgt.Dataset(X, label=y), 1)
    with pytest.raises(Exception, match="num_data"):
        lgt.Dataset(X, label=y, group=[5, 5]).construct(
            {"device_type": "cpu"})
    ds = lgt.Dataset(X, label=y).set_group([len(y)])
    assert list(ds.get_group()) == [len(y)]
