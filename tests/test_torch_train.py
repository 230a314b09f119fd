"""The port end to end: ``lightgbm_tpu_torch.train`` on the CPU against
``lightgbm_tpu.train`` on the repo's examples, for both split bodies of
the learner:

  * ``pair``: the port's mega path against the JAX mega path in its XLA
    form (``tpu_megakernel=xla``, ``tpu_frontier_k=1``);
  * ``sub_pair``: the port's histogram-subtraction path
    (``tpu_megakernel=off``) against the JAX package's
    (``tpu_megakernel=off``, ``tpu_frontier_k=1``).

Tolerances: bin mappers, the binned matrix and tree structure (split
features, bin and real thresholds, children, decision types, leaf
counts) must be identical.  Leaf values agree to rtol 1e-4 / atol 1e-5
(the repo's bar, __graft_entry__.py), raw predictions to atol 1e-5:
the two packages sum the same f32 gradients in different orders.
"""

import os

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import convert
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 5


def _load(rel):
    d = np.loadtxt(os.path.join(ROOT, "examples", rel))
    return d[:, 1:], d[:, 0]


# binary.train at 31 leaves reaches a near-tie in its first tree (two
# candidates' gains equal to within the two packages' f32 rounding),
# where the packages may pick either; 15 leaves stays clear
CASES = {
    "binary": ("binary_classification/binary.train",
               {"objective": "binary", "num_leaves": 15,
                "metric": "binary_logloss,auc"}),
    "regression": ("regression/regression.train",
                   {"objective": "regression", "num_leaves": 31,
                    "lambda_l2": 1.0, "metric": "l2,rmse"}),
}


def _train_both(case, jax_mega, min_data_in_leaf, **port):
    rel, params = CASES[case]
    X, y = _load(rel)
    params = dict(params, verbosity=-1, min_data_in_leaf=min_data_in_leaf)
    jb = lgb.train(dict(params, tpu_megakernel=jax_mega, tpu_frontier_k=1),
                   lgb.Dataset(X, label=y), num_boost_round=ROUNDS)
    jb.num_trees()                        # materialize lagged trees
    tb = lgt.train(dict(params, device_type="cpu", **port),
                   lgt.Dataset(X, label=y), num_boost_round=ROUNDS)
    return X, y, params, jb, tb


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    return _train_both(request.param, "xla", 10)


# The subtraction chain carries each package's own f32 rounding down the
# tree, and leaves a rounding residue in bins that are empty in exact
# arithmetic.  Two thresholds around such a bin split the rows the same
# way with exactly equal gains, and the residues decide which one each
# package takes: with min_data_in_leaf 10 or 20 this happens at the last
# split of one of the five regression trees (ROADMAP.md C).  At 5 none
# of the trees meets such a tie.
@pytest.fixture(scope="module", params=sorted(CASES))
def sub_pair(request):
    return _train_both(request.param, "off", 5, tpu_megakernel="off")


def test_bins_bit_identical(pair):
    _, _, _, jb, tb = pair
    jd, td = jb._gbdt.train_data, tb._gbdt.train_data
    assert [g.feature_indices for g in jd.groups] == \
        [g.feature_indices for g in td.groups]
    assert [bm.to_dict() for bm in jd.bin_mappers] == \
        [bm.to_dict() for bm in td.bin_mappers]
    np.testing.assert_array_equal(np.asarray(jd.host_binned()), td.binned)
    assert td.binned.dtype == np.uint8


def _structure(t):
    n = t.num_nodes()
    return (t.num_leaves, t.split_feature[:n].tolist(),
            t.threshold_bin[:n].tolist(), t.threshold[:n].tolist(),
            t.decision_type[:n].tolist(), t.left_child[:n].tolist(),
            t.right_child[:n].tolist(), t.leaf_count.tolist(),
            t.internal_count.tolist())


def test_tree_structure_identical(pair):
    _check_structure(pair)


def test_subtraction_tree_structure_identical(sub_pair):
    assert sub_pair[4]._gbdt.learner.subtract
    _check_structure(sub_pair)


def _check_structure(pair):
    _, _, _, jb, tb = pair
    jt, tt = jb._gbdt.models, tb._gbdt.models
    assert len(jt) == len(tt) == ROUNDS
    for a, b in zip(jt, tt):
        assert a.num_leaves > 2
        assert _structure(a) == _structure(b)


def test_leaf_values_close(pair):
    _check_leaf_values(pair)


def test_subtraction_leaf_values_close(sub_pair):
    _check_leaf_values(sub_pair)


def _check_leaf_values(pair):
    _, _, _, jb, tb = pair
    for a, b in zip(jb._gbdt.models, tb._gbdt.models):
        np.testing.assert_allclose(b.leaf_value, a.leaf_value,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(b.internal_value, a.internal_value,
                                   rtol=1e-4, atol=1e-5)


def test_raw_predictions_close(pair):
    _check_predictions(pair)


def test_subtraction_raw_predictions_close(sub_pair):
    _check_predictions(sub_pair)


def _check_predictions(pair):
    X, _, _, jb, tb = pair
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True),
                               rtol=0, atol=1e-5)
    # converted output too (sigmoid for binary, identity for L2)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=0,
                               atol=1e-5)


def test_model_text_cross_loads(pair, tmp_path):
    _check_model_text(pair, tmp_path)


def test_subtraction_model_text_cross_loads(sub_pair, tmp_path):
    _check_model_text(sub_pair, tmp_path)


def _check_model_text(pair, tmp_path):
    X, _, _, jb, tb = pair
    path = tmp_path / "port_model.txt"
    tb.save_model(str(path))
    j_from_t = lgb.Booster(model_file=str(path))
    np.testing.assert_allclose(j_from_t.predict(X, raw_score=True),
                               tb.predict(X, raw_score=True), rtol=0,
                               atol=1e-9)
    t_from_j = convert.booster_from_model_string(
        jb.model_to_string(), params={"device_type": "cpu"})
    np.testing.assert_allclose(t_from_j.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=1e-9)
    # the port's own text reloads into the port with equal predictions
    t_from_t = lgt.Booster(params={"device_type": "cpu"},
                           model_file=str(path))
    np.testing.assert_array_equal(t_from_t.predict(X, raw_score=True),
                                  tb.predict(X, raw_score=True))


def _cat_jax(rounds):
    """The JAX package's regression booster on _cat_data (15 leaves,
    column 0 categorical)."""
    X, y = _cat_data()
    jb = lgb.train({"objective": "regression", "num_leaves": 15,
                    "verbosity": -1, "tpu_frontier_k": 1},
                   lgb.Dataset(X, label=y, categorical_feature=[0]),
                   num_boost_round=rounds)
    jb.num_trees()
    return jb


# the JAX boosters on categorical data, trained once for every case of
# `pair` that reads them
@pytest.fixture(scope="module")
def cat_jax3():
    return _cat_jax(3)


@pytest.fixture(scope="module")
def cat_jax():
    return _cat_jax(ROUNDS)


@pytest.mark.parametrize("key", ["num_cat", "is_linear"])
def test_loading_categorical_or_linear_trees_raises(pair, key, request):
    """JAX-written models with categorical trees or linear trees load and
    predict what JAX predicts: NaN and unseen categories included, and
    a linear tree's NaN rows at their leaves' constant values.  (Both
    raised before the port had these trees; the name stayed.)"""
    if key == "num_cat":
        X, y = _cat_data()
        jb = request.getfixturevalue("cat_jax3")
        tl = lgt.Booster(params={"device_type": "cpu"},
                         model_str=jb.model_to_string())
        assert sum(t.num_cat for t in tl._gbdt.models) > 0
        X[:5, 0], X[5:10, 0] = np.nan, 99.0
        np.testing.assert_allclose(tl.predict(X, raw_score=True),
                                   jb.predict(X, raw_score=True), rtol=0,
                                   atol=1e-9)
        return
    X, y = _load(CASES["regression"][0])
    jb = lgb.train({"objective": "regression", "num_leaves": 15,
                    "linear_tree": True, "verbosity": -1},
                   lgb.Dataset(X, label=y), 3)
    tl = lgt.Booster(params={"device_type": "cpu"},
                     model_str=jb.model_to_string())
    assert all(t.is_linear for t in tl._gbdt.models)
    X = X.copy()
    X[:5, :4] = np.nan
    np.testing.assert_allclose(tl.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=1e-9)


def _cat_data(n=2000, seed=0):
    """A 12-level categorical column beside a numerical one."""
    rng = np.random.RandomState(seed)
    cat = rng.randint(0, 12, n).astype(float)
    x1 = rng.normal(size=n)
    y = np.isin(cat, (2, 5, 7, 11)) * 2.0 + 0.3 * x1 + 0.1 * rng.normal(
        size=n)
    return np.column_stack([cat, x1]), y


def test_categorical_bin_mapper_raises(pair, cat_jax):
    """convert.dataset_from_arrays carries the JAX package's categorical
    bin mappers across bit for bit, and the port grows JAX's trees on
    them."""
    X, y = _cat_data()
    params = {"objective": "regression", "num_leaves": 15, "verbosity": -1}
    jb = cat_jax
    jd = jb._gbdt.train_data
    ds = convert.dataset_from_arrays(
        np.asarray(jd.host_binned()), [bm.to_dict() for bm in jd.bin_mappers],
        [(g.feature_indices, g.bin_offsets, g.num_total_bin)
         for g in jd.groups], y, params=dict(params, device_type="cpu"))
    assert [bm.to_dict() for bm in ds.bin_mappers] == \
        [bm.to_dict() for bm in jd.bin_mappers]
    assert [bm.categorical_2_bin for bm in ds.bin_mappers] == \
        [bm.categorical_2_bin for bm in jd.bin_mappers]
    np.testing.assert_array_equal(ds.feature_meta_arrays()["is_categorical"],
                                  jd.feature_meta_arrays()["is_categorical"])
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.models.boosting import GBDT
    from lightgbm_tpu_torch.models.objective import create_objective
    cfg = Config(dict(params, device_type="cpu"))
    g = GBDT(cfg, ds, create_objective(cfg), "cpu")
    for _ in range(ROUNDS):
        g.train_one_iter()
    assert sum(t.num_cat for t in g.models) > 0
    for a, b in zip(jb._gbdt.models, g.models):
        assert _structure(a) == _structure(b)
        assert a.cat_threshold == b.cat_threshold
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)


def test_training_metric_falls(pair):
    X, y, params, _, _ = pair
    b = lgt.Booster(dict(params, device_type="cpu"), lgt.Dataset(X, label=y))
    losses = []
    for _ in range(3):
        b.update()
        losses.append(b.eval_train()[0][2])
    assert losses[0] > losses[1] > losses[2]


def test_train_metrics_match_jax(pair):
    """binary_logloss / auc and l2 / rmse of the trained scores: the same
    metrics, in the same order, within rtol 1e-5 (the scores agree to
    atol 1e-5; the loss sums run in f32 in both packages)."""
    _check_metrics(pair)


def test_subtraction_train_metrics_match_jax(sub_pair):
    _check_metrics(sub_pair)


def _check_metrics(pair):
    _, _, _, jb, tb = pair
    je, te = jb.eval_train(), tb.eval_train()
    assert [e[1] for e in te] == [e[1] for e in je]
    assert len(te) == 2
    for (_, _, tv, tmax), (_, _, jv, jmax) in zip(te, je):
        assert tmax == jmax
        np.testing.assert_allclose(tv, jv, rtol=1e-5)


def test_dataset_from_jax_arrays_trains_the_same_trees(pair):
    """convert.dataset_from_arrays feeds the JAX package's bins to the
    port's learner: the trees equal those of the port's own binning."""
    X, y, params, jb, tb = pair
    jd = jb._gbdt.train_data
    ds = convert.dataset_from_arrays(
        np.asarray(jd.host_binned()), [bm.to_dict() for bm in jd.bin_mappers],
        [(g.feature_indices, g.bin_offsets, g.num_total_bin)
         for g in jd.groups], y, params=dict(params, device_type="cpu"))
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.models.boosting import GBDT
    from lightgbm_tpu_torch.models.objective import create_objective
    cfg = Config(dict(params, device_type="cpu"))
    g = GBDT(cfg, ds, create_objective(cfg), "cpu")
    for _ in range(ROUNDS):
        g.train_one_iter()
    for a, b in zip(g.models, tb._gbdt.models):
        assert _structure(a) == _structure(b)
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)


@pytest.mark.parametrize("param,value", [
    ("feature_fraction_bynode", 0.5), ("extra_trees", True),
    ("objective", "multiclass"), ("cegb_penalty_split", 0.5),
    ("tpu_ab_double", "hist"),
    ("path_smooth", 1.0), ("tree_learner", "data"),
    ("tpu_megakernel", "xla"), ("tpu_hist_dtype", "float16"),
    ("tpu_hist_state", "flat")])
def test_unsupported_param_raises_naming_it(param, value):
    """``multiclass`` with one class is refused, naming the objective
    (multiclass itself trains: test_torch_multiclass.py)."""
    X, y = _load(CASES["binary"][0])
    params = {"objective": "binary", "device_type": "cpu", param: value,
              "bagging_freq": 1, "num_class": 1}
    with pytest.raises(NotImplementedError, match=param):
        lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=1)


def test_weights_and_init_score_match_jax():
    """Row weights (riding the binary payload row) and an init score
    (replacing boost-from-average) train the same trees as the JAX
    package."""
    X, y = _load(CASES["binary"][0])
    rng = np.random.RandomState(4)
    w = rng.uniform(0.5, 2.0, len(y))
    init = rng.normal(scale=0.1, size=len(y))
    params = {"objective": "binary", "num_leaves": 7, "verbosity": -1}
    jb = lgb.train(dict(params, tpu_megakernel="xla", tpu_frontier_k=1),
                   lgb.Dataset(X, label=y, weight=w, init_score=init),
                   num_boost_round=3)
    jb.num_trees()
    tb = lgt.train(dict(params, device_type="cpu"),
                   lgt.Dataset(X, label=y, weight=w, init_score=init),
                   num_boost_round=3)
    for a, b in zip(jb._gbdt.models, tb._gbdt.models):
        assert _structure(a) == _structure(b)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value,
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)


def test_subtraction_path_calls_each_kernel_once_per_split(monkeypatch):
    """The eager oracle (``build_tree_eager``), per tree: partition once
    per split, the fused histogram and state update (leaf_hist_rmw) and
    split_pair once per split plus once for the root, split_mega never;
    one host sync per split plus one for the root.  The device loop's
    counts are tests/test_torch_tree_loop.py's."""
    from lightgbm_tpu_torch.models import learner as lm
    monkeypatch.setattr(lm.SerialTreeLearner, "build_tree",
                        lm.SerialTreeLearner.build_tree_eager)
    calls = dict.fromkeys(["partition_leaf", "leaf_hist_rmw", "split_pair",
                           "split_mega"], 0)
    for name in calls:
        real = getattr(lm, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(lm, name, counted)
    X, y = _load(CASES["binary"][0])
    for kernel in ("xla", "pallas"):
        for k in calls:
            calls[k] = 0
        b = lgt.train({"objective": "binary", "num_leaves": 15,
                       "verbosity": -1, "device_type": "cpu",
                       "tpu_megakernel": "off", "tpu_hist_kernel": kernel},
                      lgt.Dataset(X, label=y), num_boost_round=2)
        splits = sum(t.num_leaves - 1 for t in b._gbdt.models)
        assert splits == 28
        assert calls == {"partition_leaf": splits,
                         "leaf_hist_rmw": splits + 2,
                         "split_pair": splits + 2, "split_mega": 0}
        assert b._gbdt.learner.syncs == splits + 2


# ---- exact ties between the packages (ROADMAP.md C) ------------------------
#
# Three settings reach splits whose competing candidates have equal gains
# in exact arithmetic, where each package's f32 rounding decides: missing
# values (the forward and the reverse scan make the same partition),
# max_delta_step (every output clamps, so a split's exact gain is 0) and
# max_depth with 63 leaves (first-tree gains that depend only on label
# counts tie across features).  The comparison below walks both packages'
# trees split by split, in the order they were made (an internal node's
# index), on the training rows: each split must partition the same rows
# the same way -- its feature, threshold and default_left may differ, the
# gain being a function of the partition -- until the first split that
# partitions differently, where the two splits' gains recounted in f64
# from that tree's gradients must be equal (a missing split counts as a
# gain of 0).  The trees before it must also have their leaf values
# within the repo's bar.

def _leaf_sets(tree):
    """Leaves below each internal node and below its left child."""
    ns = tree.num_leaves - 1
    lc = np.asarray(tree.left_child[:ns])
    rc = np.asarray(tree.right_child[:ns])

    def below(c):
        return {~c} if c < 0 else below(lc[c]) | below(rc[c])

    return [(below(s), below(lc[s])) for s in range(ns)]


def _leaf_gain64(g, h, l1, l2, mds):
    s = np.sign(g) * max(abs(g) - l1, 0.0)
    if mds > 0:
        out = min(max(-s / (h + l2), -mds), mds)
        return -(2.0 * s * out + (h + l2) * out * out)
    return s * s / (h + l2)


def _split_gain64(rows, left, g, h, reg):
    if rows is None:
        return 0.0
    right = rows & ~left
    parts = [(g[m].sum(), h[m].sum()) for m in (left, right, rows)]
    gl, gr, gp = (_leaf_gain64(a, b, *reg) for a, b in parts)
    return gl + gr - gp, abs(gl) + abs(gr) + abs(gp)


def _first_tie(a, b, lvj, lvt, g, h, reg, t=0, rtol=1e-9):
    """The first split of tree ``a`` (JAX) and ``b`` (port) that
    partitions the rows differently, after checking that its two choices
    have equal f64 gains from the rows' ``g`` and ``h`` (to ``rtol`` of
    the larger sum of the split's three |leaf gains|); None when every
    split partitions the same rows.  ``lvj`` / ``lvt``: each row's leaf."""
    sets = []
    for tree, lv in ((a, lvj), (b, lvt)):
        sets.append([(np.isin(lv, list(u)), np.isin(lv, list(v)))
                     for u, v in _leaf_sets(tree)])
    for s in range(max(len(sets[0]), len(sets[1]))):
        got = [x[s] if s < len(x) else (None, None) for x in sets]
        (rj, lj), (rt, lt) = got
        if (rj is not None and rt is not None
                and np.array_equal(rj, rt) and np.array_equal(lj, lt)):
            continue
        gj = _split_gain64(rj, lj, g, h, reg)
        gt = _split_gain64(rt, lt, g, h, reg)
        (vj, mj), (vt, mt) = (x if isinstance(x, tuple) else (x, 0.0)
                              for x in (gj, gt))
        assert abs(vj - vt) <= rtol * max(1.0, mj, mt), (
            f"tree {t} split {s}: the packages split differently with "
            f"f64 gains {vj!r} (JAX) and {vt!r} (port)")
        return s
    return None


def _compare_with_ties(X, y, objective, params, jb, tb, row_scale=None):
    """Returns (tree, split) of the first split that partitions the
    training rows differently, after checking it is an exact tie; None
    when every tree agrees.  ``row_scale(t)``, when given, is tree t's
    (N,) factor on every row's gradient and hessian (a sampling mask)."""
    reg = (params.get("lambda_l1", 0.0), params.get("lambda_l2", 0.0),
           params.get("max_delta_step", 0.0))
    port_in_jax = lgb.Booster(model_str=tb.model_to_string())
    leaves_j = np.asarray(jb.predict(X, pred_leaf=True))
    leaves_t = np.asarray(port_in_jax.predict(X, pred_leaf=True))
    score = np.full(len(y), tb._gbdt.init_scores[0], np.float64)
    for t, (a, b) in enumerate(zip(jb._gbdt.models, tb._gbdt.models)):
        if objective == "binary":
            p = 1.0 / (1.0 + np.exp(-score))
            g, h = p - y, p * (1.0 - p)
        else:
            g, h = score - y, np.ones_like(y)
        if row_scale is not None:
            g, h = g * row_scale(t), h * row_scale(t)
        s = _first_tie(a, b, leaves_j[:, t], leaves_t[:, t], g, h, reg, t)
        if s is not None:
            return t, s
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)
        score = score + np.asarray(b.leaf_value, np.float64)[leaves_t[:, t]]
        if t == 0:
            score = score - tb._gbdt.init_scores[0]
    return None


TIE_CASES = {
    "missing_values": ("regression/regression.train", "regression",
                       {"num_leaves": 31, "lambda_l2": 1.0}),
    "max_delta_step": (CASES["binary"][0], "binary",
                       {"num_leaves": 15, "max_delta_step": 0.3}),
    "max_depth": (CASES["binary"][0], "binary",
                  {"num_leaves": 63, "max_depth": 5}),
}


@pytest.mark.parametrize("case", sorted(TIE_CASES))
def test_tie_settings_agree_up_to_exact_ties(case):
    rel, objective, extra = TIE_CASES[case]
    X, y = _load(rel)
    if case == "missing_values":
        X = X.copy()
        X[np.random.RandomState(3).rand(*X.shape) < 0.1] = np.nan
    params = dict(extra, objective=objective, verbosity=-1,
                  min_data_in_leaf=20)
    jb = lgb.train(dict(params, tpu_megakernel="xla", tpu_frontier_k=1),
                   lgb.Dataset(X, label=y), num_boost_round=ROUNDS)
    jb.num_trees()
    tb = lgt.train(dict(params, device_type="cpu"), lgt.Dataset(X, label=y),
                   num_boost_round=ROUNDS)
    _compare_with_ties(X, y, objective, params, jb, tb)
