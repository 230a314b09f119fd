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


@pytest.mark.parametrize("key", ["num_cat", "is_linear"])
def test_loading_categorical_or_linear_trees_raises(pair, key):
    """The port's slice has numerical constant-leaf trees only: model text
    with a categorical or linear tree raises instead of losing them."""
    text = pair[4].model_to_string().replace(f"{key}=0", f"{key}=1", 1)
    with pytest.raises(NotImplementedError, match=key):
        lgt.Booster(params={"device_type": "cpu"}, model_str=text)


def test_categorical_bin_mapper_raises(pair):
    _, y, _, jb, _ = pair
    jd = jb._gbdt.train_data
    mappers = [dict(bm.to_dict(), bin_type=1) for bm in jd.bin_mappers]
    with pytest.raises(NotImplementedError, match="categorical"):
        convert.dataset_from_arrays(
            np.asarray(jd.host_binned()), mappers,
            [g.feature_indices[0] for g in jd.groups], y)


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
        [g.feature_indices[0] for g in jd.groups], y,
        params=dict(params, device_type="cpu"))
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
    ("bagging_fraction", 0.5), ("feature_fraction", 0.5),
    ("objective", "multiclass"), ("tpu_frontier_k", 4),
    ("linear_tree", True), ("tree_learner", "data"),
    ("tpu_megakernel", "xla"), ("tpu_hist_dtype", "bfloat16_pair"),
    ("tpu_hist_state", "flat")])
def test_unsupported_param_raises_naming_it(param, value):
    X, y = _load(CASES["binary"][0])
    params = {"objective": "binary", "device_type": "cpu", param: value,
              "bagging_freq": 1, "num_class": 3 if value == "multiclass"
              else 1}
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
    """Per tree: partition and hist_rmw once per split, leaf_hist and
    split_pair once per split plus once for the root, split_mega never;
    one host sync per split plus one for the root."""
    from lightgbm_tpu_torch.models import learner as lm
    calls = dict.fromkeys(["partition_leaf", "leaf_hist", "hist_rmw",
                           "split_pair", "split_mega"], 0)
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
        assert calls == {"partition_leaf": splits, "hist_rmw": splits,
                         "leaf_hist": splits + 2, "split_pair": splits + 2,
                         "split_mega": 0}
        assert b._gbdt.learner.syncs == splits + 2
