"""The slice end to end: ``lightgbm_tpu_torch.train`` on the CPU against
``lightgbm_tpu.train`` with the mega path in its XLA form
(``tpu_megakernel=xla``, ``tpu_frontier_k=1``) on the repo's examples.

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


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    rel, params = CASES[request.param]
    X, y = _load(rel)
    params = dict(params, verbosity=-1, min_data_in_leaf=10)
    jb = lgb.train(dict(params, tpu_megakernel="xla", tpu_frontier_k=1),
                   lgb.Dataset(X, label=y), num_boost_round=ROUNDS)
    jb.num_trees()                        # materialize lagged trees
    tb = lgt.train(dict(params, device_type="cpu"), lgt.Dataset(X, label=y),
                   num_boost_round=ROUNDS)
    return X, y, params, jb, tb


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
    _, _, _, jb, tb = pair
    jt, tt = jb._gbdt.models, tb._gbdt.models
    assert len(jt) == len(tt) == ROUNDS
    for a, b in zip(jt, tt):
        assert a.num_leaves > 2
        assert _structure(a) == _structure(b)


def test_leaf_values_close(pair):
    _, _, _, jb, tb = pair
    for a, b in zip(jb._gbdt.models, tb._gbdt.models):
        np.testing.assert_allclose(b.leaf_value, a.leaf_value,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(b.internal_value, a.internal_value,
                                   rtol=1e-4, atol=1e-5)


def test_raw_predictions_close(pair):
    X, _, _, jb, tb = pair
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True),
                               rtol=0, atol=1e-5)
    # converted output too (sigmoid for binary, identity for L2)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=0,
                               atol=1e-5)


def test_model_text_cross_loads(pair, tmp_path):
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
    ("tpu_hist_kernel", "pallas")])
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
