"""Categorical features through the port's API on the CPU, against the
JAX package: model text both ways, prediction of edge values, a
validation set with early stopping, and the ways of naming the
categorical columns.

Tolerances: a model written by one package and loaded into the other
predicts the same raw scores to atol 1e-9 (the same f64 leaf values and
the same decisions), leaf indices identically, on rows with NaN,
negative, unseen, non-integer and huge category values; the port's host
``Tree.predict`` equals its device walk bit for bit.  The early-stopping
run's evaluation history agrees to rtol 1e-5, its best iteration and
trees exactly (leaf values rtol 1e-4 / atol 1e-5), and the validation
scores, grown a tree at a time by the bin-space walk, equal a fresh raw
prediction of the validation rows to atol 1e-5.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

from test_torch_categorical import cat_data
from torch_one_thread import one_torch_thread  # noqa: F401

PARAMS = {"objective": "regression", "num_leaves": 15, "verbosity": -1,
          "min_data_in_leaf": 20, "min_data_per_group": 50}


def _edge_rows(X):
    q = X[:60].copy()
    q[0:6, 0] = [np.nan, -1.0, -7.5, 50.0, 1e12, 2.7]
    q[6:12, 0] = [11.9, 0.0, 5.0, 99.0, np.inf, -np.inf]
    q[12:16, 2] = [np.nan, -2.0, 1.5, 3.0]
    return q


@pytest.fixture(scope="module")
def models():
    X, y = cat_data()
    jb = lgb.train(dict(PARAMS, tpu_frontier_k=1),
                   lgb.Dataset(X, label=y, categorical_feature=[0, 2]), 5)
    jb.num_trees()
    tb = lgt.train(dict(PARAMS, device_type="cpu"),
                   lgt.Dataset(X, label=y, categorical_feature=[0, 2]), 5)
    return X, y, jb, tb


def test_port_model_loads_in_jax_and_predicts_the_same(models, tmp_path):
    X, _, _, tb = models
    assert sum(t.num_cat for t in tb._gbdt.models) > 0
    path = tmp_path / "port.txt"
    tb.save_model(str(path))
    jl = lgb.Booster(model_file=str(path))
    for q in (X, _edge_rows(X)):
        np.testing.assert_allclose(jl.predict(q, raw_score=True),
                                   tb.predict(q, raw_score=True), rtol=0,
                                   atol=1e-9)
        np.testing.assert_array_equal(np.asarray(jl.predict(q,
                                                            pred_leaf=True)),
                                      tb.predict(q, pred_leaf=True))
    back = lgt.Booster(params={"device_type": "cpu"}, model_file=str(path))
    q = _edge_rows(X)
    np.testing.assert_array_equal(back.predict(q, raw_score=True),
                                  tb.predict(q, raw_score=True))
    assert back.model_to_string().split("Tree=", 1)[1] == \
        tb.model_to_string().split("Tree=", 1)[1]


def test_jax_model_loads_in_port_and_predicts_the_same(models):
    X, _, jb, _ = models
    tl = lgt.Booster(params={"device_type": "cpu"},
                     model_str=jb.model_to_string())
    assert sum(t.num_cat for t in tl._gbdt.models) > 0
    for q in (X, _edge_rows(X)):
        np.testing.assert_allclose(tl.predict(q, raw_score=True),
                                   jb.predict(q, raw_score=True), rtol=0,
                                   atol=1e-9)
        np.testing.assert_array_equal(tl.predict(q, pred_leaf=True),
                                      np.asarray(jb.predict(q,
                                                            pred_leaf=True)))
        host = sum(t.predict(q) for t in tl._gbdt.models)
        np.testing.assert_array_equal(tl.predict(q, raw_score=True), host)


@pytest.mark.parametrize("spec", ["names", "config"])
def test_categorical_columns_by_name_or_config_string(models, spec):
    """``categorical_feature`` as column names or as the config string
    gives the same model as column indices."""
    X, y, _, tb = models
    names = [f"f{i}" for i in range(X.shape[1])]
    if spec == "names":
        ds = lgt.Dataset(X, label=y, feature_name=names,
                         categorical_feature=["f0", "f2"])
        params = dict(PARAMS, device_type="cpu")
    else:
        ds = lgt.Dataset(X, label=y, feature_name=names)
        params = dict(PARAMS, device_type="cpu", categorical_feature="0,2")
    b = lgt.train(params, ds, 5)
    np.testing.assert_array_equal(b.predict(X, raw_score=True),
                                  tb.predict(X, raw_score=True))
    assert b.model_to_string().split("feature_infos=")[1].split("\n")[0] \
        == tb.model_to_string().split("feature_infos=")[1].split("\n")[0]


def test_validation_early_stopping_matches_jax():
    X, y = cat_data(n=3000, seed=3)
    Xt, yt, Xv, yv = X[:2200], y[:2200], X[2200:], y[2200:]
    out = {}
    for mod, extra in ((lgb, {"tpu_frontier_k": 1}),
                       (lgt, {"device_type": "cpu"})):
        d = mod.Dataset(Xt, label=yt, categorical_feature=[0, 2])
        v = mod.Dataset(Xv, label=yv, reference=d)
        ev = {}
        b = mod.train(dict(PARAMS, metric="l2,l1", learning_rate=0.5,
                           early_stopping_round=2, **extra), d, 40,
                      valid_sets=[v], callbacks=[mod.record_evaluation(ev)])
        b.num_trees()
        out[mod] = (b, ev)
    (jb, je), (tb, te) = out[lgb], out[lgt]
    assert tb.best_iteration == jb.best_iteration
    assert 0 < tb.best_iteration < len(te["valid_0"]["l2"]) < 40
    for metric in ("l2", "l1"):
        np.testing.assert_allclose(te["valid_0"][metric],
                                   je["valid_0"][metric], rtol=1e-5)
    assert len(tb._gbdt.models) == len(jb._gbdt.models)
    for a, b in zip(jb._gbdt.models, tb._gbdt.models):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        assert a.cat_threshold == b.cat_threshold
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(
        tb._gbdt.valid_scores[0].numpy(),
        tb.predict(Xv, raw_score=True, num_iteration=-1), rtol=0, atol=1e-5)
