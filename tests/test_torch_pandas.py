"""pandas DataFrames in the port (lightgbm_tpu_torch/basic.py
``_dataframe_to_matrix``, a copy of the JAX package's) against the JAX
package: category, object (strings), string and bool columns become
integer codes and, with ``categorical_feature`` left at "auto", the
dataset's categorical features; ``pandas_categorical`` keeps each
column's categories and encodes later frames with the training codes.

On a frame of 1,000 rows (6 numerical columns of binary.train, a
12-level category column, a 5-level object column, a string column and a
bool column), binary, 15 leaves, 5 trees:
  * the port finds the same categorical columns and codes as JAX, and
    its trees equal JAX's split for split (the tie rule of
    test_torch_categorical_trees.py ``_compare``; none is met here);
  * a frame to predict whose category column lists its categories in
    another order, and which holds unseen values, predicts what JAX
    predicts (unseen values are NaN, the missing branch);
  * the model text carries a ``pandas_categorical`` line and loads in
    both packages, each predicting a frame as its writer does;
  * a validation frame built with ``reference`` shares the codes.
"""

import os

import numpy as np
import pandas as pd
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.basic import _dataframe_to_matrix

from test_torch_categorical_trees import _compare
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
          "min_data_in_leaf": 20, "min_data_per_group": 20}
ROUNDS = 5


def frame(n=1000, seed=0):
    d = np.loadtxt(os.path.join(ROOT, "examples", "binary_classification",
                                "binary.train"))[:n]
    rng = np.random.RandomState(seed)
    df = pd.DataFrame(d[:, 1:7], columns=[f"x{i}" for i in range(6)])
    levels = [f"c{i}" for i in range(12)]
    cat = rng.randint(0, 12, n)
    df["cat"] = pd.Categorical([levels[i] for i in cat], categories=levels)
    obj = rng.randint(0, 5, n)
    df["obj"] = pd.Series(np.array(["a", "b", "c", "d", "e"], object)[obj],
                          dtype=object)
    df["txt"] = pd.Series([("u", "v", "w")[i % 3] for i in range(n)],
                          dtype="string")
    df["flag"] = rng.rand(n) < 0.4
    # a label the categoricals move
    y = d[:, 0].copy()
    flip = ((cat % 3 == 0) | (obj == 4)) & (rng.rand(n) < 0.6)
    y[flip] = 1.0 - y[flip]
    return df, y


@pytest.fixture(scope="module")
def trained():
    df, y = frame()
    jb = lgb.train(PARAMS, lgb.Dataset(df, label=y), ROUNDS)
    jb.num_trees()
    tb = lgt.train(dict(PARAMS, device_type="cpu"), lgt.Dataset(df, label=y),
                   ROUNDS)
    return df, y, jb, tb


def test_codes_and_categoricals_equal_jax(trained):
    df, _, jb, tb = trained
    mat, cats, maps = _dataframe_to_matrix(df)
    from lightgbm_tpu.basic import _dataframe_to_matrix as jax_codes
    jmat, jcats, jmaps = jax_codes(df)
    np.testing.assert_array_equal(mat, jmat)
    assert cats == jcats == [6, 7, 8, 9]
    assert maps == jmaps == tb.pandas_categorical == jb.pandas_categorical
    lr = tb._gbdt.learner
    assert lr.has_cat and lr.subtract
    assert sorted(np.nonzero(lr.is_cat)[0].tolist()) == [6, 7, 8, 9]


def test_trees_match_jax(trained):
    df, y, jb, tb = trained
    X = _dataframe_to_matrix(df)[0]
    assert sum(t.num_cat for t in tb._gbdt.models) > 0
    found = _compare(X, y, "binary", PARAMS, jb, tb,
                     tb._gbdt.train_data.bin_mappers, None)
    assert found is None
    np.testing.assert_allclose(tb.predict(df, raw_score=True),
                               jb.predict(df, raw_score=True), rtol=0,
                               atol=1e-5)


def test_reordered_and_unseen_categories_predict_as_jax(trained):
    df, _, jb, tb = trained
    new, _ = frame(400, seed=3)
    levels = list(new["cat"].cat.categories)
    vals = new["cat"].astype(object).tolist()
    vals[:40] = ["zz"] * 40                           # unseen
    new["cat"] = pd.Categorical(vals, categories=levels[::-1] + ["zz"])
    new.loc[new.index[:30], "obj"] = "never"           # unseen object value
    pt, pj = (b.predict(new, raw_score=True) for b in (tb, jb))
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
    # reordering the categories changes no prediction: codes follow the
    # training lists, not the frame's
    same = new.copy()
    same["cat"] = pd.Categorical(vals, categories=levels + ["zz"])
    np.testing.assert_array_equal(tb.predict(same, raw_score=True), pt)


def test_model_text_loads_both_ways(trained):
    df, _, jb, tb = trained
    text = tb.model_to_string()
    line = text.rstrip().split("\n")[-1]
    assert line.startswith("pandas_categorical:")
    port_in_jax = lgb.Booster(model_str=text)
    jax_in_port = lgt.Booster(model_str=jb.model_to_string(),
                              params={"device_type": "cpu"})
    assert port_in_jax.pandas_categorical == tb.pandas_categorical
    assert jax_in_port.pandas_categorical == jb.pandas_categorical
    new, _ = frame(300, seed=5)
    np.testing.assert_allclose(port_in_jax.predict(new, raw_score=True),
                               tb.predict(new, raw_score=True), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(jax_in_port.predict(new, raw_score=True),
                               jb.predict(new, raw_score=True), rtol=0,
                               atol=1e-5)


def test_validation_frame_shares_the_training_codes():
    df, y = frame()
    dv, yv = frame(500, seed=7)
    # the validation frame sees its categories in another order
    dv["obj"] = dv["obj"].iloc[::-1].values
    out = {}
    for name, mod, extra in (("jax", lgb, {}),
                             ("port", lgt, {"device_type": "cpu"})):
        dt = mod.Dataset(df, label=y)
        res = {}
        b = mod.train(dict(PARAMS, metric="binary_logloss", **extra), dt, 3,
                      valid_sets=[mod.Dataset(dv, label=yv, reference=dt)],
                      valid_names=["v"],
                      callbacks=[mod.record_evaluation(res)])
        out[name] = res["v"]["binary_logloss"]
        assert dt.pandas_categorical == b.pandas_categorical
    np.testing.assert_allclose(out["port"], out["jax"], rtol=1e-5)
