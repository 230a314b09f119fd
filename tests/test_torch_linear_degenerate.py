"""Linear trees (``linear_tree_mode`` refit) on degenerate leaves, the
port (``device_type`` cpu) against the JAX package: a column 90% NaN and
a constant column (JAX test_linear_leafwise.py's data), and a leaf whose
normal equations are exactly singular.  A leaf keeps its constant value
where the JAX package's fit keeps it: no usable column, fewer rows than
columns + 1, a singular solve, a coefficient not finite.  And
``init_model`` from either package's linear model.
"""

from unittest import mock

import numpy as np

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.models import linear as linmod

from torch_boost_cases import REG, example, train_both
from torch_linear_cases import check_linear, linear_leaves_close
from torch_one_thread import one_torch_thread  # noqa: F401

LINEAR = {"num_leaves": 15, "linear_tree": True}
CPU = {"device_type": "cpu", "verbosity": -1}


def _smooth(n=1500, f=5, seed=3, nan_col=None, const_col=None):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    if const_col is not None:
        X[:, const_col] = 1.5
    if nan_col is not None:
        X[rng.rand(n) < 0.9, nan_col] = np.nan
    y = (2.0 * X[:, 0] + np.sin(2.0 * X[:, 1])
         + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X.astype(np.float64), y.astype(np.float64)


def test_nan_and_constant_columns_keep_constant_leaves():
    """A column 90% NaN and a constant column (JAX
    test_linear_leafwise.py's degenerate data): NaN rows leave the fit,
    a constant column never gets a slope, a leaf without a usable column
    or with too few rows keeps its constant value, and NaN rows predict
    their leaf's constant value.  Trees and linear leaves as JAX's."""
    X, y = _smooth(nan_col=2, const_col=3)
    params = dict(LINEAR, objective="regression", learning_rate=0.2,
                  min_data_in_leaf=20)
    jb, tb, rec = train_both(params, (X, y), 8)
    check_linear(X, jb, tb, rec, params)
    for t in tb._gbdt.models:
        assert all(3 not in fs for fs in t.leaf_features)
    # some leaves saw NaN rows on a path through column 2, and some
    # leaves fell back for want of rows
    status = tb._gbdt.last_linear_status
    assert status is not None and len(status) == 15
    Xn = X.copy()
    Xn[:, 0] = np.nan
    np.testing.assert_allclose(tb.predict(Xn, raw_score=True),
                               jb.predict(Xn, raw_score=True), rtol=0,
                               atol=1e-5)


def _few_data(n=2000, seed=5):
    """Two 0/1 columns (constant in every leaf below their splits), one
    97% NaN, one normal."""
    rng = np.random.RandomState(seed)
    X = np.column_stack([rng.randint(0, 2, n), rng.randint(0, 2, n),
                         rng.normal(size=n), rng.normal(size=n)]).astype(
        np.float64)
    X[rng.rand(n) < 0.97, 2] = np.nan
    y = (3 * X[:, 0] - 2 * X[:, 1] + 2 * np.nan_to_num(X[:, 2])
         + 0.5 * X[:, 3] + 0.1 * rng.normal(size=n))
    return X, y


def test_leaves_without_columns_or_rows_keep_their_constant():
    """Leaves whose path columns are all constant over their rows (the 0/1
    columns) keep their constant value for want of a column, and leaves
    left with fewer rows than columns + 1 once their NaN rows go, for
    want of rows: the same leaves as in the JAX package."""
    X, y = _few_data()
    params = dict(LINEAR, objective="regression", min_data_in_leaf=5)
    status = []
    unpack = linmod.unpack

    def keep(tree, packed):
        status.append(unpack(tree, packed))
        return status[-1]

    with mock.patch.object(linmod, "unpack", keep):
        jb, tb, rec = train_both(params, (X, y), 4)
    check_linear(X, jb, tb, rec, params)
    seen = np.bincount(np.concatenate(status), minlength=5)
    assert seen[linmod.LIN_NO_FEATURES] > 0 and seen[linmod.LIN_FEW_ROWS] > 0
    assert seen[linmod.LIN_OK] > 0.5 * seen.sum()


def _singular_data():
    """One feature: x = 1 (16 rows), x = 2 (8 rows), NaN (32 rows), then
    x = 5 and x = 6 (30 rows each)."""
    x = np.concatenate([np.ones(16), np.full(8, 2.0), np.full(32, np.nan),
                        np.full(30, 5.0), np.full(30, 6.0)])
    X = np.column_stack([x, np.linspace(0, 1, len(x))])
    return X, np.zeros(len(x))


def _singular_fobj(preds, train_data):
    """Gradients that split the rows at x = 2 | 5 with the NaN rows left
    (g -4, h 1 against g 2, h 1 on the right; x = 1 and x = 2 rows carry
    g 0, so a threshold at 1 | 2 ties exactly and both packages' scan
    order takes 2 | 5), and whose left leaf's fit sees Σh = Σhx = Σhx² =
    -1 (x = 1 rows at h = -1/16, x = 2 rows at h = 0): its normal
    equations [[-1, -1], [-1, -1]] keep their values under the ridge
    (eps (1 + diag) = 0 at diag -1), an exactly singular matrix.  The
    NaN rows give the leaf its hessian mass."""
    x = _singular_data()[0][:, 0]
    nan = np.isnan(x)
    g = np.where(nan, -4.0, np.where(x > 3, 2.0, 0.0))
    h = np.where(nan | (x > 3), 1.0, np.where(x == 1, -1.0 / 16, 0.0))
    return g, h


def test_singular_normal_equations_keep_the_constant_leaf():
    """Where LAPACK's gesv meets an exactly singular system (the JAX
    package's ``np.linalg.solve`` raises and keeps the constant leaf),
    the port's ``torch.linalg.solve_ex`` reports it in ``info`` and keeps
    it too."""
    X, y = _singular_data()
    params = dict(LINEAR, num_leaves=2, min_data_in_leaf=5,
                  min_sum_hessian_in_leaf=0.0, objective=_singular_fobj,
                  verbosity=-1)
    jb = lgb.train(params, lgb.Dataset(X, label=y), 1)
    tb = lgt.train(dict(params, device_type="cpu"),
                   lgt.Dataset(X, label=y), 1)
    a, b = jb._gbdt.models[0], tb._gbdt.models[0]
    assert a.num_leaves == b.num_leaves == 2
    np.testing.assert_array_equal(b.threshold, a.threshold)
    assert 2 < a.threshold[0] < 5 and a.decision_type[0] & 2  # NaN left
    left = ~int(a.left_child[0])
    assert a.leaf_features[left] == [] == b.leaf_features[left]
    assert tb._gbdt.last_linear_status[left] == linmod.LIN_SINGULAR
    linear_leaves_close(a, b)


def test_init_model_both_ways():
    """A JAX-written linear model continued by the port, and the port's
    continued by JAX: the same trees and predictions (atol 1e-5)."""
    X, y = example(REG)
    params = dict(LINEAR, objective="regression")
    j3 = lgb.train(dict(params, verbosity=-1), lgb.Dataset(X, label=y), 3)
    t3 = lgt.train(dict(params, **CPU), lgt.Dataset(X, label=y), 3)
    np.testing.assert_allclose(t3.predict(X, raw_score=True),
                               j3.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)
    tj = lgt.train(dict(params, **CPU), lgt.Dataset(X, label=y), 2,
                   init_model=j3.model_to_string())
    jt = lgb.train(dict(params, verbosity=-1), lgb.Dataset(X, label=y), 2,
                   init_model=lgb.Booster(model_str=t3.model_to_string()))
    jj = lgb.train(dict(params, verbosity=-1), lgb.Dataset(X, label=y), 2,
                   init_model=j3)
    assert tj.num_trees() == jt.num_trees() == jj.num_trees() == 5
    for b in (tj, jt):
        for a, c in zip(b._gbdt.models, jj._gbdt.models):
            np.testing.assert_array_equal(a.split_feature, c.split_feature)
        np.testing.assert_allclose(b.predict(X, raw_score=True),
                                   jj.predict(X, raw_score=True), rtol=0,
                                   atol=1e-5)
