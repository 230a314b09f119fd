"""Wide bins end to end: ``lightgbm_tpu_torch.train`` (``device_type``
cpu) against the JAX package (``tpu_frontier_k=1``) on data the JAX
package stores as a uint16 bin matrix -- binary and regression on the
repo's examples at ``max_bin`` 1023 here; ``max_bin_by_feature`` and
multiclass in test_torch_u16_train_more.py, a 400-level categorical in
test_torch_u16_cat.py.  5 trees of 15 leaves.

The tie rule of ROADMAP section C (``test_torch_categorical_trees``
``_compare``): both packages' trees are walked split by split on the
training rows, every tree before the first differing split holds leaf
values to rtol 1e-4 / atol 1e-5, and a differing split must be an exact
tie in f64 (``ties``: none is met here).  With no tie, raw
predictions agree to atol 1e-5, and the model text loads both ways: the
port's in lightgbm_tpu and JAX's in the port predict the same raw
scores (atol 1e-5) and leaves.
"""

import os

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

from test_torch_categorical_trees import _compare
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 5


def example(name):
    d = np.loadtxt(os.path.join(ROOT, "examples", name))
    return d[:, 1:], d[:, 0]


def check_both_ways(X, objective, jb, tb):
    """Raw predictions agree; each package's model text loads in the
    other and predicts what its writer predicts."""
    pj, pt = (b.predict(X, raw_score=True) for b in (jb, tb))
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
    port_in_jax = lgb.Booster(model_str=tb.model_to_string())
    jax_in_port = lgt.Booster(model_str=jb.model_to_string(),
                              params={"device_type": "cpu"})
    np.testing.assert_allclose(port_in_jax.predict(X, raw_score=True), pt,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(jax_in_port.predict(X, raw_score=True), pj,
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(jax_in_port.predict(X, pred_leaf=True),
                                  jb.predict(X, pred_leaf=True))


def train_and_check(X, y, params, cats=None, ties=None):
    """Train both packages, hold the port to JAX by the tie rule and the
    model text both ways; returns the port's booster."""
    objective = params["objective"]
    params = dict(params, num_leaves=15, verbosity=-1, min_data_in_leaf=20)
    kw = {} if cats is None else {"categorical_feature": cats}
    jb = lgb.train(dict(params, tpu_frontier_k=1), lgb.Dataset(X, label=y,
                                                               **kw), ROUNDS)
    tb = lgt.train(dict(params, device_type="cpu"),
                   lgt.Dataset(X, label=y, **kw), ROUNDS)
    lr = tb._gbdt.learner
    assert lr.bin_dtype == np.uint16 and lr.B > 256
    assert lr.subtract and lr.K == 1
    found = _compare(X, y, objective, params, jb, tb, lr.ds.bin_mappers,
                     None)
    assert found == ties
    if found is None:
        check_both_ways(X, objective, jb, tb)
    return tb


CASES = {
    "binary_1023": ("binary_classification/binary.train",
                    {"objective": "binary", "max_bin": 1023}),
    "regression_1023": ("regression/regression.train",
                        {"objective": "regression", "max_bin": 1023}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_max_bin_1023_trains_as_jax(case):
    path, params = CASES[case]
    X, y = example(path)
    train_and_check(X, y, params)

