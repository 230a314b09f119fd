"""Linear trees, ``linear_tree_mode`` refit, end to end:
``lightgbm_tpu_torch.train`` (``device_type`` cpu) against the JAX
package on ``examples/*``, 15 leaves, 5 iterations, on the mega body (K=1
and the frontier at K=4) and the histogram-subtraction body.

The trees grow by the constant gain; each leaf then gets its ridge fit
on the raw values of the features on its path (models/linear.py), on
the device, read back with the tree.  The trees are held split for
split (tests/torch_linear_cases.py), the linear leaves' features,
constants and coefficients to rtol 1e-4 / atol 1e-5, the raw predictions
to atol 1e-5, and the model text both ways, ``linear_lambda`` too
(degenerate leaves: test_torch_linear_degenerate.py; the training API:
test_torch_linear_api.py).
"""

import numpy as np
import pytest

from torch_boost_cases import BIN, BODIES, REG, example, train_both
from torch_linear_cases import check_linear
from torch_one_thread import one_torch_thread  # noqa: F401

ROUNDS = 5
LINEAR = {"num_leaves": 15, "linear_tree": True}
CPU = {"device_type": "cpu", "verbosity": -1}
# case: (data, params, body)
CASES = {
    "regression-mega": (REG, {"objective": "regression"}, "mega"),
    "regression-k4": (REG, {"objective": "regression"}, "k4"),
    "regression-sub": (REG, {"objective": "regression"}, "sub"),
    "binary-mega": (BIN, {"objective": "binary"}, "mega"),
    "binary-sub": (BIN, {"objective": "binary"}, "sub"),
    "regression-lambda-sub": (REG, {"objective": "regression",
                                    "linear_lambda": 2.5}, "sub"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_refit_matches_jax(case):
    data, extra, body = CASES[case]
    params = dict(LINEAR, **extra, **BODIES[body])
    jb, tb, rec = train_both(params, data, ROUNDS)
    g = tb._gbdt
    assert g._eager and g.linear and not g.learner.linear_gain
    assert g.learner.K == (4 if body == "k4" else 1)
    assert g.learner.subtract == (body == "sub")
    assert all(t.is_linear for t in g.models)
    X = example(data)[0]
    check_linear(X, jb, tb, rec, params)
    # the train scores carry the linear leaves' f32 outputs
    np.testing.assert_allclose(g.scores.numpy(), np.asarray(jb._gbdt.scores),
                               rtol=0, atol=1e-5)
    # one host read a tree, the fit's results riding it
    assert g.learner.syncs == ROUNDS
    # most leaves are linear, each on the features of its path
    lin = sum(len(c) > 0 for t in g.models for c in t.leaf_coeff)
    assert lin > ROUNDS * 10
