"""The eager iteration end to end: ``tpu_fused_iteration=false`` (bagging,
balanced bagging, GOSS, quantized gradients, 3 classes) and GOSS with
the renewing objectives (``regression_l1``, ``quantile``, ``mape``), which
the JAX package trains eagerly whatever the flag says, against the JAX
package on ``examples/*``, 15 leaves, a few iterations, on the mega body
(K=1 and the frontier at K=4) and the histogram-subtraction body.

The port draws as that iteration does: the gradients leave the payload
for original row order, where the bag (an exact count by a permutation),
GOSS and the quantization (``quant_rng`` at the row id) are drawn, and
the L1 family renews its leaves over the eager draw's rows (GOSS's kept
rows).  Trees are held split for split with the repo's tie rule
(tests/torch_boost_cases.py ``compare``): balanced bagging on binary
labels and quantile (one gradient value a side of each leaf's alpha
quantile) meet exact ties in their first tree.  ``reset_parameter``
reaches the eager draws between iterations, as in JAX.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

from test_torch_multiclass import mc_data
from torch_boost_cases import (BAG, BIN, BODIES, REG, check, example,
                               train_both)
from torch_one_thread import one_torch_thread  # noqa: F401

ROUNDS = 4
EAGER = {"tpu_fused_iteration": False}
GOSS = {"data_sample_strategy": "goss"}
# case: (data, params, body, tie)
CASES = {
    "bagging-mega": (BIN, dict(EAGER, objective="binary", **BAG), "mega",
                     None),
    "balanced-sub": (BIN, dict(EAGER, objective="binary",
                               pos_bagging_fraction=0.7,
                               neg_bagging_fraction=0.5, bagging_freq=1),
                     "sub", (0, 13)),
    "goss-k4": (REG, dict(EAGER, objective="regression", **GOSS), "k4",
                None),
    "quantized-bagging-mega": (BIN, dict(EAGER, objective="binary",
                                         use_quantized_grad=True, **BAG),
                               "mega", None),
    "classes-3-bagging-sub": ("mc3", dict(EAGER, objective="multiclass",
                                          num_class=3, **BAG), "sub", None),
    "goss-l1-mega": (REG, dict(objective="regression_l1", **GOSS), "mega",
                     None),
    "goss-quantile-sub": (REG, dict(objective="quantile", **GOSS), "sub",
                          (0, 7)),
    "goss-mape-k4": (REG, dict(objective="mape", **GOSS), "k4", None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_eager_trees_match_jax(case):
    data, extra, body, tie = CASES[case]
    params = dict(extra, num_leaves=15, **BODIES[body])
    if data == "mc3":
        # a seeded init score: more than 3 gradient values, no tie
        X, y = mc_data(3)
        data = (X, y, np.random.RandomState(4).randn(3 * len(y)) * 0.5)
    X = example(data)[0] if isinstance(data, str) else data[0]
    jb, tb, rec = train_both(params, data, ROUNDS)
    tg = tb._gbdt
    assert tg._eager and not tg._class_fused_draw
    if "data_sample_strategy" in extra:
        # the last iteration's GOSS rows: the bag its tree counted, the
        # rows its renewal read
        assert int(tg._bag_mask.sum()) == tg.models[-1].internal_count[0]
    check(X, jb, tb, rec, params, tie)
    if tie is None:
        np.testing.assert_allclose(tg.scores.numpy(),
                                   np.asarray(jb._gbdt.scores), rtol=0,
                                   atol=1e-5)


def test_reset_parameter_reaches_the_eager_draws():
    """Two iterations at bagging 0.7, then ``reset_parameter`` to 0.5 and
    ``feature_fraction`` 0.6: the bags' counts and the trees equal JAX's."""
    X, y = example(BIN)
    params = dict(EAGER, objective="binary", num_leaves=15, verbosity=-1,
                  **BAG)
    out = {}
    for name, mod, extra in (("jax", lgb, {}),
                             ("port", lgt, {"device_type": "cpu"})):
        b = mod.Booster(dict(params, **extra), mod.Dataset(X, label=y))
        for i in range(4):
            if i == 2:
                b.reset_parameter({"bagging_fraction": 0.5,
                                   "feature_fraction": 0.6})
            b.update()
        out[name] = b
    jt, tt = out["jax"]._gbdt.models, out["port"]._gbdt.models
    assert [t.internal_count[0] for t in tt] == [700, 700, 500, 500]
    assert [t.internal_count[0] for t in jt] == [700, 700, 500, 500]
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold, b.threshold)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)
