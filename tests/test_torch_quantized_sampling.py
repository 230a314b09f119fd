"""Quantized-gradient training with row sampling against the JAX package,
held split for split (test_torch_quantized_trees.py ``compare``): the
fused iteration's bagging and balanced bagging on binary data, GOSS
(whose rows are kept by the draw at their physical position, and whose
re-weighted hessians the discretizer sums as integers), and a bagged L2
with ``quant_train_renew_leaf`` on the subtraction body, whose
constant-hessian shortcut gives out-of-bag rows a hessian of 1 as the
JAX package's fused discretizer does.
"""

import numpy as np
import pytest

from test_torch_quantized_trees import check, example, train_jax, train_port
from torch_one_thread import one_torch_thread  # noqa: F401

CASES = {
    "bagging": ("binary", dict(bagging_fraction=0.7, bagging_freq=1)),
    "balanced": ("binary", dict(pos_bagging_fraction=0.8,
                                neg_bagging_fraction=0.6, bagging_freq=1)),
    "goss": ("binary", dict(data_sample_strategy="goss")),
    "bagged_l2_renew": ("regression", dict(
        bagging_fraction=0.7, bagging_freq=1, tpu_megakernel="off",
        quant_train_renew_leaf=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sampled_trees_match_jax(case):
    objective, extra = CASES[case]
    name = ("binary_classification/binary.train" if objective == "binary"
            else "regression/regression.train")
    X, y = example(name)
    params = dict(objective=objective, **extra)
    jb = train_jax(X, y, params, rounds=3)
    tb, rec = train_port(X, y, params, rounds=3)
    assert not tb._gbdt._eager_quant
    counts = [t.internal_count[0] for t in tb._gbdt.models]
    assert all(c < len(y) for c in counts)
    if case == "bagged_l2_renew":
        # out-of-bag rows keep an integer hessian of 1 (the constant-
        # hessian shortcut), in-bag rows too: every row sums
        assert np.all(rec[0][1] == rec[0][1].max())
    check(X, jb, tb, rec, params)
