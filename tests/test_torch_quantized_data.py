"""Quantized-gradient training on the data layouts of earlier slices
against the JAX package, held split for split
(test_torch_quantized_trees.py ``compare``): one-hot columns that bundle
(EFB: the subtraction body with the feature view's scale arm), a
categorical column (the categorical search reads the scaled histograms),
and ``max_bin`` 1023 (a uint16 bin matrix), binary, 15 leaves.
"""

import numpy as np
import pytest

from test_torch_quantized_trees import check, example, train_jax, train_port
from torch_one_thread import one_torch_thread  # noqa: F401


def _data(case):
    X, y = example("binary_classification/binary.train")
    n = len(y)
    if case == "efb":
        return np.hstack([X, np.eye(6)[np.arange(n) % 6]]), y, {}, {}
    if case == "categorical":
        Xc = np.column_stack([X, np.arange(n) % 7])
        return Xc, y, {}, {"categorical_feature": [Xc.shape[1] - 1]}
    return X, y, {"max_bin": 1023}, {}


@pytest.mark.parametrize("case", ["efb", "categorical", "max_bin_1023"])
def test_trees_match_jax_on_each_layout(case):
    X, y, extra, ds_kw = _data(case)
    params = dict(objective="binary", quant_train_renew_leaf=True, **extra)
    jb = train_jax(X, y, params, rounds=3, **ds_kw)
    tb, rec = train_port(X, y, params, rounds=3, **ds_kw)
    lr = tb._gbdt.learner
    assert lr.subtract
    assert lr.bundled == (case == "efb")
    assert lr.has_cat == (case == "categorical")
    assert (lr.bin_dtype == np.uint16) == (case == "max_bin_1023")
    check(X, jb, tb, rec, params)
