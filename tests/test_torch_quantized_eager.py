"""Quantized-gradient training where the JAX package takes its eager
iteration -- a custom objective (``fobj``) and the renewing L1 objective
(multiclass in test_torch_quantized_multiclass.py) -- against the JAX
package, held split for split (test_torch_quantized_trees.py
``compare``).  The port draws there as that iteration does: the
``quant_rng`` chain at each row's original id, the eager bag (an exact
count), no constant-hessian shortcut under sampling, and the L1 renewal
over the eager bag after the quantized one.
"""

import numpy as np

from test_torch_quantized_trees import check, example, train_jax, train_port
from torch_one_thread import one_torch_thread  # noqa: F401

BAG = dict(bagging_fraction=0.7, bagging_freq=1)


def test_regression_l1_bagged_renewal_trees_match_jax():
    X, y = example("regression/regression.train")
    params = dict(objective="regression_l1", quant_train_renew_leaf=True,
                  **BAG)
    jb = train_jax(X, y, params, rounds=3)
    tb, rec = train_port(X, y, params, rounds=3)
    assert tb._gbdt._eager_quant
    counts = [t.internal_count[0] for t in tb._gbdt.models]
    assert counts == [int(len(y) * 0.7)] * 3
    # sampled: the hessians are quantized, not the shortcut's ones
    assert rec[0][1].min() == 0.0
    check(X, jb, tb, rec, params)


def _fobj(score, dataset):
    """The binary logloss's gradients, as a custom objective."""
    y = dataset.get_label()
    p = 1.0 / (1.0 + np.exp(-np.asarray(score, np.float64)))
    return p - y, p * (1.0 - p)


def test_custom_objective_trees_match_jax():
    X, y = example("binary_classification/binary.train")
    params = dict(objective=_fobj, metric="None", **BAG)
    jb = train_jax(X, y, params, rounds=3)
    tb, rec = train_port(X, y, params, rounds=3)
    assert tb._gbdt._eager_quant
    check(X, jb, tb, rec, dict(params, objective="custom"))
