"""Sampling of a custom objective's gradients (``fobj``) against the JAX
package on the CPU (``examples/binary_classification/binary.train``):
both packages train it through their eager iteration -- the bag redrawn
every ``bagging_freq`` iterations as a permutation's first
``bagging_fraction * N`` rows, balanced bagging by the label, and GOSS
from a fresh split of the bagging rng each iteration.  The objective
returns fixed gradients per call, so both packages sample the same rows.
Tolerances: the repo's bar (tests/test_torch_efb.py ``_same_trees``).
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from test_torch_efb import _same_trees
from test_torch_sampling import _load
from torch_one_thread import one_torch_thread  # noqa: F401

ROUNDS = 5
BASE = {"objective": "binary", "num_leaves": 15, "verbosity": -1}


def _fixed_fobj(N):
    """A custom objective whose gradients are fixed draws per call."""
    calls = []

    def fobj(score, dataset):
        rng = np.random.RandomState(len(calls))
        calls.append(1)
        return rng.randn(N), rng.rand(N) + 0.05
    return fobj


EAGER = {
    "bagging": dict(bagging_fraction=0.7, bagging_freq=2),
    "balanced": dict(pos_bagging_fraction=0.5, neg_bagging_fraction=0.9,
                     bagging_freq=1),
    "goss": dict(data_sample_strategy="goss"),
}


@pytest.mark.parametrize("case", sorted(EAGER))
def test_custom_objective_samples_as_jax(case):
    X, y = _load()
    N = len(y)
    out = {}
    for name, mod, extra in (("jax", lgb, {"tpu_frontier_k": 1}),
                             ("port", lgt, {"device_type": "cpu"})):
        params = dict(BASE, objective=_fixed_fobj(N), metric="None",
                      **EAGER[case], **extra)
        out[name] = mod.train(params, mod.Dataset(X, label=y), ROUNDS)
        out[name].num_trees()
    _same_trees(out["jax"], out["port"])
    counts = [t.internal_count[0] for t in out["port"]._gbdt.models]
    assert all(c < N for c in counts)
    if case == "bagging":           # an exact count, redrawn every 2
        assert counts == [int(N * 0.7)] * ROUNDS
