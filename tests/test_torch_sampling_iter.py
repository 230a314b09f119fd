"""The fused iteration's sampling in both packages on the same data,
``examples/binary_classification/binary.train``:

  * one and two iterations of bagging, balanced bagging and GOSS: the
    sampled gradients of the first iteration are bit for bit equal, the
    masks and in-bag counts of both;
  * ``init_model``: a bagged run with feature_fraction continued for
    three more trees, its draws keyed by the continued iteration count
    as in JAX (the repo's bar, tests/test_torch_efb.py ``_same_trees``).
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from test_torch_sampling import _load
from test_torch_efb import _same_trees
from torch_one_thread import one_torch_thread  # noqa: F401

ITER_CASES = {
    "bag": dict(bagging_fraction=0.7, bagging_freq=2),
    "balanced": dict(pos_bagging_fraction=0.5, neg_bagging_fraction=0.9,
                     bagging_freq=1),
    "goss": dict(data_sample_strategy="goss"),
}


def _orig(ghi, N):
    """Payload rows 0 and 1 in original row order."""
    rid = ghi[2].view(np.int32)
    keep = rid < N
    out = np.zeros((2, N), np.float32)
    out[:, rid[keep]] = ghi[:2, keep]
    return out


@pytest.mark.parametrize("case", sorted(ITER_CASES))
def test_fused_iteration_samples_as_jax(case):
    """After each of two iterations both packages' payloads hold the
    sampled gradients, and each tree's root counts the in-bag rows: the
    first iteration's gradients bit for bit, both iterations' masks and
    counts equal."""
    X, y = _load()
    N = len(y)
    p = dict({"objective": "binary", "num_leaves": 7, "verbosity": -1},
             **ITER_CASES[case])
    jb = lgb.Booster(dict(p, tpu_frontier_k=1), lgb.Dataset(X, label=y))
    tb = lgt.Booster(dict(p, device_type="cpu"), lgt.Dataset(X, label=y))
    for it in range(2):
        jb.update()
        tb.update()
        a = _orig(np.asarray(jb._gbdt._phys[1]), N)
        b = _orig(tb._gbdt._phys[1].numpy(), N)
        if it == 0:
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
        np.testing.assert_array_equal(a[1] != 0, b[1] != 0)
        jb.num_trees()
        cnt = int(tb._gbdt.learner.bag[0])
        assert 0 < cnt < N and cnt == int((b[1] != 0).sum())
        assert tb._gbdt.models[-1].internal_count[0] == cnt
        assert jb._gbdt.models[-1].internal_count[0] == cnt


def test_init_model_continues_a_bagged_run_as_jax():
    X, y = _load()
    p = dict({"objective": "binary", "num_leaves": 15, "verbosity": -1},
             bagging_fraction=0.7, bagging_freq=2,
             feature_fraction=0.8, min_data_in_leaf=20)
    runs = {}
    for name, mod, extra in (("jax", lgb, {"tpu_frontier_k": 1,
                                           "tpu_megakernel": "xla"}),
                             ("port", lgt, {"device_type": "cpu"})):
        base = mod.train(dict(p, **extra), mod.Dataset(X, label=y), 3)
        base.num_trees()
        runs[name] = mod.train(dict(p, **extra), mod.Dataset(X, label=y), 3,
                               init_model=base.model_to_string())
        runs[name].num_trees()
    tb = runs["port"]
    assert tb.num_trees() == 6 and tb._gbdt.iter == 6
    _same_trees(runs["jax"], tb)
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               runs["jax"].predict(X, raw_score=True),
                               rtol=0, atol=1e-5)
