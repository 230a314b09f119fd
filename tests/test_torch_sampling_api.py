"""Sampling through the rest of the training API, against the JAX
package on the CPU (``examples/binary_classification/binary.train``):

  * GOSS, in lockstep: before each iteration the port takes the JAX
    package's whole physical state (the permuted bins, row ids, scores
    and payload), so both sample from the same gradients (to the last
    bit of their sigmoids) and every one of the five trees is compared.
    GOSS keeps the rows whose |g h| reaches the top_rate-th largest, and
    binary gradients take few distinct values, so without the lockstep
    the f32 rounding of two packages' scores (within the repo's bar)
    moves whole groups of tied rows across that threshold after a few
    trees;

A custom objective's sampling is tests/test_torch_sampling_fobj.py's.

Tolerances: the repo's bar (tests/test_torch_efb.py ``_same_trees``),
or at a tree's first differing split the tie rule of ROADMAP.md C
(``_goss_tie`` below for GOSS).
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from test_torch_efb import _structure
from test_torch_sampling import _load
from test_torch_sampling_iter import _orig
from test_torch_train import _first_tie, _leaf_sets, _split_gain64
from torch_one_thread import one_torch_thread  # noqa: F401

ROUNDS = 5
BASE = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
NO_REG = (0.0, 0.0, 0.0)

# GOSS params -> the (tree, split, kind) of every tree that splits
# differently; each reproduces on every run (the lockstep is
# deterministic)
GOSS_CASES = {
    "defaults": ({}, [(1, 10, "f32")]),
    "bagging_seed_5": ({"bagging_seed": 5}, [(0, 5, "exact")]),
    "top_0.3_other_0.2": ({"top_rate": 0.3, "other_rate": 0.2}, []),
}


def _goss_tie(a, b, lvj, lvt, grads, t):
    """(split, kind) of the first split of tree ``a`` (JAX) and ``b``
    (port) that partitions the rows differently, None when none does.
    Its two choices' f64 gains are recounted from each package's sampled
    (g, h) in ``grads``, and both recounts must agree: ``exact`` when
    the gains are equal to 1e-9 of the leaf gains (the rule of
    ``_first_tie``); else ``f32`` -- equal to f32 resolution (2^-23 of
    the leaf gains, which both packages' f32 gains cannot order) and the
    port's choice the f64-better one."""
    found = set()
    for g, h in grads:
        s = _first_tie(a, b, lvj, lvt, g, h, NO_REG, t, rtol=2.0 ** -23)
        if s is None:
            found.add(None)
            continue
        (vj, mj), (vt, mt) = (
            _split_gain64(*[np.isin(lv, list(x)) for x in _leaf_sets(tr)[s]],
                          g, h, NO_REG)
            for tr, lv in ((a, lvj), (b, lvt)))
        if abs(vj - vt) <= 1e-9 * max(1.0, mj, mt):
            found.add((s, "exact"))
        else:
            assert vt > vj, (t, s, vj, vt)
            found.add((s, "f32"))
    assert len(found) == 1, found
    return found.pop()


@pytest.mark.parametrize("case", sorted(GOSS_CASES))
def test_goss_lockstep_matches_jax(case):
    """Each iteration samples the same rows in both packages, and each
    of the five trees is the same, or its first differing split is a tie
    (ROADMAP.md C: GOSS's up-weighted rows make near-zero-gain splits
    that f32 gains cannot order)."""
    extra, expected = GOSS_CASES[case]
    X, y = _load()
    N = len(y)
    p = dict(BASE, data_sample_strategy="goss", **extra)
    jb = lgb.Booster(dict(p, tpu_frontier_k=1), lgb.Dataset(X, label=y))
    tb = lgt.Booster(dict(p, device_type="cpu"), lgt.Dataset(X, label=y))
    ties = []
    for it in range(ROUNDS):
        if it:
            jp, jg = (np.asarray(x) for x in jb._gbdt._phys)
            tp, tg = tb._gbdt._phys
            tp.copy_(torch.from_numpy(jp.copy()))
            tg[2:] = torch.from_numpy(jg[2:].copy())
        jb.update()
        tb.update()
        jb.num_trees()
        a = _orig(np.asarray(jb._gbdt._phys[1]), N)
        b = _orig(tb._gbdt._phys[1].numpy(), N)
        # the same rows sampled; the gradients of the same scores differ
        # in the last bit where the packages' sigmoids round differently
        np.testing.assert_array_equal(a != 0, b != 0)
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
        assert 0 < int(tb._gbdt.learner.bag[0]) == int((b[1] != 0).sum()) < N
        ja, ta = jb._gbdt.models[-1], tb._gbdt.models[-1]
        lvj = np.asarray(jb.predict(X, pred_leaf=True))[:, it]
        lvt = np.asarray(tb.predict(X, pred_leaf=True))[:, it]
        tie = _goss_tie(ja, ta, lvj, lvt, [x.astype(np.float64)
                                           for x in (a, b)], it)
        if tie is not None:
            ties.append((it,) + tie)
            continue
        assert _structure(ja) == _structure(ta)
        np.testing.assert_allclose(ta.leaf_value, ja.leaf_value, rtol=1e-4,
                                   atol=1e-5)
    assert ties == expected
