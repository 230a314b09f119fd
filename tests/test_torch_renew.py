"""The port's leaf renewal (models/renew.py) against the JAX package's
device renewal ``_renew_leaves_percentile`` and its host percentile
``_weighted_percentile_host``, on seeded leaves (contiguous row ranges
in a shuffled column order, unused columns of no rows, leaves of one
row), residuals with ties, bag masks (a leaf with no in-bag row keeps
its value) and weights.

Unweighted, the port runs the JAX function's f32 arithmetic: the renewed
values are bit-identical to it.  Weighted, the port keeps float64
cumulative weights and interpolates in float64 as
``_weighted_percentile_host`` does, and equals the host function.  The
JAX device function picks the same elements but interpolates in f32
from an f32 running sum over all rows: within the repo's leaf-value bar,
rtol 1e-4 / atol 1e-5, of the port.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lightgbm_tpu.models.boosting import _renew_leaves_percentile
from lightgbm_tpu.models.objective import _weighted_percentile_host

from lightgbm_tpu_torch.models.renew import order_bits, renew_leaves

C, N, PAD, L = 64, 1800, 200, 24


def _leaves(rng):
    """(starts, cnts) of L leaf columns tiling [C, C + N) in a shuffled
    order, four columns without rows, two leaves of one row."""
    used = L - 4
    cuts = np.sort(rng.choice(np.arange(3, N - 3), used - 3, replace=False))
    sizes = np.diff(np.concatenate([[0], cuts, [N]]))
    sizes = np.concatenate([sizes, [1, 1]])
    sizes[0] -= 2
    starts = C + np.concatenate([[0], np.cumsum(sizes)[:-1]])
    perm = rng.permutation(L)
    s = np.full(L, 0, np.int32)
    c = np.zeros(L, np.int32)
    s[perm[:used]] = starts
    c[perm[:used]] = sizes
    return s, c


def _case(seed, weights, bag):
    rng = np.random.RandomState(seed)
    starts, cnts = _leaves(rng)
    resid = np.round(rng.randn(N + PAD + C) * 3, 1).astype(np.float32)
    resid[rng.rand(len(resid)) < 0.02] = -0.0
    sel = np.zeros(len(resid), bool)
    sel[C:C + N] = rng.rand(N) < bag if bag < 1 else True
    # a leaf of several rows with none in the bag keeps its value
    big = int(np.argmax(cnts))
    sel[starts[big]:starts[big] + cnts[big]] = False
    w = None
    if weights == "int":
        w = rng.randint(0, 4, len(resid)).astype(np.float32)
    elif weights == "real":
        w = rng.uniform(0.1, 2.5, len(resid)).astype(np.float32)
    old = rng.randn(L).astype(np.float32)
    return starts, cnts, resid, sel, w, old, big


def _port(starts, cnts, resid, sel, w, old, alpha):
    sl = slice(C, C + N)
    t = (lambda a: None if a is None else torch.from_numpy(a[sl].copy()))
    return renew_leaves(torch.from_numpy(starts - C), torch.from_numpy(cnts),
                        torch.from_numpy(old), t(resid), t(sel), t(w),
                        alpha).numpy()


def _jax(starts, cnts, resid, sel, w, old, alpha):
    rec = {"leaf_start": jnp.asarray(starts), "leaf_cnt": jnp.asarray(cnts),
           "leaf_value": jnp.asarray(old)}
    return np.asarray(_renew_leaves_percentile(
        rec, jnp.asarray(resid), None if w is None else jnp.asarray(w),
        jnp.asarray(sel), alpha, len(resid)))


def _host(starts, cnts, resid, sel, w, old, alpha):
    out = old.copy()
    for j in range(L):
        rows = np.arange(starts[j], starts[j] + cnts[j])
        rows = rows[sel[rows]]
        if len(rows):
            out[j] = _weighted_percentile_host(
                resid[rows], None if w is None else w[rows], alpha)
    return out


@pytest.mark.parametrize("bag", [1.0, 0.7])
@pytest.mark.parametrize("alpha", [0.5, 0.9, 0.25])
@pytest.mark.parametrize("seed", [0, 1])
def test_unweighted_renewal_bit_identical_to_jax(seed, alpha, bag):
    case = _case(seed, None, bag)
    got = _port(*case[:6], alpha)
    np.testing.assert_array_equal(got.view(np.int32),
                                  _jax(*case[:6], alpha).view(np.int32))
    assert got[case[6]] == case[5][case[6]]
    # the host percentile in float64 rounds its interpolation once
    np.testing.assert_allclose(got, _host(*case[:6], alpha), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("weights", ["int", "real"])
@pytest.mark.parametrize("alpha", [0.5, 0.8])
@pytest.mark.parametrize("bag", [1.0, 0.6])
def test_weighted_renewal_matches_host_and_jax(weights, alpha, bag):
    case = _case(3, weights, bag)
    got = _port(*case[:6], alpha)
    np.testing.assert_array_equal(got, _host(*case[:6], alpha))
    np.testing.assert_allclose(got, _jax(*case[:6], alpha), rtol=1e-4,
                               atol=1e-5)
    assert got[case[6]] == case[5][case[6]]


def test_order_bits_orders_like_floats():
    x = torch.tensor([3.5, -0.0, 0.0, -1e-30, 1e-30, -7.0, float("inf"),
                      -float("inf"), 2.0])
    keys = order_bits(x)
    assert keys.min() >= 0 and keys.max() < (1 << 32)
    assert torch.equal(torch.argsort(keys, stable=True),
                       torch.argsort(x, stable=True))
