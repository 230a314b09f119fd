"""The port's leaf histogram (lightgbm_tpu_torch/ops/histogram.py)
against the JAX package's ``leaf_hist_slice``, the XLA form of
``leaf_hist_pallas`` with the same contract (``leaf_hist_pallas`` has no
interpret mode and runs on a TPU only).

Tolerances: the port's plain version sums in f64 and rounds once, so it
is within one f32 rounding (rtol 2^-23) of the f64 sums of a numpy
oracle.  ``leaf_hist_slice`` sums each 256-row chunk with an f32 one-hot
matmul and adds the chunks in f32; it is held to the f64 sums, and the
port to it, within rtol 1e-5 + atol 1e-5 x each bin's absolute mass (the
sum of |grad| or |hess| over the bin's rows: f32 rounding grows with it,
and a bin here holds a few rows of a few hundred).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu.ops.histogram import leaf_hist_slice
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops.partition import make_scalars, partition_leaf

C, R, G, B = 256, 32, 28, 255
NP = 8 * C


def _buffers(seed):
    rng = np.random.RandomState(seed)
    pb = rng.randint(0, B, (R, NP)).astype(np.uint8)
    pg = rng.randn(8, NP).astype(np.float32)
    pg[1] = np.abs(pg[1])
    return rng, pb, pg


def _oracle(pb, pg, s, c):
    """f64 (G, B, 2) sums and absolute masses of the rows [s, s + c)."""
    ref = np.zeros((G, B, 2))
    mass = np.zeros((G, B, 2))
    for p in range(2):
        v = pg[p, s:s + c].astype(np.float64)
        for g in range(G):
            np.add.at(ref[g, :, p], pb[g, s:s + c], v)
            np.add.at(mass[g, :, p], pb[g, s:s + c], np.abs(v))
    return ref, mass


def _port(pb, pg, s, c, **kw):
    return th.leaf_hist(torch.as_tensor(pb), torch.as_tensor(pg), s, c,
                        num_bins=B, num_groups=G, **kw)


def _check(pb, pg, s, c):
    got = _port(pb, pg, s, c)
    assert tuple(got.shape) == (G, B, 2) and got.dtype == torch.float32
    got = got.numpy()
    jx = np.asarray(leaf_hist_slice(jnp.asarray(pb), jnp.asarray(pg),
                                    jnp.int32(s), jnp.int32(c), num_bins=B,
                                    row_chunk=C, num_groups=G))
    ref, mass = _oracle(pb, pg, s, c)
    np.testing.assert_allclose(got, ref.astype(np.float32), rtol=2 ** -23,
                               atol=0)
    assert (np.abs(jx - ref) <= 1e-5 * np.abs(ref) + 1e-5 * mass).all()
    assert (np.abs(got - jx) <= 1e-5 * np.abs(ref) + 1e-5 * mass).all()
    return got


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_leaf_hist_plain_matches_leaf_hist_slice(trial):
    """Random leaf range, not chunk-aligned."""
    rng, pb, pg = _buffers(trial)
    _check(pb, pg, int(rng.randint(C, 4 * C)), int(rng.randint(1, 3 * C)))


def test_leaf_hist_zero_count_is_zero():
    _, pb, pg = _buffers(5)
    assert not _check(pb, pg, 3 * C + 17, 0).any()


@pytest.mark.parametrize("side", [0, 1])
def test_leaf_hist_of_a_child_reads_the_left_count(side):
    """child=(nl, side) covers the child's rows of the partition just
    made, as an explicit range does."""
    _, pb, pg = _buffers(6)
    tb, tg = torch.as_tensor(pb), torch.as_tensor(pg)
    start, cnt = C + 7, 3 * C + 1
    nl = partition_leaf(tb, tg, make_scalars(start, cnt, 3, 0, 0, B, 0, 0,
                                             100, 0))
    n = int(nl[0])
    assert 0 < n < cnt
    s, c = (start, n) if side == 0 else (start + n, cnt - n)
    got = th.leaf_hist(tb, tg, start, cnt, num_bins=B, num_groups=G,
                       child=(nl, side))
    want = th.leaf_hist(tb, tg, s, c, num_bins=B, num_groups=G)
    assert torch.equal(got, want)
    _check(tb.numpy(), tg.numpy(), s, c)


def test_leaf_hist_planes_layout():
    """planes=True gives the (2, G, Bp) state slot; the default is its
    (G, B, 2) view; the padded bin columns are zero."""
    _, pb, pg = _buffers(7)
    planes = _port(pb, pg, 100, 900, planes=True)
    assert tuple(planes.shape) == (2, G, 256) and planes.is_contiguous()
    assert torch.equal(th.as_gb2(planes, B), _port(pb, pg, 100, 900))
    assert not planes[:, :, B:].any()


def test_leaf_hist_ignores_rows_outside_the_range():
    _, pb, pg = _buffers(8)
    want = _port(pb, pg, C + 5, 2 * C)
    pb2, pg2 = pb.copy(), pg.copy()
    pb2[:, :C + 5] = 0
    pb2[:, 3 * C + 5:] = 1
    pg2[:2, :C + 5] = 1e6
    pg2[:2, 3 * C + 5:] = np.nan
    assert torch.equal(_port(pb2, pg2, C + 5, 2 * C), want)


def test_leaf_hist_reference_mass_bounds_the_sums():
    _, pb, pg = _buffers(9)
    ref, mass = th.leaf_hist_reference(torch.as_tensor(pb),
                                       torch.as_tensor(pg), 50, 1000,
                                       num_bins=B, num_groups=G)
    assert ref.dtype == mass.dtype == torch.float64
    assert bool((mass >= ref.abs()).all())
    np.testing.assert_allclose(th.as_gb2(ref, B).numpy(),
                               _oracle(pb, pg, 50, 1000)[0], rtol=1e-12)


def test_leaf_hist_dispatches_cpu_to_plain_version():
    before = th.launches
    _, pb, pg = _buffers(10)
    _port(pb, pg, C, C)
    assert th.launches == before


# ---- the kernel's fixed-point twin: leaf_hist_fixed_plain --------------
#
# Bars: the integer sums are exact, so the twin differs from the f64
# sums by the rounding of each row to the grid 2^-k (at most 2^-(k+1) a
# row, cnt rows a bin at most) plus the one rounding to f32 (2^-24
# relative); from the f32 plain version (itself within 2^-24 of the f64
# sums) by twice that rounding.  k = fixed_exponent(max|v|, rows summed).

def _fixed(pb, pg, s, c, **kw):
    return th.leaf_hist_fixed_plain(torch.as_tensor(pb), torch.as_tensor(pg),
                                    s, c, num_bins=B, num_groups=G, **kw)


def _grid_bar(pg, s, c, absmax=None):
    """(2,) per-plane fixed-point rounding bar c * 2^-(k+1)."""
    from lightgbm_tpu_torch.ops.split_mega import fixed_exponent
    if absmax is None:
        absmax = np.abs(pg[:2, s:s + c]).max(axis=1)
    return np.array([c * 2.0 ** -(fixed_exponent(float(a), c) + 1)
                     for a in absmax])


@pytest.mark.parametrize("scale", [1.0, 1e4])
def test_leaf_hist_fixed_plain_is_permutation_invariant(scale):
    """Integer sums do not depend on the order of the rows: permuting the
    range's rows (bins and payload together) leaves the histogram
    bit-identical."""
    rng, pb, pg = _buffers(11)
    pg[:2] *= scale
    s, c = C + 3, 5 * C + 9
    want = _fixed(pb, pg, s, c, planes=True)
    for _ in range(3):
        perm = s + rng.permutation(c)
        qb, qg = pb.copy(), pg.copy()
        qb[:, s:s + c] = pb[:, perm]
        qg[:, s:s + c] = pg[:, perm]
        got = _fixed(qb, qg, s, c, planes=True)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("scale", [1.0, 1e4])
def test_leaf_hist_fixed_plain_within_f64_bars(scale):
    """Within chip_smoke.py's bar (rtol 1e-4 + atol 1e-5 x bin mass) and
    within one f32 rounding of the f64 sums plus the grid rounding."""
    rng, pb, pg = _buffers(12)
    pg[:2] *= scale
    s, c = C + 5, 6 * C + 1
    got = _fixed(pb, pg, s, c).numpy().astype(np.float64)
    ref, mass = _oracle(pb, pg, s, c)
    err = np.abs(got - ref)
    assert (err <= 1e-4 * np.abs(ref) + 1e-5 * mass).all()
    assert (err <= np.abs(ref) * 2.0 ** -24 + _grid_bar(pg, s, c)).all()


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_leaf_hist_fixed_plain_agrees_with_plain_and_jax(trial):
    """On a random range: the twin (the card's arithmetic) against the
    plain version (the CPU's) to f32 rounding, and against the JAX
    leaf_hist_slice within the bar that file's tests hold the port to;
    a wider bound (the learner's per-tree one) changes only rounding."""
    rng, pb, pg = _buffers(20 + trial)
    s, c = int(rng.randint(C, 4 * C)), int(rng.randint(1, 3 * C))
    got = _fixed(pb, pg, s, c).numpy().astype(np.float64)
    plain = _port(pb, pg, s, c).numpy().astype(np.float64)
    ref, mass = _oracle(pb, pg, s, c)
    assert (np.abs(got - plain) <= np.abs(ref) * 2.0 ** -23
            + _grid_bar(pg, s, c)).all()
    jx = np.asarray(leaf_hist_slice(jnp.asarray(pb), jnp.asarray(pg),
                                    jnp.int32(s), jnp.int32(c), num_bins=B,
                                    row_chunk=C, num_groups=G))
    assert (np.abs(got - jx) <= 1e-5 * np.abs(ref) + 1e-5 * mass).all()
    wide = np.abs(pg[:2]).max(axis=1) * 4
    got_w = _fixed(pb, pg, s, c, absmax=torch.as_tensor(wide)).numpy()
    assert (np.abs(got_w - ref) <= np.abs(ref) * 2.0 ** -24
            + _grid_bar(pg, s, c, wide)).all()


@pytest.mark.parametrize("side", [0, 1])
def test_leaf_hist_fixed_plain_of_a_child(side):
    """child=(nl, side) sums the child's rows with the scale of the
    child's own count, as an explicit range does; the default bound is
    taken over the parent's range."""
    _, pb, pg = _buffers(13)
    tb, tg = torch.as_tensor(pb), torch.as_tensor(pg)
    start, cnt = C + 7, 3 * C + 1
    nl = partition_leaf(tb, tg, make_scalars(start, cnt, 3, 0, 0, B, 0, 0,
                                             100, 0))
    n = int(nl[0])
    s, c = (start, n) if side == 0 else (start + n, cnt - n)
    amax = tg[:2, start:start + cnt].abs().amax(dim=1)
    kw = dict(num_bins=B, num_groups=G, planes=True)
    got = th.leaf_hist_fixed_plain(tb, tg, start, cnt, child=(nl, side),
                                   **kw)
    want = th.leaf_hist_fixed_plain(tb, tg, s, c, absmax=amax, **kw)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("side", [0, 1])
def test_leaf_hist_fixed_plain_zero_row_child_is_zero(side):
    """A child of no rows (every row went to the other side) gives
    zeros, as does an empty range."""
    _, pb, pg = _buffers(14)
    tb, tg = torch.as_tensor(pb), torch.as_tensor(pg)
    start, cnt = C + 9, 2 * C
    thr = 255 if side == 1 else -1          # all left / all right
    nl = partition_leaf(tb, tg, make_scalars(start, cnt, 3, 0, 0, B, 0, 0,
                                             thr, 0))
    assert int(nl[0]) == (cnt if side == 1 else 0)
    got = th.leaf_hist_fixed_plain(tb, tg, start, cnt, child=(nl, side),
                                   num_bins=B, num_groups=G, planes=True)
    assert tuple(got.shape) == (2, G, 256) and not got.any()
    assert not _fixed(pb, pg, 3 * C, 0).any()
