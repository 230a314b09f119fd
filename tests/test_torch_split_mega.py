"""The port's split mega-kernel (lightgbm_tpu_torch/ops/split_mega.py)
against the JAX mega-kernel run in the Pallas interpreter, on the shapes
of tests/test_pallas_interpret.py.

Tolerances: bins, every payload row (as raw 32-bit words, row-id row
included) and the left count must be bit-identical.  Histograms agree
to rtol 1e-5 / atol 1e-6: the JAX kernel sums each chunk with an f32
one-hot matmul, the port row by row, so f32 summation order differs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu.ops.partition_pallas import make_scalars, sc_rows_for
from lightgbm_tpu.ops.split_megakernel_pallas import split_megakernel_pallas
from lightgbm_tpu_torch.ops import split_mega as sm
from lightgbm_tpu_torch.ops import partition as tpart
from lightgbm_tpu_torch.ops.partition import decide_left

C, G32, G, B = 256, 32, 28, 255
NP = 8 * C


def _buffers(seed):
    rng = np.random.RandomState(seed)
    pb = rng.randint(0, 250, (G32, NP)).astype(np.uint8)
    pg = rng.randn(8, NP).astype(np.float32)
    # row ids ride row 2 as int32 bits; include words that are NaN
    # patterns as floats, which a float move could rewrite
    ids = rng.permutation(NP).astype(np.int32)
    ids[:16] = np.arange(-16, 0, dtype=np.int32)
    pg[2] = ids.view(np.float32)
    return rng, pb, pg


def _jax(pb, pg, sc):
    rpb, rpg, _, rnl, acc = split_megakernel_pallas(
        jnp.asarray(pb), jnp.asarray(pg),
        jnp.zeros((sc_rows_for(G32), NP), jnp.int32),
        make_scalars(*sc), row_chunk=C, num_bins=B, num_groups=G,
        ghi_live=8, interpret=True)
    return (np.asarray(rpb), np.asarray(rpg), int(np.asarray(rnl)[0, 0]),
            np.asarray(acc))


def _port(pb, pg, sc, move=True):
    tb, tg = torch.as_tensor(pb.copy()), torch.as_tensor(pg.copy())
    nl, acc = sm.split_mega(tb, tg, tpart.make_scalars(*sc), num_bins=B,
                            num_groups=G, move=move)
    return tb.numpy(), tg.numpy(), int(nl[0]), acc.numpy()


def _check(pb, pg, sc):
    epb, epg, enl, eacc = _jax(pb, pg, sc)
    rpb, rpg, rnl, racc = _port(pb, pg, sc)
    assert rnl == enl
    np.testing.assert_array_equal(rpb, epb)
    np.testing.assert_array_equal(rpg.view(np.int32), epg.view(np.int32))
    assert racc.shape == eacc.shape == (G, 4 * 16, 16)
    np.testing.assert_allclose(racc, eacc, rtol=1e-5, atol=1e-6)
    return rnl, racc


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_split_mega_plain_matches_pallas_interpreted(trial):
    """Random leaf range (not 128-aligned), split column and decision
    (missing none / zero / NaN)."""
    rng, pb, pg = _buffers(60 + trial)
    start = int(rng.randint(C, 4 * C))
    cnt = int(rng.randint(1, 3 * C))
    nb = int(rng.randint(10, 250))
    sc = (start, cnt, int(rng.randint(0, G)), 0, 0, nb,
          int(rng.randint(0, nb)), trial, int(rng.randint(0, nb)),
          int(rng.rand() < 0.5))
    _check(pb, pg, sc)


@pytest.mark.parametrize("thr", [255, -1])
def test_split_mega_all_left_all_right(thr):
    """Every row left (the partition is the identity) or every row right."""
    _, pb, pg = _buffers(7)
    nl, acc = _check(pb, pg, (3 * C + 5, 2 * C + 3, 4, 0, 0, 250, 0, 0,
                              thr, 0))
    planes = acc.reshape(G, 4, -1)
    assert nl == (2 * C + 3 if thr == 255 else 0)
    assert not planes[:, 2 if thr == 255 else 0].any()


def test_split_mega_zero_count():
    """cnt == 0 (the trash-slot call): nothing moves, zeros come back."""
    _, pb, pg = _buffers(99)
    nl, acc = _check(pb, pg, (3 * C + 17, 0, 5, 0, 0, 200, 0, 0, 100, 0))
    assert nl == 0 and not acc.any()


def test_split_mega_no_move_is_histogram_only():
    """move=False returns the same histogram, moves no row and reports
    cnt as the left count (the learner's root-histogram call)."""
    _, pb, pg = _buffers(11)
    sc = (C + 3, 3 * C, 2, 0, 0, 250, 7, 1, 120, 1)
    _, _, _, acc = _port(pb, pg, sc)
    rpb, rpg, nl, acc2 = _port(pb, pg, sc, move=False)
    np.testing.assert_array_equal(acc2, acc)
    np.testing.assert_array_equal(rpb, pb)
    np.testing.assert_array_equal(rpg.view(np.int32), pg.view(np.int32))
    assert nl == 3 * C


def test_decide_left_matches_numpy_oracle():
    """The partition decision against the oracle of
    tests/test_pallas_interpret.py, bundled offsets included."""
    rng = np.random.RandomState(5)
    colv = rng.randint(0, 256, 4000)
    for isb in (0, 1):
        for mtype in (0, 1, 2):
            bstart, nb, dbin, thr, dl = 3, 40, 2, 17, 1
            got = decide_left(torch.as_tensor(colv), bstart, isb, nb, dbin,
                              mtype, thr, dl).numpy()
            fb_raw = colv - bstart
            in_r = (fb_raw >= 1) & (fb_raw <= nb - 1)
            fb = np.where(isb == 1, np.where(in_r, fb_raw, dbin), colv)
            miss = (fb == dbin if mtype == 1 else fb == nb - 1
                    if mtype == 2 else np.zeros_like(fb, bool))
            np.testing.assert_array_equal(got, np.where(miss, dl != 0,
                                                        fb <= thr))


def test_split_mega_dispatches_cpu_to_plain_version():
    before = sm.launches
    _, pb, pg = _buffers(3)
    _port(pb, pg, (C, C, 1, 0, 0, 250, 0, 0, 100, 0))
    assert sm.launches == before


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fixed_exponent_matches_numpy_oracle(seed):
    """The scale 2^k of the kernel's fixed-point histogram: k is the
    largest with cnt * max|v| * 2^k < 2^62 (numpy's frexp as the oracle),
    clamped to [-100, 220]."""
    rng = np.random.RandomState(seed)
    amax = np.concatenate([[0.0, 1.0, 0.25, 1e4, 3.0e38, 1e-40],
                           rng.lognormal(0, 8, 50)]).astype(np.float32)
    for a in amax:
        for cnt in (1, 2, 1000, 1 << 23, (1 << 24) - 1):
            k = sm.fixed_exponent(float(a), cnt)
            want = 62 - int(np.frexp(np.float64(a) * cnt)[1])
            assert k == min(max(want, -100), 220)
            m = float(a) * cnt
            if m > 0 and -100 < k < 220:
                assert m * 2.0 ** k < 2.0 ** 62 <= m * 2.0 ** (k + 1)


def _fixed_case(seed, scale=1.0):
    rng, pb, pg = _buffers(seed)
    pg[0] *= scale
    pg[1] = np.abs(pg[1]) * scale
    start, cnt = C + 5, 5 * C + 3
    sc = tpart.make_scalars(start, cnt, 3, 0, 0, 250, 0, 0, 120, 1)
    return rng, pb, pg, sc


@pytest.mark.parametrize("scale", [1.0, 1e4])
def test_hist_fixed_plain_is_permutation_invariant(scale):
    """Integer sums do not depend on the order of the rows: permuting the
    leaf's rows (bins and payload together) leaves the histogram
    bit-identical."""
    rng, pb, pg, sc = _fixed_case(4, scale)
    start, cnt = tpart.scalars_start(sc), sc[tpart.S_CNT]
    want = sm.hist_fixed_plain(torch.as_tensor(pb), torch.as_tensor(pg), sc,
                               num_bins=B, num_groups=G)
    for _ in range(3):
        perm = start + rng.permutation(cnt)
        qb, qg = pb.copy(), pg.copy()
        qb[:, start:start + cnt] = pb[:, perm]
        qg[:, start:start + cnt] = pg[:, perm]
        got = sm.hist_fixed_plain(torch.as_tensor(qb), torch.as_tensor(qg),
                                  sc, num_bins=B, num_groups=G)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("scale", [1.0, 1e4])
def test_hist_fixed_plain_within_f64_bars(scale):
    """Against the f64 sums: within chip_smoke.py's bars (rtol 1e-4 +
    atol 1e-5 x bin mass), and within one f32 rounding of the exact sum
    plus the fixed-point rounding of at most 2^-(k+1) per row."""
    _, pb, pg, sc = _fixed_case(5, scale)
    tb, tg = torch.as_tensor(pb), torch.as_tensor(pg)
    got = sm.hist_fixed_plain(tb, tg, sc, num_bins=B, num_groups=G).double()
    ref, mass = sm.hist_reference(tb, tg, sc, num_bins=B, num_groups=G)
    err = (got - ref).abs()
    assert bool((err <= 1e-4 * ref.abs() + 1e-5 * mass).all())
    start, cnt = tpart.scalars_start(sc), sc[tpart.S_CNT]
    amax = tg[:2, start:start + cnt].abs().amax(dim=1).tolist()
    rnd = [cnt * 2.0 ** -(sm.fixed_exponent(a, cnt) + 1) for a in amax]
    per_plane = torch.tensor(rnd * 2, dtype=torch.float64)
    tol = ref.abs() * 2.0 ** -24 + per_plane.repeat_interleave(16).view(
        1, 4 * 16, 1)
    assert bool((err <= tol).all())


def test_hist_fixed_plain_agrees_with_split_mega_plain():
    """The fixed-point and the f32 histograms of one split agree to f32
    rounding (the card runs the first, the CPU the second), and a bound
    larger than the leaf's max|v| (the learner's per-tree bound) changes
    only the rounding."""
    _, pb, pg, sc = _fixed_case(6)
    tb, tg = torch.as_tensor(pb), torch.as_tensor(pg)
    kw = dict(num_bins=B, num_groups=G)
    fixed = sm.hist_fixed_plain(tb, tg, sc, **kw)
    wide = sm.hist_fixed_plain(tb, tg, sc, absmax=tg[:2].abs().amax(dim=1)
                               * 4, **kw)
    _, plain = sm.split_mega_plain(tb.clone(), tg.clone(), sc, **kw)
    ref, mass = sm.hist_reference(tb, tg, sc, **kw)
    for h in (fixed, wide, plain):
        err = (h.double() - ref).abs()
        assert bool((err <= 1e-4 * ref.abs() + 1e-5 * mass).all())
    assert sm.hist_fixed_plain(tb, tg, tpart.make_scalars(
        C, 0, 3, 0, 0, 250, 0, 0, 120, 1), **kw).abs().sum() == 0


def test_partition_tile_rows_fit_shared_memory():
    """The partition tile of csrc/partition.cuh: a multiple of 32 rows,
    at most 1024, whose staged bytes fit the per-tile budget (three
    tiles an SM), 1024 rows at the HIGGS width."""
    assert tpart.tile_rows(28) == 1024
    for R in (1, 28, 32, 64, 136, 500, 2000):
        T = tpart.tile_rows(R)
        assert T % 32 == 0 and 32 <= T <= 1024
        assert tpart.part_smem_bytes(R, T) <= tpart.PART_SMEM
        assert T == 1024 or tpart.part_smem_bytes(R, 2 * T) > tpart.PART_SMEM
    with pytest.raises(ValueError):
        tpart.tile_rows(10_000)
