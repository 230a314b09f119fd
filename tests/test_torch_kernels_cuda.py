"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; every test skips where torch.cuda.is_available() is
False.  The file imports neither jax nor lightgbm_tpu, so on a machine
with a card and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances: split_pair's kernel runs the plain version's f32 operations
in the same order and its blocked f64 prefix sums, so all 13 fields are
bit-identical to the plain version, on the CPU and on the card.  split_mega's partition (bins and payload words) is
bit-identical to the plain version, and its fixed-point histogram is
bit-identical to hist_fixed_plain (integer sums are exact in any
order); repeated launches are bit-identical.  The histogram is also held
to the f64 sums within rtol 1e-4 + 1e-5 x each bin's absolute mass (the
sum of |grad| or |hess| over the bin's rows), and to the plain
version's f32 sums within rtol 1e-4 + 1e-4 x mass, the plain version's
own rounding included.  The partition and hist_rmw kernels are
bit-identical to their plain versions (words moved; one f32
subtraction).  leaf_hist's fixed-point histogram is bit-identical to
leaf_hist_fixed_plain and held to the f64 sums of leaf_hist_reference
within rtol 1e-4 + 1e-5 x mass; repeated launches are bit-identical.
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import hist_state as hs
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import partition as tpart
from lightgbm_tpu_torch.ops import split_mega as sm
from lightgbm_tpu_torch.ops.partition import make_scalars
from lightgbm_tpu_torch.ops import split_pair as sp

PARAMS = [
    dict(l1=0.0, l2=1e-3, max_delta_step=0.0, min_gain_to_split=0.0,
         min_data_in_leaf=5, min_sum_hessian=1e-3, max_depth=0),
    dict(l1=0.5, l2=2.0, max_delta_step=0.7, min_gain_to_split=0.1,
         min_data_in_leaf=20, min_sum_hessian=1.0, max_depth=3),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _pair_case(seed, F=28, BF=255):
    rng = np.random.RandomState(seed)
    half = np.zeros((F, 8), np.int32)
    half[:, 0] = rng.randint(3, BF + 1, F)
    half[:, 1] = rng.randint(0, 3, F)
    half[:, 2] = np.where(half[:, 1] == 1, rng.randint(0, 3, F), 0)
    hg = rng.randn(2 * F, BF).astype(np.float32)
    hh = rng.uniform(0.01, 2.0, (2 * F, BF)).astype(np.float32)
    info = np.zeros((2 * F, 8), np.float32)
    for c in range(2):
        rows = slice(c * F, (c + 1) * F)
        info[rows, 0] = hg[c * F].sum()
        info[rows, 1] = hh[c * F].sum()
        info[rows, 2] = 2000 + 100 * c
        info[rows, 3] = 2 + c
        info[rows, 4] = rng.rand(F) > 0.1
    return [torch.as_tensor(a) for a in
            (hg, hh, np.concatenate([half, half]), info)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(28, 255), (28, 256), (7, 31), (3, 16),
                                   (45, 64), (70, 255)])
@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_split_pair_kernel_bit_identical_to_plain(card, shape, pi):
    """Kernel, plain version on the card and plain version on the CPU
    agree bit for bit (the prefix sums are elementwise f64 adds in the
    kernel's association), at widths that leave lanes without bins and
    with more work items (feature row, scan direction) than one cluster
    has warps."""
    F, BF = shape
    args = _pair_case(F + BF + pi, F, BF)
    want = sp.split_pair_plain(*args, **PARAMS[pi])
    dev = [a.to(card) for a in args]
    got = sp.split_pair(*dev, **PARAMS[pi]).cpu()
    plain = sp.split_pair_plain(*dev, **PARAMS[pi]).cpu()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(plain.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("trial", [0, 1, 2])
def test_split_mega_kernel_matches_plain(card, trial):
    rng = np.random.RandomState(trial)
    G, n_pad = 28, 1 << 20
    pb = torch.as_tensor(rng.randint(0, 255, (G, n_pad)).astype(np.uint8))
    pg = torch.as_tensor(rng.randn(8, n_pad).astype(np.float32))
    sc = make_scalars(4096 + trial, 900_000 + 77 * trial, trial + 3, 0, 0,
                      255, int(rng.randint(0, 255)), trial,
                      int(rng.randint(0, 255)), 1)
    outs = []
    for _ in range(2):
        b, g = pb.to(card), pg.to(card)
        nl, acc = sm.split_mega(b, g, sc, num_bins=255, num_groups=G)
        outs.append((b.cpu(), g.cpu(), nl.cpu(), acc.cpu()))
    b0, g0 = pb.clone(), pg.clone()
    ref, mass = sm.hist_reference(b0, g0, sc, num_bins=255, num_groups=G)
    fixed = sm.hist_fixed_plain(b0, g0, sc, num_bins=255, num_groups=G)
    enl, eacc = sm.split_mega_plain(b0, g0, sc, num_bins=255, num_groups=G)
    for b, g, nl, acc in outs:
        assert int(nl) == int(enl)
        assert torch.equal(acc.view(torch.int32), fixed.view(torch.int32))
        assert torch.equal(b, b0)
        assert torch.equal(g.view(torch.int32), g0.view(torch.int32))
        err = (acc.double() - ref).abs()
        assert bool((err <= 1e-4 * ref.abs() + 1e-5 * mass).all())
        err = (acc.double() - eacc.double()).abs()
        assert bool((err <= 1e-4 * eacc.double().abs() + 1e-4 * mass).all())
    assert torch.equal(outs[0][3].view(torch.int32),
                       outs[1][3].view(torch.int32))


@pytest.mark.cuda
def test_split_mega_kernel_zero_count(card):
    pb = torch.randint(0, 255, (28, 8192), dtype=torch.uint8, device=card)
    pg = torch.randn(8, 8192, device=card)
    b, g = pb.clone(), pg.clone()
    nl, acc = sm.split_mega(b, g, make_scalars(3000, 0, 5, 0, 0, 200, 0, 0,
                                               100, 0),
                            num_bins=255, num_groups=28)
    assert int(nl) == 0 and not acc.any()
    assert torch.equal(b, pb) and torch.equal(g, pg)


@pytest.mark.cuda
def test_wrappers_raise_on_bad_arguments(card):
    pb = torch.zeros((28, 8192), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError):
        sm.split_mega(pb, torch.zeros((8, 8192), dtype=torch.float64,
                                      device=card),
                      make_scalars(0, 10, 0, 0, 0, 255, 0, 0, 1, 0),
                      num_bins=255, num_groups=28)
    with pytest.raises(ValueError):
        sm.split_mega(pb, torch.zeros((8, 8192), device=card),
                      make_scalars(8000, 500, 0, 0, 0, 255, 0, 0, 1, 0),
                      num_bins=255, num_groups=28)


PART_CASES = {
    "cnt0": (5000, 0, 3, 0, 0, 255, 0, 0, 100, 0),
    "unaligned": (4096 + 77, 300_001, 5, 0, 0, 255, 0, 0, 128, 1),
    "all_left": (4096, 50_000, 1, 0, 0, 255, 0, 0, 255, 0),
    "all_right": (4096, 50_000, 1, 0, 0, 255, 0, 0, -1, 0),
    "zero_missing": (9000, 70_000, 7, 0, 0, 255, 40, 1, 90, 1),
    "nan_missing": (9000, 70_000, 8, 0, 0, 255, 0, 2, 200, 1),
    "bundled": (123, 33_333, 2, 10, 1, 60, 0, 1, 30, 0),
}


def _row_buffers(seed, G=28, n_pad=1 << 19):
    rng = np.random.RandomState(seed)
    pb = torch.as_tensor(rng.randint(0, 255, (G, n_pad)).astype(np.uint8))
    pg = torch.as_tensor(rng.randn(8, n_pad).astype(np.float32))
    pg[1] = pg[1].abs()
    pg[2] = torch.arange(n_pad, dtype=torch.int32).view(torch.float32)
    pg[5, ::7] = torch.tensor([0x7FC00001], dtype=torch.int32).view(
        torch.float32)
    return pb, pg


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PART_CASES))
def test_partition_kernel_bit_identical_to_plain(card, case):
    pb, pg = _row_buffers(1)
    sc = make_scalars(*PART_CASES[case])
    b, g = pb.to(card), pg.to(card)
    nl = tpart.partition_leaf(b, g, sc)
    b0, g0 = pb.clone(), pg.clone()
    enl = tpart.partition_leaf_plain(b0, g0, sc)
    assert int(nl) == int(enl)
    assert torch.equal(b.cpu(), b0)
    assert torch.equal(g.cpu().view(torch.int32), g0.view(torch.int32))


def _risk_buffers(case, G=28, n_pad=1 << 19):
    """Row buffers and the scalars of one risk case of the tile-compacted
    partition and the fixed-point histogram (see RISK_CASES)."""
    T = tpart.tile_rows(G)
    pb, pg = _row_buffers(3, G, n_pad)
    start, cnt = 4096, 5000
    if case.startswith("offset"):
        start += int(case[6:])
    elif case in ("tile_minus_1", "tile", "tile_plus_1"):
        cnt = T + {"tile_minus_1": -1, "tile": 0, "tile_plus_1": 1}[case]
    elif case in ("unaligned_tile_minus_1", "unaligned_tile",
                  "unaligned_tile_plus_1"):
        start += 9
        cnt = T + {"unaligned_tile_minus_1": -1, "unaligned_tile": 0,
                   "unaligned_tile_plus_1": 1}[case]
    elif case == "one_row":
        start, cnt = 4096 + 7, 1
    elif case == "ends_at_n_pad":
        start, cnt = n_pad - 3000 - 5, 3005
    elif case == "one_bin":
        pb[:] = 7
        pb[5] = torch.as_tensor(np.random.RandomState(4).randint(
            0, 255, n_pad).astype(np.uint8))
    elif case == "regression_scale":
        pg[0] *= 1e4
        pg[1] *= 1e4
    thr = {"all_left": 255, "all_right": -1}.get(case, 120)
    return pb, pg, make_scalars(start, cnt, 5, 0, 0, 255, 0, 0, thr, 1)


RISK_CASES = ([f"offset{o}" for o in range(16)]
              + ["tile_minus_1", "tile", "tile_plus_1",
                 "unaligned_tile_minus_1", "unaligned_tile",
                 "unaligned_tile_plus_1", "one_row", "ends_at_n_pad",
                 "one_bin", "all_left", "all_right", "regression_scale"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", RISK_CASES)
def test_split_mega_and_partition_risk_cases(card, case):
    """Start at every offset mod 16, counts around one partition tile,
    one row, a leaf ending at N_pad, all rows in one bin, all left / all
    right, |grad| ~ 1e4; the NaN payload word of _row_buffers rides along.
    Partition bit-identical to the plain version; histogram bit-identical
    to hist_fixed_plain and within the f64 bars."""
    G = 28
    pb, pg, sc = _risk_buffers(case, G)
    b0, g0 = pb.clone(), pg.clone()
    ref, mass = sm.hist_reference(b0, g0, sc, num_bins=255, num_groups=G)
    fixed = sm.hist_fixed_plain(b0, g0, sc, num_bins=255, num_groups=G)
    enl = tpart.partition_leaf_plain(b0, g0, sc)
    for fn in ("split_mega", "partition"):
        b, g = pb.to(card), pg.to(card)
        if fn == "split_mega":
            nl, acc = sm.split_mega(b, g, sc, num_bins=255, num_groups=G)
            acc = acc.cpu()
            assert torch.equal(acc.view(torch.int32), fixed.view(torch.int32))
            err = (acc.double() - ref).abs()
            assert bool((err <= 1e-4 * ref.abs() + 1e-5 * mass).all())
        else:
            nl = tpart.partition_leaf(b, g, sc)
        assert int(nl) == int(enl)
        assert torch.equal(b.cpu(), b0)
        assert torch.equal(g.cpu().view(torch.int32), g0.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["split_mega", "partition", "leaf_hist"])
def test_repeated_launches_bit_identical(card, fn):
    """20 launches on one input give identical buffers, left counts and
    histograms: a look-back that read a stale tile word, or a histogram
    that depended on the order of its adds or on an accumulator left
    dirty by the launch before, would show here."""
    pb, pg = _row_buffers(5)
    sc = make_scalars(4096 + 3, 400_000, 6, 0, 0, 255, 0, 0, 131, 0)
    first = None
    for _ in range(20):
        b, g = pb.to(card), pg.to(card)
        if fn == "split_mega":
            nl, acc = sm.split_mega(b, g, sc, num_bins=255, num_groups=28)
        elif fn == "partition":
            nl, acc = tpart.partition_leaf(b, g, sc), torch.zeros(1)
        else:
            nl = tpart.partition_leaf(b, g, sc)
            acc = torch.cat([th.leaf_hist(b, g, 4096 + 3, 400_000,
                                          num_bins=255, num_groups=28,
                                          child=child, planes=True)
                             for child in (None, (nl, 0), (nl, 1))])
        got = (b.cpu(), g.cpu().view(torch.int32), int(nl),
               acc.cpu().view(torch.int32))
        if first is None:
            first = got
        assert torch.equal(got[0], first[0])
        assert torch.equal(got[1], first[1])
        assert got[2] == first[2]
        assert torch.equal(got[3], first[3])


def _leaf_hist_check(card, pb, pg, start, cnt, child_sc):
    """leaf_hist on the card over [start, start + cnt) and over both
    children of its partition by the scalars child_sc: bit-identical to
    leaf_hist_fixed_plain (with the default bound and with the learner's
    per-tree bound) and within the f64 bars."""
    G, B = 28, 255
    kw = dict(num_bins=B, num_groups=G, planes=True)
    b, g = pb.to(card), pg.to(card)
    nl = tpart.partition_leaf(b, g, child_sc)
    tree_bound = g[:2].abs().amax(dim=1)
    hb, hg = b.cpu(), g.cpu()
    for child in (None, (nl, 0), (nl, 1)):
        host = None if child is None else (child[0].cpu(), child[1])
        ref, mass = th.leaf_hist_reference(hb, hg, start, cnt, child=host,
                                           num_bins=B, num_groups=G)
        for absmax in (None, tree_bound):
            got = th.leaf_hist(b, g, start, cnt, child=child, absmax=absmax,
                               **kw).cpu()
            want = th.leaf_hist_fixed_plain(
                hb, hg, start, cnt, child=host,
                absmax=None if absmax is None else absmax.cpu(), **kw)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
            assert bool(((got.double() - ref).abs() <= 1e-4 * ref.abs()
                         + 1e-5 * mass).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PART_CASES))
def test_leaf_hist_kernel_matches_f64(card, case):
    """The whole range, then each child of the partition, read from the
    left count on the card (all_left / all_right give a child of no
    rows); bit-identical to leaf_hist_fixed_plain, within the f64
    bars."""
    pb, pg = _row_buffers(2)
    start, cnt = PART_CASES[case][:2]
    _leaf_hist_check(card, pb, pg, start, cnt,
                     make_scalars(*PART_CASES[case]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [f"offset{o}" for o in range(16)]
                         + ["one_row", "ends_at_n_pad", "one_bin",
                            "regression_scale"])
def test_leaf_hist_kernel_risk_cases(card, case):
    """Start at every offset mod 16, one row, a leaf ending at N_pad, all
    rows in one bin, |grad| ~ 1e4: the range and both children of its
    partition, bit-identical to leaf_hist_fixed_plain."""
    pb, pg, sc = _risk_buffers(case)
    start, cnt = tpart.scalars_start(sc), sc[tpart.S_CNT]
    _leaf_hist_check(card, pb, pg, start, cnt, sc)


@pytest.mark.cuda
@pytest.mark.parametrize("idx", [(2, 2, 4, 1), (2, 2, 4, 0), (0, 7, 7, 1)])
def test_hist_rmw_kernel_bit_identical_to_plain(card, idx):
    rng = np.random.RandomState(sum(idx))
    state = torch.as_tensor(rng.randn(8, 2, 28, 256).astype(np.float32))
    small = torch.as_tensor(rng.randn(2, 28, 256).astype(np.float32))
    st = state.to(card)
    got = hs.hist_rmw(st, small.to(card), idx)
    want = hs.hist_rmw_plain(state, small, idx)
    assert torch.equal(st.cpu().view(torch.int32), state.view(torch.int32))
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_new_wrappers_raise_on_bad_arguments(card):
    pb = torch.zeros((28, 8192), dtype=torch.uint8, device=card)
    pg = torch.zeros((8, 8192), device=card)
    with pytest.raises(ValueError):
        tpart.partition_leaf(pb, pg, make_scalars(8000, 500, 0, 0, 0, 255,
                                                  0, 0, 1, 0))
    with pytest.raises(ValueError):
        th.leaf_hist(pb, pg, 0, 100, num_bins=255, num_groups=29)
    with pytest.raises(ValueError):
        th.leaf_hist(pb, pg, 0, 100, num_bins=255, num_groups=28,
                     child=(torch.zeros(1, dtype=torch.int64, device=card),
                            0))
    state = torch.zeros((4, 2, 28, 256), device=card)
    with pytest.raises(ValueError):
        hs.hist_rmw(state, torch.zeros((2, 28, 256), device=card),
                    (0, 4, 1, 1))
