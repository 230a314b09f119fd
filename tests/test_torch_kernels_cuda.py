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
own rounding included.  The partition kernel is bit-identical to its
plain version (words moved).  leaf_hist's fixed-point histogram is
bit-identical to leaf_hist_fixed_plain and held to the f64 sums of
leaf_hist_reference within rtol 1e-4 + 1e-5 x mass; repeated launches
are bit-identical.  Its state launch (leaf_hist_rmw: the histogram-state
update folded into the histogram) is bit-identical to
leaf_hist_rmw_fixed_plain, the int64 state and the f32 children (integer
sums and differences are exact), and the larger child's slot to a
direct fixed-point histogram of its own rows at the tree's scale.  The
frontier's bookkeeping kernel is bit-identical to frontier_step_plain on
every state of real trees, its key and undo kernels to their plain
versions, split_pair over 2K children to the pair launches that hold
each child; trees grown by the frontier's graph (conditional IF nodes)
equal the K=1 graph loop's bit for bit, row order included.  The
sampling pass and the EFB feature view are bit-identical to
sample_plain and feat_view_fixed_plain (integer draws and sums, the same
f32 operations), and trees grown on bundled, bagged data through the
graph equal the eager oracle's, one capture for every draw.  Quantized
training: the discretizer is bit-identical to quantize_plain (integer
draws, single f32 operations), each kernel's scale arm to its plain
twin's (the exact integer sums as f32, one f32 product), and quantized
trees on the card equal the CPU's split for split.  Monotone
constraints: the monotone arm of split_pair (the register arm and past
256 bins, 2 and 31 children, with and without the penalty table) and
the clamp arm of split_cat (narrow, wide, 300 children) bit-identical to
their plain versions on the card and on the CPU; tree_step's bounds and
bin boxes in every mode, and mono_refresh, mono_planes and mono_overlay,
bit-identical to their twins; constrained trees through the graph stay
monotone.  The train walk of a past tree (DART, rollback) over the
card's physical bin matrix finds the CPU's leaves and updates the scores
bit for bit, and DART's trees and drops on the card equal the CPU's.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops import feat_view as fv
from lightgbm_tpu_torch.ops import hist_state as hs
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import partition as tpart
from lightgbm_tpu_torch.ops import split_mega as sm
from lightgbm_tpu_torch.ops.partition import make_scalars
from lightgbm_tpu_torch.ops import sample as smp
from lightgbm_tpu_torch.ops import split_pair as sp
from lightgbm_tpu_torch.ops import tree_step as ts
from lightgbm_tpu_torch.utils import random as jr

import test_torch_tree_loop as _tl

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
                                   (45, 64), (70, 255), (284, 48),
                                   (284, 255)])
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
    _split_mega_trial(card, trial, 28, 1 << 20, 900_000)


@pytest.mark.cuda
@pytest.mark.parametrize("trial", [0, 1])
def test_split_mega_kernel_matches_plain_at_136_groups(card, trial):
    """MSLR-WEB30K's 136 dense features: more groups than one block's
    shared memory holds planes for, so a launch runs several group
    sets."""
    _split_mega_trial(card, trial, 136, 1 << 19, 400_000)


def _split_mega_trial(card, trial, G, n_pad, cnt):
    rng = np.random.RandomState(trial)
    pb = torch.as_tensor(rng.randint(0, 255, (G, n_pad)).astype(np.uint8))
    pg = torch.as_tensor(rng.randn(8, n_pad).astype(np.float32))
    sc = make_scalars(4096 + trial, cnt + 77 * trial, trial + 3, 0, 0,
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
@pytest.mark.parametrize("fn", ["split_mega", "partition", "leaf_hist",
                                "leaf_hist_rmw"])
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
        elif fn == "leaf_hist_rmw":
            state = hs.new_state(4, 28, 255, card)
            kw = dict(num_bins=255, num_groups=28, state=state,
                      absmax=g[:2].abs().amax(dim=1), kcnt=1 << 20)
            root = hs.leaf_hist_rmw(b, g, 4096 + 3, 400_000, idx=(-1, 1, 1, 0),
                                    **kw)
            nl = tpart.partition_leaf(b, g, sc)
            ch = hs.leaf_hist_rmw(b, g, 4096 + 3, 400_000, child=(nl, 1),
                                  idx=(1, 1, 3, 0), **kw)
            acc = torch.cat([root.reshape(-1), ch.reshape(-1),
                             state.view(torch.float32).reshape(-1)])
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


# (scalars case of _risk_buffers, smaller side, idx = (parent, wa, wb,
# small_is_left)) of the fused histogram-state launch
FUSED_CASES = {
    "small_left": ("offset0", 0, (2, 2, 5, 1)),
    "small_right": ("offset0", 1, (2, 2, 5, 0)),
    "trash_wa_eq_wb": ("offset3", 0, (2, 7, 7, 1)),
    "trash_small_right": ("offset3", 1, (2, 7, 7, 0)),
    "zero_row_right_child": ("all_left", 1, (2, 2, 5, 0)),
    "zero_row_left_child": ("all_right", 0, (2, 2, 5, 1)),
    "regression_scale": ("regression_scale", 1, (4, 4, 1, 0)),
    "multi_block": ("multi_block", 0, (1, 1, 6, 1)),
}
FUSED_CASES.update({f"offset{o}": (f"offset{o}", o % 2,
                                   (2, 2, 5, 1 - o % 2))
                    for o in range(1, 16)})


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_leaf_hist_rmw_kernel_bit_identical_to_plain(card, case):
    """The root launch (no parent) into slot ``parent``, the partition,
    then the split launch of the smaller child: the int64 state and the
    f32 children bit-identical to leaf_hist_rmw_fixed_plain; the larger
    child's slot equal to the direct fixed-point sums of its own rows and
    both children's planes to leaf_hist_fixed_plain of each child's rows,
    at the tree's scale (the bound over all rows, kcnt above every
    count)."""
    G, B, kcnt = 28, 255, 1 << 20
    risk, small_side, idx = FUSED_CASES[case]
    if risk == "multi_block":        # a group set spans several blocks
        pb, pg = _row_buffers(4)
        sc = make_scalars(4096 + 5, 400_003, 6, 0, 0, 255, 0, 0, 131, 0)
    else:
        pb, pg, sc = _risk_buffers(risk, G)
    start, cnt = tpart.scalars_start(sc), sc[tpart.S_CNT]
    kw = dict(num_bins=B, num_groups=G, kcnt=kcnt)
    b, g = pb.to(card), pg.to(card)
    absmax = g[:2].abs().amax(dim=1)
    hmax = absmax.cpu()
    state = hs.new_state(8, G, B, card)
    assert state.dtype == torch.int64
    want_state = state.cpu()
    root = (-1, idx[0], idx[0], 0)
    got = hs.leaf_hist_rmw(b, g, start, cnt, state=state, idx=root,
                           absmax=absmax, **kw)
    want = hs.leaf_hist_rmw_fixed_plain(pb, pg, start, cnt, state=want_state,
                                        idx=root, absmax=hmax, **kw)
    assert torch.equal(state.cpu(), want_state)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))

    nl = tpart.partition_leaf(b, g, sc)
    hb, hg, hnl = b.cpu(), g.cpu(), nl.cpu()
    got = hs.leaf_hist_rmw(b, g, start, cnt, child=(nl, small_side),
                           state=state, idx=idx, absmax=absmax, **kw)
    want = hs.leaf_hist_rmw_fixed_plain(hb, hg, start, cnt,
                                        child=(hnl, small_side),
                                        state=want_state, idx=idx,
                                        absmax=hmax, **kw)
    got_state = state.cpu()
    assert torch.equal(got_state, want_state)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    hkw = dict(num_bins=B, num_groups=G, absmax=hmax, kcnt=kcnt)
    direct = [th.leaf_hist_fixed_sums(hb, hg, start, cnt, child=(hnl, s),
                                      **hkw)[0] for s in (0, 1)]
    _, wa, wb, _ = idx
    if wa != wb:
        assert torch.equal(got_state[wa], direct[0])
    assert torch.equal(got_state[wb], direct[1])
    for s in (0, 1):
        plane = th.leaf_hist_fixed_plain(hb, hg, start, cnt, child=(hnl, s),
                                         planes=True, **hkw)
        assert torch.equal(got[:, s].cpu().view(torch.int32),
                           plane.view(torch.int32))


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
    # the card's state is updated only inside the fused launch
    with pytest.raises(ValueError, match="leaf_hist_rmw"):
        hs.hist_rmw(torch.zeros((4, 2, 28, 256), dtype=torch.int64,
                                device=card),
                    torch.zeros((2, 28, 256), dtype=torch.int64,
                                device=card), (0, 0, 1, 1))
    state = hs.new_state(4, 28, 255, card)
    kw = dict(num_bins=255, num_groups=28, absmax=pg[:2, 0].abs() + 1)
    for bad in (dict(state=state, idx=(0, 4, 1, 1), kcnt=8192),
                dict(state=state, idx=(0, 0, 1, 2), kcnt=8192),
                dict(state=state.float(), idx=(0, 0, 1, 1), kcnt=8192),
                dict(state=state, idx=(0, 0, 1, 1), kcnt=None),
                dict(state=state, idx=(0, 0, 1, 1), kcnt=50)):
        with pytest.raises(ValueError):
            hs.leaf_hist_rmw(pb, pg, 0, 100, **kw, **bad)


# ---- the step block and the device-resident tree loop -------------------

STEP_BOUND = (1 << 19) - 8192   # a fixed bound well above every case's rows


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(["root", "final", "sil tie",
                                         "s == nodes", "stopped"]
                                        + list(_tl.GAIN_CASES)))
def test_tree_step_kernel_bit_identical_to_plain(card, case):
    """csrc/tree_step.cu against tree_step_plain on the CPU, bit for bit
    on leafmat, nodemat, the step block and the info block."""
    mode = {"root": ts.MODE_ROOT, "final": ts.MODE_FINAL}.get(case,
                                                             ts.MODE_STEP)
    if case == "sil tie":
        c = _tl.tree_case(2, sil_tie=True)
    elif case == "s == nodes":
        c = _tl.tree_case(4, L=6, made=5)
    elif case == "stopped":
        c = _tl.tree_case(7, gains=_tl.GAIN_CASES["max gain 0 stops"])
        ts.tree_step_plain(ts.MODE_STEP, *c, row0=_tl.ROW0, N=_tl.N)
    else:
        c = _tl.tree_case(1, gains=_tl.GAIN_CASES.get(case))
    dev = [t.to(card) for t in c]
    kw = dict(row0=_tl.ROW0, N=_tl.N)
    ts.tree_step(mode, *dev, **kw)
    ts.tree_step_plain(mode, *c, **kw)
    for got, want in zip(dev, c):
        assert torch.equal(_tl._bits(got.cpu()), _tl._bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["split_mega", "partition",
                                    "leaf_hist_rmw"])
@pytest.mark.parametrize("case", ["offset0", "offset7", "tile_plus_1",
                                  "unaligned_tile_minus_1", "one_row",
                                  "ends_at_n_pad", "all_left",
                                  "regression_scale"])
def test_step_block_launch_matches_host_int_launch(card, kernel, case):
    """A kernel fed a step block, its grid and scratch sized for a fixed
    bound (as the tree loop launches it), gives the bits of its host-int
    launch, whose grid is sized for the call's own rows."""
    G, B = 28, 255
    pb, pg, sc = _risk_buffers(case, G)
    start, cnt = tpart.scalars_start(sc), sc[tpart.S_CNT]
    b, g = pb.to(card), pg.to(card)
    absmax = g[:2].abs().amax(dim=1)
    if kernel == "split_mega":
        want = sm.split_mega(b, g, sc, num_bins=B, num_groups=G,
                             absmax=absmax)
    elif kernel == "partition":
        want = (tpart.partition_leaf(b, g, sc),)
    else:
        state0 = hs.new_state(8, G, B, card)
        root = hs.leaf_hist_rmw(b, g, start, cnt, num_bins=B, num_groups=G,
                                state=state0, idx=(-1, 2, 2, 0),
                                absmax=absmax, kcnt=1 << 20)
        nl0 = tpart.partition_leaf(b, g, sc)
        ch = hs.leaf_hist_rmw(b, g, start, cnt, num_bins=B, num_groups=G,
                              state=state0, idx=(2, 2, 5, 1),
                              child=(nl0, 0), absmax=absmax, kcnt=1 << 20)
        want = (root, nl0, ch, state0)
    b2, g2 = pb.to(card), pg.to(card)
    nl = torch.zeros(1, dtype=torch.int32, device=card)
    if kernel == "split_mega":
        hist = torch.zeros((G, 64, 16), device=card)
        sm.split_mega_step(b2, g2, tpart.step_block(sc, card), nl, hist,
                           num_bins=B, num_groups=G, absmax=absmax,
                           bound=STEP_BOUND)
        got = (nl, hist)
    elif kernel == "partition":
        tpart.partition_step(b2, g2, tpart.step_block(sc, card), nl,
                             bound=STEP_BOUND)
        got = (nl,)
    else:
        state = hs.new_state(8, G, B, card)
        kw = dict(num_bins=B, num_groups=G, state=state, absmax=absmax,
                  kcnt=1 << 20, bound=STEP_BOUND)
        root = torch.zeros((2, 2, G, 256), device=card)
        hs.leaf_hist_rmw_step(
            b2, g2, tpart.step_block(sc, card, (-1, 2, 2, 0), 0), None,
            out=root, **kw)
        tpart.partition_step(b2, g2, tpart.step_block(sc, card), nl,
                             bound=STEP_BOUND)
        ch = torch.zeros((2, 2, G, 256), device=card)
        hs.leaf_hist_rmw_step(
            b2, g2, tpart.step_block(sc, card, (2, 2, 5, 1), 1), nl,
            out=ch, **kw)
        got = (root, nl, ch, state)
    assert torch.equal(b2, b)
    assert torch.equal(g2.view(torch.int32), g.view(torch.int32))
    for x, y in zip(got, want):
        assert torch.equal(_tl._bits(x), _tl._bits(y))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["split_mega", "partition",
                                    "leaf_hist_rmw"])
@pytest.mark.parametrize("step_case", ["stopped", "outside the bound"])
def test_step_of_no_rows_writes_nothing(card, kernel, step_case):
    """A step with cnt == 0 (the tree has stopped) leaves the rows and
    every state slot byte-identical and reports a left count of 0; a step
    whose range lies outside the launch's bound does the same and sets
    the step block's error word."""
    G, B = 28, 255
    pb, pg = _row_buffers(6)
    if step_case == "stopped":
        sc = make_scalars(4096 + 5, 0, 5, 0, 0, 255, 0, 0, 120, 1)
    else:
        sc = make_scalars(4096 + 5, 9000, 5, 0, 0, 255, 0, 0, 120, 1)
    b, g = pb.to(card), pg.to(card)
    step = tpart.step_block(sc, card, (2, 2, 5, 1), 0)
    nl = torch.full((1,), 7, dtype=torch.int32, device=card)
    state = hs.new_state(8, G, B, card)
    state.random_(-1000, 1000)
    state0 = state.clone()
    absmax = g[:2].abs().amax(dim=1)
    bound = 8000
    if kernel == "split_mega":
        hist = torch.zeros((G, 64, 16), device=card)
        sm.split_mega_step(b, g, step, nl, hist, num_bins=B, num_groups=G,
                           absmax=absmax, bound=bound)
        assert not hist.any()
    elif kernel == "partition":
        tpart.partition_step(b, g, step, nl, bound=bound)
    else:
        out = torch.zeros((2, 2, G, 256), device=card)
        hs.leaf_hist_rmw_step(b, g, step, None, num_bins=B, num_groups=G,
                              state=state, absmax=absmax, kcnt=1 << 20,
                              out=out, bound=bound)
    assert torch.equal(b.cpu(), pb)
    assert torch.equal(g.cpu().view(torch.int32), pg.view(torch.int32))
    assert torch.equal(state, state0)
    if kernel != "leaf_hist_rmw":
        assert int(nl) == 0
    err = int(step[tpart.SB_ERR])
    assert err == (0 if step_case == "stopped" else tpart.ERR_RANGE)


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["mega", "subtraction"])
@pytest.mark.parametrize("example", ["binary", "regression"])
def test_graph_replay_trees_equal_eager_oracle(card, body, example):
    """Three trees grown by replaying the captured graph equal the eager
    oracle's on the card, bit for bit: leafmat, nodemat, the tree record
    and the row order of both row buffers after each tree; one host read
    a tree."""
    rel, obj = _tl.EXAMPLES[example]
    X, y = _tl._load(rel)
    params = {"objective": obj, "num_leaves": 15, "verbosity": -1}
    if body == "subtraction":
        params["tpu_megakernel"] = "off"
    for a, b in _tl.lockstep(X, y, params, "cuda"):
        _tl.assert_same_tree(a, b)
    learner = a._gbdt.learner
    assert learner.syncs == 3 and learner.replays == 3


# ---- the frontier (K > 1): bookkeeping, 2K-child search, graph trees ------

def frontier_calls(X, y, params, rounds=2):
    """Train on the CPU with the frontier and keep, before every
    bookkeeping call, a CPU copy of its state and its mode; and before
    every undo, the row buffers and the state."""
    from lightgbm_tpu_torch.models import learner as lm
    from lightgbm_tpu_torch.ops import frontier as fro
    calls, undos = [], []
    real_step, real_undo = lm.frontier_step, lm.frontier_undo

    def step(mode, fr, **kw):
        calls.append((mode, fr.to("cpu"), dict(kw, handles=(0, 0))))
        return real_step(mode, fr, **kw)

    def undo(pb, pg, fr, **kw):
        undos.append((pb.clone(), pg.clone(), fr.to("cpu"),
                      calls[-1][2]["row0"], kw["bound"]))
        return real_undo(pb, pg, fr, **kw)

    lm.frontier_step, lm.frontier_undo = step, undo
    try:
        lgt.train(dict(params, device_type="cpu"), lgt.Dataset(X, label=y),
                  num_boost_round=rounds)
    finally:
        lm.frontier_step, lm.frontier_undo = real_step, real_undo
    return fro, calls, undos


@pytest.mark.cuda
@pytest.mark.parametrize("leaves,k", [(15, 4), (12, 4), (8, 5), (31, 2)])
def test_frontier_step_kernel_bit_identical_to_plain(card, leaves, k):
    """The bookkeeping kernel against frontier_step_plain on every state
    of two real trees (the root's reset, each step's commit, replay and
    selection, the final renumber): every buffer bit for bit."""
    X, y = _tl._load(_tl.EXAMPLES["binary"][0])
    fro, calls, _ = frontier_calls(X, y, {
        "objective": "binary", "num_leaves": leaves, "verbosity": -1,
        "tpu_frontier_k": k})
    assert len(calls) > 6
    for i, (mode, fr, kw) in enumerate(calls):
        want = fr.to("cpu")
        fro.frontier_step_plain(mode, want, **{n: v for n, v in kw.items()
                                               if n != "handles"})
        got = fr.to(card)
        fro.frontier_step(mode, got, **kw)
        for name in fro.Frontier.TENSORS:
            a, b = getattr(got, name).cpu(), getattr(want, name)
            assert torch.equal(_tl._bits(a), _tl._bits(b)), (i, mode, name)


@pytest.mark.cuda
def test_frontier_key_and_undo_kernels_bit_identical_to_plain(card):
    """The key row (positions, then zeros) and the undo of the pruned
    ranges against their plain versions, on the states of real trees
    where the replay pruned."""
    X, y = _tl._load(_tl.EXAMPLES["binary"][0])
    fro, _, undos = frontier_calls(X, y, {
        "objective": "binary", "num_leaves": 12, "verbosity": -1,
        "tpu_frontier_k": 4}, rounds=4)
    assert undos, "no tree pruned"
    for pb, pg, fr, row0, N in undos:
        for clear in (False, True):
            g, gc = pg.clone(), pg.to(card)
            fro.frontier_key_plain(g, row0=row0, N=N, clear=clear)
            fro.frontier_key(gc, row0=row0, N=N, clear=clear)
            assert torch.equal(gc.cpu().view(torch.int32),
                               g.view(torch.int32))
        b, g = pb.clone(), pg.clone()
        fro.frontier_undo_plain(b, g, fr)
        bc, gc = pb.to(card), pg.to(card)
        fro.frontier_undo(bc, gc, fr.to(card), bound=N)
        assert torch.equal(bc.cpu(), b)
        assert torch.equal(gc.cpu().view(torch.int32), g.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4, 8])
def test_split_pair_2k_children_equal_per_pair_launches(card, k):
    """One launch over 2K children gives each child the bits of the pair
    launch that holds it."""
    _pair_2k(card, k, 28)


@pytest.mark.cuda
def test_split_pair_8_children_at_136_features(card):
    """The frontier's 2K = 8 children at MSLR-WEB30K's 136 features."""
    _pair_2k(card, 4, 136)


def _pair_2k(card, k, F):
    BF = 256
    pairs = [_pair_case(100 + i, F, BF) for i in range(k)]
    # children order of the frontier: the K left children, then the K
    # right ones
    hg = torch.cat([p[0][:F] for p in pairs] + [p[0][F:] for p in pairs])
    hh = torch.cat([p[1][:F] for p in pairs] + [p[1][F:] for p in pairs])
    fm = torch.cat([p[2][:F] for p in pairs] + [p[2][F:] for p in pairs])
    info = torch.cat([p[3][:F] for p in pairs] + [p[3][F:] for p in pairs])
    got = sp.split_pair(hg.to(card), hh.to(card), fm.to(card),
                        info.to(card), children=2 * k, **PARAMS[0]).cpu()
    for i, p in enumerate(pairs):
        one = sp.split_pair(*(a.to(card) for a in p), **PARAMS[0]).cpu()
        assert torch.equal(got[i].view(torch.int32), one[0].view(torch.int32))
        assert torch.equal(got[k + i].view(torch.int32),
                           one[1].view(torch.int32))
    plain = sp.split_pair_plain(hg, hh, fm, info, children=2 * k,
                                **PARAMS[0])
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("leaves,k", [(15, 4), (12, 4), (31, 3)])
@pytest.mark.parametrize("example", ["binary", "regression"])
def test_frontier_graph_trees_equal_k1(card, example, leaves, k):
    """Trees grown by the frontier's graph (conditional IF nodes) equal
    the K=1 graph loop's on the card, bit for bit: leafmat, nodemat, the
    tree record and the row order of both row buffers after each tree;
    one host read a tree."""
    rel, obj = _tl.EXAMPLES[example]
    X, y = _tl._load(rel)
    params = {"objective": obj, "num_leaves": leaves, "verbosity": -1}
    a = lgt.Booster(dict(params, device_type="cuda", tpu_frontier_k=k),
                    lgt.Dataset(X, label=y))
    b = lgt.Booster(dict(params, device_type="cuda", tpu_frontier_k=1),
                    lgt.Dataset(X, label=y))
    made = []
    for _ in range(4):
        a.update()
        b.update()
        _tl.assert_same_tree(a, b)
        made.append(a._gbdt.learner.last_made - a._gbdt.models[-1]
                    .num_leaves + 1)
    learner = a._gbdt.learner
    assert learner.K == k and learner.syncs == 4 and learner.replays == 4
    assert all(0 <= p <= k - 1 for p in made)


@pytest.mark.cuda
@pytest.mark.parametrize("min_gain", [5.0, 1e9])
def test_frontier_graph_trees_that_stop_early_equal_k1(card, min_gain):
    """Trees that stop early, down to stumps (no step's IF node taken),
    grown by the frontier's graph equal the K=1 graph loop's on the card,
    row order included."""
    X, y = _tl._load(_tl.EXAMPLES["binary"][0])
    params = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
              "min_gain_to_split": min_gain}
    a = lgt.Booster(dict(params, device_type="cuda", tpu_frontier_k=3),
                    lgt.Dataset(X, label=y))
    b = lgt.Booster(dict(params, device_type="cuda", tpu_frontier_k=1),
                    lgt.Dataset(X, label=y))
    for _ in range(2):
        a.update()
        b.update()
        _tl.assert_same_tree(a, b)
    assert a._gbdt.learner.K == 3
    if min_gain >= 1e9:
        assert a._gbdt.learner.last_steps == 0



@pytest.mark.cuda
def test_many_frontier_learners_in_one_process(card):
    """More frontier learners than PyTorch's pool holds streams, each
    capturing its graph in turn: no learner's IF-node body stream is the
    stream its graph is captured on."""
    rng = np.random.RandomState(11)
    X = rng.normal(size=(3000, 5))
    y = (X[:, 0] + 0.5 * rng.normal(size=3000) > 0).astype(float)
    d = lgt.Dataset(X, label=y)
    first = None
    for _ in range(40):
        b = lgt.train({"objective": "binary", "num_leaves": 7,
                       "verbosity": -1, "tpu_frontier_k": 3}, d, 1)
        assert b._gbdt.learner.K == 3 and b._gbdt.learner.replays == 1
        raw = b.predict(X[:50], raw_score=True)
        if first is None:
            first = raw
        np.testing.assert_array_equal(raw, first)


# ---- EFB bundles and sampling ----------------------------------------------

def _sample_payload(seed, N=300000, C=4096):
    """A payload as the fused iteration lays it out (pad rows carry the
    row id N and zero gradients), the label sign in row 4."""
    rng = np.random.RandomState(seed)
    Np = C + ((N + C - 1) // C + 2) * C
    ghi = np.zeros((8, Np), np.float32)
    rid = np.full(Np, N, np.int32)
    rid[C:C + N] = rng.permutation(N)
    real = rid != N
    g = rng.randn(Np).astype(np.float32)
    g[rng.rand(Np) < 0.05] = 0.25
    ghi[0] = np.where(real, g, 0)
    ghi[1] = np.where(real, rng.rand(Np) + 0.05, 0)
    ghi[2] = rid.view(np.float32)
    ghi[4] = np.where(rng.rand(Np) < 0.3, 1.0, -1.0) * real
    return torch.as_tensor(ghi), N


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bag", "balanced", "goss"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sample_kernel_bit_identical_to_plain(card, mode, seed):
    """csrc/sample.cu against sample_plain: the payload words and the
    in-bag count."""
    ghi, N = _sample_payload(seed)
    key = jr.fold_in(jr.PRNGKey(3), seed + 5)
    m = {"bag": smp.MODE_BAG, "balanced": smp.MODE_BALANCED,
         "goss": smp.MODE_GOSS}[mode]
    kw = dict(N=N, key=key, frac=0.7, pos_frac=0.5, neg_frac=0.9,
              sign_row=4, other_k=N // 10, mult=(N - N // 5) / (N // 10))
    out = {}
    for dev in ("cpu", card):
        t = ghi.clone().to(dev)
        bag = torch.zeros(1, dtype=torch.int32, device=dev)
        if m == smp.MODE_GOSS:
            kw["thr"], kw["n_top"] = smp.goss_threshold(t, N, N // 5)
        smp.sample(t, bag, m, **kw)
        out[str(dev)] = (t.cpu(), int(bag[0]))
    (a, ca), (b, cb) = out.values()
    assert ca == cb and 0 < ca < N
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _view_case(seed, G=36, Bp=48, slots=5):
    """28 features alone in their groups and 8 bundles of 32 two-bin
    indicators (the smoke's EFB shape, cut in rows), an int64 state."""
    rng = np.random.RandomState(seed)
    group, bstart, isb, nb = [], [], [], []
    for g in range(28):
        group.append(g)
        bstart.append(0)
        isb.append(0)
        nb.append(int(rng.randint(20, Bp + 1)))
    for g in range(28, G):
        for i in range(32):
            group.append(g)
            bstart.append(i)
            isb.append(1)
            nb.append(2)
    view = fv.View(np.array(group), np.array(bstart), np.array(isb),
                   np.array(nb), G, Bp, "cpu")
    state = torch.as_tensor(rng.randint(-2 ** 50, 2 ** 50,
                                        size=(slots, 2, G, Bp)))
    return view, state


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["split", "root", "stopped", "seed1"])
def test_feat_view_kernel_bit_identical_to_plain(card, case):
    view, state = _view_case(1 if case == "seed1" else 0)
    step = torch.zeros(tpart.STEP_WORDS, dtype=torch.int32)
    step[tpart.SB_CNT] = 0 if case == "stopped" else 1000
    step[tpart.SB_WA], step[tpart.SB_WB] = (0, 0) if case == "root" else (
        3, 1)
    absmax = torch.tensor([0.8, 0.24])
    want = fv.feat_view_fixed_plain(state, step, absmax, 1 << 20, view)
    vd = view.to(card)
    out = torch.zeros((2, 2, view.F, view.Bp), device=card)
    fv.feat_view(None, None, state.to(card), step.to(card), absmax.to(card),
                 kcnt=1 << 20, view=vd, out=out)
    assert torch.equal(out.cpu().view(torch.int32), want.view(torch.int32))
    assert (case == "stopped") == (not want.any())


def _onehot(n=20000, seed=5):
    rng = np.random.RandomState(seed)
    dense = rng.normal(size=(n, 4))
    cats = [rng.randint(0, k, size=n) for k in (5, 8, 3)]
    X = np.hstack([dense] + [np.eye(k)[c] for k, c in zip((5, 8, 3), cats)])
    y = (dense[:, 0] + (cats[0] == 2) - (cats[1] > 4)
         + 0.3 * rng.normal(size=n) > 0).astype(float)
    return X, y


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["none", "bagging", "goss"])
def test_bundled_graph_trees_equal_eager_oracle(card, sampling):
    """On bundled data, with and without sampling: trees grown by the
    graph (feat_view between the state update and the pair search) equal
    the eager oracle's on the card, bit for bit; one capture serves every
    draw, one host read a tree."""
    X, y = _onehot()
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "feature_fraction": 0.8}
    if sampling == "bagging":
        params.update(bagging_fraction=0.7, bagging_freq=1)
    elif sampling == "goss":
        params.update(data_sample_strategy="goss")
    for a, b in _tl.lockstep(X, y, params, "cuda", trees=5):
        _tl.assert_same_tree(a, b)
    lr = a._gbdt.learner
    assert lr.bundled and lr.subtract
    assert lr.syncs == 5 and lr.replays == 5 and lr.captures == 1


@pytest.mark.cuda
@pytest.mark.parametrize("k", ["1", "4"])
def test_one_graph_capture_across_bagged_iterations(card, k):
    """Bagging redraws the bag every iteration: the count is a device
    word, so the tree graph is captured once and replayed for every
    draw; the card's trees and counts equal the CPU's."""
    X, y = _tl._load(_tl.EXAMPLES["binary"][0])
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "bagging_fraction": 0.6, "bagging_freq": 1,
              "feature_fraction": 0.7, "tpu_frontier_k": k}
    out = {}
    for dev in ("cpu", "cuda"):
        b = lgt.train(dict(params, device_type=dev), lgt.Dataset(X, label=y),
                      6)
        out[dev] = b
    lr = out["cuda"]._gbdt.learner
    assert lr.captures == 1 and lr.replays == 6 and lr.syncs == 6
    assert lr.K == int(k)
    for a, b in zip(out["cpu"]._gbdt.models, out["cuda"]._gbdt.models):
        assert a.internal_count[0] == b.internal_count[0] < len(y)
        assert np.array_equal(a.split_feature, b.split_feature)
        assert np.array_equal(a.threshold_bin, b.threshold_bin)



# ---- categorical features: split_cat, the set decision, graph trees -------

from lightgbm_tpu_torch.ops import split_cat as scat  # noqa: E402

CAT_PARAMS = [
    dict(max_cat_threshold=32, cat_l2=10.0, cat_smooth=10.0,
         max_cat_to_onehot=4, min_data_per_group=100),
    dict(max_cat_threshold=4, cat_l2=1.0, cat_smooth=1.0,
         max_cat_to_onehot=8, min_data_per_group=5),
]


def cat_case(seed, F=10, BF=255, ncat=4, C=2):
    """The pair search's inputs for C children with ``ncat`` categorical
    features among F (FM_IS_CAT set), counts from the hessians, and the
    numerical pair rows split_pair writes for them."""
    rng = np.random.RandomState(seed)
    hg, hh, fm, info = _pair_case(seed, F, BF)
    cats = np.sort(rng.choice(F, ncat, replace=False)).astype(np.int32)
    half = fm[:F].numpy().copy()
    half[cats, 0] = rng.choice([3, 5, 9, 40, BF], ncat)
    half[cats, 1] = 2
    half[cats, 3] = 1
    fm = torch.as_tensor(np.concatenate([half] * C))
    hg, hh = hg.repeat(C // 2, 1), hh.repeat(C // 2, 1)
    info = info.repeat(C // 2, 1)
    info[:, 2] = torch.floor(info[:, 1] * 40)
    return hg, hh, fm, info, torch.as_tensor(cats)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(10, 255), (10, 256), (6, 16), (38, 201)])
@pytest.mark.parametrize("ci", range(len(CAT_PARAMS)))
@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_split_cat_kernel_bit_identical_to_plain(card, shape, ci, pi):
    """csrc/split_cat.cu against split_cat_plain on the card and on the
    CPU, bit for bit on the merged (2, 13) rows and the (2, 8) sets, over
    both arms, the feature mask and max_depth; a second launch on the
    same scratch (the ticket left at 0) gives the same bits."""
    F, BF = shape
    hg, hh, fm, info, cats = cat_case(F + BF + ci, F, BF, min(4, F))
    kw = dict(PARAMS[pi], **CAT_PARAMS[ci])
    pair = sp.split_pair_plain(hg, hh, fm, info, **PARAMS[pi])
    want, wset = pair.clone(), torch.zeros((2, 8), dtype=torch.int32)
    scat.split_cat(hg, hh, fm, info, cats, want, wset, **kw)
    dev = [t.to(card) for t in (hg, hh, fm, info, cats)]
    work = scat.new_work(2, len(cats), card)
    for _ in range(2):
        got = pair.to(card)
        gset = torch.full((2, 8), 7, dtype=torch.int32, device=card)
        scat.split_cat(*dev, got, gset, work=work, **kw)
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
        assert torch.equal(gset.cpu(), wset)
    plain = pair.to(card)
    pset = torch.zeros((2, 8), dtype=torch.int32, device=card)
    scat.split_cat_plain(*dev, plain, pset, **kw)
    assert torch.equal(plain.cpu().view(torch.int32), want.view(torch.int32))
    assert torch.equal(pset.cpu(), wset)
    assert int(work[-1]) == 0


CAT_PART_CASES = {
    "plain": (4096 + 77, 300_001, 5, 0, 0, 255, 0, 2, 0, 0),
    "bundled": (123, 33_333, 2, 10, 1, 60, 0, 2, 0, 0),
    "cnt0": (5000, 0, 3, 0, 0, 255, 0, 2, 0, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CAT_PART_CASES))
def test_partition_categorical_bit_identical_to_plain(card, case):
    """A categorical step (left iff the decoded bin is in the set)
    through the partition kernel, bit for bit against the plain
    version: bins, payload words and the left count."""
    rng = np.random.RandomState(11)
    words = [int(v) for v in rng.randint(-2 ** 31, 2 ** 31, 8)]
    words[0] &= ~1          # bin 0 never joins a set
    sc = make_scalars(*CAT_PART_CASES[case], 1, words)
    pb, pg = _row_buffers(5)
    b, g = pb.to(card), pg.to(card)
    nl = tpart.partition_leaf(b, g, sc)
    b0, g0 = pb.clone(), pg.clone()
    enl = tpart.partition_leaf_plain(b0, g0, sc)
    assert int(nl) == int(enl)
    assert torch.equal(b.cpu(), b0)
    assert torch.equal(g.cpu().view(torch.int32), g0.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["root", "step", "final"])
def test_tree_step_kernel_with_category_sets(card, case):
    """tree_step with the category sets: leafcat / nodecat / paircat, the
    step block's SB_ISCAT / SB_CAT and ND_IS_CAT, bit for bit against
    tree_step_plain."""
    mode = {"root": ts.MODE_ROOT, "final": ts.MODE_FINAL}.get(case,
                                                             ts.MODE_STEP)
    c = _tl.tree_case(3)
    # the elected leaf categorical or not, whichever it is in this case
    L = c[0].shape[1] - 1
    c[0][ts.LM_BISCAT, :L] = torch.arange(L) % 2
    dev = [t.to(card) for t in c]
    kw = dict(row0=_tl.ROW0, N=_tl.N)
    ts.tree_step(mode, *dev, **kw)
    ts.tree_step_plain(mode, *c, **kw)
    for got, want in zip(dev, c):
        assert torch.equal(_tl._bits(got.cpu()), _tl._bits(want))


def _cat_rows(n=6000, seed=0):
    """Numerical columns, a 30-level categorical with NaN, negative and
    rare values, a 3-level one (one-vs-rest), a mostly-NaN one (default
    and most frequent bin 0) and a mostly-zero numerical column on the
    other rows, which the two bundle with (EFB)."""
    rng = np.random.RandomState(seed)
    c30 = rng.randint(0, 30, n).astype(float)
    c30[rng.rand(n) < 0.05] = np.nan
    c30[rng.rand(n) < 0.02] = -2
    c30[:7] = 97                                    # rare
    c3 = rng.randint(0, 3, n).astype(float)
    r = rng.rand(n)
    sparse = np.where(r < 0.08, rng.randint(1, 6, n), np.nan)
    znum = np.where((r >= 0.08) & (r < 0.14), rng.rand(n) + 0.1, 0.0)
    x = rng.randn(n, 3)
    y = (np.isin(c30, [1, 4, 9, 16, 25]) * 1.5 + (c3 == 2) * 0.8
         + (sparse == 3) * 1.0 + znum + x[:, 0] + 0.3 * rng.randn(n))
    X = np.column_stack([x[:, 0], c30, x[:, 1], c3, sparse, x[:, 2], znum])
    return X, (y > np.median(y)).astype(float)


@pytest.mark.cuda
@pytest.mark.parametrize("bundle", [False, True])
def test_categorical_graph_trees_equal_eager_oracle(card, bundle):
    """On categorical data (the subtraction body, split_cat after the
    pair search, the sets through tree_step into the partition): trees
    grown by the graph equal the eager oracle's on the card, bit for bit,
    the category sets included; one capture, one host read a tree; the
    card's trees equal the CPU's."""
    X, y = _cat_rows()
    params = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
              "categorical_feature": "1,3,4", "min_data_per_group": 20,
              "cat_smooth": 5, "enable_bundle": bundle}
    for a, b in _tl.lockstep(X, y, params, "cuda", trees=4):
        _tl.assert_same_tree(a, b)
        la, lb = a._gbdt.learner, b._gbdt.learner
        assert torch.equal(la.nodecat, lb.nodecat)
        ta, tb = a._gbdt.models[-1], b._gbdt.models[-1]
        assert ta.cat_threshold == tb.cat_threshold
    lr = a._gbdt.learner
    assert lr.has_cat and lr.subtract and lr.K == 1 and lr.bundled == bundle
    assert lr.captures == 1 and lr.syncs == 4
    assert sum(t.num_cat for t in a._gbdt.models) > 0
    cpu = lgt.train(dict(params, device_type="cpu"), lgt.Dataset(X, label=y),
                    4)
    for ta, tb in zip(a._gbdt.models, cpu._gbdt.models):
        assert np.array_equal(ta.split_feature, tb.split_feature)
        assert ta.cat_threshold == tb.cat_threshold
        assert np.array_equal(ta.leaf_count, tb.leaf_count)


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
def test_renewal_on_the_card_equals_its_cpu_run(card, weighted):
    """The L1-family leaf renewal (models/renew.py: one int64 sort, then
    a gather or two a leaf) on the card equals its run on the CPU on the
    same inputs, bit for bit: unweighted it is f32 arithmetic on equal
    sorted values; weighted, the float64 sums of f32 weights are exact
    in any order here."""
    from lightgbm_tpu_torch.models.renew import renew_leaves
    rng = np.random.RandomState(9)
    N, L = 300_000, 255
    cnts = rng.multinomial(N - 2 * L, np.ones(L) / L) + 2
    cnts[rng.choice(L, 5, replace=False)] = 0
    cnts[0] += N - cnts.sum()
    perm = rng.permutation(L)
    starts = np.zeros(L, np.int64)
    starts[perm] = np.concatenate([[0], np.cumsum(cnts[perm])[:-1]])
    resid = np.round(rng.randn(N) * 3, 2).astype(np.float32)
    sel = rng.rand(N) < 0.8
    w = rng.uniform(0.1, 2.5, N).astype(np.float32) if weighted else None
    old = rng.randn(L).astype(np.float32)
    args = [torch.from_numpy(a) for a in (starts.astype(np.int32),
                                          cnts.astype(np.int32), old,
                                          resid, sel)]
    wt = torch.from_numpy(w) if weighted else None
    for alpha in (0.5, 0.9):
        host = renew_leaves(*args, wt, alpha)
        got = renew_leaves(*(a.to(card) for a in args),
                           wt.to(card) if weighted else None, alpha)
        assert torch.equal(got.cpu().view(torch.int32),
                           host.view(torch.int32))


def _objective_rows(objective, n=4000, seed=3):
    """Rows, label, init_score and weight: 5 classes from the argmax of
    noisy features with a seeded init_score (the first iteration then
    meets no exact tie), or a continuous label with row weights for
    quantile (its two-valued gradients tie often without them)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8)
    if objective == "quantile":
        y = X[:, 0] * 2 + X[:, 1] + rng.randn(n)
        return X, y, None, rng.uniform(0.5, 1.5, n)
    y = np.argmax(X[:, :5] + 0.5 * rng.randn(n, 5), 1).astype(float)
    return X, y, rng.randn(5 * n) * 0.5, None


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["mega", "subtraction"])
@pytest.mark.parametrize("objective", ["multiclass", "multiclassova",
                                       "quantile"])
def test_other_objectives_on_the_card(card, body, objective):
    """5-class boosters (the class scores in original row order, each
    class tree one graph replay) and a quantile booster (leaves renewed
    before the tree's host read) on the card: the graph's trees, class
    scores and row buffers equal the eager oracle's bit for bit, one
    capture and one tree read a tree; on the mega body the card's trees
    equal the CPU's (structure, leaf values rtol 1e-4 / atol 1e-5, raw
    predictions atol 1e-5).  The subtraction body is held to the oracle
    only: the CPU's f32 state subtracts its way to small leaves, the
    card's int64 state is exact."""
    X, y, init, w = _objective_rows(objective)
    params = {"objective": objective, "num_leaves": 31, "verbosity": -1,
              "min_data_in_leaf": 20, "min_gain_to_split": 0.01,
              "device_type": "cuda"}
    if objective != "quantile":
        params["num_class"] = 5
    if body == "subtraction":
        params["tpu_megakernel"] = "off"

    def booster(**kw):
        return lgt.Booster(dict(params, **kw), lgt.Dataset(
            X, label=y, init_score=init, weight=w))
    a, b = booster(), booster()
    b._gbdt.learner.build_tree = b._gbdt.learner.build_tree_eager
    for _ in range(3):
        a.update()
        b.update()
        ga, gb = a._gbdt, b._gbdt
        for ta, tb in zip(ga.models, gb.models):
            for f in ("split_feature", "threshold_bin", "left_child",
                      "leaf_value", "leaf_count", "internal_value"):
                assert np.array_equal(getattr(ta, f), getattr(tb, f)), f
        assert torch.equal(ga.scores.contiguous().view(torch.int32),
                           gb.scores.contiguous().view(torch.int32))
        for x, z in zip(ga._phys, gb._phys):
            assert torch.equal(x.view(torch.int32), z.view(torch.int32))
    K = ga.num_tree_per_iteration
    lr = ga.learner
    assert lr.captures == 1 and lr.syncs == lr.replays == 3 * K
    if body == "subtraction":
        return
    cpu = booster(device_type="cpu")
    for _ in range(3):
        cpu.update()
    for ta, tb in zip(ga.models, cpu._gbdt.models):
        n = ta.num_nodes()
        assert ta.num_leaves == tb.num_leaves
        assert np.array_equal(ta.split_feature[:n], tb.split_feature[:n])
        assert np.array_equal(ta.threshold_bin[:n], tb.threshold_bin[:n])
        assert np.array_equal(ta.leaf_count, tb.leaf_count)
        np.testing.assert_allclose(ta.leaf_value, tb.leaf_value, rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(a.predict(X, raw_score=True),
                               cpu.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)


# ---- wide bins: uint16 bin matrices, rows wider than 256 bins -------------
#
# Every uint16 and wide arm against its plain version, max_abs_err 0: the
# partition (words moved), leaf_hist and its state launch (exact int64
# sums: bit-identical), the wide histogram arm past one block's shared
# memory (max_bin 16383), split_pair and split_cat at BF > 256 (the same
# f32 operations and blocked f64 prefix sums), feat_view at Bp > 256 and
# tree_step with sets of more than 8 words; the mega kernel and the
# frontier's undo raise on uint16 bins.

def _u16_buffers(seed, G=4, n_pad=1 << 17, top=1023):
    rng = np.random.RandomState(seed)
    pb = torch.as_tensor(rng.randint(0, top, (G, n_pad)).astype(np.uint16))
    pg = torch.as_tensor(rng.randn(8, n_pad).astype(np.float32))
    pg[1] = pg[1].abs()
    pg[2] = torch.arange(n_pad, dtype=torch.int32).view(torch.float32)
    return pb, pg


U16_PART_CASES = {
    "unaligned": (4096 + 77, 60_001, 1, 0, 0, 1023, 0, 0, 500, 1),
    "offset1": (4097, 5000, 2, 0, 0, 1023, 0, 0, 300, 0),
    "zero_missing": (9000, 50_000, 3, 0, 0, 1023, 40, 1, 900, 1),
    "nan_missing": (9000, 50_000, 0, 0, 0, 1023, 0, 2, 100, 0),
    "bundled": (123, 33_333, 2, 700, 1, 200, 0, 1, 30, 0),
    "cnt0": (5000, 0, 3, 0, 0, 1023, 0, 0, 100, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cat", [False, True])
@pytest.mark.parametrize("case", sorted(U16_PART_CASES))
def test_partition_kernel_u16_bit_identical_to_plain(card, case, cat):
    """The uint16 instantiation of the partition, numerical or with a
    set of 32 words (a step block of SB_CAT + 32): bins, payload words
    and the left count against partition_leaf_plain."""
    pb, pg = _u16_buffers(7)
    sc = U16_PART_CASES[case]
    if cat:
        words = [int(v) for v in np.random.RandomState(3).randint(
            -2 ** 31, 2 ** 31, 32)]
        sc = make_scalars(*sc, 1, words)
    else:
        sc = make_scalars(*sc)
    b, g = pb.to(card), pg.to(card)
    nl = tpart.partition_leaf(b, g, sc)
    b0, g0 = pb.clone(), pg.clone()
    enl = tpart.partition_leaf_plain(b0, g0, sc)
    assert int(nl) == int(enl)
    assert torch.equal(b.cpu(), b0)
    assert torch.equal(g.cpu().view(torch.int32), g0.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,n", [(1023, 28, 1 << 18), (300, 5, 1 << 17),
                                   (16383, 4, 1 << 18)])
def test_leaf_hist_u16_and_wide_arm_bit_identical_to_plain(card, B, G, n):
    """The uint16 histogram (B = 300 and 1023: shared memory; B = 16383:
    the wide arm, one group's planes past a block's shared memory) and
    its state launch, root then the smaller child of a partition, against
    leaf_hist_fixed_plain / leaf_hist_rmw_fixed_plain bit for bit."""
    pb, pg = _u16_buffers(B, G, n, B)
    start, cnt = 4096 + 3, n - 8192
    sc = make_scalars(start, cnt, 1, 0, 0, B, 0, 0, B // 3, 1)
    b, g = pb.to(card), pg.to(card)
    absmax = g[:2].abs().amax(dim=1)
    hmax = absmax.cpu()
    kw = dict(num_bins=B, num_groups=G)
    got = th.leaf_hist(b, g, start, cnt, absmax=absmax, **kw)
    want = th.leaf_hist_fixed_plain(pb, pg, start, cnt, absmax=hmax, **kw)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    kcnt = 1 << 20
    state = hs.new_state(4, G, B, card)
    want_state = state.cpu()
    got = hs.leaf_hist_rmw(b, g, start, cnt, state=state, idx=(-1, 1, 1, 0),
                           absmax=absmax, kcnt=kcnt, **kw)
    want = hs.leaf_hist_rmw_fixed_plain(pb, pg, start, cnt,
                                        state=want_state, idx=(-1, 1, 1, 0),
                                        absmax=hmax, kcnt=kcnt, **kw)
    assert torch.equal(state.cpu(), want_state)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    nl = tpart.partition_leaf(b, g, sc)
    hb, hg, hnl = b.cpu(), g.cpu(), nl.cpu()
    idx = (1, 1, 3, 1)
    got = hs.leaf_hist_rmw(b, g, start, cnt, child=(nl, 0), state=state,
                           idx=idx, absmax=absmax, kcnt=kcnt, **kw)
    want = hs.leaf_hist_rmw_fixed_plain(hb, hg, start, cnt, child=(hnl, 0),
                                        state=want_state, idx=idx,
                                        absmax=hmax, kcnt=kcnt, **kw)
    assert torch.equal(state.cpu(), want_state)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(28, 1024), (7, 257), (3, 3000),
                                   (2, 16384)])
@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_split_pair_kernel_wide_bit_identical_to_plain(card, shape, pi):
    """split_pair past 256 bins (each lane walks ceil(BF / 32) bins):
    all 13 fields bit-identical to split_pair_plain."""
    F, BF = shape
    hg, hh, fm, info = _pair_case(BF + pi, F, BF)
    want = sp.split_pair_plain(hg, hh, fm, info, **PARAMS[pi])
    got = sp.split_pair(*(t.to(card) for t in (hg, hh, fm, info)),
                        **PARAMS[pi])
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(10, 1024), (6, 400), (4, 2048)])
@pytest.mark.parametrize("ci", range(len(CAT_PARAMS)))
def test_split_cat_kernel_wide_bit_identical_to_plain(card, shape, ci):
    """split_cat's wide arm (BF > 256, sets of ceil(BF / 32) words)
    against split_cat_plain on the card and on the CPU, bit for bit; a
    second launch on the same scratch gives the same bits."""
    F, BF = shape
    hg, hh, fm, info, cats = cat_case(F + BF + ci, F, BF, min(4, F))
    kw = dict(PARAMS[0], **CAT_PARAMS[ci])
    W = tpart.cat_words(BF)
    pair = sp.split_pair_plain(hg, hh, fm, info, **PARAMS[0])
    want, wset = pair.clone(), torch.zeros((2, W), dtype=torch.int32)
    scat.split_cat(hg, hh, fm, info, cats, want, wset, **kw)
    dev = [t.to(card) for t in (hg, hh, fm, info, cats)]
    work = scat.new_work(2, len(cats), card, BF)
    for _ in range(2):
        got = pair.to(card)
        gset = torch.full((2, W), 7, dtype=torch.int32, device=card)
        scat.split_cat(*dev, got, gset, work=work, **kw)
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))
        assert torch.equal(gset.cpu(), wset)
    plain = pair.to(card)
    pset = torch.zeros((2, W), dtype=torch.int32, device=card)
    scat.split_cat_plain(*dev, plain, pset, **kw)
    assert torch.equal(pset.cpu(), wset)
    assert int(work[scat.work_words(2, len(cats), BF)
                    - 1 - 2 * len(cats) * scat.WIDE_ROWS * BF]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("Bp", [512, 1024])
def test_feat_view_kernel_wide_bit_identical_to_plain(card, Bp):
    """feat_view past 256 bins (threads striding over the bins) against
    feat_view_fixed_plain, bit for bit."""
    view, state = _view_case(2, Bp=Bp)
    step = torch.zeros(tpart.step_len(tpart.cat_words(Bp)),
                       dtype=torch.int32)
    step[tpart.SB_CNT] = 1000
    step[tpart.SB_WA], step[tpart.SB_WB] = 3, 1
    absmax = torch.tensor([0.8, 0.24])
    want = fv.feat_view_fixed_plain(state, step, absmax, 1 << 20, view)
    out = torch.zeros((2, 2, view.F, view.Bp), device=card)
    fv.feat_view(None, None, state.to(card), step.to(card), absmax.to(card),
                 kcnt=1 << 20, view=view.to(card), out=out)
    assert torch.equal(out.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["root", "step", "final"])
def test_tree_step_kernel_with_wide_sets(card, case):
    """tree_step with sets of 32 words (a step block of SB_CAT + 32),
    bit for bit against tree_step_plain."""
    mode = {"root": ts.MODE_ROOT, "final": ts.MODE_FINAL}.get(case,
                                                             ts.MODE_STEP)
    c = _tl.tree_case(5, W=32)
    L = c[0].shape[1] - 1
    c[0][ts.LM_BISCAT, :L] = torch.arange(L) % 2
    dev = [t.to(card) for t in c]
    kw = dict(row0=_tl.ROW0, N=_tl.N)
    ts.tree_step(mode, *dev, **kw)
    ts.tree_step_plain(mode, *c, **kw)
    for got, want in zip(dev, c):
        assert torch.equal(_tl._bits(got.cpu()), _tl._bits(want))


@pytest.mark.cuda
def test_mega_and_frontier_raise_on_u16_bins(card):
    """The kernels that read bins as bytes raise on a uint16 tensor."""
    from lightgbm_tpu_torch.ops import frontier as fro
    pb = torch.zeros((4, 8192), dtype=torch.uint16, device=card)
    pg = torch.zeros((8, 8192), device=card)
    sc = make_scalars(0, 100, 0, 0, 0, 255, 0, 0, 1, 0)
    with pytest.raises(ValueError):
        sm.split_mega(pb, pg, sc, num_bins=300, num_groups=4)
    with pytest.raises(ValueError):
        sm.split_mega_step(pb, pg, tpart.step_block(sc, card),
                           torch.zeros(1, dtype=torch.int32, device=card),
                           torch.zeros((4, 4 * 19, 16), device=card),
                           num_bins=300, num_groups=4, bound=100,
                           absmax=torch.ones(2, device=card))
    with pytest.raises(ValueError):
        fro.frontier_undo(pb, pg, None, bound=100)


def _wide_rows(n=6000, seed=4):
    """Three numerical columns and a 400-level categorical."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 3)
    c = rng.randint(0, 400, n).astype(float)
    y = (x[:, 0] + np.isin(c % 17, (1, 5, 9)) * 1.5
         + 0.3 * rng.randn(n) > 0.5).astype(float)
    return np.column_stack([x, c]), y


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["max_bin_1023", "cat400"])
def test_u16_graph_trees_equal_eager_oracle(card, case):
    """uint16 data through the graph (the subtraction body at K=1 on
    every uint16 arm): trees, sets and row order equal the eager oracle's
    on the card, bit for bit; one capture, one host read a tree."""
    X, y = _wide_rows()
    params = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
              "min_data_per_group": 20}
    if case == "max_bin_1023":
        params["max_bin"] = 1023
        X = X[:, :3]
    else:
        params["categorical_feature"] = "3"
    for a, b in _tl.lockstep(X, y, params, "cuda", trees=3):
        _tl.assert_same_tree(a, b)
        assert torch.equal(a._gbdt.learner.nodecat, b._gbdt.learner.nodecat)
    lr = a._gbdt.learner
    assert lr.bin_dtype == np.uint16 and lr.subtract and lr.K == 1
    assert lr.captures == 1 and lr.syncs == 3
    if case == "cat400":
        assert lr.W > 8 and sum(t.num_cat for t in a._gbdt.models) > 0


# ---- quantized training: the discretizer and the scale arms -------------
from lightgbm_tpu_torch.ops import quantize as qz  # noqa: E402


def _quant_payload(seed, n=(1 << 18) + 3, pad=4096):
    """A (8, n + 2 pad) payload: normal grads, positive hessians, a third
    of the rows zeroed (out of a bag), row ids permuted, pads with the
    sentinel n."""
    rng = np.random.RandomState(seed)
    Np = n + 2 * pad + (-(n + 2 * pad)) % 16
    ghi = torch.zeros((8, Np))
    g = rng.randn(n).astype(np.float32) * 2
    h = (rng.rand(n) + 0.05).astype(np.float32)
    off = rng.rand(n) < 0.3
    g[off], h[off] = 0.0, 0.0
    ghi[0, pad:pad + n] = torch.as_tensor(g)
    ghi[1, pad:pad + n] = torch.as_tensor(h)
    rowid = torch.full((Np,), n, dtype=torch.int32)
    rowid[pad:pad + n] = torch.as_tensor(rng.permutation(n).astype(np.int32))
    ghi[2] = rowid.view(torch.float32)
    return ghi, n


@pytest.mark.cuda
@pytest.mark.parametrize("renew", [False, True], ids=["plain", "renew"])
@pytest.mark.parametrize("by_rowid", [False, True], ids=["fused", "eager"])
@pytest.mark.parametrize("const_h", [False, True], ids=["hess", "const_h"])
@pytest.mark.parametrize("stoch", [True, False], ids=["stoch", "nearest"])
def test_quantize_kernel_bit_identical_to_plain(card, stoch, const_h,
                                                by_rowid, renew):
    """csrc/quantize.cu against quantize_plain: the payload words (the
    carriers, the true rows with the renewal) and the scale word."""
    ghi, N = _quant_payload(7)
    keys = jr.split(jr.fold_in(jr.PRNGKey(0), 3)) if stoch else None
    kw = dict(N=N, bins=4 if const_h else 6, const_h=const_h, keys=keys,
              by_rowid=by_rowid, renew_rows=(5, 6) if renew else None)
    out = []
    for dev in ("cpu", card):
        t = ghi.clone().to(dev)
        absmax = t[:2].abs().amax(dim=1)
        scale = torch.zeros(2, device=dev)
        qz.quantize(t, absmax, scale, **kw)
        out.append((t.cpu(), scale.cpu()))
    (a, sa), (b, sb) = out
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(sa.view(torch.int32), sb.view(torch.int32))
    assert torch.equal(a[:2], torch.trunc(a[:2])) and a[0].abs().max() > 1


def _int_carriers(G, n_pad, B, seed):
    rng = np.random.RandomState(seed)
    pb = torch.as_tensor(rng.randint(0, B, (G, n_pad)).astype(np.uint8))
    pg = torch.zeros((8, n_pad))
    pg[0] = torch.as_tensor(rng.randint(-3, 4, n_pad).astype(np.float32))
    pg[1] = torch.as_tensor(rng.randint(0, 5, n_pad).astype(np.float32))
    pg[2] = torch.arange(n_pad, dtype=torch.int32).view(torch.float32)
    return pb, pg, torch.tensor([0.0137, 0.00291])


@pytest.mark.cuda
@pytest.mark.parametrize("move", [False, True])
def test_split_mega_scale_arm_bit_identical_to_plain(card, move):
    G, B, n_pad = 28, 255, 1 << 18
    pb, pg, scale = _int_carriers(G, n_pad, B, 3)
    sc = make_scalars(4096 + 5, 200_001, 4, 0, 0, 255, 0, 0, 120, 1)
    absmax = pg[:2, 4101:4101 + 200_001].abs().amax(dim=1)
    want = sm.hist_fixed_plain(pb, pg, sc, num_bins=B, num_groups=G,
                               absmax=absmax, scale=scale)
    _, got = sm.split_mega(pb.to(card), pg.to(card), sc, num_bins=B,
                           num_groups=G, move=move, absmax=absmax.to(card),
                           scale=scale.to(card))
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    unscaled = sm.hist_fixed_plain(pb, pg, sc, num_bins=B, num_groups=G,
                                   absmax=absmax)
    assert not torch.equal(unscaled, want)


@pytest.mark.cuda
@pytest.mark.parametrize("state", [False, True], ids=["planes", "state"])
def test_leaf_hist_scale_arm_bit_identical_to_plain(card, state):
    G, B, n_pad = 28, 255, 1 << 18
    pb, pg, scale = _int_carriers(G, n_pad, B, 4)
    start, cnt = 4096 + 3, 150_000
    absmax = pg[:2].abs().amax(dim=1)
    kw = dict(num_bins=B, num_groups=G)
    if not state:
        want = th.leaf_hist_fixed_plain(pb, pg, start, cnt, planes=True,
                                        absmax=absmax, scale=scale, **kw)
        got = th.leaf_hist(pb.to(card), pg.to(card), start, cnt, planes=True,
                           absmax=absmax.to(card), scale=scale.to(card),
                           **kw)
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))
        return
    st = torch.zeros((4, 2, G, 256), dtype=torch.int64)
    # the root into slot 0, then a split of it: both children scaled,
    # the state's integer sums unscaled
    outs = []
    for dev in ("cpu", card):
        s = st.clone().to(dev)
        a = dict(absmax=absmax.to(dev), kcnt=cnt, scale=scale.to(dev), **kw)
        b, g = pb.to(dev), pg.to(dev)
        f = (hs.leaf_hist_rmw_fixed_plain if dev == "cpu"
             else hs.leaf_hist_rmw)
        f(b, g, start, cnt, state=s, idx=(-1, 0, 0, 0), **a)
        ch = f(b, g, start, 70_001, state=s, idx=(0, 0, 1, 1), **a)
        outs.append((ch.cpu(), s.cpu()))
    (wc, ws), (gc, gs) = outs
    assert torch.equal(gs, ws)
    assert torch.equal(gc.view(torch.int32), wc.view(torch.int32))


@pytest.mark.cuda
def test_feat_view_scale_arm_bit_identical_to_plain(card):
    view, state = _view_case(2)
    step = torch.zeros(tpart.STEP_WORDS, dtype=torch.int32)
    step[tpart.SB_CNT] = 1000
    step[tpart.SB_WA], step[tpart.SB_WB] = 3, 1
    absmax = torch.tensor([3.0, 4.0])
    scale = torch.tensor([0.0137, 0.00291])
    want = fv.feat_view_fixed_plain(state, step, absmax, 1 << 20, view,
                                    scale=scale)
    out = torch.zeros((2, 2, view.F, view.Bp), device=card)
    fv.feat_view(None, None, state.to(card), step.to(card), absmax.to(card),
                 kcnt=1 << 20, view=view.to(card), out=out,
                 scale=scale.to(card))
    assert torch.equal(out.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("renew", [False, True], ids=["plain", "renew"])
@pytest.mark.parametrize("case", ["mega", "mega_k4", "subtraction", "efb"])
def test_quantized_trees_on_the_card_equal_the_cpu(card, case, renew):
    """Quantized L2 training from a zero score (bagged): the gradients are
    f32 subtractions, the same bits on both devices, so the carriers are;
    the card's exact integer histograms and the CPU's f32 sums of them
    agree, so 4 trees equal the CPU's bit for bit.  With the leaf renewal
    (one tree: its f64 sums of the true gradients run in another order on
    each device), and on bundled data (the CPU rebuilds a bundled
    feature's default bin in f32 as JAX does, the card exactly), the
    trees equal the CPU's split for split and their leaf values agree
    within rtol 1e-6.  One capture, one host read a tree."""
    X, _ = _onehot()
    y = X[:, 0] * 2 + X[:, 1] ** 2 + 0.1 * X[:, 2]
    if case != "efb":
        X = X[:, :4]
    params = {"objective": "regression", "num_leaves": 15, "verbosity": -1,
              "use_quantized_grad": True, "boost_from_average": False,
              "quant_train_renew_leaf": renew, "bagging_fraction": 0.8,
              "bagging_freq": 1}
    params.update({"mega": {"tpu_frontier_k": 1},
                   "mega_k4": {"tpu_frontier_k": 4},
                   "subtraction": {"tpu_megakernel": "off"},
                   "efb": {}}[case])
    trees = 1 if renew else 4
    b = {}
    for dev in ("cpu", "cuda"):
        b[dev] = lgt.train(dict(params, device_type=dev),
                           lgt.Dataset(X, label=y), trees)
    for ta, tb in zip(b["cpu"]._gbdt.models, b["cuda"]._gbdt.models):
        for f in ("split_feature", "threshold_bin", "left_child",
                  "right_child", "leaf_count"):
            assert np.array_equal(getattr(ta, f), getattr(tb, f)), f
        if renew or case == "efb":
            np.testing.assert_allclose(tb.leaf_value, ta.leaf_value,
                                       rtol=1e-6)
        else:
            assert np.array_equal(tb.leaf_value, ta.leaf_value)
    lr = b["cuda"]._gbdt.learner
    assert lr.captures == 1 and lr.syncs == trees
    assert lr.K == (4 if case == "mega_k4" else 1)
    assert lr.bundled == (case == "efb")


# ---- monotone constraints: the search arms, the bookkeeping, the refresh --
from lightgbm_tpu_torch.ops import mono as tmono  # noqa: E402


def _mono_info(fm, info, C, seed, l2=1e-3):
    """Directions in FM_MONO (every third feature free) and, per child,
    bounds around its own output (none, below, above, both)."""
    rng = np.random.RandomState(seed)
    F = fm.shape[0] // C
    fm, info = fm.clone(), info.clone()
    mono = torch.as_tensor(rng.choice([-1, 1], F) * (np.arange(F) % 3 != 2),
                           dtype=torch.int32)
    fm[:, sp.FM_MONO] = mono.repeat(C)
    for c in range(C):
        r = slice(c * F, (c + 1) * F)
        out = float(-info[c * F, 0] / (info[c * F, 1] + l2))
        lo, hi = [(-np.inf, np.inf), (out - 0.05, np.inf),
                  (-np.inf, out + 0.05), (out - 0.1, out + 0.02)][c % 4]
        info[r, sp.IN_CMIN], info[r, sp.IN_CMAX] = lo, hi
    return fm, info


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(28, 255), (7, 31), (28, 1024), (5, 300)])
@pytest.mark.parametrize("penalty", [0.0, 2.0, 0.5])
@pytest.mark.parametrize("C", [2, 31])
@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_split_pair_monotone_arm_bit_identical_to_plain(card, shape,
                                                        penalty, C, pi):
    """split_pair's monotone arm (clipped outputs, directions, the penalty
    table; the register arm and the arm past 256 bins; a pair and the
    refresh's C children) against split_pair_plain on the CPU and on the
    card, all 13 fields bit for bit."""
    F, BF = shape
    hg, hh, fm, info = _pair_case(BF + C + pi, F, BF)
    reps = (C + 1) // 2
    hg, hh = hg.repeat(reps, 1)[:C * F], hh.repeat(reps, 1)[:C * F]
    fm, info = fm.repeat(reps, 1)[:C * F], info.repeat(reps, 1)[:C * F]
    info[:, 3] = torch.arange(C).repeat_interleave(F).float() % 6
    fm, info = _mono_info(fm, info, C, BF + pi)
    pen = sp.penalty_table(penalty, 31) if penalty > 0 else None
    kw = dict(PARAMS[pi], children=C, mono=True)
    want = sp.split_pair_plain(hg, hh, fm, info, pen=pen, **kw)
    dev = [t.to(card) for t in (hg, hh, fm, info)]
    dpen = None if pen is None else pen.to(card)
    got = sp.split_pair(*dev, pen=dpen, **kw)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    on_card = sp.split_pair_plain(*dev, pen=dpen, **kw)
    assert torch.equal(on_card.cpu().view(torch.int32),
                       want.view(torch.int32))


@pytest.mark.cuda
def test_split_pair_unconstrained_bits_untouched_by_the_info_bounds(card):
    """Without ``mono`` the kernel reads no bound or direction: the
    unconstrained rows are the same bits whatever IN_CMIN / IN_CMAX and
    FM_MONO hold."""
    hg, hh, fm, info = _pair_case(11)
    base = sp.split_pair(*(t.to(card) for t in (hg, hh, fm, info)),
                         **PARAMS[0])
    fm2, info2 = _mono_info(fm, info, 2, 3)
    again = sp.split_pair(*(t.to(card) for t in (hg, hh, fm2, info2)),
                          **PARAMS[0])
    assert torch.equal(base.view(torch.int32), again.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,C", [((10, 255), 2), ((6, 16), 2),
                                     ((10, 1024), 2), ((8, 255), 300)])
@pytest.mark.parametrize("ci", range(len(CAT_PARAMS)))
def test_split_cat_monotone_arm_bit_identical_to_plain(card, shape, C, ci):
    """split_cat's clamp arm (narrow and wide; 300 children: the merge's
    loop past a block of threads) against split_cat_plain on the CPU and
    on the card, rows and sets bit for bit."""
    F, BF = shape
    hg, hh, fm, info, cats = cat_case(F + BF + ci + C, F, BF, min(4, F),
                                      C=C if C % 2 == 0 else C + 1)
    fm, info = _mono_info(fm, info, C, F + ci)
    fm[:, sp.FM_MONO] = torch.where(fm[:, 3] == 1, 0, fm[:, sp.FM_MONO])
    kw = dict(PARAMS[0], **CAT_PARAMS[ci])
    W = tpart.cat_words(BF)
    pair = sp.split_pair_plain(hg, hh, fm, info, children=C, mono=True,
                               **PARAMS[0])
    want, wset = pair.clone(), torch.zeros((C, W), dtype=torch.int32)
    scat.split_cat(hg, hh, fm, info, cats, want, wset, children=C, mono=True,
                   **kw)
    dev = [t.to(card) for t in (hg, hh, fm, info, cats)]
    work = scat.new_work(C, len(cats), card, BF)
    for _ in range(2):
        got = pair.to(card)
        gset = torch.full((C, W), 7, dtype=torch.int32, device=card)
        scat.split_cat(*dev, got, gset, children=C, mono=True, work=work,
                       **kw)
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))
        assert torch.equal(gset.cpu(), wset)


def mono_tree_case(seed, L=9, F=5):
    """tree_case with directions in fmeta row 7, bounds and some
    categorical best splits in leafmat and (2, L + 1, F) bin boxes: the
    pending split on a monotone feature."""
    rng = np.random.RandomState(seed)
    c = _tl.tree_case(seed, L=L, F=F)
    lm, step, fmeta = c[0], c[2], c[5]
    fmeta[7] = torch.as_tensor(rng.choice([-1, 0, 1], F), dtype=torch.int32)
    L1 = L + 1
    lm[ts.LM_CMIN] = torch.as_tensor(np.where(
        rng.rand(L1) < 0.5, -np.inf, rng.randn(L1) - 2).astype(np.float32))
    lm[ts.LM_CMAX] = torch.as_tensor(np.where(
        rng.rand(L1) < 0.5, np.inf, rng.randn(L1) + 2).astype(np.float32))
    lm[ts.LM_BISCAT] = torch.as_tensor((rng.rand(L1) < 0.2)
                                       .astype(np.float32))
    leaf = int(step[tpart.SB_LEAF])
    fe = int(lm[ts.LM_BFEAT, leaf:leaf + 1].view(torch.int32))
    fmeta[7, fe] = int(rng.choice([-1, 1]))
    nb = fmeta[4].numpy()
    lo = rng.randint(0, 3, (L1, F))
    hi = np.maximum(lo, nb[None, :] - 1 - rng.randint(0, 3, (L1, F)))
    thr = int(rng.randint(lo[leaf, fe], hi[leaf, fe] + 1))
    lm[ts.LM_BTHR, leaf] = torch.tensor([thr], dtype=torch.int32).view(
        torch.float32)[0]
    return c, torch.as_tensor(np.stack([lo, hi]).astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["root", "step", "commit", "elect"])
@pytest.mark.parametrize("seed", range(4))
def test_tree_step_kernel_monotone_bounds_and_boxes(card, mode, seed):
    """tree_step with directions, leaf bounds and bin boxes: the root's
    reset, a step, and intermediate's commit and election launches,
    against tree_step_plain bit for bit (boxes included)."""
    c, boxes = mono_tree_case(seed)
    m = {"root": ts.MODE_ROOT, "step": ts.MODE_STEP,
         "commit": ts.MODE_COMMIT, "elect": ts.MODE_ELECT}[mode]
    kw = dict(row0=_tl.ROW0, N=_tl.N)
    if mode == "elect":       # after a commit: nothing due
        ts.tree_step_plain(ts.MODE_COMMIT, *c, boxes=boxes, **kw)
    dev = [t.to(card) for t in c]
    dbox = boxes.to(card)
    ts.tree_step(m, *dev, boxes=dbox, **kw)
    ts.tree_step_plain(m, *c, boxes=boxes, **kw)
    for got, want in zip(dev + [dbox], c + [boxes]):
        assert torch.equal(_tl._bits(got.cpu()), _tl._bits(want))


def _refresh_case(seed, L=31, F=6, live=None):
    """A leafmat of ``live`` leaves grown by random numerical splits
    (their boxes), outputs mostly along the directions, some bounds."""
    rng = np.random.RandomState(seed)
    live = live or int(rng.randint(2, L + 1))
    nb = rng.randint(4, 60, F)
    lo = np.zeros((L + 1, F), np.int32)
    hi = np.tile(nb - 1, (L + 1, 1)).astype(np.int32)
    for new in range(1, live):
        leaf = int(rng.randint(new))
        cand = [f for f in range(F) if hi[leaf, f] > lo[leaf, f]]
        f = int(rng.choice(cand))
        t = int(rng.randint(lo[leaf, f], hi[leaf, f]))
        lo[new], hi[new] = lo[leaf], hi[leaf]
        hi[leaf, f], lo[new, f] = t, t + 1
    fmeta = np.zeros((ts.FMETA_ROWS, F), np.int32)
    fmeta[4] = nb
    fmeta[7] = rng.choice([-1, 0, 1], F)
    lm = ts.empty_leafmat(L)
    for leaf in range(live):
        lm[:, leaf] = ts.leaf_column(
            0, 100, int(rng.randint(10, 900)), rng.randn(),
            abs(rng.randn()) + 1, int(rng.randint(1, 9)), 0.0, -1, 0,
            rng.randn(13).astype(np.float32))
    lm[ts.LM_VALUE, :live] = ((lo[:live] + hi[:live]) * fmeta[7] / nb).sum(1) \
        + 0.1 * rng.randn(live)
    lm[ts.LM_CMIN, :live:3] = -0.5
    step = torch.zeros(tpart.step_len(8), dtype=torch.int32)
    step[tpart.SB_S] = live - 1
    return [torch.as_tensor(a) for a in (lm, np.stack([lo, hi]), fmeta)] + [
        step, torch.as_tensor((rng.rand(F) > 0.2).astype(np.float32))]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(6))
def test_mono_refresh_kernel_bit_identical_to_plain(card, seed):
    """mono_refresh against mono_refresh_plain (CPU and card): leafmat
    (every bound), the changed flags and the info rows bit for bit; a
    stopped tree's launch writes nothing but zero flags."""
    L, F = 31, 6
    lm, boxes, fmeta, step, fmask = _refresh_case(seed, L, F,
                                                  live=31 if seed == 0 else None)
    outs = [torch.zeros(L, dtype=torch.int32), torch.zeros((L * F, 8))]
    dev = [t.to(card) for t in (lm, boxes, fmeta, step, fmask)]
    douts = [t.to(card) for t in outs]
    tmono.mono_refresh(*dev, *douts)
    tmono.mono_refresh_plain(lm, boxes, fmeta, step, fmask, *outs)
    assert outs[0].any()
    for got, want in zip([dev[0]] + douts, [lm] + outs):
        assert torch.equal(_tl._bits(got.cpu()), _tl._bits(want))
    on_card = [t.to(card) for t in (lm, boxes, fmeta, step, fmask)]
    tmono.mono_refresh_plain(*on_card, *[t.to(card) for t in outs])
    dev[3][tpart.SB_DONE] = 1
    before = dev[0].clone()
    douts[1].fill_(3.0)
    tmono.mono_refresh(*dev, *douts)
    assert torch.equal(dev[0].view(torch.int32), before.view(torch.int32))
    assert not douts[0].any() and bool((douts[1] == 3.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bundled", [False, True])
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("Bp", [48, 512])
def test_mono_planes_kernel_bit_identical_to_plain(card, bundled, scaled,
                                                   Bp):
    """mono_planes against mono_planes_fixed_plain: the changed leaves'
    planes from the int64 state, unbundled (group rows) or through the
    EFB view, with and without the quantized scale, bit for bit."""
    view, state = _view_case(3, Bp=Bp, slots=12)
    L = state.shape[0]
    F = view.F if bundled else state.shape[2]
    rng = np.random.RandomState(Bp + bundled)
    changed = torch.as_tensor((rng.rand(L) < 0.6).astype(np.int32))
    absmax = torch.tensor([3.0, 1.5])
    scale = torch.tensor([0.25, 0.125]) if scaled else None
    v = view if bundled else None
    want = tmono.mono_planes_fixed_plain(state, changed, absmax, kcnt=5000,
                                         view=v, scale=scale)
    out = torch.full((2, L, F, Bp), 9.0, device=card)
    tmono.mono_planes(state.to(card), changed.to(card), absmax.to(card),
                      None, kcnt=5000, out=out,
                      view=v.to(card) if v is not None else None,
                      scale=None if scale is None else scale.to(card))
    keep = changed.bool()
    assert torch.equal(out.cpu()[:, keep].view(torch.int32),
                       want[:, keep].view(torch.int32))
    assert bool((out.cpu()[:, ~keep] == 9.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("with_sets", [False, True])
def test_mono_overlay_kernel_bit_identical_to_plain(card, with_sets):
    L, W = 31, 8
    rng = np.random.RandomState(with_sets)
    lm = torch.as_tensor(ts.empty_leafmat(L))
    leafcat = torch.as_tensor(rng.randint(-9, 9, (L + 1, W)).astype(np.int32))
    changed = torch.as_tensor((rng.rand(L) < 0.5).astype(np.int32))
    rows = torch.as_tensor(rng.randn(L, 13).astype(np.float32))
    cats = (torch.as_tensor(rng.randint(-9, 9, (L, W)).astype(np.int32))
            if with_sets else None)
    dev = [t.to(card) for t in (lm, leafcat, changed, rows)]
    tmono.mono_overlay(*dev, None if cats is None else cats.to(card))
    tmono.mono_overlay_plain(lm, leafcat, changed, rows, cats)
    for got, want in zip(dev[:2], (lm, leafcat)):
        assert torch.equal(_tl._bits(got.cpu()), _tl._bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["basic", "intermediate"])
def test_monotone_graph_trees_on_the_card(card, method):
    """Intermediate and basic constraints through the graph loop on the
    card: one capture, one tree read a tree, the refresh's kernels
    launched (intermediate), and the model monotone along each
    constrained feature."""
    rng = np.random.RandomState(0)
    X = rng.randn(6000, 6)
    y = X[:, 0] - X[:, 1] + 0.5 * X[:, 2] ** 2 + 0.2 * rng.randn(6000)
    mc = [1, -1, 0, 1, 0, 0]
    for k in tmono.launches:
        tmono.launches[k] = 0
    b = lgt.train({"objective": "regression", "num_leaves": 31,
                   "verbosity": -1, "monotone_constraints": mc,
                   "monotone_constraints_method": method,
                   "monotone_penalty": 1.0}, lgt.Dataset(X, label=y), 4)
    lr = b._gbdt.learner
    assert lr.captures == 1 and lr.syncs == 4 and lr.subtract
    assert (tmono.launches["mono_refresh"] == 2 * (lr.L - 2)) == (
        method == "intermediate")
    base = X[:100]
    for f, s in enumerate(mc):
        if not s:
            continue
        grid = np.linspace(-3, 3, 41)
        Z = np.repeat(base, len(grid), axis=0)
        Z[:, f] = np.tile(grid, len(base))
        p = b.predict(Z, raw_score=True).reshape(len(base), len(grid))
        assert (np.diff(p, axis=1) * s).min() >= -1e-6


# ---- ranking: the lambdas in plain PyTorch on the card ---------------------
def _rank_metadata(sizes, seed=0):
    from lightgbm_tpu_torch.dataset import Metadata
    rng = np.random.RandomState(seed)
    n = int(np.sum(sizes))
    md = Metadata(n)
    label = rng.randint(0, 5, n).astype(np.float64)
    label[rng.rand(n) < 0.6] = 0
    md.set_label(label)
    md.set_group(sizes)
    md.set_position(rng.randint(0, 8, n))
    return md


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["lambdarank", "lambdarank_positions",
                                       "rank_xendcg"])
def test_rank_gradients_on_the_card_equal_the_cpu(card, objective,
                                                  monkeypatch):
    """The ranking objectives' gradients from the same scores on the card
    and on the CPU, three calls in a row (XE-NDCG's draws, the position
    biases), within the CPU tests' bar against the JAX package (rtol 1e-5
    / atol 1e-6): queries of 1 to 70 documents and three past 1,024 (a
    2,048-wide bucket), the budget cut so that the 2,048-wide bucket runs
    in chunks of one query on both."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.models import objective as tobj
    monkeypatch.setattr(tobj, "PAIR_BUDGET",
                        tobj.PAIR_TEMPS * 2048 * 2048 * 4)
    sizes = np.concatenate([np.random.RandomState(1).permutation(
        np.arange(1, 71)), [1100, 1500, 2048]])
    md = _rank_metadata(sizes)
    if objective != "lambdarank_positions":
        md.set_position(None)
    params = {"objective": objective.split("_positions")[0],
              "lambdarank_position_bias_regularization": 0.1}
    objs = []
    for dev in ("cpu", card):
        o = tobj.create_objective(Config(params))
        o.init(md, dev)
        objs.append(o)
    if objective != "rank_xendcg":
        big = [b for b in objs[1].buckets if b.P == 2048][0]
        assert len(big.chunks) == 3
    rng = np.random.RandomState(2)
    for it in range(3):
        s = (rng.randn(md.num_data).astype(np.float32) if it
             else np.zeros(md.num_data, np.float32))
        want = objs[0].get_gradients(torch.as_tensor(s))
        got = objs[1].get_gradients(torch.as_tensor(s, device=card))
        for a, b in zip(got, want):
            assert a.device == torch.device(card)
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       rtol=1e-5, atol=1e-6)
    if objective == "lambdarank_positions":
        np.testing.assert_allclose(objs[1].pos_biases.cpu().numpy(),
                                   objs[0].pos_biases.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("body", [{}, {"tpu_megakernel": "off"}])
def test_rank_graph_trees_on_the_card(card, body):
    """lambdarank through the graph loop on the card on both bodies (the
    mega path at the auto K = 4): one capture, one tree read a tree, and
    the training NDCG@10 rising; ndcg@10 equal to its evaluation on the
    CPU from the card's scores."""
    from lightgbm_tpu_torch.models.metric import NDCGMetric
    from lightgbm_tpu_torch.config import Config
    rng = np.random.RandomState(0)
    sizes = rng.randint(5, 60, 200)
    n = int(sizes.sum())
    X = rng.randn(n, 12)
    y = np.clip(np.round(X[:, 0] + 0.5 * X[:, 1] + rng.randn(n)), 0, 4)
    ev = {}
    b = lgt.train(dict({"objective": "lambdarank", "num_leaves": 31,
                        "verbosity": -1, "metric": "ndcg", "eval_at": 10},
                       **body), lgt.Dataset(X, label=y, group=sizes), 5,
                  valid_sets=[lgt.Dataset(X, label=y, group=sizes)],
                  valid_names=["v"], callbacks=[lgt.record_evaluation(ev)])
    lr = b._gbdt.learner
    assert lr.captures == 1 and lr.syncs == 5
    assert lr.subtract == bool(body) and lr.K == (1 if body else 4)
    hist = ev["v"]["ndcg@10"]
    assert hist[-1] > hist[0]
    m = NDCGMetric(Config({"eval_at": 10}))
    m.init(b._gbdt.train_data.metadata, "cpu")
    (_, v), = m.eval(b._gbdt.scores.cpu(), None)
    w = {k: x for k, x, _ in b._gbdt.eval_train()}["ndcg@10"]
    assert abs(v - w) <= 1e-6


def _walk_case(kind):
    """(X, y, Dataset kwargs, params) of binary.train with bundles, a
    categorical feature or uint16 bins (``kind`` uint8: as it is)."""
    import os
    d = np.loadtxt(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "binary_classification",
        "binary.train"))
    X, y = d[:, 1:], d[:, 0]
    rng = np.random.RandomState(0)
    if kind == "efb":
        return np.hstack([X, np.eye(6)[rng.randint(0, 6, len(y))]]), y, {}, {}
    if kind == "categorical":
        X = np.column_stack([X, rng.randint(0, 9, len(y))])
        return X, y, {"categorical_feature": [X.shape[1] - 1]}, {}
    return X, y, {}, {"max_bin": 1023} if kind == "uint16" else {}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uint8", "uint16", "efb", "categorical"])
def test_train_walk_on_the_card_equals_the_cpu(card, kind):
    """The walk of every past tree over the card's live physical bin
    matrix (models/boosting.py ``_tree_to_scores``) finds the leaves the
    CPU's walk of a copy of the same matrix finds, and its score update
    (-1, then a DART factor) is bit-identical to the CPU's."""
    from lightgbm_tpu_torch.ops.predict import predict_leaf_binned_t
    X, y, ds_kw, extra = _walk_case(kind)
    b = lgt.train(dict({"objective": "binary", "num_leaves": 15,
                        "verbosity": -1}, **extra),
                  lgt.Dataset(X, label=y, **ds_kw), 4)
    g = b._gbdt
    lr = g.learner
    assert {"uint8": lr.K == 4, "uint16": lr.bin_dtype == np.uint16,
            "efb": lr.bundled, "categorical": lr.has_cat}[kind]
    pb, ghi = g._phys
    C, N = lr.row0, g.num_data
    bins_cpu = pb[:, C:C + N].cpu()
    for t, dt in enumerate(g.device_trees):
        leaf = predict_leaf_binned_t(pb[:, C:C + N], dt["node"])
        want = predict_leaf_binned_t(bins_cpu, dt["node"])
        assert torch.equal(leaf.cpu(), want)
        score_cpu = ghi[3, C:C + N].cpu()
        for f in (-1.0, 0.6666666666666666):
            g._tree_to_scores(t, f, valid=False)
            score_cpu += (dt["delta"].cpu() * f)[want]
            assert torch.equal(ghi[3, C:C + N].cpu().view(torch.int32),
                               score_cpu.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("body", [{}, {"tpu_megakernel": "off"}])
def test_dart_on_the_card_equals_the_cpu(card, body):
    """5 DART iterations on binary.train (15 leaves, drop_rate 0.5,
    skip_drop 0) on the card and on the CPU: the same drops, the same
    trees (the card's exact histograms and the CPU's f32 ones meet no
    tie there), leaf values within rtol 1e-4 / atol 1e-5, raw predictions
    within atol 1e-5."""
    X, y, _, _ = _walk_case("uint8")
    p = dict({"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0},
             **body)
    out = []
    for kw in ({}, {"device_type": "cpu"}):
        b = lgt.Booster(dict(p, **kw), lgt.Dataset(X, label=y))
        drops = []
        for _ in range(5):
            b.update()
            drops.append(list(b._gbdt.last_drops))
        out.append((b, drops))
    (bc, dc), (bh, dh) = out
    assert dc == dh and sum(map(len, dc)) > 0
    for a, t in zip(bc._gbdt.models, bh._gbdt.models):
        assert a.split_feature.tolist() == t.split_feature.tolist()
        assert a.threshold_bin.tolist() == t.threshold_bin.tolist()
        np.testing.assert_allclose(a.leaf_value, t.leaf_value, rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(bc.predict(X, raw_score=True),
                               bh.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)


def _linear_tree_case(seed=0, n=6000, F=6, L=31, nan=True):
    """A finished linear tree of ``L`` leaves on the CPU (regression on a
    label with a linear part, NaNs in two columns) and the inputs of its
    fit: raw rows, row ids, leaf ranges, true gradients, path features."""
    from lightgbm_tpu_torch.models import linear as linmod
    from lightgbm_tpu_torch.ops.partition import SB_S
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    if nan:
        X[rng.rand(n) < 0.05, 1] = np.nan
        X[rng.rand(n) < 0.02, 3] = np.nan
    y = X[:, 0] * 2 - np.nan_to_num(X[:, 1]) + np.sin(X[:, 2]) \
        + 0.1 * rng.normal(size=n)
    b = lgt.train({"objective": "regression", "num_leaves": L,
                   "linear_tree": True, "device_type": "cpu",
                   "verbosity": -1}, lgt.Dataset(X, label=y), 2)
    g, lr = b._gbdt, b._gbdt.learner
    pb, ghi = g._phys
    C, N = lr.row0, g.num_data
    start, cnt = linmod.leaf_ranges(lr.leafmat, C, N)
    D = linmod.width(F, L, -1)
    feat, ok = linmod.path_features(lr.leafmat, lr.nodemat,
                                    lr.steps[0, SB_S], F, D)
    rowid = ghi[2, C:C + N].view(torch.int32).long()
    return dict(raw=g._raw, rowid=rowid,
                rawp=linmod.physical_rows(g._raw, rowid), start=start,
                cnt=cnt,
                g=ghi[0, C:C + N].clone(), h=ghi[1, C:C + N].clone(),
                feat=feat, ok=ok, value=lr.leafmat[ts.LM_VALUE, :L].clone(),
                lm=lr.leafmat.clone(), nm=lr.nodemat.clone(),
                s=lr.steps[0, SB_S].clone(), F=F, D=D)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_linear_fit_on_the_card_equals_the_cpu(card, seed):
    """models/linear.py on the card against the same functions on the
    CPU: the path features and the physical raw rows equal, the batched
    leaf fit's statuses and active columns equal, its constants and
    coefficients within rtol 1e-9 (f64, other summation orders), the
    linear score update (by pieces, and by rows and leaves) within 1e-9
    before its cast to f32."""
    from lightgbm_tpu_torch.models import linear as linmod
    c = _linear_tree_case(seed)
    dc = {k: (v.to(card) if isinstance(v, torch.Tensor) else v)
          for k, v in c.items()}
    feat, ok = linmod.path_features(dc["lm"], dc["nm"], dc["s"], c["F"],
                                    c["D"])
    assert torch.equal(feat.cpu(), c["feat"]) and torch.equal(ok.cpu(),
                                                              c["ok"])
    kw = dict(lam=0.25, shrinkage=0.1)
    want = linmod.fit_leaves(c["rawp"], c["start"], c["cnt"], c["g"],
                             c["h"], c["feat"], c["ok"], c["value"], **kw)
    rawp = linmod.physical_rows(dc["raw"], dc["rowid"])
    assert torch.equal(rawp.cpu().view(torch.int32),
                       c["rawp"].view(torch.int32))
    got = linmod.fit_leaves(rawp, dc["start"], dc["cnt"], dc["g"], dc["h"],
                            feat, ok, dc["value"], **kw)
    assert torch.equal(got.status.cpu(), want.status)
    assert torch.equal(got.active.cpu(), want.active)
    assert int((want.status == linmod.LIN_OK).sum()) > 10
    np.testing.assert_allclose(got.const.cpu().numpy(), want.const.numpy(),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.coeff.cpu().numpy(), want.coeff.numpy(),
                               rtol=1e-9, atol=1e-12)
    N = len(c["rowid"])
    order = torch.argsort(c["start"], stable=True)
    leaf = torch.repeat_interleave(order, c["cnt"][order])
    out_cpu = linmod.linear_output(c["raw"], leaf, want, rows=c["rowid"])
    out = linmod.linear_output(dc["raw"], leaf.to(card), got,
                               rows=dc["rowid"], chunk=1000)
    tiles = linmod.tile_output(rawp, dc["start"], dc["cnt"], got, N)
    assert torch.isnan(c["raw"]).any()
    for o in (out, tiles):
        np.testing.assert_allclose(o.cpu().numpy(), out_cpu.numpy(),
                                   rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
def test_linear_search_on_the_card_equals_the_cpu(card):
    """ops/split_linear.py on the card against the CPU on split_pair's
    seeded pair cases with representative values: the (2, 13) rows and
    the own models bit for bit (the same blocked f64 prefix sums, the
    same f64 and f32 operations)."""
    from lightgbm_tpu_torch.ops.split_linear import (linear_static,
                                                     split_linear)
    for seed in range(4):
        hg, hh, fm, info = _pair_case(seed, F=28, BF=255)
        rng = np.random.RandomState(seed)
        rep = torch.as_tensor(rng.uniform(-2, 2, (28, 256)).astype(
            np.float32))
        fid = torch.arange(28) * 2
        kw = dict(l2=1e-3, min_gain_to_split=0.0, min_data_in_leaf=5,
                  min_sum_hessian=1e-3, max_depth=0, lam=0.5)
        meta = [fm[:28, i] for i in range(3)]
        want = split_linear(hg, hh, info,
                            linear_static(*meta, rep, fid, 255), **kw)
        got = split_linear(hg.to(card), hh.to(card), info.to(card),
                           linear_static(*(m.to(card) for m in meta),
                                         rep.to(card), fid, 255), **kw)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu().view(torch.int32),
                               b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["refit", "leafwise_gain"])
@pytest.mark.parametrize("body", [{}, {"tpu_megakernel": "off"}])
def test_linear_trees_on_the_card(card, mode, body):
    """Linear trees through the graph loop on the card, quantized
    (integer carriers, exact on both): the trees equal the CPU's, one
    host read a tree and one capture; the constants within rtol 1e-6 for
    refit (f64 fits of the same true gradients) and the coefficients
    within the leaf bar (rtol 1e-4 / atol 1e-5: a near-collinear leaf's
    system, conditioned by the 1e-10 ridge alone, carries the two
    devices' summation orders into its slopes), and all of them within
    the leaf bar for leafwise_gain, whose own models read
    the histograms through ``var``'s cancellation (the CPU's larger
    children are f32 differences of scaled sums, the card's exact); the
    train scores equal the raw predictions (atol 1e-5), and a saved model
    reloads and predicts bit for bit."""
    X, y, _, _ = _walk_case("uint8")
    p = dict({"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "linear_tree": True, "linear_tree_mode": mode,
              "use_quantized_grad": True}, **body)
    bc = lgt.train(p, lgt.Dataset(X, label=y), 4)
    bh = lgt.train(dict(p, device_type="cpu"), lgt.Dataset(X, label=y), 4)
    lr = bc._gbdt.learner
    assert lr.captures == 1 and lr.syncs == 4
    assert lr.linear_gain == (mode == "leafwise_gain")
    for a, t in zip(bc._gbdt.models, bh._gbdt.models):
        assert a.split_feature.tolist() == t.split_feature.tolist()
        assert a.threshold_bin.tolist() == t.threshold_bin.tolist()
        assert a.leaf_features == t.leaf_features
        rtol, atol = (1e-6, 1e-9) if mode == "refit" else (1e-4, 1e-5)
        np.testing.assert_allclose(a.leaf_const, t.leaf_const, rtol=rtol,
                                   atol=atol)
        for ca, ct in zip(a.leaf_coeff, t.leaf_coeff):
            np.testing.assert_allclose(ca, ct, rtol=1e-4, atol=1e-5)
    raw = bc.predict(X, raw_score=True)
    np.testing.assert_allclose(bc._gbdt.scores.cpu().numpy(), raw, rtol=0,
                               atol=1e-5)
    again = lgt.Booster(model_str=bc.model_to_string())
    np.testing.assert_array_equal(again.predict(X, raw_score=True), raw)
