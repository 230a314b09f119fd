"""The port's histogram-state read-modify-write
(lightgbm_tpu_torch/ops/hist_state.py) against the JAX kernel
``hist_rmw_pallas`` run in the Pallas interpreter.

The two keep different layouts: the port's (slots, 2, G, Bp) state
against the JAX kernel's lane-flattened (slots, 8, WL) one
(``flat_geometry``).  The test converts between them (zero padding, as
the JAX learner's ``_flatten_hist`` pads) and requires the state after
the update and both children to be bit-identical: one f32 subtraction
per element in both.  The card's int64 state (``hist_rmw_fixed_plain``)
is held to the same JAX kernel on integer-valued states, where f32 and
int64 differences are both exact.

The fused entry ``leaf_hist_rmw`` is held to its parts: on the CPU to
``leaf_hist_plain`` + ``hist_rmw_plain``; the card's arithmetic
(``leaf_hist_rmw_fixed_plain``) to the invariant the int64 state buys --
after any chain of splits, every leaf's slot equals the direct
fixed-point sums of its own rows at the tree's scale, bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu.ops.hist_state_pallas import flat_geometry, hist_rmw_pallas
from lightgbm_tpu_torch.ops import hist_state as hs
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops.partition import make_scalars, partition_leaf

SLOTS = 6


def _to_flat(x, G, B):
    """(..., 2, G, Bp) port planes -> (..., 8, WL) JAX slots."""
    Gf, Bf, WL = flat_geometry(G, B)
    lead = x.shape[:-3]
    pad = [(0, 0)] * len(lead) + [(0, 0), (0, Gf - G), (0, Bf - x.shape[-1])]
    return np.pad(x, pad).reshape(*lead, 8, WL)


def _from_flat(x, G, Bp, B):
    Gf, Bf, _ = flat_geometry(G, B)
    return x.reshape(*x.shape[:-2], 2, Gf, Bf)[..., :G, :Bp]


@pytest.mark.parametrize("G,B", [(28, 255), (5, 60)])
@pytest.mark.parametrize("idx", [(2, 2, 4, 1), (2, 2, 4, 0), (0, 5, 5, 1),
                                 (3, 5, 5, 0)],
                         ids=["small_left", "small_right", "trash_wa_eq_wb",
                              "trash_small_right"])
def test_hist_rmw_plain_matches_pallas_interpreted(G, B, idx):
    rng = np.random.RandomState(sum(idx) + G)
    state = hs.new_state(SLOTS, G, B, "cpu")
    Bp = state.shape[-1]
    state[..., :B] = torch.as_tensor(
        rng.randn(SLOTS, 2, G, B).astype(np.float32) * 100)
    small = torch.zeros((2, G, Bp))
    small[..., :B] = torch.as_tensor(rng.randn(2, G, B).astype(np.float32))
    jstate, jl, jr = hist_rmw_pallas(
        jnp.asarray(_to_flat(state.numpy(), G, B)),
        jnp.asarray(_to_flat(small.numpy(), G, B)),
        jnp.asarray(idx, jnp.int32), interpret=True)
    children = hs.hist_rmw(state, small, idx)
    assert tuple(children.shape) == (2, 2, G, Bp)

    def bits(a):
        return np.ascontiguousarray(a).view(np.int32)

    np.testing.assert_array_equal(
        bits(_from_flat(np.asarray(jstate), G, Bp, B)), bits(state.numpy()))
    np.testing.assert_array_equal(bits(_from_flat(np.asarray(jl), G, Bp, B)),
                                  bits(children[:, 0].numpy()))
    np.testing.assert_array_equal(bits(_from_flat(np.asarray(jr), G, Bp, B)),
                                  bits(children[:, 1].numpy()))


def test_hist_rmw_contract():
    """large = parent - small; left to wa, then right to wb; the children
    are the pair search's (2G, Bp) inputs, left rows first; other slots
    untouched."""
    rng = np.random.RandomState(1)
    G, B = 4, 32
    state = hs.new_state(SLOTS, G, B, "cpu")
    state[:] = torch.as_tensor(rng.randn(*state.shape).astype(np.float32))
    before = state.clone()
    small = torch.as_tensor(rng.randn(2, G, 32).astype(np.float32))
    ch = hs.hist_rmw(state, small, (1, 1, 3, 0))
    large = before[1] - small
    assert torch.equal(state[1], large) and torch.equal(state[3], small)
    for s in (0, 2, 4, 5):
        assert torch.equal(state[s], before[s])
    hg = ch[0].reshape(2 * G, -1)
    assert torch.equal(hg[:G], large[0]) and torch.equal(hg[G:], small[0])
    assert torch.equal(ch[1].reshape(2 * G, -1)[G:], small[1])


def test_hist_rmw_dispatches_cpu_to_plain_version():
    before = hs.launches
    state = hs.new_state(3, 2, 16, "cpu")
    hs.hist_rmw(state, torch.zeros((2, 2, 16)), (0, 0, 1, 1))
    assert hs.launches == before


# ---- the card's int64 state: hist_rmw_fixed_plain and leaf_hist_rmw ----


@pytest.mark.parametrize("G,B", [(28, 255), (5, 60)])
@pytest.mark.parametrize("idx", [(2, 2, 4, 1), (2, 2, 4, 0), (0, 5, 5, 1),
                                 (3, 5, 5, 0)],
                         ids=["small_left", "small_right", "trash_wa_eq_wb",
                              "trash_small_right"])
def test_hist_rmw_fixed_plain_matches_pallas_interpreted(G, B, idx):
    """On integer states below 2^23 in magnitude, f32 (the JAX kernel) and
    int64 (the card's state) compute the same exact differences, so the
    int64 slots and the f32 children (each plane scaled by its 2^-k) are
    bit-identical to the JAX kernel's."""
    rng = np.random.RandomState(7 * sum(idx) + G)
    Bp = hs.new_state(1, G, B, "cpu").shape[-1]
    state = torch.zeros((SLOTS, 2, G, Bp), dtype=torch.int64)
    state[..., :B] = torch.as_tensor(
        rng.randint(-(1 << 22), 1 << 22, (SLOTS, 2, G, B)))
    small = torch.zeros((2, G, Bp), dtype=torch.int64)
    small[..., :B] = torch.as_tensor(rng.randint(-(1 << 22), 1 << 22,
                                                 (2, G, B)))
    inv = torch.tensor([2.0 ** -30, 2.0 ** -7], dtype=torch.float64)
    jstate, jl, jr = hist_rmw_pallas(
        jnp.asarray(_to_flat(state.float().numpy(), G, B)),
        jnp.asarray(_to_flat(small.float().numpy(), G, B)),
        jnp.asarray(idx, jnp.int32), interpret=True)
    children = hs.hist_rmw_fixed_plain(state, small, idx, inv)
    assert children.dtype == torch.float32
    assert tuple(children.shape) == (2, 2, G, Bp)
    np.testing.assert_array_equal(
        _from_flat(np.asarray(jstate), G, Bp, B).astype(np.int64),
        state.numpy())
    scale = inv.float().numpy()[:, None, None]
    for c, j in ((0, jl), (1, jr)):
        want = _from_flat(np.asarray(j), G, Bp, B) * scale
        np.testing.assert_array_equal(
            np.ascontiguousarray(want).view(np.int32),
            children[:, c].numpy().view(np.int32))


def test_hist_rmw_plain_root_has_no_parent():
    """parent < 0: slot wa gets the histogram and both children are it,
    in either dtype; no other slot is touched."""
    for dtype in (torch.float32, torch.int64):
        state = torch.arange(4 * 2 * 3 * 16).reshape(4, 2, 3, 16).to(dtype)
        before = state.clone()
        small = (torch.arange(2 * 3 * 16).reshape(2, 3, 16) * 3).to(dtype)
        ch = hs.hist_rmw_plain(state, small, (-1, 2, 3, 0))
        assert torch.equal(state[2], small)
        assert torch.equal(ch[:, 0], small) and torch.equal(ch[:, 1], small)
        for s in (0, 1, 3):
            assert torch.equal(state[s], before[s])


def test_new_state_is_f32_on_the_cpu_and_int64_elsewhere():
    assert hs.new_state(3, 4, 60, "cpu").dtype == torch.float32
    st = hs.new_state(3, 4, 60, "meta")
    assert st.dtype == torch.int64 and tuple(st.shape) == (3, 2, 4, 64)


def test_hist_rmw_alone_raises_off_the_cpu():
    """Off the CPU the update exists only fused into leaf_hist_rmw; there
    is no fallback to the plain version."""
    state = torch.zeros((3, 2, 2, 16), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="leaf_hist_rmw"):
        hs.hist_rmw(state, torch.zeros((2, 2, 16), dtype=torch.int64,
                                       device="meta"), (0, 0, 1, 1))


# the learner's shape of the fused call, at a small size
C, R, G, B = 256, 32, 28, 255
NP = 8 * C
KCNT = NP                 # the tree's root count: above every leaf's


def _buffers(seed):
    rng = np.random.RandomState(seed)
    pb = torch.as_tensor(rng.randint(0, B, (R, NP)).astype(np.uint8))
    pg = torch.as_tensor(rng.randn(8, NP).astype(np.float32))
    pg[1] = pg[1].abs()
    return rng, pb, pg


def _split(pb, pg, state, start, cnt, col, thr, small_side, idx, absmax):
    """Partition the leaf, then the fused update of its smaller child on
    the int64 state; returns the left count and the children."""
    nl = partition_leaf(pb, pg, make_scalars(start, cnt, col, 0, 0, B, 0, 0,
                                             thr, 0))
    ch = hs.leaf_hist_rmw_fixed_plain(pb, pg, start, cnt, num_bins=B,
                                      num_groups=G, state=state, idx=idx,
                                      absmax=absmax, kcnt=KCNT,
                                      child=(nl, small_side))
    return nl, ch


def _direct(pb, pg, start, cnt, child, absmax):
    kw = dict(num_bins=B, num_groups=G, child=child, absmax=absmax,
              kcnt=KCNT)
    return (th.leaf_hist_fixed_sums(pb, pg, start, cnt, **kw)[0],
            th.leaf_hist_fixed_plain(pb, pg, start, cnt, planes=True, **kw))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("small_side", [0, 1])
def test_larger_child_exact_after_subtraction(seed, small_side):
    """The invariant the int64 state buys: after the root's launch and a
    split, parent minus the smaller child's sums equals the direct
    fixed-point sums of the larger child's own rows at the tree's scale,
    bit for bit, and both f32 children equal leaf_hist_fixed_plain of
    each child's rows at that scale."""
    rng, pb, pg = _buffers(seed)
    absmax = pg[:2].abs().amax(dim=1)
    start, cnt = C + int(rng.randint(0, 16)), 5 * C + int(rng.randint(0, 99))
    state = torch.zeros((4, 2, G, 256), dtype=torch.int64)
    root = hs.leaf_hist_rmw_fixed_plain(pb, pg, start, cnt, num_bins=B,
                                        num_groups=G, state=state,
                                        idx=(-1, 1, 1, 0), absmax=absmax,
                                        kcnt=KCNT)
    sums, planes = _direct(pb, pg, start, cnt, None, absmax)
    assert torch.equal(state[1], sums)
    assert torch.equal(root[:, 0], planes) and torch.equal(root[:, 1], planes)
    sil = int(small_side == 0)
    nl, ch = _split(pb, pg, state, start, cnt, int(rng.randint(0, G)),
                    int(rng.randint(20, 230)), small_side, (1, 1, 3, sil),
                    absmax)
    for side, slot in ((0, 1), (1, 3)):
        sums, planes = _direct(pb, pg, start, cnt, (nl, side), absmax)
        assert torch.equal(state[slot], sums)
        assert torch.equal(ch[:, side].view(torch.int32),
                           planes.view(torch.int32))


@pytest.mark.parametrize("small_side", [0, 1])
def test_zero_row_child_gets_zeros_and_the_parent(small_side):
    """A smaller child of no rows (every row on the other side): zeros on
    its side, the parent's exact sums on the other."""
    _, pb, pg = _buffers(3)
    absmax = pg[:2].abs().amax(dim=1)
    start, cnt = C + 9, 3 * C
    state = torch.zeros((4, 2, G, 256), dtype=torch.int64)
    hs.leaf_hist_rmw_fixed_plain(pb, pg, start, cnt, num_bins=B,
                                 num_groups=G, state=state,
                                 idx=(-1, 2, 2, 0), absmax=absmax, kcnt=KCNT)
    parent = state[2].clone()
    thr = 255 if small_side == 1 else -1     # all left / all right
    sil = int(small_side == 0)
    nl, ch = _split(pb, pg, state, start, cnt, 3, thr, small_side,
                    (2, 2, 0, sil), absmax)
    assert int(nl[0]) == (cnt if small_side == 1 else 0)
    small_slot, large_slot = (2, 0) if sil else (0, 2)
    assert not state[small_slot].any() and not ch[:, small_side].any()
    assert torch.equal(state[large_slot], parent)


def test_exact_down_a_chain_of_splits():
    """Four splits deep, each child derived from its parent's derived
    slot: every leaf's slot stays equal to the direct sums of its rows."""
    rng, pb, pg = _buffers(4)
    absmax = pg[:2].abs().amax(dim=1)
    state = torch.zeros((6, 2, G, 256), dtype=torch.int64)
    leaves = {0: (C, 6 * C + 5)}
    hs.leaf_hist_rmw_fixed_plain(pb, pg, C, 6 * C + 5, num_bins=B,
                                 num_groups=G, state=state,
                                 idx=(-1, 0, 0, 0), absmax=absmax, kcnt=KCNT)
    for new in range(1, 5):
        leaf = max(leaves, key=lambda k: leaves[k][1])
        start, cnt = leaves[leaf]
        side = int(rng.randint(0, 2))
        nl, _ = _split(pb, pg, state, start, cnt, int(rng.randint(0, G)),
                       int(rng.randint(60, 200)), side,
                       (leaf, leaf, new, int(side == 0)), absmax)
        n = int(nl[0])
        leaves[leaf], leaves[new] = (start, n), (start + n, cnt - n)
        for k, (s, c) in leaves.items():
            assert torch.equal(state[k],
                               _direct(pb, pg, s, c, None, absmax)[0])


def test_leaf_hist_rmw_cpu_runs_the_f32_plain_versions():
    """On the CPU the fused entry is leaf_hist_plain, then hist_rmw_plain
    on the f32 state (the JAX contract); absmax and kcnt are not used;
    no launch is counted."""
    _, pb, pg = _buffers(5)
    start, cnt = C + 3, 4 * C
    before = (hs.launches, th.launches)
    state = hs.new_state(4, G, B, "cpu")
    kw = dict(num_bins=B, num_groups=G, absmax=None, kcnt=None)
    root = hs.leaf_hist_rmw(pb, pg, start, cnt, state=state,
                            idx=(-1, 0, 0, 0), **kw)
    planes = th.leaf_hist_plain(pb, pg, start, cnt, num_bins=B,
                                num_groups=G, planes=True)
    assert torch.equal(state[0], planes) and torch.equal(root[:, 1], planes)
    want = state.clone()
    nl = partition_leaf(pb, pg, make_scalars(start, cnt, 4, 0, 0, B, 0, 0,
                                             90, 0))
    ch = hs.leaf_hist_rmw(pb, pg, start, cnt, child=(nl, 1), state=state,
                          idx=(0, 0, 2, 0), **kw)
    small = th.leaf_hist_plain(pb, pg, start, cnt, num_bins=B, num_groups=G,
                               child=(nl, 1), planes=True)
    want_ch = hs.hist_rmw_plain(want, small, (0, 0, 2, 0))
    assert torch.equal(state, want) and torch.equal(ch, want_ch)
    assert (hs.launches, th.launches) == before
