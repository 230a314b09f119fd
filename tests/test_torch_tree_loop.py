"""The device-resident tree loop of the port on the CPU.

``ops/tree_step.py:tree_step_plain`` -- the bookkeeping step the card
runs as csrc/tree_step.cu -- is held bit for bit to the eager host loop's
bookkeeping (``reference_step`` below restates it as
``SerialTreeLearner.build_tree_eager`` does it) on leafmat, nodemat, the
step block and the info block: gain ties (the first index wins), -inf
gains, a gain of 0 and NaN (the tree stops), ``s == nodes``, the root,
and ties of the children's counts (the smaller child is the left one).
Whole trees from the step loop (``build_tree``) equal the eager oracle's
(``build_tree_eager``) exactly, on both split bodies; and the loop makes
one host read a tree.  No JAX here: the card tests import the case
builders of this file.
"""

import os

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.models import learner as lm
from lightgbm_tpu_torch.ops import partition as tpart
from lightgbm_tpu_torch.ops import tree_step as ts
from lightgbm_tpu_torch.ops.partition import (CAT_WORDS, SB_CNT, SB_DONE,
                                              SB_LEAF, SB_NEW, SB_PEND, SB_S)
from lightgbm_tpu_torch.ops.tree_step import (
    LM_BDL, LM_BFEAT, LM_BGAIN, LM_BISCAT, LM_BLCNT, LM_BLOUT, LM_BLSG,
    LM_BLSH, LM_BRCNT, LM_BROUT, LM_BRSG, LM_BRSH, LM_BTHR, LM_CNT, LM_CNT_G,
    LM_DEPTH, LM_PARENT, LM_PSIDE, LM_START, LM_SUM_H, LM_VALUE, ND_IS_CAT,
    ND_LEFT, ND_RIGHT, NND, _f2i, _i2f)
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW0, N, BAG = 256, 5000, 5000


def _i(x):
    return int(_f2i(x))


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def tree_case(seed, L=9, F=5, made=4, gains=None, sil_tie=False,
              W=CAT_WORDS):
    """A tree part-grown: ``made`` splits done (leaves 0..made), the last
    one pending commit, random best splits in every leaf, the pair
    search's rows for the pending children, the left count, fmeta.
    ``gains`` overrides LM_BGAIN of the leaves after the commit; ``W`` the
    category sets' words (the step block is SB_CAT + W)."""
    rng = np.random.RandomState(seed)
    nodes = L - 1
    lmat = ts.empty_leafmat(L)
    nmat = np.zeros((NND, nodes + 1), np.float32)
    fmeta = np.stack([rng.permutation(F) + 3, rng.permutation(F),
                      np.zeros(F), np.zeros(F), rng.randint(3, 255, F),
                      rng.randint(0, 3, F), rng.randint(0, 3, F),
                      np.zeros(F)]          # no monotone feature
                     ).astype(np.int32)

    def seg():
        s = rng.randn(13).astype(np.float32)
        s[0] = abs(s[0]) + 0.1
        lc, rc = rng.randint(1, 400, 2)
        if sil_tie:
            rc = lc
        s[1:6] = [_i2f(rng.randint(F)), _i2f(rng.randint(0, 250)),
                  float(rng.rand() > 0.5), _i2f(lc), _i2f(rc)]
        return s

    start = ROW0
    for leaf in range(made + 1):
        cnt = int(rng.randint(50, 900))
        parent = -1 if leaf == 0 else int(rng.randint(0, max(made - 1, 1)))
        lmat[:, leaf] = ts.leaf_column(start, cnt, cnt - 3, rng.randn(),
                                       abs(rng.randn()) + 1, rng.randint(5),
                                       rng.randn(), parent, leaf % 2, seg())
        start += cnt
    for node in range(made - 1):
        nmat[:, node] = rng.randn(NND).astype(np.float32)
    step = np.zeros(tpart.step_len(W), np.int32)
    pending = int(rng.randint(0, made))
    step[[SB_S, SB_LEAF, SB_NEW, SB_PEND]] = [made, pending, made, 2]
    pair = np.stack([seg(), seg()])
    if gains is not None:
        pair[0, 0], pair[1, 0] = gains[pending], gains[made]
        for leaf, g in enumerate(gains):
            if leaf not in (pending, made):
                lmat[LM_BGAIN, leaf] = g
    cnt = _i(lmat[LM_CNT, pending])
    nl = np.array([rng.randint(0, cnt + 1)], np.int32)
    info = rng.randn(2 * F, 8).astype(np.float32)
    sums = rng.randn(2).astype(np.float32)
    bag = np.array([BAG], np.int32)
    fmask = (rng.rand(F) < 0.7).astype(np.float32)
    # the category sets of the leaves, the nodes and the pending children
    # (random words: LM_BISCAT above is random too, so some leaves are
    # categorical)
    cats = [rng.randint(-2 ** 31, 2 ** 31, (r, W)).astype(np.int32)
            for r in (L + 1, nodes + 1, 2)]
    return [torch.as_tensor(a) for a in (lmat, nmat, step, nl, pair, fmeta,
                                         info, sums, bag, fmask, *cats)]


def reference_step(mode, lmat, nmat, step, nl, pair, fmeta, info, sums, bag,
                   fmask, leafcat, nodecat, paircat):
    """The eager loop's bookkeeping (build_tree_eager), on numpy copies:
    the root's column from the root search, or the split's two children
    from the left count and the pair search's rows (and their sets); then
    the argmax, the stop rule, the node column and set, the parent's
    pointer and the info block.  Returns the arrays and the next split's
    (scalars, idx) or None."""
    L, nodes, F = lmat.shape[1] - 1, nmat.shape[1] - 1, fmeta.shape[1]
    lmat, nmat, info = lmat.copy(), nmat.copy(), info.copy()
    lc, nc = leafcat.copy(), nodecat.copy()
    s = int(step[SB_S])
    if step[SB_PEND] == 1:
        lmat[:, 0] = ts.leaf_column(ROW0, N, bag[0], sums[0], sums[1], 0, 0.0,
                                    -1, 0, pair[0])
        lc[0] = paircat[0]
    elif step[SB_PEND] == 2:
        best, new = int(step[SB_LEAF]), int(step[SB_NEW])
        pcol = lmat[:, best].copy()
        start, cnt = _i(pcol[LM_START]), _i(pcol[LM_CNT])
        dc = _i(pcol[LM_DEPTH]) + 1
        left = int(nl[0])
        lmat[:, best] = ts.leaf_column(start, left, _i(pcol[LM_BLCNT]),
                                       pcol[LM_BLSG], pcol[LM_BLSH], dc,
                                       pcol[LM_BLOUT], s - 1, 0, pair[0])
        lmat[:, new] = ts.leaf_column(start + left, cnt - left,
                                      _i(pcol[LM_BRCNT]), pcol[LM_BRSG],
                                      pcol[LM_BRSH], dc, pcol[LM_BROUT],
                                      s - 1, 1, pair[1])
        lc[best], lc[new] = paircat[0], paircat[1]
    if mode == ts.MODE_FINAL or s >= nodes or step[SB_DONE]:
        return lmat, nmat, info, lc, nc, None
    bgain = lmat[LM_BGAIN, :L]
    best = int(np.argmax(bgain))
    gain = bgain[best]
    if not gain > 0:
        return lmat, nmat, info, lc, nc, None
    pcol = lmat[:, best].copy()
    fe = _i(pcol[LM_BFEAT])
    nmat[:, s] = ts.node_column(pcol, gain, fmeta[:, fe], best, s + 1)
    iscat = int(pcol[LM_BISCAT] > 0.5)
    nmat[ND_IS_CAT, s] = iscat
    nc[s] = lc[best]
    p = _i(pcol[LM_PARENT])
    if p >= 0:
        nmat.view(np.int32)[ND_LEFT if _i(pcol[LM_PSIDE]) == 0
                            else ND_RIGHT, p] = s
    lcg, rcg = _i(pcol[LM_BLCNT]), _i(pcol[LM_BRCNT])
    dc = _i(pcol[LM_DEPTH]) + 1
    info = ts.info_block(F, [(pcol[LM_BLSG], pcol[LM_BLSH], lcg, dc),
                             (pcol[LM_BRSG], pcol[LM_BRSH], rcg, dc)], fmask)
    _, col, bstart, isb, nb, dbin, mtype = (int(v) for v in fmeta[:7, fe])
    sc = tpart.make_scalars(_i(pcol[LM_START]), _i(pcol[LM_CNT]), col,
                            bstart, isb, nb, dbin, mtype, _i(pcol[LM_BTHR]),
                            bool(pcol[LM_BDL] > 0.5), iscat, lc[best])
    return lmat, nmat, info, lc, nc, (sc, (best, best, s + 1,
                                          int(lcg <= rcg)))


NAN, NEG = float("nan"), float("-inf")
# LM_BGAIN of leaves 0..4 after the pending split's commit
GAIN_CASES = {
    "random": None,
    "tie first index wins": [0.5, 2.0, 2.0, 1.0, 2.0],
    "all -inf": [NEG] * 5,
    "one finite among -inf": [NEG, NEG, 0.7, NEG, NEG],
    "max gain 0 stops": [0.0, -1.0, NEG, 0.0, -0.5],
    "nan stops": [0.5, NAN, 3.0, 1.0, 0.2],
    "nan after max stops": [0.5, 3.0, 1.0, NAN, 0.2],
    "negative zero tie": [-0.0, 0.0, NEG, NEG, NEG],
}


def _run_both(case, mode):
    want = reference_step(mode, *(t.numpy() for t in case))
    ts.tree_step_plain(mode, *case, row0=ROW0, N=N)
    return want


def _check(case, want, final=False):
    lmat, nmat, step, _, _, _, info, _, _, _, lc, nc, _ = case
    wl, wn, wi, wlc, wnc, nxt = want
    assert np.array_equal(lmat.numpy().view(np.int32), wl.view(np.int32))
    assert np.array_equal(nmat.numpy().view(np.int32), wn.view(np.int32))
    assert np.array_equal(info.numpy().view(np.int32), wi.view(np.int32))
    assert np.array_equal(lc.numpy(), wlc)
    assert np.array_equal(nc.numpy(), wnc)
    w = step.numpy()
    if final:
        assert w[SB_PEND] == 0
        return
    if nxt is None:
        assert w[SB_CNT] == 0 and w[SB_DONE] == 1 and w[SB_PEND] == 0
        return
    sc, idx, side = tpart.step_fields(step)
    assert (sc, idx, side) == (nxt[0], nxt[1], 1 if nxt[1][3] else 2)
    assert w[SB_PEND] == 2 and w[SB_DONE] == 0


@pytest.mark.parametrize("case", sorted(GAIN_CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_tree_step_plain_matches_eager_bookkeeping(case, seed):
    c = tree_case(seed, gains=GAIN_CASES[case])
    _check(c, _run_both(c, ts.MODE_STEP))


@pytest.mark.parametrize("seed", [2, 3])
def test_tree_step_plain_child_count_tie_is_small_left(seed):
    c = tree_case(seed, sil_tie=True)
    want = _run_both(c, ts.MODE_STEP)
    _check(c, want)
    assert want[-1][1][3] == 1


def test_tree_step_plain_stops_at_s_equal_nodes():
    """The last split (s == nodes after it) is committed, then no leaf is
    elected, whatever the gains."""
    c = tree_case(4, L=6, made=5)
    _check(c, _run_both(c, ts.MODE_STEP))
    assert c[2][SB_DONE] == 1


def test_tree_step_plain_final_commits_only():
    c = tree_case(5)
    nodes_before = c[1].clone()
    _check(c, _run_both(c, ts.MODE_FINAL), final=True)
    assert torch.equal(c[1], nodes_before)


def test_tree_step_plain_root_then_first_election():
    """MODE_ROOT resets the matrices and writes the root search's info
    block; the next step commits the root's column and elects it."""
    c = tree_case(6)
    ts.tree_step_plain(ts.MODE_ROOT, *c, row0=ROW0, N=N)
    lmat, nmat, step, _, pair, _, info, sums, _, fmask, lc, nc, _ = c
    assert np.array_equal(lmat.numpy().view(np.int32),
                          ts.empty_leafmat(lmat.shape[1] - 1).view(np.int32))
    assert not nmat.any() and step[SB_PEND] == 1
    assert not lc.any() and not nc.any()
    want = ts.info_block(info.shape[0] // 2, [(0, 0, BAG, 0)] * 2,
                         fmask.numpy())
    want[:, :2] = sums.numpy()
    assert np.array_equal(info.numpy(), want)
    _check(c, _run_both(c, ts.MODE_STEP))
    assert _i(lmat[LM_CNT, 0]) == N and _i(lmat[LM_CNT_G, 0]) == BAG
    assert step[SB_S] == 1 and step[SB_LEAF] == 0


def test_tree_step_plain_stopped_tree_writes_nothing():
    """After a stop every step leaves the matrices and the info block as
    they are."""
    c = tree_case(7, gains=GAIN_CASES["max gain 0 stops"])
    ts.tree_step_plain(ts.MODE_STEP, *c, row0=ROW0, N=N)
    assert c[2][SB_DONE] == 1
    before = [t.clone() for t in c]
    for mode in (ts.MODE_STEP, ts.MODE_STEP, ts.MODE_FINAL):
        ts.tree_step_plain(mode, *c, row0=ROW0, N=N)
        for a, b in zip(c, before):
            assert torch.equal(_bits(a), _bits(b))


# ---- whole trees: the step loop against the eager oracle ----------------

EXAMPLES = {"binary": ("binary_classification/binary.train", "binary"),
            "regression": ("regression/regression.train", "regression")}


def _load(rel):
    d = np.loadtxt(os.path.join(ROOT, "examples", rel))
    return d[:, 1:], d[:, 0]


def lockstep(X, y, params, device, trees=3):
    """Two boosters on ``device``, one growing its trees with build_tree
    and one with build_tree_eager, iteration by iteration; yields after
    each tree (graph booster, eager booster)."""
    a = lgt.Booster(dict(params, device_type=device), lgt.Dataset(X, label=y))
    b = lgt.Booster(dict(params, device_type=device), lgt.Dataset(X, label=y))
    eager = b._gbdt.learner
    eager.build_tree = eager.build_tree_eager
    for _ in range(trees):
        a.update()
        b.update()
        yield a, b


def assert_same_tree(a, b):
    """Leafmat, nodemat, the tree record and both row buffers (the row
    order the next tree starts from) bit for bit."""
    la, lb = a._gbdt.learner, b._gbdt.learner
    for t in ("leafmat", "nodemat"):
        assert torch.equal(getattr(la, t).view(torch.int32),
                           getattr(lb, t).view(torch.int32)), t
    ta, tb = a._gbdt.models[-1], b._gbdt.models[-1]
    assert ta.num_leaves == tb.num_leaves
    for f in ("split_feature", "threshold_bin", "left_child", "right_child",
              "leaf_value", "leaf_count", "internal_value",
              "internal_count", "split_gain"):
        assert np.array_equal(getattr(ta, f), getattr(tb, f)), f
    (pa, ga), (pb, gb) = a._gbdt._phys, b._gbdt._phys
    assert torch.equal(pa.cpu(), pb.cpu())
    assert torch.equal(ga.view(torch.int32), gb.view(torch.int32))


@pytest.mark.parametrize("body", ["mega", "subtraction"])
@pytest.mark.parametrize("example", sorted(EXAMPLES))
def test_step_loop_trees_equal_eager_oracle(example, body):
    rel, obj = EXAMPLES[example]
    X, y = _load(rel)
    params = {"objective": obj, "num_leaves": 15, "verbosity": -1}
    if body == "subtraction":
        params["tpu_megakernel"] = "off"
    for a, b in lockstep(X, y, params, "cpu"):
        assert_same_tree(a, b)
    assert a._gbdt.learner.syncs == 3
    assert a._gbdt.learner.subtract == (body == "subtraction")


def test_step_loop_counts(monkeypatch):
    """Per tree on the CPU: one host read of the finished tree; per split
    one partition, one fused histogram, one pair search and one
    bookkeeping step; plus the root's histogram and search, the root's
    reset, and the step that finds the tree done."""
    calls = dict.fromkeys(["partition_step", "leaf_hist_rmw_step",
                           "split_pair", "split_mega_step", "tree_step"], 0)
    for name in calls:
        real = getattr(lm, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(lm, name, counted)
    X, y = _load(EXAMPLES["binary"][0])
    b = lgt.train({"objective": "binary", "num_leaves": 15, "verbosity": -1,
                   "device_type": "cpu", "tpu_megakernel": "off"},
                  lgt.Dataset(X, label=y), num_boost_round=2)
    splits = sum(t.num_leaves - 1 for t in b._gbdt.models)
    assert splits == 28
    assert calls == {"partition_step": splits,
                     "leaf_hist_rmw_step": splits + 2,
                     "split_pair": splits + 2, "split_mega_step": 0,
                     "tree_step": 2 * 2 + splits}
    assert b._gbdt.learner.syncs == 2
