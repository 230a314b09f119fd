"""The port's pair search (lightgbm_tpu_torch/ops/split_pair.py) against
the JAX pair kernel run in the Pallas interpreter and against the JAX
one-leaf search ``find_best_split_fast``.

Tolerances: int fields (feature, threshold, default_left, counts) must
be identical.  The JAX kernel's prefix sums are an f32 triangular
matmul, the port's an f64 running sum rounded to f32, so float fields
differ in the last bits of the leaf totals they are derived from:
the children's sums agree to rtol 1e-5 with atol 1e-5 x the child's
total; gains and leaf outputs, which subtract nearly equal totals,
agree to rtol 2e-4 / atol 1e-5 (the bar tests/test_pallas_interpret.py
holds the JAX kernel to against find_best_split_fast).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu.ops.split_pallas import best_split_pair_pallas
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops.split_pair import (split_pair, split_pair_plain)

INT_FIELDS = (1, 2, 3, 4, 5)       # feature, threshold, dl, counts
SUM_FIELDS = (6, 7, 8, 9)          # left/right grad/hess sums
DERIVED_FIELDS = (0, 10, 11)       # gain, left/right output


def _case(seed, F=7, BF=31, mtypes=(0, 1, 2)):
    rng = np.random.RandomState(seed)
    num_bin = rng.randint(3, BF + 1, size=F).astype(np.int32)
    missing = rng.choice(mtypes, size=F).astype(np.int32)
    dflt = np.where(missing == 1, rng.randint(0, 3, size=F), 0).astype(
        np.int32)
    half = np.zeros((F, 8), np.int32)
    half[:, 0], half[:, 1], half[:, 2] = num_bin, missing, dflt
    hists, infos = [], []
    for c in range(2):
        hist = np.zeros((F, BF, 2), np.float32)
        for f in range(F):
            hist[f, :num_bin[f], 0] = rng.normal(size=num_bin[f])
            hist[f, :num_bin[f], 1] = rng.uniform(0.01, 2.0, size=num_bin[f])
        info = np.zeros((F, 8), np.float32)
        info[:, 0] = hist[0, :, 0].sum()
        info[:, 1] = hist[0, :, 1].sum()
        info[:, 2] = 1000 + 200 * c
        info[:, 3] = 2 + c
        info[:, 4] = rng.rand(F) > 0.2
        hists.append(hist)
        infos.append(info)
    return dict(
        hg=np.concatenate([h[..., 0] for h in hists]),
        hh=np.concatenate([h[..., 1] for h in hists]),
        fmeta=np.concatenate([half, half]), info=np.concatenate(infos),
        hists=hists, infos=infos, num_bin=num_bin, missing=missing,
        dflt=dflt)


PARAMS = [
    dict(l1=0.0, l2=1e-3, max_delta_step=0.0, min_gain_to_split=0.0,
         min_data_in_leaf=5, min_sum_hessian=1e-3, max_depth=0),
    dict(l1=0.5, l2=2.0, max_delta_step=0.0, min_gain_to_split=0.1,
         min_data_in_leaf=20, min_sum_hessian=1.0, max_depth=0),
    dict(l1=0.1, l2=0.5, max_delta_step=0.7, min_gain_to_split=0.0,
         min_data_in_leaf=1, min_sum_hessian=1e-3, max_depth=0),
    # depth guard: child 1 sits at depth 3 == max_depth, so every one of
    # its candidates is invalid and both searches fall to the same
    # degenerate winner
    dict(l1=0.0, l2=1.0, max_delta_step=0.0, min_gain_to_split=0.0,
         min_data_in_leaf=5, min_sum_hessian=1e-3, max_depth=3),
    # min-data guard rejecting most candidates
    dict(l1=0.0, l2=0.0, max_delta_step=0.0, min_gain_to_split=0.0,
         min_data_in_leaf=400, min_sum_hessian=1e-3, max_depth=0),
]


def _port(case, p):
    return split_pair(torch.as_tensor(case["hg"]), torch.as_tensor(case["hh"]),
                      torch.as_tensor(case["fmeta"]),
                      torch.as_tensor(case["info"]), **p).numpy()


def _assert_rows(got, want, infos):
    for c in range(2):
        assert got[c, list(INT_FIELDS)].view(np.int32).tolist() == \
            want[c, list(INT_FIELDS)].view(np.int32).tolist(), c
        scale = max(abs(float(infos[c][0, 0])), float(infos[c][0, 1]), 1.0)
        np.testing.assert_allclose(got[c, list(SUM_FIELDS)],
                                   want[c, list(SUM_FIELDS)],
                                   rtol=1e-5, atol=1e-5 * scale)
        np.testing.assert_allclose(got[c, list(DERIVED_FIELDS)],
                                   want[c, list(DERIVED_FIELDS)],
                                   rtol=2e-4, atol=1e-5)
        assert got[c, 12] == want[c, 12] == 0.0


@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_split_pair_plain_matches_pallas_interpreted(pi):
    p = PARAMS[pi]
    case = _case(10 + pi)
    tile = np.asarray(best_split_pair_pallas(
        jnp.asarray(case["hg"]), jnp.asarray(case["hh"]),
        jnp.asarray(case["fmeta"]), jnp.asarray(case["info"]),
        interpret=True, **p))
    got = _port(case, p)
    assert got.shape == (2, 13) and got.dtype == np.float32
    _assert_rows(got, tile[:2, :13], case["infos"])
    if p["max_depth"] == 3:
        assert got[0, 0] > float("-inf") and got[1, 0] == float("-inf")


@pytest.mark.parametrize("mtype", [0, 1, 2])
def test_split_pair_plain_matches_find_best_split_fast(mtype):
    """Each child's row equals the JAX one-leaf search on that child,
    with every feature of one missing type."""
    p = PARAMS[0]
    case = _case(30 + mtype, mtypes=(mtype,))
    got = _port(case, p)
    ctx = jsplit.SplitContext(
        jnp.asarray(case["num_bin"]), jnp.asarray(case["missing"]),
        jnp.asarray(case["dflt"]), jnp.zeros(7, jnp.int32),
        jnp.arange(7, dtype=jnp.int32))
    for c in range(2):
        info = case["infos"][c]
        ref = jsplit.find_best_split_fast(
            jnp.asarray(case["hists"][c]), ctx, jnp.float32(info[0, 0]),
            jnp.float32(info[0, 1]), jnp.int32(info[0, 2]), p["l1"],
            p["l2"], p["max_delta_step"], p["min_gain_to_split"],
            p["min_data_in_leaf"], p["min_sum_hessian"],
            jnp.asarray(info[:, 4] > 0))
        row = got[c]
        assert row[1:2].view(np.int32)[0] == int(ref.feature)
        assert row[2:3].view(np.int32)[0] == int(ref.threshold)
        assert bool(row[3] > 0.5) == bool(ref.default_left)
        assert row[4:5].view(np.int32)[0] == int(ref.left_count)
        assert row[5:6].view(np.int32)[0] == int(ref.right_count)
        scale = max(abs(float(info[0, 0])), float(info[0, 1]), 1.0)
        np.testing.assert_allclose(
            row[[6, 7]], [float(ref.left_sum_g), float(ref.left_sum_h)],
            rtol=1e-5, atol=1e-5 * scale)
        np.testing.assert_allclose(
            row[[0, 10, 11]], [float(ref.gain), float(ref.left_output),
                               float(ref.right_output)],
            rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("mtype", [0, 1, 2])
def test_find_best_split_fast_port_matches_jax(mtype):
    """The port's one-leaf search against the JAX function."""
    case = _case(50 + mtype, mtypes=(mtype,))
    p = PARAMS[1]
    info = case["infos"][0]
    args = (p["l1"], p["l2"], p["max_delta_step"], p["min_gain_to_split"],
            p["min_data_in_leaf"], p["min_sum_hessian"])
    jctx = jsplit.SplitContext(
        jnp.asarray(case["num_bin"]), jnp.asarray(case["missing"]),
        jnp.asarray(case["dflt"]), jnp.zeros(7, jnp.int32),
        jnp.arange(7, dtype=jnp.int32))
    ref = jsplit.find_best_split_fast(
        jnp.asarray(case["hists"][0]), jctx, jnp.float32(info[0, 0]),
        jnp.float32(info[0, 1]), jnp.int32(info[0, 2]), *args)
    tctx = tsplit.SplitContext(torch.as_tensor(case["num_bin"]),
                               torch.as_tensor(case["missing"]),
                               torch.as_tensor(case["dflt"]))
    got = tsplit.find_best_split_fast(
        torch.as_tensor(case["hists"][0]), tctx, float(info[0, 0]),
        float(info[0, 1]), int(info[0, 2]), *args)
    for k in ("feature", "threshold", "default_left", "left_count",
              "right_count"):
        assert int(getattr(got, k)) == int(getattr(ref, k)), k
    scale = max(abs(float(info[0, 0])), float(info[0, 1]), 1.0)
    for k in ("left_sum_g", "left_sum_h", "right_sum_g", "right_sum_h"):
        np.testing.assert_allclose(float(getattr(got, k)),
                                   float(getattr(ref, k)),
                                   rtol=1e-5, atol=1e-5 * scale, err_msg=k)
    for k in ("gain", "left_output", "right_output"):
        np.testing.assert_allclose(float(getattr(got, k)),
                                   float(getattr(ref, k)),
                                   rtol=2e-4, atol=1e-5, err_msg=k)


def test_split_pair_dispatches_cpu_to_plain_version():
    """A CPU tensor runs the plain version and launches nothing."""
    from lightgbm_tpu_torch.ops import split_pair as sp
    case = _case(7)
    before = sp.launches
    a = _port(case, PARAMS[0])
    b = split_pair_plain(*(torch.as_tensor(case[k]) for k in
                           ("hg", "hh", "fmeta", "info")), **PARAMS[0])
    assert np.array_equal(a.view(np.int32), b.numpy().view(np.int32))
    assert sp.launches == before


def _blocked_scan_oracle(x):
    """numpy emulation of the pair kernel's prefix-sum association (f64):
    32 lanes of max(8, ceil(n/32)) bins, each lane's bins summed from the
    left, an inclusive Hillis-Steele scan of the lane totals (lane l adds
    lane l - d at d = 1, 2, 4, 8, 16), the exclusive offset added per
    bin, rounded to f32."""
    n = x.shape[-1]
    per = max(8, -(-n // 32))
    rows = x.reshape(-1, n).astype(np.float64)
    out = np.empty(rows.shape, np.float32)
    for i, row in enumerate(rows):
        pad = np.zeros(32 * per)
        pad[:n] = row
        loc = np.empty((32, per))
        for lane in range(32):
            acc = pad[lane * per]
            loc[lane, 0] = acc
            for j in range(1, per):
                acc = acc + pad[lane * per + j]
                loc[lane, j] = acc
        tot = loc[:, -1].copy()
        for d in (1, 2, 4, 8, 16):
            tot = np.array([tot[lane] + tot[lane - d] if lane >= d
                            else tot[lane] for lane in range(32)])
        off = np.concatenate([[0.0], tot[:-1]])
        out[i] = (off[:, None] + loc).reshape(-1)[:n].astype(np.float32)
    return out.reshape(x.shape)


@pytest.mark.parametrize("n", [1, 16, 31, 255, 256, 300])
def test_prefix_sum_blocked_association(n):
    """ops/split.py prefix_sum equals the numpy emulation of its blocked
    association bit for bit, and a sequential f64 oracle within one f32
    rounding (plus the f64 rounding of either order)."""
    rng = np.random.RandomState(n)
    x = (rng.randn(3, 4, n) * np.exp(rng.randn(3, 4, n) * 4)).astype(
        np.float32)
    x[0, 0, ::3] = 0.0
    x[0, 1] = -0.0
    got = tsplit.prefix_sum(torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    want = _blocked_scan_oracle(x)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    seq = np.cumsum(x.astype(np.float64), axis=-1)
    f64_err = 2 * n * 2.0 ** -53 * np.cumsum(np.abs(x.astype(np.float64)),
                                             axis=-1)
    assert (np.abs(got - seq) <= np.abs(seq) * 2.0 ** -24 + f64_err).all()
