"""The monotone arm of the port's pair search against the JAX package, on
the CPU: ``split_pair_plain`` with bounds, directions and
``monotone_penalty`` against JAX ``find_best_split`` on seeded random
histograms (the winning feature, threshold and default direction
identical; gain and outputs within rtol 2e-4 / atol 1e-5, the bar
tests/test_torch_split_pair.py holds the unconstrained search to: its
f64 prefix sums against JAX's f32 ones), the arm on unconstrained data,
and ``penalty_table`` against JAX's penalty formula, exactly.  The
categorical search's clamp arm is tests/test_torch_monotone_cat.py, the
bookkeeping and the refresh tests/test_torch_monotone_refresh.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.ops.split_pair import penalty_table, split_pair_plain

from test_torch_split_pair import PARAMS, _case
from test_torch_monotone_trees import one_torch_thread  # noqa: F401

PENALTIES = [0.0, 1.0, 2.0]


def _bounds(out, k):
    """Four kinds of a child's bounds around its own output ``out``."""
    return [(-np.inf, np.inf), (out - 0.05, np.inf), (-np.inf, out + 0.05),
            (out - 0.1, out + 0.02)][k % 4]


def _jax_best(hist, nb, mtype, dflt, is_cat, inf, kw, mono, penalty,
              cat_kw=None):
    F = hist.shape[0]
    ctx = jsplit.SplitContext(
        num_bin=jnp.asarray(nb), missing_type=jnp.asarray(mtype),
        default_bin=jnp.asarray(dflt),
        is_categorical=jnp.asarray(is_cat, jnp.int32),
        feature_index=jnp.arange(F, dtype=jnp.int32))
    return jsplit.find_best_split(
        jnp.asarray(hist), ctx, jnp.float32(inf[0, 0]),
        jnp.float32(inf[0, 1]), jnp.float32(inf[0, 2]), kw["l1"], kw["l2"],
        kw["max_delta_step"], kw["min_gain_to_split"],
        kw["min_data_in_leaf"], kw["min_sum_hessian"],
        feature_mask=jnp.asarray(inf[:, 4] > 0), cat_params=cat_kw,
        monotone=jnp.asarray(mono), cmin=jnp.float32(inf[0, 5]),
        cmax=jnp.float32(inf[0, 6]), depth=jnp.int32(inf[0, 3]),
        monotone_penalty=penalty)


@pytest.mark.parametrize("penalty", PENALTIES)
@pytest.mark.parametrize("pi", range(len(PARAMS)))
@pytest.mark.parametrize("seed", [0, 1])
def test_split_pair_monotone_arm_matches_jax(seed, pi, penalty):
    p = PARAMS[pi]
    case = _case(seed + 10 * pi)
    F = len(case["num_bin"])
    rng = np.random.RandomState(seed + 100 * pi)
    mono = rng.choice([-1, 0, 1], F).astype(np.int32)
    fm = case["fmeta"].copy()
    fm[:, 4] = np.concatenate([mono, mono])
    info = case["info"].copy()
    for c in range(2):
        rows = slice(c * F, (c + 1) * F)
        out = -info[c * F, 0] / (info[c * F, 1] + p["l2"])
        info[rows, 5], info[rows, 6] = _bounds(out, seed + c + pi)
    pen = penalty_table(penalty, 31) if penalty > 0 else None
    rows = split_pair_plain(
        torch.as_tensor(case["hg"]), torch.as_tensor(case["hh"]),
        torch.as_tensor(fm), torch.as_tensor(info), mono=True, pen=pen, **p)
    found = 0
    for c in range(2):
        inf = info[c * F:(c + 1) * F]
        best = _jax_best(case["hists"][c], case["num_bin"], case["missing"],
                         case["dflt"], np.zeros(F), inf, p, mono, penalty)
        if p["max_depth"] > 0 and inf[0, 3] >= p["max_depth"]:
            assert rows[c, 0] == float("-inf")
            continue
        r = rows[c]
        ri = r.view(torch.int32)
        jg = float(best.gain)
        if not np.isfinite(jg):
            assert not np.isfinite(float(r[0]))
            continue
        found += 1
        assert (int(ri[1]), int(ri[2]), float(r[3])) == (
            int(best.feature), int(best.threshold),
            float(best.default_left))
        np.testing.assert_allclose(float(r[0]), jg, rtol=2e-4, atol=1e-5)
        for k, v in ((10, best.left_output), (11, best.right_output)):
            np.testing.assert_allclose(float(r[k]), float(v), rtol=2e-4,
                                       atol=1e-5)
            assert info[c * F, 5] <= float(r[k]) <= info[c * F, 6]
        if mono[int(ri[1])] != 0:     # the direction holds
            assert (float(r[11]) - float(r[10])) * mono[int(ri[1])] >= 0
    assert found >= 1 or p["min_data_in_leaf"] > 100


def test_monotone_arm_without_monotone_features_is_the_plain_search():
    """No monotone feature and unbounded children: the same winners as
    the unconstrained search (the gains, taken at the outputs, agree to
    f32 rounding)."""
    for pi, p in enumerate(PARAMS):
        case = _case(3 + pi)
        args = [torch.as_tensor(case[k]) for k in ("hg", "hh", "fmeta")]
        info = torch.as_tensor(case["info"])
        info[:, 5], info[:, 6] = float("-inf"), float("inf")
        a = split_pair_plain(*args, info, mono=True, **p)
        b = split_pair_plain(*args, info, **p)
        assert torch.equal(a[:, 1:6], b[:, 1:6])
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


@pytest.mark.parametrize("penalty", [0.5, 1.0, 2.0, 3.5])
def test_penalty_table_is_jax_formula(penalty):
    tab = penalty_table(penalty, 200).numpy()
    d = jnp.arange(tab.shape[0], dtype=jnp.float32)
    want = jnp.where(
        penalty >= d + 1.0, jsplit.K_EPSILON,
        jnp.where(jnp.float32(penalty) <= 1.0,
                  1.0 - penalty / jnp.exp2(d) + jsplit.K_EPSILON,
                  1.0 - jnp.exp2(penalty - 1.0 - d) + jsplit.K_EPSILON))
    np.testing.assert_array_equal(tab, np.asarray(want, np.float32))
    assert tab[-1] == 1.0 and tab.shape[0] < 50
