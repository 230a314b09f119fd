"""The clamp arm of the port's categorical search against the JAX
package, on the CPU: the pair search then ``split_cat``, both with their
monotone arms (the children's outputs clipped to the leaf's bounds, every
gain taken at the clipped outputs; categorical features never monotone
themselves), against JAX's general search ``find_best_split`` with the
same bounds, directions and penalty on seeded random histograms: the
winning feature and arm identical, the set identical, the gain within
rtol 1e-5 and the outputs within rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.ops import split_cat as scat
from lightgbm_tpu_torch.ops.split_pair import penalty_table, split_pair_plain

from test_torch_categorical import SEARCH_PARAMS, _search_kw, random_hist
from test_torch_monotone import _bounds, _jax_best
from test_torch_monotone_trees import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("penalty", [0.0, 2.0])
@pytest.mark.parametrize("case", ["defaults", "threshold2", "onehot"])
def test_split_cat_monotone_arm_matches_jax(case, penalty):
    """The pair search then split_cat, both with their monotone arms,
    against JAX's general search with the same bounds, directions
    (categorical features unconstrained) and penalty."""
    kw = _search_kw(SEARCH_PARAMS[case])
    cat_kw = {k: kw.pop(k) for k in ("max_cat_threshold", "cat_l2",
                                     "cat_smooth", "max_cat_to_onehot",
                                     "min_data_per_group")}
    F, C = 12, 2
    rng = np.random.RandomState(len(case) + int(penalty))
    is_cat = (np.arange(F) % 3 != 1).astype(np.int32)
    mono = np.where(is_cat == 1, 0, rng.choice([-1, 1], F)).astype(np.int32)
    nb = rng.choice([3, 4, 8, 20, 40, 64], F).astype(np.int32)
    hists, infos = [], []
    for c in range(C):
        hist, _, n = random_hist(100 + c + len(case), F, nb=nb)
        info = np.zeros((F, 8), np.float32)
        info[:, 0] = hist[0, :, 0].sum()
        info[:, 1] = hist[0, :, 1].sum()
        info[:, 2], info[:, 3], info[:, 4] = n, 1 + c, rng.rand(F) > 0.2
        out = -info[0, 0] / (info[0, 1] + kw["l2"])
        info[:, 5], info[:, 6] = _bounds(out, c + len(case))
        hists.append(hist)
        infos.append(info)
    half = np.zeros((F, 8), np.int32)
    half[:, 0], half[:, 3], half[:, 4] = nb, is_cat, mono
    hg = torch.as_tensor(np.concatenate([h[..., 0] for h in hists]))
    hh = torch.as_tensor(np.concatenate([h[..., 1] for h in hists]))
    fm = torch.as_tensor(np.concatenate([half] * C))
    info = torch.as_tensor(np.concatenate(infos))
    pen = penalty_table(penalty, 31) if penalty > 0 else None
    pair = split_pair_plain(hg, hh, fm, info, mono=True, pen=pen, **kw)
    sets = torch.zeros((C, 8), dtype=torch.int32)
    scat.split_cat(hg, hh, fm, info, torch.as_tensor(
        np.nonzero(is_cat)[0].astype(np.int32)), pair, sets, mono=True, **kw,
        **cat_kw)
    z = np.zeros(F, np.int32)
    for c in range(C):
        best = _jax_best(hists[c], nb, z, z, is_cat, infos[c], kw, mono,
                         penalty, cat_kw)
        row = pair[c]
        assert int(row[1:2].view(torch.int32)) == int(best.feature)
        assert bool(row[12] > 0.5) == bool(best.is_cat)
        np.testing.assert_allclose(float(row[0]), float(best.gain),
                                   rtol=1e-5)
        np.testing.assert_allclose(
            row[10:12].numpy(), [float(best.left_output),
                                 float(best.right_output)],
            rtol=1e-4, atol=1e-5)
        if bool(best.is_cat):
            w = sets[c].numpy().astype(np.int64)[:, None] & 0xFFFFFFFF
            bins = np.nonzero(((w >> np.arange(32)) & 1).reshape(-1))[0]
            np.testing.assert_array_equal(
                bins, np.nonzero(np.asarray(best.cat_set))[0])
