"""The linear-tree pieces of the port against the JAX package's, on the
CPU: ``bin_rep_values`` bit for bit on examples/*, the moment planes,
the one-leaf linear search on seeded histograms in the five scenarios of
the JAX package's oracle test (tests/test_linear_leafwise.py: plain,
bagging, GOSS, quantized, multiclass), the path features the device
reads off a finished tree in JAX's stack order, and the leafwise_gain
envelope's warnings.
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import BinnedDataset as JDataset
from lightgbm_tpu.ops import histogram as jhist
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu.utils import log as jlog
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.dataset import BinnedDataset
from lightgbm_tpu_torch.models import linear as linmod
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops.split_linear import (find_best_split_linear,
                                                 linear_moment_planes)
from lightgbm_tpu_torch.ops.partition import SB_S
from lightgbm_tpu_torch.utils import log as tlog

from test_linear_leafwise import _ctx, _hist_for
from torch_boost_cases import ROOT
from torch_one_thread import one_torch_thread  # noqa: F401

LEAFWISE = {"num_leaves": 15, "linear_tree": True,
            "linear_tree_mode": "leafwise_gain"}
EXAMPLES = ["regression/regression.train",
            "binary_classification/binary.train",
            "multiclass_classification/multiclass.train",
            "xendcg/rank.train"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_bin_rep_values_bit_for_bit(name):
    """Every feature's representative values, with the raw column as
    f64 and as the learners pass it (f32), and without it, at the pair
    search's width, and from the Dataset's bins of the column: equal bit
    for bit to the JAX package's."""
    X = np.loadtxt(os.path.join(ROOT, "examples", name))[:, 1:]
    X[::13, 0] = np.nan           # a NaN bin on the first feature
    X[::17, 1] = 0.0
    jd = JDataset.from_matrix(X, JConfig({"linear_tree": True}))
    td = BinnedDataset.from_matrix(X, Config({"linear_tree": True}))
    np.testing.assert_array_equal(td.raw_data, jd.raw_data)
    meta = td.feature_meta_arrays()
    for f in range(X.shape[1]):
        for values in (X[:, f], td.raw_data[:, f], None):
            a = jd.bin_mappers[f].bin_rep_values(256, values=values)
            b = td.bin_mappers[f].bin_rep_values(256, values=values)
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(b, a)
        # the Dataset's bins of a feature alone in its group (the
        # learner's way) give the same values
        if f in meta["feature"]:
            g = int(meta["group"][list(meta["feature"]).index(f)])
            if td.groups[g].feature_indices == [f]:
                np.testing.assert_array_equal(
                    td.bin_mappers[f].bin_rep_values(
                        256, values=td.raw_data[:, f],
                        bins=td.binned[:, g]),
                    jd.bin_mappers[f].bin_rep_values(
                        256, values=td.raw_data[:, f]))


def test_moment_planes_match_jax():
    rng = np.random.RandomState(0)
    hist = rng.normal(size=(5, 31, 2)).astype(np.float32)
    rep = rng.uniform(-2, 2, size=(5, 31)).astype(np.float32)
    np.testing.assert_array_equal(
        linear_moment_planes(torch.as_tensor(hist),
                             torch.as_tensor(rep)).numpy(),
        np.asarray(jhist.linear_moment_planes(jnp.asarray(hist),
                                              jnp.asarray(rep))))


SCENARIOS = ["plain", "bagging", "goss", "quantized", "multiclass"]


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_linear_search_matches_jax(scenario, seed):
    """The JAX oracle test's seeded histograms: the discrete decisions
    (feature, threshold, default_left, the leaf's own feature) equal,
    the gain and the own model within the JAX test's f32-against-f64 bar
    (rtol / atol 3e-4: JAX sums in f32, the port in f64)."""
    rng = np.random.RandomState(100 * seed + 7 * SCENARIOS.index(scenario))
    F, BF = 6, 31
    ctx = _ctx(F, BF, rng)
    nb = np.asarray(ctx.num_bin)
    hist = _hist_for(scenario, F, BF, nb, rng)
    rep = rng.uniform(-2.0, 2.0, size=(F, BF)).astype(np.float32)
    missing, dflt = np.asarray(ctx.missing_type), np.asarray(ctx.default_bin)
    for f in range(F):
        if missing[f] == jsplit.MISSING_NAN:
            rep[f, nb[f] - 1] = 0.0
        if missing[f] == jsplit.MISSING_ZERO:
            rep[f, dflt[f]] = 0.0
        rep[f, nb[f]:] = 0.0
    sum_g, sum_h = float(hist[0, :, 0].sum()), float(hist[0, :, 1].sum())
    args = (1e-3, 0.0, 3, 1e-3)
    mask = (rng.rand(F) > 0.25) if seed % 2 else None
    want = jsplit.find_best_split_linear(
        jnp.asarray(hist), ctx, jnp.float32(sum_g), jnp.float32(sum_h),
        jnp.int32(900), *args, jnp.asarray(rep), 1e-2,
        feature_mask=None if mask is None else jnp.asarray(mask))
    tctx = tsplit.SplitContext(*(torch.as_tensor(np.array(v)) for v in (
        nb, missing, dflt)))
    got = find_best_split_linear(
        torch.as_tensor(hist), tctx, np.float32(sum_g), np.float32(sum_h),
        900, *args, rep, 1e-2, feature_mask=mask)
    if float(want.gain) == -np.inf:
        assert float(got.gain) == -np.inf
        return
    for name in ("feature", "threshold", "default_left", "self_feature",
                 "left_count", "right_count"):
        assert int(getattr(got, name)) == int(np.asarray(
            getattr(want, name))), name
    for name in ("gain", "self_coeff", "self_const", "left_sum_g",
                 "left_output", "right_output"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(np.asarray(getattr(want, name))),
                                   rtol=3e-4, atol=3e-4, err_msg=name)


def _jax_paths(tree):
    """JAX boosting.py ``_fit_linear_leaves``' path features of each leaf
    of a host tree (stack order, categorical splits skipped, each feature
    once)."""
    paths = [[] for _ in range(tree.num_leaves)]
    stack = [(0, [])]
    while stack and tree.num_leaves > 1:
        node, path = stack.pop()
        cat = tree.decision_type[node] & 1
        feats = path if cat else path + [int(tree.split_feature[node])]
        for child in (int(tree.left_child[node]),
                      int(tree.right_child[node])):
            if child < 0:
                paths[~child] = feats
            else:
                stack.append((child, feats))
    return [list(dict.fromkeys(p)) for p in paths]


@pytest.mark.parametrize("max_depth", [-1, 3])
def test_path_features_in_jax_stack_order(max_depth):
    """The device's path features of a finished tree (read off leafmat
    and nodemat, no host read) equal JAX's host walk of it, a
    categorical split skipped."""
    rng = np.random.RandomState(4)
    n = 3000
    X = np.column_stack([rng.normal(size=(n, 5)), rng.randint(0, 6, n)])
    y = X[:, 0] * X[:, 1] + (X[:, 5] == 2) + np.sin(X[:, 2])
    tb = lgt.train({"objective": "regression", "num_leaves": 31,
                    "linear_tree": True, "max_depth": max_depth,
                    "device_type": "cpu", "verbosity": -1},
                   lgt.Dataset(X, label=y, categorical_feature=[5]), 2)
    lr = tb._gbdt.learner
    tree = tb._gbdt.models[-1]
    assert tree.num_cat > 0
    D = linmod.width(X.shape[1], 31, max_depth)
    feat, ok = linmod.path_features(lr.leafmat, lr.nodemat,
                                    lr.steps[0, SB_S], X.shape[1], D)
    want = _jax_paths(tree)
    for leaf in range(tree.num_leaves):
        assert feat[leaf][ok[leaf]].tolist() == want[leaf], leaf


def _warned(mod_log, fn):
    lines = []
    old = mod_log.get_verbosity()
    mod_log.register_callback(lines.append)
    try:
        out = fn()
    finally:
        mod_log.register_callback(None)
        mod_log.set_verbosity(old)
    return out, [ln for ln in lines if "leafwise_gain" in ln]


@pytest.mark.parametrize("why", ["categorical", "lambda_l1"])
def test_outside_the_envelope_warns_and_trains_refit(why):
    """Categorical features and ``lambda_l1`` leave the linear search's
    envelope: both packages warn in the JAX package's words and train as
    refit, the same trees."""
    rng = np.random.RandomState(2)
    n = 800
    Xc = rng.randint(0, 5, size=n).astype(np.float64)
    X = np.column_stack([rng.normal(size=n), Xc])
    y = X[:, 0] * 2 + (Xc == 2) + 0.1 * rng.normal(size=n)
    extra = ({"categorical_feature": [1]} if why == "categorical"
             else {"lambda_l1": 0.5})
    params = dict(LEAFWISE, objective="regression", verbosity=0, **extra)
    jb, jw = _warned(jlog, lambda: lgb.train(
        params, lgb.Dataset(X, label=y), 3))
    tb, tw = _warned(tlog, lambda: lgt.train(
        dict(params, device_type="cpu"), lgt.Dataset(X, label=y), 3))
    assert jw and tw
    assert [w.split("] ", 1)[-1] for w in tw] == \
        [w.split("] ", 1)[-1] for w in jw]
    assert "falling back to the post-hoc refit mode" in tw[0]
    assert not tb._gbdt.learner.linear_gain
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)
