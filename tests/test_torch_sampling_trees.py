"""Sampled training in the port against the JAX package, on the CPU:
five trees on ``examples/binary_classification/binary.train``, the
port's mega path against JAX's (``tpu_megakernel=xla``,
``tpu_frontier_k=1``) or the subtraction paths (``off``): bagging on
both paths and balanced bagging.  feature_fraction is
tests/test_torch_sampling_ff.py's (a file of its own so that neither
file takes much more than 10 s).

Tolerances: the repo's bar -- structure identical, leaf values rtol 1e-4
/ atol 1e-5, raw predictions atol 1e-5 -- or, where the packages split
differently, the exact-tie rule of ROADMAP.md C
(tests/test_torch_train.py ``_compare_with_ties``), with each tree's
gradients under its bag.  Bagging draws by row id, so the bag of tree t
is recomputed here from ``bagging_seed``.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.utils import random as jr
from test_torch_sampling import _load
from test_torch_train import _compare_with_ties
from torch_one_thread import one_torch_thread  # noqa: F401

ROUNDS = 5
# case -> (params, JAX's megakernel path, the (tree, split) where the
# first differing split may be an exact tie, None for none)
CASES = {
    "bagging": (dict(bagging_fraction=0.7, bagging_freq=2), "xla", None),
    "bagging_subtraction": (dict(bagging_fraction=0.7, bagging_freq=2),
                            "off", None),
    # both packages grow the same first tree up to split 9, where two
    # features partition the rows differently with equal f64 gains
    "balanced_bagging": (dict(pos_bagging_fraction=0.5,
                              neg_bagging_fraction=0.9, bagging_freq=1),
                         "xla", (0, 9)),
}


def _bag(extra, y):
    """Tree t's (N,) 0/1 bag (None without bagging): the fused
    iteration's draw at seed t + 1."""
    freq = extra.get("bagging_freq", 0)
    if not freq:
        return None
    N = len(y)

    def scale(t):
        u = jr.uniform(jr.fold_in(jr.PRNGKey(3), t // freq), (N + 1,))[:N]
        if "bagging_fraction" in extra:
            sel = u < np.float32(extra["bagging_fraction"])
        else:
            pos = np.float32(extra["pos_bagging_fraction"])
            neg = np.float32(extra["neg_bagging_fraction"])
            sel = np.where(y > 0, u < pos, u < neg)
        return sel.astype(np.float64)
    return scale


def check_case(extra, mega):
    X, y = _load()
    params = dict({"objective": "binary", "num_leaves": 15,
                   "verbosity": -1, "min_data_in_leaf": 20}, **extra)
    jb = lgb.train(dict(params, tpu_megakernel=mega, tpu_frontier_k=1),
                   lgb.Dataset(X, label=y), num_boost_round=ROUNDS)
    jb.num_trees()
    tb = lgt.train(dict(params, device_type="cpu",
                        tpu_megakernel="off" if mega == "off" else "auto"),
                   lgt.Dataset(X, label=y), num_boost_round=ROUNDS)
    assert len(tb._gbdt.models) == ROUNDS
    bag = _bag(extra, y)
    if bag is not None:
        # the root counts the rows of the bag
        for t, tree in enumerate(tb._gbdt.models):
            assert tree.internal_count[0] == int(bag(t).sum()) < len(y)
    tie = _compare_with_ties(X, y, "binary", params, jb, tb, row_scale=bag)
    if tie is None:
        np.testing.assert_allclose(tb.predict(X, raw_score=True),
                                   jb.predict(X, raw_score=True), rtol=0,
                                   atol=1e-5)
    return tie


@pytest.mark.parametrize("case", sorted(CASES))
def test_sampled_trees_match_jax(case):
    extra, mega, tie = CASES[case]
    assert check_case(extra, mega) in (None, tie)
