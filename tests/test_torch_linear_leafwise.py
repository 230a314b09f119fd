"""Linear trees, ``linear_tree_mode`` leafwise_gain, end to end:
``lightgbm_tpu_torch.train`` (``device_type`` cpu) against the JAX
package on ``examples/*``, 15 leaves, 5 iterations.

The split search itself scores leaf-local linear models
(ops/split_linear.py, in the tree's loop in place of the pair search),
and each leaf's model is its own best single-feature fit from that
search, so there is no fit after the tree.  As in the JAX package the
learner takes the histogram-subtraction body at K=1 whatever
``tpu_megakernel`` and ``tpu_frontier_k`` say.  The trees are held split
for split with the linear tie rule (tests/torch_linear_cases.py), the
linear leaves to the repo's bars and the raw predictions to the bar
those give each row (tests/torch_linear_cases.py ``leaf_bar``).  The
envelope's warnings are in test_torch_linear_ops.py.
"""

from unittest import mock

import pytest

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.models.learner import SerialTreeLearner

from torch_boost_cases import BAG, BIN, BODIES, REG, example, train_both
from torch_linear_cases import check_linear
from torch_one_thread import one_torch_thread  # noqa: F401

ROUNDS = 5
LEAFWISE = {"num_leaves": 15, "linear_tree": True,
            "linear_tree_mode": "leafwise_gain"}
# case: (data, params, body, tie)
CASES = {
    "regression-mega": (REG, {"objective": "regression"}, "mega", None),
    "regression-k4": (REG, {"objective": "regression",
                            "linear_lambda": 0.5}, "k4", None),
    "binary-sub": (BIN, {"objective": "binary"}, "sub", None),
    "binary-bagging-sub": (BIN, dict(BAG, objective="binary"), "sub", (0, 9)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_leafwise_matches_jax(case):
    data, extra, body, tie = CASES[case]
    params = dict(LEAFWISE, **extra, **BODIES[body])
    jb, tb, rec = train_both(params, data, ROUNDS)
    g = tb._gbdt
    lr = g.learner
    assert lr.linear_gain and lr.subtract and lr.K == 1
    assert lr.lin_static.rep.shape == (lr.F, lr.children.shape[-1])
    assert g.learner.syncs == ROUNDS
    X = example(data)[0]
    check_linear(X, jb, tb, rec, params, tie, leafwise=True)
    # one model a leaf, on one feature
    assert all(len(c) <= 1 for t in g.models for c in t.leaf_coeff)
    assert sum(len(c) for t in g.models for c in t.leaf_coeff) > 30


def test_record_carries_each_leafs_model():
    """The tree's record holds each leaf's own model (JAX
    ``leaf_lin_const`` / ``leaf_lin_coeff`` / ``leaf_lin_feat``), which the
    host tree takes shrunk: the record's values times the learning
    rate."""
    X, y = example(REG)
    recs = []
    orig = SerialTreeLearner.build_tree

    def keep(self, *a, **k):
        recs.append(orig(self, *a, **k))
        return recs[-1]

    with mock.patch.object(SerialTreeLearner, "build_tree", keep):
        tb = lgt.train(dict(LEAFWISE, objective="regression",
                            learning_rate=0.25, device_type="cpu",
                            verbosity=-1), lgt.Dataset(X, label=y), 2)
    t, rec = tb._gbdt.models[1], recs[1]
    L = t.num_leaves
    for leaf in range(L):
        c = float(rec["leaf_lin_coeff"][leaf])
        if t.leaf_features[leaf]:
            assert t.leaf_features[leaf] == [int(rec["leaf_lin_feat"][leaf])]
            assert t.leaf_coeff[leaf] == [c * 0.25]
            assert t.leaf_const[leaf] == float(rec["leaf_lin_const"][leaf]) \
                * 0.25
        else:
            assert abs(c) <= 1e-35
            assert t.leaf_const[leaf] == t.leaf_value[leaf]
