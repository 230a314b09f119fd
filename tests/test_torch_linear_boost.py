"""Linear trees (``linear_tree_mode`` refit) with the rest of the
learner, the port (``device_type`` cpu) against the JAX package, 15
leaves: bagging and GOSS, quantized gradients and random forests
(multiclass and ranking: test_torch_linear_classes.py).

Which rows and gradients a leaf's fit sees, as in the JAX package
(boosting.py ``_fit_linear_leaves`` over ``_leaf_rows``, every train row
of the leaf, at ``gk_true`` / ``hk_true``): the out-of-bag rows of a
bagged or GOSS iteration are in their leaf's fit with gradient and
hessian 0, GOSS's kept rows at their scaled values, and a quantized
iteration's fit reads the true gradients, not the integer carriers
(payload rows ``4 + fields`` and ``5 + fields``).  RF with linear trees
does what JAX's RF does: each tree at shrinkage 1, the init score
folded into the first tree's constants, the train scores the running
sum (ROADMAP section C: rf.hpp keeps the average).
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.models import linear as linmod

from torch_boost_cases import (BAG, BIN, BODIES, REG, example, recording,
                               train_both)
from torch_linear_cases import check_linear
from torch_one_thread import one_torch_thread  # noqa: F401

ROUNDS = 4
LINEAR = {"num_leaves": 15, "linear_tree": True}


# case: (data, params, body, tie)
CASES = {
    "binary-bagging-mega": (BIN, dict(BAG, objective="binary"), "mega",
                            None),
    "binary-goss-sub": (BIN, {"objective": "binary",
                              "data_sample_strategy": "goss"}, "sub",
                        (0, 9)),
    "regression-quantized-mega": (REG, {"objective": "regression",
                                        "use_quantized_grad": True},
                                  "mega", None),
    "regression-rf-sub": (REG, {"objective": "regression", "boosting": "rf",
                                "bagging_fraction": 0.632,
                                "bagging_freq": 1}, "sub", None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_linear_with_the_learner_matches_jax(case):
    data, extra, body, tie = CASES[case]
    params = dict(LINEAR, **extra, **BODIES[body])
    jb, tb, rec = train_both(params, data, ROUNDS)
    X = example(data)[0] if isinstance(data, str) else data[0]
    check_linear(X, jb, tb, rec, params, tie)
    g = tb._gbdt
    if tie is not None:
        return
    if g.use_quant:
        # the true gradients ride the payload for the fit
        assert g._renew_rows == (5, 6)
    if extra.get("boosting") == "rf":
        assert g.shrinkage_rate == 1.0 and g.average_output
    np.testing.assert_allclose(g.scores.numpy(), np.asarray(jb._gbdt.scores),
                               rtol=0, atol=1e-5)


def _leaf_rows_fit(tb, X, g, h, t):
    """The JAX package's fit of tree ``t``'s leaves in numpy (boosting.py
    ``_fit_linear_leaves``): every train row of the leaf, at ``g`` /
    ``h`` (N,), over the raw f32 rows."""
    tree = tb._gbdt.models[t]
    raw = np.asarray(X, np.float32).astype(np.float64)
    leaf = tree.predict_leaf(X)
    out = {}
    for lf in range(tree.num_leaves):
        feats = tree.leaf_features[lf]
        if not feats:
            continue
        rows = np.nonzero(leaf == lf)[0]
        Xa = np.column_stack([raw[np.ix_(rows, feats)], np.ones(len(rows))])
        A = (Xa * h[rows, None]).T @ Xa
        A[np.diag_indices(len(feats) + 1)] += 1e-10 * (
            1 + A[np.diag_indices(len(feats) + 1)])
        out[lf] = -np.linalg.solve(A, Xa.T @ g[rows])
    return out


@pytest.mark.parametrize("sampling", ["bagging", "goss"])
def test_sampled_fit_sees_every_row_of_its_leaf(sampling):
    """A bagged or GOSS tree's leaves fit over all their rows, the rows
    left out at gradient and hessian 0 and GOSS's kept small-gradient rows
    at their amplified values: the port's coefficients equal a numpy fit
    on exactly those rows and values (rtol 1e-6, f64), while the tree's
    counts are the in-bag ones."""
    X, y = example(BIN)
    draw = BAG if sampling == "bagging" else {"data_sample_strategy":
                                              "goss"}
    params = dict(LINEAR, **draw, objective="binary", device_type="cpu",
                  verbosity=-1, learning_rate=1.0)
    with recording() as rec:
        tb = lgt.train(params, lgt.Dataset(X, label=y), 2)
    g, h = rec[1]
    assert (h == 0).sum() > 0.25 * len(h)
    if sampling == "goss":
        assert h.max() > 0.25     # a binary hessian amplified
    tree = tb._gbdt.models[1]
    want = _leaf_rows_fit(tb, X, g, h, 1)
    assert len(want) > 5
    for lf, coef in want.items():
        np.testing.assert_allclose(tree.leaf_coeff[lf], coef[:-1],
                                   rtol=1e-6)
    assert tree.leaf_count.sum() < len(y)        # in-bag counts


def test_quantized_fit_reads_the_true_gradients():
    """Quantized: the trees grow on the integer carriers and each leaf
    fits on the true gradients (a numpy fit on the recorded carriers
    times their scale gives other coefficients)."""
    X, y = example(REG)
    params = dict(LINEAR, objective="regression", device_type="cpu",
                  verbosity=-1, use_quantized_grad=True,
                  learning_rate=1.0)
    with recording() as rec:
        tb = lgt.train(params, lgt.Dataset(X, label=y), 1)
    tree = tb._gbdt.models[0]
    score = np.full(len(y), tb._gbdt.init_scores[0])
    want = _leaf_rows_fit(tb, X, score - y, np.ones(len(y)), 0)
    carriers = _leaf_rows_fit(tb, X, *rec[0], 0)
    parted = 0
    for lf, coef in want.items():
        np.testing.assert_allclose(tree.leaf_coeff[lf], coef[:-1],
                                   rtol=1e-6, atol=1e-9)
        parted += not np.allclose(carriers[lf], coef, rtol=1e-3)
    assert parted > 0


def test_linear_output_on_the_device_matches_the_host_tree():
    """ops of models/linear.py on a trained tree: the device's linear
    output of every row equals the host tree's f64 one, NaN rows
    included."""
    X, y = example(REG)
    tb = lgt.train(dict(LINEAR, objective="regression", device_type="cpu",
                        verbosity=-1), lgt.Dataset(X, label=y), 2)
    t = tb._gbdt.models[1]
    Xn = X.copy()
    Xn[::7, 3] = np.nan
    lin = linmod.from_tree(t, "cpu")
    got = linmod.linear_output(torch.as_tensor(Xn),
                               torch.as_tensor(t.predict_leaf(Xn)).long(),
                               lin, chunk=1000)
    np.testing.assert_allclose(got.numpy(), t.predict(Xn), rtol=0,
                               atol=1e-12)
