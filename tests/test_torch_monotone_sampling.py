"""Monotone constraints with GOSS and with a validation set, on the CPU:

  * GOSS (``intermediate``; the fused draw) against the JAX package
    (tests/test_torch_monotone_trees.py's ``check``: trees split for
    split or a recorded exact tie, leaf values rtol 1e-4 / atol 1e-5),
    the port's model swept for monotonicity;
  * a validation set (the port alone): its scores, updated a tree at a
    time outside the graph, give the metric of a fresh raw prediction.
"""

import numpy as np

import lightgbm_tpu_torch as lgt

from test_torch_monotone_options import BASE
from test_torch_monotone_trees import one_torch_thread  # noqa: F401
from test_torch_monotone_trees import MC, check, example, monotone_sweep, \
    train_both

ROUNDS = 3
# the first split where the packages part (test_torch_monotone_trees.py
# TIES, ROADMAP section C): an exact f64 tie of two splits of equal gain
# on one leaf, which each package's f32 rounding breaks another way
TIES = {"goss": (0, 15, 1e-9)}


def test_goss():
    """GOSS (the fused draw) under intermediate constraints."""
    X, y = example("binary_classification/binary.train")
    params = dict(BASE, objective="binary", data_sample_strategy="goss")
    jb, tb, rec = train_both(X, y, params, ROUNDS)
    assert tb._gbdt.goss and tb._gbdt.learner.mc_mode == "intermediate"
    check(X, jb, tb, rec, params, TIES.get("goss"))
    assert monotone_sweep(tb, X, MC) > 0


def test_validation_scores_follow_the_constrained_trees():
    """A validation set's scores, updated a tree at a time outside the
    graph, equal a fresh raw prediction of the constrained model."""
    X, y = example("binary_classification/binary.train")
    Xv, yv = example("binary_classification/binary.test")
    dt = lgt.Dataset(X, label=y)
    dv = lgt.Dataset(Xv, label=yv, reference=dt)
    evals = {}
    b = lgt.train(dict(BASE, objective="binary", device_type="cpu",
                       metric="binary_logloss", monotone_penalty=1.0), dt,
                  ROUNDS, valid_sets=[dv], valid_names=["v"],
                  callbacks=[lgt.record_evaluation(evals)])
    assert len(evals["v"]["binary_logloss"]) == ROUNDS
    p = 1.0 / (1.0 + np.exp(-b.predict(Xv, raw_score=True)))
    want = -np.mean(yv * np.log(p) + (1 - yv) * np.log(1 - p))
    np.testing.assert_allclose(evals["v"]["binary_logloss"][-1], want,
                               rtol=1e-5)
