"""DART boosting (``boosting=dart``) end to end: ``lightgbm_tpu_torch.train``
(``device_type`` cpu) against the JAX package on ``examples/*``, 15
leaves, a few iterations, on the mega body (K=1 and the frontier at K=4)
and the histogram-subtraction body.

Per case: the iterations each package drops are equal, iteration by
iteration (both draw them from ``drop_rng`` on the host), the weighted
mode's ``tree_weights`` and ``sum_weight`` are equal, and the trees are
held split for split with the repo's tie rule (tests/torch_boost_cases.py
``compare``; the recorded tie of a case is where its few gradient values
make two splits of exactly equal gain).  Then: continuation from an
init model (its trees never dropped), ``skip_drop=1`` equal to GBDT (JAX tests/test_objectives_all.py), the
refusal of linear trees, the f32 rounding of the drop factors bit for
bit, and what the init-score fold does once tree 0 is dropped.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.utils.log import LightGBMError as JaxLightGBMError
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.models.boosting import DART
from lightgbm_tpu_torch.utils.log import LightGBMError

from test_torch_multiclass import mc_data
from torch_boost_cases import (BAG, BIN, BIN_TEST, BODIES, REG, check,
                               drops, example, train_both)
from torch_one_thread import one_torch_thread  # noqa: F401

ROUNDS = 5
BASE = {"boosting": "dart", "num_leaves": 15, "drop_rate": 0.5,
        "skip_drop": 0.0}
# case: (data, params, body, validation file, tie)
CASES = {
    "weighted-max_drop-mega": (BIN, {"objective": "binary", "max_drop": 2},
                               "mega", None, None),
    "uniform-xgboost-sub": (REG, {"objective": "regression",
                                  "uniform_drop": True,
                                  "xgboost_dart_mode": True}, "sub", None,
                            None),
    "weighted-k4": (REG, {"objective": "regression", "drop_rate": 0.9,
                          "max_drop": 1}, "k4", None, None),
    "bagging-valid-mega": (BIN, dict(BAG, objective="binary",
                                     metric="binary_logloss"), "mega",
                           BIN_TEST, None),
    "classes-3-sub": ("mc3", {"objective": "multiclass", "num_class": 3},
                      "sub", None, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dart_trees_match_jax(case):
    data, extra, body, valid, tie = CASES[case]
    params = dict(BASE, **extra, **BODIES[body])
    if data == "mc3":
        # a seeded init score: tree 0 then sees more than 3 gradient
        # values, and meets no tie
        X, y = mc_data(3)
        data = (X, y, np.random.RandomState(4).randn(3 * len(y)) * 0.5)
    X = example(data)[0] if isinstance(data, str) else data[0]
    with drops() as dropped:
        jb, tb, rec = train_both(params, data, ROUNDS, valid=valid)
    assert dropped["port"] == dropped["jax"]
    assert sum(len(d) for d in dropped["port"]) >= 3
    jg, tg = jb._gbdt, tb._gbdt
    assert type(tg).__name__ == "DART" and tg._eager
    assert tg.tree_weights == jg.tree_weights
    assert tg.sum_weight == jg.sum_weight
    check(X, jb, tb, rec, params, tie)
    if tie is None:
        np.testing.assert_allclose(tg.scores.numpy(), np.asarray(jg.scores),
                                   rtol=0, atol=1e-5)
    if valid is not None:
        np.testing.assert_allclose(tg.valid_score(0).numpy(),
                                   np.asarray(jg.valid_scores[0]), rtol=0,
                                   atol=1e-5)
        ev = dict(((n, v) for _, n, v, _ in tb.eval_valid()))
        evj = dict(((n, v) for _, n, v, _ in jb.eval_valid()))
        np.testing.assert_allclose(ev["binary_logloss"],
                                   evj["binary_logloss"], rtol=1e-6)


def test_dart_continues_from_init_model():
    """DART from a GBDT model of 3 iterations: the loaded iterations are
    never dropped (``init_iters``), and the trees and drops equal JAX's."""
    X, y = example(REG)
    p0 = {"objective": "regression", "num_leaves": 15, "verbosity": -1}
    init = lgb.train(p0, lgb.Dataset(X, label=y), 3).model_to_string()
    params = dict(BASE, objective="regression", drop_rate=0.8)
    with drops() as dropped:
        jb, tb, rec = train_both(params, REG, 4, init_model=init)
    assert dropped["port"] == dropped["jax"]
    flat = [t for d in dropped["port"] for t in d]
    assert flat and min(flat) >= 3
    assert tb._gbdt.init_iters == jb._gbdt.init_iters == 3
    assert tb._gbdt.device_trees[:3] == [None] * 3
    # the loaded trees are not the port's own: compare the trees after them
    jb._gbdt.models, tb._gbdt.models = (jb._gbdt.models[3:],
                                        tb._gbdt.models[3:])
    from torch_boost_cases import compare
    assert compare(X, jb, tb, rec, params) is None


@pytest.mark.parametrize("body", ["mega", "sub"])
def test_skip_drop_one_is_gbdt(body):
    """``skip_drop=1`` never drops: DART's trees, scores and predictions
    are GBDT's bit for bit (the eager iteration without sampling grows
    the fused one's trees), as JAX tests/test_objectives_all.py holds
    JAX's DART to its GBDT."""
    X, y = example(BIN)
    params = dict(BASE, objective="binary", skip_drop=1.0, verbosity=-1,
                  device_type="cpu", **BODIES[body])
    db, gb = (lgt.train(dict(params, boosting=b), lgt.Dataset(X, label=y),
                        4) for b in ("dart", "gbdt"))
    assert not gb._gbdt._eager and db._gbdt._eager
    assert db._gbdt.tree_weights == [0.1] * 4
    for a, b in zip(gb._gbdt.models, db._gbdt.models):
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)
        np.testing.assert_array_equal(a.threshold, b.threshold)
    np.testing.assert_array_equal(db._gbdt.scores.numpy(),
                                  gb._gbdt.scores.numpy())
    np.testing.assert_array_equal(db.predict(X), gb.predict(X))


def test_linear_trees_are_refused():
    """DART with linear trees: the engine raises LightGBMError as JAX's
    does, and so does the API, in both packages."""
    p = {"boosting": "dart", "linear_tree": True, "device_type": "cpu"}
    with pytest.raises(LightGBMError, match="linear tree"):
        DART(Config(p), None, None, "cpu")
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.models.boosting import DART as JDART
    with pytest.raises(JaxLightGBMError, match="linear tree"):
        JDART(JConfig({"boosting": "dart", "linear_tree": True}), None, None)
    X, y = example(BIN)
    with pytest.raises(LightGBMError, match="linear tree"):
        lgt.train(dict(p, objective="binary"), lgt.Dataset(X, label=y), 1)
    with pytest.raises(JaxLightGBMError, match="linear tree"):
        lgb.train({"boosting": "dart", "linear_tree": True,
                   "objective": "binary", "verbosity": -1},
                  lgb.Dataset(X, label=y), 1)


def test_drop_factors_round_as_jax():
    """The device record's f32 arithmetic: a leaf value times each
    iteration's factor (a Python float), repeated as normalisations
    repeat, and gathered then scaled, bit for bit as JAX computes it."""
    rng = np.random.RandomState(0)
    delta = (rng.randn(31) * 0.3).astype(np.float32)
    leaf = rng.randint(0, 31, 500)
    j, t = jnp.asarray(delta), torch.from_numpy(delta.copy())
    for k in (1, 2, 3, 1, 5, 7, 2):
        for final in (k / (k + 1.0), k / (k + 0.1)):
            j, t = j * final, t * final
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            for f in (-1.0, final, final - 1.0):
                np.testing.assert_array_equal(
                    (t * f)[torch.from_numpy(leaf)].numpy(),
                    np.asarray(jnp.take(j, jnp.asarray(leaf)) * f))


def test_init_fold_after_tree_zero_drops():
    """The init score (boost from average) is folded into the host tree 0
    only, as in the JAX package, so once tree 0 is dropped and scaled the
    model's prediction of the train rows parts from the train scores by
    init * (1 - the product of its factors) -- in both packages alike
    (ROADMAP section C)."""
    X, y = example(REG)
    y = y + 2.0         # an init score far from 0
    params = dict(BASE, objective="regression", drop_rate=0.9)
    with drops() as dropped:
        jb, tb, _ = train_both(params, (X, y), 4)
    assert any(0 in d for d in dropped["port"])
    init = tb._gbdt.init_scores[0]
    assert init == pytest.approx(jb._gbdt.init_scores[0]) and init > 1.0
    gap_t = tb.predict(X, raw_score=True) - tb._gbdt.scores.numpy()
    gap_j = jb.predict(X, raw_score=True) - np.asarray(jb._gbdt.scores)
    np.testing.assert_allclose(gap_t, gap_j, rtol=0, atol=1e-5)
    # host tree 0 holds (v + init) * F, its record v * F: F of tree 0
    t0 = tb._gbdt.models[0]
    d0 = float(tb._gbdt.device_trees[0]["delta"][0])
    F = (t0.leaf_value[0] - d0) / init
    assert F < 0.99
    np.testing.assert_allclose(gap_t, init * (F - 1.0), rtol=0, atol=1e-5)
