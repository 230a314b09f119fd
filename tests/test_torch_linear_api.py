"""Linear trees through the training API, the port (``device_type``
cpu) against the JAX package: validation sets with early stopping,
``rollback_one_iter``, and the model text (exact round trip, the dict
form, the host oracle); ``init_model`` is in
test_torch_linear_degenerate.py.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

from torch_boost_cases import BIN, BIN_TEST, BODIES, REG, REG_TEST, example
from torch_one_thread import one_torch_thread  # noqa: F401

LINEAR = {"num_leaves": 15, "linear_tree": True}
CPU = {"device_type": "cpu", "verbosity": -1}


@pytest.mark.parametrize("body", ["mega", "sub"])
def test_valid_sets_and_early_stopping(body):
    """A validation set's scores gain each tree's linear outputs of its
    own raw rows; early stopping stops where JAX's does, the histories
    within rtol 1e-5."""
    params = dict(LINEAR, objective="binary", metric="binary_logloss",
                  learning_rate=0.6, early_stopping_round=2,
                  **BODIES[body])
    out = {}
    for name, mod, extra in (("jax", lgb, {"verbosity": -1}),
                             ("port", lgt, CPU)):
        X, y = example(BIN)
        Xv, yv = example(BIN_TEST)
        dt = mod.Dataset(X, label=y)
        hist = {}
        b = mod.train(dict(params, **extra), dt, 25,
                      valid_sets=[mod.Dataset(Xv, label=yv, reference=dt)],
                      callbacks=[mod.record_evaluation(hist)])
        out[name] = (b, hist)
    (jb, jh), (tb, th) = out["jax"], out["port"]
    assert tb.best_iteration == jb.best_iteration
    key = list(jh)[0]
    np.testing.assert_allclose(th[key]["binary_logloss"],
                               jh[key]["binary_logloss"], rtol=1e-5)
    Xv = example(BIN_TEST)[0]
    np.testing.assert_allclose(tb._gbdt.valid_score(0).numpy(),
                               tb.predict(Xv, raw_score=True,
                                          num_iteration=len(tb._gbdt.models)),
                               rtol=0, atol=1e-5)


def test_rollback_one_iter():
    """5 iterations less 2 roll the train and validation scores back to
    3 iterations' (1e-6), the first tree's folded init score taken out,
    and the trees are the 3-iteration run's."""
    X, y = example(REG)
    Xv, yv = example(REG_TEST)
    params = dict(LINEAR, objective="regression", **CPU)
    boosters = []
    for rounds in (5, 3):
        dt = lgt.Dataset(X, label=y)
        b = lgt.train(params, dt, rounds,
                      valid_sets=[lgt.Dataset(Xv, label=yv, reference=dt)])
        boosters.append(b)
    b5, b3 = boosters
    b5.rollback_one_iter().rollback_one_iter()
    g5, g3 = b5._gbdt, b3._gbdt
    assert g5.init_scores[0] != 0.0
    assert len(g5.models) == 3
    np.testing.assert_allclose(g5.scores.numpy(), g3.scores.numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(g5.valid_score(0).numpy(),
                               g3.valid_score(0).numpy(), rtol=0, atol=1e-6)
    for a, b in zip(g5.models, g3.models):
        np.testing.assert_array_equal(a.leaf_const, b.leaf_const)
    # and training goes on from there as the 3-iteration booster does
    b5.update()
    b3.update()
    np.testing.assert_allclose(b5.predict(X, raw_score=True),
                               b3.predict(X, raw_score=True), rtol=0,
                               atol=1e-6)


def test_model_text_round_trip_is_exact():
    """The port's linear model text reloads and predicts bit for bit, and
    its dict form carries each leaf's model."""
    X, y = example(REG)
    tb = lgt.train(dict(LINEAR, objective="regression", **CPU),
                   lgt.Dataset(X, label=y), 3)
    text = tb.model_to_string()
    assert "is_linear=1" in text and "leaf_coeff=" in text
    back = lgt.Booster(model_str=text, params={"device_type": "cpu"})
    np.testing.assert_array_equal(back.predict(X, raw_score=True),
                                  tb.predict(X, raw_score=True))
    # the trees' text (a loaded model keeps no feature_infos)
    assert (back.model_to_string().split("tree_sizes=")[1]
            == text.split("tree_sizes=")[1])
    t = tb._gbdt.models[1]
    d = t.to_json()["tree_structure"]
    while "leaf_index" not in d:
        d = d["left_child"]
    leaf = d["leaf_index"]
    assert d["leaf_features"] == t.leaf_features[leaf]
    assert d["leaf_coeff"] == t.leaf_coeff[leaf]
    # the host oracle of the device walk agrees
    np.testing.assert_allclose(
        sum(m.predict(X) for m in tb._gbdt.models),
        tb.predict(X, raw_score=True), rtol=0, atol=1e-12)
