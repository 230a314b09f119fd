"""Random forest (``boosting=rf``) end to end: ``lightgbm_tpu_torch.train``
(``device_type`` cpu) against the JAX package on ``examples/*``, 15
leaves, a few iterations, with bagging and ``feature_fraction``, on the
mega body (K=1 and the frontier at K=4) and the histogram-subtraction
body.

Every tree grows at shrinkage 1 from the gradients at the init score,
each iteration on its own eager bag; the trees are held split for split
with the repo's tie rule (tests/torch_boost_cases.py ``compare``).  At
the init score binary has two gradient values and 5-class multiclass one
per class and label, so both meet exact ties (at binary's second tree,
multiclass's first).  The train scores are the running sum, as the JAX
package keeps them, and the metrics read them as JAX's do.  Predictions
average the iterations taken (``start_iteration`` / ``num_iteration``
honoured), with the init score folded into the first tree only, as in
the JAX package (ROADMAP section C); the model text carries
``average_output`` both ways; an init model and an RF without bagging or
``feature_fraction`` are refused as JAX refuses them.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.utils.log import LightGBMError as JaxLightGBMError
from lightgbm_tpu_torch.utils.log import LightGBMError

from test_torch_multiclass import mc_data
from torch_boost_cases import BIN, BODIES, REG, check, example, train_both
from torch_one_thread import one_torch_thread  # noqa: F401

ROUNDS = 5
BASE = {"boosting": "rf", "num_leaves": 15, "bagging_fraction": 0.632,
        "bagging_freq": 1}
# case: (data, params, body, tie)
CASES = {
    "regression-mega": (REG, {"objective": "regression"}, "mega", None),
    "binary-feature_fraction-sub": (BIN, {"objective": "binary",
                                          "feature_fraction": 0.8},
                                    "sub", (1, 12)),
    "multiclass-k4": ("mc", {"objective": "multiclass", "num_class": 5},
                      "k4", (0, 5)),
}


@pytest.fixture(scope="module")
def runs():
    return {}


def _run(case, runs):
    if case not in runs:
        data, extra, body, _ = CASES[case]
        params = dict(BASE, **extra, **BODIES[body])
        if data == "mc":
            data = mc_data()
        runs[case] = (params, data) + train_both(params, data, ROUNDS)
    return runs[case]


@pytest.mark.parametrize("case", list(CASES))
def test_rf_trees_match_jax(case, runs):
    params, data, jb, tb, rec = _run(case, runs)
    X = example(data)[0] if isinstance(data, str) else data[0]
    jg, tg = jb._gbdt, tb._gbdt
    assert type(tg).__name__ == "RF" and tg._eager and tg.average_output
    assert tg.shrinkage_rate == 1.0
    # one eager bag an iteration, an exact count
    n = len(X)
    assert [t.internal_count[0] for t in tg.models
            if t.num_leaves > 1] == [int(n * 0.632)] * sum(
                t.num_leaves > 1 for t in tg.models)
    check(X, jb, tb, rec, params, CASES[case][3])
    if CASES[case][3] is not None:
        return
    np.testing.assert_allclose(tg.scores.numpy(), np.asarray(jg.scores),
                               rtol=1e-6, atol=1e-5)
    for (_, m, v, _), (_, mj, vj, _) in zip(tb.eval_train(),
                                            jb.eval_train()):
        assert m == mj
        np.testing.assert_allclose(v, vj, rtol=1e-5)


@pytest.mark.parametrize("start,num", [(0, -1), (1, 2), (3, 0)])
def test_average_over_the_iterations_taken(start, num, runs):
    """Raw predictions of iterations [start, start + num) are their
    trees' mean, as JAX's; converted ones the objective's transform of
    that mean."""
    _, _, jb, tb, _ = _run("regression-mega", runs)
    X, _ = example(REG)
    pt = tb.predict(X, start_iteration=start, num_iteration=num)
    pj = jb.predict(X, start_iteration=start, num_iteration=num)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
    trees = tb._gbdt.models[start:(ROUNDS if num <= 0 else start + num)]
    want = np.mean([t.predict(X) for t in trees], axis=0)
    np.testing.assert_allclose(pt, want, rtol=1e-12, atol=1e-12)
    bb = _run("binary-feature_fraction-sub", runs)[3]
    Xb, _ = example(BIN)
    raw = bb.predict(Xb, start_iteration=start, num_iteration=num,
                     raw_score=True)
    np.testing.assert_allclose(
        bb.predict(Xb, start_iteration=start, num_iteration=num),
        1.0 / (1.0 + np.exp(-raw)), rtol=1e-6)


def test_model_text_both_ways(runs):
    """The ``average_output`` line rides the model text: a port model
    loads in the JAX package and a JAX model in the port, each averaging
    as the booster that wrote it."""
    _, _, jb, tb, _ = _run("regression-mega", runs)
    X, _ = example(REG)
    text = tb.model_to_string()
    assert "\naverage_output\n" in text
    assert "\naverage_output\n" in jb.model_to_string()
    port_in_jax = lgb.Booster(model_str=text)
    assert port_in_jax._gbdt.average_output
    np.testing.assert_allclose(port_in_jax.predict(X),
                               tb.predict(X), rtol=0, atol=1e-5)
    jax_in_port = lgt.Booster(model_str=jb.model_to_string(),
                              params={"device_type": "cpu"})
    assert jax_in_port._gbdt.average_output
    np.testing.assert_allclose(jax_in_port.predict(X), jb.predict(X),
                               rtol=0, atol=1e-5)
    again = lgt.Booster(model_str=text, params={"device_type": "cpu"})
    np.testing.assert_array_equal(again.predict(X), tb.predict(X))


def test_init_model_refused(runs):
    """RF does not continue a model: ValueError in both packages."""
    _, _, jb, tb, _ = _run("regression-mega", runs)
    X, y = example(REG)
    for mod, extra, init in ((lgb, {}, jb), (lgt, {"device_type": "cpu"},
                                             tb)):
        with pytest.raises(ValueError, match="boosting=rf"):
            mod.train(dict(BASE, objective="regression", verbosity=-1,
                           **extra), mod.Dataset(X, label=y), 1,
                      init_model=init.model_to_string())


def test_rf_needs_bagging_or_feature_fraction():
    """Without bagging and at ``feature_fraction`` 1, RF raises
    LightGBMError as JAX's does."""
    X, y = example(REG)
    params = {"boosting": "rf", "objective": "regression", "verbosity": -1}
    with pytest.raises(JaxLightGBMError, match="Random forest"):
        lgb.train(params, lgb.Dataset(X, label=y), 1)
    with pytest.raises(LightGBMError, match="Random forest"):
        lgt.train(dict(params, device_type="cpu"), lgt.Dataset(X, label=y),
                  1)
    # feature_fraction < 1 alone is enough
    tb = lgt.train(dict(params, feature_fraction=0.5, device_type="cpu"),
                   lgt.Dataset(X, label=y), 2)
    assert tb.num_trees() == 2


def test_init_score_in_the_first_tree_only():
    """The boost-from-average init is folded into tree 0 alone, so the
    averaged prediction is init / n plus the trees' mean, and the train
    scores init plus their sum -- in both packages alike (ROADMAP
    section C; the reference adds the init to every RF tree)."""
    X, y = example(REG)
    y = y + 2.0         # an init score far from 0
    params = dict(BASE, objective="regression")
    jb, tb, _ = train_both(params, (X, y), 3)
    init = tb._gbdt.init_scores[0]
    assert init == pytest.approx(jb._gbdt.init_scores[0]) and init > 1.0
    own = sum(t.predict(X) for t in tb._gbdt.models) - init
    np.testing.assert_allclose(tb.predict(X), (init + own) / 3, rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(tb._gbdt.scores.numpy(), init + own, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tb._gbdt.scores.numpy(),
                               np.asarray(jb._gbdt.scores), rtol=0, atol=1e-5)
