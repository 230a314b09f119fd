"""``Booster.rollback_one_iter`` and the train walk it runs on.

The rollback (JAX boosting.py ``rollback_one_iter``) walks the last
iteration's trees over the learner's live physical bin matrix -- the
order payload row 3 holds after the latest tree, the frontier's undo
and the partition included -- and over the validation sets, and takes
their f32 shrunk values out of the scores.  Held against the JAX package
after the same calls (``examples/binary_classification`` with
``binary.test`` as a validation set, 15 leaves, on every body, 4
iterations, 2 rolled back, 2 more; 3 classes with a seeded init score, 2,
1 and 1): the train and validation scores (atol 1e-5),
the model and the trees grown after it.  An init model's trees stay, with
JAX's warning.  Inside DART a rollback also takes the last tree weight
out, and the drops after it stay JAX's.  The walk itself, on data whose
learner groups bundles (EFB), holds a categorical feature or keeps
uint16 bins, finds every past tree's leaf of every train row as
``predict(pred_leaf=True)`` does.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.utils import log as jlog
from lightgbm_tpu_torch.ops.predict import predict_leaf_binned_t
from lightgbm_tpu_torch.utils import log as tlog

from test_torch_multiclass import mc_data
from torch_boost_cases import BIN, BIN_TEST, BODIES, drops, example
from torch_one_thread import one_torch_thread  # noqa: F401

PARAMS = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
          "metric": "binary_logloss"}
DART_BASE = {"boosting": "dart", "num_leaves": 15, "drop_rate": 0.5,
             "skip_drop": 0.0}


def _steps(mod, params, X, y, valid=None, init_score=None, n=4, back=2):
    """``n`` iterations, ``back`` rollbacks, ``back`` iterations; the
    booster and its (train, valid) scores after the rollbacks."""
    dt = mod.Dataset(X, label=y, init_score=init_score)
    b = mod.Booster(params, dt)
    if valid is not None:
        b.add_valid(mod.Dataset(*valid, reference=dt), "v")
    for _ in range(n):
        b.update()
    for _ in range(back):
        b.rollback_one_iter()
    g = b._gbdt
    after = (np.array(g.scores), [np.array(v) for v in g.valid_scores])
    assert b.current_iteration == n - back
    assert b.num_trees() == (n - back) * b.num_model_per_iteration()
    for _ in range(back):
        b.update()
    return b, after


@pytest.fixture(scope="module")
def jax_binary():
    X, y = example(BIN)
    return _steps(lgb, PARAMS, X, y, valid=example(BIN_TEST))


@pytest.mark.parametrize("body", list(BODIES))
def test_rollback_with_a_validation_set_matches_jax(body, jax_binary):
    X, y = example(BIN)
    tb, (ts, tv) = _steps(lgt, dict(PARAMS, device_type="cpu",
                                    **BODIES[body]), X, y,
                          valid=example(BIN_TEST))
    jb, (js, jv) = jax_binary
    assert len(tb._gbdt.device_trees) == 4
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv[0], jv[0], rtol=0, atol=1e-5)
    for a, b in zip(jb._gbdt.models, tb._gbdt.models):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold, b.threshold)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(tb._gbdt.valid_score(0).numpy(),
                               np.asarray(jb._gbdt.valid_scores[0]), rtol=0,
                               atol=1e-5)
    (_, _, v, _), = tb.eval_valid()
    (_, _, vj, _), = jb.eval_valid()
    np.testing.assert_allclose(v, vj, rtol=1e-6)


def test_rollback_of_class_trees_matches_jax():
    """3 classes: an iteration's 3 class trees leave together."""
    X, y = mc_data(3)
    init = np.random.RandomState(4).randn(3 * len(y)) * 0.5
    params = {"objective": "multiclass", "num_class": 3, "num_leaves": 15,
              "verbosity": -1}
    jb, (js, _) = _steps(lgb, params, X, y, init_score=init, n=2, back=1)
    tb, (ts, _) = _steps(lgt, dict(params, device_type="cpu"), X, y,
                         init_score=init, n=2, back=1)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
    assert tb.num_trees() == jb.num_trees() == 6
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)


def test_rollback_stops_at_the_init_model():
    """Continued from a model of 2 iterations: one iteration rolls back,
    the next call warns as JAX does and leaves the model and scores."""
    X, y = example(BIN)
    init = lgb.train(PARAMS, lgb.Dataset(X, label=y), 2).model_to_string()
    for mod, log, extra in ((lgb, jlog, {}),
                            (lgt, tlog, {"device_type": "cpu"})):
        b = mod.train(dict(PARAMS, **extra), mod.Dataset(X, label=y), 1,
                      init_model=init)
        b.rollback_one_iter()
        before = np.array(b._gbdt.scores)
        lines = []
        log.register_callback(lines.append)
        log.set_verbosity(0)
        try:
            b.rollback_one_iter()
        finally:
            log.register_callback(None)
            log.set_verbosity(-1)
        assert any("init_model boundary" in ln for ln in lines)
        assert b.current_iteration == 2 and b.num_trees() == 2
        np.testing.assert_array_equal(np.array(b._gbdt.scores), before)


def test_rollback_inside_dart():
    """Four DART iterations, one rolled back, two more: the drops, tree
    weights, scores and trees equal JAX's after the same calls."""
    X, y = example(BIN)
    params = dict(DART_BASE, objective="binary", verbosity=-1)
    out = {}
    with drops() as dropped:
        for name, mod, extra in (("jax", lgb, {}),
                                 ("port", lgt, {"device_type": "cpu"})):
            b = mod.Booster(dict(params, **extra), mod.Dataset(X, label=y))
            for _ in range(4):
                b.update()
            w = list(b._gbdt.tree_weights)
            b.rollback_one_iter()
            assert b._gbdt.tree_weights == w[:-1]
            for _ in range(2):
                b.update()
            out[name] = b
    jb, tb = out["jax"], out["port"]
    assert dropped["port"] == dropped["jax"]
    assert tb.current_iteration == jb.current_iteration == 5
    assert tb._gbdt.tree_weights == jb._gbdt.tree_weights
    np.testing.assert_allclose(tb._gbdt.scores.numpy(),
                               np.asarray(jb._gbdt.scores), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)


def _walk_data(kind):
    """(X, y, Dataset kwargs, params) of a learner with bundles, a
    categorical feature or uint16 bins."""
    X, y = example(BIN)
    rng = np.random.RandomState(0)
    if kind == "efb":
        X = np.hstack([X, np.eye(6)[rng.randint(0, 6, len(y))]])
        return X, y, {}, {}
    if kind == "categorical":
        X = np.column_stack([X, rng.randint(0, 9, len(y))])
        return X, y, {"categorical_feature": [X.shape[1] - 1]}, {}
    return X, y, {}, {"max_bin": 1023} if kind == "uint16" else {}


@pytest.mark.parametrize("kind,body", [("efb", "sub"),
                                       ("categorical", "sub"),
                                       ("uint16", "sub"), ("plain", "k4")])
def test_train_walk_finds_every_past_trees_leaves(kind, body):
    """After 4 iterations, each past tree walked over the live physical
    bin matrix gives each row (by its id in payload row 2) the leaf of
    ``predict(pred_leaf=True)``."""
    X, y, ds_kw, extra = _walk_data(kind)
    b = lgt.train(dict(PARAMS, device_type="cpu", **BODIES[body], **extra),
                  lgt.Dataset(X, label=y, **ds_kw), 4)
    g = b._gbdt
    lr = g.learner
    assert {"efb": lr.bundled, "categorical": lr.has_cat,
            "uint16": lr.bin_dtype == np.uint16,
            "plain": lr.K == 4}[kind]
    pb, ghi = g._phys
    C, N = lr.row0, g.num_data
    rowid = ghi[2, C:C + N].view(torch.int32).long().numpy()
    want = b.predict(X, pred_leaf=True)
    for t, dt in enumerate(g.device_trees):
        leaf = predict_leaf_binned_t(pb[:, C:C + N], dt["node"])
        np.testing.assert_array_equal(leaf.numpy(), want[rowid, t])
