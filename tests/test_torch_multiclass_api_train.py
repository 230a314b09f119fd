"""The training API of the port with 5 classes against the JAX package
(its eager iteration) on examples/multiclass_classification, as
test_torch_multiclass_api.py sets out: a continued model
(``init_model``) and a custom objective (the softmax in numpy, as (N, 5) or class-major
N * 5 values) with ``feval`` on (N, 5) scores; and early stopping on
the validation set's multi_logloss against numpy float64."""

import os

import numpy as np

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

from test_torch_multiclass import K, mc_data
from test_torch_multiclass_api import BASE, CPU, JAX, ROOT, port2  # noqa
from torch_one_thread import one_torch_thread  # noqa: F401


def test_continued_training_matches_jax(port2):
    X, y, b = port2
    text = b.model_to_string()
    tb = lgt.train(dict(BASE, **CPU), lgt.Dataset(X, label=y), 2,
                   init_model=text)
    jb = lgb.train(dict(BASE, **JAX), lgb.Dataset(X, label=y), 2,
                   init_model=text)
    assert tb.num_trees() == jb.num_trees() == 4 * K
    assert tb.current_iteration == 4
    raw = tb.predict(X, raw_score=True)
    np.testing.assert_allclose(raw, jb.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)
    # the train scores carry the init model's prediction and the new trees
    np.testing.assert_allclose(tb._gbdt.scores.numpy(), raw, rtol=0,
                               atol=1e-5)


def test_early_stopping_on_multi_logloss():
    """Early stopping on the validation set's multi_logloss: every
    recorded value against a numpy float64 logloss of the model's
    prediction at that iteration (rtol 1e-6), the best iteration the
    first minimum, and training stopped ``early_stopping_round`` after
    it."""
    X, y = mc_data()
    d = np.loadtxt(os.path.join(ROOT, "examples", "multiclass_classification",
                                "multiclass.test"))
    Xv, yv = d[:, 1:], d[:, 0]
    params = dict(BASE, metric="multi_logloss,multi_error",
                  early_stopping_round=2, learning_rate=0.8,
                  first_metric_only=True, **CPU)
    res = {}
    ds = lgt.Dataset(X, label=y)
    tb = lgt.train(params, ds, 30, valid_sets=[ds.create_valid(Xv, label=yv)],
                   callbacks=[lgt.record_evaluation(res)])
    got = np.asarray(res["valid_0"]["multi_logloss"])
    n = len(got)
    assert 2 < n < 30 and tb.current_iteration == n
    want = []
    for i in range(1, n + 1):
        p = tb.predict(Xv, num_iteration=i)
        want.append(-np.mean(np.log(np.maximum(
            p[np.arange(len(yv)), yv.astype(int)], 1e-15))))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert tb.best_iteration == int(np.argmin(got)) + 1 == n - 2
    assert tb.best_score["valid_0"]["multi_logloss"] == got.min()
    # the validation scores are the model's raw prediction
    np.testing.assert_allclose(tb._gbdt.valid_score(0).numpy(),
                               tb.predict(Xv, raw_score=True,
                                          num_iteration=-1), rtol=0,
                               atol=1e-5)


def _softmax_obj(flat):
    def fobj(score, dataset):
        assert score.shape == (dataset.num_data(), K)
        e = np.exp(score - score.max(1, keepdims=True))
        p = e / e.sum(1, keepdims=True)
        Y = np.eye(K)[dataset.get_label().astype(int)]
        g, h = p - Y, K / (K - 1.0) * p * (1.0 - p)
        if flat:
            return g.T.reshape(-1), h.T.reshape(-1)
        return g, h
    return fobj


def test_custom_objective_and_feval_shapes():
    X, y = mc_data()
    seen = []

    def feval(score, dataset):
        seen.append(score.shape)
        return "top_class_error", float(np.mean(score.argmax(1) != y)), False

    # seeded init scores keep the first iteration clear of ties
    init = np.random.RandomState(4).randn(K * len(y)) * 0.5
    params = dict(BASE, objective=_softmax_obj(True), **CPU)
    flat = lgt.train(params, (ds := lgt.Dataset(X, label=y,
                                                init_score=init)), 2,
                     valid_sets=[ds], feval=feval)
    assert seen and all(s == (len(y), K) for s in seen)
    square = lgt.train(dict(params, objective=_softmax_obj(False)),
                       lgt.Dataset(X, label=y, init_score=init), 2)
    np.testing.assert_array_equal(flat.predict(X, raw_score=True),
                                  square.predict(X, raw_score=True))
    jb = lgb.train(dict(BASE, objective=_softmax_obj(False), **JAX),
                   lgb.Dataset(X, label=y, init_score=init), 2)
    np.testing.assert_allclose(flat.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)
    # the built-in objective grows the same first iteration
    builtin = lgt.train(dict(BASE, **CPU),
                        lgt.Dataset(X, label=y, init_score=init), 1)
    np.testing.assert_allclose(flat.predict(X, raw_score=True,
                                            num_iteration=1),
                               builtin.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)
