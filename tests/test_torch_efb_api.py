"""EFB bundles through the port's training API, against the JAX package
on the CPU: a validation set binned with the training set's bundles and
early stopping, and the knobs a bundled dataset overrides.  The data
and tolerances are tests/test_torch_efb.py's.
"""

import numpy as np

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from test_torch_efb import LABELS, X, _same_trees
from torch_one_thread import one_torch_thread  # noqa: F401


def test_validation_set_and_early_stopping_on_bundles():
    y = LABELS["binary"]
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "metric": "binary_logloss", "early_stopping_round": 3,
              "learning_rate": 0.6}
    out = {}
    for name, mod, extra in (("jax", lgb, {"tpu_frontier_k": 1}),
                             ("port", lgt, {"device_type": "cpu"})):
        d = mod.Dataset(X[:1600], label=y[:1600])
        v = mod.Dataset(X[1600:], label=y[1600:], reference=d)
        ev = {}
        b = mod.train(dict(params, **extra), d, 30, valid_sets=[v],
                      callbacks=[mod.record_evaluation(ev)])
        b.num_trees()
        out[name] = (b, ev)
    (jb, je), (tb, te) = out["jax"], out["port"]
    assert tb._gbdt.learner.bundled
    assert tb.best_iteration == jb.best_iteration > 0
    assert len(te["valid_0"]["binary_logloss"]) < 30
    _same_trees(jb, tb)
    for metric in je["valid_0"]:
        np.testing.assert_allclose(te["valid_0"][metric],
                                   je["valid_0"][metric], rtol=1e-5)


def test_megakernel_pallas_on_bundles_warns(capsys):
    y = LABELS["binary"]
    b = lgt.Booster({"objective": "binary", "device_type": "cpu",
                     "tpu_megakernel": "pallas", "tpu_frontier_k": 4},
                    lgt.Dataset(X, label=y))
    lr = b._gbdt.learner
    assert lr.subtract and lr.K == 1
    err = capsys.readouterr()
    text = err.out + err.err
    assert "tpu_megakernel=pallas" in text and "tpu_frontier_k=4" in text
