"""Quantized-gradient training's options and objectives against the JAX
package, held split for split (test_torch_quantized_trees.py
``compare``): a weighted L2 with ``quant_train_renew_leaf`` fills
payload rows 6 and 7, so ``tpu_frontier_k=4`` falls back to K=1 there
(the frontier's row keys need row 7) and still grows JAX's trees;
``stochastic_rounding`` false with 16 quantization bins, whose
parameters ride the model text into the JAX package; Huber, whose
gradients the JAX package does not fuse (the port draws as JAX's eager
iteration, ``reference_fused``), with bagging.
"""

import numpy as np

import lightgbm_tpu as lgb
from test_torch_quantized_trees import check, example, train_jax, train_port
from torch_one_thread import one_torch_thread  # noqa: F401


def test_weighted_renewal_takes_k1_and_matches_jax():
    X, y = example("regression/regression.train")
    w = np.random.RandomState(0).uniform(0.5, 2.0, len(y))
    params = {"objective": "regression", "quant_train_renew_leaf": True}
    jb = train_jax(X, y, params, weight=w)
    tb, rec = train_port(X, y, dict(params, tpu_frontier_k=4), weight=w)
    assert tb._gbdt._renew_rows == (6, 7)
    assert tb._gbdt.learner.K == 1
    check(X, jb, tb, rec, params)


def test_round_to_nearest_with_16_bins_matches_jax():
    X, y = example("regression/regression.train")
    params = {"objective": "regression", "stochastic_rounding": False,
              "num_grad_quant_bins": 16}
    jb = train_jax(X, y, params)
    tb, rec = train_port(X, y, params)
    g = rec[0][0] / np.abs(rec[0][0]).max() * 8
    assert np.allclose(g, np.round(g)) and np.abs(g).max() == 8
    check(X, jb, tb, rec, params)
    # the quantization parameters ride the model text both ways
    text = tb.model_to_string()
    for line in ("[use_quantized_grad: 1]", "[num_grad_quant_bins: 16]",
                 "[stochastic_rounding: 0]"):
        assert line in text and line in jb.model_to_string()
    cfg = lgb.Booster(model_str=text).config
    assert cfg.use_quantized_grad and cfg.num_grad_quant_bins == 16
    assert not cfg.stochastic_rounding


def test_huber_draws_as_the_eager_iteration_and_matches_jax():
    X, y = example("regression/regression.train")
    params = {"objective": "huber", "bagging_fraction": 0.7,
              "bagging_freq": 2}
    jb = train_jax(X, y, params)
    tb, rec = train_port(X, y, params)
    assert tb._gbdt._eager_quant
    counts = [t.internal_count[0] for t in tb._gbdt.models]
    assert counts == [int(len(y) * 0.7)] * len(counts)
    check(X, jb, tb, rec, params)
