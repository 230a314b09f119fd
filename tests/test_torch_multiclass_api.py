"""The training API of the port with 5 classes, on the CPU, against the
JAX package and numpy float64 oracles (examples/multiclass_classification,
15 leaves):

  * predict: (N, 5) raw and converted scores, (N, iterations * 5) leaf
    indices, slices by iteration; the host trees' sums and leaves;
  * model text both ways (port -> JAX and JAX -> port: equal raw
    predictions to 1e-9, converted ones to 1e-5, as JAX converts in f32);
  * ``auc_mu`` (``auc_mu_weights``) and ``multi_error``
    (``multi_error_top_k``), with row weights, against numpy float64 by
    their definitions (rtol 1e-6: the projections of f32 scores tie in
    exact arithmetic but not always in f64);
  * every combination the port refuses raises NotImplementedError
    naming its parameters.

test_torch_multiclass_api_train.py holds continued training, early
stopping and custom objectives.  Tolerances as in test_torch_multiclass.py: raw predictions atol 1e-5,
metrics rtol 1e-6.  The JAX runs take its eager iteration
(``tpu_fused_iteration=false``).
"""

import os

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.utils.log import LightGBMError

from test_torch_multiclass import K, mc_data
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = {"objective": "multiclass", "num_class": K, "num_leaves": 15,
        "min_data_in_leaf": 20, "verbosity": -1}
JAX = {"tpu_megakernel": "xla", "tpu_frontier_k": 1,
       "tpu_fused_iteration": False}
CPU = {"device_type": "cpu"}


@pytest.fixture(scope="module")
def port2():
    X, y = mc_data()
    return X, y, lgt.train(dict(BASE, **CPU), lgt.Dataset(X, label=y), 2)


def test_predict_shapes_and_slices(port2):
    X, y, b = port2
    models = b._gbdt.models
    raw = b.predict(X, raw_score=True)
    assert raw.shape == (len(y), K)
    host = np.stack([sum(models[i * K + k].predict(X) for i in range(2))
                     for k in range(K)], 1)
    np.testing.assert_array_equal(raw, host)
    prob = b.predict(X)
    e = np.exp(raw - raw.max(1, keepdims=True))
    np.testing.assert_allclose(prob, e / e.sum(1, keepdims=True), rtol=1e-12)
    leaves = b.predict(X, pred_leaf=True)
    assert leaves.shape == (len(y), 2 * K)
    np.testing.assert_array_equal(
        leaves, np.stack([t.predict_leaf(X) for t in models], 1))
    # iterations, not trees: the second iteration alone
    second = b.predict(X, raw_score=True, start_iteration=1, num_iteration=1)
    np.testing.assert_array_equal(second, np.stack(
        [models[K + k].predict(X) for k in range(K)], 1))
    assert b.predict(X, pred_leaf=True, start_iteration=1).shape == \
        (len(y), K)
    assert b.num_model_per_iteration() == K
    assert b.current_iteration == 2 and b.num_trees() == 2 * K
    text = b.model_to_string(num_iteration=1)
    assert "num_tree_per_iteration=5" in text and "Tree=5" not in text


def test_model_text_both_ways(port2, tmp_path):
    X, y, b = port2
    path = tmp_path / "mc.txt"
    b.save_model(str(path))
    text = path.read_text()
    assert "objective=multiclass num_class:5" in text
    j_from_t = lgb.Booster(model_file=str(path))
    np.testing.assert_allclose(j_from_t.predict(X, raw_score=True),
                               b.predict(X, raw_score=True), rtol=0,
                               atol=1e-9)
    jb = lgb.train(dict(BASE, objective="multiclassova", **JAX),
                   lgb.Dataset(X, label=y), 2)
    t_from_j = convert.booster_from_model_string(jb.model_to_string(), CPU)
    assert t_from_j._gbdt.num_tree_per_iteration == K
    np.testing.assert_allclose(t_from_j.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=1e-9)
    # JAX converts in f32, the port in f64
    np.testing.assert_allclose(t_from_j.predict(X), jb.predict(X), rtol=0,
                               atol=1e-5)
    again = lgt.Booster(params=CPU, model_file=str(path))
    np.testing.assert_array_equal(again.predict(X, raw_score=True),
                                  b.predict(X, raw_score=True))


def _auc_mu64(score, y, w, W):
    """AUC-mu by its definition: for each class pair (i, j), the
    weighted share of (row of i, row of j) pairs ordered right by the
    projection on W[i] - W[j], ties half."""
    total = 0.0
    for i in range(K):
        for j in range(i + 1, K):
            v = W[i] - W[j]
            si = (score[y == i] @ v) * (v[i] - v[j])
            sj = (score[y == j] @ v) * (v[i] - v[j])
            wi, wj = w[y == i], w[y == j]
            d = si[:, None] - sj[None, :]
            win = (d > 0) + 0.5 * (d == 0)
            total += (wi[:, None] * wj[None, :] * win).sum() / (
                wi.sum() * wj.sum())
    return 2.0 * total / (K * (K - 1))


@pytest.mark.parametrize("top_k", [1, 2])
def test_auc_mu_and_multi_error_against_numpy(port2, top_k):
    X, y, b = port2
    w = np.random.RandomState(2).uniform(0.5, 2.0, len(y))
    W = np.random.RandomState(3).uniform(0.5, 1.5, (K, K))
    np.fill_diagonal(W, 0.0)
    spec = ",".join(repr(float(v)) for v in W.reshape(-1))
    bw = lgt.Booster(dict(BASE, metric="auc_mu,multi_error",
                          auc_mu_weights=spec, multi_error_top_k=top_k,
                          **CPU), lgt.Dataset(X, label=y, weight=w))
    bw.update()
    score = bw._gbdt.scores.numpy().astype(np.float64)
    got = dict((name, val) for _, name, val, _ in bw.eval_train())
    np.testing.assert_allclose(got["auc_mu"], _auc_mu64(score, y, w, W),
                               rtol=1e-6)
    true = score[np.arange(len(y)), y.astype(int)]
    err = ((score > true[:, None]).sum(1) >= top_k).astype(np.float64)
    np.testing.assert_allclose(got["multi_error"],
                               (err * w).sum() / w.sum(), rtol=1e-6)


# DART with linear trees is refused by the engine, as the JAX package's
# DART refuses it (LightGBMError); rank_xendcg with linear trees trains
# (tests/test_torch_linear_boost.py)
@pytest.mark.parametrize("extra,names", [
    ({"objective": "quantile", "monotone_constraints": [1],
      "monotone_constraints_method": "advanced"},
     ("monotone_constraints_method",)),
    ({"objective": "regression_l1", "boosting": "goss",
      "cegb_penalty_split": 0.5}, ("cegb_penalty_split",)),
    ({"objective": "regression", "num_class": 3}, ("num_class", "objective")),
    ({"objective": "multiclass", "num_class": 1}, ("num_class", "objective")),
    ({"objective": "lambdarank", "boosting": "dart", "linear_tree": True,
      "num_class": 1}, ("linear tree", "DART")),
    ({"objective": "rank_xendcg", "path_smooth": 1.0}, ("path_smooth",))])
def test_refused_combinations_name_their_params(extra, names):
    X, y = mc_data()
    error = (LightGBMError if extra.get("boosting") == "dart"
             else NotImplementedError)
    with pytest.raises(error) as err:
        lgt.train(dict(BASE, **dict(extra, **CPU)), lgt.Dataset(X, label=y),
                  1)
    for n in names:
        assert n in str(err.value)
