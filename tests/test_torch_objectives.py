"""Each objective of the port against the JAX package's class, on the same
seeded numpy inputs, with and without row weights: gradients and
hessians (the port's ``gradients_from_payload``, or ``class_gradients``
for the multiclass objectives, against JAX's ``get_gradients``), the
boost-from-average init score of each class and ``convert_output``.

Tolerance: rtol 1e-6, and an atol of 1e-6 of the largest magnitude for
values that cancel to near zero (a few f32 ulps: the packages' ``exp``
and ``log1p`` differ in the last bits).  The init scores of the L1
family are percentiles of the labels, equal; the others come from f32
means summed in other orders, within rtol 1e-6 / atol 1e-6 (a mean's
last bit through a logit near 0).  One exception: cross_entropy_lambda's
hessian takes ``c - 1`` with ``c = 1 / (1 - z)``, which turns a 1-ulp
difference of ``exp`` into up to 4e-6 relative; it is held to rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu.config as jconfig
import lightgbm_tpu.dataset as jdataset
from lightgbm_tpu.models import objective as jobj

import lightgbm_tpu_torch.config as tconfig
import lightgbm_tpu_torch.dataset as tdataset
from lightgbm_tpu_torch.models import objective as tobj

N = 1500
POINTWISE = ["regression_l1", "huber", "fair", "poisson", "quantile", "mape",
             "gamma", "tweedie", "cross_entropy", "cross_entropy_lambda"]
PARAMS = {"quantile": {"alpha": 0.8}, "huber": {"alpha": 0.7},
          "fair": {"fair_c": 0.5}, "tweedie": {"tweedie_variance_power": 1.3},
          "poisson": {"poisson_max_delta_step": 0.5}}


def _labels(name, rng):
    if name in ("poisson", "gamma", "tweedie"):
        y = rng.gamma(2.0, 1.5, N)
        if name != "gamma":
            y[rng.rand(N) < 0.2] = 0.0
        return y
    if name.startswith("cross_entropy"):
        return np.clip(rng.rand(N) * 1.2 - 0.1, 0.0, 1.0)
    if name in ("multiclass", "multiclassova"):
        return rng.randint(0, 4, N).astype(np.float64)
    return rng.randn(N) * 3.0 + 1.0


def _pair(name, weighted, extra=None):
    rng = np.random.RandomState(7 + POINTWISE.index(name)
                                if name in POINTWISE else 3)
    y = _labels(name, rng)
    w = rng.uniform(0.2, 2.0, N) if weighted else None
    params = dict(PARAMS.get(name, {}), objective=name, **(extra or {}))
    objs = []
    for cfg_mod, ds_mod, mod in ((jconfig, jdataset, jobj),
                                 (tconfig, tdataset, tobj)):
        md = ds_mod.Metadata(N)
        md.set_label(y)
        md.set_weight(w)
        o = mod.create_objective(cfg_mod.Config(params))
        if mod is jobj:
            o.init(md)
        else:
            o.init(md, "cpu")
        objs.append(o)
    return rng, objs


def _close(got, want, rtol=1e-6):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = 1e-6 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", POINTWISE)
def test_pointwise_objective_matches_jax(name, weighted):
    rng, (jo, to) = _pair(name, weighted)
    score = (rng.randn(N) * 0.8).astype(np.float32)
    jg, jh = jo.get_gradients(score)
    payload = [p for _, p in to.payload()]
    assert [n for n, _ in to.payload()] == (
        ["label", "weight"] if weighted else ["label"])
    tg, th = to.gradients_from_payload(torch.from_numpy(score), *payload)
    assert tg.dtype == th.dtype == torch.float32
    _close(tg, jg)
    _close(th, jh, 1e-5 if name == "cross_entropy_lambda" else 1e-6)
    np.testing.assert_allclose(to.boost_from_score(0),
                               jo.boost_from_score(0), rtol=1e-6, atol=1e-6)
    if jo.is_renew_tree_output:
        assert to.boost_from_score(0) == jo.boost_from_score(0)
    raw = rng.randn(N)
    _close(to.convert_output(torch.from_numpy(raw)),
           jo.convert_output(raw))
    assert to.to_string() == name
    assert (to.renew_leaf_alpha is not None) == jo.is_renew_tree_output
    if jo.is_renew_tree_output:
        assert to.renew_leaf_alpha == jo.renew_leaf_alpha()
        want = (jo.renew_weights_from_payload(jo.label, jo.weight)
                if name == "mape" else jo.weight)
        got = to.renew_weights_from_payload(to.label, to.weight)
        if want is None:
            assert got is None
        else:
            _close(got, want)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ["multiclass", "multiclassova"])
def test_multiclass_objective_matches_jax(name, weighted):
    K = 4
    rng, (jo, to) = _pair(name, weighted, {"num_class": K})
    assert to.num_model_per_iteration == jo.num_model_per_iteration == K
    score = (rng.randn(N, K) * 0.8).astype(np.float32)
    jg, jh = jo.get_gradients(score)
    tg, th = to.class_gradients(torch.from_numpy(score.T.copy()))
    assert tuple(tg.shape) == (K, N)
    _close(tg.T, jg)
    _close(th.T, jh)
    for k in range(K):
        np.testing.assert_allclose(to.boost_from_score(k),
                                   jo.boost_from_score(k), rtol=1e-6,
                                   atol=1e-6)
    raw = rng.randn(N, K)
    _close(to.convert_output(torch.from_numpy(raw)), jo.convert_output(raw))
    assert to.to_string() == jo.to_string()


def test_weighted_percentile_host_matches_jax():
    rng = np.random.RandomState(5)
    for n in (1, 2, 3, 10, 101):
        v = rng.randn(n).astype(np.float32)
        for w in (None, rng.uniform(0.1, 3.0, n).astype(np.float32),
                  rng.randint(0, 3, n).astype(np.float32)):
            for alpha in (0.1, 0.5, 0.9):
                assert tobj.weighted_percentile_host(v, w, alpha) == \
                    jobj._weighted_percentile_host(v, w, alpha)


def _aliases(table_name):
    return sorted(getattr(tconfig, table_name))


@pytest.mark.parametrize("alias", _aliases("_OBJECTIVE_ALIASES"))
def test_objective_alias_resolves_as_jax(alias):
    """Each objective name and alias means what it means to the JAX
    package, and the port builds it."""
    params = {"objective": alias, "num_class": 3 if "multi" in alias
              or alias in ("softmax", "ova", "ovr") else 1}
    jc, tc = jconfig.Config(params), tconfig.Config(params)
    assert tc.objective == jc.objective
    tc.check_supported()
    o = tobj.create_objective(tc)
    want = jobj.create_objective(jc)
    assert (o is None) == (want is None)
    if o is not None:
        assert o.name == want.name


@pytest.mark.parametrize("alias", _aliases("_METRIC_ALIASES"))
def test_metric_alias_resolves_as_jax(alias):
    """Each metric alias names the JAX package's metric; the port builds
    every one."""
    from lightgbm_tpu.models import metric as jmetric
    from lightgbm_tpu_torch.models import metric as tmetric
    jc, tc = (m.Config({"metric": alias, "num_class": 3})
              for m in (jconfig, tconfig))
    assert tc.metric_list == jc.metric_list
    assert [m.name for m in tmetric.create_metrics(tc)] == \
        [m.name for m in jmetric.create_metrics(jc)]
