"""feature_fraction in the port against the JAX package (the data, paths
and tolerances of tests/test_torch_sampling_trees.py):

  * alone and with bagging, five trees;
  * ``reset_parameter`` through the callback, five trees:
    ``feature_fraction`` 0.7 -> 1.0 (the host feature mask follows the
    live config in both packages, back to all features) together with
    ``bagging_fraction`` 0.7 -> 0.5 (the fused draw keeps the fraction it
    was set up with, as JAX's compiled fused step does).
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from test_torch_sampling import _load
from test_torch_sampling_trees import _bag, check_case
from test_torch_train import _compare_with_ties
from torch_one_thread import one_torch_thread  # noqa: F401

CASES = {
    "feature_fraction": dict(feature_fraction=0.6),
    "feature_fraction_bagging": dict(feature_fraction=0.6,
                                     bagging_fraction=0.7, bagging_freq=1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_feature_fraction_trees_match_jax(case):
    assert check_case(CASES[case], "xla") is None


def test_reset_sampling_params_gives_jax_trees():
    X, y = _load()
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "min_data_in_leaf": 20, "feature_fraction": 0.7,
              "bagging_fraction": 0.7, "bagging_freq": 1}
    reset = dict(feature_fraction=[0.7, 0.7, 1.0, 1.0, 1.0],
                 bagging_fraction=[0.7, 0.7, 0.5, 0.5, 0.5])
    boosters = {}
    for name, mod, more in (("jax", lgb, {"tpu_frontier_k": 1,
                                          "tpu_megakernel": "xla"}),
                            ("port", lgt, {"device_type": "cpu"})):
        boosters[name] = mod.train(dict(params, **more),
                                   mod.Dataset(X, label=y), 5,
                                   callbacks=[mod.reset_parameter(**reset)])
        boosters[name].num_trees()
    jb, tb = boosters["jax"], boosters["port"]
    for k, v in reset.items():     # the reset reached both configs
        assert getattr(tb._gbdt.config, k) == getattr(jb._gbdt.config, k) \
            == v[-1]
    assert _compare_with_ties(X, y, "binary", params, jb, tb,
                              row_scale=_bag(params, y)) is None
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)
