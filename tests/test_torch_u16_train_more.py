"""Wide bins end to end, continued (test_torch_u16_train.py states the
bar): ``max_bin_by_feature`` mixing 63, 255 and 1023, and one 5-class
softmax run with a uint16 matrix (examples/multiclass_classification at
``max_bin`` 1023, a seeded ``init_score`` so the first iteration meets
no exact tie, as tests/test_torch_multiclass.py's ``softmax_init``):
its 15 class trees by the tie walk, raw and converted predictions to
atol 1e-5.
"""

import numpy as np

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

from test_torch_multiclass import class_grads, mc_data
from test_torch_objectives_train import walk_ties
from test_torch_u16_train import example, train_and_check
from torch_one_thread import one_torch_thread  # noqa: F401


def test_max_bin_by_feature_trains_as_jax():
    X, y = example("regression/regression.train")
    mbbf = ",".join(["63", "255", "1023"] * (X.shape[1] // 3 + 1))
    tb = train_and_check(X, y, {"objective": "regression",
                                "max_bin_by_feature": mbbf})
    nb = [bm.num_bin for bm in tb._gbdt.learner.ds.bin_mappers]
    assert max(nb[0::3]) <= 63 and max(nb[1::3]) <= 255
    assert max(nb[2::3]) > 256


def test_multiclass_with_a_u16_matrix_trains_as_jax():
    X, y = mc_data()
    init = np.random.RandomState(4).randn(5 * len(y)) * 0.5
    params = {"objective": "multiclass", "num_class": 5, "num_leaves": 15,
              "min_data_in_leaf": 20, "verbosity": -1, "max_bin": 1023}
    jb = lgb.train(dict(params, tpu_megakernel="xla", tpu_frontier_k=1,
                        tpu_fused_iteration=False),
                   lgb.Dataset(X, label=y, init_score=init),
                   num_boost_round=3)
    tb = lgt.train(dict(params, device_type="cpu"),
                   lgt.Dataset(X, label=y, init_score=init),
                   num_boost_round=3)
    assert tb._gbdt.learner.bin_dtype == np.uint16
    assert tb.num_trees() == jb.num_trees() == 15
    assert walk_ties(X, y, None, jb, tb, params,
                     class_grads("multiclass", y), init) is None
    for raw in (True, False):
        got, want = (b.predict(X, raw_score=raw) for b in (tb, jb))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    back = lgt.Booster(model_str=tb.model_to_string(),
                       params={"device_type": "cpu"})
    np.testing.assert_array_equal(back.predict(X, raw_score=True),
                                  tb.predict(X, raw_score=True))
