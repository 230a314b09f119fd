"""``enable_bundle=false`` on the data of tests/test_torch_efb.py: no
bundles, the port's mega path, JAX's unbundled trees (that file's
tolerances).  A file of its own so that neither file takes much more
than 10 s.
"""

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from test_torch_efb import LABELS, ROUNDS, X, _same_trees
from torch_one_thread import one_torch_thread  # noqa: F401


def test_enable_bundle_false_gives_the_unbundled_trees():
    """Without bundles the port keeps its mega path and grows JAX's
    unbundled trees."""
    y = LABELS["binary"]
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "enable_bundle": False}
    jb = lgb.train(dict(params, tpu_megakernel="xla", tpu_frontier_k=1),
                   lgb.Dataset(X, label=y), num_boost_round=ROUNDS)
    jb.num_trees()
    tb = lgt.train(dict(params, device_type="cpu"), lgt.Dataset(X, label=y),
                   num_boost_round=ROUNDS)
    lr = tb._gbdt.learner
    assert not lr.bundled and not lr.subtract and lr.G == lr.F
    _same_trees(jb, tb)
