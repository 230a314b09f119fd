"""Quantized-gradient training of one-vs-all multiclass (5 classes, 2
iterations, a seeded ``init_score``) at ``tpu_frontier_k=4`` with bagging
and ``quant_train_renew_leaf`` against the JAX package, held split for
split (test_torch_quantized_trees.py ``compare``): the JAX package's
eager iteration draws the bag and the ``quant_rng`` chain, and the true
gradients of each class tree ride payload rows 4 and 5.
"""

from test_torch_quantized_multiclass import train_both
from test_torch_quantized_trees import check
from torch_one_thread import one_torch_thread  # noqa: F401


def test_ova_frontier_bagged_renewal_trees_match_jax():
    params = dict(objective="multiclassova", num_class=5, tpu_frontier_k=4,
                  quant_train_renew_leaf=True, bagging_fraction=0.7,
                  bagging_freq=1)
    X, jb, tb, rec = train_both(params, True)
    assert tb._gbdt.learner.K == 4 and tb._gbdt._renew_rows == (4, 5)
    check(X, jb, tb, rec, params)
