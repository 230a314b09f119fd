"""A categorical of 400 levels at the default ``max_bin`` (more than 256
bins: a uint16 matrix from that column alone, category sets of more than
8 words),
trained by the port and by the JAX package, held by the bar of
test_torch_u16_train.py.
"""

import numpy as np

from test_torch_u16_train import train_and_check


def cat400(n=3000, seed=0):
    """Three numerical columns and a 400-level categorical with NaNs:
    half the rows spread over all 400 levels, half on 20 popular ones,
    of which every third moves the label."""
    rng = np.random.RandomState(seed)
    c = np.where(rng.rand(n) < 0.5, rng.randint(0, 400, n),
                 rng.randint(0, 20, n) * 19).astype(float)
    c[rng.rand(n) < 0.03] = np.nan
    X = np.column_stack([rng.randn(n, 3), c])
    y = (X[:, 0] + np.isin(c, np.arange(0, 400, 57)) * 1.5
         + 0.3 * rng.randn(n) > 0.5).astype(float)
    return X, y


def test_400_level_categorical_trains_as_jax():
    X, y = cat400()
    tb = train_and_check(X, y, {"objective": "binary"}, cats=[3])
    lr = tb._gbdt.learner
    assert lr.ds.bin_mappers[3].num_bin > 256
    assert lr.W > 8 and lr.has_cat
    assert sum(t.num_cat for t in tb._gbdt.models) > 0
