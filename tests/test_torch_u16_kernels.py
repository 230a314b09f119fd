"""The plain partition and histograms of the port at uint16 bins
against the JAX package, on the CPU (the binning and the uint16 matrix:
test_torch_u16.py; the searches past 256 bins:
test_torch_u16_search.py).

Tolerances (ROADMAP's parity bar): the partition's row order and left
count are identical (it moves words); the fixed-point histogram is held
to JAX's ``leaf_hist_slice`` within 1e-5 of each bin's sum plus 1e-5 of
its absolute mass (the f64 bar of tests/test_torch_leaf_hist.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.models.learner import SerialTreeLearner as JaxLearner
from lightgbm_tpu.ops import partition as jpart
from lightgbm_tpu.ops.histogram import leaf_hist_slice
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import partition as tpart


def _u16_rows(seed, G=3, n=4096, top=1024):
    rng = np.random.RandomState(seed)
    pb = rng.randint(0, top, (G, n)).astype(np.uint16)
    pg = rng.randn(8, n).astype(np.float32)
    pg[1] = np.abs(pg[1])
    pg[2] = np.arange(n, dtype=np.int32).view(np.float32)
    return rng, pb, pg


@pytest.mark.parametrize("cat", [False, True])
def test_u16_partition_plain_equals_jax_partition(cat):
    """partition_leaf_plain on uint16 bins against JAX ops/partition.py
    ``partition_leaf`` driven by the JAX learner's own decision
    (``_goes_left``, a 32-word set for the categorical case): the same
    rows in the same order, the same left count."""
    rng, pb, pg = _u16_rows(3)
    start, cnt, col = 131, 3000, 1
    member = rng.rand(1024) < 0.4
    member[0] = False
    words = tpart.cat_words(1024)
    bits = np.zeros(32 * words, np.int64)
    bits[:1024] = member
    cat_words = [int(v) for v in (bits.reshape(words, 32)
                                  << np.arange(32)).sum(1).astype(
                                      np.uint32).view(np.int32)]
    thr, dl, mtype, dbin, nb = 600, 1, 2, 0, 1024
    sc = (tpart.make_scalars(start, cnt, col, 0, 0, nb, dbin, mtype, thr, dl,
                             1, cat_words) if cat else
          tpart.make_scalars(start, cnt, col, 0, 0, nb, dbin, mtype, thr, dl))
    tb, tg = torch.as_tensor(pb.copy()), torch.as_tensor(pg.copy())
    nl = tpart.partition_leaf(tb, tg, sc)

    colv = jnp.asarray(pb[col])
    jl = JaxLearner.__new__(JaxLearner)
    jl.has_categorical = cat
    scal = (0, 0, nb, dbin, mtype, thr, dl, int(cat), jnp.asarray(member))

    def goes_left(rows):
        return jl._goes_left(colv[rows], scal)

    size = 4096
    idx = jnp.arange(pb.shape[1] + size, dtype=jnp.int32)
    new, jnl = jpart.partition_leaf(idx, None, start, cnt, size, goes_left)
    order = np.asarray(new)[:pb.shape[1]]
    assert int(nl[0]) == int(jnl)
    np.testing.assert_array_equal(tb.numpy(), pb[:, order])
    np.testing.assert_array_equal(tg.numpy().view(np.int32),
                                  pg.view(np.int32)[:, order])


def test_fixed_histograms_at_1024_bins_within_jax_bar():
    """The card's fixed-point histogram (leaf_hist_fixed_plain) and the
    CPU's f32 one at B = 1024 against JAX's leaf_hist_slice on uint16
    bins: within 1e-5 of each bin's sum plus 1e-5 of its mass."""
    rng, pb, pg = _u16_rows(5)
    B, G, s, c = 1024, 3, 77, 3500
    tb, tg = torch.as_tensor(pb), torch.as_tensor(pg)
    fixed = th.leaf_hist_fixed_plain(tb, tg, s, c, num_bins=B,
                                     num_groups=G).numpy()
    plain = th.leaf_hist(tb, tg, s, c, num_bins=B, num_groups=G).numpy()
    jx = np.asarray(leaf_hist_slice(jnp.asarray(pb), jnp.asarray(pg),
                                    jnp.int32(s), jnp.int32(c), num_bins=B,
                                    row_chunk=256, num_groups=G))
    ref, mass = (x.permute(1, 2, 0).numpy() for x in th.leaf_hist_reference(
        tb, tg, s, c, num_bins=B, num_groups=G))
    assert fixed.shape == plain.shape == jx.shape == (G, B, 2)
    for got in (fixed, plain):
        assert (np.abs(got - jx) <= 1e-5 * np.abs(ref) + 1e-5 * mass).all()
