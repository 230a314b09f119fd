"""The port's leaf partition (lightgbm_tpu_torch/ops/partition.py)
against the JAX partition kernel run in the Pallas interpreter, on the
shapes of tests/test_pallas_interpret.py (R = 32 bin rows, 256-row
chunks), and against a numpy oracle.

Tolerances: none -- the partition moves words.  Bins, the left count and
payload rows 0..2 (grad, hess, row-id bits) must be bit-identical to the
JAX kernel, which keeps only its ``ghi_live`` = 3 first payload rows;
all 8 payload rows, as raw 32-bit words, must be bit-identical to the
numpy oracle.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu.ops.partition_pallas import (make_scalars,
                                               partition_leaf_pallas,
                                               sc_rows_for)
from lightgbm_tpu_torch.ops import partition as tpart

C, R = 256, 32
NP = 8 * C


def _buffers(seed):
    rng = np.random.RandomState(seed)
    pb = rng.randint(0, 250, (R, NP)).astype(np.uint8)
    pg = rng.randn(8, NP).astype(np.float32)
    # row ids ride row 2 as int32 bits; include words that are NaN
    # patterns as floats, which a float move could rewrite
    ids = rng.permutation(NP).astype(np.int32)
    ids[:16] = np.arange(-16, 0, dtype=np.int32)
    pg[2] = ids.view(np.float32)
    pg[5, ::7] = np.array([0x7FC00001], np.uint32).view(np.float32)[0]
    return rng, pb, pg


def _oracle(pb, pg, start, cnt, col, bstart, isb, nb, dbin, mtype, thr, dl):
    pb, words = pb.copy(), pg.view(np.int32).copy()
    fb = pb[col, start:start + cnt].astype(np.int32)
    if isb == 1:
        raw = fb - bstart
        fb = np.where((raw >= 1) & (raw <= nb - 1), raw, dbin)
    miss = (fb == dbin if mtype == 1 else fb == nb - 1 if mtype == 2
            else np.zeros_like(fb, bool))
    gl = np.where(miss, dl != 0, fb <= thr)
    order = np.concatenate([np.where(gl)[0], np.where(~gl)[0]]) + start
    pb[:, start:start + cnt] = pb[:, order]
    words[:, start:start + cnt] = words[:, order]
    return pb, words, int(gl.sum())


def _check(pb, pg, sc):
    epb, ewords, enl = _oracle(pb, pg, *sc)
    tb, tg = torch.as_tensor(pb.copy()), torch.as_tensor(pg.copy())
    nl = tpart.partition_leaf(tb, tg, tpart.make_scalars(*sc))
    assert nl.dtype == torch.int32 and tuple(nl.shape) == (1,)
    assert int(nl[0]) == enl
    np.testing.assert_array_equal(tb.numpy(), epb)
    np.testing.assert_array_equal(tg.numpy().view(np.int32), ewords)
    rpb, rpg, _, rnl = partition_leaf_pallas(
        jnp.asarray(pb), jnp.asarray(pg),
        jnp.zeros((sc_rows_for(R), NP), jnp.int32), make_scalars(*sc),
        row_chunk=C, interpret=True)
    assert int(np.asarray(rnl)[0, 0]) == enl
    np.testing.assert_array_equal(np.asarray(rpb), tb.numpy())
    np.testing.assert_array_equal(np.asarray(rpg)[:3].view(np.int32),
                                  tg.numpy()[:3].view(np.int32))
    return enl


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_partition_plain_matches_pallas_interpreted(trial):
    """Random leaf range (not 128-aligned), split column and decision
    (missing none / zero / NaN)."""
    rng, pb, pg = _buffers(trial)
    start = int(rng.randint(C, 4 * C))
    cnt = int(rng.randint(1, 3 * C))
    nb = int(rng.randint(10, 250))
    _check(pb, pg, (start, cnt, int(rng.randint(0, 28)), 0, 0, nb,
                    int(rng.randint(0, nb)), trial, int(rng.randint(0, nb)),
                    int(rng.rand() < 0.5)))


@pytest.mark.parametrize("case,sc,want", [
    ("cnt0", (3 * C + 17, 0, 5, 0, 0, 200, 0, 0, 100, 0), 0),
    ("all_left", (C + 3, 2 * C + 9, 4, 0, 0, 250, 0, 0, 255, 0), 2 * C + 9),
    ("all_right", (C + 3, 2 * C + 9, 4, 0, 0, 250, 0, 0, -1, 0), 0),
    ("zero_missing", (77, 3 * C, 7, 0, 0, 250, 40, 1, 90, 1), None),
    ("nan_missing", (77, 3 * C, 8, 0, 0, 250, 0, 2, 200, 1), None),
    ("bundled", (5, 4 * C + 1, 2, 10, 1, 60, 0, 1, 30, 0), None),
], ids=lambda v: v if isinstance(v, str) else None)
def test_partition_edge_cases(case, sc, want):
    _, pb, pg = _buffers(20)
    nl = _check(pb, pg, sc)
    if want is not None:
        assert nl == want


def test_partition_leaves_rows_outside_the_range():
    _, pb, pg = _buffers(3)
    sc = (C + 11, 3 * C, 6, 0, 0, 250, 0, 0, 120, 0)
    tb, tg = torch.as_tensor(pb.copy()), torch.as_tensor(pg.copy())
    tpart.partition_leaf(tb, tg, tpart.make_scalars(*sc))
    for sl in (np.s_[:, :C + 11], np.s_[:, 4 * C + 11:]):
        np.testing.assert_array_equal(tb.numpy()[sl], pb[sl])
        np.testing.assert_array_equal(tg.numpy()[sl].view(np.int32),
                                      pg[sl].view(np.int32))


def test_partition_dispatches_cpu_to_plain_version():
    before = tpart.launches
    _, pb, pg = _buffers(4)
    tpart.partition_leaf(torch.as_tensor(pb), torch.as_tensor(pg),
                         tpart.make_scalars(C, C, 1, 0, 0, 250, 0, 0, 100, 0))
    assert tpart.launches == before
