"""The port's split mega-kernel (lightgbm_tpu_torch/ops/split_mega.py)
against the JAX mega-kernel run in the Pallas interpreter, on the shapes
of tests/test_pallas_interpret.py.

Tolerances: bins, every payload row (as raw 32-bit words, row-id row
included) and the left count must be bit-identical.  Histograms agree
to rtol 1e-5 / atol 1e-6: the JAX kernel sums each chunk with an f32
one-hot matmul, the port row by row, so f32 summation order differs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu.ops.partition_pallas import make_scalars, sc_rows_for
from lightgbm_tpu.ops.split_megakernel_pallas import split_megakernel_pallas
from lightgbm_tpu_torch.ops import split_mega as sm
from lightgbm_tpu_torch.ops import partition as tpart
from lightgbm_tpu_torch.ops.partition import decide_left

C, G32, G, B = 256, 32, 28, 255
NP = 8 * C


def _buffers(seed):
    rng = np.random.RandomState(seed)
    pb = rng.randint(0, 250, (G32, NP)).astype(np.uint8)
    pg = rng.randn(8, NP).astype(np.float32)
    # row ids ride row 2 as int32 bits; include words that are NaN
    # patterns as floats, which a float move could rewrite
    ids = rng.permutation(NP).astype(np.int32)
    ids[:16] = np.arange(-16, 0, dtype=np.int32)
    pg[2] = ids.view(np.float32)
    return rng, pb, pg


def _jax(pb, pg, sc):
    rpb, rpg, _, rnl, acc = split_megakernel_pallas(
        jnp.asarray(pb), jnp.asarray(pg),
        jnp.zeros((sc_rows_for(G32), NP), jnp.int32),
        make_scalars(*sc), row_chunk=C, num_bins=B, num_groups=G,
        ghi_live=8, interpret=True)
    return (np.asarray(rpb), np.asarray(rpg), int(np.asarray(rnl)[0, 0]),
            np.asarray(acc))


def _port(pb, pg, sc, move=True):
    tb, tg = torch.as_tensor(pb.copy()), torch.as_tensor(pg.copy())
    nl, acc = sm.split_mega(tb, tg, tpart.make_scalars(*sc), num_bins=B,
                            num_groups=G, move=move)
    return tb.numpy(), tg.numpy(), int(nl[0]), acc.numpy()


def _check(pb, pg, sc):
    epb, epg, enl, eacc = _jax(pb, pg, sc)
    rpb, rpg, rnl, racc = _port(pb, pg, sc)
    assert rnl == enl
    np.testing.assert_array_equal(rpb, epb)
    np.testing.assert_array_equal(rpg.view(np.int32), epg.view(np.int32))
    assert racc.shape == eacc.shape == (G, 4 * 16, 16)
    np.testing.assert_allclose(racc, eacc, rtol=1e-5, atol=1e-6)
    return rnl, racc


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_split_mega_plain_matches_pallas_interpreted(trial):
    """Random leaf range (not 128-aligned), split column and decision
    (missing none / zero / NaN)."""
    rng, pb, pg = _buffers(60 + trial)
    start = int(rng.randint(C, 4 * C))
    cnt = int(rng.randint(1, 3 * C))
    nb = int(rng.randint(10, 250))
    sc = (start, cnt, int(rng.randint(0, G)), 0, 0, nb,
          int(rng.randint(0, nb)), trial, int(rng.randint(0, nb)),
          int(rng.rand() < 0.5))
    _check(pb, pg, sc)


@pytest.mark.parametrize("thr", [255, -1])
def test_split_mega_all_left_all_right(thr):
    """Every row left (the partition is the identity) or every row right."""
    _, pb, pg = _buffers(7)
    nl, acc = _check(pb, pg, (3 * C + 5, 2 * C + 3, 4, 0, 0, 250, 0, 0,
                              thr, 0))
    planes = acc.reshape(G, 4, -1)
    assert nl == (2 * C + 3 if thr == 255 else 0)
    assert not planes[:, 2 if thr == 255 else 0].any()


def test_split_mega_zero_count():
    """cnt == 0 (the trash-slot call): nothing moves, zeros come back."""
    _, pb, pg = _buffers(99)
    nl, acc = _check(pb, pg, (3 * C + 17, 0, 5, 0, 0, 200, 0, 0, 100, 0))
    assert nl == 0 and not acc.any()


def test_split_mega_no_move_is_histogram_only():
    """move=False returns the same histogram, moves no row and reports
    cnt as the left count (the learner's root-histogram call)."""
    _, pb, pg = _buffers(11)
    sc = (C + 3, 3 * C, 2, 0, 0, 250, 7, 1, 120, 1)
    _, _, _, acc = _port(pb, pg, sc)
    rpb, rpg, nl, acc2 = _port(pb, pg, sc, move=False)
    np.testing.assert_array_equal(acc2, acc)
    np.testing.assert_array_equal(rpb, pb)
    np.testing.assert_array_equal(rpg.view(np.int32), pg.view(np.int32))
    assert nl == 3 * C


def test_decide_left_matches_numpy_oracle():
    """The partition decision against the oracle of
    tests/test_pallas_interpret.py, bundled offsets included."""
    rng = np.random.RandomState(5)
    colv = rng.randint(0, 256, 4000)
    for isb in (0, 1):
        for mtype in (0, 1, 2):
            bstart, nb, dbin, thr, dl = 3, 40, 2, 17, 1
            got = decide_left(torch.as_tensor(colv), bstart, isb, nb, dbin,
                              mtype, thr, dl).numpy()
            fb_raw = colv - bstart
            in_r = (fb_raw >= 1) & (fb_raw <= nb - 1)
            fb = np.where(isb == 1, np.where(in_r, fb_raw, dbin), colv)
            miss = (fb == dbin if mtype == 1 else fb == nb - 1
                    if mtype == 2 else np.zeros_like(fb, bool))
            np.testing.assert_array_equal(got, np.where(miss, dl != 0,
                                                        fb <= thr))


def test_split_mega_dispatches_cpu_to_plain_version():
    before = sm.launches
    _, pb, pg = _buffers(3)
    _port(pb, pg, (C, C, 1, 0, 0, 250, 0, 0, 100, 0))
    assert sm.launches == before
