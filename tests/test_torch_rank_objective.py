"""The ranking objectives of the port (``lambdarank``, ``rank_xendcg``)
against the JAX package's classes on the same seeded queries: the
lambdas and hessians of ``get_gradients`` from the same scores.

The queries have every size from 1 to 70 documents, so every padded
bucket from 2 to 128 occurs, one query's labels are all 0 and one has a
single document.  Scores: all zero (the first iteration, where every
score ties and the stable sort's order decides the lambdas), seeded
normal scores, and scores rounded to a coarse grid so that many tie.
Lambdarank runs at ``lambdarank_truncation_level`` 30 and 3, with
``lambdarank_norm`` on and off, and with a custom ``label_gain``; with
positions, three calls in a row, the learned position biases compared
after each.  XE-NDCG runs three iterations in a row: the uniform bits of
its gumbel draw equal JAX's (``utils/random.py``), the noise itself to
rtol 1e-6 / atol 1e-6 (XLA's CPU ``log`` and torch's differ in the
last bits; near 0 the outer log's ulp is absolute, ~1e-7).

Bar: rtol 1e-5 / atol 1e-6 (the pairwise sums run in other orders and
``exp`` / ``log2`` differ in the last bits between XLA and torch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu.config as jconfig
import lightgbm_tpu.dataset as jdataset
from lightgbm_tpu.models import objective as jobj

import lightgbm_tpu_torch.config as tconfig
import lightgbm_tpu_torch.dataset as tdataset
from lightgbm_tpu_torch.models import objective as tobj
from lightgbm_tpu_torch.utils import random as trandom
from torch_one_thread import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def rank_data(seed=0):
    """Queries of 1..70 documents in a seeded order, graded labels 0-4
    (query 5 all 0), and positions 0-4 a document."""
    rng = np.random.RandomState(seed)
    sizes = rng.permutation(np.arange(1, 71))
    n = int(sizes.sum())
    label = rng.randint(0, 5, n).astype(np.float64)
    qb = np.concatenate([[0], np.cumsum(sizes)])
    label[qb[5]:qb[6]] = 0
    return sizes, label, rng.randint(0, 5, n)


def metadata(sizes, label, position=None):
    out = []
    for mod in (jdataset, tdataset):
        md = mod.Metadata(len(label))
        md.set_label(label)
        md.set_group(sizes)
        md.set_position(position)
        out.append(md)
    return out


def scores(kind, n, seed=1):
    rng = np.random.RandomState(seed)
    if kind == "zero":
        return np.zeros(n, np.float32)
    s = rng.randn(n).astype(np.float32)
    return np.round(s * 2) / 2 if kind == "ties" else s


def objectives(params, sizes, label, position=None):
    jmd, tmd = metadata(sizes, label, position)
    j = jobj.create_objective(jconfig.Config(params))
    t = tobj.create_objective(tconfig.Config(params))
    j.init(jmd)
    t.init(tmd, "cpu")
    return j, t


def jax_lambdarank(j, s):
    """JAX ``LambdarankNDCG.get_gradients`` of ``s``: its bucket lambdas
    under ``jax.jit`` (one compile; eager, each operation compiles on
    first use, ~40 s), with positions the biased scores first and the
    bias step after, as the method runs them."""
    positions, j.positions = j.positions, None
    s = jnp.asarray(s)
    if positions is not None:
        s = s + j.pos_biases[positions]
    key = ("jit", j.truncation_level, j.norm)
    if key not in j._grad_fns:
        j._grad_fns[key] = jax.jit(j.get_gradients)
    g, h = j._grad_fns[key](s)
    j.positions = positions
    if positions is not None:
        j._update_position_bias(g, h)
    return g, h


def grads(j, t, s):
    if isinstance(j, jobj.LambdarankNDCG):
        gj, hj = jax_lambdarank(j, s)
    else:
        gj, hj = j.get_gradients(jnp.asarray(s))
    gt, ht = (v.numpy() for v in t.get_gradients(torch.as_tensor(s)))
    return np.asarray(gj), np.asarray(hj), gt, ht


def check(gj, hj, gt, ht):
    np.testing.assert_allclose(gt, gj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ht, hj, rtol=RTOL, atol=ATOL)


LAMBDARANK = {
    "default": {},
    "truncation_3": {"lambdarank_truncation_level": 3},
    "no_norm": {"lambdarank_norm": False},
    "no_norm_truncation_3": {"lambdarank_norm": False,
                             "lambdarank_truncation_level": 3},
    "label_gain": {"label_gain": "0,1,3,7,20", "sigmoid": 1.5},
}


@pytest.mark.parametrize("case", sorted(LAMBDARANK))
def test_lambdarank_gradients_match_jax(case):
    sizes, label, _ = rank_data()
    j, t = objectives(dict(LAMBDARANK[case], objective="lambdarank"),
                      sizes, label)
    assert [b.P for b in t.buckets] == [b["P"] for b in j.buckets] == \
        [2, 4, 8, 16, 32, 64, 128]
    for kind in ("zero", "normal", "ties"):
        gj, hj, gt, ht = grads(j, t, scores(kind, len(label)))
        check(gj, hj, gt, ht)
        assert np.abs(gt).max() > 0.01
    # a one-document query and an all-zero query get no lambdas
    qb = np.concatenate([[0], np.cumsum(sizes)])
    one = int(np.nonzero(sizes == 1)[0][0])
    for q in (one, 5):
        assert not gt[qb[q]:qb[q + 1]].any() and not ht[qb[q]:qb[q + 1]].any()


def test_lambdarank_chunks_give_the_same_lambdas(monkeypatch):
    """Queries split into chunks of a few (the memory budget on the
    card) give the lambdas of one chunk a bucket, bit for bit."""
    sizes, label, _ = rank_data()
    params = {"objective": "lambdarank"}
    _, whole = objectives(params, sizes, label)
    monkeypatch.setattr(tobj, "PAIR_BUDGET", 20 * 4 * 64 * 64 * 3)
    _, chunked = objectives(params, sizes, label)
    assert max(len(b.chunks) for b in chunked.buckets) > 4
    assert all(len(b.chunks) == 1 for b in whole.buckets)
    s = torch.as_tensor(scores("normal", len(label)))
    for a, b in zip(whole.get_gradients(s), chunked.get_gradients(s)):
        assert torch.equal(a, b)


def test_position_bias_matches_jax_over_three_calls():
    sizes, label, position = rank_data()
    j, t = objectives({"objective": "lambdarank",
                       "lambdarank_position_bias_regularization": 0.5,
                       "learning_rate": 0.3}, sizes, label, position)
    assert not j.is_jit_safe and t.positions is not None
    for it, kind in enumerate(("zero", "normal", "ties")):
        check(*grads(j, t, scores(kind, len(label), seed=it)))
        np.testing.assert_allclose(t.pos_biases.numpy(),
                                   np.asarray(j.pos_biases), rtol=RTOL,
                                   atol=ATOL)
    assert np.abs(t.pos_biases.numpy()).max() > 1e-3


def test_gumbel_draws_jax_bits():
    """The uniform bits under ``jax.random.gumbel`` equal, the noise to
    the f32 resolution of ``log``, for the keys XE-NDCG folds."""
    tiny = np.finfo(np.float32).tiny
    for seed, it, b, shape in ((5, 1, 0, (37, 2)), (5, 3, 6, (3, 128)),
                               (17, 2, 4, (100, 16))):
        jk = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), it), b)
        tk = trandom.fold_in(trandom.fold_in(trandom.PRNGKey(seed), it), b)
        u = np.asarray(jax.random.uniform(jk, shape, minval=tiny, maxval=1.0))
        got = trandom.torch_gumbel(tk, shape, "cpu").numpy()
        bits = trandom.torch_random_bits_at(tk, torch.arange(u.size))
        want_u = (((bits >> 9) | 0x3F800000).to(torch.int32)
                  .view(torch.float32) - 1.0 + tiny).numpy()
        np.testing.assert_array_equal(want_u.reshape(shape), u)
        want = np.asarray(jax.random.gumbel(jk, shape))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_xendcg_gradients_match_jax_over_three_iterations():
    sizes, label, _ = rank_data(seed=3)
    j, t = objectives({"objective": "rank_xendcg", "objective_seed": 11},
                      sizes, label)
    assert [b.P for b in t.buckets] == [b["P"] for b in j.buckets]
    for it, kind in enumerate(("zero", "normal", "ties")):
        check(*grads(j, t, scores(kind, len(label), seed=it)))
        assert t._iter == j._iter == it + 1


@pytest.mark.parametrize("name", ["lambdarank", "rank_xendcg"])
def test_rank_objective_text_and_output(name):
    sizes, label, _ = rank_data()
    j, t = objectives({"objective": name}, sizes, label)
    assert t.to_string() == j.to_string() == name
    assert t.boost_from_score(0) == j.boost_from_score(0) == 0.0
    s = torch.as_tensor(scores("normal", 10))
    assert torch.equal(t.convert_output(s), s)
    assert not t.reference_fused
