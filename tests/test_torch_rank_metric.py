"""The ranking metrics of the port (``ndcg``, ``map``) against the JAX
package's on the same seeded queries and scores, at ``eval_at``
1,3,5,10 and at the default 1..5, with the default and a custom
``label_gain``: queries of every size from 1 to 70 (padded buckets 2 to
128), one whose labels are all 0 (NDCG 1, MAP 0), and scores all equal,
normal, or rounded so that many tie (the stable sort keeps document
order among ties in both packages).  Bar: 1e-6 absolute (f32 sums a
bucket, their f64 total across buckets).  Also: each metric against a
numpy float64 evaluation of its definition, the default metric of the
ranking objectives and ``is_max_better``.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu.config as jconfig
from lightgbm_tpu.models import metric as jmetric

import lightgbm_tpu_torch.config as tconfig
from lightgbm_tpu_torch.models import metric as tmetric

from test_torch_rank_objective import metadata, rank_data, scores

EVAL_AT = {"1,3,5,10": [1, 3, 5, 10], "": [1, 2, 3, 4, 5]}


def metrics(params, sizes, label):
    jmd, tmd = metadata(sizes, label)
    jm = jmetric.create_metrics(jconfig.Config(params))
    tm = tmetric.create_metrics(tconfig.Config(params))
    for m in jm:
        m.init(jmd)
    for m in tm:
        m.init(tmd, "cpu")
    return jm, tm


def ndcg64(s, label, sizes, k, gains):
    """NDCG@k of one query at a time in float64, ties in document order."""
    out, lo = [], 0
    for n in sizes:
        g = gains[label[lo:lo + n].astype(int)]
        order = np.argsort(-s[lo:lo + n], kind="stable")
        disc = 1.0 / np.log2(np.arange(2, n + 2))
        kk = min(k, n)
        dcg = np.sum(g[order][:kk] * disc[:kk])
        idcg = np.sum(np.sort(g)[::-1][:kk] * disc[:kk])
        out.append(dcg / idcg if idcg > 0 else 1.0)
        lo += n
    return np.mean(out)


def map64(s, label, sizes, k):
    out, lo = [], 0
    for n in sizes:
        y = (label[lo:lo + n] > 0)[np.argsort(-s[lo:lo + n], kind="stable")]
        kk = min(k, n)
        hits = np.cumsum(y)
        ap = np.sum((hits / np.arange(1, n + 1))[:kk] * y[:kk])
        out.append(ap / max(min(hits[-1], kk), 1))
        lo += n
    return np.mean(out)


@pytest.mark.parametrize("gain", ["", "0,1,3,7,20"])
@pytest.mark.parametrize("eval_at", sorted(EVAL_AT))
def test_ndcg_and_map_match_jax(eval_at, gain):
    sizes, label, _ = rank_data()
    params = {"metric": "ndcg,map", "eval_at": eval_at, "label_gain": gain}
    jm, tm = metrics(params, sizes, label)
    gains = (np.asarray([float(x) for x in gain.split(",")]) if gain
             else 2.0 ** np.arange(32) - 1.0)
    for kind in ("zero", "normal", "ties"):
        s = scores(kind, len(label))
        for a, b in zip(jm, tm):
            want = a.eval(s, None)
            got = b.eval(torch.as_tensor(s), None)
            assert [n for n, _ in got] == [n for n, _ in want] == [
                f"{b.name}@{k}" for k in EVAL_AT[eval_at]]
            np.testing.assert_allclose([v for _, v in got],
                                       [v for _, v in want], rtol=0,
                                       atol=1e-6)
            for (_, v), k in zip(got, EVAL_AT[eval_at]):
                ref = (ndcg64(s, label, sizes, k, gains) if b.name == "ndcg"
                       else map64(s, label, sizes, k))
                assert abs(v - ref) <= 1e-6


def test_all_zero_and_one_document_queries():
    """A query whose labels are all 0 counts NDCG 1 and MAP 0; a single
    document's query NDCG 1, and MAP 1 when it is relevant; a query of
    tied scores ranks in document order."""
    sizes = np.array([3, 1, 1, 4])
    label = np.array([0, 0, 0, 2, 0, 1, 0, 3, 0], np.float64)
    s = torch.tensor([0.5, 0.1, 0.3, 1.0, 2.0, 0.0, 0.0, 0.0, 0.0])
    _, (nd, mp) = metrics({"metric": "ndcg,map", "eval_at": "1,3"}, sizes,
                          label)
    ndcg = dict(nd.eval(s, None))
    ap = dict(mp.eval(s, None))
    # the tied query ranks gains 1, 0, 7, 0 (labels 1, 0, 3, 0)
    tied_ndcg1 = 1 / 7
    tied_ndcg3 = (1 + 7 / np.log2(4)) / (7 + 1 / np.log2(3))
    np.testing.assert_allclose(ndcg["ndcg@1"], (3 + tied_ndcg1) / 4,
                               atol=1e-7)
    np.testing.assert_allclose(ndcg["ndcg@3"], (3 + tied_ndcg3) / 4,
                               atol=1e-7)
    # relevant at ranks 1 and 3 of the tied query: (1 + 2/3) / 2 at 3
    np.testing.assert_allclose(ap["map@1"], (0 + 1 + 0 + 1) / 4, atol=1e-7)
    np.testing.assert_allclose(ap["map@3"], (0 + 1 + 0 + 5 / 6) / 4,
                               atol=1e-7)


@pytest.mark.parametrize("objective", ["lambdarank", "rank_xendcg"])
def test_ranking_objectives_default_to_ndcg(objective):
    for pkg_config, pkg_metric in ((jconfig, jmetric), (tconfig, tmetric)):
        ms = pkg_metric.create_metrics(pkg_config.Config({}), objective)
        assert [m.name for m in ms] == ["ndcg"]
        assert ms[0].is_max_better
    assert tmetric.MapMetric.is_max_better


def test_metric_without_queries_is_fatal():
    from lightgbm_tpu_torch.dataset import Metadata
    md = Metadata(4)
    md.set_label([0, 1, 0, 1])
    for cls in (tmetric.NDCGMetric, tmetric.MapMetric):
        with pytest.raises(Exception, match="query"):
            cls(tconfig.Config({})).init(md, "cpu")
