"""Shared helpers of the linear-tree tests (test_torch_linear_*.py): the
repo's tie rule (tests/torch_boost_cases.py ``compare``) with linear
leaves, and its linear-gain form for ``linear_tree_mode`` leafwise_gain.

``compare_linear`` walks both packages' trees in the order made, split
by split, as ``compare`` does: every split partitions the training rows
as JAX's does, every tree has its leaf values within rtol 1e-4 / atol
1e-5, and every linear leaf the same features in the same order, its
constant and coefficients within rtol 1e-4 / atol 1e-5.  The first split
that parts must tie:

  * refit grows by the constant gain: its two choices' gains, recounted
    in f64 from the gradients the port's tree summed, agree to 1e-9 of
    the gains' mass (``compare``'s rule);
  * leafwise_gain grows by the linear gain: the two choices' linear
    gains (each side's centered ridge fit over the bins' representative
    values, less the leaf's own best single-feature model), recounted in
    f64 from the same gradients, agree to ``LINEAR_TIE`` = 2^-12 of the
    gains' mass.  That is the f32 resolution of the JAX package's linear
    gain: its moment sums are f32 cumulative sums, and ``var = Σx²h -
    xm·Σxh`` cancels, so its recorded gains part from their f64 recount
    by up to 9e-5 of their value on examples/regression's first tree
    (ROADMAP section C).
"""

import numpy as np

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

from test_torch_categorical_trees import _gain64
from test_torch_train import _leaf_sets

LINEAR_TIE = 2.0 ** -12
K_EPSILON = 1e-15


def linear_leaves_close(a, b):
    """Host trees ``a`` (JAX) and ``b`` (port): the same linear leaves."""
    assert a.is_linear and b.is_linear
    np.testing.assert_allclose(b.leaf_const, a.leaf_const, rtol=1e-4,
                               atol=1e-5)
    for fa, fb, ca, cb in zip(a.leaf_features, b.leaf_features,
                              a.leaf_coeff, b.leaf_coeff):
        assert list(fa) == list(fb)
        np.testing.assert_allclose(cb, ca, rtol=1e-4, atol=1e-5)


def _side64(m, x, g, h, l2, lam):
    G, H = g[m].sum(), h[m].sum() + K_EPSILON
    xg, xh, xxh = (x[m] * g[m]).sum(), (x[m] * h[m]).sum(), \
        (x[m] * x[m] * h[m]).sum()
    xm = xh / H
    xgc, var = xg - xm * G, xxh - xm * xh
    gain = G * G / (H + l2)
    return gain + (xgc * xgc / (var + lam) if var > 0 else 0.0)


def rep_columns(tb, X):
    """Each used feature's (N,) f64 representative value per row: the
    port's ``bin_rep_values`` at the row's bin."""
    ds = tb._gbdt.train_data
    bins = ds._used_columns(np.asarray(X))
    return {f: ds.bin_mappers[f].bin_rep_values(
        values=ds.raw_data[:, f]).astype(np.float64)[bins[f]]
        for f in ds.used_features}


def _lingain64(rows, left, f, xs, g, h, params):
    if rows is None:
        return 0.0, 0.0
    l2 = params.get("lambda_l2", 0.0)
    lam = params.get("linear_lambda", 0.0)
    right = rows & ~left
    gl = _side64(left, xs[f], g, h, l2, lam)
    gr = _side64(right, xs[f], g, h, l2, lam)
    own = max(_side64(rows, x, g, h, l2, lam) for x in xs.values())
    return gl + gr - own, abs(gl) + abs(gr) + abs(own)


def compare_linear(X, jb, tb, rec, params, leafwise=False, bound=None):
    """The first (tree, split) where the packages part, after checking
    it is a tie (see module doc; ``bound``, when given, replaces the
    rule's share of the gains' mass); None when every tree agrees."""
    port_in_jax = lgb.Booster(model_str=tb.model_to_string())
    leaves_j = np.asarray(jb.predict(X, pred_leaf=True)).reshape(len(X), -1)
    leaves_t = np.asarray(port_in_jax.predict(X, pred_leaf=True)).reshape(
        len(X), -1)
    np.testing.assert_array_equal(
        leaves_t, np.asarray(tb.predict(X, pred_leaf=True)).reshape(
            len(X), -1))
    assert len(jb._gbdt.models) == len(tb._gbdt.models) == len(rec)
    xs = rep_columns(tb, X) if leafwise else None
    l2 = params.get("lambda_l2", 0.0)
    for t, (a, b) in enumerate(zip(jb._gbdt.models, tb._gbdt.models)):
        g, h = rec[t]
        sets = [[(np.isin(lv, list(u)), np.isin(lv, list(v)))
                 for u, v in _leaf_sets(tree)]
                for tree, lv in ((a, leaves_j[:, t]), (b, leaves_t[:, t]))]
        for s in range(max(len(sets[0]), len(sets[1]))):
            (rj, lj), (rt, lt) = (x[s] if s < len(x) else (None, None)
                                  for x in sets)
            if (rj is not None and rt is not None
                    and np.array_equal(rj, rt) and np.array_equal(lj, lt)):
                continue
            if leafwise:
                vj, mj = _lingain64(rj, lj, int(a.split_feature[s]) if
                                    rj is not None else 0, xs, g, h, params)
                vt, mt = _lingain64(rt, lt, int(b.split_feature[s]) if
                                    rt is not None else 0, xs, g, h, params)
                rule = LINEAR_TIE
            else:
                vj, mj = _gain64(rj, lj, g, h, l2, params)
                vt, mt = _gain64(rt, lt, g, h, l2, params)
                rule = 1e-9
            rule = rule if bound is None else bound
            assert abs(vj - vt) <= rule * max(1.0, mj, mt), (
                f"tree {t} split {s}: the packages split differently with "
                f"f64 gains {vj!r} (JAX) and {vt!r} (port)")
            return t, s
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)
        linear_leaves_close(a, b)
    return None


def leaf_bar(jb, X):
    """(N,) the raw-prediction bar that the leaf bar gives a row: atol
    1e-5 plus, over the trees, rtol 1e-4 of its leaf's |constant| and of
    each |coefficient x value| (``leafwise_gain``'s own models carry the
    f32 error of the histograms through ``var``'s cancellation, in both
    packages: ROADMAP section C)."""
    bar = np.full(len(X), 1e-5)
    for t in jb._gbdt.models:
        leaf = t.predict_leaf(X)
        for lf in np.unique(leaf):
            m = leaf == lf
            mass = abs(t.leaf_const[lf]) + sum(
                abs(c * X[m, f]) for f, c in zip(t.leaf_features[lf],
                                                 t.leaf_coeff[lf]))
            bar[m] += 1e-4 * np.nan_to_num(mass)
    return bar


def check_linear(X, jb, tb, rec, params, ties=None, leafwise=False):
    """``compare_linear`` meets ``ties`` ((tree, split), or (tree, split,
    bound) for a tie to ``bound`` of the gains' mass); with none, the raw
    predictions agree to atol 1e-5 (``leafwise_gain``: to ``leaf_bar``)
    and the model text loads in both packages and predicts the same (atol
    1e-5)."""
    bound = ties[2] if ties is not None and len(ties) > 2 else None
    found = compare_linear(X, jb, tb, rec, params, leafwise, bound)
    assert found == (None if ties is None else tuple(ties[:2])), found
    if found is not None:
        return
    pj, pt = (b.predict(X, raw_score=True) for b in (jb, tb))
    if leafwise:
        assert np.all(np.abs(pt - pj) <= leaf_bar(jb, X))
    else:
        np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
    jax_in_port = lgt.Booster(model_str=jb.model_to_string(),
                              params={"device_type": "cpu"})
    np.testing.assert_allclose(jax_in_port.predict(X, raw_score=True), pj,
                               rtol=0, atol=1e-5)
    port_in_jax = lgb.Booster(model_str=tb.model_to_string())
    np.testing.assert_allclose(port_in_jax.predict(X, raw_score=True), pt,
                               rtol=0, atol=1e-5)
