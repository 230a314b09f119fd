"""Trees on categorical data: the port (``device_type=cpu``) against the
JAX package (``tpu_frontier_k=1``, its default on the CPU), 5 trees of
31 leaves on binary and L2 data mixing numerical and categorical columns,
and on data where a mostly-NaN categorical lands in an EFB bundle.

The tie rule of ROADMAP section C: both packages' trees are walked split
by split in the order made, on the training rows; every split must
partition the same rows the same way until the first one that does not,
whose two choices must have equal gains recounted in f64 from the
tree's gradients (each choice with its own arm's l2: ``lambda_l2 +
cat_l2`` for a categorical split of the sorted arm, ``lambda_l2``
otherwise); every tree before it has its leaf values within rtol 1e-4 /
atol 1e-5.  On categorical data JAX runs its general search for the
numerical features too (f32 cumulative sums) where the port's pair
search keeps f64 prefix sums, so a tie may also be one of f32
resolution, held to 2^-23 of the split's leaf gains.  ``TIES`` records,
per case, the (tree, split) of the tie found and the tolerance it meets;
with no tie at all the raw predictions agree to atol 1e-5.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

from test_torch_categorical import CATS, cat_data
from test_torch_train import _leaf_gain64, _leaf_sets
from torch_one_thread import one_torch_thread  # noqa: F401

ROUNDS = 5
CASES = {
    "binary": ("binary", False),
    "regression": ("regression", False),
    "bundled": ("regression", True),
}
# (tree, split, rtol) of the first tie on each case.  binary: tree 1
# split 25 is a split of zero exact gain in both packages, on different
# leaves (f64 recounts 2.3e-13 and -1.1e-13 against leaf gains of 1891
# and 1544; both f32 gains 1.22e-4, an ulp at ~1900), ROADMAP section C
TIES = {"binary": (1, 25, 1e-9), "regression": None, "bundled": None}


def _l2_of(tree, s, mappers, params):
    """The l2 of split s's children: the sorted categorical arm adds
    cat_l2."""
    l2 = params.get("lambda_l2", 0.0)
    if s is None or s >= tree.num_leaves - 1:
        return l2
    f = int(tree.split_feature[s])
    if (int(tree.decision_type[s]) & 1 and mappers[f].num_bin
            > params.get("max_cat_to_onehot", 4)):
        return l2 + params.get("cat_l2", 10.0)
    return l2


def _gain64(rows, left, g, h, l2c, params):
    if rows is None:
        return 0.0, 0.0
    l1 = params.get("lambda_l1", 0.0)
    l2 = params.get("lambda_l2", 0.0)
    mds = params.get("max_delta_step", 0.0)
    right = rows & ~left
    gl = _leaf_gain64(g[left].sum(), h[left].sum(), l1, l2c, mds)
    gr = _leaf_gain64(g[right].sum(), h[right].sum(), l1, l2c, mds)
    gp = _leaf_gain64(g[rows].sum(), h[rows].sum(), l1, l2, mds)
    return gl + gr - gp, abs(gl) + abs(gr) + abs(gp)


def _compare(X, y, objective, params, jb, tb, mappers, tie):
    """The first (tree, split) that partitions the rows differently,
    after checking it is a tie (to 1e-9, or at ``tie`` to its rtol);
    None when every tree agrees."""
    port_in_jax = lgb.Booster(model_str=tb.model_to_string())
    leaves_j = np.asarray(jb.predict(X, pred_leaf=True))
    leaves_t = np.asarray(port_in_jax.predict(X, pred_leaf=True))
    np.testing.assert_array_equal(leaves_t,
                                  tb.predict(X, pred_leaf=True))
    score = np.full(len(y), tb._gbdt.init_scores[0], np.float64)
    for t, (a, b) in enumerate(zip(jb._gbdt.models, tb._gbdt.models)):
        if objective == "binary":
            p = 1.0 / (1.0 + np.exp(-score))
            g, h = p - y, p * (1.0 - p)
        else:
            g, h = score - y, np.ones_like(y)
        sets = [[(np.isin(lv, list(u)), np.isin(lv, list(v)))
                 for u, v in _leaf_sets(tree)]
                for tree, lv in ((a, leaves_j[:, t]), (b, leaves_t[:, t]))]
        for s in range(max(len(sets[0]), len(sets[1]))):
            (rj, lj), (rt, lt) = (x[s] if s < len(x) else (None, None)
                                  for x in sets)
            if (rj is not None and rt is not None
                    and np.array_equal(rj, rt) and np.array_equal(lj, lt)):
                continue
            vj, mj = _gain64(rj, lj, g, h, _l2_of(a, s, mappers, params),
                             params)
            vt, mt = _gain64(rt, lt, g, h, _l2_of(b, s, mappers, params),
                             params)
            rtol = tie[2] if tie and (t, s) == tie[:2] else 1e-9
            assert abs(vj - vt) <= rtol * max(1.0, mj, mt), (
                f"tree {t} split {s}: the packages split differently with "
                f"f64 gains {vj!r} (JAX) and {vt!r} (port)")
            return t, s
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)
        score = score + np.asarray(b.leaf_value, np.float64)[leaves_t[:, t]]
        if t == 0:
            score = score - tb._gbdt.init_scores[0]
    return None


@pytest.mark.parametrize("case", sorted(CASES))
def test_categorical_trees_match_jax(case):
    objective, bundle = CASES[case]
    X, y = cat_data(bundle=bundle)
    if objective == "binary":
        y = (y > np.median(y)).astype(float)
    params = {"objective": objective, "num_leaves": 31, "verbosity": -1,
              "min_data_in_leaf": 20, "min_data_per_group": 50}
    cats = CATS[bundle]
    jb = lgb.train(dict(params, tpu_frontier_k=1),
                   lgb.Dataset(X, label=y, categorical_feature=cats),
                   num_boost_round=ROUNDS)
    jb.num_trees()
    tb = lgt.train(dict(params, device_type="cpu"),
                   lgt.Dataset(X, label=y, categorical_feature=cats),
                   num_boost_round=ROUNDS)
    lr = tb._gbdt.learner
    assert lr.has_cat and lr.subtract and lr.K == 1
    assert lr.bundled == bundle
    assert sum(t.num_cat for t in tb._gbdt.models) > 0
    if bundle:      # the bundled categorical is split on
        assert any(4 in t.split_feature[t.is_categorical_node()]
                   for t in tb._gbdt.models)
    mappers = tb._gbdt.train_data.bin_mappers
    found = _compare(X, y, objective, params, jb, tb, mappers, TIES[case])
    assert found == (TIES[case] and TIES[case][:2])
    if found is None:
        for a, b in zip(jb._gbdt.models, tb._gbdt.models):
            assert a.cat_threshold == b.cat_threshold
            assert a.cat_boundaries == b.cat_boundaries
            np.testing.assert_array_equal(a.decision_type, b.decision_type)
        np.testing.assert_allclose(tb.predict(X, raw_score=True),
                                   jb.predict(X, raw_score=True), rtol=0,
                                   atol=1e-5)


def equal_ratio_data(seed=2, n=3000):
    """4 normal features and categoricals of 60 and 7 levels (columns 4
    and 5) with a seeded effect a level, and a binary label."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[:, 4] = rng.randint(0, 60, n)
    X[:, 5] = rng.randint(0, 7, n)
    eff60, eff7 = rng.randn(60), rng.randn(7)
    z = (X[:, 0] + 0.5 * X[:, 1] + eff60[X[:, 4].astype(int)]
         + 0.5 * eff7[X[:, 5].astype(int)])
    return X, (z + rng.randn(n) > 0).astype(float)


def complement_data(n=3000):
    """ROADMAP section C.2's frame: ``a``, ``b`` normal, ``c`` a pandas
    category of 6 levels drawn uniformly, ``d`` bool, and a binary label
    that the odd levels of ``c`` raise."""
    import pandas as pd
    rng = np.random.default_rng(0)
    df = pd.DataFrame({"a": rng.normal(size=n), "b": rng.normal(size=n)})
    df["c"] = pd.Categorical.from_codes(rng.integers(0, 6, n),
                                        categories=list("pqrstu"))
    df["d"] = rng.random(n) < 0.5
    z = df["a"] + (df["c"].cat.codes % 2) * 0.8 + rng.normal(0, 0.5, n)
    return df, (z > 0.3).astype(float).values


def _is_complement(jb, tb, X, t, s):
    """Split s of tree t holds the same rows in both packages, and the
    rows one sends left the other sends right."""
    port_in_jax = lgb.Booster(model_str=tb.model_to_string())
    sets = []
    for tree, bst in ((jb._gbdt.models[t], jb), (tb._gbdt.models[t],
                                                 port_in_jax)):
        lv = np.asarray(bst.predict(X, pred_leaf=True))[:, t]
        u, v = _leaf_sets(tree)[s]
        sets.append((np.isin(lv, list(u)), np.isin(lv, list(v))))
    (rj, lj), (rt, lt) = sets
    return np.array_equal(rj, rt) and np.array_equal(lj, rt & ~lt)


# ROADMAP section C.2: at cat_smooth 1, levels of the 60-level feature
# with equal row counts and labels have equal sort keys G / (H +
# cat_smooth) in exact arithmetic, and each package's f32 residues order
# them; the sets differ at a split of equal f64 gain.  At cat_smooth 10
# (the default) the same data meet no tie.  The complement tie: on
# complement_data, a leaf's best set is half of the 6 levels, which both
# scan ends reach at exactly equal gain; tree 1 split 2 takes {p, r, t}
# in the port and {q, s, u} in JAX (the rows agree, the sides swap).
COMPLEMENT = ("complement", 1, 2)


@pytest.mark.parametrize("cat_smooth,tie", [
    (1.0, (0, 10)), (10.0, None),
    pytest.param(10.0, COMPLEMENT, id="complement-10.0")])
def test_equal_ratio_categories_tie_only_at_small_cat_smooth(cat_smooth,
                                                             tie):
    if tie == COMPLEMENT:
        X, y = complement_data()
        params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
                  "min_data_in_leaf": 20, "tpu_megakernel": "off"}
        jb = lgb.train(dict(params, tpu_frontier_k=1), lgb.Dataset(
            X, label=y), num_boost_round=5)
        jb.num_trees()
        tb = lgt.train(dict(params, device_type="cpu"),
                       lgt.Dataset(X, label=y), num_boost_round=5)
        mappers = tb._gbdt.train_data.bin_mappers
        assert _compare(X, y, "binary", params, jb, tb, mappers,
                        None) == tie[1:]
        assert _is_complement(jb, tb, X, *tie[1:])
        a, b = (bst._gbdt.models[tie[1]] for bst in (jb, tb))
        # the tree's first categorical split: bits {0, 2, 4} against {1, 3, 5}
        assert sorted([a.cat_threshold[0], b.cat_threshold[0]]) == [21, 42]
        return
    X, y = equal_ratio_data()
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "min_data_in_leaf": 20, "cat_smooth": cat_smooth}
    jb = lgb.train(dict(params, tpu_frontier_k=1),
                   lgb.Dataset(X, label=y, categorical_feature=[4, 5]),
                   num_boost_round=4)
    jb.num_trees()
    tb = lgt.train(dict(params, device_type="cpu"),
                   lgt.Dataset(X, label=y, categorical_feature=[4, 5]),
                   num_boost_round=4)
    mappers = tb._gbdt.train_data.bin_mappers
    assert _compare(X, y, "binary", params, jb, tb, mappers, None) == tie
    if tie is None:
        np.testing.assert_allclose(tb.predict(X, raw_score=True),
                                   jb.predict(X, raw_score=True), rtol=0,
                                   atol=1e-5)
