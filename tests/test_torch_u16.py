"""Wide bins in the port against the JAX package, on the CPU: the uint16
bin matrix (``max_bin`` > 256, ``max_bin_by_feature``, categoricals of
more than 256 levels), the JAX package's uint16 arrays through
``convert``, and a validation set's uint16 bins (the plain kernels at
uint16: test_torch_u16_kernels.py).

Tolerances (ROADMAP's parity bar): bin mappers (``to_dict``), the
binned matrix, its dtype, the groups and the feature metadata are
identical; trees from JAX's arrays equal those of the port's own
binning; validation scores equal raw predictions to atol 1e-5.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops import partition as tpart


def wide_data(n=3000, seed=0):
    """Two normal columns, a skewed one and a 400-level categorical."""
    rng = np.random.RandomState(seed)
    c = rng.randint(0, 400, n).astype(float)
    c[rng.rand(n) < 0.03] = np.nan
    X = np.column_stack([rng.randn(n), rng.exponential(size=n), rng.randn(n),
                         c])
    y = (X[:, 0] + np.isin(c % 13, (1, 4, 7)) * 1.5
         + 0.3 * rng.randn(n) > 0.5).astype(float)
    return X, y


def onehot_beside_wide(n=3000, seed=1):
    """One wide numerical feature beside 6 one-hot columns (EFB bundles
    them; the wide feature stands alone in its group)."""
    rng = np.random.RandomState(seed)
    k = rng.randint(0, 6, n)
    X = np.column_stack([rng.randn(n) * 10, np.eye(6)[k]])
    y = X[:, 0] * 0.1 + (k == 2) + 0.1 * rng.randn(n)
    return X, y


DATASETS = {
    "max_bin_511": (wide_data, {"max_bin": 511}, None),
    "max_bin_1023": (wide_data, {"max_bin": 1023}, None),
    "max_bin_by_feature": (wide_data,
                           {"max_bin_by_feature": "63,255,1023"}, None),
    "cat400": (wide_data, {}, [3]),
    "efb_beside_wide": (onehot_beside_wide, {"max_bin": 1023}, None),
}


def _datasets(case):
    make, params, cats = DATASETS[case]
    X, y = make()
    if cats is None:
        X = X[:, :3] if make is wide_data else X
    p = dict(params, objective="regression", verbosity=-1)
    kw = {} if cats is None else {"categorical_feature": cats}
    jd = lgb.Dataset(X, label=y, params=p, **kw).construct()._inner
    td = lgt.Dataset(X, label=y, params=dict(p, device_type="cpu"),
                     **kw).construct()._inner
    return jd, td


@pytest.mark.parametrize("case", sorted(DATASETS))
def test_u16_mappers_matrix_and_groups_equal_jax(case):
    """Bin mappers, the uint16 matrix and its dtype, the groups (EFB
    bundles beside a wide feature) and the feature metadata are
    bit-identical to lightgbm_tpu's Dataset._inner."""
    jd, td = _datasets(case)
    assert [bm.to_dict() for bm in td.bin_mappers] == \
        [bm.to_dict() for bm in jd.bin_mappers]
    assert [(g.feature_indices, g.bin_offsets, g.num_total_bin)
            for g in td.groups] == \
        [(g.feature_indices, g.bin_offsets, g.num_total_bin)
         for g in jd.groups]
    jb = np.asarray(jd.host_binned())
    assert jb.dtype == td.binned.dtype == td.bin_dtype == np.uint16
    np.testing.assert_array_equal(td.binned, jb)
    mt, mj = td.feature_meta_arrays(), jd.feature_meta_arrays()
    for k in mt:
        np.testing.assert_array_equal(mt[k], mj[k], err_msg=k)
    if case == "max_bin_by_feature":
        assert [bm.num_bin for bm in td.bin_mappers][:2] == [63, 255]
        assert td.max_group_bins > 256
    if case == "cat400":
        assert td.bin_mappers[3].num_bin > 256
    if case == "efb_beside_wide":
        assert any(len(g.feature_indices) > 1 for g in td.groups)
        assert all(g.num_total_bin <= 256 for g in td.groups
                   if len(g.feature_indices) > 1)


def test_u16_arrays_from_jax_train_as_the_ports_own_binning():
    """convert.dataset_from_arrays takes the JAX package's uint16 matrix,
    mappers and groups: 2 trees equal those of the port's own binning; a
    uint8 matrix for these groups is refused."""
    from lightgbm_tpu_torch import convert
    jd, td = _datasets("cat400")
    groups = [(g.feature_indices, g.bin_offsets, g.num_total_bin)
              for g in jd.groups]
    mappers = [bm.to_dict() for bm in jd.bin_mappers]
    y = np.asarray(td.metadata.label)
    params = {"objective": "regression", "verbosity": -1,
              "device_type": "cpu", "num_leaves": 15}
    ds = convert.dataset_from_arrays(np.asarray(jd.host_binned()), mappers,
                                     groups, y, params=params)
    assert ds.binned.dtype == np.uint16
    with pytest.raises(ValueError):
        convert.dataset_from_arrays(np.asarray(jd.host_binned()).astype(
            np.uint8), mappers, groups, y, params=params)
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.models.boosting import GBDT
    from lightgbm_tpu_torch.models.objective import create_objective
    cfg = Config(params)
    models = []
    for inner in (ds, td):
        g = GBDT(cfg, inner, create_objective(cfg), "cpu")
        for _ in range(2):
            g.train_one_iter()
        models.append(g.models)
    for ta, tb in zip(*models):
        assert ta.split_feature.tolist() == tb.split_feature.tolist()
        assert ta.cat_threshold == tb.cat_threshold
        np.testing.assert_array_equal(ta.leaf_value, tb.leaf_value)


def test_u16_validation_scores_equal_predict_and_mega_refuses_u16():
    """A validation set's uint16 bins walked after each tree
    (ops/predict.py predict_leaf_binned) give the raw predictions of its
    rows; the mega kernel's wrapper refuses uint16 bins on the CPU too."""
    X, y = wide_data()
    X = X[:, :3]
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 1023,
              "verbosity": -1, "device_type": "cpu"}
    dt = lgt.Dataset(X[:2000], label=y[:2000])
    dv = lgt.Dataset(X[2000:], label=y[2000:], reference=dt)
    bst = lgt.train(params, dt, 3, valid_sets=[dv])
    g = bst._gbdt
    assert g.valid_sets[0][2].dtype == torch.uint16
    np.testing.assert_allclose(g.valid_scores[0].numpy(),
                               bst.predict(X[2000:], raw_score=True),
                               rtol=0, atol=1e-5)
    from lightgbm_tpu_torch.ops import split_mega as sm
    pb = torch.zeros((2, 512), dtype=torch.uint16)
    with pytest.raises(ValueError):
        sm.split_mega(pb, torch.zeros((8, 512)),
                      tpart.make_scalars(0, 10, 0, 0, 0, 300, 0, 0, 1, 0),
                      num_bins=300, num_groups=2)
