"""Training with categorical features, CSR ingest and bundling: the port
(``device="cpu"``, the kernels' plain versions) against the reference's
CPU trainer.

* The reference's tie-free categorical fixtures
  (``tests/test_engine_parity.py``: leaf-wise bagged, depthwise bagged)
  and a bundled sparse-categorical fixture with missing values: integer
  tree arrays, ``is_cat`` and ``cat_bitset`` equal; leaf values within
  1e-4 (the packages sum histograms in different orders and precisions).
* ``criteo_like``: sparse data is tie-heavy, so the reference's own test
  holds its two arms to the root split and AUC within 0.01; at this seed
  every tree agrees, and the test holds that too.
* Wired = legacy and batched = sequential with categoricals, bitwise.
* Model files with categorical bitsets and a bundled mapper load in either
  package with bitwise predictions.
"""

import numpy as np
import pytest
import torch
from test_bundling import _sparse_cat_csr

import dryad_tpu
from dryad_tpu.metrics import auc as j_auc

import dryad_tpu_torch as dt
from dryad_tpu_torch import datasets as tdatasets
from dryad_tpu_torch.data.bundling import BundledMapper
from dryad_tpu_torch.engine.predict import predict_binned
from dryad_tpu_torch.metrics import auc
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

_STRUCT = ("feature", "threshold", "left", "right", "is_cat", "cat_bitset",
           "default_left")


def _fixture_leafwise_bagged():
    rng = np.random.Generator(np.random.Philox(5))
    n = 2000
    cat = rng.integers(0, 12, size=n).astype(np.float32)
    Xnum = rng.normal(size=(n, 5)).astype(np.float32)
    X = np.column_stack([cat, Xnum])
    y = ((cat % 3 == 0).astype(np.float32) * 1.5 + Xnum[:, 0]
         + rng.normal(size=n) * 0.3 > 0.5).astype(np.float32)
    return X, y, dict(objective="binary", num_trees=6, num_leaves=8,
                      max_bins=32, categorical_features=[0], subsample=0.8,
                      colsample=0.8, seed=9)


def _fixture_depthwise_bagged():
    rng = np.random.Generator(np.random.Philox(11))
    n = 2500
    cat = rng.integers(0, 9, size=n).astype(np.float32)
    Xnum = rng.normal(size=(n, 4)).astype(np.float32)
    X = np.column_stack([cat, Xnum])
    y = ((cat % 2 == 0) * 1.2 + Xnum[:, 0] + rng.normal(size=n) * 0.3
         > 0.6).astype(np.float32)
    return X, y, dict(objective="binary", num_trees=5, num_leaves=16,
                      max_depth=4, growth="depthwise", max_bins=32,
                      categorical_features=[0], subsample=0.8, seed=3)


def _same_structure(got, ref):
    for k in _STRUCT:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
        assert got[k].dtype == np.asarray(ref[k]).dtype, k
    np.testing.assert_allclose(got["value"], ref["value"], atol=1e-4)


@pytest.mark.parametrize("make", [_fixture_leafwise_bagged,
                                  _fixture_depthwise_bagged])
def test_categorical_fixtures_match_cpu_trainer(make):
    X, y, params = make()
    jds = dryad_tpu.Dataset(X, y, categorical_features=[0], max_bins=32)
    tds = dt.Dataset(X, y, categorical_features=[0], max_bins=32)
    np.testing.assert_array_equal(tds.X_binned, jds.X_binned)
    jb = dryad_tpu.train(params, jds, backend="cpu")
    tb = dt.train(params, tds, device="cpu")
    assert tb.arrays["is_cat"].any()
    _same_structure(tb.tree_arrays(), jb.tree_arrays())
    # wired = legacy bitwise; for leaf-wise the sequential grower (taken
    # without subtraction, so its leaf sums differ in the last bits) grows
    # the same structure
    ta = dt.train(dict(params, deep_layout="legacy"), tds,
                  device="cpu").tree_arrays()
    for k in _STRUCT + ("value",):
        np.testing.assert_array_equal(ta[k], tb.arrays[k], err_msg=k)
    if params.get("growth") != "depthwise":
        seq = dt.train(dict(params, max_depth=tb.params.max_depth,
                            hist_subtraction=False), tds, device="cpu")
        _same_structure(seq.tree_arrays(), tb.arrays)


def test_criteo_root_split_and_auc_match_reference():
    (indptr, indices, values, F), y, cat = tdatasets.criteo_like(5000,
                                                                  seed=51)
    csr = (indptr, indices, values, F)
    params = dict(objective="binary", num_trees=5, num_leaves=15,
                  max_bins=64, categorical_features=list(cat))
    jds = dryad_tpu.Dataset(None, y, csr=csr, categorical_features=cat,
                            max_bins=64)
    tds = dt.Dataset(None, y, csr=csr, categorical_features=cat,
                     max_bins=64)
    jb = dryad_tpu.train(params, jds, backend="cpu")
    tb = dt.train(params, tds, device="cpu")
    assert tb.arrays["is_cat"].any() and jb.is_cat.any()
    assert tb.arrays["feature"][0, 0] == jb.feature[0, 0]
    assert tb.arrays["is_cat"][0, 0] == jb.is_cat[0, 0]
    np.testing.assert_array_equal(tb.arrays["cat_bitset"][0, 0],
                                  jb.cat_bitset[0, 0])
    # at this seed no near-tie separates the two: every tree agrees
    _same_structure(tb.tree_arrays(), jb.tree_arrays())
    a_t = auc(y, predict_binned(tb, tds.X_binned,
                                device=torch.device("cpu"))[:, 0])
    a_j = j_auc(y, jb.predict_binned(tds.X_binned, raw_score=True))
    assert a_t > 0.6 and abs(a_t - a_j) < 0.01


@pytest.fixture(scope="module")
def bundled():
    """The reference's sparse-categorical bundling fixture with NaN in
    one in ten entries of a dense column, so that the missing-right plane
    is scanned and the bundle columns are kept out of it."""
    (indptr, indices, values, F), y, cat = _sparse_cat_csr()
    values = values.copy()
    values[np.flatnonzero(indices == F - 1)[::10]] = np.nan
    csr = (indptr, indices, values, F)
    params = dict(objective="binary", num_trees=10, num_leaves=15,
                  max_bins=64)
    jds = dryad_tpu.Dataset(None, y, csr=csr, categorical_features=cat,
                            max_bins=64)
    tds = dt.Dataset(None, y, csr=csr, categorical_features=cat,
                     max_bins=64)
    n = indptr.shape[0] - 1
    dense = np.zeros((n, F), np.float32)
    dense[np.repeat(np.arange(n), np.diff(indptr)), indices] = values
    return (jds, dryad_tpu.train(params, jds, backend="cpu"), tds,
            dt.train(params, tds, device="cpu"), dense)


def test_bundled_fixture_matches_cpu_trainer(bundled):
    jds, jb, tds, tb, _ = bundled
    assert isinstance(tds.mapper, BundledMapper) and tds.has_missing
    np.testing.assert_array_equal(tds.X_binned, jds.X_binned)
    _same_structure(tb.tree_arrays(), jb.tree_arrays())
    used = set(tb.arrays["feature"][tb.arrays["is_cat"]].tolist())
    assert any(f < len(tds.mapper.bundles) for f in used)


def test_model_files_load_in_either_package(bundled, tmp_path):
    _, jb, _, tb, dense = bundled
    t_path, j_path = str(tmp_path / "port.dryad"), str(tmp_path / "ref.dryad")
    tb.save(t_path)
    jb.save(j_path)
    # the port's file in the reference, the reference's in the port
    j_of_t = dryad_tpu.Booster.load(t_path)
    t_of_j = dt.Booster.load(j_path)
    assert isinstance(t_of_j.mapper, BundledMapper)
    np.testing.assert_array_equal(
        j_of_t.predict(dense, raw_score=True),
        tb.predict(dense, raw_score=True, device="cpu"))
    np.testing.assert_array_equal(
        t_of_j.predict(dense, raw_score=True, device="cpu"),
        jb.predict(dense, raw_score=True))
    np.testing.assert_array_equal(j_of_t.cat_bitset, tb.arrays["cat_bitset"])
