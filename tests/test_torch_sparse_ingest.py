"""The port's sparse ingest against the reference: ``criteo_like``, the
categorical sketch, ``_sketch_csr``, ``zero_bins`` and ``bin_csr``
(threaded over row blocks), categorical binning of unknown and missing
values, and ``Dataset.has_missing``.  Everything here is host numpy on
both sides and is held bit for bit: binned matrices, mapper bytes."""

import numpy as np
import pytest

import dryad_tpu
from dryad_tpu import datasets as jdatasets
from dryad_tpu import dataset as jdataset
from dryad_tpu.data import binning as jbinning
from dryad_tpu.data.sketch import _sketch_categorical as j_sketch_cat

import dryad_tpu_torch as dt
from dryad_tpu_torch import dataset as tdataset
from dryad_tpu_torch import datasets as tdatasets
from dryad_tpu_torch.data import binning as tbinning
from dryad_tpu_torch.data.sketch import _sketch_categorical as t_sketch_cat
from torch_layout import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def criteo():
    return tdatasets.criteo_like(3000, seed=53)


def test_criteo_like_is_the_references():
    for n, seed in ((3000, 53), (2000, 19)):
        (tp, ti, tv, tf), ty, tc = tdatasets.criteo_like(n, seed=seed)
        (jp, ji, jv, jf), jy, jc = jdatasets.criteo_like(n, seed=seed)
        for a, b in ((tp, jp), (ti, ji), (tv, jv), (ty, jy)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert (tf, tc) == (jf, jc)


def test_categorical_sketch_matches_reference():
    rng = np.random.default_rng(5)
    col = rng.zipf(1.3, 5000).astype(np.float32) % 300
    col[rng.random(5000) < 0.05] = np.nan
    for max_bins in (16, 64, 256, 1024):
        t, j = t_sketch_cat(col, max_bins), j_sketch_cat(col, max_bins)
        assert t.n_bins == j.n_bins and t.is_categorical
        np.testing.assert_array_equal(t.cat_values, j.cat_values)
        np.testing.assert_array_equal(t.cat_bins, j.cat_bins)


def test_csr_sketch_and_binning_match_reference(criteo, monkeypatch):
    csr, y, cat = criteo
    tm = tdataset._sketch_csr(*csr, 64, cat)
    jm = jdataset._sketch_csr(*csr, 64, cat)
    assert tm.to_bytes() == jm.to_bytes()
    np.testing.assert_array_equal(tbinning.zero_bins(tm),
                                  jbinning.zero_bins(jm))
    ref = jbinning.bin_csr(*csr, jm)
    # blocks of 256 rows: a dozen blocks on the thread pool
    for block_rows in (256, 65536):
        monkeypatch.setattr(tbinning, "_BLOCK_ROWS", block_rows)
        got = tbinning.bin_csr(*csr, tm)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bundle", [True, False])
def test_dataset_csr_ingest_matches_reference(criteo, bundle):
    csr, y, cat = criteo
    t = dt.Dataset(None, y, csr=csr, categorical_features=cat, max_bins=64,
                   bundle=bundle)
    j = dryad_tpu.Dataset(None, y, csr=csr, categorical_features=cat,
                          max_bins=64, bundle=bundle)
    assert t.mapper.is_categorical.sum() == len(cat)
    np.testing.assert_array_equal(t.X_binned, j.X_binned)
    assert t.mapper.to_bytes() == j.mapper.to_bytes()
    assert t.has_missing == j.has_missing


def test_csr_and_dense_ingest_agree(criteo):
    (indptr, indices, values, F), y, cat = criteo
    n = indptr.shape[0] - 1
    dense = np.zeros((n, F), np.float32)
    dense[np.repeat(np.arange(n), np.diff(indptr)), indices] = values
    ds_csr = dt.Dataset(None, y, csr=(indptr, indices, values, F),
                        categorical_features=cat, max_bins=64, bundle=False)
    ds_dense = dt.Dataset(dense, y, categorical_features=cat, max_bins=64)
    np.testing.assert_array_equal(ds_csr.X_binned, ds_dense.X_binned)
    assert ds_csr.mapper.to_bytes() == ds_dense.mapper.to_bytes()
    # a CSR valid set binds through the train mapper like dense rows
    dv = ds_csr.bind(None, y[:500], csr=(indptr[:501], indices, values, F))
    np.testing.assert_array_equal(dv.X_binned, ds_dense.X_binned[:500])
    with pytest.raises(ValueError, match="exactly one"):
        dt.Dataset(dense, y, csr=(indptr, indices, values, F))


def test_unknown_and_missing_categories():
    rng = np.random.default_rng(9)
    X = np.column_stack([rng.integers(0, 40, 2000),
                         rng.normal(size=2000)]).astype(np.float32)
    t = dt.Dataset(X, categorical_features=[0], max_bins=16)
    j = dryad_tpu.Dataset(X, categorical_features=[0], max_bins=16)
    assert t.mapper.to_bytes() == j.mapper.to_bytes()
    fb = t.mapper.features[0]
    probe = np.array([[fb.cat_values[0], 0.5], [1e6, 0.5], [np.nan, 0.5],
                      [-3.0, 0.5]], np.float32)
    got = t.mapper.transform(probe)
    np.testing.assert_array_equal(got, j.mapper.transform(probe))
    assert got[0, 0] == fb.cat_bins[0]
    assert got[1, 0] == fb.overflow_bin == got[3, 0] == 15
    assert got[2, 0] == 0


def _nan_in(csr, cols, every):
    """A copy of a CSR triple with NaN in every ``every``-th stored entry
    of the given columns."""
    indptr, indices, values, F = csr
    values = values.copy()
    values[np.flatnonzero(np.isin(indices, cols))[::every]] = np.nan
    return indptr, indices, values, F


@pytest.mark.parametrize("nan_cols", [(), (2,), (3,)])
def test_has_missing_matches_reference(nan_cols):
    """``_onehot_csr`` bundles its one-hot columns 3..32: NaN in a dense
    column (2) scans the missing-right plane, NaN in a bundled member (3)
    does not."""
    from test_bundling import _onehot_csr

    csr, y = _onehot_csr(n=1500)
    csr = _nan_in(csr, list(nan_cols), 5)
    t = dt.Dataset(None, y, csr=csr, max_bins=64)
    j = dryad_tpu.Dataset(None, y, csr=csr, max_bins=64)
    np.testing.assert_array_equal(t.X_binned, j.X_binned)
    assert t.mapper.bundled_mask.any()
    assert t.has_missing == j.has_missing == (nan_cols == (2,))
