"""The port's exclusive feature bundling (``data/bundling.py``) against the
reference's: the plan on its one-hot and sparse-categorical fixtures
(``tests/test_bundling.py``), eviction of members that conflict past the
sampled prefix, the fold and the transform, and mapper bytes and JSON
that load in either package.  Host numpy on both sides, held bit for
bit."""

import json

import numpy as np
import pytest
from test_bundling import _onehot_csr, _sparse_cat_csr

import dryad_tpu
from dryad_tpu.data import bundling as jb
from dryad_tpu.data.sketch import BinMapper as JBinMapper
from dryad_tpu.data.sketch import sketch_features as j_sketch

import dryad_tpu_torch as dt
from dryad_tpu_torch.data import bundling as tb
from dryad_tpu_torch.data.sketch import BinMapper as TBinMapper
from dryad_tpu_torch.data.sketch import sketch_features as t_sketch
from torch_layout import one_torch_thread  # noqa: F401 (autouse)


def _base(csr, y, cat=()):
    """The unbundled binned matrix and its mapper, in both packages."""
    t = dt.Dataset(None, y, csr=csr, categorical_features=cat, max_bins=64,
                   bundle=False)
    j = dryad_tpu.Dataset(None, y, csr=csr, categorical_features=cat,
                          max_bins=64, bundle=False)
    np.testing.assert_array_equal(t.X_binned, j.X_binned)
    return t, j


@pytest.fixture(scope="module", params=["onehot", "sparse_cat"])
def fixture(request):
    if request.param == "onehot":
        csr, y = _onehot_csr(n=3000)
        return _base(csr, y)
    csr, y, cat = _sparse_cat_csr(n=3000)
    return _base(csr, y, cat)


def test_plan_fold_and_transform_match_reference(fixture):
    t, j = fixture
    plan = tb.plan_bundles(t.X_binned, t.mapper, 64)
    assert plan == jb.plan_bundles(j.X_binned, j.mapper, 64)
    assert len(plan) >= 2
    tm, jm = tb.BundledMapper(t.mapper, plan), jb.BundledMapper(j.mapper,
                                                                plan)
    for k in ("n_bins", "is_categorical", "bundled_mask"):
        np.testing.assert_array_equal(getattr(tm, k), getattr(jm, k))
    folded = tm.fold(t.X_binned)
    np.testing.assert_array_equal(folded, jm.fold(j.X_binned))
    assert folded.dtype == jm.bin_dtype and tm.last_conflict_count == 0
    # raw rows: bin through the base, then fold, with conflicts counted
    rng = np.random.default_rng(1)
    X = np.where(rng.random((400, t.mapper.num_features)) < 0.3, 1.0,
                 0.0).astype(np.float32)
    with pytest.warns(RuntimeWarning, match="EFB fold dropped"):
        got = tm.transform(X)
    with pytest.warns(RuntimeWarning, match="EFB fold dropped"):
        np.testing.assert_array_equal(got, jm.transform(X))
    assert tm.last_conflict_count == jm.last_conflict_count > 0


def test_categorical_bundles_stay_categorical():
    csr, y, cat = _sparse_cat_csr(n=3000)
    t = dt.Dataset(None, y, csr=csr, categorical_features=cat, max_bins=64)
    m = t.mapper
    assert isinstance(m, tb.BundledMapper)
    base_cat = m.base.is_categorical
    assert any(base_cat[b[0]] for b in m.bundles)
    for bi, members in enumerate(m.bundles):
        assert len({bool(base_cat[f]) for f in members}) == 1
        assert m.is_categorical[bi] == base_cat[members[0]]
        if base_cat[members[0]]:
            assert m.n_bins[bi] <= 255


@pytest.mark.parametrize("sparse", [False, True])
def test_plan_evicts_conflicts_beyond_the_sample(sparse):
    """Columns 0 and 1 are exclusive in the planning prefix and collide
    past it (the reference's dense case, where they are too dense to
    bundle at all, and a sparse one, where the prefix bundles them and
    the full-data pass evicts column 1)."""
    rng = np.random.default_rng(67)
    n, S = 3000, 1000
    X = np.zeros((n, 3), np.float32)
    X[:, 2] = rng.normal(size=n)
    if sparse:
        X[:100, 0] = 1.0
        X[100:200, 1] = 1.0
        X[S:S + 300, :2] = 1.0
    else:
        X[: S // 2, 0] = 1.0
        X[S // 2: S, 1] = 1.0
        X[S:, :2] = 1.0
    tm, jm = t_sketch(X, max_bins=16), j_sketch(X, max_bins=16)
    assert tm.to_bytes() == jm.to_bytes()
    Xb = tm.transform(X)
    plan = tb.plan_bundles(Xb, tm, 16, sample_rows=S)
    assert plan == jb.plan_bundles(jm.transform(X), jm, 16, sample_rows=S)
    for members in plan:
        assert not (0 in members and 1 in members), plan
    assert ([0, 1] in tb.plan_bundles(Xb[:S], tm, 16)) == sparse


def test_mapper_bytes_and_json_load_in_either_package(fixture):
    t, j = fixture
    plan = tb.plan_bundles(t.X_binned, t.mapper, 64)
    tm = tb.BundledMapper(t.mapper, plan)
    jm = jb.BundledMapper(j.mapper, plan)
    assert tm.to_bytes() == jm.to_bytes()
    # the port's bytes through the reference's loader (BinMapper.from_bytes
    # dispatches on the efb container) and back
    j_loaded = JBinMapper.from_bytes(tm.to_bytes())
    t_loaded = TBinMapper.from_bytes(jm.to_bytes())
    assert isinstance(j_loaded, jb.BundledMapper)
    assert isinstance(t_loaded, tb.BundledMapper)
    assert j_loaded.bundles == t_loaded.bundles == plan
    assert t_loaded.to_bytes() == jm.to_bytes()
    doc = json.loads(json.dumps(tm.to_json_dict()))
    assert doc == jm.to_json_dict()
    assert tb.mapper_from_json_dict(doc).to_bytes() == jm.to_bytes()
    assert jb.BundledMapper.from_json_dict(doc).to_bytes() == tm.to_bytes()
