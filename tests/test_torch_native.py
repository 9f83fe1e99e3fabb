"""The port's native host layer (``dryad_tpu_torch/native``, M17) against
its numpy path and the reference's spec, bit for bit: the counterpart of
``tests/test_native.py``.

* The native sketch of the reference's eight column families (ties, NaN,
  +-inf, all-NaN, tiny, the denormal range) and of signed zeros equals
  the port's numpy sketch and ``dryad_tpu.data.sketch.
  _sketch_numerical_np`` bit for bit, signs of zero included; native
  ``bin_matrix`` equals ``BinMapper.transform`` of both packages, also
  with uint16 bins past 256; categorical sketches do not go native.
* A port ``Dataset`` (dense, CSR, bundled CSR) equals the reference's
  ``X_binned``; ``DRYAD_NATIVE=0`` leaves ``native.counts`` at 0.
* Threaded and one-thread sketches and binnings agree.
* An ABI mismatch and a failed build with ``g++`` present raise; no
  ``g++`` takes the numpy path; two processes that build at once both
  load.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import dryad_tpu
from dryad_tpu.data.sketch import _sketch_numerical_np as ref_sketch_np
from dryad_tpu.data.sketch import sketch_features as ref_sketch_features

import dryad_tpu_torch as dt
from dryad_tpu_torch import native
from dryad_tpu_torch.data import binning, sketch
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def native_on(monkeypatch):
    monkeypatch.delenv("DRYAD_NATIVE", raising=False)
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the native host layer cannot build")
    assert native.available()
    native.reset_counts()


def _random_cols(rng):
    # tests/test_native.py's families
    n = 4096
    yield "uniform", rng.standard_normal(n).astype(np.float32)
    yield "heavy-ties", rng.integers(0, 7, n).astype(np.float32)
    yield "constant", np.full(n, 3.25, np.float32)
    col = rng.standard_normal(n).astype(np.float32)
    col[rng.random(n) < 0.3] = np.nan
    yield "nan-mixed", col
    col2 = rng.standard_normal(n).astype(np.float32)
    col2[:16] = np.inf
    col2[16:32] = -np.inf
    yield "inf-tails", col2
    yield "all-nan", np.full(n, np.nan, np.float32)
    yield "tiny", rng.standard_normal(3).astype(np.float32)
    yield "denormal-range", (rng.standard_normal(n) * 1e-38).astype(
        np.float32)
    # both zeros, which compare equal: the edges keep numpy's signs
    zeros = rng.choice(np.array([-0.0, 0.0, 1.0, -1.0], np.float32), n)
    yield "signed-zeros", zeros


def _mixed(n=2000, F=9, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, F)).astype(np.float32)
    X[:, 2] = rng.integers(0, 40, n)            # categorical
    X[:, 5] = rng.integers(0, 500, n)           # categorical with overflow
    X[rng.random((n, F)) < 0.05] = np.nan
    X[:7, 0] = np.inf
    X[7:12, 3] = -np.inf
    return X


@pytest.mark.parametrize("max_bins", [16, 256])
def test_sketch_numerical_bitwise(max_bins):
    rng = np.random.default_rng(0)
    for name, col in _random_cols(rng):
        want = sketch._sketch_numerical_np(col, max_bins)
        got = native.sketch_numerical(col, max_bins)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.edges.view(np.uint32),
                                      err_msg=name)
        np.testing.assert_array_equal(
            got.view(np.uint32),
            ref_sketch_np(col, max_bins).edges.view(np.uint32),
            err_msg=name)
        fb = sketch.sketch_column(col, max_bins, False)
        assert fb.n_bins == want.n_bins
        np.testing.assert_array_equal(fb.edges, want.edges, err_msg=name)
    assert native.counts["sketch"] == 18


def test_bin_matrix_bitwise():
    X = _mixed()
    mapper = sketch.sketch_features(X, max_bins=64,
                                    categorical_features=(2, 5))
    assert native.counts["sketch"] == 7         # numerical columns only
    ref = ref_sketch_features(X, max_bins=64, categorical_features=(2, 5))
    assert mapper.to_json_dict() == ref.to_json_dict()
    got = native.bin_matrix(X, mapper)
    want = mapper.transform(X)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref.transform(X))
    np.testing.assert_array_equal(binning.bin_matrix(X, mapper), want)
    assert native.counts["bin"] == 2


def test_bin_matrix_bitwise_uint16():
    rng = np.random.default_rng(2)
    X = rng.standard_normal((3000, 3)).astype(np.float32)
    X[::17, 1] = np.nan
    mapper = sketch.sketch_features(X, max_bins=1024)
    assert mapper.bin_dtype == np.uint16
    got = native.bin_matrix(X, mapper)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, mapper.transform(X))
    np.testing.assert_array_equal(
        got, ref_sketch_features(X, max_bins=1024).transform(X))


def test_categorical_sketch_unchanged():
    """Categorical columns stay on the numpy path, as in the reference."""
    from dryad_tpu.data.sketch import _sketch_categorical as ref_cat

    col = np.random.default_rng(6).integers(0, 50, 2000).astype(np.float32)
    fb = sketch.sketch_column(col, 32, True)
    want = ref_cat(col, 32)
    assert fb.is_categorical and fb.n_bins == want.n_bins <= 32
    np.testing.assert_array_equal(fb.cat_values, want.cat_values)
    np.testing.assert_array_equal(fb.cat_bins, want.cat_bins)
    assert native.counts["sketch"] == 0


def test_dataset_equals_the_reference_dense_and_csr():
    X = _mixed(1500, seed=3)
    y = (np.nan_to_num(X[:, 0]) > 0).astype(np.float32)
    ds = dt.Dataset(X, y, max_bins=64, categorical_features=(2, 5))
    assert native.counts == {"sketch": 7, "bin": 1}
    ref = dryad_tpu.Dataset(X, y, max_bins=64, categorical_features=(2, 5))
    np.testing.assert_array_equal(ds.X_binned, ref.X_binned)
    # CSR rows (implicit zeros) against their dense matrix, both packages
    rng = np.random.default_rng(5)
    n, F = 800, 12
    Xs = np.zeros((n, F), np.float32)
    mask = rng.random((n, F)) < 0.2
    Xs[mask] = rng.standard_normal(int(mask.sum())).astype(np.float32)
    indptr = np.concatenate([[0], np.cumsum(mask.sum(1))]).astype(np.int64)
    indices = np.nonzero(mask)[1].astype(np.int64)
    ys = (Xs.sum(1) > 0).astype(np.float32)
    csr = dt.Dataset(None, ys, csr=(indptr, indices, Xs[mask], F),
                     max_bins=32, bundle=False)
    dense = dt.Dataset(Xs, ys, max_bins=32)
    np.testing.assert_array_equal(csr.X_binned, dense.X_binned)
    np.testing.assert_array_equal(
        dense.X_binned, dryad_tpu.Dataset(Xs, ys, max_bins=32).X_binned)


def test_bundled_mapper_bins_through_its_base_natively():
    from test_bundling import _onehot_csr

    (indptr, indices, values, F), y = _onehot_csr(2048)
    ds = dt.Dataset(None, y, csr=(indptr, indices, values, F), max_bins=64)
    assert hasattr(ds.mapper, "fold")
    X = np.zeros((2048, F), np.float32)
    X[np.repeat(np.arange(2048), np.diff(indptr)), indices] = values
    native.reset_counts()
    got = ds.mapper.transform(X)
    assert native.counts["bin"] == 1
    np.testing.assert_array_equal(got, ds.X_binned)
    ref = dryad_tpu.Dataset(None, y, csr=(indptr, indices, values, F),
                            max_bins=64)
    np.testing.assert_array_equal(got, ref.X_binned)


def test_native_off_leaves_counts_at_zero(monkeypatch):
    X = _mixed(1000, seed=4)
    y = np.ones(1000, np.float32)
    on = dt.Dataset(X, y, max_bins=64, categorical_features=(2, 5))
    monkeypatch.setenv("DRYAD_NATIVE", "0")
    native.reset_counts()
    assert not native.available()
    assert native.sketch_numerical(X[:, 0], 64) is None
    off = dt.Dataset(X, y, max_bins=64, categorical_features=(2, 5))
    assert native.counts == {"sketch": 0, "bin": 0}
    assert off.mapper.to_json_dict() == on.mapper.to_json_dict()
    np.testing.assert_array_equal(off.X_binned, on.X_binned)


def test_threaded_and_one_thread_agree(monkeypatch):
    X = _mixed(20_000, F=13, seed=7)
    monkeypatch.setattr(sketch, "_SPLIT_CELLS", 1)      # blocks per thread
    monkeypatch.setattr(native, "_BLOCK_ROWS", 1000)    # 20 row blocks
    many = sketch.sketch_features(X, 128, (2, 5))
    b_many = binning.bin_matrix(X, many)
    monkeypatch.setattr(sketch, "_MAX_THREADS", 1)
    monkeypatch.setattr(native, "_MAX_THREADS", 1)
    one = sketch.sketch_features(X, 128, (2, 5))
    assert one.to_json_dict() == many.to_json_dict()
    np.testing.assert_array_equal(binning.bin_matrix(X, one), b_many)
    np.testing.assert_array_equal(b_many, many.transform(X))


def test_abi_mismatch_raises(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_ABI_VERSION", native._ABI_VERSION + 1)
    with pytest.raises(RuntimeError, match="ABI"):
        native.available()
    with pytest.raises(RuntimeError, match="ABI"):
        sketch.sketch_column(np.ones(8, np.float32), 16, False)


def test_failed_build_raises_with_the_log(monkeypatch, tmp_path):
    bad = tmp_path / "dryad_native.cpp"
    bad.write_text("int64_t this does not compile;\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as ei:
        native.available()
    assert "error" in str(ei.value)
    assert not os.listdir(tmp_path / "build")   # no half-written library


def test_no_compiler_takes_the_numpy_path(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    col = np.random.default_rng(8).standard_normal(500).astype(np.float32)
    assert not native.available()
    fb = sketch.sketch_column(col, 32, False)
    np.testing.assert_array_equal(fb.edges,
                                  sketch._sketch_numerical_np(col, 32).edges)
    assert native.counts["sketch"] == 0


def test_two_processes_building_at_once_both_load(tmp_path):
    build = tmp_path / "build"
    code = ("import sys\n"
            "from dryad_tpu_torch import native\n"
            "native.BUILD_DIR = sys.argv[1]\n"
            "assert native.available()\n"
            "import numpy as np\n"
            "print(native.sketch_numerical(np.arange(9, dtype=np.float32),"
            " 4).tolist())\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("DRYAD_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "[3.0, 6.0]"
    assert [f for f in os.listdir(build)] == [
        os.path.basename(native.lib_path())]
