"""The port's out-of-core streamed datasets against the reference's
``dryad_tpu.data.stream_dataset`` and ``dryad_tpu.data.streaming``.

Files, chunk builders, the keyed draw and mappers are host numpy on both
sides and are held bit for bit: a spill written by either package reads
in the other.  Streamed training is held to resident training bit for bit
(every tree array, values included: both runs grow on the same device
tensor), at two ragged chunkings, on both growths and both depthwise
arms; the resident run is held to the reference's CPU trainer on the
reference's own fixture (``tests/test_stream_train.py``: integer tree
arrays equal, leaf values within 1e-4, the packages summing histograms in
different orders).
"""

import threading

import numpy as np
import pytest
import torch

import dryad_tpu
from dryad_tpu.data import stream_dataset as jsd
from dryad_tpu.data import streaming as jst

import dryad_tpu_torch as dt
from dryad_tpu_torch import datasets as tdatasets
from dryad_tpu_torch.data import stream_dataset as tsd
from dryad_tpu_torch.data import streaming as tst
from dryad_tpu_torch.dataset import Dataset
from dryad_tpu_torch.engine import train as ttrain
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

KEYS = ("feature", "threshold", "left", "right", "default_left", "value",
        "cover", "gain")
INT_KEYS = ("feature", "threshold", "left", "right", "default_left")
CHUNKINGS = (700, 1231)          # neither divides 3000
PARAMS = dict(objective="binary", num_trees=8, num_leaves=7, max_bins=32,
              seed=3, min_data_in_leaf=5)


def same_booster(a, b):
    ta, tb = a.tree_arrays(), b.tree_arrays()
    for k in KEYS:
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
    np.testing.assert_array_equal(a.init_score, b.init_score)


@pytest.fixture(scope="module")
def raw():
    return tdatasets.higgs_like(3000, seed=21)


@pytest.fixture(scope="module")
def data(raw):
    X, y = raw
    return dt.Dataset(X, y, max_bins=32)


@pytest.fixture(scope="module")
def valid(data):
    Xv, yv = tdatasets.higgs_like(800, seed=22)
    return data.bind(Xv, yv)


def spill(ds, tmp_path, chunk_rows, name="bins.stream"):
    return tsd.StreamedDataset.from_dataset(
        ds, str(tmp_path / f"{chunk_rows}_{name}"), chunk_rows=chunk_rows)


# ---- files and accessors ----------------------------------------------------

def test_spill_reads_in_both_packages(data, raw, tmp_path):
    X, y = raw
    jds = dryad_tpu.Dataset(X, y, max_bins=32)
    np.testing.assert_array_equal(jds.X_binned, data.X_binned)
    t = spill(data, tmp_path, 700)
    j = jsd.StreamedDataset.from_dataset(jds, str(tmp_path / "ref.bins"),
                                         chunk_rows=700)
    with open(t.path, "rb") as a, open(j.path, "rb") as b:
        assert a.read() == b.read()
    # each package reads the other's file
    j_of_t = jsd.StreamedDataset(t.path, jds.mapper, y, chunk_rows=1231)
    t_of_j = tsd.StreamedDataset(j.path, data.mapper, y, chunk_rows=1231)
    np.testing.assert_array_equal(j_of_t.read_rows(0, 3000), data.X_binned)
    np.testing.assert_array_equal(t_of_j.read_rows(0, 3000), data.X_binned)
    assert t_of_j.num_rows == 3000 and t_of_j.num_chunks == 3


def test_accessors_match_reference(data, raw, tmp_path):
    X, y = raw
    t = spill(data, tmp_path, 700)
    j = jsd.StreamedDataset(t.path, dryad_tpu.Dataset(X, y, max_bins=32)
                            .mapper, y, chunk_rows=700)
    Xb = data.X_binned
    assert (t.num_rows, t.num_features, t.num_chunks) == (
        j.num_rows, j.num_features, j.num_chunks)
    for lo, hi in ((0, 3000), (693, 1402), (5, 5), (2999, 3000)):
        np.testing.assert_array_equal(t.read_rows(lo, hi), j.read_rows(lo, hi))
    for prefetch in (2, 1, 0):
        got = [(lo, hi, buf) for lo, hi, buf in t.iter_chunks(prefetch)]
        ref = list(j.iter_chunks(prefetch))
        assert [(lo, hi) for lo, hi, _ in got] == [(lo, hi)
                                                   for lo, hi, _ in ref]
        np.testing.assert_array_equal(
            np.concatenate([b for *_, b in got]), Xb)
    for stride in (1, 3, 700, 997):
        np.testing.assert_array_equal(t.strided_rows(stride), Xb[::stride])
    assert t.has_missing == j.has_missing == data.has_missing
    view = t.binned_view()
    assert view.shape == Xb.shape and len(view) == 3000
    rng = np.random.default_rng(5)
    rows = np.sort(rng.choice(3000, 900, replace=False))
    np.testing.assert_array_equal(view[rows], Xb[rows])
    np.testing.assert_array_equal(view[rows, 7], j.binned_view()[rows, 7])
    dup = np.sort(rng.integers(0, 3000, 400))
    np.testing.assert_array_equal(view[dup, 2], Xb[dup, 2])
    assert view[np.empty(0, np.int64)].shape == (0, t.num_features)
    with pytest.raises(ValueError, match="ascending"):
        view[rows[::-1]]
    with pytest.raises(IndexError):
        view[np.array([3000])]
    with pytest.raises(ValueError, match="row range"):
        t.read_rows(0, 3001)
    with pytest.raises(TypeError):
        t.X_binned
    m = t.materialize()
    np.testing.assert_array_equal(m.X_binned, Xb)
    assert not m.is_streamed and t.is_streamed


def test_spill_sink_checks(tmp_path):
    sink = tsd.SpillSink(str(tmp_path / "over.bins"), 10, 4,
                         np.dtype(np.uint8))
    sink.write(np.zeros((8, 4), np.uint8))
    with pytest.raises(ValueError, match="more than the declared"):
        sink.write(np.zeros((3, 4), np.uint8))
    with pytest.raises(ValueError, match=r"\(\*, 4\)"):
        sink.write(np.zeros((2, 5), np.uint8))
    with pytest.raises(ValueError, match="expected"):
        tsd.SpillSink(str(tmp_path / "short.bins"), 10, 4,
                      np.dtype(np.uint8)).finish()


def test_uint16_spill_matches_reference(tmp_path):
    X, y = tdatasets.higgs_like(1500, seed=23)
    tds = dt.Dataset(X, y, max_bins=512)
    jds = dryad_tpu.Dataset(X, y, max_bins=512)
    assert tds.X_binned.dtype == np.uint16
    t = tsd.StreamedDataset.from_dataset(tds, str(tmp_path / "t16.bins"),
                                         chunk_rows=333)
    j = jsd.StreamedDataset.from_dataset(jds, str(tmp_path / "j16.bins"),
                                         chunk_rows=333)
    with open(t.path, "rb") as a, open(j.path, "rb") as b:
        assert a.read() == b.read()
    Xd, yd, wd = t.device_arrays(torch.device("cpu"))
    assert Xd.dtype == torch.int32 and wd is None
    np.testing.assert_array_equal(Xd.numpy(), tds.X_binned.astype(np.int32))
    np.testing.assert_array_equal(yd.numpy(), y)


# ---- the prefetcher ---------------------------------------------------------

def _reader_threads():
    return [t for t in threading.enumerate()
            if t.name == "dryad-chunk-prefetch"]


def test_prefetcher_order_error_and_close():
    pf = tsd.ChunkPrefetcher(lambda i: np.full(3, i), 7, depth=2)
    assert [(i, int(c[0])) for i, c in pf] == [(i, i) for i in range(7)]
    pf.close()
    assert not pf._thread.is_alive()

    def bad(i):
        if i == 3:
            raise OSError("disk gone")
        return np.full(2, i)

    pf = tsd.ChunkPrefetcher(bad, 6, depth=1)
    got = []
    with pytest.raises(OSError, match="disk gone"):
        for i, _ in pf:
            got.append(i)
    assert got == [0, 1, 2]
    pf.close()
    assert not pf._thread.is_alive()
    # close() mid-stream, with the producer blocked on a full queue
    before = len(_reader_threads())
    pf = tsd.ChunkPrefetcher(lambda i: np.full(2, i), 1000, depth=1)
    it = iter(pf)
    assert next(it)[0] == 0
    pf.close()
    assert not pf._thread.is_alive() and len(_reader_threads()) == before
    pf.close()                   # idempotent


def test_iter_chunks_closes_its_reader_on_break(data, tmp_path):
    t = spill(data, tmp_path, 200, "brk.bins")
    before = len(_reader_threads())
    for lo, _hi, _buf in t.iter_chunks(prefetch=2):
        if lo >= 400:
            break
    assert len(_reader_threads()) == before


# ---- chunk builders ---------------------------------------------------------

@pytest.mark.parametrize("offset,n,seed", [(0, 1000, 0), (12345, 777, 9),
                                           (2 ** 40, 64, 123)])
def test_keyed_uniform_bitwise(offset, n, seed):
    np.testing.assert_array_equal(tst.keyed_uniform(offset, n, seed),
                                  jst._keyed_uniform(offset, n, seed))


def _dense_chunks():
    N, F = 2000, 16
    rng = np.random.default_rng(9)
    X = rng.standard_normal((N, F)).astype(np.float32)
    X[rng.random((N, F)) < 0.05] = np.nan
    y = (X[:, 0] > 0.1).astype(np.float32)

    def chunks():
        for lo in range(0, N, 517):
            yield X[lo:lo + 517]

    return chunks, X, y


def test_sketch_stream_and_dataset_from_chunks(tmp_path):
    chunks, X, y = _dense_chunks()
    N, F = X.shape
    kw = dict(max_bins=32, sample_rows=900, seed=4)
    tm = tst.sketch_stream(chunks, N, **kw)
    jm = jst.sketch_stream(chunks, N, **kw)
    assert tm.to_bytes() == jm.to_bytes()
    jres = jst.dataset_from_chunks(chunks, y, N, F, **kw)
    res = tst.dataset_from_chunks(chunks, y, N, F, **kw)
    assert res.mapper.to_bytes() == jres.mapper.to_bytes()
    np.testing.assert_array_equal(res.X_binned, jres.X_binned)
    stm = tst.dataset_from_chunks(chunks, y, N, F, **kw,
                                  spill=str(tmp_path / "cb.bins"),
                                  chunk_rows=601)
    assert stm.is_streamed and stm.chunk_rows == 601
    np.testing.assert_array_equal(stm.read_rows(0, N), jres.X_binned)
    assert stm.has_missing == res.has_missing
    # a given mapper skips the sketch pass
    again = tst.dataset_from_chunks(chunks, y, N, F, mapper=res.mapper,
                                    spill=str(tmp_path / "cb2.bins"))
    assert again.chunk_rows == tsd.DEFAULT_CHUNK_ROWS
    np.testing.assert_array_equal(again.read_rows(0, N), res.X_binned)
    with pytest.raises(ValueError, match="expected"):
        tst.dataset_from_chunks(chunks, y, N + 1, F, mapper=res.mapper)


def _onehot_csr(n=2048, groups=6, levels=5, num_dense=3, seed=61):
    """Dense numeric columns plus groups of strictly exclusive one-hot
    columns, CSR encoded (the reference's bundling fixture's shape)."""
    rng = np.random.default_rng(seed)
    F = num_dense + groups * levels
    dense = rng.normal(size=(n, num_dense)).astype(np.float32)
    cat = rng.integers(0, levels, size=(n, groups))
    cols = np.concatenate(
        [np.tile(np.arange(num_dense), (n, 1)),
         num_dense + np.arange(groups) * levels + cat], axis=1)
    vals = np.concatenate([dense, np.ones((n, groups), np.float32)], 1)
    indptr = np.arange(n + 1, dtype=np.int64) * cols.shape[1]
    y = (dense[:, 0] + (cat[:, 0] == 2) * 1.5 - (cat[:, 1] >= 3)
         + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    return (indptr, cols.reshape(-1).astype(np.int64),
            vals.reshape(-1).astype(np.float32), F), y


def test_dataset_from_csr_chunks_matches_reference(tmp_path):
    (indptr, cols, vals, F), y = _onehot_csr()
    n = 2048

    def chunks():
        for lo in range(0, n, 600):
            hi = min(lo + 600, n)
            a, b = indptr[lo], indptr[hi]
            yield indptr[lo:hi + 1] - a, cols[a:b], vals[a:b]

    kw = dict(max_bins=64, sample_rows=1500, seed=2)
    assert (tst.sketch_stream_csr(chunks, n, F, **kw).to_bytes()
            == jst.sketch_stream_csr(chunks, n, F, **kw).to_bytes())
    jres = jst.dataset_from_csr_chunks(chunks, y, n, F, **kw)
    res = tst.dataset_from_csr_chunks(chunks, y, n, F, **kw)
    assert res.mapper.bundles and res.num_features < F
    assert res.mapper.to_bytes() == jres.mapper.to_bytes()
    np.testing.assert_array_equal(res.X_binned, jres.X_binned)
    stm = tst.dataset_from_csr_chunks(chunks, y, n, F, **kw,
                                      spill=str(tmp_path / "csr.bins"),
                                      chunk_rows=777)
    assert stm.num_features == res.num_features
    np.testing.assert_array_equal(stm.read_rows(0, n), jres.X_binned)
    flat = tst.dataset_from_csr_chunks(chunks, y, n, F, bundle=False, **kw)
    np.testing.assert_array_equal(
        flat.X_binned, jst.dataset_from_csr_chunks(
            chunks, y, n, F, bundle=False, **kw).X_binned)
    p = dict(PARAMS, num_trees=3, growth="depthwise", max_depth=3)
    same_booster(dt.train(p, res, device="cpu"),
                 dt.train(p, stm, device="cpu"))


# ---- streamed training = resident training ----------------------------------

@pytest.mark.parametrize("growth,extra", [
    ("leafwise", {}),
    ("depthwise", {"max_depth": 4}),
    ("depthwise", {"max_depth": 4, "deep_layout": "legacy"}),
])
def test_streamed_equals_resident(data, raw, tmp_path, growth, extra):
    p = dict(PARAMS, num_trees=4, growth=growth, **extra)
    ref = dt.train(p, data, device="cpu")
    for chunk_rows in CHUNKINGS:
        got = dt.train(p, spill(data, tmp_path, chunk_rows,
                                f"{growth}{len(extra)}.bins"), device="cpu")
        same_booster(ref, got)
    # and the resident run is the reference's CPU trainer's
    X, y = raw
    jb = dryad_tpu.train(p, dryad_tpu.Dataset(X, y, max_bins=32),
                         backend="cpu")
    got, want = ref.to_reference_arrays(), jb.tree_arrays()
    for k in INT_KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["value"], want["value"], atol=1e-4)


@pytest.mark.parametrize("extra", [{"boosting": "goss"},
                                   {"subsample": 0.7, "colsample": 0.7}])
def test_streamed_sampling_and_early_stopping(data, valid, tmp_path, extra):
    sds = spill(data, tmp_path, 700, f"es{len(extra)}.bins")
    p = dict(PARAMS, num_trees=30, early_stopping_rounds=3, **extra)
    # early stopping scores every iteration synchronously; the history is
    # what the loop hands its callback
    hist = {"ref": [], "got": []}
    ref = dt.train(p, data, [valid], device="cpu",
                   callback=lambda it, info: hist["ref"].append(info))
    got = dt.train(p, sds, [valid], device="cpu",
                   callback=lambda it, info: hist["got"].append(info))
    same_booster(ref, got)
    assert got.best_iteration == ref.best_iteration
    assert hist["got"] == hist["ref"] and len(hist["ref"]) > 3


def test_streamed_resume_equals_straight_run(data, tmp_path):
    p = dict(PARAMS, num_trees=6, subsample=0.8, growth="depthwise",
             max_depth=3)
    straight = dt.train(p, data, device="cpu")
    sds = spill(data, tmp_path, 1231, "resume.bins")
    ck = str(tmp_path / "ck")
    # a run cut after iteration 4, its newest checkpoint at 4
    dt.train(dict(p, num_trees=4), sds, device="cpu", checkpoint_dir=ck,
             checkpoint_every=2)
    resumed = dt.train(p, sds, device="cpu", checkpoint_dir=ck,
                       checkpoint_every=2, resume=True)
    same_booster(straight, resumed)


# ---- gates ------------------------------------------------------------------

def test_streamed_gates(data, tmp_path):
    sds = spill(data, tmp_path, 700, "gates.bins")
    p = dict(PARAMS, num_trees=2, growth="depthwise", max_depth=3)
    with pytest.raises(ValueError, match="materialize"):
        dt.train(p, data, [sds], device="cpu")
    with pytest.raises(ValueError, match="streamed"):
        ttrain.check_group_supported(dt.Params.from_dict(p), sds)
    same_booster(dt.train(p, data, device="cpu"),
                 dt.train(p, sds.materialize(), device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sds.device_arrays(torch.device("cuda"))
        with pytest.raises(RuntimeError, match="CUDA"):
            dt.train(p, sds)


def test_streamed_set_refused_under_a_group(data, tmp_path):
    """The process-group path refuses a streamed set before any
    collective, through ``train_distributed`` as a user calls it (a gloo
    group of this process alone)."""
    import torch.distributed as tdist

    from dryad_tpu_torch import distributed as dd

    sds = spill(data, tmp_path, 700, "group.bins")
    dd.initialize(backend="gloo", init_method=f"file://{tmp_path}/store",
                  rank=0, world_size=1, timeout_s=60)
    try:
        with pytest.raises(ValueError, match="streamed"):
            dd.train_distributed(dict(PARAMS, num_trees=2), sds,
                                 device="cpu")
    finally:
        tdist.destroy_process_group()


def test_upload_is_memoized(data, monkeypatch):
    calls = []
    real = Dataset._upload_matrix

    def counted(self, device):
        calls.append(str(device))
        return real(self, device)

    monkeypatch.setattr(Dataset, "_upload_matrix", counted)
    ds = Dataset.from_binned(data.X_binned, data.mapper, data.y)
    p = dict(PARAMS, num_trees=2, growth="depthwise", max_depth=3)
    a = dt.train(p, ds, device="cpu")
    b = dt.train(p, ds, device="cpu")
    assert calls == ["cpu"]
    same_booster(a, b)
    assert ds.device_arrays("cpu")[0] is ds.device_arrays("cpu")[0]
