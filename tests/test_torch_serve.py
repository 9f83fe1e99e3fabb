"""The port's serving stack (``dryad_tpu_torch.serve``) on the CPU, held to
the contract of ``tests/test_serve.py`` with its fixtures.

* The reference's ``PredictServer(backend="cpu")`` and the port's
  ``PredictServer(device="cpu")`` serve the same model file (written by
  the reference): outputs bitwise equal, binary and 3-class, raw and
  transformed, at every bucket boundary n in {0, 1, 7, 8, 9, 15, 16, 17,
  33}; an rf and a categorical model too (the bitset arm).
* The tree-at-once program (``predict.forest_scores``) is bitwise
  ``accumulate`` on the packed, SoA and bitset arms.
* Registry (hot swap, rollback, names, LRU budget, unload), batcher
  (coalescing, backpressure, timeouts, stop draining, stop/start races),
  per-model stats, the recompile accounting and the bench.
* The server refuses ``device="cuda"`` without a card.

Every thread a test starts is joined with a timeout and every predict
carries one, so no test can hang the suite.
"""

import threading
import time

import numpy as np
import pytest
import torch

import dryad_tpu
from dryad_tpu.checkpoint import Checkpointer as JCheckpointer
from dryad_tpu.datasets import higgs_like
from dryad_tpu.serve import PredictServer as JPredictServer

import dryad_tpu_torch as dt
from dryad_tpu_torch.engine import predict as P
from dryad_tpu_torch.serve import (MicroBatcher, ModelRegistry, PredictServer,
                                   Request, ServeMetrics, ServeOverloaded,
                                   ServeTimeout, bucket_rows, run_bench,
                                   run_bench_compare)
from dryad_tpu_torch.serve.bench import run_bench_layout, summary_line
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

T_OUT = 30.0          # every predict and join in this file


def _cat_data(n=2000, seed=7):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    X[:, 0] = rng.integers(0, 12, n)
    X[rng.random((n, 6)) < 0.1] = np.nan
    y = ((X[:, 0] % 3 == 0) ^ (np.nan_to_num(X[:, 1]) > 0)).astype(
        np.float32)
    return X, y


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{kind: (path of the reference's model file, raw rows, port booster)}
    for tests/test_serve.py's two fixtures, an rf and a categorical
    model."""
    d = tmp_path_factory.mktemp("models")
    out = {}
    X, y = higgs_like(600, seed=7)
    specs = {"binary": (X, y, dict(objective="binary", num_trees=8,
                                   num_leaves=7, max_bins=32), {}),
             "rf": (X, y, dict(objective="binary", boosting="rf",
                               num_trees=6, num_leaves=7, max_bins=32,
                               subsample=0.7, colsample=0.8, seed=3), {})}
    rng = np.random.default_rng(3)
    Xm = rng.standard_normal((500, 8)).astype(np.float32)
    ym = (Xm[:, 0] + Xm[:, 1] > 0).astype(np.float32) + (Xm[:, 2] > 0.5)
    specs["multiclass"] = (Xm, ym, dict(objective="multiclass", num_class=3,
                                        num_trees=4, num_leaves=7,
                                        max_bins=32), {})
    Xc, yc = _cat_data()
    specs["categorical"] = (Xc, yc, dict(objective="binary", num_trees=6,
                                         num_leaves=15, max_bins=64),
                            {"categorical_features": [0]})
    for kind, (Xk, yk, params, dkw) in specs.items():
        ds = dryad_tpu.Dataset(Xk, yk, max_bins=params["max_bins"], **dkw)
        jb = dryad_tpu.train(params, ds, backend="cpu")
        path = str(d / f"{kind}.dryad")
        jb.save(path)
        out[kind] = (path, Xk, dt.Booster.load(path))
    assert out["categorical"][2].has_categorical_splits
    return out


def _server(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("max_wait_ms", 0.2)
    return PredictServer(**kw)


def _run_threads(fns):
    threads = [threading.Thread(target=f, daemon=True) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(T_OUT)
    assert not any(t.is_alive() for t in threads)


def test_bucket_rows():
    assert [bucket_rows(n) for n in (1, 7, 8, 9, 16, 17)] == [8, 8, 8, 16,
                                                              16, 32]
    assert bucket_rows(100, 8, 64) == 64
    with pytest.raises(ValueError):
        bucket_rows(0)


@pytest.mark.parametrize("kind", ["binary", "multiclass", "rf",
                                  "categorical"])
def test_served_bitwise_reference_server(files, kind):
    """Padded, bucketed and chunked (33 > 16) serving equals the
    reference's server on the same file and the port's direct predict,
    bitwise, raw and transformed."""
    path, X, tb = files[kind]
    ref = JPredictServer(backend="cpu", max_batch_rows=16, max_wait_ms=0.5,
                         min_bucket=8)
    ref.load_model(path)
    server = _server(max_batch_rows=16, max_wait_ms=0.5, min_bucket=8)
    server.load_model(path)
    with ref, server:
        for n in (0, 1, 7, 8, 9, 15, 16, 17, 33):
            for raw in (False, True):
                want = ref.predict(X[:n], raw_score=raw, timeout=T_OUT)
                got = server.predict(X[:n], raw_score=raw, timeout=T_OUT)
                direct = tb.predict(X[:n], raw_score=raw, device="cpu")
                assert got.dtype == want.dtype and got.shape == want.shape
                assert np.array_equal(got, want), (n, raw)
                assert np.array_equal(got, direct), (n, raw)
    snap = server.stats()
    assert snap["cache_compiles"] == 2          # buckets {8, 16} only
    assert snap["cache_hits"] > 0 and snap["device"] == "cpu"


def test_served_binned_multiclass(files):
    path, X, tb = files["multiclass"]
    Xb = tb.mapper.transform(X)
    server = _server(max_batch_rows=64)
    server.load_model(path)
    with server:
        for n in (1, 9, 33):
            direct = tb.predict_binned(Xb[:n], device="cpu")
            got = server.predict(Xb[:n], binned=True, timeout=T_OUT)
            assert direct.shape == (n, 3) and np.array_equal(got, direct)


def _stage(booster, layout, device="cpu"):
    table, value, bitset, init, _ = P.stage_trees(booster, layout=layout)
    return (P.table_to(table, device), torch.from_numpy(value),
            None if bitset is None else torch.from_numpy(bitset),
            torch.from_numpy(init))


@pytest.mark.parametrize("kind,layout", [
    ("binary", "packed"), ("binary", "legacy"), ("multiclass", "packed"),
    ("multiclass", "legacy"), ("categorical", "packed"),
    ("categorical", "legacy")])
def test_forest_scores_bitwise_accumulate(files, kind, layout):
    """The tree-at-once program against the per-tree ``accumulate``: packed
    words, the SoA dict, and the bitset arm of a categorical model."""
    _, X, tb = files[kind]
    Xb = torch.from_numpy(tb.mapper.transform(X))
    table, value, bitset, init = _stage(tb, layout)
    assert (bitset is not None) == (kind == "categorical")
    depth = max(tb.max_depth_seen, 1)
    want = P.accumulate(table, value, Xb, init, depth, bitset)
    got = P.forest_scores(table, value, Xb, init, depth, bitset)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    leaves = P.forest_leaves(table, Xb, depth, bitset)
    M = value.shape[1]
    for t in (0, P.table_len(table) - 1):
        np.testing.assert_array_equal(
            leaves[:, t] - t * M,
            P.tree_leaves(P.table_slot(table, t), Xb, depth,
                          None if bitset is None else bitset[t]))


def test_forest_scores_wide_feature_ids():
    """Feature ids past the packed width traverse through the SoA arm."""
    rng = np.random.default_rng(0)
    T, M, F, N = 3, 7, 4100, 50
    f = np.full((T, M), -1, np.int64)
    f[:, 0] = [4099, 3, 4098]
    tab = {"feature": f, "threshold": np.full((T, M), 5, np.int64),
           "left": np.zeros((T, M), np.int64),
           "right": np.zeros((T, M), np.int64),
           "default_left": np.zeros((T, M), np.int64),
           "is_cat": np.zeros((T, M), np.int64)}
    tab["left"][:, 0], tab["right"][:, 0] = 1, 2
    table = P.table_to(tab, "cpu")
    value = torch.from_numpy(rng.normal(size=(T, M)).astype(np.float32))
    Xb = torch.from_numpy(rng.integers(0, 16, (N, F)).astype(np.uint8))
    init = torch.tensor([0.25], dtype=torch.float32)
    assert torch.equal(P.forest_scores(table, value, Xb, init, 1),
                       P.accumulate(table, value, Xb, init, 1))


def test_server_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PredictServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PredictServer(device="cuda")


def test_registry_hot_swap_and_rollback(files):
    booster_a, booster_b = files["binary"][2], files["multiclass"][2]
    reg = ModelRegistry()
    v1 = reg.add(booster_a)
    v2 = reg.add(booster_b, activate=False)
    assert (reg.active_version, reg.versions()) == (v1, [v1, v2])
    reg.activate(v2)
    assert reg.active_version == v2
    assert reg.rollback() == v1 and reg.active_version == v1
    with pytest.raises(ValueError):
        reg.unload(v1)
    reg.unload(v2)
    assert reg.versions() == [v1]
    with pytest.raises(KeyError):
        reg.get(v2)
    with pytest.raises(LookupError):
        ModelRegistry().get()
    with pytest.raises(LookupError):
        reg.rollback()


def test_hot_swap_changes_served_model(files):
    _, X, booster_a = files["binary"]
    _, Xm, booster_b = files["multiclass"]
    server = _server()
    v1 = server.registry.add(booster_a)
    v2 = server.registry.add(booster_b, activate=False)

    def direct(b, rows):
        return b.predict(rows, device="cpu")

    with server:
        assert np.array_equal(server.predict(X[:5], timeout=T_OUT),
                              direct(booster_a, X[:5]))
        server.activate(v2)
        assert np.array_equal(server.predict(Xm[:5], timeout=T_OUT),
                              direct(booster_b, Xm[:5]))
        assert np.array_equal(server.predict(X[:5], version=v1,
                                             timeout=T_OUT),
                              direct(booster_a, X[:5]))
        assert server.rollback() == v1
        assert np.array_equal(server.predict(X[:5], timeout=T_OUT),
                              direct(booster_a, X[:5]))


def test_registry_loads_text_binary_checkpoint(files, tmp_path):
    path, X, tb = files["binary"]
    jb = dryad_tpu.Booster.load(path)
    jb.save_text(str(tmp_path / "m.txt"))
    JCheckpointer(str(tmp_path / "ck")).save(jb, 8)
    reg = ModelRegistry()
    v_bin = reg.load(path)
    v_txt = reg.load(str(tmp_path / "m.txt"))
    v_ck = reg.load_latest_checkpoint(str(tmp_path / "ck"))
    ref = jb.predict(X[:10])
    for v in (v_bin, v_txt, v_ck):
        got = reg.get(v).booster.predict(X[:10], device="cpu")
        assert np.array_equal(got, ref)
    with pytest.raises(FileNotFoundError):
        reg.load_latest_checkpoint(str(tmp_path / "empty_ck"))


@pytest.mark.parametrize("depth,sizes,wait_ms", [
    (2, [1, 3, 5, 8, 13], 20.0), (1, [1, 3, 5, 8, 13], 20.0),
    (2, [1, 3, 5, 8, 13, 21], 5.0)])
def test_concurrent_requests_coalesce_bitwise(files, depth, sizes, wait_ms):
    """Threads in flight at once, through the pipeline or the serial loop:
    answers stay request-exact and the coalescer folds them into fewer
    dispatches."""
    _, X, tb = files["binary"]
    server = _server(max_batch_rows=128, max_wait_ms=wait_ms,
                     queue_size=64, pipeline_depth=depth)
    server.registry.add(tb)
    outs: dict[int, np.ndarray] = {}
    start = threading.Barrier(len(sizes))

    def worker(i, n):
        start.wait(T_OUT)
        outs[i] = server.predict(X[i:i + n], timeout=T_OUT)

    with server:
        _run_threads([lambda i=i, n=n: worker(i, n)
                      for i, n in enumerate(sizes)])
    for i, n in enumerate(sizes):
        assert np.array_equal(outs[i], tb.predict(X[i:i + n], device="cpu"))
    snap = server.stats()
    assert snap["requests"] == len(sizes)
    assert snap["batches"] < len(sizes)
    assert 0 < snap["batch_fill_ratio"] <= 1


def test_batcher_backpressure_and_timeout():
    """The bounded queue rejects excess load; a per-request timeout
    abandons a stuck request."""
    release = threading.Event()

    def slow_dispatch(batch):
        release.wait(5.0)
        return [np.zeros(r.rows.shape[0], np.float32) for r in batch]

    metrics = ServeMetrics()
    batcher = MicroBatcher(slow_dispatch, max_batch_rows=4, max_wait_ms=1.0,
                           queue_size=1, metrics=metrics)
    batcher.start()
    rows = np.zeros((2, 3), np.uint8)
    errs: list[BaseException] = []

    def blocked():
        try:
            batcher.submit(Request(rows), timeout=0.05)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    t = threading.Thread(target=blocked, daemon=True)
    t.start()
    time.sleep(0.2)       # the worker is now inside slow_dispatch
    with pytest.raises(ServeTimeout):
        batcher.submit(Request(rows), timeout=0.01)
    with pytest.raises(ServeOverloaded):
        batcher.submit(Request(rows), timeout=0.01)
    release.set()
    t.join(5.0)
    assert not t.is_alive()
    assert errs and isinstance(errs[0], ServeTimeout)
    assert metrics.timeouts >= 1 and metrics.rejected >= 1
    batcher.stop()


def test_stop_drains_stranded_requests():
    from dryad_tpu_torch.serve.batcher import _StopToken

    batcher = MicroBatcher(lambda b: [None] * len(b), queue_size=4)
    stranded = Request(np.zeros((1, 2), np.uint8))
    batcher._q.put(_StopToken(batcher._gen))
    batcher._q.put(stranded)
    batcher.start()
    assert stranded.event.wait(5.0)
    assert isinstance(stranded.error, ServeOverloaded)
    batcher.stop()


def test_dispatch_error_propagates():
    def bad_dispatch(batch):
        raise RuntimeError("boom")

    batcher = MicroBatcher(bad_dispatch, max_wait_ms=0.1, queue_size=4)
    batcher.start()
    with pytest.raises(RuntimeError, match="boom"):
        batcher.submit(Request(np.zeros((1, 2), np.uint8)), timeout=5.0)
    batcher.stop()


def test_stop_timeout_keeps_stuck_worker_handle():
    release = threading.Event()

    def stuck_dispatch(batch):
        release.wait(30.0)
        return [np.zeros(r.rows.shape[0], np.float32) for r in batch]

    batcher = MicroBatcher(stuck_dispatch, max_batch_rows=4, max_wait_ms=0.5,
                           queue_size=4)
    batcher.start()
    req = Request(np.zeros((1, 3), np.uint8))
    batcher._q.put_nowait(req)
    deadline = time.monotonic() + 5.0
    while not batcher._q.empty() and time.monotonic() < deadline:
        time.sleep(0.005)
    worker = batcher._thread
    assert worker is not None and worker.is_alive()
    batcher.stop(timeout=0.05)
    assert batcher._thread is worker, "handle cleared while worker alive"
    batcher.start()
    assert batcher._thread is worker
    release.set()
    assert req.event.wait(5.0)
    batcher.stop(timeout=5.0)
    assert batcher._thread is None


def test_restart_after_stop_timeout_keeps_serving():
    entered = threading.Event()
    release = threading.Event()
    stuck_once = []

    def dispatch(batch):
        if not stuck_once:
            stuck_once.append(1)
            entered.set()
            release.wait(30.0)
        return [np.zeros(r.rows.shape[0], np.float32) for r in batch]

    batcher = MicroBatcher(dispatch, max_batch_rows=4, max_wait_ms=0.5,
                           queue_size=4)
    batcher.start()
    req = Request(np.zeros((1, 3), np.uint8))
    batcher._q.put_nowait(req)
    assert entered.wait(5.0)
    worker = batcher._thread
    batcher.stop(timeout=0.05)
    batcher.start()
    release.set()
    assert req.event.wait(5.0)
    out = batcher.submit(Request(np.zeros((2, 3), np.uint8)), timeout=5.0)
    assert out.shape == (2,)
    assert batcher._thread is worker and worker.is_alive()
    batcher.stop(timeout=5.0)
    assert batcher._thread is None
    gen = batcher._gen
    batcher.start()
    batcher.start()                # a plain start does not cancel a stop
    assert batcher._gen == gen
    batcher.stop(timeout=5.0)
    assert batcher._thread is None


def test_unloaded_version_fails_only_its_group(files):
    _, X, tb = files["binary"]
    server = _server()
    server.registry.add(tb)
    Xb = tb.mapper.transform(X[:4])
    good = Request(Xb, version=server.registry.active_version)
    dead = Request(Xb, version=99)
    results = server._dispatch([good, dead])
    assert isinstance(results[1], KeyError)
    assert np.array_equal(results[0], tb.predict(X[:4], device="cpu"))


def test_registry_budget_evicts_lru_not_active(files):
    """Staging past the budget evicts the LRU staged entry (and its
    programs); the active version is pinned; an evicted model re-stages
    on its next request with bitwise the same output; its stats
    survive."""
    _, X, booster_a = files["binary"]
    _, Xm, booster_b = files["multiclass"]
    server = PredictServer(device="cpu", max_wait_ms=0.2,
                           device_budget_bytes=1)
    reg = server.registry
    vA = reg.add(booster_a)
    vB = reg.add(booster_b, activate=False, name="challenger")
    with server:
        outB1 = server.predict(Xm[:5], version=vB, timeout=T_OUT)
        eA, eB = reg.get(vA), reg.get(vB)
        assert eB.is_staged
        server.predict(X[:5], timeout=T_OUT)
        assert not eB.is_staged, "inactive LRU entry must be evicted"
        assert not any(k[0] == vB for k in server.cache._warm)
        assert eA.is_staged, "active version is pinned"
        reqs_before = server.stats()["models"][vB]["requests"]
        outB2 = server.predict(Xm[:5], version=vB, timeout=T_OUT)
        assert eB.is_staged
        assert np.array_equal(outB1, outB2)
        assert np.array_equal(outB2, booster_b.predict(Xm[:5], device="cpu"))
    snap = server.stats()
    assert snap["evictions"] >= 1 and snap["restages"] >= 1
    mB = snap["models"][vB]
    assert mB["evictions"] >= 1 and mB["restages"] >= 1
    assert mB["requests"] == reqs_before + 1, "stats must survive eviction"
    assert snap["memory"]["budget_bytes"] == 1


def test_unbudgeted_registry_never_evicts(files):
    _, X, booster_a = files["binary"]
    _, Xm, booster_b = files["multiclass"]
    server = _server()
    vA = server.registry.add(booster_a)
    vB = server.registry.add(booster_b, activate=False)
    with server:
        server.predict(Xm[:5], version=vB, timeout=T_OUT)
        server.predict(X[:5], version=vA, timeout=T_OUT)
    assert server.registry.get(vA).is_staged
    assert server.registry.get(vB).is_staged
    snap = server.stats()
    assert snap["evictions"] == 0
    assert snap["memory"]["staged_versions"] == [vA, vB]
    assert snap["memory"]["staged_layouts"] == {vA: "packed", vB: "packed"}


def test_named_model_routing(files):
    _, X, booster_a = files["binary"]
    _, Xm, booster_b = files["multiclass"]
    server = _server()
    v1 = server.registry.add(booster_a, name="champion")
    v2 = server.registry.add(booster_b, activate=False, name="challenger")
    with server:
        assert np.array_equal(server.predict(X[:5], model="champion",
                                             timeout=T_OUT),
                              booster_a.predict(X[:5], device="cpu"))
        assert np.array_equal(server.predict(Xm[:5], model="challenger",
                                             timeout=T_OUT),
                              booster_b.predict(Xm[:5], device="cpu"))
        with pytest.raises(KeyError):
            server.predict(X[:2], model="nobody", timeout=T_OUT)
        with pytest.raises(ValueError):
            server.predict(X[:2], version=v1, model="champion",
                           timeout=T_OUT)
        v3 = server.registry.add(booster_b, activate=False, name="champion")
        assert np.array_equal(server.predict(Xm[:5], model="champion",
                                             timeout=T_OUT),
                              booster_b.predict(Xm[:5], device="cpu"))
        assert server.registry.aliases() == {"champion": v3,
                                             "challenger": v2}
        server.registry.unload(v2)
        assert server.registry.aliases() == {"champion": v3}


def test_unload_frees_staged_and_cache_entries(files):
    _, X, booster_a = files["binary"]
    _, Xm, booster_b = files["multiclass"]
    server = _server()
    server.registry.add(booster_a)
    vB = server.registry.add(booster_b, activate=False, name="retired")
    with server:
        server.predict(Xm[:5], version=vB, timeout=T_OUT)
        entry_b = server.registry.get(vB)
        assert entry_b.is_staged
        assert any(k[0] == vB for k in server.cache._warm)
        server.unload(vB)
        assert not entry_b.is_staged, "unload must free the staged tables"
        assert not any(k[0] == vB for k in server.cache._warm)
        assert server.registry.aliases() == {}
        with pytest.raises(KeyError):
            entry_b.staged()
        assert np.array_equal(server.predict(X[:5], timeout=T_OUT),
                              booster_a.predict(X[:5], device="cpu"))


def test_malformed_request_fails_alone(files):
    _, X, tb = files["binary"]
    server = _server(max_batch_rows=64, max_wait_ms=20.0)
    server.registry.add(tb)
    results: dict = {}
    start = threading.Barrier(2)

    def good():
        start.wait(T_OUT)
        results["good"] = server.predict(X[:5], timeout=T_OUT)

    def bad():
        start.wait(T_OUT)
        try:
            server.predict(X[:3, :-1], timeout=T_OUT)
            results["bad"] = "no error"
        except ValueError as e:
            results["bad"] = e

    with server:
        _run_threads([good, bad])
        assert isinstance(results["bad"], ValueError)
        assert np.array_equal(results["good"], tb.predict(X[:5],
                                                          device="cpu"))
        with pytest.raises(ValueError, match="expected"):
            server.predict(tb.mapper.transform(X[:2])[:, :-1], binned=True,
                           timeout=T_OUT)


def test_per_model_stats(files):
    _, X, booster_a = files["binary"]
    _, Xm, booster_b = files["multiclass"]
    server = _server()
    v1 = server.registry.add(booster_a)
    v2 = server.registry.add(booster_b, activate=False)
    with server:
        for _ in range(3):
            server.predict(X[:4], version=v1, timeout=T_OUT)
        server.predict(Xm[:7], version=v2, timeout=T_OUT)
    snap = server.stats()
    assert snap["models"][v1]["requests"] == 3
    assert snap["models"][v1]["rows"] == 12
    assert snap["models"][v2]["requests"] == 1
    assert snap["models"][v2]["rows"] == 7
    assert snap["models"][v2]["p99_ms"] >= 0.0


def test_warmup_touches_every_bucket_and_arms_the_tripwire(files):
    """``warmup`` runs every (version, bucket) program once; afterwards
    traffic compiles nothing, and a new version's first call is an
    unexpected compile until it is warmed."""
    from dryad_tpu_torch.obs.registry import default_registry

    path, X, tb = files["binary"]
    server = _server(max_batch_rows=64)
    server.load_model(path)
    assert server.warmup() == 4                 # buckets 8, 16, 32, 64
    snap = server.stats()
    assert snap["cache_compiles"] == 4 and snap["compiled_buckets"] == 4
    unexpected = default_registry().counter(
        "dryad_recompile_unexpected_total").labels(program="serve.predict")
    before = unexpected.value()
    with server:
        for n in (1, 9, 33, 64, 100):
            assert np.array_equal(server.predict(X[:n], timeout=T_OUT),
                                  tb.predict(X[:n], device="cpu"))
        assert server.stats()["cache_compiles"] == 4
        assert unexpected.value() == before
        v2 = server.registry.add(files["multiclass"][2], activate=False)
        server.predict(files["multiclass"][1][:3], version=v2,
                       timeout=T_OUT)
        assert unexpected.value() == before + 1
        assert server.warmup([v2]) == 4
    assert server.stats()["cache_compiles"] == 8


def test_bench_compare_pipeline_vs_serial(files):
    _, X, tb = files["binary"]
    report = run_bench_compare(tb, device="cpu", clients=3, duration_s=0.3,
                               sizes=(1, 5, 9), max_batch_rows=32,
                               max_wait_ms=1.0, seed=0, arms=2,
                               feature_pool=X)
    assert report["recompiles_after_warmup"] == 0
    assert report["serial"]["pipeline_depth"] == 1
    assert report["pipeline"]["pipeline_depth"] == 2
    assert report["pipeline_speedup"] > 0
    for arm in ("serial", "pipeline"):
        assert report[arm]["bench_arms"] == 2
        assert "spread_rows_per_s" in report[arm]
        assert isinstance(report[arm]["suspect_capture"], bool)


def test_bench_zero_recompiles_after_warmup_and_layouts(files):
    _, X, tb = files["binary"]
    report = run_bench(tb, device="cpu", clients=3, duration_s=0.3,
                       sizes=(1, 5, 9, 17), max_batch_rows=32,
                       max_wait_ms=1.0, seed=0, feature_pool=X)
    assert report["recompiles_after_warmup"] == 0
    assert report["cache_hits"] > 0 and report["bench_requests"] > 0
    assert report["cache_compiles"] == 3         # buckets {8, 16, 32}
    line = summary_line(report)
    assert line["device"] == "cpu" and line["mesh_shards"] == 1
    lay = run_bench_layout(tb, device="cpu", clients=2, duration_s=0.2,
                           sizes=(1, 9), max_batch_rows=16, seed=0,
                           feature_pool=X)
    assert lay["layout_recompiles_after_warmup"] == 0
    assert lay["layout_rows_per_s_packed"] > 0
    assert lay["layout_rows_per_s_legacy"] > 0
    assert tb.params.predict_layout == "auto"    # restored


def test_stress_more_clients_than_cores(files):
    """16 clients (more than the cores) with a short switch interval: every
    answer bitwise its direct predict, and no request or row lost from the
    shared counters."""
    import sys

    _, X, tb = files["binary"]
    direct = tb.predict(X, raw_score=True, device="cpu")
    server = _server(max_batch_rows=64, max_wait_ms=1.0, queue_size=256)
    server.registry.add(tb)
    bad, sent = [], [0] * 16

    def client(ci):
        rng = np.random.default_rng(ci)
        for _ in range(10):
            n = int(rng.integers(1, 40))
            s0 = int(rng.integers(0, len(X) - n))
            out = server.predict(X[s0:s0 + n], raw_score=True,
                                 timeout=T_OUT)
            sent[ci] += n
            if not np.array_equal(out, direct[s0:s0 + n]):
                bad.append((ci, s0, n))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with server:
            _run_threads([lambda ci=ci: client(ci) for ci in range(16)])
    finally:
        sys.setswitchinterval(old)
    assert not bad
    snap = server.stats()
    assert snap["requests"] == 160 and snap["rows"] == sum(sent)
    assert snap["models"][1]["requests"] == 160
