"""Closed-loop serving benchmark.

``clients`` threads each run a closed loop (submit a request of a random
size, wait for the answer, repeat) against one PredictServer, so the
concurrency, and with it the batch fill, is controlled exactly.

Warmup touches every bucket the cache can produce (``cache.buckets()``),
not just the request sizes: coalesced batches land on any bucket up to
the row cap.  After it a warm cache never captures again, so
``recompiles_after_warmup`` must be 0.

The closed loop runs ``arms`` times and the report carries the per-arm
spread (max/min - 1) beside the rows/s; above 5% the capture is flagged
``suspect_capture``.  ``run_bench_compare`` measures the overlapped
dispatch pipeline against the serial loop on otherwise identical
servers; ``run_bench_layout`` the packed node words against the SoA
traversal.  The counterpart of ``dryad_tpu/serve/bench.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np

from dryad_tpu_torch.booster import Booster
from dryad_tpu_torch.serve.server import PredictServer

SPREAD_SUSPECT = 0.05    # per-arm spread above this flags the capture


def run_bench(model, *, device=None, clients: int = 4,
              duration_s: float = 2.0,
              sizes: Sequence[int] = (1, 3, 9, 17, 40),
              max_batch_rows: int = 256, max_wait_ms: float = 1.0,
              queue_size: int = 1024, min_bucket: int = 8, seed: int = 0,
              pipeline_depth: int = 2, arms: int = 1,
              feature_pool: Optional[np.ndarray] = None) -> dict:
    """Run the closed loop on ``device`` (default: the card); returns the
    stats snapshot plus the bench fields (rows/s, per-arm spread,
    recompiles_after_warmup).  ``model`` is a Booster or a model path."""
    booster = model if isinstance(model, Booster) else Booster.load_any(model)
    server = PredictServer(device=device, max_batch_rows=max_batch_rows,
                           max_wait_ms=max_wait_ms, queue_size=queue_size,
                           min_bucket=min_bucket,
                           pipeline_depth=pipeline_depth)
    server.registry.add(booster)
    rng = np.random.default_rng(seed)
    if feature_pool is None:
        feature_pool = rng.standard_normal(
            (max(int(max_batch_rows), 512), booster.mapper.num_features)
        ).astype(np.float32)
    pool_n = feature_pool.shape[0]
    sizes = [int(s) for s in sizes if 0 < int(s) <= pool_n]

    with server:
        # structural warmup: one request per bucket, then arm the tripwire
        for b in server.cache.buckets():
            server.predict(feature_pool[:min(b, pool_n)])
        server.warmup_complete()
        compiles_at_warmup = server.stats()["cache_compiles"]

        arm_reqs, arm_rows, arm_rows_per_s, arm_reqs_per_s = [], [], [], []
        for arm in range(max(1, int(arms))):
            counts = [0] * clients
            row_counts = [0] * clients
            barrier = threading.Barrier(clients + 1)
            # set before the barrier releases anyone, so no client reads
            # it unset
            stop_at = [float("inf")]

            def client(ci: int) -> None:
                crng = np.random.default_rng(seed + 1000 * (arm + 1) + ci)
                barrier.wait()
                while time.perf_counter() < stop_at[0]:
                    n = int(crng.choice(sizes))
                    start = int(crng.integers(0, pool_n - n + 1))
                    server.predict(feature_pool[start:start + n],
                                   timeout=60.0)
                    counts[ci] += 1
                    row_counts[ci] += n

            threads = [threading.Thread(target=client, args=(ci,),
                                        daemon=True)
                       for ci in range(clients)]
            for t in threads:
                t.start()
            stop_at[0] = time.perf_counter() + float(duration_s)
            barrier.wait()
            t0 = time.perf_counter()
            for t in threads:
                t.join(float(duration_s) + 120.0)
            if any(t.is_alive() for t in threads):
                raise RuntimeError("a bench client did not finish")
            elapsed = time.perf_counter() - t0
            arm_reqs.append(sum(counts))
            arm_rows.append(sum(row_counts))
            arm_rows_per_s.append(sum(row_counts) / elapsed
                                  if elapsed > 0 else 0.0)
            arm_reqs_per_s.append(sum(counts) / elapsed
                                  if elapsed > 0 else 0.0)
        snap = server.stats()

    spread = (max(arm_rows_per_s) / min(arm_rows_per_s) - 1
              if len(arm_rows_per_s) > 1 and min(arm_rows_per_s) > 0 else 0.0)
    snap["bench_clients"] = clients
    snap["bench_arms"] = len(arm_rows_per_s)
    snap["bench_requests"] = sum(arm_reqs)
    snap["bench_rows"] = sum(arm_rows)
    snap["requests_per_s"] = float(np.mean(arm_reqs_per_s))
    snap["rows_per_s"] = float(np.mean(arm_rows_per_s))
    snap["rows_per_s_arms"] = [round(r, 1) for r in arm_rows_per_s]
    snap["spread_rows_per_s"] = round(spread, 3)
    snap["suspect_capture"] = bool(spread > SPREAD_SUSPECT)
    snap["recompiles_after_warmup"] = (snap["cache_compiles"]
                                       - compiles_at_warmup)
    return snap


def summary_line(report: dict, label: str = "serve") -> dict:
    """The one-line JSON summary of a report."""
    return {
        "bench": label,
        "device": report["device"],
        "rows_per_s": round(report["rows_per_s"], 1),
        "requests_per_s": round(report["requests_per_s"], 1),
        "p50_ms": round(report["p50_ms"], 3),
        "p99_ms": round(report["p99_ms"], 3),
        "batch_fill_ratio": round(report["batch_fill_ratio"], 3),
        "recompiles_after_warmup": report["recompiles_after_warmup"],
        "spread_rows_per_s": report["spread_rows_per_s"],
        "suspect_capture": report["suspect_capture"],
        "pipeline_depth": report["pipeline_depth"],
        "mesh_shards": report["mesh_shards"],
    }


def run_bench_layout(model, *, arms: int = 2, **kw) -> dict:
    """Packed node words against the SoA traversal: the same closed loop
    on two otherwise identical servers, the model staged with
    ``predict_layout='packed'`` and then ``'legacy'``.  Forcing
    ``packed`` raises on a model whose fields overflow the packed
    widths."""
    booster = model if isinstance(model, Booster) else Booster.load_any(model)
    orig = booster.params
    try:
        booster.params = orig.replace(predict_layout="packed")
        packed = run_bench(booster, arms=arms, **kw)
        booster.params = orig.replace(predict_layout="legacy")
        legacy = run_bench(booster, arms=arms, **kw)
    finally:
        booster.params = orig
    speedup = (packed["rows_per_s"] / legacy["rows_per_s"]
               if legacy["rows_per_s"] > 0 else 0.0)
    return {
        "layout_rows_per_s_packed": round(packed["rows_per_s"], 1),
        "layout_rows_per_s_legacy": round(legacy["rows_per_s"], 1),
        "predict_layout_speedup": round(speedup, 3),
        "layout_spread_packed": packed["spread_rows_per_s"],
        "layout_spread_legacy": legacy["spread_rows_per_s"],
        "layout_recompiles_after_warmup": (
            packed["recompiles_after_warmup"]
            + legacy["recompiles_after_warmup"]),
        "suspect_capture": (packed["suspect_capture"]
                            or legacy["suspect_capture"]),
    }


def run_bench_compare(model, *, pipeline_depth: int = 2, **kw) -> dict:
    """Pipeline against serial on otherwise identical servers: the serial
    arm pins ``pipeline_depth=1``.  Returns both reports and
    ``pipeline_speedup`` (the rows/s ratio)."""
    serial = run_bench(model, pipeline_depth=1, **kw)
    pipeline = run_bench(model, pipeline_depth=pipeline_depth, **kw)
    speedup = (pipeline["rows_per_s"] / serial["rows_per_s"]
               if serial["rows_per_s"] > 0 else 0.0)
    return {
        "serial": serial,
        "pipeline": pipeline,
        "pipeline_speedup": round(speedup, 3),
        "recompiles_after_warmup": (serial["recompiles_after_warmup"]
                                    + pipeline["recompiles_after_warmup"]),
        "suspect_capture": (serial["suspect_capture"]
                            or pipeline["suspect_capture"]),
    }
