"""PredictServer: the long-lived online-inference front object.

Composes the registry (versioned, named, hot-swappable models under an
LRU device-memory budget), the shape-bucketed predict cache (a CUDA graph
per (version, bucket) on the card) and the micro-batcher's overlapped
dispatch pipeline behind one thread-safe ``predict`` call, with a
``stats()`` snapshot.  ``python -m dryad_tpu_torch serve`` wraps it in
the HTTP front end (``serve/http.py``).

The server runs on ``device`` (default: the card) and raises when no card
is present; it never falls back to the CPU on its own.  ``device="cpu"``
runs the same serving stack with eager programs, as the tests do.

Each coalesced batch goes through ``_prepare`` (host: group by version,
concatenate, bin raw rows through the model's mapper, bucket-pad; no
CUDA call) and ``_execute`` (device: upload, graph replay, the one host
copy, then per-request slicing and the link transform), so batch i+1's
host work overlaps batch i's device work (``pipeline_depth=1`` keeps the
serial loop, the bench's comparison arm).

With two or more visible cards (``sharded="auto"``) the cache's sharded
family splits a big bucket's rows over every card (``serve/cache.py``):
a bucket takes it when it carries at least ``sharded_threshold``
row-outputs (``SHARDED_MIN_WORK`` by default; ``sharded=True`` sets 0,
so every bucket that divides among the cards takes it) and divides among
them; ``sharded=False`` keeps one card.

The counterpart of ``dryad_tpu/serve/server.py``.  Not ported: the drift
monitors (the port's boosters carry no reference profile) and the policy
block of ``stats()``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from dryad_tpu_torch.serve.batcher import MicroBatcher, Request, RequestTrace
from dryad_tpu_torch.serve.cache import CompiledPredictCache
from dryad_tpu_torch.serve.metrics import ServeMetrics
from dryad_tpu_torch.serve.registry import ModelRegistry

# the row-outputs (rows x outputs) from which a bucket is split over the
# cards: the reference's policy-table default ("predict_sharded",
# "min_work"), kept as a constant of the port
SHARDED_MIN_WORK = 32768


class _PreparedGroup:
    """One model-version group of a prepared batch (see ``_prepare``)."""

    __slots__ = ("idxs", "entry", "prepared", "row_counts", "raw_flags",
                 "error")

    def __init__(self, idxs, entry=None, prepared=None, row_counts=None,
                 raw_flags=None, error=None):
        self.idxs = idxs
        self.entry = entry
        self.prepared = prepared
        self.row_counts = row_counts
        self.raw_flags = raw_flags
        self.error = error


class PredictServer:
    def __init__(self, *, device=None, max_batch_rows: int = 4096,
                 max_wait_ms: float = 2.0, queue_size: int = 256,
                 min_bucket: int = 8, pipeline_depth: int = 2,
                 device_budget_bytes: Optional[int] = None,
                 sharded="auto", sharded_threshold: Optional[int] = None):
        from dryad_tpu_torch import resolve_device

        self.device = resolve_device(device)
        self.metrics = ServeMetrics()
        self.registry = ModelRegistry(budget_bytes=device_budget_bytes,
                                      metrics=self.metrics)
        devices = self._shard_devices(sharded)
        if sharded_threshold is None:
            sharded_threshold = SHARDED_MIN_WORK
        # row-outputs; True takes every dividing bucket, and without two
        # cards the family is off
        threshold = (None if devices is None
                     else 0 if sharded is True else int(sharded_threshold))
        self.cache = CompiledPredictCache(
            self.device, self.metrics, min_bucket=min_bucket,
            max_bucket=max_batch_rows, devices=devices,
            sharded_threshold=threshold)
        # an eviction must drop the version's graphs, which hold its tables
        self.registry.on_evict = self.cache.evict_version
        self.batcher = MicroBatcher(
            self._dispatch, prepare=self._prepare, execute=self._execute,
            pipeline_depth=pipeline_depth, max_batch_rows=max_batch_rows,
            max_wait_ms=max_wait_ms, queue_size=queue_size,
            metrics=self.metrics)

    def _shard_devices(self, sharded):
        """Every visible card when there are two or more and sharding is
        not off, else None."""
        if sharded not in ("auto", True, False):
            raise ValueError("sharded must be 'auto', True or False")
        if self.device.type != "cuda" or sharded is False:
            return None
        import torch

        n = torch.cuda.device_count()
        return ([torch.device("cuda", i) for i in range(n)] if n >= 2
                else None)

    # ---- lifecycle ---------------------------------------------------------
    def start(self) -> "PredictServer":
        self.batcher.start()
        return self

    def stop(self) -> None:
        self.batcher.stop()

    def __enter__(self) -> "PredictServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- model lifecycle ---------------------------------------------------
    def load_model(self, path: str, *, activate: bool = True,
                   num_iteration: Optional[int] = None,
                   name: Optional[str] = None) -> int:
        """Register a model file (npz or text, from either package).  A
        deploy legitimately captures the new version's graphs, so this
        opens the tripwire's deploy window; ``warmup`` re-arms it."""
        self.cache.deploy_started()
        return self.registry.load(path, activate=activate,
                                  num_iteration=num_iteration, name=name)

    def activate(self, version: int) -> None:
        self.registry.activate(version)

    def rollback(self) -> int:
        return self.registry.rollback()

    def unload(self, version: int) -> None:
        """Unload a version: its tables and, through the registry's
        ``on_evict``, its graphs are freed."""
        self.registry.unload(version)

    def warmup(self, versions=None) -> int:
        """One zero-binned batch per (version, bucket) through the real
        program (``cache.buckets()`` is every bucket a batch can land on),
        so every graph warm traffic can need is captured; then arm the
        recompile tripwire (``warmup_complete``).  Returns the number of
        (version, bucket) pairs touched."""
        if versions is None:
            versions = self.registry.versions()
        touched = 0
        for version in versions:
            entry = self.registry.get(version)
            mapper = entry.booster.mapper
            for b in self.cache.buckets():
                Xb = np.zeros((b, mapper.num_features), mapper.bin_dtype)
                self.cache.predict_raw(entry, Xb)
                touched += 1
        self.warmup_complete()
        return touched

    def warmup_complete(self) -> None:
        """Arm the recompile tripwire: any later first call at a (version,
        bucket) shape increments
        ``dryad_recompile_unexpected_total{program="serve.predict"}`` and
        degrades ``/healthz``.  Re-arming after a re-warm clears it."""
        self.cache.warmup_complete()

    # ---- request path ------------------------------------------------------
    def predict(self, X: np.ndarray, *, version: Optional[int] = None,
                model: Optional[str] = None, raw_score: bool = False,
                binned: bool = False,
                timeout: Optional[float] = None,
                trace: Optional[str] = None,
                priority: Optional[str] = None) -> np.ndarray:
        """Predict through the whole serving stack (bin, bucket, batch,
        program, link transform); bitwise the direct ``Booster.predict`` /
        ``predict_binned`` on the same rows.  ``version`` pins a version,
        ``model`` routes by name; the default is the active version.
        ``trace`` (the ``X-Dryad-Trace`` header) and ``priority`` label
        the per-(priority, stage) latency series."""
        self.start()
        # pin the version at submit time, names included, so a re-deploy
        # mid-queue cannot switch models
        entry = self.registry.get(version, name=model)
        X = np.asarray(X)
        if X.ndim == 1:
            X = X[None, :]
        # binning waits for _prepare (the pipeline's host stage); the dtype
        # is fixed here so _prepare can concatenate requests
        Xb = np.ascontiguousarray(X if binned else np.asarray(X, np.float32))
        # the width is checked here, in the caller's thread, so a malformed
        # request fails alone instead of poisoning its batch (raw width is
        # the base mapper's for a bundled model)
        mapper = entry.booster.mapper
        nf = (mapper.num_features if binned
              else getattr(mapper, "base", mapper).num_features)
        if Xb.ndim != 2 or Xb.shape[1] != nf:
            raise ValueError(
                f"request shape {Xb.shape} does not match model version "
                f"{entry.version}: expected (n, {nf}) "
                f"{'binned' if binned else 'raw'} features")
        if Xb.shape[0] == 0:
            t0 = time.perf_counter()
            raw = np.zeros((0, entry.num_outputs), np.float32)
            out = entry.booster.transform_raw(raw, raw_score=raw_score)
            self.metrics.record_request(0, time.perf_counter() - t0,
                                        entry.version)
            return out
        # a trace context only while obs records (nothing allocated when
        # it is off)
        tctx = (RequestTrace(trace, priority or "interactive")
                if self.metrics.obs_enabled else None)
        req = Request(Xb, version=entry.version, raw_score=raw_score,
                      binned=binned, priority=priority or "interactive",
                      tctx=tctx)
        return self.batcher.submit(req, timeout=timeout)

    # ---- dispatch (serial) / prepare + execute (pipeline) ------------------
    def _prepare(self, batch: list[Request]) -> list[_PreparedGroup]:
        """HOST stage: group by (version, binned), concatenate, bin raw
        rows through the model's mapper (per row, so bitwise per-request
        binning), bucket-pad.  No CUDA call.  A dead group (its version
        unloaded mid-queue) carries its error instead of poisoning the
        batch."""
        groups: dict[tuple, list[int]] = {}
        for i, req in enumerate(batch):
            groups.setdefault((req.version, req.binned), []).append(i)
        out = []
        for (version, binned), idxs in groups.items():
            try:
                entry = self.registry.get(version)
                X = (batch[idxs[0]].rows if len(idxs) == 1 else
                     np.concatenate([batch[i].rows for i in idxs], axis=0))
                if not binned:
                    X = entry.booster.mapper.transform(X)
                out.append(_PreparedGroup(
                    idxs, entry, self.cache.prepare_raw(entry, X),
                    [batch[i].rows.shape[0] for i in idxs],
                    [batch[i].raw_score for i in idxs]))
            except Exception as e:  # noqa: BLE001 — fail only this group
                out.append(_PreparedGroup(idxs, error=e))
        return out

    def _execute(self, prepared: list[_PreparedGroup]) -> list:
        """DEVICE stage: each group's programs (one host copy per chunk),
        then per-request slices and link transforms."""
        n = 1 + max(i for g in prepared for i in g.idxs)
        results: list = [None] * n
        for g in prepared:
            if g.error is not None:
                for i in g.idxs:
                    results[i] = g.error
                continue
            try:
                raw = self.cache.execute_raw(g.prepared)
                offset = 0
                for i, rows, raw_flag in zip(g.idxs, g.row_counts,
                                             g.raw_flags):
                    results[i] = g.entry.booster.transform_raw(
                        raw[offset:offset + rows], raw_score=raw_flag)
                    offset += rows
            except Exception as e:  # noqa: BLE001 — fail only this group
                for i in g.idxs:
                    results[i] = e
        return results

    def _dispatch(self, batch: list[Request]) -> list:
        """Serial-mode dispatch: the two stages in line."""
        return self._execute(self._prepare(batch))

    # ---- observability -----------------------------------------------------
    def stats(self) -> dict:
        snap = self.metrics.snapshot()
        snap["device"] = str(self.device)
        snap["active_version"] = self.registry.active_version
        snap["versions"] = self.registry.versions()
        snap["aliases"] = self.registry.aliases()
        snap["compiled_buckets"] = self.cache.num_entries
        snap["pipeline_depth"] = (self.batcher.pipeline_depth
                                  if self.batcher.pipelined else 1)
        snap["mesh_shards"] = self.cache.n_shards
        snap["sharded_threshold"] = self.cache.sharded_threshold
        snap["memory"] = self.registry.memory()
        return snap
