"""Serving metrics: thread-safe counters and windowed latency histograms.

One ``ServeMetrics`` is shared by the server, the micro-batcher, the
predict cache and the model registry; ``snapshot()`` is what ``stats()``
and ``/stats`` expose.  Latency percentiles come from the fixed-log-bucket
layout (``obs.registry.LOG_BUCKETS``): O(1) observe, and a local snapshot
reads a two-epoch rotating window of roughly the most recent
``latency_window`` requests (``_WindowedHist``), so a regression on a
long-lived server shows within one window.  Every counter that belongs to
a model version is also kept per version (``ModelStats``); that ledger
lives here, not on the registry entry, so an eviction never drops a
model's history.  Every recording is mirrored into the shared telemetry
registry as ``dryad_serve_*`` series (cumulative, Prometheus semantics),
with the per-(priority, stage) request-latency family
``dryad_request_latency_seconds``.

The counterpart of ``dryad_tpu/serve/metrics.py``; a cache "compile" is a
first call at a (version, bucket) shape, where the card captures a CUDA
graph."""

from __future__ import annotations

import threading
from typing import Optional

from dryad_tpu_torch.obs.registry import (REQUEST_LATENCY, Registry,
                                    default_registry, hist_quantile,
                                    merge_hist_states, new_hist_state,
                                    observe_log_state)

__all__ = ["ModelStats", "ServeMetrics", "REQUEST_LATENCY"]


class _WindowedHist:
    """Two-epoch rotating log-bucket histogram: percentiles over the
    most recent ~``window`` observations (between window/2 and window —
    the current epoch plus the previous full one), O(1) observe: a
    latency regression shows in snapshot percentiles within one window,
    however long the process has run.  The shared
    registry mirrors stay cumulative (Prometheus semantics); only the
    local snapshot reads this.  Guarded by the owning ServeMetrics
    lock, exactly like the deques it replaces."""

    __slots__ = ("half", "cur", "prev")

    def __init__(self, window: int):
        self.half = max(1, int(window) // 2)
        self.cur = new_hist_state()
        self.prev = None

    def observe(self, value: float) -> None:
        observe_log_state(self.cur, value)
        if self.cur[2] >= self.half:
            self.prev, self.cur = self.cur, new_hist_state()

    def state(self) -> tuple:
        if self.prev is None:
            return tuple(self.cur)
        return merge_hist_states([self.prev, self.cur])


def _pcts(state) -> tuple:
    """(p50_ms, p99_ms, mean_ms) from a log-hist state (mean is exact
    over the state's observations)."""
    counts, total, n = state
    if not n:
        return 0.0, 0.0, 0.0
    return (hist_quantile(counts, 0.50) * 1e3,
            hist_quantile(counts, 0.99) * 1e3,
            total / n * 1e3)


class ModelStats:
    """Per-version slice of the serving counters (guarded by the owning
    ServeMetrics lock; never touched directly by callers)."""

    __slots__ = ("requests", "rows", "lat_hist", "cache_hits",
                 "cache_compiles", "evictions", "restages", "errors")

    def __init__(self, latency_window: int = 512):
        self.requests = 0
        self.rows = 0
        self.lat_hist = _WindowedHist(latency_window)
        self.cache_hits = 0
        self.cache_compiles = 0
        self.evictions = 0
        self.restages = 0
        self.errors = 0

    def snapshot(self) -> dict:
        p50, p99, _ = _pcts(self.lat_hist.state())
        return {
            "requests": self.requests,
            "rows": self.rows,
            "p50_ms": p50,
            "p99_ms": p99,
            "cache_hits": self.cache_hits,
            "cache_compiles": self.cache_compiles,
            "evictions": self.evictions,
            "restages": self.restages,
            "errors": self.errors,
        }


class ServeMetrics:
    """All local counters and the reservoirs live under the one ``_lock``
    (declared below); record methods take it once per event and snapshot
    takes it once for the whole consistent view.  The ``_obs_*`` mirror
    handles are immutable after construction and record into the shared
    registry's own per-family locks OUTSIDE ours — the mirror happens
    after ``_lock`` is released, so the two lock domains never nest.
    ``_model_locked`` is the called-with-the-lock-held helper idiom the
    called-with-the-lock-held helper."""

    GUARDED_BY = {
        "_lat_hist": "_lock", "_models": "_lock",
        "requests": "_lock", "rows": "_lock",
        "batches": "_lock", "batch_rows": "_lock",
        "batch_capacity": "_lock",
        "cache_hits": "_lock", "cache_compiles": "_lock",
        "timeouts": "_lock", "rejected": "_lock", "errors": "_lock",
        "evictions": "_lock", "restages": "_lock",
        "queue_depth": "_lock", "queue_depth_peak": "_lock",
    }

    def __init__(self, latency_window: int = 4096,
                 registry: Optional[Registry] = None):
        # latency_window: local snapshot
        # percentiles cover roughly the most recent `latency_window`
        # requests (the two-epoch rotation above), so regressions show
        # within one window regardless of process age
        self._lock = threading.Lock()
        # shared-registry mirror: bound series handles so the hot path is
        # one enabled-check per record when obs is disabled
        reg = registry if registry is not None else default_registry()
        self._obs = reg
        self._obs_requests = reg.counter(
            "dryad_serve_requests_total", "Completed predict requests")
        self._obs_rows = reg.counter(
            "dryad_serve_rows_total", "Rows predicted")
        # per-version breakdowns live in their OWN families: a labeled
        # series inside the totals family would make family-level PromQL
        # (sum(dryad_serve_requests_total)) double-count every request
        self._obs_requests_v = reg.counter(
            "dryad_serve_requests_by_version_total",
            "Completed predict requests by model version")
        self._obs_rows_v = reg.counter(
            "dryad_serve_rows_by_version_total",
            "Rows predicted by model version")
        self._obs_errors_v = reg.counter(
            "dryad_serve_errors_by_version_total",
            "Dispatch errors by model version")
        self._obs_latency = reg.log_histogram(
            "dryad_serve_request_latency_seconds",
            "End-to-end request latency")
        # per-(priority, stage) request latency (stages: queue_wait /
        # batch_assembly / predict / total); bound per-label handles are
        # resolved lazily in
        # record_stage (label cardinality is tiny and bounded)
        self._obs_req_latency = reg.log_histogram(
            REQUEST_LATENCY,
            "Request latency by priority class and pipeline stage")
        self._obs_batches = reg.counter(
            "dryad_serve_batches_total", "Device dispatches")
        self._obs_batch_rows = reg.counter(
            "dryad_serve_batch_rows_total", "Rows across dispatches")
        self._obs_cache_hits = reg.counter(
            "dryad_serve_cache_hits_total", "Warm compiled-bucket hits")
        self._obs_cache_compiles = reg.counter(
            "dryad_serve_cache_compiles_total", "New compiled entries")
        self._obs_timeouts = reg.counter(
            "dryad_serve_timeouts_total", "Requests that gave up waiting")
        self._obs_rejected = reg.counter(
            "dryad_serve_rejected_total", "Requests shed by backpressure")
        self._obs_errors = reg.counter(
            "dryad_serve_errors_total", "Requests that raised in dispatch")
        self._obs_evictions = reg.counter(
            "dryad_serve_evictions_total", "Staged models evicted")
        self._obs_restages = reg.counter(
            "dryad_serve_restages_total", "Evicted models re-staged")
        self._obs_queue_depth = reg.gauge(
            "dryad_serve_queue_depth", "Last sampled request-queue depth")
        self._lat_hist = _WindowedHist(latency_window)
        # per-model windows track the configured window but are capped
        # at 512 each — the model count is unbounded, the global window
        # is not
        self._model_window = min(512, int(latency_window))
        self._models: dict[int, ModelStats] = {}
        self.requests = 0          # completed requests (incl. empty)
        self.rows = 0              # rows predicted across completed requests
        self.batches = 0           # device dispatches by the micro-batcher
        self.batch_rows = 0        # rows across those dispatches
        self.batch_capacity = 0    # Σ max_batch_rows across dispatches
        self.cache_hits = 0        # bucket already compiled/prepared
        self.cache_compiles = 0    # new (version, bucket, shards) entries built
        self.timeouts = 0          # requests that gave up waiting
        self.rejected = 0          # requests refused by the bounded queue
        self.errors = 0            # requests that raised in dispatch
        self.evictions = 0         # staged models dropped by the LRU budget
        self.restages = 0          # evicted models staged again on demand
        self.queue_depth = 0       # last sampled queue depth
        self.queue_depth_peak = 0

    def _model_locked(self, version: Optional[int]) -> Optional[ModelStats]:
        if version is None:
            return None
        ms = self._models.get(version)
        if ms is None:
            ms = self._models[version] = ModelStats(self._model_window)
        return ms

    @property
    def obs_enabled(self) -> bool:
        """Whether the shared registry records (the request path's gate
        for allocating per-request trace context — serve/batcher.py)."""
        return self._obs.enabled

    @property
    def obs_registry(self) -> Registry:
        """The registry this instance mirrors into — RequestTrace.finish
        emits its stage spans there too, so the tctx-allocation gate,
        the stage histograms, and the span series all agree on ONE
        registry (a private test registry included)."""
        return self._obs

    # ---- recording ---------------------------------------------------------
    def record_request(self, n_rows: int, latency_s: float,
                       version: Optional[int] = None,
                       priority: Optional[str] = None) -> None:
        with self._lock:
            self.requests += 1
            self.rows += int(n_rows)
            self._lat_hist.observe(float(latency_s))
            ms = self._model_locked(version)
            if ms is not None:
                ms.requests += 1
                ms.rows += int(n_rows)
                ms.lat_hist.observe(float(latency_s))
        if self._obs.enabled:
            self._obs_requests.inc()
            self._obs_rows.inc(int(n_rows))
            self._obs_latency.observe(float(latency_s))
            self._obs_req_latency.labels(
                priority=priority or "interactive",
                stage="total").observe(float(latency_s))
            if version is not None:
                self._obs_requests_v.labels(version=version).inc()
                self._obs_rows_v.labels(version=version).inc(int(n_rows))

    def record_stage(self, stage: str, seconds: float,
                     priority: Optional[str] = None) -> None:
        """One pipeline-stage latency observation into the mergeable
        per-(priority, stage) family (registry-only — stages have no
        local ledger).  First action is the enabled check: the disabled
        path allocates nothing."""
        if self._obs.enabled:
            self._obs_req_latency.labels(
                priority=priority or "interactive",
                stage=stage).observe(float(seconds))

    def record_batch(self, rows: int, capacity: int) -> None:
        with self._lock:
            self.batches += 1
            self.batch_rows += int(rows)
            self.batch_capacity += int(capacity)
        if self._obs.enabled:
            self._obs_batches.inc()
            self._obs_batch_rows.inc(int(rows))

    def record_cache(self, hit: bool, version: Optional[int] = None) -> None:
        with self._lock:
            ms = self._model_locked(version)
            if hit:
                self.cache_hits += 1
                if ms is not None:
                    ms.cache_hits += 1
            else:
                self.cache_compiles += 1
                if ms is not None:
                    ms.cache_compiles += 1
        (self._obs_cache_hits if hit else self._obs_cache_compiles).inc()

    def record_eviction(self, version: Optional[int] = None) -> None:
        with self._lock:
            self.evictions += 1
            ms = self._model_locked(version)
            if ms is not None:
                ms.evictions += 1
        self._obs_evictions.inc()

    def record_restage(self, version: Optional[int] = None) -> None:
        with self._lock:
            self.restages += 1
            ms = self._model_locked(version)
            if ms is not None:
                ms.restages += 1
        self._obs_restages.inc()

    def record_timeout(self) -> None:
        with self._lock:
            self.timeouts += 1
        self._obs_timeouts.inc()

    def record_rejected(self) -> None:
        with self._lock:
            self.rejected += 1
        self._obs_rejected.inc()

    def record_error(self, version: Optional[int] = None) -> None:
        with self._lock:
            self.errors += 1
            ms = self._model_locked(version)
            if ms is not None:
                ms.errors += 1
        if self._obs.enabled:
            self._obs_errors.inc()
            if version is not None:
                self._obs_errors_v.labels(version=version).inc()

    def sample_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.queue_depth = int(depth)
            self.queue_depth_peak = max(self.queue_depth_peak, int(depth))
        self._obs_queue_depth.set(int(depth))

    # ---- snapshot ----------------------------------------------------------
    def snapshot(self) -> dict:
        """One consistent dict of everything — counters plus derived rates.
        Latency keys are milliseconds; ``models`` maps version → its slice."""
        with self._lock:
            p50, p99, mean = _pcts(self._lat_hist.state())
            return {
                "requests": self.requests,
                "rows": self.rows,
                "batches": self.batches,
                "batch_rows": self.batch_rows,
                "batch_fill_ratio": (self.batch_rows / self.batch_capacity
                                     if self.batch_capacity else 0.0),
                "p50_ms": p50,
                "p99_ms": p99,
                "mean_ms": mean,
                "cache_hits": self.cache_hits,
                "cache_compiles": self.cache_compiles,
                "timeouts": self.timeouts,
                "rejected": self.rejected,
                "errors": self.errors,
                "evictions": self.evictions,
                "restages": self.restages,
                "queue_depth": self.queue_depth,
                "queue_depth_peak": self.queue_depth_peak,
                "models": {v: ms.snapshot()
                           for v, ms in sorted(self._models.items())},
            }
