"""Micro-batching queue: coalesce concurrent requests into one dispatch,
with an optional two-deep overlapped dispatch pipeline.

A single collector thread drains a bounded queue.  The first dequeued
request opens a batch and starts a max-wait deadline clock; requests
keep joining until the row cap is reached or the deadline expires, then
the whole batch goes to the device in one dispatch.  Under load batches
fill at once; when idle a lone request pays at most ``max_wait_ms``.

Serial mode (``pipeline_depth <= 1`` or no prepare/execute split): the
collector also runs the dispatch, one batch at a time.

Pipeline mode (the default when the caller gives ``prepare`` and
``execute``): the collector runs only the host side, coalescing plus
``prepare(batch)`` (grouping, binning, bucket padding), and hands the
prepared batch to an executor thread over a bounded queue.  While the
executor runs batch i on the device (graph replay and the one host copy
of its output), the collector prepares batch i+1.  The handoff queue
holds ``pipeline_depth - 1`` prepared batches, which caps the run-ahead.
``prepare`` makes no CUDA call: on the card the executor may be
capturing a CUDA graph, and a CUDA call from another thread during a
capture breaks it.

Backpressure is the bounded queue itself: when it is full, ``submit``
fails fast with ``ServeOverloaded``.  Each caller may bound its own wait
(``ServeTimeout``); an abandoned request's result is dropped when its
batch completes.

Results come back bitwise equal to solo predicts: the dispatch slices the
coalesced output per request, and every predict stage is per row.
Pipelining changes only when a batch runs, not what runs.

The counterpart of ``dryad_tpu/serve/batcher.py``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np

from dryad_tpu_torch.obs.spans import record_at, span


class ServeOverloaded(RuntimeError):
    """The request queue is full — shed load upstream."""


class ServeTimeout(TimeoutError):
    """The per-request timeout expired before the batch completed."""


class RequestTrace:
    """Per-request observability context across the batching hand-off.

    A request crosses three threads — the caller (submit), the collector
    (batch assembly), the executor (dispatch + fetch) — so its stage
    timestamps are STAMPED in place as it travels and emitted once, at
    delivery, as trace-tagged spans and
    per-(priority, stage) histogram observations (metrics.record_stage).
    The queue/event hand-offs that move the request between threads
    already provide the happens-before edges that make the plain-field
    stamps safe: exactly one thread owns the context at a time.

    Zero-cost when disabled: the server allocates a RequestTrace ONLY
    when the obs registry records (``ServeMetrics.obs_enabled``); with
    obs off ``Request.tctx`` stays None and every stamp site is one
    attribute check (the spans null-context idiom, test-pinned)."""

    __slots__ = ("trace", "priority", "t_submit", "t_collect", "t_execute")

    def __init__(self, trace: Optional[str] = None,
                 priority: str = "interactive"):
        self.trace = trace
        self.priority = priority
        self.t_submit = 0.0
        self.t_collect = 0.0
        self.t_execute = 0.0

    def finish(self, t_end: float, metrics=None) -> None:
        """Emit the stage spans/observations (called once, at delivery).
        Spans go to the SAME registry the metrics mirror into — the
        allocation gate (``metrics.obs_enabled``), the stage histograms,
        and the span series must agree on one registry, or a private
        registry (tests) would allocate contexts whose spans then vanish
        against a disabled process default."""
        reg = metrics.obs_registry if metrics is not None else None
        for name, stage, a, b in (
                ("serve.request/queue_wait", "queue_wait",
                 self.t_submit, self.t_collect),
                ("serve.request/batch_assembly", "batch_assembly",
                 self.t_collect, self.t_execute),
                ("serve.request/predict", "predict",
                 self.t_execute, t_end)):
            dur = max(b - a, 0.0)
            record_at(name, a, dur, trace=self.trace, registry=reg)
            if metrics is not None:
                metrics.record_stage(stage, dur, priority=self.priority)


class Request:
    """One submitted predict request.  ``rows`` is pre-binned when
    ``binned`` is True, else raw float32 features — binning then happens
    in the dispatch pipeline's host stage (server._prepare), overlapped
    with the previous batch's device predict.  ``priority`` is the
    admission class (``interactive`` or ``bulk``; per-priority latency
    series); ``tctx`` is the optional RequestTrace (None with obs off)."""

    __slots__ = ("rows", "version", "raw_score", "binned", "event", "result",
                 "error", "abandoned", "priority", "tctx")

    def __init__(self, rows: np.ndarray, version: Optional[int] = None,
                 raw_score: bool = False, binned: bool = True,
                 priority: str = "interactive",
                 tctx: Optional[RequestTrace] = None):
        self.rows = rows
        self.version = version
        self.raw_score = raw_score
        self.binned = binned
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.abandoned = False
        self.priority = priority
        self.tctx = tctx


_STOP = object()          # pipeline-internal handoff sentinel only


class _StopToken:
    """Generation-stamped stop request on the public queue.  A token only
    stops the worker while its generation is current: a start() issued
    AFTER a stop() timed out (worker stuck in a stalled dispatch) bumps
    the generation, leaving the still-queued token STALE — the unstuck
    worker ignores it and keeps serving instead of dying with nothing
    left to collect the queue.  An in-flight stop() is never cancelled
    this way (see start())."""

    __slots__ = ("gen",)

    def __init__(self, gen: int):
        self.gen = gen


class MicroBatcher:
    """Bounded-queue request coalescer around a batch dispatch function.

    ``dispatch(batch)`` receives the list of coalesced ``Request``s and
    returns one result per request, in order.  When ``prepare`` and
    ``execute`` are also given (``dispatch ≡ execute ∘ prepare``) and
    ``pipeline_depth >= 2``, dispatch runs as the overlapped two-stage
    pipeline described in the module docstring.

    Lock contract: ``_lock`` guards the lifecycle triple — the worker handle
    ``_thread``, the stop-token generation ``_gen``, and the timed-out
    marker ``_stop_timed_out``.  Only ``start()``/``stop()``/
    ``_stop_live()`` take it, always briefly and never around the queue
    or a join: ``stop()`` snapshots the handle under the lock, blocks
    OUTSIDE it, then re-validates under the lock before clearing (a stop
    and a start racing in that window is what the generation stamp of
    ``_StopToken`` resolves).  The queue itself is the synchronization for the
    request path; per-request state rides each ``Request``'s own event.
    """

    GUARDED_BY = {"_thread": "_lock", "_gen": "_lock",
                  "_stop_timed_out": "_lock"}

    def __init__(self, dispatch, *, prepare=None, execute=None,
                 pipeline_depth: int = 2, max_batch_rows: int = 4096,
                 max_wait_ms: float = 2.0, queue_size: int = 256,
                 metrics=None):
        self._dispatch = dispatch
        self._prepare = prepare
        self._execute = execute
        self.pipeline_depth = int(pipeline_depth)
        self.pipelined = (prepare is not None and execute is not None
                         and self.pipeline_depth >= 2)
        self.max_batch_rows = int(max_batch_rows)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.metrics = metrics
        self._q: queue.Queue = queue.Queue(maxsize=int(queue_size))
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._gen = 0
        self._stop_timed_out = False

    # ---- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        with self._lock:
            if self._stop_timed_out:
                # a previous stop() timed out with its token still queued
                # behind the stuck dispatch: this start() is a deliberate
                # reinstatement, so invalidate that token — the unstuck
                # worker ignores it and keeps serving.  Only the timed-out
                # case is cancellable: an IN-FLIGHT stop() (join pending)
                # must survive predict()'s per-request auto-start, or any
                # concurrent traffic would silently abort a shutdown.
                self._gen += 1
                self._stop_timed_out = False
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="dryad-serve-batcher")
                self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        # keep _thread set until the worker is joined: clearing it first
        # would let a concurrent submit's start() spawn a SECOND worker
        # (two dispatchers racing on the cache) while this one drains
        with self._lock:
            thread = self._thread
            token = _StopToken(self._gen)
        if thread is None:
            return
        if thread.is_alive():
            # bounded put: with the queue full AND the worker stuck in a
            # stalled dispatch, a blocking put would wedge stop() before
            # its join timeout could ever apply; on Full we fall through
            # to the timed-out bookkeeping and a later stop() retries
            deadline = time.monotonic() + timeout
            try:
                self._q.put(token, timeout=timeout)
            except queue.Full:
                pass
            thread.join(max(0.0, deadline - time.monotonic()))
        with self._lock:
            # clear the handle ONLY once the worker is really dead: on a
            # join() timeout (worker stuck in a stalled device predict) a
            # cleared handle would let the next start() race a second
            # collector onto the same queue — pinned
            # by test_stop_timeout_keeps_stuck_worker_handle
            if self._thread is thread and not thread.is_alive():
                self._thread = None
                self._stop_timed_out = False
            elif thread.is_alive():
                # join timed out: remember it so a LATER start() may cancel
                # the still-queued token (restart-after-stuck-stop)
                self._stop_timed_out = True

    # ---- request path ------------------------------------------------------
    def submit(self, request: Request,
               timeout: Optional[float] = None) -> np.ndarray:
        """Enqueue, wait for the coalesced dispatch, return this request's
        slice of the results.  Raises ServeOverloaded / ServeTimeout, or
        re-raises the dispatch error."""
        t0 = time.perf_counter()
        if request.tctx is not None:
            request.tctx.t_submit = t0
        try:
            self._q.put_nowait(request)
        except queue.Full:
            if self.metrics is not None:
                self.metrics.record_rejected()
            raise ServeOverloaded(
                f"request queue full ({self._q.maxsize} waiting)") from None
        if self.metrics is not None:
            self.metrics.sample_queue_depth(self._q.qsize())
        if not request.event.wait(timeout):
            request.abandoned = True
            if self.metrics is not None:
                self.metrics.record_timeout()
            raise ServeTimeout(f"request timed out after {timeout}s")
        if request.error is not None:
            if self.metrics is not None:
                self.metrics.record_error(request.version)
            raise request.error
        if self.metrics is not None:
            self.metrics.record_request(request.rows.shape[0],
                                        time.perf_counter() - t0,
                                        request.version,
                                        priority=request.priority)
        return request.result

    # ---- worker ------------------------------------------------------------
    def _collect(self, first: Request,
                 downstream_full=None) -> tuple[list[Request], bool]:
        """Coalesce until the row cap or the max-wait deadline.

        ``downstream_full`` (pipeline mode) is demand-driven flow control:
        while the executor is backed up, shipping another batch would only
        park it in the handoff queue, so the deadline re-arms and the
        batch keeps coalescing — without this, a run-ahead collector opens
        batches into a momentarily empty queue and closes them on the
        deadline instead of the row cap, and the pipeline measures SLOWER
        than serial (observed; the bench compare pins the win now)."""
        batch, rows = [first], first.rows.shape[0]
        if first.tctx is not None:
            first.tctx.t_collect = time.perf_counter()
        deadline = time.perf_counter() + self.max_wait_s
        stopping = False
        while rows < self.max_batch_rows:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                if downstream_full is None or not downstream_full():
                    break
                remaining = self.max_wait_s     # executor backed up: re-arm
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                if downstream_full is not None and downstream_full():
                    continue                    # still no demand downstream
                break
            if isinstance(nxt, _StopToken):
                if self._stop_live(nxt):
                    stopping = True
                    break
                continue        # stale: a start() since reinstated service
            if nxt.tctx is not None:
                nxt.tctx.t_collect = time.perf_counter()
            batch.append(nxt)
            rows += nxt.rows.shape[0]
        if self.metrics is not None:
            # the closing request may overshoot the cap (and one oversized
            # request opens a batch unconditionally): count such batches
            # as full rather than reporting a fill ratio above 1
            self.metrics.record_batch(rows, max(rows, self.max_batch_rows))
            self.metrics.sample_queue_depth(self._q.qsize())
        return batch, stopping

    @staticmethod
    def _stamp_execute(batch: list) -> None:
        """Mark the batch-assembly → predict boundary on every traced
        request (called just before dispatch/execute on the owning
        thread)."""
        t = time.perf_counter()
        for req in batch:
            if req.tctx is not None:
                req.tctx.t_execute = t

    def _deliver(self, batch: list, results) -> None:
        for req, out in zip(batch, results):
            # the dispatch may fail requests individually (e.g. one
            # group's model version was unloaded mid-queue) without
            # poisoning the rest of the batch
            if isinstance(out, BaseException):
                req.error = out
            else:
                req.result = out
            req.event.set()
        t_end = time.perf_counter()
        for req in batch:
            if req.tctx is not None:
                req.tctx.finish(t_end, self.metrics)

    @staticmethod
    def _fail(batch: list, error: BaseException) -> None:
        for req in batch:
            req.error = error
            req.event.set()

    def _stop_live(self, token: _StopToken) -> bool:
        with self._lock:
            return token.gen == self._gen

    def _run(self) -> None:
        if self.pipelined:
            self._run_pipeline()
        else:
            self._run_serial()

    def _run_serial(self) -> None:
        while True:
            item = self._q.get()
            if isinstance(item, _StopToken):
                if self._stop_live(item):
                    self._drain()
                    return
                continue        # stale: a start() since reinstated service
            with span("serve.collect"):
                batch, stopping = self._collect(item)
            try:
                self._stamp_execute(batch)
                with span("serve.dispatch"):
                    results = self._dispatch(batch)
                self._deliver(batch, results)
            except BaseException as e:  # noqa: BLE001 — delivered to callers
                self._fail(batch, e)
            if stopping:
                self._drain()
                return

    def _run_pipeline(self) -> None:
        # run-ahead cap: the executor holds one batch in flight and this
        # queue holds pipeline_depth - 1 more; collector blocks beyond that
        handoff: queue.Queue = queue.Queue(maxsize=self.pipeline_depth - 1)

        def executor() -> None:
            while True:
                item = handoff.get()
                if item is _STOP:
                    return
                batch, prepared = item
                try:
                    self._stamp_execute(batch)
                    with span("serve.execute"):
                        results = self._execute(prepared)
                    self._deliver(batch, results)
                except BaseException as e:  # noqa: BLE001 — to callers
                    self._fail(batch, e)

        ex = threading.Thread(target=executor, daemon=True,
                              name="dryad-serve-executor")
        ex.start()
        stopping = False
        while not stopping:
            item = self._q.get()
            if isinstance(item, _StopToken):
                if self._stop_live(item):
                    break
                continue        # stale: a start() since reinstated service
            with span("serve.collect"):
                batch, stopping = self._collect(item,
                                                downstream_full=handoff.full)
            try:
                with span("serve.prepare"):
                    prepared = self._prepare(batch)
            except BaseException as e:  # noqa: BLE001 — to callers
                self._fail(batch, e)
                continue
            handoff.put((batch, prepared))
        handoff.put(_STOP)
        ex.join()
        self._drain()

    def _drain(self) -> None:
        """Fail anything enqueued behind the stop sentinel — a caller with
        no timeout would otherwise wait forever on a dead worker."""
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                return
            if isinstance(req, _StopToken):
                continue
            req.error = ServeOverloaded("batcher stopped")
            req.event.set()
