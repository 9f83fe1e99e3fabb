"""Shape-bucketed predict cache: one CUDA graph per (version, bucket).

Batches are padded up to the next power-of-two row bucket and predicted
at the bucket shape, so warm traffic touches a small fixed set of
programs, at most log2(max_bucket / min_bucket) + 1 per model version.
Batches larger than ``max_bucket`` are predicted in ``max_bucket``-row
chunks.

The program is ``engine.predict.forest_scores``: every tree of the staged
table traversed at once (one gather per field per level over an (N, T)
node tensor), then the leaf values added into the (N, K) scores in tree
order.  On the card the first call at a (version, bucket) shape captures
it as a CUDA graph with a static (bucket, F) input buffer and a static
(bucket, K) output buffer; every later call copies the padded chunk into
the input, replays the graph and copies the output to the host once.  The
captures share one graph memory pool, which holds only their scratch:
the static buffers are allocated outside the captures, and one executor
replays one graph at a time and copies its output before the next.  The
first call at a shape is this cache's "compile": it is counted
(``ServeMetrics.cache_compiles``) and noted at the recompile tripwire,
which ``warmup_complete()`` arms.  On the CPU (``device="cpu"``, as the
tests run) the same program runs eagerly.

All device work (uploads, captures, replays, graph destruction) runs
under one lock on one dedicated stream.  ``prepare_raw`` (the pipeline's
host stage) makes no CUDA call: a CUDA call from another thread during a
capture breaks it.  Nothing catches a failed capture or replay: it fails
the requests of its batch.

``evict_version`` drops a version's graphs and warm keys (unload, and a
registry budget eviction through ``ModelRegistry.on_evict``): a graph
reads the version's device tables, so the tables' memory is released only
with it.  The next call re-stages the tables and captures anew; its key
is not new to the tripwire, so a budget eviction does not degrade
``/healthz``.

Bitwise contract: padding rows (bin 0 everywhere) and chunking cannot
change the real rows' scores, since traversal and the fp32 leaf sums are
per row, and ``forest_scores`` is bitwise ``accumulate``, the direct
predict's program.  An rf model's scores are averaged on the host after
the output comes back.

The counterpart of ``dryad_tpu/serve/cache.py`` (single-device family
only: ``n_shards`` is 1 until the port distributes).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

import numpy as np
import torch

from dryad_tpu_torch.obs.tripwire import default_tripwire

PROGRAM = "serve.predict"


def bucket_rows(n: int, min_bucket: int = 8,
                max_bucket: Optional[int] = None) -> int:
    """Smallest power of two >= n, floored at min_bucket, capped at
    max_bucket (itself rounded up to a power of two by the cache)."""
    if n < 1:
        raise ValueError("bucket_rows needs n >= 1")
    b = max(int(min_bucket), 1 << (int(n) - 1).bit_length())
    if max_bucket is not None:
        b = min(b, int(max_bucket))
    return b


def device_bins(Xb: np.ndarray) -> np.ndarray:
    """Binned rows in the dtype the device tensors hold (uint8 stays,
    wider bins become int32, as ``dataset.binned_to_device`` uploads
    them)."""
    return Xb if Xb.dtype == np.uint8 else Xb.astype(np.int32)


class PreparedPredict:
    """Host-ready predict work: the padded chunks of one model version's
    rows.  Built by ``prepare_raw``, consumed by ``execute_raw``."""

    __slots__ = ("entry", "n", "chunks")

    def __init__(self, entry, n: int, chunks: list):
        self.entry = entry
        self.n = n
        self.chunks = chunks    # [(padded_chunk, start, m), ...]


class _Graph:
    """One captured (version, bucket) program and its static buffers."""

    __slots__ = ("state", "x", "out", "graph")

    def __init__(self, state, x, out, graph):
        self.state = state      # the device tables the graph reads
        self.x = x
        self.out = out
        self.graph = graph


class CompiledPredictCache:
    """(version, bucket, 1) -> a captured program on ``device``, with
    hit/compile accounting and per-capture seconds (``capture_s``)."""

    GUARDED_BY = {"_warm": "_lock", "_graphs": "_lock",
                  "capture_s": "_lock"}

    n_shards = 1

    def __init__(self, device: torch.device, metrics=None, *,
                 min_bucket: int = 8, max_bucket: int = 4096):
        self.device = torch.device(device)
        self.metrics = metrics
        self.min_bucket = int(min_bucket)
        # a power of two, so chunk remainders re-bucket cleanly
        self.max_bucket = 1 << (int(max_bucket) - 1).bit_length()
        self._lock = threading.Lock()            # the dicts below
        self._device_lock = threading.RLock()    # every CUDA call
        self._warm: set[tuple] = set()
        self._graphs: dict[tuple, _Graph] = {}
        self.capture_s: dict[tuple, float] = {}
        self._stream = None     # created by the first device call
        self._pool = None
        self._tripwire = default_tripwire()
        self._tripwire.begin_program(PROGRAM)

    @property
    def num_entries(self) -> int:
        """Warm (version, bucket, 1) keys."""
        with self._lock:
            return len(self._warm)

    def warmup_complete(self) -> None:
        """Arm the tripwire: every bucket the server can produce has been
        touched, so a later first call at a shape is unexpected (counter
        and a degraded ``/healthz``).  Re-arming clears the degradation."""
        self._tripwire.arm(PROGRAM)

    def deploy_started(self) -> None:
        """Open a deploy window: a model load legitimately captures new
        graphs; the caller warms them and calls ``warmup_complete()``."""
        self._tripwire.disarm(PROGRAM)

    def buckets(self) -> list[int]:
        """Every bucket this cache can produce: the warmup set."""
        out, b = [], self.min_bucket
        while b <= self.max_bucket:
            out.append(b)
            b <<= 1
        return out

    # ---- prediction --------------------------------------------------------
    def prepare_raw(self, entry, Xb: np.ndarray) -> PreparedPredict:
        """HOST stage: chunk at max_bucket, zero-pad to the bucket, cast to
        the device's bin dtype.  numpy only: no CUDA call."""
        n = int(Xb.shape[0])
        chunks = []
        for start in range(0, n, self.max_bucket):
            chunk = device_bins(Xb[start:start + self.max_bucket])
            m = int(chunk.shape[0])
            b = bucket_rows(m, self.min_bucket, self.max_bucket)
            if m < b:
                pad = np.zeros((b - m,) + chunk.shape[1:], chunk.dtype)
                chunk = np.concatenate([chunk, pad])
            chunks.append((np.ascontiguousarray(chunk), start, m))
        return PreparedPredict(entry, n, chunks)

    def execute_raw(self, prepared: PreparedPredict) -> np.ndarray:
        """DEVICE stage: run each chunk's program; raw (n, K) fp32 scores
        (rf averaged) on the host."""
        entry = prepared.entry
        out = np.empty((prepared.n, entry.num_outputs), np.float32)
        for chunk, start, m in prepared.chunks:
            out[start:start + m] = self._run(entry, chunk)[:m]
        if entry.booster.params.boosting == "rf":
            from dryad_tpu_torch.engine.predict import rf_average

            n_iter = entry.staged()[4]
            if n_iter > 0:
                out = rf_average(out, entry.booster.init_score, n_iter)
        return out

    def predict_raw(self, entry, Xb: np.ndarray) -> np.ndarray:
        """Raw scores (n, K) fp32 of pre-binned rows through the bucketed
        program; bitwise the direct unpadded predict."""
        if int(Xb.shape[0]) == 0:
            return np.zeros((0, entry.num_outputs), np.float32)
        return self.execute_raw(self.prepare_raw(entry, Xb))

    def _run(self, entry, chunk: np.ndarray) -> np.ndarray:
        key = (entry.version, int(chunk.shape[0]), 1)
        cuda = self.device.type == "cuda"
        with self._device_lock:
            if cuda and self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
                self._pool = torch.cuda.graph_pool_handle()
            with (torch.cuda.stream(self._stream) if cuda
                  else contextlib.nullcontext()):
                state = entry.device_state(self.device)
                with self._lock:
                    g = self._graphs.get(key)
                    hit = (g is not None and g.state is state if cuda
                           else key in self._warm)
                    self._warm.add(key)
                if not hit:
                    # a first call at this shape: the compile boundary
                    self._tripwire.note_compile(
                        PROGRAM, key,
                        detail=f"version={key[0]} bucket={key[1]}")
                if self.metrics is not None:
                    self.metrics.record_cache(hit, entry.version)
                if not cuda:
                    return _program(entry, state,
                                    torch.from_numpy(chunk)).numpy()
                if not hit:
                    g = self._capture(entry, state, chunk, key)
                g.x.copy_(torch.from_numpy(chunk))
                g.graph.replay()
                return g.out.cpu().numpy()     # the one host copy

    def _capture(self, entry, state, chunk: np.ndarray, key) -> _Graph:
        t0 = time.perf_counter()
        x = torch.zeros(chunk.shape, dtype=torch.from_numpy(chunk[:0]).dtype,
                        device=self.device)
        out = torch.empty((chunk.shape[0], entry.num_outputs),
                          dtype=torch.float32, device=self.device)
        # one eager run on the capture stream first, as capture requires
        out.copy_(_program(entry, state, x))
        self._stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            out.copy_(_program(entry, state, x))
        self._stream.synchronize()
        g = _Graph(state, x, out, graph)
        with self._lock:
            self._graphs[key] = g
            self.capture_s[key] = time.perf_counter() - t0
        return g

    def evict_version(self, version: int) -> None:
        """Drop a version's graphs, warm keys and capture times (unload,
        budget eviction): the graphs hold its device tables alive."""
        version = int(version)
        with self._device_lock:
            with self._lock:
                for key in [k for k in self._graphs if k[0] == version]:
                    del self._graphs[key]
                self._warm -= {k for k in self._warm if k[0] == version}
                for key in [k for k in self.capture_s if k[0] == version]:
                    del self.capture_s[key]


def _program(entry, state: dict, x: torch.Tensor) -> torch.Tensor:
    from dryad_tpu_torch.engine.predict import forest_scores

    return forest_scores(state["table"], state["value"], x, state["init"],
                         entry.depth_bound, state["bitset"])

