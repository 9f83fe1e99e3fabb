"""Shape-bucketed predict cache: one CUDA graph per (version, bucket,
n_shards) and shard.

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

Entries come in two families keyed by (version, bucket, n_shards):

* ``n_shards == 1``: the program on ``device``, the path of small
  interactive batches;
* ``n_shards == len(devices)``: the bucket split into that many
  contiguous blocks of ``bucket / n_shards`` rows, block i on
  ``devices[i]`` (a device may repeat), each one program (one CUDA graph,
  captured on that block's device and stream) over the version's tables
  staged on that device.  Every block is replayed before any output is
  fetched, so blocks on different cards run at once.

Routing is the reference's, a pure function of the bucket
(``shards_for``): the sharded family only when ``devices`` holds two or
more, the bucket divides among them, and ``bucket * num_outputs`` reaches
``sharded_threshold``; so warming every bucket warms exactly the family
each bucket will use, and warm traffic captures nothing in either.

Bitwise contract: padding rows (bin 0 everywhere), chunking and the row
split cannot change the real rows' scores, since traversal and the fp32
leaf sums are per row, and ``forest_scores`` is bitwise ``accumulate``,
the direct predict's program.  An rf model's scores are averaged on the
host after the output comes back.

The counterpart of ``dryad_tpu/serve/cache.py``; ``devices`` plays its
mesh's part.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

import numpy as np
import torch

from dryad_tpu_torch.obs.tripwire import default_tripwire
from dryad_tpu_torch.serve.registry import indexed_device

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
    """One captured program of one block and its static buffers."""

    __slots__ = ("state", "x", "out", "graph")

    def __init__(self, state, x, out, graph):
        self.state = state      # the device tables the graph reads
        self.x = x
        self.out = out
        self.graph = graph


class CompiledPredictCache:
    """(version, bucket, n_shards) -> captured programs, one a shard, with
    hit/compile accounting and per-capture seconds (``capture_s``).
    ``devices`` (two or more, the sharded family's blocks in order) and
    ``sharded_threshold`` (row-outputs; None turns the family off) route
    a bucket to the sharded family (module doc)."""

    GUARDED_BY = {"_warm": "_lock", "_graphs": "_lock",
                  "capture_s": "_lock"}

    def __init__(self, device: torch.device, metrics=None, *,
                 min_bucket: int = 8, max_bucket: int = 4096,
                 devices=None, sharded_threshold: Optional[int] = None):
        self.device = indexed_device(device)
        self.metrics = metrics
        self.min_bucket = int(min_bucket)
        # a power of two, so chunk remainders re-bucket cleanly
        self.max_bucket = 1 << (int(max_bucket) - 1).bit_length()
        self.devices = (None if devices is None or len(devices) < 2
                        else [indexed_device(d) for d in devices])
        self.n_shards = 1 if self.devices is None else len(self.devices)
        self.sharded_threshold = (None if sharded_threshold is None
                                  else int(sharded_threshold))
        self._lock = threading.Lock()            # the dicts below
        self._device_lock = threading.RLock()    # every CUDA call
        self._warm: set[tuple] = set()
        self._graphs: dict[tuple, list[_Graph]] = {}
        self.capture_s: dict[tuple, float] = {}
        # per card: its capture and replay stream, created by the first
        # device call there, and one graph memory pool for all captures
        self._streams: dict = {}
        self._pool = None
        self._tripwire = default_tripwire()
        self._tripwire.begin_program(PROGRAM)

    @property
    def num_entries(self) -> int:
        """Warm (version, bucket, n_shards) keys."""
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
        """Every bucket this cache can produce: the warmup set (routing is
        a function of the bucket, so it warms both families)."""
        out, b = [], self.min_bucket
        while b <= self.max_bucket:
            out.append(b)
            b <<= 1
        return out

    def shards_for(self, bucket: int, num_outputs: int) -> int:
        """The family of a bucket: ``n_shards`` when devices are attached,
        the bucket divides among them and carries at least
        ``sharded_threshold`` row-outputs, else 1."""
        if (self.devices is None or self.sharded_threshold is None
                or bucket % self.n_shards != 0):
            return 1
        return (self.n_shards
                if bucket * int(num_outputs) >= self.sharded_threshold
                else 1)

    def _shard_devices(self, n_shards: int) -> list[torch.device]:
        return [self.device] if n_shards == 1 else self.devices

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

    def _stream(self, dev: torch.device):
        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(dev)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
        return s

    def _on(self, dev: torch.device):
        """The context of device work on ``dev``: its card and stream."""
        if dev.type != "cuda":
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(dev))
        stack.enter_context(torch.cuda.stream(self._stream(dev)))
        return stack

    def _state(self, entry, dev: torch.device) -> dict:
        """The version's tables on ``dev``, uploaded on its stream."""
        with self._on(dev):
            return entry.device_state(dev)

    def _run(self, entry, chunk: np.ndarray) -> np.ndarray:
        bucket = int(chunk.shape[0])
        n_shards = self.shards_for(bucket, entry.num_outputs)
        key = (entry.version, bucket, n_shards)
        devs = self._shard_devices(n_shards)
        blocks = np.split(chunk, n_shards)
        cuda = self.device.type == "cuda"
        with self._device_lock:
            states = [self._state(entry, d) for d in devs]
            with self._lock:
                gs = self._graphs.get(key)
                hit = (gs is not None
                       and all(g.state is st for g, st in zip(gs, states))
                       if cuda else key in self._warm)
                self._warm.add(key)
            if not hit:
                # a first call at this shape: the compile boundary
                self._tripwire.note_compile(
                    PROGRAM, key, detail=f"version={key[0]} "
                    f"bucket={key[1]} shards={key[2]}")
            if self.metrics is not None:
                self.metrics.record_cache(hit, entry.version)
            if not cuda:
                return np.concatenate([
                    _program(entry, st, torch.from_numpy(b).to(d)).cpu()
                    .numpy() for d, st, b in zip(devs, states, blocks)])
            if not hit:
                gs = self._capture(entry, states, blocks, devs, key)
            for g, b, d in zip(gs, blocks, devs):
                with self._on(d):
                    g.x.copy_(torch.from_numpy(b))
                    g.graph.replay()
            outs = []
            for g, d in zip(gs, devs):
                with self._on(d):
                    outs.append(g.out.cpu().numpy())   # the one host copy
            return np.concatenate(outs)

    def _capture(self, entry, states, blocks, devs, key) -> list[_Graph]:
        t0 = time.perf_counter()
        gs = []
        for st, b, d in zip(states, blocks, devs):
            # each block's graph on its own card and that card's stream
            stream = self._stream(d)
            with self._on(d):
                x = torch.zeros(b.shape, dtype=torch.from_numpy(b[:0]).dtype,
                                device=d)
                out = torch.empty((b.shape[0], entry.num_outputs),
                                  dtype=torch.float32, device=d)
                # one eager run on the capture stream first, as capture
                # requires
                out.copy_(_program(entry, st, x))
            stream.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.device(d), torch.cuda.graph(
                    graph, pool=self._pool, stream=stream):
                out.copy_(_program(entry, st, x))
            stream.synchronize()
            gs.append(_Graph(st, x, out, graph))
        with self._lock:
            self._graphs[key] = gs
            self.capture_s[key] = time.perf_counter() - t0
        return gs

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

