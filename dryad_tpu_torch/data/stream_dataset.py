"""Streamed (out-of-core) binned dataset: row-chunked tiles on disk.

The counterpart of ``dryad_tpu/data/stream_dataset.py``.  The binned
matrix lives in one raw file, row-major (N, F) ``uint8`` or ``uint16``
with no header (row r starts at byte ``r * F * itemsize``), the reference's
layout, so a spill written by either package reads in the other.  Labels,
weights, groups and the mapper stay resident: at Criteo scale the binned
matrix is what does not fit, not the 4-byte label per row.

Streamed training is resident training bit for bit, by construction: the
trainer uploads the (N, F) matrix chunk by chunk (``device_arrays``: the
prefetcher reads chunk i+1 from disk while chunk i is copied from a pinned
host buffer on a side stream into the preallocated device tensor) and then
runs the unchanged growers on the same device tensor a resident Dataset
gives.  Peak host residency is the prefetch window, never (N, F).

``ChunkPrefetcher`` is one reader thread feeding a bounded queue: reads
happen outside any lock, ``close`` is cancel-safe from the consumer's side
at any point, and a read error is re-raised in the consumer.
"""

from __future__ import annotations

import mmap
import os
import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from dryad_tpu_torch.dataset import Dataset

# default rows per streamed chunk (28 MB of u8 bins at F = 28)
DEFAULT_CHUNK_ROWS = 1 << 20

_DONE = object()          # the producer's last item: the stream ended


class ChunkPrefetcher:
    """Bounded single-producer chunk pipeline.

    A daemon thread calls ``read(i)`` for ``i in range(n_chunks)``, outside
    any lock, and feeds a ``queue.Queue(maxsize=depth)``; iterating yields
    ``(i, chunk)`` in order, so chunk i+1's read overlaps the consumer's
    work on chunk i.  ``close()`` flips the stop flag, drains the queue so
    that a producer blocked on a full queue sees the flag, and joins the
    thread.  A read error is kept and re-raised in the consumer."""

    def __init__(self, read: Callable[[int], np.ndarray], n_chunks: int,
                 depth: int = 2):
        self._read = read
        self._n = int(n_chunks)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        self._lock = threading.Lock()
        # guarded by _lock: the stop flag and the reader's error
        self._closed = False
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._produce, name="dryad-chunk-prefetch", daemon=True)
        self._thread.start()

    def _stopped(self) -> bool:
        with self._lock:
            return self._closed

    def _put(self, item) -> bool:
        """Put with a timeout loop, so a full queue never holds the
        producer past ``close()``; False when cancelled."""
        while not self._stopped():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        try:
            for i in range(self._n):
                if self._stopped():
                    return
                if not self._put((i, self._read(i))):
                    return
        except BaseException as e:     # re-raised in the consumer
            with self._lock:
                self._error = e
        finally:
            self._put(_DONE)

    def __iter__(self) -> Iterator[tuple[int, np.ndarray]]:
        delivered = 0
        while delivered < self._n and not self._stopped():
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            if item is _DONE:
                break
            delivered += 1
            yield item
        with self._lock:
            err = self._error
        if err is not None:
            raise err

    def close(self) -> None:
        with self._lock:
            already = self._closed
            self._closed = True
        if already:
            return
        # drain outside the lock: a producer blocked on the full queue
        # needs the room (or its timeout) to see the stop flag
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10.0)


class _StreamedMatrix:
    """Read-only stand-in for the resident (N, F) binned matrix: ``.shape``,
    ``.dtype``, ``len`` and the gathers ``Xb[rows]`` and ``Xb[rows, col]``
    with ascending ``rows``, each through bounded reads of the sub-range of
    every chunk it spans.  Results equal the resident slices element for
    element."""

    def __init__(self, ds: "StreamedDataset"):
        self._ds = ds
        self.shape = (ds.num_rows, ds.num_features)
        self.dtype = ds.bin_dtype

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, key):
        col: Optional[int] = None
        if isinstance(key, tuple):
            if len(key) != 2:
                raise TypeError(
                    "streamed matrix supports [rows] and [rows, col]")
            key, col = key
            col = int(col)
        rc = np.asarray(key)
        if rc.ndim != 1 or not np.issubdtype(rc.dtype, np.integer):
            raise TypeError("streamed matrix gathers take a 1-D integer "
                            f"row-index array (got {rc.dtype})")
        rc = rc.astype(np.int64, copy=False)
        ds = self._ds
        shape = (rc.size, ds.num_features) if col is None else (rc.size,)
        if rc.size == 0:
            return np.empty(shape, self.dtype)
        if rc[0] < 0 or rc[-1] >= ds.num_rows:
            raise IndexError("row index out of range")
        if rc.size > 1 and not bool((np.diff(rc) >= 0).all()):
            raise ValueError("streamed matrix gathers require ascending rows")
        out = np.empty(shape, self.dtype)
        for lo, hi in ds.chunk_bounds():
            i0 = int(np.searchsorted(rc, lo, side="left"))
            i1 = int(np.searchsorted(rc, hi, side="left"))
            if i0 == i1:
                continue
            lo2, hi2 = int(rc[i0]), int(rc[i1 - 1]) + 1
            buf = ds.read_rows(lo2, hi2)
            idx = rc[i0:i1] - lo2
            out[i0:i1] = buf[idx] if col is None else buf[idx, col]
        return out


class StreamedDataset(Dataset):
    """A Dataset whose binned matrix is a row-chunked file on disk.

    Built by ``dataset_from_chunks(..., spill=path)`` or
    ``dataset_from_csr_chunks(..., spill=path)``, or spilled from a
    resident Dataset by ``from_dataset``.  Labels, weights and groups stay
    resident.  ``X_binned`` raises: the matrix is reached through
    ``read_rows``, ``iter_chunks``, ``binned_view``, ``strided_rows`` and
    ``device_arrays``, or ``materialize()`` for a resident copy."""

    is_streamed = True

    def __init__(self, path, mapper, y=None, *, weight=None, group=None,
                 categorical_features: Sequence[int] = (),
                 num_rows: Optional[int] = None,
                 chunk_rows: int = DEFAULT_CHUNK_ROWS):
        self.categorical_features = tuple(int(c) for c in
                                          categorical_features)
        self.sparse_ingest = False
        self.mapper = mapper
        self.path = os.fspath(path)
        self.bin_dtype = np.dtype(mapper.bin_dtype)
        self.num_features = int(mapper.num_features)
        row_bytes = self.num_features * self.bin_dtype.itemsize
        size = os.path.getsize(self.path)
        if num_rows is None:
            if row_bytes == 0 or size % row_bytes:
                raise ValueError(
                    f"{self.path}: size {size} is not a multiple of the "
                    f"row stride {row_bytes} (F={self.num_features}, "
                    f"dtype={self.bin_dtype})")
            num_rows = size // row_bytes
        elif int(num_rows) * row_bytes > size:
            raise ValueError(f"{self.path}: {size} bytes hold fewer than "
                             f"{num_rows} x {row_bytes}-byte rows")
        self.num_rows = int(num_rows)
        self.chunk_rows = max(1, int(chunk_rows))
        self._attach_targets(y, weight, group)

    @property
    def X_binned(self):
        raise TypeError(
            "StreamedDataset keeps the binned matrix on disk: use "
            "binned_view()/read_rows()/iter_chunks(), or materialize() "
            "for a resident copy")

    @property
    def num_chunks(self) -> int:
        return -(-self.num_rows // self.chunk_rows)

    def chunk_bounds(self) -> list[tuple[int, int]]:
        return [(lo, min(lo + self.chunk_rows, self.num_rows))
                for lo in range(0, self.num_rows, self.chunk_rows)]

    def read_rows(self, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) as a fresh contiguous array, read at their offset
        (the pages land in the page cache, not in the process)."""
        lo, hi = int(lo), int(hi)
        if not 0 <= lo <= hi <= self.num_rows:
            raise ValueError(
                f"row range [{lo}, {hi}) outside [0, {self.num_rows})")
        count = (hi - lo) * self.num_features
        if count == 0:
            return np.empty((0, self.num_features), self.bin_dtype)
        with open(self.path, "rb") as f:
            f.seek(lo * self.num_features * self.bin_dtype.itemsize)
            buf = np.fromfile(f, dtype=self.bin_dtype, count=count)
        if buf.size != count:
            raise OSError(f"{self.path}: short read at rows [{lo}, {hi}) "
                          f"({buf.size} of {count} elements)")
        return buf.reshape(hi - lo, self.num_features)

    def iter_chunks(self, prefetch: int = 2):
        """Yield ``(lo, hi, rows[lo:hi])`` in order; with ``prefetch > 0``
        a reader thread loads up to ``prefetch`` chunks ahead of the
        caller, ``prefetch=0`` reads inline."""
        bounds = self.chunk_bounds()
        if prefetch <= 0 or len(bounds) <= 1:
            for lo, hi in bounds:
                yield lo, hi, self.read_rows(lo, hi)
            return
        pf = ChunkPrefetcher(lambda i: self.read_rows(*bounds[i]),
                             len(bounds), depth=prefetch)
        try:
            for i, buf in pf:
                yield bounds[i][0], bounds[i][1], buf
        finally:
            pf.close()

    def binned_view(self) -> _StreamedMatrix:
        return _StreamedMatrix(self)

    @property
    def has_missing(self) -> bool:
        """``Dataset.has_missing``, folded chunk by chunk."""
        if self._has_missing is None:
            zero_cols = np.zeros(self.num_features, bool)
            for _lo, _hi, buf in self.iter_chunks():
                zero_cols |= (buf == 0).any(axis=0)
            eligible = ~self.mapper.is_categorical
            bundled = getattr(self.mapper, "bundled_mask", None)
            if bundled is not None:
                eligible &= ~bundled
            self._has_missing = bool((zero_cols & eligible).any())
        return self._has_missing

    def strided_rows(self, stride: int) -> np.ndarray:
        """Exactly ``Xb[::stride]``, through chunked reads."""
        stride = max(1, int(stride))
        parts = []
        for lo, hi, buf in self.iter_chunks(prefetch=0):
            first = -(-lo // stride) * stride   # first multiple >= lo
            if first < hi:
                parts.append(np.ascontiguousarray(buf[first - lo::stride]))
        if not parts:
            return np.empty((0, self.num_features), self.bin_dtype)
        return np.concatenate(parts, axis=0)

    def _upload_matrix(self, device: torch.device) -> torch.Tensor:
        """The (N, F) bins on ``device``, assembled chunk by chunk into one
        preallocated tensor (``Dataset.device_arrays``' dtypes: uint8, or
        int32 for wider bins, widened a chunk at a time).  On the card the
        prefetcher reads chunk i+1 while chunk i is staged into one of two
        pinned buffers and copied on a side stream; a CUDA event orders
        each copy before its pinned buffer is reused.  On the CPU the same
        loop copies in place, without pinning or streams."""
        wide = self.bin_dtype != np.uint8
        dtype = torch.int32 if wide else torch.uint8
        out = torch.empty((self.num_rows, self.num_features), dtype=dtype,
                          device=device)
        cuda = device.type == "cuda"
        stream = torch.cuda.Stream(device) if cuda else None
        if cuda:
            # ``out`` may reuse a block that kernels queued on the caller's
            # stream still read: the side stream's copies wait for them
            stream.wait_stream(torch.cuda.current_stream(device))
        pinned: list = [None, None]
        done: list = [None, None]
        for i, (lo, hi, buf) in enumerate(self.iter_chunks(prefetch=1)):
            src = torch.from_numpy(buf.astype(np.int32) if wide else buf)
            if not cuda:
                out[lo:hi].copy_(src)
                continue
            k = i % 2
            if done[k] is not None:
                done[k].synchronize()       # its last copy has landed
            if pinned[k] is None:
                pinned[k] = torch.empty(self.chunk_rows * self.num_features,
                                        dtype=dtype, pin_memory=True)
            host = pinned[k][:src.numel()].view(src.shape)
            host.copy_(src)
            with torch.cuda.stream(stream):
                out[lo:hi].copy_(host, non_blocking=True)
                done[k] = torch.cuda.Event()
                done[k].record(stream)
        if cuda:
            # the pinned buffers go out of scope once every copy is done;
            # the caller's stream then sees the whole tensor
            stream.synchronize()
            torch.cuda.current_stream(device).wait_stream(stream)
        return out

    def materialize(self) -> Dataset:
        """A resident Dataset over the same binned matrix (reads the whole
        file)."""
        return Dataset.from_binned(
            self.read_rows(0, self.num_rows), self.mapper, self.y,
            weight=self.weight, group=self.group,
            categorical_features=self.categorical_features)

    @classmethod
    def from_dataset(cls, ds: Dataset, path, *,
                     chunk_rows: int = DEFAULT_CHUNK_ROWS
                     ) -> "StreamedDataset":
        """Spill a resident Dataset's binned matrix to ``path``, chunk by
        chunk, and return its streamed counterpart."""
        sink = SpillSink(path, ds.num_rows, ds.num_features,
                         np.dtype(ds.mapper.bin_dtype))
        step = max(1, int(chunk_rows))
        for lo in range(0, ds.num_rows, step):
            sink.write(ds.X_binned[lo:lo + step])
        sink.finish()
        return cls(path, ds.mapper, ds.y, weight=ds.weight, group=ds.group,
                   categorical_features=ds.categorical_features,
                   num_rows=ds.num_rows, chunk_rows=chunk_rows)


class SpillSink:
    """Sequential chunk writer into a preallocated raw on-disk matrix.
    Each block goes through a transient ``np.memmap`` window that is
    flushed and dropped from residency at once, so the writer holds about
    one chunk, never the whole matrix."""

    def __init__(self, path, total_rows: int, num_features: int,
                 dtype: np.dtype):
        self.path = os.fspath(path)
        self.total_rows = int(total_rows)
        self.num_features = int(num_features)
        self.dtype = np.dtype(dtype)
        self.row_bytes = self.num_features * self.dtype.itemsize
        with open(self.path, "wb") as f:
            f.truncate(self.total_rows * self.row_bytes)
        self.rows_written = 0

    def write(self, block: np.ndarray) -> None:
        block = np.asarray(block, self.dtype)
        n = block.shape[0]
        if n == 0:
            return
        if block.ndim != 2 or block.shape[1] != self.num_features:
            raise ValueError(f"spill block shape {block.shape} != "
                             f"(*, {self.num_features})")
        if self.rows_written + n > self.total_rows:
            raise ValueError("stream yielded more than the declared "
                             f"{self.total_rows} rows")
        mm = np.memmap(self.path, dtype=self.dtype, mode="r+",
                       offset=self.rows_written * self.row_bytes,
                       shape=(n, self.num_features))
        mm[:] = block
        mm.flush()
        try:
            mm._mmap.madvise(mmap.MADV_DONTNEED)
        except (AttributeError, ValueError, OSError):
            pass        # no madvise here: the bytes are the same
        del mm
        self.rows_written += n

    def finish(self) -> None:
        if self.rows_written != self.total_rows:
            raise ValueError(f"stream yielded {self.rows_written} rows, "
                             f"expected {self.total_rows}")
