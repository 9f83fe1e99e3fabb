"""Out-of-core ingest: a Dataset from row chunks, without ever holding the
raw float table in memory.

The counterpart of ``dryad_tpu/data/streaming.py``.  Two passes over the
chunk stream:

1. **Sketch pass**: a subsample keyed on the global row id
   (``keyed_uniform``, a stateless splitmix64 hash) feeds the canonical
   sketch.  The kept rows depend only on (seed, global row id), never on
   the chunk boundaries, so re-chunking (or splitting the rows over the
   ranks of a process group, ``distributed.sketch_distributed``) cannot
   change the frozen edges.
2. **Bin pass**: each chunk is binned through the frozen mapper straight
   into the preallocated uint8/uint16 matrix, or, with ``spill=path``,
   onto disk through ``stream_dataset.SpillSink``, which returns a
   ``StreamedDataset`` whose binned matrix is never resident.

``chunks`` is a restartable factory: a callable that returns a fresh
iterable of row chunks each time it is called.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

import numpy as np

from dryad_tpu_torch.data.sketch import BinMapper, sketch_features


def keyed_uniform(row_offset: int, n: int, seed: int) -> np.ndarray:
    """uniform(0, 1) per row, a pure function of (seed, global row id): a
    stateless splitmix64 finalizer, so any split of the rows draws the
    same values.  Bit for bit the reference's ``_keyed_uniform``."""
    r = np.arange(row_offset, row_offset + n, dtype=np.uint64)
    z = r + np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15) + np.uint64(
        0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))


def _check_rows(got: int, total_rows: int) -> None:
    if got != total_rows:
        raise ValueError(f"stream yielded {got} rows, expected {total_rows}")


def sketch_stream(chunks: Callable[[], Iterable[np.ndarray]],
                  total_rows: int, *, max_bins: int = 256,
                  categorical_features: Sequence[int] = (),
                  sample_rows: int = 1 << 20, seed: int = 0) -> BinMapper:
    """The frozen BinMapper of one pass over dense chunks: the rows whose
    keyed draw falls under ``sample_rows / total_rows`` are sketched."""
    rate = min(1.0, sample_rows / max(total_rows, 1))
    parts: list[np.ndarray] = []
    offset = 0
    for chunk in chunks():
        chunk = np.asarray(chunk, np.float32)
        keep = keyed_uniform(offset, chunk.shape[0], seed) < rate
        parts.append(np.ascontiguousarray(chunk[keep]))
        offset += chunk.shape[0]
    _check_rows(offset, total_rows)
    return sketch_features(np.concatenate(parts, axis=0), max_bins=max_bins,
                           categorical_features=categorical_features)


def _spill(chunks, fold, out_mapper, total_rows: int, spill: str, y, *,
           weight, group, categorical_features, chunk_rows):
    """The bin pass onto disk: each folded chunk through ``SpillSink``;
    returns the ``StreamedDataset`` over the file."""
    from dryad_tpu_torch.data.stream_dataset import (
        DEFAULT_CHUNK_ROWS,
        SpillSink,
        StreamedDataset,
    )

    # mapper.num_features, not the raw column count: a BundledMapper folds
    sink = SpillSink(spill, total_rows, out_mapper.num_features,
                     np.dtype(out_mapper.bin_dtype))
    for chunk in chunks():
        sink.write(fold(chunk))
    sink.finish()
    return StreamedDataset(
        spill, out_mapper, y, weight=weight, group=group,
        categorical_features=categorical_features, num_rows=total_rows,
        chunk_rows=chunk_rows or DEFAULT_CHUNK_ROWS)


def _resident(chunks, fold, out_mapper, total_rows: int, y, *, weight,
              group, categorical_features):
    """The bin pass into the preallocated resident matrix."""
    from dryad_tpu_torch.dataset import Dataset

    Xb = np.empty((total_rows, out_mapper.num_features),
                  out_mapper.bin_dtype)
    offset = 0
    for chunk in chunks():
        block = fold(chunk)
        if offset + block.shape[0] > total_rows:
            raise ValueError(f"stream yielded more than {total_rows} rows")
        Xb[offset:offset + block.shape[0]] = block
        offset += block.shape[0]
    _check_rows(offset, total_rows)
    return Dataset.from_binned(Xb, out_mapper, y, weight=weight, group=group,
                               categorical_features=categorical_features)


def dataset_from_chunks(chunks: Callable[[], Iterable[np.ndarray]],
                        y: np.ndarray, total_rows: int, num_features: int, *,
                        weight: Optional[np.ndarray] = None,
                        group: Optional[np.ndarray] = None,
                        categorical_features: Sequence[int] = (),
                        max_bins: int = 256,
                        mapper: Optional[BinMapper] = None,
                        sample_rows: int = 1 << 20, seed: int = 0,
                        spill: Optional[str] = None,
                        chunk_rows: Optional[int] = None):
    """An out-of-core Dataset from dense row chunks (module doc).  The
    sketch pass is skipped when ``mapper`` is given.  With ``spill=path``
    the bins go to disk and a ``StreamedDataset`` reading ``chunk_rows``
    rows at a time (default ``DEFAULT_CHUNK_ROWS``) comes back."""
    if mapper is None:
        mapper = sketch_stream(chunks, total_rows, max_bins=max_bins,
                               categorical_features=categorical_features,
                               sample_rows=sample_rows, seed=seed)

    def fold(chunk):
        return mapper.transform(np.asarray(chunk, np.float32))

    kw = {"weight": weight, "group": group,
          "categorical_features": categorical_features}
    if spill is not None:
        return _spill(chunks, fold, mapper, total_rows, spill, y,
                      chunk_rows=chunk_rows, **kw)
    if mapper.num_features != num_features:
        raise ValueError(f"the mapper bins {mapper.num_features} features, "
                         f"not {num_features}")
    return _resident(chunks, fold, mapper, total_rows, y, **kw)


def _csr_sample(indptr, indices, values, keep: np.ndarray):
    """The CSR rows ``keep`` (ascending ids) of a chunk, as their own CSR
    triple."""
    indptr = np.asarray(indptr, np.int64)
    counts = indptr[keep + 1] - indptr[keep]
    starts = np.repeat(indptr[keep], counts)
    within = np.arange(counts.sum(), dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts)
    src = starts + within
    return (np.concatenate([[0], np.cumsum(counts)]).astype(np.int64),
            np.asarray(indices)[src], np.asarray(values, np.float32)[src])


def sketch_stream_csr(chunks: Callable[[], Iterable[tuple]],
                      total_rows: int, num_features: int, *,
                      max_bins: int = 256,
                      categorical_features: Sequence[int] = (),
                      sample_rows: int = 1 << 20,
                      seed: int = 0) -> BinMapper:
    """The frozen BinMapper of one pass over CSR chunks ``(indptr, indices,
    values)`` (indptr chunk-local): the keyed row subsample, kept sparse,
    sketched as ``Dataset`` sketches CSR input (``dataset._sketch_csr``:
    explicit values plus implicit zeros, the edges of the densified
    sample)."""
    from dryad_tpu_torch.dataset import _sketch_csr

    rate = min(1.0, sample_rows / max(total_rows, 1))
    parts = []
    offset = 0
    for indptr, indices, values in chunks():
        n = len(indptr) - 1
        keep = np.flatnonzero(keyed_uniform(offset, n, seed) < rate)
        parts.append(_csr_sample(indptr, indices, values, keep))
        offset += n
    _check_rows(offset, total_rows)
    ptrs, cols, vals = zip(*parts)
    base = np.cumsum([0] + [p[-1] for p in ptrs[:-1]])
    indptr = np.concatenate([ptrs[0][:1]] + [p[1:] + b
                                             for p, b in zip(ptrs, base)])
    return _sketch_csr(indptr, np.concatenate(cols), np.concatenate(vals),
                       num_features, max_bins, categorical_features)


def _verified_plan(chunks, bin_chunk, mapper, plan: list) -> list:
    """The bundle plan made on a prefix, verified exactly over the whole
    stream: one pass counts each bundle's pairwise member conflicts (two
    members off their zero bin in one row), then the plan's greedy
    eviction replays on the counts, so every kept bundle is strictly
    exclusive and the fold drops nothing."""
    from dryad_tpu_torch.data.binning import zero_bins

    zb = zero_bins(mapper)
    mats = [np.zeros((len(m), len(m)), np.int64) for m in plan]
    for triple in chunks():
        Xb0 = bin_chunk(*triple)
        for bi, members in enumerate(plan):
            nz = Xb0[:, members] != zb[members][None, :]
            mats[bi] += nz.T.astype(np.int64) @ nz.astype(np.int64)
    verified = []
    for members, mat in zip(plan, mats):
        kept: list[int] = []
        for i in range(len(members)):
            if not any(mat[i, j] for j in kept):
                kept.append(i)
        if len(kept) >= 2:
            verified.append([members[i] for i in kept])
    return verified


def dataset_from_csr_chunks(chunks: Callable[[], Iterable[tuple]],
                            y: np.ndarray, total_rows: int,
                            num_features: int, *,
                            weight: Optional[np.ndarray] = None,
                            group: Optional[np.ndarray] = None,
                            categorical_features: Sequence[int] = (),
                            max_bins: int = 256,
                            mapper: Optional[BinMapper] = None,
                            sample_rows: int = 1 << 20, seed: int = 0,
                            bundle: bool = True, plan_rows: int = 1 << 20,
                            spill: Optional[str] = None,
                            chunk_rows: Optional[int] = None):
    """An out-of-core Dataset from CSR chunks with exclusive feature
    bundling: the streamed sketch (skipped when ``mapper`` is given), the
    bundle plan (``data/bundling.plan_bundles``) on the first
    ``plan_rows`` rows, its exact verification over the whole stream
    (``_verified_plan``), then the chunk by chunk fold into the bundled
    matrix, resident or spilled (``spill=``, as in
    ``dataset_from_chunks``).  ``chunks`` is iterated up to four times."""
    from dryad_tpu_torch.data.binning import bin_csr
    from dryad_tpu_torch.data.bundling import BundledMapper, plan_bundles

    if mapper is None:
        mapper = sketch_stream_csr(
            chunks, total_rows, num_features, max_bins=max_bins,
            categorical_features=categorical_features,
            sample_rows=sample_rows, seed=seed)

    def bin_chunk(indptr, indices, values):
        return bin_csr(np.asarray(indptr, np.int64),
                       np.asarray(indices, np.int64),
                       np.asarray(values, np.float32), num_features, mapper)

    plan: list = []
    if bundle:
        prefix, got = [], 0
        for triple in chunks():
            prefix.append(bin_chunk(*triple))
            got += prefix[-1].shape[0]
            if got >= min(plan_rows, total_rows):
                break
        plan = plan_bundles(np.concatenate(prefix, axis=0)[:plan_rows],
                            mapper, max_bins, sample_rows=plan_rows)
        del prefix
    if plan:
        plan = _verified_plan(chunks, bin_chunk, mapper, plan)
    out_mapper = BundledMapper(mapper, plan) if plan else mapper

    def fold(triple):
        Xb0 = bin_chunk(*triple)
        return out_mapper.fold(Xb0) if plan else Xb0

    kw = {"weight": weight, "group": group,
          "categorical_features": categorical_features}
    if spill is not None:
        return _spill(chunks, fold, out_mapper, total_rows, spill, y,
                      chunk_rows=chunk_rows, **kw)
    return _resident(chunks, fold, out_mapper, total_rows, y, **kw)
