"""Binning front ends: dense matrices and CSR sparse input, through the
frozen ``BinMapper`` (see data/sketch.py for the bit-exact contract).
Dense matrices bin in the native host layer (``dryad_tpu_torch/native``)
when it is available, as in ``dryad_tpu/data/binning.py``.

The sparse path serves Criteo-shaped data: the CSR triple is binned block
by block of rows, absent entries taking their feature's zero-value bin,
and the dense float matrix is never built.  Blocks are independent, so
they run on a thread pool (numpy's sorts and searches release the
interpreter lock) and the result does not depend on the threads.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from dryad_tpu_torch.data.sketch import _MAX_THREADS, BinMapper

# rows of CSR input binned per block (one thread's unit of work)
_BLOCK_ROWS = 65536


def bin_matrix(X: np.ndarray, mapper) -> np.ndarray:
    """Dense raw features -> bin ids (N, F) uint8/uint16: through the
    native host layer when it is available, else ``mapper.transform`` (a
    bundled mapper bins through its base, then folds)."""
    if hasattr(mapper, "fold"):
        return mapper.transform(X)
    from dryad_tpu_torch import native

    out = native.bin_matrix(np.asarray(X, np.float32), mapper)
    if out is not None:
        return out
    return mapper.transform(X)


def zero_bins(mapper: BinMapper) -> np.ndarray:
    """Per-feature bin id of the raw value 0.0 (the sparse default)."""
    zero = np.zeros((1,), np.float32)
    return np.array([mapper.transform_column(zero, f)[0]
                     for f in range(mapper.num_features)], np.int32)


def column_order(cols: np.ndarray, num_features: int) -> np.ndarray:
    """The stable argsort of CSR column ids, on the narrowest unsigned key
    (numpy sorts keys of 16 bits or less by radix, in linear time)."""
    if num_features <= 1 << 16:
        cols = cols.astype(np.uint8 if num_features <= 1 << 8
                           else np.uint16)
    return np.argsort(cols, kind="stable")


def bin_csr(indptr: np.ndarray, indices: np.ndarray, values: np.ndarray,
            num_features: int, mapper: BinMapper) -> np.ndarray:
    """CSR ``(indptr, indices, values)`` -> binned (N, F), bit for bit the
    binning of the dense matrix with explicit 0.0 at the absent entries."""
    n = indptr.shape[0] - 1
    out = np.empty((n, num_features), mapper.bin_dtype)
    zb = zero_bins(mapper).astype(mapper.bin_dtype)

    def block(start: int) -> None:
        stop = min(start + _BLOCK_ROWS, n)
        blk = np.broadcast_to(zb, (stop - start, num_features)).copy()
        lo, hi = indptr[start], indptr[stop]
        rows = np.repeat(np.arange(stop - start, dtype=np.int64),
                         np.diff(indptr[start:stop + 1]))
        cols = indices[lo:hi]
        vals = values[lo:hi].astype(np.float32)
        # the explicit entries, feature by feature
        order = column_order(cols, num_features)
        rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
        bounds = np.searchsorted(cols_s, np.arange(num_features + 1))
        for f in range(num_features):
            a, b = bounds[f], bounds[f + 1]
            if a < b:
                blk[rows_s[a:b], f] = mapper.transform_column(
                    vals_s[a:b], f).astype(mapper.bin_dtype)
        out[start:stop] = blk

    starts = range(0, n, _BLOCK_ROWS)
    threads = min(_MAX_THREADS, os.cpu_count() or 1, len(starts))
    if threads <= 1:
        for s in starts:
            block(s)
    else:
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(block, starts))   # re-raises a block's error
    return out
