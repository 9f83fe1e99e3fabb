"""Training set: raw features -> frozen sketch -> binned matrix.

The counterpart of ``dryad_tpu.Dataset``: dense ``X`` or a CSR triple
(``csr=(indptr, indices, values, F)``, where absent entries are 0.0),
optional categorical features, sample weights and, for ranking, query
groups (``group[i]`` rows in query i, consecutive, the LightGBM
convention).  CSR ingest folds strictly exclusive sparse columns into
bundles (EFB, ``bundle=True``).  The binned matrix stays on the host as
numpy; the trainer takes it on its device through ``device_arrays``, which
uploads once per device and keeps the tensors, so repeated ``train`` calls
on one Dataset upload once.  Validation sets bin through the training
set's frozen mapper (``bind``), as predict does.  A Dataset whose bins
live on disk is a ``data/stream_dataset.StreamedDataset``.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from dryad_tpu_torch.data.binning import bin_csr, bin_matrix, column_order
from dryad_tpu_torch.data.bundling import BundledMapper, plan_bundles
from dryad_tpu_torch.data.sketch import (
    _MAX_THREADS,
    BinMapper,
    sketch_column,
    sketch_features,
)


def binned_to_device(X_binned: np.ndarray, device) -> torch.Tensor:
    """u8 bins stay uint8; wider bins travel as int32 (torch's uint16
    support is thin)."""
    if X_binned.dtype == np.uint8:
        return torch.from_numpy(np.ascontiguousarray(X_binned)).to(device)
    return torch.from_numpy(X_binned.astype(np.int32)).to(device)


class Dataset:
    # the binned matrix lives on disk (``StreamedDataset``)
    is_streamed = False

    def __init__(self, X: Optional[np.ndarray] = None,
                 y: Optional[np.ndarray] = None, *,
                 weight: Optional[np.ndarray] = None,
                 group: Optional[np.ndarray] = None,
                 categorical_features: Sequence[int] = (),
                 max_bins: int = 256, mapper=None,
                 csr: Optional[tuple] = None, bundle: bool = True):
        if (X is None) == (csr is None):
            raise ValueError("provide exactly one of X (dense) or "
                             "csr=(indptr, indices, values, num_features)")
        self.categorical_features = tuple(int(c) for c in
                                          categorical_features)
        # built from CSR rows (a process group refuses such sets for now)
        self.sparse_ingest = csr is not None
        if csr is not None:
            indptr, indices, values, num_features = csr
            if mapper is None:
                base = _sketch_csr(indptr, indices, values, num_features,
                                   max_bins, self.categorical_features)
                Xb0 = bin_csr(indptr, indices, values, num_features, base)
                plan = plan_bundles(Xb0, base, max_bins) if bundle else []
                mapper = BundledMapper(base, plan) if plan else base
                self.X_binned = mapper.fold(Xb0) if plan else Xb0
            elif isinstance(mapper, BundledMapper):
                self.X_binned = mapper.fold(bin_csr(
                    indptr, indices, values, num_features, mapper.base))
            else:
                self.X_binned = bin_csr(indptr, indices, values,
                                        num_features, mapper)
        else:
            X = np.asarray(X, np.float32)
            if mapper is None:
                mapper = sketch_features(
                    X, max_bins=max_bins,
                    categorical_features=self.categorical_features)
            self.X_binned = bin_matrix(X, mapper)
        self.mapper = mapper
        self.num_rows, self.num_features = self.X_binned.shape
        self._attach_targets(y, weight, group)

    def _attach_targets(self, y, weight, group) -> None:
        """Check and store labels, weights and query groups (shared by
        ``__init__`` and ``from_binned``)."""
        self.y = None if y is None else np.ascontiguousarray(y, np.float32)
        if self.y is not None and self.y.shape[0] != self.num_rows:
            raise ValueError("y length mismatch")
        self.weight = (None if weight is None
                       else np.ascontiguousarray(weight, np.float32))
        if self.weight is not None and self.weight.shape[0] != self.num_rows:
            raise ValueError(f"weight length {self.weight.shape[0]} != "
                             f"num_rows {self.num_rows}")
        self.group = (None if group is None
                      else np.ascontiguousarray(group, np.int64))
        if self.group is not None and int(self.group.sum()) != self.num_rows:
            raise ValueError("group sizes must sum to num_rows")
        self._has_missing: Optional[bool] = None
        self._device_cache: dict = {}

    def device_arrays(self, device) -> tuple:
        """(Xb, y, weight) on ``device``, uploaded once per device and kept
        (y and weight None when absent).  The arrays are treated as
        immutable once uploaded: a set whose arrays change is a new
        Dataset.  The counterpart of the reference's memoized
        ``device_arrays``."""
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available to upload the "
                               "dataset to")
        key = str(dev)
        if key not in self._device_cache:
            self._device_cache[key] = (
                self._upload_matrix(dev),
                None if self.y is None else torch.from_numpy(self.y).to(dev),
                None if self.weight is None
                else torch.from_numpy(self.weight).to(dev))
        return self._device_cache[key]

    def _upload_matrix(self, device: torch.device) -> torch.Tensor:
        return binned_to_device(self.X_binned, device)

    @classmethod
    def from_binned(cls, X_binned: np.ndarray, mapper,
                    y: Optional[np.ndarray] = None, *,
                    weight: Optional[np.ndarray] = None,
                    group: Optional[np.ndarray] = None,
                    categorical_features: Sequence[int] = ()) -> "Dataset":
        """A Dataset over an already-binned matrix (shared, not copied),
        with the same checks of labels, weights and groups as
        ``__init__``: new labels for rows binned once."""
        ds = cls.__new__(cls)
        ds.categorical_features = tuple(int(c) for c in categorical_features)
        ds.sparse_ingest = False
        ds.mapper = mapper
        ds.X_binned = X_binned
        ds.num_rows, ds.num_features = X_binned.shape
        ds._attach_targets(y, weight, group)
        return ds

    def bind(self, X: Optional[np.ndarray] = None,
             y: Optional[np.ndarray] = None, **kw) -> "Dataset":
        """Bin new data (validation, test) through this set's frozen
        mapper, dense ``X`` or ``csr=``; ``weight=`` and ``group=`` pass
        through."""
        return Dataset(X, y, mapper=self.mapper,
                       categorical_features=self.categorical_features, **kw)

    @property
    def query_offsets(self) -> Optional[np.ndarray]:
        """(Q + 1,) int64 row offsets of the query groups, or None."""
        if self.group is None:
            return None
        return np.concatenate([[0], np.cumsum(self.group)]).astype(np.int64)

    @property
    def has_missing(self) -> bool:
        """True when any numerical column holds missing (bin 0) rows: the
        grower then scans splits in both missing directions.  Categorical
        columns learn the missing direction through membership, and a
        bundle column's bin 0 means "every member at its default", so
        neither counts."""
        if self._has_missing is None:
            zero_cols = (self.X_binned == 0).any(axis=0)
            eligible = ~self.mapper.is_categorical
            bundled = getattr(self.mapper, "bundled_mask", None)
            if bundled is not None:
                eligible &= ~bundled
            self._has_missing = bool((zero_cols & eligible).any())
        return self._has_missing


def _sketch_csr(indptr, indices, values, num_features: int, max_bins: int,
                categorical_features: Sequence[int]) -> BinMapper:
    """The mapper of a CSR matrix: each feature is sketched from its
    explicit values plus its implicit zeros, joined as an exact count (they
    dominate Criteo-shaped data).  Features are sketched on a thread pool;
    each depends on its own values alone."""
    n = indptr.shape[0] - 1
    cols = np.asarray(indices)
    vals_s = np.asarray(values, np.float32)[column_order(cols, num_features)]
    bounds = np.concatenate(
        [[0], np.cumsum(np.bincount(cols, minlength=num_features))])
    cats = frozenset(int(c) for c in categorical_features)

    def feature(f: int):
        explicit = vals_s[bounds[f]:bounds[f + 1]]
        col = np.concatenate([explicit, np.zeros(n - explicit.size,
                                                 np.float32)])
        return sketch_column(col, max_bins, f in cats)

    threads = min(_MAX_THREADS, os.cpu_count() or 1, num_features)
    if threads <= 1:
        feats = [feature(f) for f in range(num_features)]
    else:
        with ThreadPoolExecutor(threads) as pool:
            feats = list(pool.map(feature, range(num_features)))
    return BinMapper(feats, max_bins)
