"""Canonical quantile sketch -> per-feature bin mapper (numpy only).

A copy of ``dryad_tpu/data/sketch.py``'s canonical numpy path, so that the
port bins through the same frozen edges as the reference and binned ids
agree bit for bit.  The reference's optional native sketch is not copied:
it must match this numpy path anyway.

Binning contract:

* bin id 0 is always the missing (NaN) bin;
* numerical feature with ascending float32 edges ``e``:
  ``bin(x) = 1 + searchsorted(e, x, side='left')``;
* categorical feature: categories ranked by (count desc, value asc); rank
  r maps to bin r + 1, at most ``max_bins - 2`` of them; a category beyond
  the vocabulary, or unseen at predict, maps to the overflow (last) bin;
* a numerical split at (feature f, threshold bin t) sends ``bin <= t``
  left; a categorical split sends its node's set of bins left.

Sketching and binning go feature by feature, in blocks of ``_BLOCK``
columns copied contiguous and spread over a few threads: numpy's sorts
and searches release the interpreter lock, and each feature's result
depends on its own column alone, so the threads change no value.
"""

from __future__ import annotations

import dataclasses
import io
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np

MISSING_BIN = 0
# features per task, and the most threads the host pass uses
_BLOCK = 64
_MAX_THREADS = 8


def _by_feature(X: np.ndarray, fn) -> list:
    """``[fn(f, column f) for f in range(F)]`` of a (N, F) matrix, each
    column handed over contiguous; blocks of ``_BLOCK`` columns run on a
    thread pool."""
    F = X.shape[1]

    def block(f0: int) -> list:
        cols = np.ascontiguousarray(X[:, f0:f0 + _BLOCK].T)
        return [fn(f0 + j, cols[j]) for j in range(cols.shape[0])]

    starts = range(0, F, _BLOCK)
    threads = min(_MAX_THREADS, os.cpu_count() or 1, len(starts))
    if threads <= 1:
        return [r for f0 in starts for r in block(f0)]
    with ThreadPoolExecutor(threads) as pool:
        return [r for rs in pool.map(block, starts) for r in rs]


@dataclasses.dataclass
class FeatureBins:
    """Frozen binning recipe for one feature."""

    is_categorical: bool
    edges: np.ndarray
    cat_values: np.ndarray
    cat_bins: np.ndarray
    n_bins: int

    @property
    def overflow_bin(self) -> int:
        return self.n_bins - 1


def _sketch_numerical_np(col: np.ndarray, max_bins: int) -> FeatureBins:
    finite = col[np.isfinite(col)]
    if finite.size == 0:
        edges = np.empty((0,), np.float32)
        return FeatureBins(False, edges, np.empty(0, np.float32),
                           np.empty(0, np.int32), 2)
    distinct = np.unique(finite)
    max_edges = max_bins - 2  # bins = missing + (edges+1)
    if distinct.size - 1 <= max_edges:
        # one bin per distinct value; boundaries midway between neighbours
        edges = ((distinct[:-1] + distinct[1:]) * np.float32(0.5)).astype(np.float32)
    else:
        # equal-frequency cuts over the sorted sample, deduplicated
        svals = np.sort(finite)
        pos = (np.arange(1, max_edges + 1, dtype=np.int64) * svals.size) // (max_edges + 1)
        edges = np.unique(svals[pos].astype(np.float32))
    return FeatureBins(
        False, edges.astype(np.float32), np.empty(0, np.float32),
        np.empty(0, np.int32), int(edges.size) + 2,
    )


def _sketch_categorical(col: np.ndarray, max_bins: int) -> FeatureBins:
    finite = col[np.isfinite(col)]
    vals, counts = np.unique(finite, return_counts=True)
    # rank by (count desc, value asc)
    order = np.lexsort((vals, -counts))
    # bin 0 is missing and the last bin the overflow
    n_kept = int(min(vals.size, max_bins - 2))
    kept = vals[order[:n_kept]]
    bins = np.arange(1, n_kept + 1, dtype=np.int32)
    # stored sorted by value for the searchsorted lookup
    sort_idx = np.argsort(kept, kind="stable")
    return FeatureBins(True, np.empty(0, np.float32),
                       kept[sort_idx].astype(np.float32),
                       bins[sort_idx].astype(np.int32), n_kept + 2)


def sketch_column(col: np.ndarray, max_bins: int,
                  categorical: bool) -> FeatureBins:
    """One feature's recipe from its raw values."""
    return (_sketch_categorical(col, max_bins) if categorical
            else _sketch_numerical_np(col, max_bins))


def sketch_features(X: np.ndarray, max_bins: int = 256,
                    categorical_features: Sequence[int] = ()
                    ) -> "BinMapper":
    """Build the frozen per-feature bin mapper from dense training data."""
    X = np.asarray(X, dtype=np.float32)
    if X.ndim != 2:
        raise ValueError(f"X must be 2-D, got shape {X.shape}")
    cats = frozenset(int(c) for c in categorical_features)
    feats = _by_feature(
        X, lambda f, col: sketch_column(col, max_bins, f in cats))
    return BinMapper(feats, max_bins)


class BinMapper:
    """Frozen collection of per-feature binning recipes."""

    def __init__(self, features: list[FeatureBins], max_bins: int):
        self.features = features
        self.max_bins = int(max_bins)

    @property
    def num_features(self) -> int:
        return len(self.features)

    @property
    def n_bins(self) -> np.ndarray:
        return np.array([f.n_bins for f in self.features], np.int32)

    @property
    def total_bins(self) -> int:
        return int(self.n_bins.max(initial=2))

    @property
    def bin_dtype(self) -> np.dtype:
        return np.dtype(np.uint8 if self.total_bins <= 256 else np.uint16)

    @property
    def is_categorical(self) -> np.ndarray:
        return np.array([f.is_categorical for f in self.features], bool)

    def transform_column(self, col: np.ndarray, f: int) -> np.ndarray:
        fb = self.features[f]
        col = np.asarray(col, np.float32)
        if fb.is_categorical:
            if fb.cat_values.size:
                idx = np.minimum(np.searchsorted(fb.cat_values, col),
                                 fb.cat_values.size - 1)
                hit = fb.cat_values[idx] == col
                out = np.where(hit, fb.cat_bins[idx],
                               fb.overflow_bin).astype(np.int32)
            else:
                out = np.full(col.shape, fb.overflow_bin, np.int32)
        else:
            out = (1 + np.searchsorted(fb.edges, col, side="left")).astype(
                np.int32)
        out[np.isnan(col)] = MISSING_BIN
        return out

    def transform(self, X: np.ndarray) -> np.ndarray:
        """Map raw features -> bin ids, dtype uint8/uint16, shape (N, F)."""
        X = np.asarray(X, np.float32)
        if X.ndim != 2 or X.shape[1] != self.num_features:
            raise ValueError(f"X must be (N, {self.num_features}), got "
                             f"{X.shape}")
        out = np.empty(X.shape, self.bin_dtype)

        def column(f: int, col: np.ndarray) -> None:
            out[:, f] = self.transform_column(col, f)

        _by_feature(X, column)
        return out

    # ---- serialization (byte for byte the reference's) --------------------
    def to_json_dict(self) -> dict:
        """JSON-safe structural dump.  Floats pass through Python float
        (exact f64 widening of the f32 edges), so json round-trips them
        bit-exactly; +-inf edges serialize as JSON Infinity."""
        return {
            "type": "plain",
            "max_bins": int(self.max_bins),
            "features": [
                {
                    "is_categorical": bool(f.is_categorical),
                    "edges": [float(e) for e in np.asarray(f.edges, np.float32)],
                    "cat_values": [float(v) for v in
                                   np.asarray(f.cat_values, np.float32)],
                    "cat_bins": [int(b) for b in f.cat_bins],
                    "n_bins": int(f.n_bins),
                }
                for f in self.features
            ],
        }

    @classmethod
    def from_json_dict(cls, d: dict) -> "BinMapper":
        feats = [
            FeatureBins(
                bool(f["is_categorical"]),
                np.asarray(f["edges"], np.float32),
                np.asarray(f["cat_values"], np.float32),
                np.asarray(f["cat_bins"], np.int32),
                int(f["n_bins"]),
            )
            for f in d["features"]
        ]
        return cls(feats, int(d["max_bins"]))

    def to_bytes(self) -> bytes:
        """The reference's npz layout (``BinMapper.to_bytes``): a model
        file's ``mapper`` entry, readable by either package."""
        buf = io.BytesIO()
        arrs: dict[str, np.ndarray] = {
            "max_bins": np.array([self.max_bins], np.int64),
            "is_cat": self.is_categorical,
            "n_bins": self.n_bins,
        }
        for i, f in enumerate(self.features):
            arrs[f"edges_{i}"] = f.edges
            arrs[f"catv_{i}"] = f.cat_values
            arrs[f"catb_{i}"] = f.cat_bins
        np.savez_compressed(buf, **arrs)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "BinMapper":
        with np.load(io.BytesIO(data)) as z:
            if "efb_base" in z.files:
                # a bundled (EFB) mapper's container
                from dryad_tpu_torch.data.bundling import BundledMapper

                return BundledMapper.from_bytes(data)
            n = z["is_cat"].shape[0]
            feats = [
                FeatureBins(
                    bool(z["is_cat"][i]),
                    z[f"edges_{i}"],
                    z[f"catv_{i}"],
                    z[f"catb_{i}"],
                    int(z["n_bins"][i]),
                )
                for i in range(n)
            ]
            return cls(feats, int(z["max_bins"][0]))
