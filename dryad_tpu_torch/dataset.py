"""Dense training set: raw features -> frozen sketch -> binned matrix.

The counterpart of ``dryad_tpu.Dataset`` for dense data with optional
sample weights and, for ranking, query groups (``group[i]`` rows in query
i, consecutive, the LightGBM convention).  The binned matrix stays on the
host as numpy; the trainer uploads it to its device.  Validation sets bin
through the training set's frozen mapper (``bind``), as predict does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dryad_tpu_torch.data.binning import bin_matrix
from dryad_tpu_torch.data.sketch import BinMapper, sketch_features


class Dataset:
    def __init__(self, X: np.ndarray, y: Optional[np.ndarray] = None, *,
                 weight: Optional[np.ndarray] = None,
                 group: Optional[np.ndarray] = None, max_bins: int = 256,
                 mapper: Optional[BinMapper] = None):
        X = np.asarray(X, np.float32)
        if mapper is None:
            mapper = sketch_features(X, max_bins=max_bins)
        self.mapper = mapper
        self.X_binned = bin_matrix(X, mapper)
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

    @classmethod
    def from_binned(cls, X_binned: np.ndarray, mapper: BinMapper,
                    y: Optional[np.ndarray] = None, *,
                    weight: Optional[np.ndarray] = None,
                    group: Optional[np.ndarray] = None) -> "Dataset":
        """A Dataset over an already-binned matrix (shared, not copied),
        with the same checks of labels, weights and groups as
        ``__init__``: new labels for rows binned once."""
        ds = cls.__new__(cls)
        ds.mapper = mapper
        ds.X_binned = X_binned
        ds.num_rows, ds.num_features = X_binned.shape
        ds._attach_targets(y, weight, group)
        return ds

    def bind(self, X: np.ndarray, y: Optional[np.ndarray] = None,
             **kw) -> "Dataset":
        """Bin new data (validation, test) through this set's frozen
        mapper; ``weight=`` and ``group=`` pass through."""
        return Dataset(X, y, mapper=self.mapper, **kw)

    @property
    def query_offsets(self) -> Optional[np.ndarray]:
        """(Q + 1,) int64 row offsets of the query groups, or None."""
        if self.group is None:
            return None
        return np.concatenate([[0], np.cumsum(self.group)]).astype(np.int64)

    @property
    def has_missing(self) -> bool:
        """True when any numerical column holds missing (bin 0) rows: the
        grower then scans splits in both missing directions."""
        if self._has_missing is None:
            zero_cols = (self.X_binned == 0).any(axis=0)
            self._has_missing = bool((zero_cols & ~self.mapper.is_categorical).any())
        return self._has_missing
