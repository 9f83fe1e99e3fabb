"""Dense training set: raw features -> frozen sketch -> binned matrix.

The counterpart of ``dryad_tpu.Dataset`` for dense, unweighted data.  The
binned matrix stays on the host as numpy; the trainer uploads it to its
device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dryad_tpu_torch.data.binning import bin_matrix
from dryad_tpu_torch.data.sketch import BinMapper, sketch_features


class Dataset:
    def __init__(self, X: np.ndarray, y: Optional[np.ndarray] = None, *,
                 max_bins: int = 256, mapper: Optional[BinMapper] = None):
        X = np.asarray(X, np.float32)
        if mapper is None:
            mapper = sketch_features(X, max_bins=max_bins)
        self.mapper = mapper
        self.X_binned = bin_matrix(X, mapper)
        self.num_rows, self.num_features = self.X_binned.shape
        self.y = None if y is None else np.ascontiguousarray(y, np.float32)
        if self.y is not None and self.y.shape[0] != self.num_rows:
            raise ValueError("y length mismatch")
        self._has_missing: Optional[bool] = None

    @property
    def has_missing(self) -> bool:
        """True when any numerical column holds missing (bin 0) rows: the
        grower then scans splits in both missing directions."""
        if self._has_missing is None:
            zero_cols = (self.X_binned == 0).any(axis=0)
            self._has_missing = bool((zero_cols & ~self.mapper.is_categorical).any())
        return self._has_missing
