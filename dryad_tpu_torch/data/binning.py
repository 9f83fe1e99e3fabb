"""Dense binning front end: raw features -> bin ids through the frozen
``BinMapper`` (see data/sketch.py for the bit-exact contract)."""

from __future__ import annotations

import numpy as np

from dryad_tpu_torch.data.sketch import BinMapper


def bin_matrix(X: np.ndarray, mapper: BinMapper) -> np.ndarray:
    """Dense raw features -> bin ids (N, F) uint8/uint16."""
    return mapper.transform(np.asarray(X, np.float32))
