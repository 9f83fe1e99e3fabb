"""Trained model of the port.

Holds the same tree arrays as ``dryad_tpu.Booster.tree_arrays()``, shaped
(num_trees, max_nodes), plus ``init_score``, ``max_depth_seen`` and the
frozen bin mapper.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dryad_tpu_torch.config import Params
from dryad_tpu_torch.data.sketch import BinMapper

CAT_WORDS = 8  # bitset words per node, as the reference stores them

ARRAY_KEYS = ("feature", "threshold", "left", "right", "value", "is_cat",
              "cat_bitset", "gain", "default_left", "cover")
_DTYPES = {"feature": np.int32, "threshold": np.int32, "left": np.int32,
           "right": np.int32, "value": np.float32, "is_cat": bool,
           "cat_bitset": np.uint32, "gain": np.float32,
           "default_left": bool, "cover": np.float32}


class Booster:
    def __init__(self, params: Params, mapper: BinMapper,
                 arrays: dict[str, np.ndarray], init_score,
                 max_depth_seen: int):
        missing = [k for k in ARRAY_KEYS if k not in arrays]
        if missing:
            raise ValueError(f"tree arrays missing: {missing}")
        self.params = params
        self.mapper = mapper
        self.arrays = {k: np.array(arrays[k], _DTYPES[k])  # owned copies
                       for k in ARRAY_KEYS}
        self.init_score = np.asarray(init_score, np.float32).reshape(-1)
        self.max_depth_seen = int(max_depth_seen)
        self.tree_seconds: list[float] = []

    @property
    def num_iterations(self) -> int:
        return int(self.arrays["feature"].shape[0])

    @property
    def num_outputs(self) -> int:
        return 1

    def tree_arrays(self) -> dict[str, np.ndarray]:
        return dict(self.arrays)

    def to_reference_arrays(self) -> dict[str, np.ndarray]:
        """Copies of the tree arrays with the reference's keys and dtypes,
        for comparison with ``dryad_tpu.Booster.tree_arrays()``."""
        return {k: v.copy() for k, v in self.arrays.items()}

    def predict(self, X: np.ndarray, *, raw_score: bool = False,
                num_iteration: Optional[int] = None, device=None) -> np.ndarray:
        from dryad_tpu_torch import predict

        return predict(self, X, raw_score=raw_score,
                       num_iteration=num_iteration, device=device)
