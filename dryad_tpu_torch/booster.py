"""Trained model of the port.

Holds the same tree arrays as ``dryad_tpu.Booster.tree_arrays()``, shaped
(num_trees, max_nodes), plus ``init_score``, ``max_depth_seen``, the
frozen bin mapper, ``best_iteration`` and the loop state a resumed run
continues from (``train_state``).  A model file is the reference's npz
format, so a file written by either package loads in the other.
"""

from __future__ import annotations

import io
import json
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
                 max_depth_seen: int, best_iteration: int = -1,
                 train_state: Optional[dict] = None):
        missing = [k for k in ARRAY_KEYS if k not in arrays]
        if missing:
            raise ValueError(f"tree arrays missing: {missing}")
        self.params = params
        self.mapper = mapper
        self.arrays = {k: np.array(arrays[k], _DTYPES[k])  # owned copies
                       for k in ARRAY_KEYS}
        self.init_score = np.asarray(init_score, np.float32).reshape(-1)
        self.max_depth_seen = int(max_depth_seen)
        # predict stops here when it is above 0 and no num_iteration is
        # given (early-stopping semantics)
        self.best_iteration = int(best_iteration)
        # loop state a resumed run needs to continue exactly: best_value,
        # stale and, when evals were deferred, eval_history
        self.train_state = dict(train_state or {})
        self.tree_seconds: list[float] = []

    @property
    def num_total_trees(self) -> int:
        return int(self.arrays["feature"].shape[0])

    @property
    def num_outputs(self) -> int:
        return 1

    @property
    def num_iterations(self) -> int:
        return self.num_total_trees // self.num_outputs

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

    # ---- model files (the reference's npz format, format_version 1) -------
    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.to_bytes())

    def to_bytes(self) -> bytes:
        meta = {"params": self.params.to_dict(),
                "max_depth_seen": self.max_depth_seen,
                "best_iteration": self.best_iteration,
                "train_state": self.train_state,
                "format_version": 1}
        buf = io.BytesIO()
        np.savez_compressed(
            buf, **self.arrays, init_score=self.init_score,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            mapper=np.frombuffer(self.mapper.to_bytes(), dtype=np.uint8))
        return buf.getvalue()

    @classmethod
    def load(cls, path: str) -> "Booster":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    @classmethod
    def from_bytes(cls, data: bytes) -> "Booster":
        """A model file of either package.  Arrays an older reference file
        lacks take the reference's defaults (gain and cover 0,
        default_left True); its optional drift profile is not read."""
        with np.load(io.BytesIO(data)) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            arrays = {k: z[k] for k in ARRAY_KEYS if k in z.files}
            value = arrays["value"]
            arrays.setdefault("gain", np.zeros_like(value))
            arrays.setdefault("cover", np.zeros_like(value))
            arrays.setdefault("default_left", np.ones(value.shape, bool))
            return cls(Params.from_reference_dict(meta["params"]),
                       BinMapper.from_bytes(bytes(z["mapper"])), arrays,
                       z["init_score"], meta["max_depth_seen"],
                       meta.get("best_iteration", -1),
                       meta.get("train_state"))
