"""Trained model of the port.

Holds the same tree arrays as ``dryad_tpu.Booster.tree_arrays()``, shaped
(num_iterations * K, max_nodes) for K outputs (the tree in slot
``it * K + k`` adds to score column k), plus ``init_score`` (K,),
``max_depth_seen``, the frozen bin mapper (plain, or bundled for EFB),
``best_iteration`` and the loop state a resumed run continues from
(``train_state``).  Model files are the reference's formats, the npz
(``save``/``load``) and the versioned JSON text (``dump_text``,
``from_text``; ``load_any`` reads either), so a file written by either
package loads in the other.  Beside predict the booster gives leaf ids
(``pred_leaf``), TreeSHAP contributions (``pred_contrib``,
``engine/shap.py``), ``refit`` on new rows (``engine/refit.py``),
``feature_importance`` and ``dump_model``.
"""

from __future__ import annotations

import io
import json
from typing import Optional

import numpy as np

from dryad_tpu_torch.config import Params
from dryad_tpu_torch.data.bundling import mapper_from_json_dict
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
        # a process-group run's collective plan per iteration
        # (``engine/train.comm_stats``), else None
        self.comm_stats: Optional[dict] = None

    @property
    def num_total_trees(self) -> int:
        return int(self.arrays["feature"].shape[0])

    @property
    def num_outputs(self) -> int:
        return self.params.num_outputs

    @property
    def num_iterations(self) -> int:
        return self.num_total_trees // self.num_outputs

    def tree_arrays(self) -> dict[str, np.ndarray]:
        return dict(self.arrays)

    def to_reference_arrays(self) -> dict[str, np.ndarray]:
        """Copies of the tree arrays with the reference's keys and dtypes,
        for comparison with ``dryad_tpu.Booster.tree_arrays()``."""
        return {k: v.copy() for k, v in self.arrays.items()}

    @property
    def has_categorical_splits(self) -> bool:
        """True when any tree holds a categorical split."""
        return bool(self.arrays["is_cat"].any())

    # ---- predict -----------------------------------------------------------
    def predict(self, X: np.ndarray, *, raw_score: bool = False,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, device=None,
                sharded: bool = False, devices=None) -> np.ndarray:
        """Predict raw features: bin through the frozen mapper, then
        ``predict_binned``."""
        return self.predict_binned(
            self.mapper.transform(np.asarray(X, np.float32)),
            raw_score=raw_score, num_iteration=num_iteration,
            pred_leaf=pred_leaf, pred_contrib=pred_contrib, device=device,
            sharded=sharded, devices=devices)

    def predict_binned(self, X_binned: np.ndarray, *,
                       raw_score: bool = False,
                       num_iteration: Optional[int] = None,
                       pred_leaf: bool = False, pred_contrib: bool = False,
                       device=None, sharded: bool = False,
                       devices=None) -> np.ndarray:
        """Pre-binned rows on ``device`` (default: the card) -> the
        objective's transform of the scores, or raw scores; with
        ``pred_contrib`` the (N, [K,] F + 1) float64 SHAP values (last
        column the bias), which take precedence over ``pred_leaf``'s (N, T)
        int32 leaf node ids of the first T = n_iter * K trees.
        ``sharded=True`` splits the rows over ``devices`` (default: every
        visible card; ``engine.predict.predict_binned_sharded``), bitwise
        the single-device scores; it takes neither ``pred_leaf`` nor
        ``pred_contrib``."""
        from dryad_tpu_torch import resolve_device
        from dryad_tpu_torch.engine import predict as engine_predict

        if sharded:
            if pred_leaf or pred_contrib:
                raise ValueError("sharded=True is not supported with "
                                 "pred_leaf/pred_contrib")
            raw = engine_predict.predict_binned_sharded(
                self, X_binned, num_iteration=num_iteration,
                devices=devices)
            return self.transform_raw(raw, raw_score=raw_score)
        dev = resolve_device(device)
        if pred_contrib:
            from dryad_tpu_torch.engine.shap import predict_contrib

            return predict_contrib(self, X_binned, device=dev,
                                   num_iteration=num_iteration)
        if pred_leaf:
            return engine_predict.predict_leaves(
                self, X_binned, device=dev, num_iteration=num_iteration)
        raw = engine_predict.predict_binned(self, X_binned, device=dev,
                                            num_iteration=num_iteration)
        return self.transform_raw(raw, raw_score=raw_score)

    def transform_raw(self, raw: np.ndarray, *,
                      raw_score: bool = False) -> np.ndarray:
        """(N, K) raw scores -> the objective's transform (or raw), the
        single-output column squeezed.  Per row, so a slice of a batch
        transforms bitwise as the whole."""
        from dryad_tpu_torch.objectives import get_objective

        out = raw if raw_score else get_objective(self.params).transform_np(
            raw)
        return out if self.num_outputs > 1 else out[:, 0]

    def refit(self, X: np.ndarray, y: np.ndarray, *,
              weight: Optional[np.ndarray] = None, decay_rate: float = 0.9,
              device=None) -> "Booster":
        """Keep every tree's structure and re-derive its leaf values from
        new rows on ``device`` (default: the card), the reference's
        ``Booster.refit``: each leaf becomes ``decay_rate * old + (1 -
        decay_rate) * new`` (``engine/refit.py``).  Returns a new booster
        with no best iteration and no loop state."""
        from dryad_tpu_torch import resolve_device
        from dryad_tpu_torch.engine.refit import refit_values

        value = refit_values(self, X, y, weight=weight,
                             decay_rate=decay_rate,
                             device=resolve_device(device))
        return Booster(self.params, self.mapper, dict(self.arrays,
                                                      value=value),
                       self.init_score, self.max_depth_seen)

    # ---- introspection -----------------------------------------------------
    def feature_importance(self, importance_type: str = "split") -> np.ndarray:
        """Per feature: ``split``, the times it splits a node (int64);
        ``gain``, the split gain it accumulates (float64)."""
        F = self.mapper.num_features
        internal = self.arrays["feature"] >= 0
        used = self.arrays["feature"][internal]
        if importance_type == "split":
            return np.bincount(used, minlength=F).astype(np.int64)
        if importance_type == "gain":
            return np.bincount(
                used, weights=self.arrays["gain"][internal].astype(
                    np.float64), minlength=F)
        raise ValueError("importance_type must be 'split' or 'gain'")

    def dump_model(self) -> dict:
        """The reference's structured dump (JSON-serialisable), one dict
        per tree."""
        a = self.arrays
        trees = []
        for t in range(self.num_total_trees):
            nodes = []
            n_nodes = int((a["feature"][t] >= 0).sum()) * 2 + 1
            for n in range(n_nodes):
                f = int(a["feature"][t, n])
                if f >= 0:
                    nodes.append({
                        "node": n,
                        "split_feature": f,
                        "threshold_bin": int(a["threshold"][t, n]),
                        "is_categorical": bool(a["is_cat"][t, n]),
                        "default_left": bool(a["default_left"][t, n]),
                        "gain": float(a["gain"][t, n]),
                        "left": int(a["left"][t, n]),
                        "right": int(a["right"][t, n]),
                    })
                else:
                    nodes.append({"node": n, "value": float(a["value"][t, n])})
            trees.append({"tree_index": t, "class": t % self.num_outputs,
                          "nodes": nodes})
        return {
            "num_iterations": self.num_iterations,
            "num_class": self.num_outputs,
            "init_score": [float(v) for v in self.init_score],
            "params": self.params.to_dict(),
            "trees": trees,
        }

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

    # ---- the versioned text model (the reference's format) -----------------
    TEXT_FORMAT_VERSION = 1

    def dump_text(self) -> str:
        """The reference's JSON text model: params, the frozen mapper and
        every tree's node arrays.  Floats are the exact f64 widening of the
        stored f32 (JSON round-trips them exactly); bitsets are sparse,
        ``{node: [CAT_WORDS words]}`` for nodes with a set bit.  The loop
        state is not written; the reference's optional drift profile is
        neither written nor read."""
        a = self.arrays
        trees = []
        for t in range(self.num_total_trees):
            cat_rows = {str(int(n)): [int(w) for w in a["cat_bitset"][t, n]]
                        for n in np.flatnonzero(a["cat_bitset"][t].any(
                            axis=1))}
            trees.append({
                "feature": [int(v) for v in a["feature"][t]],
                "threshold": [int(v) for v in a["threshold"][t]],
                "left": [int(v) for v in a["left"][t]],
                "right": [int(v) for v in a["right"][t]],
                "value": [float(v) for v in a["value"][t]],
                "is_cat": [int(v) for v in a["is_cat"][t]],
                "default_left": [int(v) for v in a["default_left"][t]],
                "gain": [float(v) for v in a["gain"][t]],
                "cover": [float(v) for v in a["cover"][t]],
                "cat_bitset": cat_rows,
            })
        doc = {
            "format": "dryad-text",
            "format_version": self.TEXT_FORMAT_VERSION,
            "params": self.params.to_dict(),
            "init_score": [float(v) for v in self.init_score],
            "max_depth_seen": self.max_depth_seen,
            "best_iteration": self.best_iteration,
            "cat_words": int(a["cat_bitset"].shape[2]),
            "max_nodes": int(a["feature"].shape[1]),
            "mapper": self.mapper.to_json_dict(),
            "trees": trees,
        }
        return json.dumps(doc, indent=1)

    def save_text(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dump_text())

    @classmethod
    def from_text(cls, text: str) -> "Booster":
        """A text model written by either package."""
        doc = json.loads(text)
        if doc.get("format") != "dryad-text":
            raise ValueError("not a dryad text model dump")
        if doc["format_version"] > cls.TEXT_FORMAT_VERSION:
            raise ValueError(
                f"text format version {doc['format_version']} is newer than "
                f"this library supports ({cls.TEXT_FORMAT_VERSION})")
        trees = doc["trees"]
        T, M = len(trees), int(doc["max_nodes"])
        arrays = {k: np.empty((T, M), _DTYPES[k]) for k in ARRAY_KEYS
                  if k != "cat_bitset"}
        arrays["cat_bitset"] = np.zeros((T, M, int(doc["cat_words"])),
                                        np.uint32)
        for t, tr in enumerate(trees):
            for k in ARRAY_KEYS:
                if k != "cat_bitset":
                    arrays[k][t] = np.asarray(tr[k], _DTYPES[k])
            for n_str, words in tr["cat_bitset"].items():
                arrays["cat_bitset"][t, int(n_str)] = np.asarray(words,
                                                                 np.uint32)
        return cls(Params.from_reference_dict(doc["params"]),
                   mapper_from_json_dict(doc["mapper"]), arrays,
                   np.asarray(doc["init_score"], np.float32),
                   int(doc["max_depth_seen"]),
                   int(doc.get("best_iteration", -1)))

    @classmethod
    def load_text(cls, path: str) -> "Booster":
        with open(path) as f:
            return cls.from_text(f.read())

    @classmethod
    def load_any(cls, path: str) -> "Booster":
        """Either model format, sniffed: the npz is a zip (magic ``PK``),
        anything else is read as the text model."""
        with open(path, "rb") as f:
            magic = f.read(2)
        return cls.load(path) if magic == b"PK" else cls.load_text(path)

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
