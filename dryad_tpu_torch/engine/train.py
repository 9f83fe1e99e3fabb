"""Boosting loop for one output, the counterpart of
``dryad_tpu/engine/train.py::train_device`` (its per-iteration flow):
init score -> grad/hess -> grow -> ``score += value[row_leaf]`` -> store
the tree arrays.  Valid sets, callbacks, checkpoints, chunking and meshes
are later slices."""

from __future__ import annotations

import time

import numpy as np
import torch

from dryad_tpu_torch.booster import CAT_WORDS, Booster
from dryad_tpu_torch.config import Params, effective_depth_params
from dryad_tpu_torch.dataset import Dataset
from dryad_tpu_torch.engine.grower import grow_any
from dryad_tpu_torch.objectives import get_objective

TREE_KEYS = ("feature", "threshold", "left", "right", "value", "gain",
             "default_left", "cover")


def binned_to_device(X_binned: np.ndarray, device) -> torch.Tensor:
    """u8 bins stay uint8; wider bins travel as int32 (torch's uint16
    support is thin)."""
    if X_binned.dtype == np.uint8:
        return torch.from_numpy(np.ascontiguousarray(X_binned)).to(device)
    return torch.from_numpy(X_binned.astype(np.int32)).to(device)


def train_device(params: Params, data: Dataset, *,
                 device: torch.device) -> Booster:
    p = params.validate()
    if data.y is None:
        raise ValueError("training needs labels")
    N, F = data.num_rows, data.num_features
    B = data.mapper.total_bins
    # the max_depth=-1 policy of leaf-wise growth, as the reference applies
    # it; the booster keeps the effective params
    p = effective_depth_params(p, F, B, N)
    obj = get_objective(p)
    T, M = p.num_trees, p.max_nodes
    Xb = binned_to_device(data.X_binned, device)
    y = torch.from_numpy(data.y).to(device)
    init = np.asarray(obj.init_score(data.y), np.float32).reshape(-1)
    score = torch.full((N,), float(init[0]), dtype=torch.float32,
                       device=device)
    bag = torch.ones(N, dtype=torch.bool, device=device)
    fmask = torch.ones(F, dtype=torch.bool, device=device)
    learn_missing = data.has_missing

    out = {
        "feature": torch.full((T, M), -1, dtype=torch.int64, device=device),
        "threshold": torch.zeros((T, M), dtype=torch.int64, device=device),
        "left": torch.zeros((T, M), dtype=torch.int64, device=device),
        "right": torch.zeros((T, M), dtype=torch.int64, device=device),
        "value": torch.zeros((T, M), dtype=torch.float32, device=device),
        "gain": torch.zeros((T, M), dtype=torch.float32, device=device),
        "default_left": torch.ones((T, M), dtype=torch.bool, device=device),
        "cover": torch.zeros((T, M), dtype=torch.float32, device=device),
        "max_depth": torch.zeros(T, dtype=torch.int64, device=device),
    }
    cuda = device.type == "cuda"
    tree_seconds = []
    for t in range(T):
        t0 = time.perf_counter()
        g, h = obj.grad_hess(score, y)
        tree = grow_any(p, B, Xb, g, h, bag, fmask,
                        learn_missing=learn_missing)
        score = score + tree["value"][tree["row_leaf"]]
        for key in TREE_KEYS:
            out[key][t] = tree[key]
        out["max_depth"][t] = tree["max_depth"]
        if cuda:
            # per-tree wall time; a synchronisation, not a fetch
            torch.cuda.synchronize(device)
        tree_seconds.append(time.perf_counter() - t0)

    host = {k: v.cpu().numpy() for k, v in out.items()}
    arrays = {
        "feature": host["feature"].astype(np.int32),
        "threshold": host["threshold"].astype(np.int32),
        "left": host["left"].astype(np.int32),
        "right": host["right"].astype(np.int32),
        "value": host["value"],
        "is_cat": np.zeros((T, M), bool),
        "cat_bitset": np.zeros((T, M, CAT_WORDS), np.uint32),
        "gain": host["gain"],
        "default_left": host["default_left"],
        "cover": host["cover"],
    }
    booster = Booster(p, data.mapper, arrays, init,
                      int(host["max_depth"].max(initial=0)))
    booster.tree_seconds = tree_seconds
    return booster
