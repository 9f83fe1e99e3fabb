"""Refit: keep every tree's structure, re-derive its leaf values from new
rows, the counterpart of ``dryad_tpu/booster.py::Booster.refit``.

Rows are binned through the model's own mapper, and the trees are walked
in training order with the scores accumulated as in training: tree t adds
to column t % K, and a K-class model takes the g/h of all K classes from
the running score at class 0 of each iteration (rf: once, at the constant
init score).  Each leaf reached by a row becomes ``decay * old + (1 -
decay) * new``, every operation an f32 rounding of its own:

* Newton: ``new = f32(-(G / (H + lambda_l2))) * lr``, G and H the leaf's
  sums of the new rows' g and h; a leaf with ``H + lambda_l2 == 0`` keeps
  its value;
* the L1 family (``objectives.renew_alpha``): ``new`` is the type-1
  quantile of the leaf's residuals ``y - score`` times lr, through
  ``train.renew_values`` with every row in the bag.

A leaf that no row reaches keeps its value.  G and H are int64 fixed-point
sums in the tree's one power-of-two shift (``hist.fixed_point_shift``,
``quantize``): exact in any order of the row additions, so no atomic order
decides a bit, and rounded once to f32.  The reference sums in f64 on the
host from numpy's gradients; the port's g/h follow ``grad_hess_jax``'s op
order, so values agree within a tolerance, not bitwise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dryad_tpu_torch.dataset import binned_to_device
from dryad_tpu_torch.engine.hist import fixed_point_shift, pow2, quantize
from dryad_tpu_torch.engine.predict import (
    stage_trees,
    table_slot,
    table_to,
    tree_leaves,
)
from dryad_tpu_torch.engine.train import class_grads, renew_values
from dryad_tpu_torch.objectives import get_objective, renew_alpha


def leaf_sums(leaves: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
              M: int) -> tuple:
    """(G, H) f32 (M,) per-node sums of g and h over the rows' leaves:
    int64 fixed-point sums in one shift, each rounded once to f32, and the
    (M,) int64 row counts."""
    shift = fixed_point_shift(g, h)
    sums = torch.zeros((3, M), dtype=torch.int64, device=g.device)
    sums[0].index_add_(0, leaves, quantize(g, shift[0]))
    sums[1].index_add_(0, leaves, quantize(h, shift[1]))
    sums[2].index_add_(0, leaves, torch.ones_like(leaves))
    G = sums[0].to(torch.float32) * pow2(-shift[0])
    H = sums[1].to(torch.float32) * pow2(-shift[1])
    return G, H, sums[2]


def refit_values(booster, X: np.ndarray, y: np.ndarray, *,
                 weight: Optional[np.ndarray] = None,
                 decay_rate: float = 0.9,
                 device: torch.device) -> np.ndarray:
    """The refitted (T, M) f32 value table of every tree of ``booster``
    on rows ``X`` (raw features) with labels ``y``, computed on
    ``device``."""
    p = booster.params
    if p.boosting == "dart":
        raise ValueError("refit is unsupported for DART models: the "
                         "value table mixes drop-rescale generations")
    if p.objective == "lambdarank":
        raise ValueError("refit is unsupported for lambdarank models: "
                         "per-query lambda gradients need query "
                         "groups, which refit does not take")
    if not (0.0 <= decay_rate <= 1.0):
        raise ValueError("decay_rate must be in [0, 1]")
    K = booster.num_outputs
    T = booster.num_total_trees
    M = booster.arrays["feature"].shape[1]
    Xb = binned_to_device(
        booster.mapper.transform(np.asarray(X, np.float32)), device)
    yt = torch.from_numpy(np.ascontiguousarray(y, np.float32)).to(device)
    w = (None if weight is None else torch.from_numpy(
        np.ascontiguousarray(weight, np.float32)).to(device))
    obj = get_objective(p)
    table, _, bitset, init, _ = stage_trees(booster, booster.num_iterations)
    table = table_to(table, device)
    bitset = None if bitset is None else torch.from_numpy(bitset).to(device)
    value = torch.from_numpy(booster.arrays["value"].copy()).to(device)
    feature = torch.from_numpy(booster.arrays["feature"]).to(device)

    def f32(x) -> torch.Tensor:
        return torch.tensor(np.float32(x), device=device)

    lam, lr = f32(p.lambda_l2), f32(p.effective_learning_rate)
    decay, keep = f32(decay_rate), f32(np.float32(1.0) - np.float32(
        decay_rate))
    renew_a = renew_alpha(p, weighted=weight is not None)
    all_rows = torch.ones(Xb.shape[0], dtype=torch.bool, device=device)
    init_t = torch.from_numpy(init).to(device)
    score = init_t.reshape(1, K).expand(Xb.shape[0], K).clone()
    rf_gh = (class_grads(obj, score, yt, w) if p.boosting == "rf"
             else None)
    depth = max(booster.max_depth_seen, 1)
    gh = None
    for t in range(T):
        k = t % K
        if k == 0:
            gh = rf_gh if rf_gh is not None else class_grads(obj, score, yt,
                                                            w)
        leaves = tree_leaves(table_slot(table, t), Xb, depth,
                             None if bitset is None else bitset[t])
        old = value[t]
        if renew_a is not None:
            cnt = torch.bincount(leaves, minlength=M)
            new = renew_values(old, feature[t], leaves, yt, score[:, k],
                               all_rows, renew_a,
                               p.effective_learning_rate, M)
            upd = cnt > 0
        else:
            G, H, cnt = leaf_sums(leaves, *gh[k], M)
            HL = H + lam
            new = -(G / HL) * lr
            upd = (cnt > 0) & (HL != 0)
        value[t] = torch.where(upd, decay * old + keep * new, old)
        score[:, k] = score[:, k] + value[t][leaves]
    return value.cpu().numpy()
