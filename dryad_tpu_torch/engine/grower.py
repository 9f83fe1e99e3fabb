"""Grower helpers and routing, the counterpart of
``dryad_tpu/engine/grower.py`` for depthwise growth."""

from __future__ import annotations

import torch

from dryad_tpu_torch.engine.ops import drop_set


def grow_any(params, total_bins, Xb, g, h, bag_mask, feat_mask, *,
             learn_missing=False):
    """Route to the grower for the growth policy.  This slice runs
    depthwise growth only (leaf-wise growth is a later slice)."""
    if params.growth == "depthwise" and params.max_depth > 0:
        from dryad_tpu_torch.engine.levelwise import grow_tree_levelwise

        return grow_tree_levelwise(params, total_bins, Xb, g, h, bag_mask,
                                   feat_mask, learn_missing=learn_missing)
    raise NotImplementedError(
        f"growth={params.growth!r} with max_depth={params.max_depth} is "
        "outside this slice of the port (leaf-wise growth is a later slice)")


def root_stats(hist0: torch.Tensor):
    """Leaf totals = feature-0 histogram sums (the reference's contract)."""
    return hist0[0, 0].sum(), hist0[1, 0].sum(), hist0[2, 0].sum()


def finalize_leaf_values(p, M: int, slot_node, slot_G, slot_H,
                         value: torch.Tensor) -> torch.Tensor:
    """Newton leaf values with shrinkage, fp32, scattered to leaf nodes;
    slots without a node (slot_node < 0) go to the dropped index M."""
    raw = -(slot_G / (slot_H + p.lambda_l2))
    vals = raw * p.effective_learning_rate
    idx = torch.where(slot_node >= 0, slot_node, M)
    return drop_set(value, idx, vals)
