"""Predict: level-synchronous tree traversal over packed node words.

The counterpart of ``dryad_tpu/engine/predict.py``'s packed arm.
Traversal compares integer bin ids, and the leaf values are added in fp32
in iteration order, so the raw scores are bitwise those of the reference
given the same model, on any device.

Packed node-word layout (per node, two limbs):

* limb0: left (bits 0..15) | right (bits 16..31)
* limb1: threshold (0..15) | feature (16..27) | default_left (28)
  | is_cat (29) | internal (30)

The reference stores the limbs as uint32.  Torch's uint32 shifts and
compares are thin, so the port keeps the same field layout in int64.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

PACKED_CHILD_BITS = 16
PACKED_THRESHOLD_BITS = 16
PACKED_FEATURE_BITS = 12


def packed_fallback_reason(feature, threshold, left, right):
    """The first traversal field that overflows its packed width, named,
    or None when everything fits (checked against the actual values)."""
    feature = np.asarray(feature)
    internal = feature >= 0
    if not internal.any():
        return None
    named = (("feature", feature, PACKED_FEATURE_BITS),
             ("threshold", np.asarray(threshold), PACKED_THRESHOLD_BITS),
             ("left", np.asarray(left), PACKED_CHILD_BITS),
             ("right", np.asarray(right), PACKED_CHILD_BITS))
    for name, arr, bits in named:
        lo, hi = int(arr[internal].min()), int(arr[internal].max())
        if lo < 0 or hi >= (1 << bits):
            return (f"{name} range {lo}..{hi} exceeds its "
                    f"{bits}-bit packed width")
    return None


def pack_words(feature: torch.Tensor, threshold: torch.Tensor,
               left: torch.Tensor, right: torch.Tensor,
               default_left: torch.Tensor,
               is_cat: torch.Tensor | None = None) -> torch.Tensor:
    """Per-node traversal fields (..., M) -> (..., M, 2) int64 limbs on
    their device, unchecked (the caller holds every field within its
    width).  Leaf fields are zeroed so the packing depends only on
    traversal content."""
    feature = feature.to(torch.int64)
    internal = feature >= 0
    zero = torch.zeros((), dtype=torch.int64, device=feature.device)

    def field(x):
        return torch.where(internal, x.to(torch.int64), zero)

    flag = internal.to(torch.int64)
    dl = (default_left.to(torch.bool) & internal).to(torch.int64)
    ic = (zero if is_cat is None
          else (is_cat.to(torch.bool) & internal).to(torch.int64))
    limb0 = field(left) | (field(right) << PACKED_CHILD_BITS)
    limb1 = (field(threshold) | (field(feature) << 16) | (dl << 28)
             | (ic << 29) | (flag << 30))
    return torch.stack([limb0, limb1], dim=-1)


def pack_node_words(feature, threshold, left, right, default_left,
                    is_cat) -> np.ndarray:
    """``pack_words`` of numpy fields, each checked against its packed
    width."""
    feature = np.asarray(feature, np.int64)
    internal = feature >= 0
    fields = {"feature": feature, "threshold": np.asarray(threshold),
              "left": np.asarray(left), "right": np.asarray(right)}
    widths = {"feature": PACKED_FEATURE_BITS,
              "threshold": PACKED_THRESHOLD_BITS,
              "left": PACKED_CHILD_BITS, "right": PACKED_CHILD_BITS}
    for name, arr in fields.items():
        arr = np.where(internal, arr, 0)
        if arr.size and (int(arr.min()) < 0
                         or int(arr.max()) >= (1 << widths[name])):
            raise ValueError(
                f"packed predict layout: field {name!r} does not fit "
                f"{widths[name]} bits (max value {int(arr.max())}); the "
                "legacy layout is a later slice of the port")
    t = {k: torch.from_numpy(np.asarray(v, np.int64))
         for k, v in fields.items()}
    return pack_words(t["feature"], t["threshold"], t["left"], t["right"],
                      torch.from_numpy(np.asarray(default_left, bool)),
                      torch.from_numpy(np.asarray(is_cat, bool))).numpy()


def unpack_node_words(words: np.ndarray) -> dict:
    """Inverse of ``pack_node_words`` (leaf fields come back zeroed)."""
    words = np.asarray(words, np.int64)
    limb0, limb1 = words[..., 0], words[..., 1]
    internal = ((limb1 >> 30) & 1) > 0
    return {
        "left": (limb0 & 0xFFFF).astype(np.int32),
        "right": (limb0 >> PACKED_CHILD_BITS).astype(np.int32),
        "threshold": (limb1 & 0xFFFF).astype(np.int32),
        "feature": np.where(internal, (limb1 >> 16) & 0xFFF,
                            -1).astype(np.int32),
        "default_left": ((limb1 >> 28) & 1) > 0,
        "is_cat": ((limb1 >> 29) & 1) > 0,
    }


def stage_trees(booster, num_iteration: Optional[int] = None):
    """(words (n_iter, M, 2) int64, value (n_iter, M) f32, init (1,) f32,
    n_iter) for the traversal.  Without ``num_iteration`` a booster with
    a best iteration (early stopping) stops there.  Categorical splits and
    models whose fields do not fit the packed words are later slices."""
    if num_iteration is None:
        num_iteration = (booster.best_iteration
                         if booster.best_iteration > 0
                         else booster.num_iterations)
    n_iter = min(num_iteration, booster.num_iterations)
    ta = booster.tree_arrays()
    if ta["is_cat"][:n_iter].any():
        raise NotImplementedError(
            "categorical splits are outside this slice of the port")
    reason = packed_fallback_reason(ta["feature"][:n_iter],
                                    ta["threshold"][:n_iter],
                                    ta["left"][:n_iter], ta["right"][:n_iter])
    if reason is not None:
        raise NotImplementedError(
            f"packed node words do not fit ({reason}); the legacy "
            "traversal layout is a later slice of the port")
    words = pack_node_words(ta["feature"][:n_iter], ta["threshold"][:n_iter],
                            ta["left"][:n_iter], ta["right"][:n_iter],
                            ta["default_left"][:n_iter],
                            ta["is_cat"][:n_iter])
    return (words, np.ascontiguousarray(ta["value"][:n_iter], np.float32),
            np.asarray(booster.init_score, np.float32), n_iter)


def tree_leaves(words: torch.Tensor, Xb: torch.Tensor,
                depth_bound: int) -> torch.Tensor:
    """Leaf node id every row reaches in one tree (words (M, 2) int64)."""
    node = torch.zeros(Xb.shape[0], dtype=torch.int64, device=Xb.device)
    for _ in range(max(int(depth_bound), 1)):
        w = words[node]                               # one gather per level
        w0, w1 = w[:, 0], w[:, 1]
        internal = ((w1 >> 30) & 1) != 0
        fc = (w1 >> 16) & 0xFFF
        bins = Xb.gather(1, fc[:, None])[:, 0].to(torch.int64)
        go_left = bins <= (w1 & 0xFFFF)
        go_left &= (((w1 >> 28) & 1) != 0) | (bins != 0)
        nxt = torch.where(go_left, w0 & 0xFFFF, w0 >> 16)
        node = torch.where(internal, nxt, node)
    return node


def add_tree(words: torch.Tensor, value: torch.Tensor, Xb: torch.Tensor,
             score: torch.Tensor, depth_bound: int) -> torch.Tensor:
    """``score + value[leaf]`` of one tree (words (M, 2), value (M,)) over
    rows ``Xb``: the fp32 add the boosting loop makes to a valid set's
    scores when the tree is grown (the counterpart of the reference's
    ``_apply_valid_jit``)."""
    return score + value[tree_leaves(words, Xb, depth_bound)]


def accumulate(words: torch.Tensor, value: torch.Tensor, Xb: torch.Tensor,
               init: torch.Tensor, depth_bound: int) -> torch.Tensor:
    """Raw scores (N, 1): init plus each tree's leaf value, added in fp32
    in iteration order (the reference's summation order, and the
    boosting loop's, so a resumed run rebuilds its scores bitwise)."""
    score = init.to(torch.float32).expand(Xb.shape[0]).clone()
    for t in range(words.shape[0]):
        score = add_tree(words[t], value[t], Xb, score, depth_bound)
    return score[:, None]


def predict_binned(booster, Xb: np.ndarray, *, device: torch.device,
                   num_iteration: Optional[int] = None) -> np.ndarray:
    """Raw scores (N, 1) float32 of pre-binned rows, computed on
    ``device``."""
    from dryad_tpu_torch.engine.train import binned_to_device

    words, value, init, _ = stage_trees(booster, num_iteration)
    raw = accumulate(torch.from_numpy(words).to(device),
                     torch.from_numpy(value).to(device),
                     binned_to_device(np.asarray(Xb), device),
                     torch.from_numpy(init).to(device),
                     max(booster.max_depth_seen, 1))
    return raw.cpu().numpy()
