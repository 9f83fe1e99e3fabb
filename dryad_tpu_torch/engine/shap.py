"""Exact TreeSHAP contributions (``predict(pred_contrib=True)``), the
counterpart of ``dryad_tpu/cpu/shap.py``.

The reference runs the EXTEND/UNWIND path-weight recursion (Lundberg et
al., "Consistent Individualized Feature Attribution for Tree Ensembles")
once per row and tree in Python.  Which nodes the recursion visits, the
path's features and its zero fractions depend only on the tree; only the
one fractions and the path weights differ by row.  So this module walks
each tree once, depth first, carrying the one fractions and weights as
(N, depth) float64 tensors on the device: one row of the batch per row
of the reference.  Every expression keeps the reference's operation
order (``((o * w) * (j + 1)) / (d + 1)`` is three ops here too), so the
per-row values agree with it to rounding; only the order in which leaves
add into a row's contributions differs (the reference visits the row's
hot child first, this walk the left child), a few ulp at most.

Routing is the traversal's (numeric threshold, learned missing direction,
categorical bitset), decided for every (row, node) at once.  Output (N, K,
F + 1) float64, squeezed to (N, F + 1) for K = 1: column F is the bias,
the init score plus each tree's cover-weighted expectation, and the
contributions plus the bias equal the raw prediction.  An rf model's
per-tree terms are scaled by 1 / n_iter, its init term kept.

The walk issues a few tens of small operations per node (thousands per
255-leaf tree): a launch-bound path on the card, meant for explanation
batches, not bulk scoring.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dryad_tpu_torch.dataset import binned_to_device


def node_decisions(tree: dict, Xb: torch.Tensor,
                   bitset: Optional[torch.Tensor]) -> torch.Tensor:
    """(N, M) bool: row n goes left at node m, by the traversal's rules
    (``tree`` holds (M,) int64 fields on Xb's device)."""
    f = torch.clamp(tree["feature"], min=0)
    bins = Xb[:, f].to(torch.int64)                         # (N, M)
    go_left = bins <= tree["threshold"][None, :]
    go_left &= (tree["default_left"][None, :] != 0) | (bins != 0)
    if bitset is not None:
        M = f.shape[0]
        word = bitset[torch.arange(M, device=Xb.device)[None, :],
                      torch.clamp(bins >> 5, max=bitset.shape[1] - 1)]
        cat_left = ((word >> (bins & 31)) & 1) != 0
        go_left = torch.where(tree["is_cat"][None, :] != 0, cat_left,
                              go_left)
    return go_left


def _extend(path, z: float, o: torch.Tensor, i: int):
    """EXTEND: append feature ``i`` with zero fraction ``z`` and one
    fractions ``o`` (N,); the weights' recurrence over positions j = d-1
    .. 0 becomes one elementwise pass (each new weight reads only old
    ones)."""
    pd, pz, po, pw = path
    d = len(pd)
    po2 = torch.cat([po, o[:, None]], dim=1)
    if d == 0:
        return [i], [z], po2, torch.ones_like(po2)
    j = torch.arange(d, dtype=torch.float64, device=pw.device)
    scaled = z * pw * (d - j) / (d + 1)           # pw2[j] = z pw[j] ...
    grown = o[:, None] * pw * (j + 1) / (d + 1)   # pw2[j+1] += o pw[j] ...
    zero = torch.zeros_like(pw[:, :1])
    pw2 = torch.cat([scaled, zero], dim=1) + torch.cat([zero, grown], dim=1)
    # position 0 takes no addition in the reference: keep scaled[:, 0]
    # exactly (x + 0.0 is x for every finite x but -0.0)
    pw2[:, 0] = scaled[:, 0]
    return pd + [i], pz + [z], po2, pw2


def _unwind(path, i: int):
    """UNWIND: remove path element ``i``; the weights' recurrence runs
    over j = d-1 .. 0 on (N,) columns, per row the reference's branch on
    its one fraction."""
    pd, pz, po, pw = path
    d = len(pd) - 1
    o, z = po[:, i], pz[i]
    hot = o != 0.0
    nxt = pw[:, d]
    w = pw.clone()
    for j in range(d - 1, -1, -1):
        tmp = nxt * (d + 1) / ((j + 1) * o)
        nxt = torch.where(hot, w[:, j] - tmp * z * (d - j) / (d + 1), nxt)
        w[:, j] = torch.where(hot, tmp, w[:, j] * (d + 1) / (z * (d - j)))
    keep = [c for c in range(d + 1) if c != i]
    return (pd[:i] + pd[i + 1:], pz[:i] + pz[i + 1:], po[:, keep],
            w[:, :d])


def _unwound_sums(path) -> torch.Tensor:
    """(N, d): the reference's ``unwound_sum`` of every path element 1..d
    at once (its loop over j reads the element only through o and z)."""
    pd, pz, po, pw = path
    d = len(pd) - 1
    o = po[:, 1:]
    z = torch.tensor(pz[1:], dtype=torch.float64, device=pw.device)
    hot = o != 0.0
    total = torch.zeros_like(o)
    nxt = pw[:, d:d + 1].expand_as(o)
    for j in range(d - 1, -1, -1):
        wj = pw[:, j:j + 1]
        tmp = nxt * (d + 1) / ((j + 1) * o)
        total = total + torch.where(hot, tmp, wj / (z * (d - j) / (d + 1)))
        nxt = wj - tmp * z * (d - j) / (d + 1)
    return total


def tree_shap(tree: dict, cover: np.ndarray, value: np.ndarray,
              go_left: torch.Tensor, phi: torch.Tensor) -> None:
    """Add one tree's exact SHAP values of every row into ``phi`` (N, F +
    1) float64.  ``tree`` holds host int64 (M,) fields, ``cover`` and
    ``value`` the tree's host float arrays."""
    feature, left, right = tree["feature"], tree["left"], tree["right"]
    N = go_left.shape[0]
    dev = phi.device
    ones = torch.ones(N, dtype=torch.float64, device=dev)
    zeros = torch.zeros(N, dtype=torch.float64, device=dev)

    def recurse(node: int, path, z: float, o: torch.Tensor, i: int):
        path = _extend(path, z, o, i)
        pd, pz, po, _ = path
        if feature[node] < 0:                             # leaf
            if len(pd) > 1:
                zt = torch.tensor(pz[1:], dtype=torch.float64, device=dev)
                contrib = _unwound_sums(path) * (po[:, 1:] - zt) * float(
                    value[node])
                phi[:, pd[1:]] += contrib
            return
        f = int(feature[node])
        cn = max(float(cover[node]), 1e-12)
        iz, io = 1.0, ones
        if f in pd[1:]:
            k = pd.index(f, 1)
            iz, io = pz[k], po[:, k]
            path = _unwind(path, k)
        gl = go_left[:, node]
        recurse(int(left[node]), path, iz * float(cover[left[node]]) / cn,
                torch.where(gl, io, zeros), f)
        recurse(int(right[node]), path, iz * float(cover[right[node]]) / cn,
                torch.where(gl, zeros, io), f)

    empty = torch.empty((N, 0), dtype=torch.float64, device=dev)
    recurse(0, ([], [], empty, empty), 1.0, ones, -1)


def expected_value(feature, left, right, value, cover,
                   depth_bound: int) -> float:
    """Cover-weighted expectation of the tree's output at the root (the
    reference's ``_expected_value``, on the host)."""
    ev = value.astype(np.float64).copy()
    for _ in range(depth_bound):
        internal = feature >= 0
        cl = cover[np.maximum(left, 0)]
        cr = cover[np.maximum(right, 0)]
        tot = np.maximum(cl + cr, 1e-12)
        mixed = (cl * ev[np.maximum(left, 0)]
                 + cr * ev[np.maximum(right, 0)]) / tot
        ev = np.where(internal, mixed, ev)
    return float(ev[0])


def predict_contrib(booster, Xb: np.ndarray, *, device: torch.device,
                    num_iteration: Optional[int] = None) -> np.ndarray:
    """Exact SHAP values of pre-binned rows, computed on ``device``:
    (N, K, F + 1) float64, (N, F + 1) for K = 1, the last column the
    bias."""
    K = booster.num_outputs
    F = booster.mapper.num_features
    if num_iteration is None:
        n_iter = (booster.best_iteration if booster.best_iteration > 0
                  else booster.num_iterations)
    else:
        n_iter = min(num_iteration, booster.num_iterations)
    ta = booster.tree_arrays()
    root_covers = ta["cover"][: n_iter * K, 0]
    if root_covers.size and float(root_covers.min()) <= 0:
        raise ValueError(
            "pred_contrib needs per-node covers on every tree; this model "
            "(or the checkpoint it resumed from) was saved by a version "
            "that did not record them; retrain to enable SHAP")
    Xd = binned_to_device(np.asarray(Xb), device)
    N = Xd.shape[0]
    out = torch.zeros((N, K, F + 1), dtype=torch.float64, device=device)
    out[:, :, F] += torch.from_numpy(
        np.asarray(booster.init_score, np.float64)).to(device)[None, :]
    depth_bound = max(booster.max_depth_seen, 1)
    for t in range(n_iter * K):
        k = t % K
        host = {key: ta[key][t].astype(np.int64) for key in
                ("feature", "threshold", "left", "right", "default_left",
                 "is_cat")}
        cover = ta["cover"][t].astype(np.float64)
        value = ta["value"][t]
        ev = expected_value(host["feature"], host["left"], host["right"],
                            value, cover, depth_bound)
        out[:, k, F] += ev
        tree = {key: torch.from_numpy(v).to(device)
                for key, v in host.items()}
        bitset = (torch.from_numpy(ta["cat_bitset"][t].astype(
            np.int64)).to(device) if host["is_cat"].any() else None)
        tree_shap(host, cover, value,
                  node_decisions(tree, Xd, bitset), out[:, k])
    if booster.params.boosting == "rf" and n_iter > 0:
        init = torch.from_numpy(
            np.asarray(booster.init_score, np.float64)).to(device)
        out /= n_iter
        out[:, :, F] += init[None, :] * (1.0 - 1.0 / n_iter)
    res = out.cpu().numpy()
    return res[:, 0] if K == 1 else res
