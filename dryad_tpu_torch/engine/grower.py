"""The grower routing and the sequential grower, the counterpart of
``dryad_tpu/engine/grower.py``.

``grow_any`` picks the grower for the growth policy: depthwise growth with
a depth cap goes level by level (``levelwise``), leaf-wise growth with a
finite cap inside the expansion envelope goes to the batched grower
(``leafwise_fast``), and everything else (unbounded depth, leaf-wise
without histogram subtraction, envelopes the batched grower refuses) to
the sequential grower ``grow_tree``.

``grow_tree`` is the reference's slot machine: ``row_slot`` (N,) holds each
row's leaf slot; L slots hold a node id, stats, depth, cached best split
and histogram; L-1 trips each split the best slot (leaf-wise: the best
gain; depthwise: the best gain of the shallowest level), the left child
keeping the slot and the right child taking slot k+1.  The smaller child's
histogram is one masked pass over every row (K1, row mode, or arm A1
past K1's bins cap and under ``hist_backend="xla"``, in the tree's
fixed-point shift) and the larger one is the parent's minus it.  Under a
process group each pass is all-reduced across ranks ("fused" whatever
``hist_reduce`` says, as in the reference: only the level-synchronous
growers run the feature arm).  Under
monotone constraints each slot carries output bounds (``child_bounds``)
that its children inherit and its leaf value is clamped to.  A trip
without a finite gain is a masked update whose writes go to sentinel rows
(slot L, node M), so nothing is fetched to the host.
"""

from __future__ import annotations

import warnings
from typing import Any, NamedTuple, Optional

import torch

from dryad_tpu_torch.booster import CAT_WORDS
from dryad_tpu_torch.config import (
    MAX_FAST_DEPTH,
    hist_reduce_resolved,
    leafwise_fast_supported,
)
from dryad_tpu_torch.engine import hist_nat, tile_plan
from dryad_tpu_torch.engine.distributed import global_shift, reducer
from dryad_tpu_torch.engine.histogram import a1_rows, build_hist
from dryad_tpu_torch.engine.ops import drop_set
from dryad_tpu_torch.engine.split import NEG_INF, find_best_split


class GrowPlan(NamedTuple):
    """What ``grow_plan`` decides for one class's tree."""

    grower: str              # "levelwise", "leafwise_fast" or "sequential"
    use_layout: bool         # the wired arm (leaf-ordered layout, K2)
    nat_live: bool           # K3's natural-order pass on the shallow levels
    phases: tuple            # (d_switch, P_narrow, P_full); () sequential
    scan_widths: tuple       # candidate columns of each level's scan
    pass_widths: tuple       # columns of each histogram pass past the root
    hist_reduce: str         # the passes' cross-rank arm under a group


def grow_plan(p, num_features: int, total_bins: int, *, num_rows: int,
              gate_rows: Optional[int] = None, bin_itemsize: int = 1,
              n_ranks: int = 1, grower: Optional[str] = None) -> GrowPlan:
    """The grower a config takes and the histogram passes it makes, the
    one place the routing lives: ``grow_any`` routes by it, the growers
    take their arm, natural-order gate, level phases and cross-rank arm
    from it, and ``train.comm_stats`` counts its passes.  ``num_rows`` is
    the group's row count (the batched leaf-wise envelope), ``gate_rows``
    its largest rank's (the natural-order gate; default ``num_rows``),
    ``n_ranks`` the group's size; ``grower`` names a grower already
    chosen.  Without subtraction a level makes both children's passes:
    one 2P-column pass on the wired arm, a P-column pass of each side on
    the legacy arm; the sequential grower one pass a split (two without
    subtraction), always fused, as in the reference."""
    from dryad_tpu_torch.engine import leafwise_fast, levelwise

    F, B = int(num_features), int(total_bins)
    L = p.effective_num_leaves
    if grower is None:
        if p.growth == "depthwise" and p.max_depth > 0:
            grower = "levelwise"
        elif (p.growth == "leafwise"
              and leafwise_fast_supported(p, F, B, num_rows)):
            grower = "leafwise_fast"
        else:
            grower = "sequential"
    if grower == "sequential":
        per_split = 1 if p.hist_subtraction else 2
        return GrowPlan(grower, False, False, (), (),
                        (1,) * ((L - 1) * per_split), "fused")
    if grower == "levelwise":
        use_layout = levelwise.deep_layout_supported(p, F, B, bin_itemsize)
    else:
        use_layout = leafwise_fast.leafwise_layout_supported(
            p, F, B, bin_itemsize)
    nat_live = (not use_layout and a1_rows(p, B) is None
                and hist_nat.natural_admits(
                    B, num_rows if gate_rows is None else gate_rows, F,
                    bin_itemsize))
    D = p.max_depth
    phases = (levelwise.phase_plan(D, L, nat_live) if grower == "levelwise"
              else leafwise_fast.phase_plan(D))
    d_switch, P_narrow, P_full = phases
    scan = (P_narrow,) * d_switch + (P_full,) * (D - d_switch)
    if p.hist_subtraction:
        passes = scan
    elif use_layout:
        passes = tuple(2 * w for w in scan)
    else:
        passes = tuple(w for w in scan for _ in (0, 1))
    return GrowPlan(grower, use_layout, nat_live, phases, scan, passes,
                    hist_reduce_resolved(p, F, B, n_ranks))


def grow_any(params, total_bins, Xb, g, h, bag_mask, feat_mask, *,
             learn_missing=False, is_cat_feat=None, bundled_mask=None,
             group=None):
    """Route to the grower for the growth policy (module doc).
    ``is_cat_feat`` (F,) bool is given when any feature is categorical
    (the reference's static ``has_cat``); ``bundled_mask`` (F,) bool marks
    EFB bundle columns when the missing-right plane is scanned; ``group``
    (``engine/distributed.RowGroup``) grows one tree over the rows of all
    its ranks.  The grower is chosen from the global row count, so every
    rank takes the same one."""
    p = params
    kw = {"learn_missing": learn_missing, "is_cat_feat": is_cat_feat,
          "bundled_mask": bundled_mask, "group": group}
    grower = grow_plan(
        p, Xb.shape[1], total_bins,
        num_rows=Xb.shape[0] if group is None else group.global_rows).grower
    if grower == "levelwise":
        from dryad_tpu_torch.engine.levelwise import grow_tree_levelwise

        return grow_tree_levelwise(p, total_bins, Xb, g, h, bag_mask,
                                   feat_mask, **kw)
    if grower == "leafwise_fast":
        from dryad_tpu_torch.engine import leafwise_fast

        return leafwise_fast.grow_tree_leafwise_batched(
            p, total_bins, Xb, g, h, bag_mask, feat_mask, **kw)
    if p.growth == "leafwise":
        if p.max_depth > 0 and p.hist_subtraction:
            # a visible, specific reason; hist_subtraction=False is a
            # deliberate choice and does not warn
            reason = (f"max_depth above the batched grower's cap "
                      f"({MAX_FAST_DEPTH})" if p.max_depth > MAX_FAST_DEPTH
                      else "peak-memory envelope "
                           "(config.leafwise_fast_supported)")
            warnings.warn(
                f"batched leaf-wise grower unavailable: {reason} — "
                "falling back to the sequential grower", stacklevel=2)
    return grow_tree(p, total_bins, Xb, g, h, bag_mask, feat_mask, **kw)


def root_stats(hist0: torch.Tensor):
    """Leaf totals = feature-0 histogram sums (the reference's contract)."""
    return hist0[0, 0].sum(), hist0[1, 0].sum(), hist0[2, 0].sum()


def pack_cat_bitset(cat_mask_nodes: torch.Tensor) -> torch.Tensor:
    """(M, B) bool membership masks -> (M, CAT_WORDS) node bitsets, bin b
    at word ``b >> 5``, bit ``b & 31`` (the reference's layout).  The
    uint32 words are held in int64, bit 31 included."""
    M, B = cat_mask_nodes.shape
    width = CAT_WORDS * 32
    catm = torch.nn.functional.pad(cat_mask_nodes, (0, max(width - B, 0)))
    bits = catm[:, :width].reshape(M, CAT_WORDS, 32).to(torch.int64)
    return (bits << torch.arange(32, device=bits.device)).sum(2)


def finish_cat_fields(tree: dict, is_cat_feat, cat_nodes) -> dict:
    """Give a grown tree its categorical fields: a categorical split node
    stores threshold 0, default_left True, ``is_cat`` and the bitset of
    its left set (its row of ``cat_nodes`` (M, B) bool); every other node
    an empty bitset."""
    feature = tree["feature"]
    M = feature.shape[0]
    if is_cat_feat is None:
        tree["is_cat"] = torch.zeros(M, dtype=torch.bool,
                                     device=feature.device)
        tree["cat_bitset"] = torch.zeros((M, CAT_WORDS), dtype=torch.int64,
                                         device=feature.device)
        return tree
    cat = is_cat_feat[torch.clamp(feature, min=0)] & (feature >= 0)
    tree["is_cat"] = cat
    tree["threshold"] = torch.where(cat, 0, tree["threshold"])
    tree["default_left"] = tree["default_left"] | cat
    tree["cat_bitset"] = pack_cat_bitset(cat_nodes & cat[:, None])
    return tree


def _monotone_array(p, F: int, device):
    """(F,) int32 constraints, padded or cut to F, or None when nothing is
    constrained (the growers then run the unconstrained program)."""
    if not any(p.monotone_constraints):
        return None
    mono = [0] * F
    for i, m in enumerate(p.monotone_constraints[:F]):
        mono[i] = int(m)
    return torch.tensor(mono, dtype=torch.int32, device=device)


def child_bounds(mono, sf, GL, HL, GR, HR, lam, lo_p, hi_p):
    """Output bounds (lo_l, hi_l, lo_r, hi_r) of a split's two children
    (LightGBM's "basic" mode): across a +1 or -1 split feature the
    midpoint of the clamped child outputs separates the subtrees; a 0
    feature passes the parent's bounds on.  f32, elementwise over
    candidates."""
    wl = torch.clamp(-(GL / (HL + lam)), lo_p, hi_p)
    wr = torch.clamp(-(GR / (HR + lam)), lo_p, hi_p)
    mid = 0.5 * (wl + wr)
    m = mono[torch.clamp(sf, min=0)]
    return (torch.where(m < 0, mid, lo_p), torch.where(m > 0, mid, hi_p),
            torch.where(m > 0, mid, lo_p), torch.where(m < 0, mid, hi_p))


def finalize_leaf_values(p, M: int, slot_node, slot_G, slot_H,
                         value: torch.Tensor, slot_lo=None,
                         slot_hi=None) -> torch.Tensor:
    """Newton leaf values with shrinkage, fp32, scattered to leaf nodes;
    slots without a node (slot_node < 0) go to the dropped index M.
    Monotone bounds ``slot_lo``/``slot_hi`` clamp the raw value before
    shrinkage."""
    raw = -(slot_G / (slot_H + p.lambda_l2))
    if slot_lo is not None:
        raw = torch.clamp(raw, slot_lo, slot_hi)
    vals = raw * p.effective_learning_rate
    idx = torch.where(slot_node >= 0, slot_node, M)
    return drop_set(value, idx, vals)


def grow_tree(params, total_bins: int, Xb: torch.Tensor, g: torch.Tensor,
              h: torch.Tensor, bag_mask: torch.Tensor,
              feat_mask: torch.Tensor, *, learn_missing: bool = False,
              is_cat_feat=None, bundled_mask=None,
              group=None) -> dict[str, Any]:
    """Grow one tree with the sequential slot machine (module doc)."""
    p = params
    N, F = Xb.shape
    B = int(total_bins)
    L = p.effective_num_leaves
    M = p.max_nodes
    depth_cap = p.max_depth if p.max_depth > 0 else L
    dev = Xb.device
    i64, f32 = torch.int64, torch.float32
    # one record table and one fixed-point shift per tree: every masked
    # pass reads the table (K1, row mode), or the bins as they are (arm
    # A1, in chunks of ``a1`` rows), and sums in the shift
    a1 = a1_rows(p, B)
    records = tile_plan.make_records(Xb, g, h) if a1 is None else None
    shift = global_shift(g, h, group, N)
    red = reducer(group, "fused")
    mono = _monotone_array(p, F, dev)

    def hist_of(mask):
        # the bag gates histograms only; every row is routed, so the final
        # row_slot gives each row's leaf
        return build_hist(Xb, g, h, mask & bag_mask, B, shift,
                          records=records, reduce=red, a1_rows=a1)[None]

    def best(hist, G, H, C, depth, lo, hi):
        allow = (depth < depth_cap) & (C >= 2 * p.min_data_in_leaf)
        return find_best_split(
            hist, G, H, C, lambda_l2=p.lambda_l2,
            min_child_weight=p.min_child_weight,
            min_data_in_leaf=p.min_data_in_leaf,
            min_split_gain=p.min_split_gain, feat_mask=feat_mask,
            allow=allow, learn_missing=learn_missing,
            is_cat_feat=is_cat_feat, bundled_mask=bundled_mask,
            monotone=mono, lo=lo, hi=hi)

    row_slot = torch.zeros(N, dtype=i64, device=dev)
    hist0 = hist_of(torch.ones(N, dtype=torch.bool, device=dev))
    G0, H0, C0 = root_stats(hist0[0])
    G0, H0, C0 = G0[None], H0[None], C0[None]
    if mono is not None:
        # per-slot monotone output bounds, unbounded at the root
        slot_lo = torch.full((L + 1,), float("-inf"), dtype=f32, device=dev)
        slot_hi = torch.full((L + 1,), float("inf"), dtype=f32, device=dev)
    root = best(hist0, G0, H0, C0, torch.zeros(1, dtype=i64, device=dev),
                *((slot_lo[:1], slot_hi[:1]) if mono is not None
                  else (None, None)))

    # slot tables with one sentinel row (L) for the no-op writes
    def slots(fill, dtype, at0):
        t = torch.full((L + 1,), fill, dtype=dtype, device=dev)
        t[0] = at0[0]
        return t

    slot_node = torch.full((L + 1,), -1, dtype=i64, device=dev)
    slot_node[0] = 0
    slot_gain = slots(NEG_INF, f32, root["gain"])
    slot_G = slots(0.0, f32, G0)
    slot_H = slots(0.0, f32, H0)
    slot_C = slots(0.0, f32, C0)
    slot_depth = torch.zeros(L + 1, dtype=i64, device=dev)
    sp = {"feature": slots(-1, i64, root["feature"]),
          "threshold": slots(0, i64, root["threshold"]),
          "g_left": slots(0.0, f32, root["g_left"]),
          "h_left": slots(0.0, f32, root["h_left"]),
          "c_left": slots(0.0, f32, root["c_left"]),
          "default_left": slots(True, torch.bool, root["default_left"]),
          "cat_mask": torch.zeros((L + 1,) + root["cat_mask"].shape[1:],
                                  dtype=torch.bool, device=dev)}
    sp["cat_mask"][0] = root["cat_mask"][0]
    hists = torch.zeros((L + 1, 3, F, B), dtype=f32, device=dev)
    hists[0] = hist0[0]

    # node tables with one sentinel row (M)
    feature = torch.full((M + 1,), -1, dtype=i64, device=dev)
    threshold = torch.zeros(M + 1, dtype=i64, device=dev)
    left = torch.zeros(M + 1, dtype=i64, device=dev)
    right = torch.zeros(M + 1, dtype=i64, device=dev)
    gain = torch.zeros(M + 1, dtype=f32, device=dev)
    cover = torch.zeros(M + 1, dtype=f32, device=dev)
    cover[0] = C0[0]
    node_dleft = torch.ones(M + 1, dtype=torch.bool, device=dev)
    cat_nodes = torch.zeros((M + 1,) + root["cat_mask"].shape[1:],
                            dtype=torch.bool, device=dev)
    num_nodes = torch.ones(1, dtype=i64, device=dev)
    max_depth = torch.zeros(1, dtype=i64, device=dev)
    ar2 = torch.arange(2, dtype=i64, device=dev)
    right_slot = torch.arange(1, L, dtype=i64, device=dev)    # k + 1
    big_depth = torch.iinfo(i64).max

    for k in range(L - 1):
        # pick: leaf-wise the best gain; depthwise the best gain of the
        # shallowest level.  Every index is a 1-element tensor (a 0-d
        # index would be read back to the host).
        s_gain, s_depth = slot_gain[:L], slot_depth[:L]
        if p.growth == "depthwise":
            finite = s_gain > NEG_INF
            dmin = torch.where(finite, s_depth, big_depth).min()
            s_gain = torch.where(finite & (s_depth == dmin), s_gain, NEG_INF)
        s = torch.argmax(s_gain, 0, keepdim=True)
        g_s = slot_gain[s]
        ok = g_s > NEG_INF
        sf, thr = sp["feature"][s], sp["threshold"][s]
        dl = sp["default_left"][s]

        # row partition: the left child keeps slot s, the right takes k+1
        bins_f = Xb.index_select(1, torch.clamp(sf, min=0))[:, 0].to(i64)
        go_left = bins_f <= thr
        if learn_missing:
            go_left &= dl | (bins_f > 0)
        if is_cat_feat is not None:
            # a categorical split sends its set of bins left
            catm = sp["cat_mask"][s][0]
            go_left = torch.where(is_cat_feat[torch.clamp(sf, min=0)],
                                  catm[torch.clamp(bins_f, max=B - 1)],
                                  go_left)
        new_r = right_slot[k:k + 1]
        row_slot = torch.where(ok & (row_slot == s) & ~go_left, new_r,
                               row_slot)

        GL, HL, CL = sp["g_left"][s], sp["h_left"][s], sp["c_left"][s]
        GR, HR, CR = slot_G[s] - GL, slot_H[s] - HL, slot_C[s] - CL
        ids = num_nodes + ar2                          # left, right node ids
        pi = torch.where(ok, slot_node[s], M)
        feature[pi] = sf
        threshold[pi] = thr
        gain[pi] = g_s
        left[pi] = ids[:1]
        right[pi] = ids[1:]
        node_dleft[pi] = dl
        cat_nodes[pi] = sp["cat_mask"][s]
        cover[torch.where(ok, ids, M)] = torch.cat([CL, CR])

        # the smaller child's histogram directly, the larger by subtraction
        if p.hist_subtraction:
            ls = (CL <= CR)[:, None, None, None]
            shist = hist_of(row_slot == torch.where(CL <= CR, s, new_r))
            ohist = hists[s] - shist
            hist_l = torch.where(ls, shist, ohist)
            hist_r = torch.where(ls, ohist, shist)
        else:
            hist_l = hist_of(row_slot == s)
            hist_r = hist_of(row_slot == new_r)
        si = torch.where(ok, torch.cat([s, new_r]), L)
        hists[si] = torch.cat([hist_l, hist_r])

        depth_c = slot_depth[s] + 1
        ch_G, ch_H, ch_C = (torch.cat([GL, GR]), torch.cat([HL, HR]),
                            torch.cat([CL, CR]))
        ch_lo = ch_hi = None
        if mono is not None:
            lo_l, hi_l, lo_r, hi_r = child_bounds(
                mono, sf, GL, HL, GR, HR, p.lambda_l2, slot_lo[s],
                slot_hi[s])
            ch_lo, ch_hi = torch.cat([lo_l, lo_r]), torch.cat([hi_l, hi_r])
            slot_lo[si] = ch_lo
            slot_hi[si] = ch_hi
        res = best(torch.cat([hist_l, hist_r]), ch_G, ch_H, ch_C,
                   depth_c.expand(2), ch_lo, ch_hi)
        slot_node[si] = ids
        slot_gain[si] = res["gain"]
        slot_G[si] = ch_G
        slot_H[si] = ch_H
        slot_C[si] = ch_C
        slot_depth[si] = depth_c.expand(2)
        for key in sp:
            sp[key][si] = res[key]
        num_nodes = num_nodes + 2 * ok.to(i64)
        max_depth = torch.where(ok, torch.maximum(max_depth, depth_c),
                                max_depth)

    value = finalize_leaf_values(
        p, M, slot_node[:L], slot_G[:L], slot_H[:L],
        torch.zeros(M, dtype=f32, device=dev),
        *((slot_lo[:L], slot_hi[:L]) if mono is not None else ()))
    return finish_cat_fields({
        "feature": feature[:M],
        "threshold": threshold[:M],
        "left": left[:M],
        "right": right[:M],
        "value": value,
        "gain": gain[:M],
        "default_left": node_dleft[:M],
        "cover": cover[:M],
        "max_depth": max_depth[0],
        # each row's leaf node straight from the partition state
        "row_leaf": torch.clamp(slot_node[:L], min=0)[
            torch.clamp(row_slot, max=L - 1)],
    }, is_cat_feat, cat_nodes[:M])
