"""Batched leaf-wise growth: a depth-capped full expansion, then the exact
best-first selection.

The counterpart of ``dryad_tpu/engine/leafwise_fast.py``.  Split gains do
not depend on the order in which leaves are split (splitting leaf A never
changes leaf B's rows), so leaf-wise growth with a depth cap D factorises:

1. **Expansion.**  Every node with a valid split is split, level by level
   down to depth D, with the depthwise machinery (one histogram pass for
   the smaller children of a level, subtraction for the larger ones).
   Each node's best split, gain and stats go into heap tables (node 1 is
   the root, node n's children are 2n and 2n+1) of ``HN = 2^(D+1)``
   entries.
2. **Selection.**  The sequential grower's slot machine
   (``grower.grow_tree``) is replayed on the precomputed gains: L-1 trips
   of a first-max argmax over the slot gains, the left child keeping the
   parent's slot and the right child taking slot k+1, node ids in
   execution order.  The tree equals the sequential grower's, node ids
   included, whenever both see the same histograms; here every histogram
   of a tree is a fixed-point sum in one shift, so they do.

The expansion runs on one of two arms, as the depthwise grower does:

* wired (``leafwise_layout_supported``): the tree carries the leaf-ordered
  layout from the root.  Runs store heap node ids (sentinel ``HN``, run
  capacity ``NR = 2^D``): a split keeps the parent's run for the left
  child (node 2n) and appends a run for the right one (2n+1).  Each level
  moves the rows (K2) and histograms the smaller children as contiguous
  tile runs (K1, layout mode);
* legacy plan arm: levels with at most 16 columns read every row once in
  natural order with its slot id (K3, when the bin matrix passes the
  natural-order gate); the others sort the selected rows into a tile plan
  read from the per-tree record table (K1, row mode).  Past K1's bins cap
  and under ``hist_backend="xla"``, arm A1 (``histogram.build_hist_a1``)
  takes every pass.

Rows are routed off a packed per-node word (13-bit threshold); past
``levelwise.MAX_PACKED_BINS`` bins they read their node's split from the
heap tables instead (``levelwise.gather_left``), as the reference does.
Heap node ids are not packed, so the leaf budget never forces it.

The reference runs the levels in two ``fori_loop`` phases at a narrow and
a full width (``phase_plan``) and the selection in a ``fori_loop`` whose
``lax.cond`` skips a trip without a finite gain.  Here the levels are a
Python loop with the same per-phase widths, and a skipped trip is a masked
update whose writes go to sentinel rows.  Nothing is fetched to the host.
Each heap node carries its categorical left set (``nd_catmask``) through
the expansion's routing and into the selected tree's bitsets.  Under
monotone constraints each heap node carries its output bounds
(``nd_lo``/``nd_hi``, ``grower.child_bounds``): they bound its split scan
in the expansion and clamp the value of the leaf it becomes in the
selected tree.  A heap node's bounds depend only on its ancestors, so
the selection needs no bounds of its own.

Under a process group (``group``) the expansion reduces every histogram
pass across ranks, with the group's shift and without the half bounds,
as ``levelwise`` does; the feature arm keeps this rank's feature slice of
the level histograms and scans it with the sliced scan and its combine.
The selection reads only the heap tables, which every rank holds alike.
"""

from __future__ import annotations

from typing import Any

import torch

from dryad_tpu_torch.config import MAX_FAST_DEPTH
from dryad_tpu_torch.engine import distributed as _dist
from dryad_tpu_torch.engine import hist_nat, leafperm, tile_plan
from dryad_tpu_torch.engine.grower import (
    _monotone_array,
    child_bounds,
    finalize_leaf_values,
    finish_cat_fields,
    grow_plan,
    root_stats,
)
from dryad_tpu_torch.engine import levelwise
from dryad_tpu_torch.engine.histogram import (
    a1_rows,
    build_hist,
    build_hist_segmented,
)
from dryad_tpu_torch.engine.levelwise import (
    cat_lookup,
    deep_layout_supported,
    gather_left,
    packed_route,
)
from dryad_tpu_torch.engine.ops import drop_set
from dryad_tpu_torch.engine.split import NEG_INF, find_best_split

# the wired expansion's run capacity 2^D: each level's move mandates at
# least 2 * 2^D + 2 tiles, so deeper caps take the legacy arm (the
# reference's policy-table default "leafwise_layout"/"max_segments")
MAX_WIRED_SEGMENTS = 1024


def phase_plan(depth_cap: int):
    """(d_switch, P_narrow, P_full) of the two-phase expansion: levels
    below ``d_switch`` take ``P_narrow`` columns, the rest the widest
    level's ``P_full = 2^(D-1)``.  Not levelwise's plan."""
    P_full = 1 << max(depth_cap - 1, 0)
    P_narrow = min(8, P_full)
    d_switch = 4 if (depth_cap > 4 and P_full > 8) else depth_cap
    return d_switch, P_narrow, P_full


def leafwise_layout_supported(p, num_features: int, total_bins: int,
                              bin_itemsize: int) -> bool:
    """Static gate for the wired expansion: levelwise's gate (record
    width, bins, leaf budget, ``deep_layout="legacy"``), subtraction on,
    and a run capacity 2^D of at most ``MAX_WIRED_SEGMENTS``.  A pure
    function of params and the feature/bin shape, never of the rows."""
    if not deep_layout_supported(p, num_features, total_bins, bin_itemsize):
        return False
    if not p.hist_subtraction:
        return False
    D = p.max_depth
    return 0 < D and (1 << D) <= MAX_WIRED_SEGMENTS


def grow_tree_leafwise_batched(params, total_bins: int, Xb: torch.Tensor,
                               g: torch.Tensor, h: torch.Tensor,
                               bag_mask: torch.Tensor,
                               feat_mask: torch.Tensor, *,
                               learn_missing: bool = False,
                               is_cat_feat=None, bundled_mask=None,
                               group=None) -> dict[str, Any]:
    p = params
    N, F = Xb.shape
    B = int(total_bins)
    L = p.effective_num_leaves
    M = p.max_nodes
    D = p.max_depth
    if not 0 < D <= MAX_FAST_DEPTH:
        raise ValueError(f"the batched leaf-wise grower needs 0 < max_depth "
                         f"<= {MAX_FAST_DEPTH}, got {D}")
    if not p.hist_subtraction:
        raise ValueError("the batched leaf-wise grower derives the larger "
                         "children by subtraction (hist_subtraction=True)")
    HN = 1 << (D + 1)                 # heap slots (1-based; 0 unused)
    Pf = 1 << (D - 1)                 # widest expansion level
    NR = 1 << D                       # run capacity of the wired layout
    dev = Xb.device
    isz = leafperm.bin_itemsize(Xb)
    i64, f32 = torch.int64, torch.float32
    # the arm, the natural-order gate (it reads the largest rank's rows,
    # so every rank agrees) and the level phases
    plan = grow_plan(p, F, B, num_rows=N if group is None
                     else group.global_rows,
                     gate_rows=N if group is None else group.max_rank_rows,
                     bin_itemsize=isz,
                     n_ranks=1 if group is None else group.world,
                     grower="leafwise_fast")
    use_layout = plan.use_layout
    # arm A1's row chunk, None where the kernels take the passes
    a1 = a1_rows(p, B)
    packed = B <= levelwise.MAX_PACKED_BINS
    # one fixed-point shift per tree: every histogram of the tree (root,
    # every level, either arm, any kernel) sums in it
    shift = _dist.global_shift(g, h, group, N)
    mono = _monotone_array(p, F, dev)
    # the cross-rank reductions (None without a group): the root's always
    # fused, the levels' by the policy
    mode = None if group is None else plan.hist_reduce
    red_root = _dist.reducer(group, "fused")
    red = _dist.reducer(group, mode)
    arm = (_dist.FeatureArm(p, group, F, feat_mask=feat_mask,
                            learn_missing=learn_missing,
                            is_cat_feat=is_cat_feat,
                            bundled_mask=bundled_mask, monotone=mono)
           if mode == "feature" else None)

    def best(hist, G, H, C, allow, lo, hi):
        return find_best_split(
            hist, G, H, C, lambda_l2=p.lambda_l2,
            min_child_weight=p.min_child_weight,
            min_data_in_leaf=p.min_data_in_leaf,
            min_split_gain=p.min_split_gain, feat_mask=feat_mask,
            allow=allow, learn_missing=learn_missing,
            is_cat_feat=is_cat_feat, bundled_mask=bundled_mask,
            monotone=mono, lo=lo, hi=hi)

    d_switch, P_narrow, _ = plan.phases
    T = leafperm.TILE_ROWS
    n_row_tiles = -(-N // T)
    # smaller children cover <= half the rows on one device while the f32
    # counts behind the smaller-child choice are exact (< 2^24 rows)
    half_ok = group is None and N < (1 << 24)
    if use_layout:
        # ---- root: the natural-order records are the one-run layout, run
        # 0 holding heap node 1; out-of-bag rows are dropped by level 0's
        # move
        n_buf_tiles = leafperm.wired_tiles_bound(n_row_tiles, NR)
        n_sel = {P: leafperm.wired_sel_tiles_bound(
            n_row_tiles, n_buf_tiles, P, half=half_ok)
            for P in (P_narrow, Pf)}
        rec_nat = leafperm.make_layout_records(Xb, g, h, valid=bag_mask)
        lay_rec, lay_tr, lay_ns = leafperm.natural_root_layout(
            rec_nat, NR, n_buf_tiles, first_slot=1, sentinel=HN)
        del rec_nat
        hist0 = build_hist(Xb, g, h, bag_mask, B, shift, layout=lay_rec,
                           reduce=red_root)
        records = nat_tiles = None
    else:
        records = None
        if a1 is None:
            records = tile_plan.make_records(Xb, g, h)
        nat_tiles = hist_nat.natural_tiles(Xb) if plan.nat_live else None
        hist0 = build_hist(Xb, g, h, bag_mask, B, shift, records=records,
                           reduce=red_root, a1_rows=a1)
    G0, H0, C0 = root_stats(hist0)

    # ---- heap-node tables (index = heap id; unwritten nodes keep these) --
    def table(fill, dtype, at_root):
        t = torch.full((HN,), fill, dtype=dtype, device=dev)
        t[1] = at_root
        return t

    if mono is not None:
        # monotone output bounds, unbounded at the root
        nd_lo = torch.full((HN,), float("-inf"), dtype=f32, device=dev)
        nd_hi = torch.full((HN,), float("inf"), dtype=f32, device=dev)
    root = best(hist0[None], G0[None], H0[None], C0[None],
                (C0 >= 2 * p.min_data_in_leaf)[None],
                *((nd_lo[1:2], nd_hi[1:2]) if mono is not None
                  else (None, None)))

    nd_gain = table(NEG_INF, f32, root["gain"][0])
    nd_feature = table(-1, i64, root["feature"][0])
    nd_thresh = table(0, i64, root["threshold"][0])
    nd_GL = table(0.0, f32, root["g_left"][0])
    nd_HL = table(0.0, f32, root["h_left"][0])
    nd_CL = table(0.0, f32, root["c_left"][0])
    nd_G = table(0.0, f32, G0)
    nd_H = table(0.0, f32, H0)
    nd_C = table(0.0, f32, C0)
    nd_dleft = table(True, torch.bool, root["default_left"][0])
    nd_catmask = torch.zeros((HN,) + root["cat_mask"].shape[1:],
                             dtype=torch.bool, device=dev)
    nd_catmask[1] = root["cat_mask"][0]
    # level-d histograms at offsets 0..2^d-1; one sentinel row (Pf) takes
    # the dropped writes, the final level's children among them
    # the feature arm keeps this rank's feature slice
    hists = torch.zeros((Pf + 1, 3, F if arm is None else arm.width, B),
                        dtype=f32, device=dev)
    hists[0] = hist0 if arm is None else arm.slice_hist(hist0)
    level_best = best if arm is None else arm.best
    # every row is routed (the bag gates histograms only)
    row_node = torch.ones(N, dtype=i64, device=dev)

    for d in range(D):
        P = P_narrow if d < d_switch else Pf
        base = 1 << d                                  # level-d heap base
        jarr = torch.arange(P, dtype=i64, device=dev)
        idx = torch.clamp(base + jarr, max=HN - 1)
        do = (nd_gain[idx] > NEG_INF) & (jarr < base)
        GL, HL, CL = nd_GL[idx], nd_HL[idx], nd_CL[idx]
        GR, HR, CR = nd_G[idx] - GL, nd_H[idx] - HL, nd_C[idx] - CL

        # ---- packed per-node routing table (HN+1,): w0 | feature << 32,
        # a zero row at HN for sentinel runs.  The expansion splits EVERY
        # node with a finite gain at its level, so a row can only sit at
        # such a node while that node is at the current level: the valid
        # bit needs no level check.
        catmask = None if is_cat_feat is None else nd_catmask
        if packed:
            w0_t = (((nd_gain > NEG_INF).to(i64) << 31)
                    | (nd_dleft.to(i64) << 30)
                    | (torch.clamp(nd_thresh, 0, B - 1) << 16))
            if is_cat_feat is not None:
                w0_t |= (is_cat_feat[torch.clamp(nd_feature, min=0)]
                         .to(i64) << 29)
            rec_t = torch.cat([w0_t | (torch.clamp(nd_feature, min=0) << 32),
                               torch.zeros(1, dtype=i64, device=dev)])
            do_n, left_n, _ = packed_route(
                rec_t[row_node],
                lambda rf: Xb.gather(1, rf[:, None])[:, 0].to(i64),
                learn_missing,
                None if catmask is None else cat_lookup(catmask, row_node))
        else:
            # unpacked: the heap tables by node, the row's bin gathered at
            # its node's feature
            do_n = (nd_gain > NEG_INF)[row_node]
            left_n = gather_left(Xb, row_node, nd_feature, nd_thresh,
                                 nd_dleft, learn_missing, is_cat_feat,
                                 catmask)
        row_node = torch.where(do_n, 2 * row_node + (~left_n).to(i64),
                               row_node)

        ls = CL <= CR
        if use_layout:
            hist_small, lay_rec, lay_tr, lay_ns = _wired_level(
                lay_rec, lay_tr, lay_ns, rec_t, idx, do, ls, P, HN, NR, B, F,
                isz, n_sel[P], n_buf_tiles, learn_missing, shift, catmask,
                red)
        else:
            hist_small = _legacy_level(
                Xb, g, h, bag_mask, records, nat_tiles, row_node, idx, jarr,
                do, ls, CL, CR, P, HN, B, half_ok, shift, red, a1)
        hist_large = torch.index_select(
            hists, 0, torch.clamp(jarr, max=Pf - 1)) - hist_small
        ls4 = ls[:, None, None, None]
        hist_l = torch.where(ls4, hist_small, hist_large)
        hist_r = torch.where(ls4, hist_large, hist_small)
        del hist_small, hist_large
        # children land at level-(d+1) offsets 2j / 2j+1; past the buffer
        # (the final level's children, never split) they are dropped
        hists[torch.clamp(torch.where(do, 2 * jarr, Pf), max=Pf)] = hist_l
        hists[torch.clamp(torch.where(do, 2 * jarr + 1, Pf), max=Pf)] = hist_r

        # ---- children's stats and best splits, batched -------------------
        ch_lo = ch_hi = None
        if mono is not None:
            lo_l, hi_l, lo_r, hi_r = child_bounds(
                mono, nd_feature[idx], GL, HL, GR, HR, p.lambda_l2,
                nd_lo[idx], nd_hi[idx])
            ch_lo, ch_hi = torch.cat([lo_l, lo_r]), torch.cat([hi_l, hi_r])
        ch_do = torch.cat([do, do])
        ch_G = torch.cat([GL, GR])
        ch_H = torch.cat([HL, HR])
        ch_C = torch.cat([CL, CR])
        allow = ch_do & (d + 1 < D) & (ch_C >= 2 * p.min_data_in_leaf)
        res = level_best(torch.cat([hist_l, hist_r]), ch_G, ch_H, ch_C,
                         allow, ch_lo, ch_hi)
        del hist_l, hist_r
        cidx = torch.where(ch_do, torch.cat([2 * idx, 2 * idx + 1]), HN)
        if mono is not None:
            nd_lo = drop_set(nd_lo, cidx, ch_lo)
            nd_hi = drop_set(nd_hi, cidx, ch_hi)
        nd_gain = drop_set(nd_gain, cidx, res["gain"])
        nd_feature = drop_set(nd_feature, cidx, res["feature"])
        nd_thresh = drop_set(nd_thresh, cidx, res["threshold"])
        nd_GL = drop_set(nd_GL, cidx, res["g_left"])
        nd_HL = drop_set(nd_HL, cidx, res["h_left"])
        nd_CL = drop_set(nd_CL, cidx, res["c_left"])
        nd_G = drop_set(nd_G, cidx, ch_G)
        nd_H = drop_set(nd_H, cidx, ch_H)
        nd_C = drop_set(nd_C, cidx, ch_C)
        nd_dleft = drop_set(nd_dleft, cidx, res["default_left"])
        nd_catmask = drop_set(nd_catmask, cidx, res["cat_mask"])
    del hists

    tree, slot_heap, slot_tree, child_tree = select_tree(
        L, M, HN, nd_gain, nd_feature, nd_thresh, nd_dleft, nd_C)
    # a split node's left set is its heap node's
    finish_cat_fields(tree, is_cat_feat, nd_catmask[tree.pop("heap")])
    sh = torch.clamp(slot_heap, 0, HN - 1)
    tree["value"] = finalize_leaf_values(
        p, M, slot_tree, nd_G[sh], nd_H[sh],
        torch.zeros(M, dtype=f32, device=dev),
        *((nd_lo[sh], nd_hi[sh]) if mono is not None else ()))
    # every heap node's leaf in the selected tree: walking down, a node is
    # its own tree node where its parent was selected (it then has a tree
    # id, >= 1), else it inherits its parent's leaf
    leaf_of = torch.zeros(HN, dtype=i64, device=dev)
    heap = torch.arange(HN, dtype=i64, device=dev)
    for lv in range(1, D + 1):
        leaf_of = torch.where((heap >> lv) == 1,
                              torch.where(child_tree > 0, child_tree,
                                          leaf_of[heap >> 1]),
                              leaf_of)
    tree["row_leaf"] = leaf_of[torch.clamp(row_node, 0, HN - 1)]
    return tree


def _wired_level(lay_rec, lay_tr, lay_ns, rec_t, idx, do, ls, P, HN, NR, B,
                 F, isz, n_sel_tiles, n_buf_tiles, learn_missing, shift,
                 catmask=None, reduce=None):
    """One wired expansion level: sides off the layout records, one move
    (K2), the run bookkeeping under heap node ids, the smaller children as
    contiguous runs of the new layout (K1, layout mode).  ``catmask`` (HN,
    B) holds the heap nodes' categorical left sets, when any feature is
    categorical; ``reduce`` is the cross-rank hook.  Returns (hist_small,
    lay_rec, lay_tr, lay_ns)."""
    T = leafperm.TILE_ROWS
    dev = lay_rec.device
    i64 = torch.int64
    # every row of a tile shares the tile's run, so the routing word is
    # gathered per tile and broadcast over its rows; sentinel runs read the
    # zero row HN and stay put (they hold no valid rows anyway)
    lns = torch.clamp(lay_ns, max=HN)
    rr_lay = rec_t[lns][lay_tr][:, None]
    rec3 = lay_rec.view(n_buf_tiles, T, leafperm.REC_WB)
    valid_lay = rec3[:, :, 8] == 1
    cat_of = (None if catmask is None else cat_lookup(
        catmask, torch.clamp(lay_ns, max=HN - 1)[lay_tr][:, None]))
    do_lay, left_lay, _ = packed_route(
        rr_lay, lambda rf: leafperm.tile_bins(rec3, rf, isz), learn_missing,
        cat_of)
    side = torch.where(valid_lay, (do_lay & ~left_lay).to(i64),
                       2).reshape(-1)
    del rr_lay, rec3, valid_lay, do_lay, left_lay
    pos, dstl, dstr, base_l, base_r, _ = leafperm.level_moves(
        lay_tr, side, NR)
    del side
    lay_rec = leafperm.permute_records(lay_rec, pos, dstl, dstr, n_buf_tiles)
    del pos, dstl, dstr
    # node -> run inverse before advancing; sentinel runs scatter to HN + 1,
    # past the (HN+1,) table, so they are dropped
    node_run = drop_set(
        torch.full((HN + 1,), NR, dtype=i64, device=dev),
        torch.where(lay_ns < HN, lay_ns, HN + 1),
        torch.arange(NR, dtype=i64, device=dev))
    # a run splits iff its node has a finite gain (it is at this level);
    # the left child keeps the run as node 2n, the right appends node 2n+1
    run_do = (((rec_t >> 31) & 1) != 0)[lns] & (lay_ns < HN)
    lay_tr, lay_ns = leafperm.advance_runs(
        torch.where(run_do, 2 * lay_ns, lay_ns), run_do, 2 * lay_ns + 1,
        base_l, base_r, n_buf_tiles, sentinel=HN)

    rj = node_run[idx]
    rjc = torch.clamp(rj, max=NR - 1)
    lt_l = base_l[1:] - base_l[:-1]
    lt_r = base_r[1:] - base_r[:-1]
    sel_ok = do & (rj < NR)
    seg_first = torch.where(
        sel_ok, torch.where(ls, base_l[rjc], base_r[rjc]), 0)
    seg_nt = torch.where(sel_ok, torch.where(ls, lt_l[rjc], lt_r[rjc]), 0)
    hist_small = leafperm.hist_from_layout(
        lay_rec, seg_first, seg_nt, P, B, F, isz, n_sel_tiles, shift,
        reduce=reduce)
    return hist_small, lay_rec, lay_tr, lay_ns


def _legacy_level(Xb, g, h, bag_mask, records, nat_tiles, row_node, idx,
                  jarr, do, ls, CL, CR, P, HN, B, half_ok, shift,
                  reduce=None, a1=None):
    """One legacy expansion level: the smaller children's rows are picked
    off the routed natural-order ``row_node`` and histogrammed by K3 when
    it is live and holds P columns, else through a sorted tile plan (K1,
    row mode), or by arm A1 in chunks of ``a1`` rows when given (no
    natural tiles then).  Out-of-bag rows are routed but never summed."""
    N, F = Xb.shape
    small_heap = 2 * idx + (~ls).to(torch.int64)
    colof = drop_set(
        torch.full((HN,), P, dtype=torch.int64, device=Xb.device),
        torch.where(do, small_heap, HN), jarr)
    smallsel = torch.where(bag_mask, colof[row_node], P)
    if nat_tiles is not None and P <= hist_nat.NAT_SLOTS:
        return hist_nat.build_hist_small(nat_tiles, g, h, smallsel, P, B, F,
                                         shift, reduce=reduce)
    # exact per-column counts (the smaller child's C off the parent
    # histogram, integer-exact in f32 below 2^24 rows) admit the aligned
    # plan where it applies
    small_cnt = (torch.where(do, torch.where(ls, CL, CR), 0.0)
                 .to(torch.int64) if half_ok else None)
    return build_hist_segmented(
        Xb, g, h, smallsel, P, B, shift, records=records,
        rows_bound=(N // 2 + 1) if half_ok else None, sel_counts=small_cnt,
        reduce=reduce, a1_rows=a1)


def select_tree(L: int, M: int, HN: int, nd_gain, nd_feature, nd_thresh,
                nd_dleft, nd_C):
    """Replay the sequential slot machine on the heap gains: L-1 trips of
    a first-max argmax over the slot gains; the left child keeps the slot,
    the right child takes slot k+1, node ids go in execution order.

    A trip records only what the order decides: the slots' heap and tree
    ids, each split node's heap id and left child id, and each selected
    child's tree id.  The node arrays follow from the heap tables after the
    loop (a split node's gain, feature, threshold and default direction
    are its heap node's; its right child is left + 1; a child's cover is
    its heap node's count).  A trip without a finite gain writes only to
    the sentinel rows (slot L, node M, heap HN), so the loop needs no host
    decision; every index is a 1-element tensor (a 0-d index would be read
    back to the host).  Returns (tree arrays, slot_heap, slot_tree,
    child_tree), child_tree (HN,) holding each selected heap node's tree
    id and 0 elsewhere."""
    dev = nd_gain.device
    i64 = torch.int64
    ar2 = torch.arange(2, dtype=i64, device=dev)
    right_slot = torch.arange(1, L, dtype=i64, device=dev)    # k + 1
    # per heap node: its children's heap ids and gains
    kid_heap = torch.clamp(2 * torch.arange(HN, dtype=i64, device=dev)[:, None]
                           + ar2, max=HN - 1)
    kid_gain = nd_gain[kid_heap]
    # slots: [heap id, tree node], the tree node -1 while unused
    slot_int = torch.zeros((L + 1, 2), dtype=i64, device=dev)
    slot_int[:, 1] = -1
    slot_int[0, 0] = 1
    slot_int[0, 1] = 0
    slot_gain = torch.full((L + 1,), NEG_INF, dtype=torch.float32,
                           device=dev)
    slot_gain[0] = nd_gain[1]
    node_split = torch.zeros((M + 1, 2), dtype=i64, device=dev)  # heap, left
    child_tree = torch.zeros(HN + 1, dtype=i64, device=dev)
    num_nodes = torch.ones(1, dtype=i64, device=dev)

    for k in range(L - 1):
        g_s, s = slot_gain[:L].max(0, keepdim=True)   # first max, as argmax
        ok = g_s > NEG_INF
        n, parent = slot_int[s].unbind(1)
        kids = kid_heap[n][0]
        ids = num_nodes + ar2
        si = torch.where(ok, torch.cat([s, right_slot[k:k + 1]]), L)
        slot_int[si] = torch.stack([kids, ids], 1)
        slot_gain[si] = kid_gain[n][0]
        node_split[torch.where(ok, parent, M)] = torch.cat([n, ids[:1]])
        child_tree[torch.where(ok, kids, HN)] = ids
        num_nodes = torch.add(num_nodes, ok, alpha=2)

    heap, left = node_split[:M].unbind(1)
    split = left > 0
    child_tree = child_tree[:HN]
    picked = child_tree > 0
    depth = torch.frexp(torch.arange(HN, device=dev).to(torch.float32))[1] - 1
    cover = torch.zeros(M + 1, dtype=torch.float32, device=dev)
    cover[0] = nd_C[1]
    tree = {
        "feature": torch.where(split, nd_feature[heap], -1),
        "threshold": torch.where(split, nd_thresh[heap], 0),
        "left": left,
        "right": torch.where(split, left + 1, 0),
        "default_left": torch.where(split, nd_dleft[heap], True),
        "gain": torch.where(split, nd_gain[heap], 0.0),
        "cover": drop_set(cover, torch.where(picked, child_tree, M),
                          nd_C)[:M],
        "max_depth": torch.where(picked, depth.to(i64), 0).max(),
        # each split node's heap id (0 elsewhere), for the caller's
        # per-heap-node tables
        "heap": heap,
    }
    return tree, slot_int[:L, 0], slot_int[:L, 1], child_tree
