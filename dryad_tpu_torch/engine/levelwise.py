"""Level-wise (depthwise) tree grower: the wired arm and the legacy plan arm.

The counterpart of ``dryad_tpu/engine/levelwise.py::grow_tree_levelwise``.
Every level picks its candidates, routes every row of the natural order off
a packed per-slot table (each row's final leaf comes from this routing),
histograms the smaller children and gets the larger ones by subtraction
from the parent.  The two arms differ in how the smaller children are read:

* wired (``deep_layout_supported``): the tree carries a leaf-ordered
  layout of 128-byte records from the root; each level moves the rows to
  their child segments (K2) and histograms the children as contiguous
  tile runs (K1, layout mode);
* legacy plan arm (``deep_layout="legacy"``, leaf budgets above 512,
  records above 128 B): levels with at most 16 candidates read every row
  once in natural order with its slot id (K3, when the bin matrix passes
  ``hist_nat.nat_gate_admits``); the other levels sort the selected rows
  into a tile plan and read them from a per-tree record table of any
  width (K1, row mode).  Past K1's bins cap (1024), and for every pass
  under ``hist_backend="xla"``, arm A1 (``histogram.build_hist_a1``, plain
  torch) takes the root and every level instead.

Each level routes the rows off a packed per-slot word (``packed_route``:
a 13-bit threshold and a 16-bit slot).  Past those widths (bins above
``MAX_PACKED_BINS`` or leaf budgets of ``MAX_PACKED_LEAVES`` and more) the
rows read their slot's split from per-slot tables instead
(``gather_left``), the reference's gather formulation; the choice is
static for a config.

Under monotone constraints each slot carries its output bounds
(``grower.child_bounds``), which bound its split scan and clamp its leaf
value.

Semantics are the reference's: within a level, splits apply in
best-gain-first order (stable, lowest slot first) until the ``num_leaves``
budget runs out; the left child keeps the parent's slot, right children
take consecutive slot ids in execution order.

The reference runs the levels in two ``fori_loop`` phases at a narrow and
a full candidate width (``phase_plan``); here the levels are a Python loop
with the same per-phase widths, which fix each phase's static histogram
plan size.  Nothing is fetched to the host inside the loop: every
data-dependent size is a static bound, as in the reference.

Under a process group (``group``, ``engine/distributed.py``) the shift is
the group's, every histogram pass is reduced across ranks, and the
smaller child is picked from global counts, so on one rank it can hold
more than half the local rows: the half bounds are off, as in the
reference.  On the feature arm the level state holds this rank's feature
slice of the histograms, and each level's scan is the sliced scan and
its combine; the root stays on the fused all-reduce and the full scan.
"""

from __future__ import annotations

from typing import Any

import torch

from dryad_tpu_torch.engine import distributed as _dist
from dryad_tpu_torch.engine import hist as _hist
from dryad_tpu_torch.engine import hist_nat, leafperm
from dryad_tpu_torch.engine.grower import (
    _monotone_array,
    child_bounds,
    finalize_leaf_values,
    finish_cat_fields,
    grow_plan,
    root_stats,
)
from dryad_tpu_torch.engine.histogram import (
    a1_rows,
    build_hist,
    build_hist_multi,
    build_hist_segmented,
)
from dryad_tpu_torch.engine.ops import drop_set
from dryad_tpu_torch.engine.split import NEG_INF, find_best_split
from dryad_tpu_torch.policy.table import GATE_DEFAULTS

# the wired layout's caps: bins <= 1024 (K1, hist.MAX_BINS) and records
# <= 128 B (the record, leafperm.REC_WB) are structural; the leaf budget
# and the record cap are the code defaults of the policy gate
# "deep_layout", which ``deep_layout_supported`` resolves (a table can
# narrow the record cap, never widen it past the record).  The packed
# routing word's fields (13-bit threshold, 16-bit slot) bound both arms.
MAX_LAYOUT_LEAVES = GATE_DEFAULTS["deep_layout"]["max_leaves"]
MAX_RECORD_BYTES = leafperm.REC_WB
MAX_PACKED_BINS = 1 << 13
MAX_PACKED_LEAVES = 1 << 16


def deep_layout_supported(p, num_features: int, total_bins: int,
                          bin_itemsize: int) -> bool:
    """Static gate for the wired grower: a pure function of params and the
    feature/bin shape, never of the row count.  Its verdicts are the
    reference's on its Pallas arm; what it refuses, the legacy plan arm
    takes.  The structural exclusions are checked here: arm A1
    (``hist_backend="xla"``; the layout feeds the kernels), bins past
    K1's cap or the packed word, records past 128 B; the leaf and record
    caps then resolve through the policy gate "deep_layout"."""
    from dryad_tpu_torch.policy.gates import resolve

    if (p.deep_layout == "legacy" or p.hist_backend == "xla"
            or not _hist.supports(total_bins)):
        return False
    L = p.effective_num_leaves
    record_bytes = 9 + num_features * bin_itemsize
    if not (total_bins <= MAX_PACKED_BINS and L < MAX_PACKED_LEAVES
            and record_bytes <= MAX_RECORD_BYTES):
        return False
    return resolve("deep_layout", {"num_leaves": L,
                                   "record_bytes": record_bytes}) == "layout"


def phase_plan(depth_cap: int, num_leaves: int, nat_live: bool):
    """(d_switch, P_narrow, P_full) for the two-phase level loop, as the
    reference defines it.  ``nat_live``: the natural-order pass (K3) is on,
    which only the legacy arm runs; the wired arm passes False."""
    P_full = min(1 << (depth_cap - 1), num_leaves - 1)
    d_cut = 5 if nat_live else 4
    d_switch = d_cut if (depth_cap > d_cut and P_full > (1 << (d_cut - 1))) \
        else depth_cap
    P_narrow = min(1 << (d_switch - 1), num_leaves - 1)
    return d_switch, P_narrow, P_full


def packed_route(rr: torch.Tensor, bins_of, learn_missing: bool,
                 cat_of=None):
    """Per-row split routing off packed per-slot words: (splits?,
    goes-left?, w0).  ``rr`` int64 holds the reference's routing word w0 in
    its low 32 bits and the split feature above them.  w0 holds the split
    flag (bit 31), default-left (30), categorical (29), the threshold
    (16..28) and a slot (0..15).  ``cat_of(bins)`` gives each row's
    membership in its node's left set, read where bit 29 is set.

    The reference packs w0 in a uint32 with bit 31 set, beside the feature
    in a second uint32 column; torch's uint32 shifts and compares are thin,
    so the port keeps w0's field layout in the low half of one int64 (one
    8-byte gather per row instead of a 16-byte row gather)."""
    w0r = rr & 0xFFFFFFFF
    bins_rf = bins_of(rr >> 32)
    thr_r = (w0r >> 16) & 0x1FFF
    gl = bins_rf <= thr_r
    if learn_missing:
        gl &= (((w0r >> 30) & 1) != 0) | (bins_rf > 0)
    if cat_of is not None:
        gl = torch.where(((w0r >> 29) & 1) != 0, cat_of(bins_rf), gl)
    return (w0r >> 31) != 0, gl, w0r


def cat_lookup(catmask: torch.Tensor, node: torch.Tensor):
    """``cat_of`` for ``packed_route``: rows at ``node`` (any shape that
    broadcasts against their bins) read ``catmask[node, min(bin, B-1)]``
    of the (n, B) membership table, one flat gather."""
    B = catmask.shape[1]
    flat = catmask.reshape(-1)
    return lambda bins: flat[node * B + torch.clamp(bins, max=B - 1)]


def gather_left(Xb: torch.Tensor, node: torch.Tensor, feature, threshold,
                dleft, learn_missing: bool, is_cat_feat=None, catmask=None):
    """The unpacked routing, for shapes past the packed word: each row
    reads its node's split (``feature``, ``threshold``, ``dleft`` and, with
    categorical features, ``catmask``, all indexed by ``node`` (N,)) and
    its own bin at that feature.  Returns goes-left?, the reference's
    gather formulation."""
    rf = torch.clamp(feature[node], min=0)
    bins = Xb.gather(1, rf[:, None])[:, 0].to(torch.int64)
    gl = bins <= threshold[node]
    if learn_missing:
        gl &= dleft[node] | (bins > 0)
    if is_cat_feat is not None:
        gl = torch.where(is_cat_feat[rf], cat_lookup(catmask, node)(bins),
                         gl)
    return gl


def grow_tree_levelwise(params, total_bins: int, Xb: torch.Tensor,
                        g: torch.Tensor, h: torch.Tensor,
                        bag_mask: torch.Tensor, feat_mask: torch.Tensor, *,
                        learn_missing: bool = False, is_cat_feat=None,
                        bundled_mask=None, group=None) -> dict[str, Any]:
    p = params
    N, F = Xb.shape
    B = int(total_bins)
    L = p.effective_num_leaves
    M = p.max_nodes
    depth_cap = p.max_depth
    dev = Xb.device
    isz = leafperm.bin_itemsize(Xb)
    if depth_cap <= 0:
        raise ValueError("levelwise growth requires max_depth > 0")
    # the arm, the natural-order gate (it reads the largest rank's rows,
    # so every rank agrees) and the level phases
    plan = grow_plan(p, F, B, num_rows=N if group is None
                     else group.global_rows,
                     gate_rows=N if group is None else group.max_rank_rows,
                     bin_itemsize=isz,
                     n_ranks=1 if group is None else group.world,
                     grower="levelwise")
    use_layout = plan.use_layout
    # arm A1's row chunk, None where the kernels take the passes
    a1 = a1_rows(p, B)
    packed = B <= MAX_PACKED_BINS and L < MAX_PACKED_LEAVES
    i64, f32 = torch.int64, torch.float32
    # one fixed-point shift per tree, kept on the device: every histogram
    # of the tree (root, every level, either arm, either kernel) sums in it
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

    T = leafperm.TILE_ROWS
    n_row_tiles = -(-N // T)
    # smaller children cover <= half the real rows on one device while the
    # f32 counts behind the smaller-child choice are exact (< 2^24 rows);
    # the wired plan's half bound and the legacy arm's rows_bound share it
    half_ok = group is None and N < (1 << 24)
    if use_layout:
        # ---- root: the natural-order records are the one-segment layout --
        n_buf_tiles = leafperm.wired_tiles_bound(n_row_tiles, L)
        rec_nat = leafperm.make_layout_records(Xb, g, h, valid=bag_mask)
        lay_rec, lay_tr, lay_rs = leafperm.natural_root_layout(
            rec_nat, L, n_buf_tiles)
        del rec_nat
        hist0 = build_hist(Xb, g, h, bag_mask, B, shift, layout=lay_rec,
                           reduce=red_root)
        nat_tiles = None
    else:
        # ---- legacy: one record table per tree (g/h change per tree) and
        # the natural-order tiles for the shallow levels, where admitted;
        # arm A1 reads the bins as they are
        records = None
        if a1 is None:
            records = _hist.make_records(Xb, g, h)
        nat_tiles = hist_nat.natural_tiles(Xb) if plan.nat_live else None
        hist0 = build_hist(Xb, g, h, bag_mask, B, shift, records=records,
                           reduce=red_root, a1_rows=a1)
    G0, H0, C0 = root_stats(hist0)
    if mono is not None:
        # per-slot monotone output bounds, unbounded at the root
        slot_lo = torch.full((L,), float("-inf"), dtype=f32, device=dev)
        slot_hi = torch.full((L,), float("inf"), dtype=f32, device=dev)
    root = best(hist0[None], G0[None], H0[None], C0[None],
                (C0 >= 2 * p.min_data_in_leaf)[None],
                *((slot_lo[:1], slot_hi[:1]) if mono is not None
                  else (None, None)))

    slot_node = torch.full((L,), -1, dtype=i64, device=dev)
    slot_node[0] = 0
    slot_gain = torch.full((L,), NEG_INF, dtype=f32, device=dev)
    slot_gain[0] = root["gain"][0]
    slot_G = torch.zeros(L, dtype=f32, device=dev)
    slot_G[0] = G0
    slot_H = torch.zeros(L, dtype=f32, device=dev)
    slot_H[0] = H0
    slot_C = torch.zeros(L, dtype=f32, device=dev)
    slot_C[0] = C0
    slot_depth = torch.zeros(L, dtype=i64, device=dev)
    sp = {k: torch.zeros(L, dtype=f32, device=dev)
          for k in ("g_left", "h_left", "c_left")}
    sp["feature"] = torch.full((L,), -1, dtype=i64, device=dev)
    sp["threshold"] = torch.zeros(L, dtype=i64, device=dev)
    sp["default_left"] = torch.ones(L, dtype=torch.bool, device=dev)
    sp["cat_mask"] = torch.zeros((L,) + root["cat_mask"].shape[1:],
                                 dtype=torch.bool, device=dev)
    for k in sp:
        sp[k][0] = root[k][0]
    # one sentinel row (index L) takes the dropped histogram writes; the
    # feature arm keeps this rank's slice
    hists = torch.zeros((L + 1, 3, F if arm is None else arm.width, B),
                        dtype=f32, device=dev)
    hists[0] = hist0 if arm is None else arm.slice_hist(hist0)
    level_best = best if arm is None else arm.best

    cover = torch.zeros(M, dtype=f32, device=dev)
    cover[0] = C0
    feature = torch.full((M,), -1, dtype=i64, device=dev)
    threshold = torch.zeros(M, dtype=i64, device=dev)
    gain_arr = torch.zeros(M, dtype=f32, device=dev)
    left = torch.zeros(M, dtype=i64, device=dev)
    right = torch.zeros(M, dtype=i64, device=dev)
    node_dleft = torch.ones(M, dtype=torch.bool, device=dev)
    cat_nodes = torch.zeros((M,) + root["cat_mask"].shape[1:],
                            dtype=torch.bool, device=dev)
    num_nodes = torch.ones((), dtype=i64, device=dev)
    splits_done = torch.zeros((), dtype=i64, device=dev)
    max_depth = torch.zeros((), dtype=i64, device=dev)
    row_slot = torch.zeros(N, dtype=i64, device=dev)

    d_switch, P_narrow, P_full = plan.phases
    if use_layout:
        if p.hist_subtraction:
            sel_bound = {P: leafperm.wired_sel_tiles_bound(
                n_row_tiles, n_buf_tiles, P, half=half_ok)
                for P in (P_narrow, P_full)}
        else:
            sel_bound = {P: leafperm.wired_sel_tiles_bound(
                n_row_tiles, n_buf_tiles, 2 * P, half=False)
                for P in (P_narrow, P_full)}
    for d in range(depth_cap):
        P = P_narrow if d < d_switch else P_full
        at_level = (slot_depth == d) & (slot_gain > NEG_INF) & (slot_node >= 0)
        # gain-descending, stable: the lowest slot id wins ties
        # dryadlint: disable=wired-grower-sort -- (L,)-slot gain ranking, L <= 512; not a row sort (rows never sort on the wired path)
        order = torch.argsort(
            torch.where(at_level, -slot_gain, float("inf")), stable=True)
        sj = order[:P]
        budget_left = (L - 1) - splits_done
        do = at_level[sj] & (torch.arange(P, device=dev) < budget_left)
        doi = do.to(i64)
        n_do = doi.sum()

        parent_node = slot_node[sj]
        sf = sp["feature"][sj]
        thr = sp["threshold"][sj]
        GL, HL, CL = sp["g_left"][sj], sp["h_left"][sj], sp["c_left"][sj]
        GR, HR, CR = slot_G[sj] - GL, slot_H[sj] - HL, slot_C[sj] - CL

        # slot/node allocation in execution (gain) order
        ks = splits_done + torch.cumsum(doi, 0) - doi
        right_slot = torch.where(do, ks + 1, L)
        left_id = torch.where(do, num_nodes + 2 * (ks - splits_done), 0)
        right_id = left_id + 1

        # candidates that do not split write to the dropped index M
        pidx = torch.where(do, parent_node, M)
        feature = drop_set(feature, pidx, sf)
        gain_arr = drop_set(gain_arr, pidx,
                            torch.where(do, slot_gain[sj], 0.0))
        threshold = drop_set(threshold, pidx, thr)
        left = drop_set(left, pidx, left_id)
        right = drop_set(right, pidx, right_id)
        node_dleft = drop_set(node_dleft, pidx, sp["default_left"][sj])
        cat_nodes = drop_set(cat_nodes, pidx, sp["cat_mask"][sj])
        cover = drop_set(cover, torch.where(do, left_id, M), CL)
        cover = drop_set(cover, torch.where(do, right_id, M), CR)

        # natural-order routing of every row (each row's final leaf; the
        # legacy arm's histogram selection reads it too)
        rs = torch.clamp(row_slot, max=L - 1)
        if packed:
            # ---- packed per-slot routing table (L+1,): w0 | feature << 32
            w0_c = ((1 << 31) | (sp["default_left"][sj].to(i64) << 30)
                    | (torch.clamp(thr, 0, B - 1) << 16) | right_slot)
            if is_cat_feat is not None:
                w0_c |= is_cat_feat[torch.clamp(sf, min=0)].to(i64) << 29
            rec_t = drop_set(
                torch.zeros(L + 1, dtype=i64, device=dev),
                torch.where(do, sj, L + 1),
                w0_c | (torch.clamp(sf, min=0) << 32))
            cat_of = (None if is_cat_feat is None
                      else cat_lookup(sp["cat_mask"], rs))
            do_n, left_n, w0r = packed_route(
                rec_t[rs],
                lambda rf: Xb.gather(1, rf[:, None])[:, 0].to(i64),
                learn_missing, cat_of)
            row_do = do_n & (row_slot < L)
            row_slot = torch.where(row_do & ~left_n, w0r & 0xFFFF,
                                   row_slot)
        else:
            # ---- unpacked: (L,) split flags and right slots by slot, the
            # row's bin gathered at its slot's feature
            tgt = torch.where(do, sj, L)
            slot_do = drop_set(torch.zeros(L, dtype=torch.bool, device=dev),
                               tgt, torch.ones_like(do))
            slot_right = drop_set(torch.full((L,), L, dtype=i64, device=dev),
                                  tgt, right_slot)
            row_do = slot_do[rs] & (row_slot < L)
            left_n = gather_left(Xb, rs, sp["feature"], sp["threshold"],
                                 sp["default_left"], learn_missing,
                                 is_cat_feat, sp["cat_mask"])
            row_slot = torch.where(row_do & ~left_n, slot_right[rs],
                                   row_slot)

        ls = CL <= CR
        if use_layout:
            hist_l, hist_r, lay_rec, lay_tr, lay_rs = _wired_level(
                p, lay_rec, lay_tr, lay_rs, rec_t, sj, do, ls, hists, P, L,
                B, F, isz, sel_bound[P], n_buf_tiles, learn_missing, shift,
                None if is_cat_feat is None else sp["cat_mask"], red)
        else:
            hist_l, hist_r = _legacy_level(
                p, Xb, g, h, bag_mask, records, nat_tiles, row_slot, sj,
                right_slot, do, ls, CL, CR, hists, P, L, B, half_ok, shift,
                red, a1)
        hists[torch.where(do, sj, L)] = hist_l
        hists[torch.where(do, right_slot, L)] = hist_r

        # ---- children's stats and best splits, batched -------------------
        ch_lo = ch_hi = None
        if mono is not None:
            lo_l, hi_l, lo_r, hi_r = child_bounds(
                mono, sf, GL, HL, GR, HR, p.lambda_l2, slot_lo[sj],
                slot_hi[sj])
            ch_lo, ch_hi = torch.cat([lo_l, lo_r]), torch.cat([hi_l, hi_r])
        ch_slot = torch.cat([sj, right_slot])
        ch_do = torch.cat([do, do])
        ch_G = torch.cat([GL, GR])
        ch_H = torch.cat([HL, HR])
        ch_C = torch.cat([CL, CR])
        allow = ch_do & (d + 1 < depth_cap) & (ch_C >= 2 * p.min_data_in_leaf)
        res = level_best(torch.cat([hist_l, hist_r]), ch_G, ch_H, ch_C,
                         allow, ch_lo, ch_hi)

        cidx = torch.where(ch_do, ch_slot, L)
        if mono is not None:
            slot_lo = drop_set(slot_lo, cidx, ch_lo)
            slot_hi = drop_set(slot_hi, cidx, ch_hi)
        slot_node = drop_set(slot_node, cidx, torch.cat([left_id, right_id]))
        slot_gain = drop_set(slot_gain, cidx, res["gain"])
        slot_G = drop_set(slot_G, cidx, ch_G)
        slot_H = drop_set(slot_H, cidx, ch_H)
        slot_C = drop_set(slot_C, cidx, ch_C)
        slot_depth = drop_set(slot_depth, cidx,
                              torch.full_like(cidx, d + 1))
        for k in sp:
            sp[k] = drop_set(sp[k], cidx, res[k])

        splits_done = splits_done + n_do
        num_nodes = num_nodes + 2 * n_do
        max_depth = torch.where(n_do > 0, d + 1, max_depth)

    value = finalize_leaf_values(
        p, M, slot_node, slot_G, slot_H,
        torch.zeros(M, dtype=f32, device=dev),
        *((slot_lo, slot_hi) if mono is not None else ()))
    return finish_cat_fields({
        "feature": feature,
        "threshold": threshold,
        "left": left,
        "right": right,
        "value": value,
        "gain": gain_arr,
        "default_left": node_dleft,
        "cover": cover,
        "max_depth": max_depth,
        # each row's leaf node from the partition state (no re-traversal)
        "row_leaf": torch.clamp(slot_node, min=0)[
            torch.clamp(row_slot, max=L - 1)],
    }, is_cat_feat, cat_nodes)


def _wired_level(p, lay_rec, lay_tr, lay_rs, rec_t, sj, do, ls, hists, P, L,
                 B, F, isz, n_sel_tiles, n_buf_tiles, learn_missing, shift,
                 catmask=None, reduce=None):
    """One wired level: sides off the layout records, one move (K2), the
    children as contiguous runs of the new layout (K1, layout mode).
    ``catmask`` (L, B) holds the slots' categorical left sets, when any
    feature is categorical; ``reduce`` is the cross-rank hook.  Returns
    (hist_l, hist_r) and the advanced layout."""
    T = leafperm.TILE_ROWS
    dev = lay_rec.device
    i64 = torch.int64
    # every row of a tile shares the tile's run, so the routing word is
    # gathered per tile and broadcast over its 512 rows
    rr_lay = rec_t[torch.clamp(lay_rs, max=L)][lay_tr][:, None]
    rec3 = lay_rec.view(n_buf_tiles, T, leafperm.REC_WB)
    valid_lay = rec3[:, :, 8] == 1
    # dead runs compose to the zero word, so their (clamped) slot's set is
    # never read
    cat_of = (None if catmask is None else cat_lookup(
        catmask, torch.clamp(lay_rs, max=L - 1)[lay_tr][:, None]))
    do_lay, left_lay, _ = packed_route(
        rr_lay, lambda rf: leafperm.tile_bins(rec3, rf, isz), learn_missing,
        cat_of)
    side = torch.where(valid_lay, (do_lay & ~left_lay).to(i64),
                       2).reshape(-1)
    del rr_lay, rec3, valid_lay, do_lay, left_lay
    pos, dstl, dstr, base_l, base_r, _ = leafperm.level_moves(
        lay_tr, side, L)
    del side
    lay_rec = leafperm.permute_records(lay_rec, pos, dstl, dstr, n_buf_tiles)
    del pos, dstl, dstr
    # slot -> run inverse before advancing; dead runs go to L + 1, outside
    # the (L+1,) table, so the sentinel cell L stays intact
    slot_run = drop_set(
        torch.full((L + 1,), L, dtype=i64, device=dev),
        torch.where(lay_rs < L, lay_rs, L + 1),
        torch.arange(L, dtype=i64, device=dev))
    slot_do_t = ((rec_t >> 31) & 1) != 0
    slot_right_t = rec_t & 0xFFFF
    lrs_c = torch.clamp(lay_rs, max=L)
    run_do = slot_do_t[lrs_c] & (lay_rs < L)
    lay_tr, lay_rs = leafperm.advance_runs(
        lay_rs, run_do, slot_right_t[lrs_c], base_l, base_r, n_buf_tiles)

    # children are contiguous segments of the new layout
    rj = slot_run[torch.clamp(sj, max=L)]
    rjc = torch.clamp(rj, max=L - 1)
    lt_l = base_l[1:] - base_l[:-1]
    lt_r = base_r[1:] - base_r[:-1]
    sel_ok = do & (rj < L)
    if p.hist_subtraction:
        seg_first = torch.where(
            sel_ok, torch.where(ls, base_l[rjc], base_r[rjc]), 0)
        seg_nt = torch.where(
            sel_ok, torch.where(ls, lt_l[rjc], lt_r[rjc]), 0)
        hist_small = leafperm.hist_from_layout(
            lay_rec, seg_first, seg_nt, P, B, F, isz, n_sel_tiles, shift,
            reduce=reduce)
        hist_large = torch.index_select(hists, 0, sj) - hist_small
        ls4 = ls[:, None, None, None]
        hist_l = torch.where(ls4, hist_small, hist_large)
        hist_r = torch.where(ls4, hist_large, hist_small)
    else:
        # both children in one 2P-column pass over the new layout
        segf2 = torch.cat([torch.where(sel_ok, base_l[rjc], 0),
                           torch.where(sel_ok, base_r[rjc], 0)])
        segn2 = torch.cat([torch.where(sel_ok, lt_l[rjc], 0),
                           torch.where(sel_ok, lt_r[rjc], 0)])
        h2 = leafperm.hist_from_layout(
            lay_rec, segf2, segn2, 2 * P, B, F, isz, n_sel_tiles, shift,
            reduce=reduce)
        hist_l, hist_r = h2[:P], h2[P:]
    return hist_l, hist_r, lay_rec, lay_tr, lay_rs


def _legacy_level(p, Xb, g, h, bag_mask, records, nat_tiles, row_slot, sj,
                  right_slot, do, ls, CL, CR, hists, P, L, B, half_ok, shift,
                  reduce=None, a1=None):
    """One legacy level (the reference's plan arm): the smaller children's
    rows are selected off the natural-order ``row_slot`` (already routed
    to this level's children) and histogrammed by the natural-order pass
    (K3) when it is live and holds P slots, else through a sorted tile
    plan (K1, row mode), or by arm A1 in chunks of ``a1`` rows when given
    (no natural tiles then).  The larger children come by subtraction, or by their own pass when
    ``hist_subtraction`` is off."""
    N, F = Xb.shape
    dev = Xb.device
    i64 = torch.int64
    small_slot = torch.where(ls, sj, right_slot)
    large_slot = torch.where(ls, right_slot, sj)
    arange_P = torch.arange(P, dtype=i64, device=dev)
    # non-splitting candidates scatter to L + 1 (dropped); out-of-bag rows
    # are routed but never accumulated
    colof = drop_set(torch.full((L + 1,), P, dtype=i64, device=dev),
                     torch.where(do, small_slot, L + 1), arange_P)
    smallsel = torch.where(bag_mask, colof[torch.clamp(row_slot, max=L)], P)
    if nat_tiles is not None and P <= hist_nat.NAT_SLOTS:
        hist_small = hist_nat.build_hist_small(
            nat_tiles, g, h, smallsel, P, B, F, shift, reduce=reduce)
    else:
        # exact per-slot counts (the smaller child's C off the parent
        # histogram, integer-exact in f32 below 2^24 rows) admit the
        # aligned plan
        small_cnt = (torch.where(do, torch.where(ls, CL, CR), 0.0).to(i64)
                     if half_ok else None)
        hist_small = build_hist_segmented(
            Xb, g, h, smallsel, P, B, shift, records=records,
            rows_bound=(N // 2 + 1) if half_ok else None,
            sel_counts=small_cnt, reduce=reduce, a1_rows=a1)
    if p.hist_subtraction:
        hist_large = torch.index_select(hists, 0, sj) - hist_small
    else:
        largesel = drop_set(torch.full((L + 1,), P, dtype=i64, device=dev),
                            torch.where(do, large_slot, L + 1), arange_P)
        hist_large = build_hist_multi(
            Xb, g, h,
            torch.where(bag_mask, largesel[torch.clamp(row_slot, max=L)], P),
            P, B, shift, records=records, reduce=reduce, a1_rows=a1)
    ls4 = ls[:, None, None, None]
    return (torch.where(ls4, hist_small, hist_large),
            torch.where(ls4, hist_large, hist_small))
