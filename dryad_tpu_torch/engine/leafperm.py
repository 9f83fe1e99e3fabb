"""Leaf-ordered record layout of the wired grower, and K2, its row move.

The counterpart of ``dryad_tpu/engine/leafperm.py``.  Records live in a
tile-aligned, leaf-ordered buffer: segment k (one leaf slot) owns
``max(ceil(cnt/512), 1)`` consecutive 512-row tiles, and rows past its real
rows are zero sentinels (zero weight, valid flag 0).  Each level moves every
row to its child segment in one pass; the new layout is
``[left children | slack tile | right children | slack tile]``, and inside
a segment each source tile's contribution starts on a 32-row boundary
(``ALIGN``, kept from the reference so the layouts agree bit for bit).

``permute_records`` is K2's wrapper.  It replaces
``dryad_tpu/engine/leafperm.py::_perm_kernel``.  On a CUDA tensor it
launches ``csrc/perm.cu``; on a CPU tensor it runs
``permute_records_plain``.

Layout record byte format (128 B):
``[ g f32 (4) | h f32 (4) | valid u8 (1) | bins u8/u16 (F*itemsize) | 0 ]``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as nnf

from dryad_tpu_torch.engine import cuda_build, hist
from dryad_tpu_torch.engine.ops import drop_add, drop_set

TILE_ROWS = hist.TILE_ROWS
REC_WB = hist.REC_WB
ALIGN = 32


def bin_itemsize(Xb: torch.Tensor) -> int:
    """Bytes per stored bin id: u8 bins are held as uint8, wider ones
    (up to 16 bits) in a wider integer tensor."""
    return 1 if Xb.dtype == torch.uint8 else 2


def make_layout_records(Xb: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                        valid: torch.Tensor | None = None) -> torch.Tensor:
    """(N, 128) uint8 layout records in natural row order.  Rows outside
    ``valid`` get flag 0 and are dropped by the first level's move."""
    N, F = Xb.shape
    isz = bin_itemsize(Xb)
    if 9 + F * isz > REC_WB:
        raise ValueError("feature bytes exceed the record")
    rec = torch.zeros((N, REC_WB), dtype=torch.uint8, device=Xb.device)
    rec[:, 0:4] = g.to(torch.float32).contiguous().view(torch.uint8).view(N, 4)
    rec[:, 4:8] = h.to(torch.float32).contiguous().view(torch.uint8).view(N, 4)
    rec[:, 8] = 1 if valid is None else valid.to(torch.uint8)
    if isz == 1:
        rec[:, 9:9 + F] = Xb
    else:                                   # little-endian u16, as bitcast
        xb = Xb.to(torch.int32)
        rec[:, 9:9 + 2 * F:2] = (xb & 0xFF).to(torch.uint8)
        rec[:, 10:10 + 2 * F:2] = (xb >> 8).to(torch.uint8)
    return rec


def unpack_layout_records(rec: torch.Tensor, num_features: int,
                          itemsize: int):
    """(g, h, valid, bins) views of a layout record buffer; bins int64."""
    return hist.unpack_rows(rec, num_features, itemsize)


def tile_bins(rec3: torch.Tensor, feat: torch.Tensor,
              itemsize: int) -> torch.Tensor:
    """Bin ids of records viewed as tiles (n_tiles, T, 128) on one feature
    per tile (``feat`` (n_tiles, 1)); the per-tile column index is
    broadcast over the tile's rows, never materialised per row."""
    n, rows, _ = rec3.shape
    col = (9 + feat.to(torch.int64) * itemsize)[:, :, None].expand(n, rows, 1)
    lo = rec3.gather(2, col)[:, :, 0].to(torch.int64)
    if itemsize == 1:
        return lo
    return lo | (rec3.gather(2, col + 1)[:, :, 0].to(torch.int64) << 8)


def natural_root_layout(rec_nat: torch.Tensor, num_runs: int,
                        n_buf_tiles: int, first_slot: int = 0,
                        sentinel: int | None = None):
    """Root layout: the natural-order records padded to ``n_buf_tiles``
    tiles are one segment (run 0 owns every tile).  Returns
    (rec_lay, tile_run, run_slot); run_slot holds ``first_slot`` at run 0
    and ``sentinel`` (default ``num_runs``) elsewhere.  The leaf-wise
    expansion stores heap node ids in run_slot: root 1, sentinel 2^(D+1)."""
    N = rec_nat.shape[0]
    T = TILE_ROWS
    if N > n_buf_tiles * T:
        raise ValueError(f"{N} rows exceed the {n_buf_tiles}-tile buffer")
    dev = rec_nat.device
    rec_lay = nnf.pad(rec_nat, (0, 0, 0, n_buf_tiles * T - N))
    tile_run = torch.zeros(n_buf_tiles, dtype=torch.int64, device=dev)
    run_slot = torch.full((num_runs,),
                          num_runs if sentinel is None else sentinel,
                          dtype=torch.int64, device=dev)
    run_slot[0] = first_slot
    return rec_lay, tile_run, run_slot


def _aligned_layout(counts: torch.Tensor, T: int = TILE_ROWS):
    lt = torch.clamp((counts + (T - 1)) // T, min=1)
    base = torch.cat([torch.zeros(1, dtype=lt.dtype, device=lt.device),
                      torch.cumsum(lt, 0)])
    return lt, base


def level_moves(tile_slot: torch.Tensor, side: torch.Tensor, n_parents: int,
                T: int = TILE_ROWS):
    """One level's move plan, O(N) elementwise and O(n_tiles) prefix work.

    tile_slot (n_tiles,): source segment per tile.  side (n_tiles*T,): 0
    left child, 1 right child, anything else a sentinel that vanishes.
    Returns (pos, dstl, dstr, base_l, base_r, n_out_tiles): ``pos``
    (n_tiles, 2, T) int32 holds each row's stable in-tile rank on its side
    and T elsewhere; ``dstl``/``dstr`` are destination row offsets;
    ``base_l``/``base_r`` (P+1,) are the first tiles of each parent's
    children (right already offset past the left region); ``n_out_tiles``
    is a 0-d tensor (callers size buffers by a static bound)."""
    n_tiles = tile_slot.shape[0]
    A = ALIGN
    tile_slot = tile_slot.to(torch.int64)
    s2 = side.view(n_tiles, T)
    isl = (s2 == 0).to(torch.int64)
    isr = (s2 == 1).to(torch.int64)
    rkl = torch.cumsum(isl, 1) - isl                  # stable in-tile ranks
    rkr = torch.cumsum(isr, 1) - isr
    nl_t = (isl.sum(1) + (A - 1)) // A * A
    nr_t = (isr.sum(1) + (A - 1)) // A * A
    cl = torch.cumsum(nl_t, 0) - nl_t                 # global tile prefixes
    cr = torch.cumsum(nr_t, 0) - nr_t
    change = tile_slot[1:] != tile_slot[:-1]
    one = torch.ones(1, dtype=torch.bool, device=tile_slot.device)
    first = torch.cat([one, change])
    # per-segment prefix: cl is non-decreasing, so carrying the segment's
    # first-tile value forward is a running max (lax.associative_scan(max)
    # in the reference)
    segl = torch.cummax(torch.where(first, cl, -1), 0).values
    segr = torch.cummax(torch.where(first, cr, -1), 0).values
    prefl = cl - segl
    prefr = cr - segr
    last = torch.cat([change, one])
    lastl = torch.where(last, prefl + nl_t, -1)
    lastr = torch.where(last, prefr + nr_t, -1)
    P = int(n_parents)
    zeros = torch.zeros(P, dtype=torch.int64, device=tile_slot.device)
    # .at[tile_slot].max(...) on zeros
    pad_l = zeros.scatter_reduce(0, tile_slot, lastl, "amax",
                                 include_self=True)
    pad_r = zeros.scatter_reduce(0, tile_slot, lastr, "amax",
                                 include_self=True)
    _, base_l = _aligned_layout(pad_l, T)
    _, base_r = _aligned_layout(pad_r, T)
    off_r = base_l[-1] + 1                            # [left | slack | right]
    dstl = base_l[tile_slot] * T + prefl
    dstr = (off_r + base_r[tile_slot]) * T + prefr
    n_out_tiles = off_r + base_r[-1] + 1
    pos = torch.stack([torch.where(s2 == 0, rkl, T),
                       torch.where(s2 == 1, rkr, T)], 1).to(torch.int32)
    return pos, dstl, dstr, base_l, base_r + off_r, n_out_tiles


def tiles_bound(n_rows: int, n_parents: int, T: int = TILE_ROWS) -> int:
    """Static bound for ``n_out_tiles`` of one level (the reference's)."""
    n_src_tiles = n_rows // T
    pad_rows = 2 * ALIGN * n_src_tiles
    return (n_rows + pad_rows) // T + 2 * n_parents + 4


def wired_tiles_bound(n_row_tiles: int, num_slots: int) -> int:
    """Static fixed-point tile bound of the carried layout buffer: one
    buffer of this size carries every level (pads do not compound)."""
    base = n_row_tiles + 2 * num_slots + 2
    assert 2 * ALIGN * 8 <= TILE_ROWS, "fixed point needs 2A/T <= 1/8"
    return -(-8 * base // 7) + 2


def wired_sel_tiles_bound(n_row_tiles: int, n_buf_tiles: int,
                          num_cols: int, half: bool) -> int:
    """Static bound on ``hist_from_layout``'s ``n_sel_tiles``.  ``half``
    when the selection provably covers at most half the real rows (the
    smaller children on one device below 2^24 rows)."""
    if half:
        return n_row_tiles // 2 + n_buf_tiles // 16 + 2 * num_cols + 8
    return n_buf_tiles + 2 * num_cols


def _check_perm(rec, pos, dstl, dstr, n_out_tiles):
    T = TILE_ROWS
    if rec.dtype != torch.uint8 or rec.dim() != 2 or rec.shape[1] != REC_WB:
        raise ValueError(f"rec must be (n, {REC_WB}) uint8")
    if rec.shape[0] % T:
        # the reference truncates silently here
        raise ValueError(f"rec rows {rec.shape[0]} are not a multiple of {T}")
    n_tiles = rec.shape[0] // T
    if tuple(pos.shape) != (n_tiles, 2, T):
        raise ValueError(f"pos must be {(n_tiles, 2, T)}, got "
                         f"{tuple(pos.shape)}")
    if tuple(dstl.shape) != (n_tiles,) or tuple(dstr.shape) != (n_tiles,):
        raise ValueError("dstl/dstr must be (n_tiles,)")
    if n_out_tiles < 1:
        raise ValueError("n_out_tiles must be >= 1")
    for t in (pos, dstl, dstr):
        if t.device != rec.device:
            raise ValueError("all inputs must lie on one device")


def permute_records(rec: torch.Tensor, pos: torch.Tensor, dstl: torch.Tensor,
                    dstr: torch.Tensor, n_out_tiles: int) -> torch.Tensor:
    """Apply one level's move (K2): each real row goes to
    ``dst_side[tile] + pos[tile, side, row]`` in a zeroed
    (n_out_tiles*512, 128) buffer.

    The reference's kernel writes whole 512-row windows, zero tails
    included, and is right only because TPU grid steps run in order.  Here
    only real rows are written into a buffer the wrapper zeroes, so the
    result does not depend on the order blocks run in, and equals
    ``permute_records_np`` bit for bit."""
    n_out_tiles = int(n_out_tiles)
    _check_perm(rec, pos, dstl, dstr, n_out_tiles)
    T = TILE_ROWS
    # memory-safety clamp, as the reference: a violated bound misplaces
    # rows deterministically inside the buffer, never past it
    cap = (n_out_tiles - 1) * T
    dstl = torch.clamp(dstl, max=cap)
    dstr = torch.clamp(dstr, max=cap)
    if rec.device.type == "cpu":
        return permute_records_plain(rec, pos, dstl, dstr, n_out_tiles)
    if rec.device.type != "cuda":
        raise ValueError(f"unsupported device {rec.device}")
    if not rec.is_contiguous():
        raise ValueError("rec must be contiguous")
    pos = pos.to(torch.int32).contiguous()
    dstl = dstl.to(torch.int32).contiguous()
    dstr = dstr.to(torch.int32).contiguous()
    out = torch.zeros((n_out_tiles * T, REC_WB), dtype=torch.uint8,
                      device=rec.device)
    fn = cuda_build.lib("perm").dryad_permute_records
    stream = torch.cuda.current_stream(rec.device).cuda_stream
    cuda_build.counts["perm"] += 1
    cuda_build.check(fn(rec.data_ptr(), pos.data_ptr(), dstl.data_ptr(),
                        dstr.data_ptr(), out.data_ptr(), rec.shape[0] // T,
                        cap, stream), "perm kernel")
    return out


def permute_records_plain(rec, pos, dstl, dstr, n_out_tiles):
    """The plain PyTorch version of K2: one indexed write per side into a
    zeroed buffer with a sentinel row (rows of the other side and
    sentinel rows land there and are sliced off)."""
    T = TILE_ROWS
    n_out = n_out_tiles * T
    out = torch.zeros((n_out + 1, REC_WB), dtype=torch.uint8,
                      device=rec.device)
    for s, dst in ((0, dstl), (1, dstr)):
        p = pos[:, s, :].to(torch.int64)
        dest = torch.where(p < T, dst.to(torch.int64)[:, None] + p, n_out)
        out[dest.reshape(-1)] = rec
    return out[:n_out]


def hist_from_layout(rec: torch.Tensor, seg_first: torch.Tensor,
                     seg_ntiles: torch.Tensor, num_cols: int,
                     total_bins: int, num_features: int, itemsize: int,
                     n_sel_tiles: int, shift: torch.Tensor, *,
                     reduce=None) -> torch.Tensor:
    """(P, 3, F, B) histograms of P selected segments of a layout.  Each
    segment is a contiguous tile run; K1 reads the runs in place through
    the per-slot source-tile list (no gathered copy), with the tree's
    fixed-point ``shift``.  ``reduce``: the cross-rank hook
    (``hist.finish``).

    ``n_sel_tiles`` (static) must be at least ``sum(max(seg_ntiles, 1))``
    (every selection reserves a slot, so an empty one still zeroes its
    output).  The reference truncates silently when it is not; here the
    check runs on the device and raises at the next synchronisation,
    without a fetch in the level loop."""
    T = TILE_ROWS
    P = int(num_cols)
    n_in = rec.shape[0] // T
    dev = rec.device
    seg_ntiles = seg_ntiles.to(torch.int64)
    base = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(torch.clamp(seg_ntiles, min=1), 0)])
    torch._assert_async(base[-1] <= n_sel_tiles,
                        "hist_from_layout: n_sel_tiles is below "
                        "sum(max(seg_ntiles, 1))")
    idx = torch.arange(n_sel_tiles, dtype=torch.int64, device=dev)
    # jnp.searchsorted(side="right") -> torch.searchsorted(right=True)
    tile_leaf = torch.searchsorted(base[1:].contiguous(), idx, right=True)
    lc = torch.clamp(tile_leaf, max=P - 1)
    off = idx - base[lc]
    live = (tile_leaf < P) & (off < seg_ntiles[lc])
    src = torch.where(
        live, torch.clamp(seg_first.to(torch.int64)[lc] + off, 0, n_in - 1),
        -1)
    return hist.hist_tiles(rec, src, lc, P, total_bins, num_features,
                           itemsize, shift, reduce=reduce)


def advance_runs(run_slot: torch.Tensor, run_do: torch.Tensor,
                 run_right: torch.Tensor, base_l: torch.Tensor,
                 base_r: torch.Tensor, n_buf_tiles: int,
                 sentinel: int | None = None):
    """Next level's (tile_run, run_slot) after ``level_moves``: every left
    segment of a live run keeps its run index, each splitting run's right
    segment appends a new run (in run order); tiles between kept segment
    starts are absorbed into the preceding run.

    ``sentinel`` marks an unused run (default: the run capacity).  A caller
    whose kept runs change their slot id across the level (the leaf-wise
    expansion: node n's left child is 2n) applies that change to
    ``run_slot`` first; liveness is read from it and only the appended
    right runs are written."""
    L = run_slot.shape[0]
    dev = run_slot.device
    R = (run_slot < (L if sentinel is None else sentinel)).sum()
    ridx = torch.arange(L, dtype=torch.int64, device=dev)
    ones = torch.ones(L, dtype=torch.int64, device=dev)
    marks = torch.zeros(n_buf_tiles, dtype=torch.int64, device=dev)
    # out-of-range marks are dropped (mode="drop" in the reference)
    marks = drop_add(marks, torch.where(ridx < R, base_l[:L], n_buf_tiles),
                     ones)
    marks = drop_add(marks, torch.where(run_do, base_r[:L], n_buf_tiles),
                     ones)
    tile_run = torch.clamp(torch.cumsum(marks, 0) - 1, min=0)
    rd = run_do.to(torch.int64)
    rank = torch.cumsum(rd, 0) - rd
    run_slot = drop_set(run_slot, torch.where(run_do, R + rank, L),
                        run_right.to(torch.int64))
    return tile_run, run_slot


# ---------------------------------------------------------------------------
# numpy oracle, copied from the reference (the bitwise reference for tests)
# ---------------------------------------------------------------------------

def permute_records_np(rec: np.ndarray, tile_slot: np.ndarray,
                       side: np.ndarray, n_parents: int, n_out_tiles: int,
                       T: int = TILE_ROWS):
    """Stable per-(segment, side) order into the [left | slack | right |
    slack] layout with ALIGN-rounded per-tile contributions.  Returns
    (out, tile_slot_new, row_seg_new): segments numbered [left children
    0..P-1, then right children P..2P-1]; row_seg is -1 for sentinels."""
    A = ALIGN
    n_tiles = tile_slot.shape[0]
    WB = rec.shape[1]
    P = n_parents
    pad_l = np.zeros(P, np.int64)
    pad_r = np.zeros(P, np.int64)
    for i in range(n_tiles):
        s = tile_slot[i]
        sd = side[i * T:(i + 1) * T]
        pad_l[s] += -(-int((sd == 0).sum()) // A) * A
        pad_r[s] += -(-int((sd == 1).sum()) // A) * A
    lt_l = np.maximum(-(-pad_l // T), 1)
    lt_r = np.maximum(-(-pad_r // T), 1)
    base_l = np.concatenate([[0], np.cumsum(lt_l)]).astype(np.int64)
    off_r = base_l[-1] + 1
    base_r = off_r + np.concatenate([[0], np.cumsum(lt_r)]).astype(np.int64)
    out = np.zeros((n_out_tiles * T, WB), np.uint8)
    row_seg = np.full(n_out_tiles * T, -1, np.int64)
    tile_slot_new = np.full(n_out_tiles, -1, np.int64)
    for s in range(P):
        tile_slot_new[base_l[s]: base_l[s + 1]] = s
        tile_slot_new[base_r[s]: base_r[s + 1]] = P + s
    for i in range(n_out_tiles):
        if tile_slot_new[i] < 0:
            tile_slot_new[i] = tile_slot_new[i - 1] if i else 0
    fill_l = np.zeros(P, np.int64)
    fill_r = np.zeros(P, np.int64)
    for i in range(n_tiles):
        s = tile_slot[i]
        nl = nr = 0
        for j in range(T):
            sd = side[i * T + j]
            if sd == 0:
                pos = base_l[s] * T + fill_l[s] + nl
                out[pos] = rec[i * T + j]
                row_seg[pos] = s
                nl += 1
            elif sd == 1:
                pos = base_r[s] * T + fill_r[s] + nr
                out[pos] = rec[i * T + j]
                row_seg[pos] = P + s
                nr += 1
        fill_l[s] += -(-nl // A) * A
        fill_r[s] += -(-nr // A) * A
    return out, tile_slot_new, row_seg
