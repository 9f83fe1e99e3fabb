"""Sorted tile plans of the legacy plan arm.

The counterpart of the host half of ``dryad_tpu/engine/pallas_hist.py``
(``tile_plan``, ``tile_plan_aligned``), in plain torch ops; the per-tree
record table, ``make_records``, sits beside K1's wrapper in ``hist`` and
is re-exported here.  The reference's ``hist_from_plan`` is K1's row
mode, ``hist.hist_rows``, and its ``build_hist_segmented_pallas`` is
``histogram.build_hist_segmented``.

A plan buckets rows by leaf slot into fixed 512-row tiles: ``buf`` holds
row ids with the sentinel N for empty slots, ``tile_leaf`` each tile's
(non-decreasing) slot, ``tile_first`` the first tile of each slot.  Every
slot owns at least one tile, so its histogram is written even when empty.
Plan shapes are static bounds: nothing is fetched to the host.

K1's row mode (``hist.hist_rows``) reads the planned rows in place from the
record table and skips dead tiles, so the reference's staged-prefix
gather (a TPU gather trick, value-identical to the full plan) has no
counterpart here.
"""

from __future__ import annotations

import torch

from dryad_tpu_torch.engine import hist
from dryad_tpu_torch.engine.hist import make_records  # noqa: F401

TILE_ROWS = hist.TILE_ROWS
# tile_plan_aligned's packed key: slot in the bits from 24, row below
_ROW_BITS = 24
_INERT_SLOT = 0xFF


def _tile_first(tile_leaf: torch.Tensor) -> torch.Tensor:
    first = torch.ones_like(tile_leaf)
    first[1:] = (tile_leaf[1:] != tile_leaf[:-1]).to(tile_leaf.dtype)
    return first


def tile_plan(sel: torch.Tensor, N: int, P: int, T: int = TILE_ROWS,
              rows_bound: int | None = None):
    """Bucket rows by slot ``sel`` (N,) in [0, P] (P drops the row) into
    fixed tiles: (buf, tile_leaf, tile_first), stable (rows keep their
    order inside a slot).

    ``rows_bound`` caps the total selected rows when the caller can prove a
    tighter bound than N (the smaller children of a level cover at most
    half the rows), which shrinks the static tile count.  If the bound is
    violated, the safety squeeze keeps every slot at least one in-range
    tile and drops the rows past a slot's allotment deterministically."""
    bound = N if rows_bound is None else min(int(rows_bound), N)
    n_tiles = bound // T + P + 1
    dev = sel.device
    i64 = torch.int64
    # one packed key per row (slot in the high word, row id in the low):
    # a plain sort of it is the stable argsort by slot, as the reference's
    # packed uint32 sort and its argsort fallback both are
    srt = torch.sort((sel.to(i64) << 32) | torch.arange(N, dtype=i64,
                                                        device=dev)).values
    sel_sorted = srt >> 32
    order = srt & 0xFFFFFFFF
    start = torch.searchsorted(sel_sorted,
                               torch.arange(P + 1, dtype=i64, device=dev))
    counts = start[1:] - start[:-1]
    # every slot gets >= 1 tile so its output is written
    leaf_tiles = torch.clamp((counts + (T - 1)) // T, min=1)
    seg_base = torch.cat([torch.zeros(1, dtype=i64, device=dev),
                          torch.cumsum(leaf_tiles, 0)])
    # safety squeeze: slot i starts no later than n_tiles - (P - i)
    seg_base = torch.minimum(
        seg_base, n_tiles - (P - torch.arange(P + 1, dtype=i64, device=dev)))
    cap_rows = (seg_base[1:] - seg_base[:-1]) * T
    tile_idx = torch.arange(n_tiles, dtype=i64, device=dev)
    tile_leaf = torch.searchsorted(seg_base[1:].contiguous(), tile_idx,
                                   right=True)
    # slot j of tile t holds row (t*T + j - seg_base[leaf]*T) of its slot's
    # run in ``order``, or the sentinel N past the slot's count or cap
    lc = torch.clamp(tile_leaf, max=P - 1)
    base_t = tile_idx * T - seg_base[lc] * T
    cnt_t = torch.minimum(counts[lc], cap_rows[lc])
    off = base_t[:, None] + torch.arange(T, dtype=i64, device=dev)
    ok = (tile_leaf < P)[:, None] & (off >= 0) & (off < cnt_t[:, None])
    src = start[lc][:, None] + off
    buf = torch.where(ok, order[torch.clamp(src, 0, N - 1)], N).reshape(-1)
    return buf, lc, _tile_first(lc)


def tile_plan_aligned(sel: torch.Tensor, counts: torch.Tensor, N: int,
                      P: int, T: int = TILE_ROWS,
                      rows_bound: int | None = None):
    """``tile_plan`` when the caller knows each slot's exact row count
    ``counts`` (P,): ``(-count) % T`` pad keys per slot, sorted in with the
    rows, make every slot's run tile-aligned in the sorted keys themselves,
    so ``buf`` is a plain slice.  The plan equals ``tile_plan``'s value for
    value.

    Admissibility (callers gate): N <= 2**24 - 1 (the row field holds row
    ids and the sentinel N), P <= 254 (slot 0xFF marks inert keys), and
    exact counts (a wrong count misaligns the plan)."""
    bound = N if rows_bound is None else min(int(rows_bound), N)
    n_tiles = bound // T + P + 1                   # same grid as tile_plan
    dev = sel.device
    i64 = torch.int64
    cnt = counts.to(i64)
    lt = torch.clamp((cnt + (T - 1)) // T, min=1)  # aligned tiles per slot
    seg_base = torch.cat([torch.zeros(1, dtype=i64, device=dev),
                          torch.cumsum(lt, 0)])
    key_real = ((sel.to(i64) << _ROW_BITS)
                | torch.arange(N, dtype=i64, device=dev))
    # slot p needs lt[p]*T - cnt[p] <= T pad keys (row field N = sentinel);
    # unused pad keys and one extra tail tile get the inert slot 0xFF
    pad_needed = lt * T - cnt
    padj = torch.arange(T, dtype=i64, device=dev)[None, :]
    slot_col = torch.arange(P, dtype=i64, device=dev)[:, None]
    inert = _INERT_SLOT << _ROW_BITS
    key_pad = torch.where(padj < pad_needed[:, None],
                          (slot_col << _ROW_BITS) | N, inert)
    key_tail = torch.full((T,), inert, dtype=i64, device=dev)
    srt = torch.sort(torch.cat([key_real, key_pad.reshape(-1),
                                key_tail])).values[:n_tiles * T]
    slot_s = srt >> _ROW_BITS
    row_s = srt & ((1 << _ROW_BITS) - 1)
    buf = torch.where(slot_s < P, row_s, N)        # pads carry row N already
    tile_leaf = torch.searchsorted(
        seg_base[1:].contiguous(),
        torch.arange(n_tiles, dtype=i64, device=dev), right=True)
    tile_leaf = torch.clamp(tile_leaf, max=P - 1)
    return buf, tile_leaf, _tile_first(tile_leaf)
