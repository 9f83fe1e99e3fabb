"""Histogram passes of the growers, through K1 or arm A1.

The counterpart of ``dryad_tpu/engine/histogram.py`` on its Pallas arm:

* ``build_hist``: the masked single-leaf pass (the root), the reference's
  ``pallas_hist.build_hist_pallas``.  Rows stream in natural order; rows
  outside ``mask`` add nothing.  The wired grower passes its natural-order
  layout records (K1 layout mode); otherwise the rows are read from the
  per-tree record table (K1 row mode), of any record width.
* ``build_hist_segmented``: per-slot histograms of a whole level from a
  sorted tile plan (``tile_plan``), K1 row mode.
* ``build_hist_multi``: the same function for the legacy arm's
  ``hist_subtraction=False`` pass.  The reference computes it as a dense
  one-hot matmul; the port takes the generic tile plan and K1 row mode.

Every pass takes the tree's fixed-point ``shift``
(``hist.fixed_point_shift``), so all the histograms of one tree are sums
in one fixed point and agree bit for bit whichever kernel computes them.

Every pass takes an optional ``reduce`` hook (``hist.finish``): under a
process group the grower passes ``engine/distributed.reducer``, which
sums the int64 pass across ranks, whole or as this rank's feature slice,
before its conversion to f32.  A rank without rows still takes part, with
zero sums.

Arm A1 (``build_hist_a1``) is the counterpart of the reference's XLA arm
(its ``build_hist``, ``build_hist_multi`` and ``build_hist_segmented``
outside any Pallas kernel): plain torch ops, not a kernel.  The live rows
(a slot in [0, P)) are selected once; each chunk of ``rows_per_chunk`` of
them adds its fixed-point int64 g, h and count into
the flat (slot, feature, bin) cells with one ``index_add_``
(``hist.add_cells``), and the sums go through ``hist.finish``.  Integer
adds are order-free, so arm A1 is bit for bit K1 on the same rows, and
deterministic on the card.  It takes every pass of a config past K1's
bins cap (``hist.MAX_BINS``, 1024) and every pass under
``hist_backend="xla"`` (``a1_rows``): the growers pass its row chunk as
``a1_rows=`` to each entry point, and None for the kernels.  ``"auto"``
is structural, the kernels on every platform the port has: the policy
gate "hist_backend" is resolvable (``policy/gates.py``) but no site
reads it.
"""

from __future__ import annotations

import torch

from dryad_tpu_torch.engine import hist, leafperm, tile_plan


def a1_rows(p, total_bins: int) -> int | None:
    """Arm A1's row chunk when it takes this config's passes, else None
    (the kernels take them): A1 under ``hist_backend="xla"`` and past
    K1's bins cap.  Static for a config, so every rank of a group runs
    one program."""
    if p.hist_backend == "xla" or not hist.supports(total_bins):
        return max(1, int(p.rows_per_chunk))
    return None


def build_hist_a1(Xb: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                  sel: torch.Tensor, num_cols: int, total_bins: int,
                  shift: torch.Tensor, *, rows_per_chunk: int,
                  reduce=None) -> torch.Tensor:
    """Arm A1 (module doc): (P, 3, F, B) f32 sums of the rows whose ``sel``
    (N,) is a slot in [0, P); any other ``sel`` drops the row."""
    N, F = Xb.shape
    P, B = int(num_cols), int(total_bins)
    acc = torch.zeros((P * F * B, 3), dtype=torch.int64, device=Xb.device)
    # the live rows, selected once; dropped rows cost nothing
    live = ((sel >= 0) & (sel < P)).nonzero().squeeze(1)
    step = max(1, int(rows_per_chunk))
    for r0 in range(0, live.numel(), step):
        idx = live[r0:r0 + step]
        xs = Xb.index_select(0, idx)
        hist.add_cells(acc, sel.index_select(0, idx),
                       torch.ones_like(idx, dtype=torch.bool),
                       g.index_select(0, idx), h.index_select(0, idx),
                       lambda f0, f1: xs[:, f0:f1].to(torch.int64), F, B,
                       shift)
    return hist.finish(hist.cells_to_hist(acc, P, F, B), shift, reduce)


def empty_pass(P: int, F: int, total_bins: int, shift: torch.Tensor,
               reduce) -> torch.Tensor:
    """The (P, 3, F, B) pass of a rank without rows: zero sums, reduced
    with the group's."""
    acc = torch.zeros((P, 3, F, int(total_bins)), dtype=torch.int64,
                      device=shift.device)
    return hist.finish(acc, shift, reduce)


def build_hist(Xb: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
               mask: torch.Tensor, total_bins: int, shift: torch.Tensor,
               *, layout: torch.Tensor | None = None,
               records: torch.Tensor | None = None,
               reduce=None, a1_rows: int | None = None) -> torch.Tensor:
    """Masked per-(feature, bin) sums -> (3, F, B) fp32: grad, hess, count.

    ``layout`` may pass the natural-order layout records of exactly these
    rows (``leafperm.make_layout_records(Xb, g, h, valid=mask)``, padded
    with zero rows); ``records`` the tree's record table
    (``hist.make_records(Xb, g, h)``).  A caller that already holds
    either does not build it twice; with neither, the record table is
    built here.  ``reduce``: the cross-rank hook (module doc).
    ``a1_rows``: arm A1 in chunks of this many rows instead of K1."""
    if a1_rows is not None:
        return build_hist_a1(Xb, g, h, (~mask).to(torch.int64), 1,
                             total_bins, shift, rows_per_chunk=a1_rows,
                             reduce=reduce)[0]
    N, F = Xb.shape
    T = hist.TILE_ROWS
    n_tiles = -(-N // T)
    dev = Xb.device
    isz = leafperm.bin_itemsize(Xb)
    if N == 0:
        return empty_pass(1, F, total_bins, shift, reduce)[0]
    if layout is not None:
        if layout.shape[0] < n_tiles * T:
            layout = torch.nn.functional.pad(
                layout, (0, 0, 0, n_tiles * T - layout.shape[0]))
        src = torch.arange(n_tiles, dtype=torch.int64, device=dev)
        return hist.hist_tiles(layout, src, torch.zeros_like(src), 1,
                               total_bins, F, isz, shift, reduce=reduce)[0]
    if records is None:
        records = hist.make_records(Xb, g, h)
    rows = torch.arange(N, dtype=torch.int64, device=dev)
    buf = torch.nn.functional.pad(torch.where(mask, rows, N),
                                  (0, n_tiles * T - N), value=N)
    tile_leaf = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
    return hist.hist_rows(records, buf, tile_leaf, 1, total_bins, F, isz,
                          shift, reduce=reduce)[0]


def build_hist_segmented(Xb: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                         sel: torch.Tensor, num_cols: int, total_bins: int,
                         shift: torch.Tensor, *,
                         records: torch.Tensor | None = None,
                         rows_bound: int | None = None,
                         sel_counts: torch.Tensor | None = None,
                         reduce=None, a1_rows: int | None = None
                         ) -> torch.Tensor:
    """Histograms of ``num_cols`` slots -> (P, 3, F, B) fp32; ``sel`` (N,)
    in [0, P], P drops the row.  ``records`` is the tree's record table
    (built here when not given); ``rows_bound`` is ``tile_plan``'s.
    ``sel_counts`` (P,), the exact per-slot row counts, switches to the
    aligned plan where it is admissible (the reference's
    ``build_hist_segmented_pallas``).  ``reduce`` and ``a1_rows`` as in
    ``build_hist``."""
    if a1_rows is not None:
        return build_hist_a1(Xb, g, h, sel, num_cols, total_bins, shift,
                             rows_per_chunk=a1_rows, reduce=reduce)
    N, F = Xb.shape
    P = int(num_cols)
    if N == 0:
        return empty_pass(P, F, total_bins, shift, reduce)
    if records is None:
        records = hist.make_records(Xb, g, h)
    if sel_counts is not None and N <= (1 << 24) - 1 and P <= 254:
        buf, tile_leaf, _ = tile_plan.tile_plan_aligned(
            sel, sel_counts, N, P, rows_bound=rows_bound)
    else:
        buf, tile_leaf, _ = tile_plan.tile_plan(sel, N, P,
                                                rows_bound=rows_bound)
    return hist.hist_rows(records, buf, tile_leaf, P, total_bins, F,
                          leafperm.bin_itemsize(Xb), shift, reduce=reduce)


def build_hist_multi(Xb: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                     sel: torch.Tensor, num_cols: int, total_bins: int,
                     shift: torch.Tensor, *,
                     records: torch.Tensor | None = None,
                     reduce=None, a1_rows: int | None = None
                     ) -> torch.Tensor:
    """Histograms of ``num_cols`` slots in one pass -> (P, 3, F, B) fp32;
    ``sel`` (N,) in [0, P], P drops the row.  No bound on the selection:
    the generic plan covers every row.  ``reduce`` and ``a1_rows`` as in
    ``build_hist``."""
    return build_hist_segmented(Xb, g, h, sel, num_cols, total_bins, shift,
                                records=records, reduce=reduce,
                                a1_rows=a1_rows)
