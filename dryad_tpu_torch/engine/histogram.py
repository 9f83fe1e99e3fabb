"""Histogram passes of the growers, through K1.

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

Bins past ``hist.MAX_BINS`` (1024) raise: the reference histograms those
on its XLA (non-Pallas) arm, which is a later slice of the port.
"""

from __future__ import annotations

import torch

from dryad_tpu_torch.engine import hist, leafperm, tile_plan


def require_kernel_bins(total_bins: int) -> None:
    if not hist.supports(total_bins):
        raise NotImplementedError(
            f"total_bins={total_bins} exceeds the histogram kernels' cap of "
            f"{hist.MAX_BINS}; the reference histograms such configs on its "
            "XLA (non-Pallas) arm, which is a later slice of the port")


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
               reduce=None) -> torch.Tensor:
    """Masked per-(feature, bin) sums -> (3, F, B) fp32: grad, hess, count.

    ``layout`` may pass the natural-order layout records of exactly these
    rows (``leafperm.make_layout_records(Xb, g, h, valid=mask)``, padded
    with zero rows); ``records`` the tree's record table
    (``tile_plan.make_records(Xb, g, h)``).  A caller that already holds
    either does not build it twice; with neither, the record table is
    built here.  ``reduce``: the cross-rank hook (module doc)."""
    require_kernel_bins(total_bins)
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
        records = tile_plan.make_records(Xb, g, h)
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
                         reduce=None) -> torch.Tensor:
    """Histograms of ``num_cols`` slots -> (P, 3, F, B) fp32; ``sel`` (N,)
    in [0, P], P drops the row.  ``records`` is the tree's record table
    (built here when not given); ``rows_bound`` is ``tile_plan``'s.
    ``sel_counts`` (P,), the exact per-slot row counts, switches to the
    aligned plan where it is admissible (the reference's
    ``build_hist_segmented_pallas``).  ``reduce`` as in ``build_hist``."""
    require_kernel_bins(total_bins)
    N, F = Xb.shape
    P = int(num_cols)
    if N == 0:
        return empty_pass(P, F, total_bins, shift, reduce)
    if records is None:
        records = tile_plan.make_records(Xb, g, h)
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
                     reduce=None) -> torch.Tensor:
    """Histograms of ``num_cols`` slots in one pass -> (P, 3, F, B) fp32;
    ``sel`` (N,) in [0, P], P drops the row.  No bound on the selection:
    the generic plan covers every row.  ``reduce`` as in ``build_hist``."""
    return build_hist_segmented(Xb, g, h, sel, num_cols, total_bins, shift,
                                records=records, reduce=reduce)
