"""Masked single-leaf histogram (the root pass), through K1.

The counterpart of ``dryad_tpu/engine/histogram.py::build_hist`` on its
Pallas arm (``pallas_hist.build_hist_pallas``).  Rows stream in natural
order as 128-byte layout records; rows outside ``mask`` carry valid flag 0
and add nothing.
"""

from __future__ import annotations

import torch

from dryad_tpu_torch.engine import hist, leafperm


def build_hist(Xb: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
               mask: torch.Tensor, total_bins: int, *,
               records: torch.Tensor | None = None) -> torch.Tensor:
    """Masked per-(feature, bin) sums -> (3, F, B) fp32: grad, hess, count.

    ``records`` may pass the natural-order layout records of exactly these
    rows (``leafperm.make_layout_records(Xb, g, h, valid=mask)``, padded
    with zero rows), so a caller that already holds them does not build
    them twice."""
    N, F = Xb.shape
    T = hist.TILE_ROWS
    n_tiles = -(-N // T)
    if records is None:
        records = leafperm.make_layout_records(Xb, g, h, valid=mask)
    if records.shape[0] < n_tiles * T:
        records = torch.nn.functional.pad(
            records, (0, 0, 0, n_tiles * T - records.shape[0]))
    src = torch.arange(n_tiles, dtype=torch.int64, device=Xb.device)
    return hist.hist_tiles(records, src, torch.zeros_like(src), 1,
                           total_bins, F, leafperm.bin_itemsize(Xb))[0]
