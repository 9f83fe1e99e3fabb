"""K1: leaf-segmented histograms straight from 128-byte layout records.

Replaces the TPU kernel ``dryad_tpu/engine/pallas_hist.py::_hist_kernel``
(launched by ``_hist_tiles``).  It computes the same function, not the
TPU's mechanics: no one-hot product, no bf16 limb split, no feature-major
transpose.

Input is a record buffer ``rec`` (n_tiles_in*512, 128) uint8 in the layout
format of ``leafperm`` (g f32 at byte 0, h f32 at 4, valid flag at 8, bins
from 9) and a plan of ``n_sel`` tile slots: ``src[i]`` is the source tile
of slot i (-1 = dead slot) and ``tile_leaf[i]`` its output leaf, non-
decreasing.  The result is (P, 3, F, B) f32: per leaf the sums of
``g*valid``, ``h*valid`` and ``valid`` per (feature, bin).  Every leaf in
``[0, P)`` is written; a leaf without live rows is zero.

On a CUDA tensor ``hist_tiles`` launches the kernel in ``csrc/hist.cu``;
on a CPU tensor it runs ``hist_tiles_plain``.  There is no fallback from
one to the other.
"""

from __future__ import annotations

import torch

from dryad_tpu_torch.engine import cuda_build

TILE_ROWS = 512
REC_WB = 128
# supports(): the reference's Pallas cap on total bins, kept as the port's
MAX_BINS = 1024
# plan tiles one block of the CUDA kernel accumulates before it writes its
# partial histogram (see csrc/hist.cu)
TILES_PER_ITEM = 16
# shared-memory budget of one block's private histogram, in bytes
_HIST_SMEM = 100 * 1024


def supports(total_bins: int) -> bool:
    return int(total_bins) <= MAX_BINS


def _check(rec, src, tile_leaf, num_cols, total_bins, num_features, itemsize):
    if not supports(total_bins):
        raise ValueError(f"total_bins={total_bins} exceeds the histogram "
                         f"kernel's cap of {MAX_BINS}")
    if 9 + num_features * itemsize > REC_WB:
        raise ValueError("feature bytes exceed the 128-byte record")
    if itemsize not in (1, 2):
        raise ValueError(f"bin itemsize must be 1 or 2, got {itemsize}")
    if rec.dtype != torch.uint8 or rec.dim() != 2 or rec.shape[1] != REC_WB:
        raise ValueError(f"rec must be (n, {REC_WB}) uint8, got "
                         f"{tuple(rec.shape)} {rec.dtype}")
    if rec.shape[0] % TILE_ROWS:
        raise ValueError(f"rec rows {rec.shape[0]} are not a multiple of "
                         f"{TILE_ROWS}")
    if src.shape != tile_leaf.shape or src.dim() != 1 or src.numel() == 0:
        raise ValueError("src and tile_leaf must be equal non-empty 1-D")
    if num_cols < 1:
        raise ValueError("num_cols must be >= 1")
    for t in (src, tile_leaf):
        if t.device != rec.device:
            raise ValueError("all inputs must lie on one device")


def hist_tiles(rec: torch.Tensor, src: torch.Tensor, tile_leaf: torch.Tensor,
               num_cols: int, total_bins: int, num_features: int,
               itemsize: int) -> torch.Tensor:
    """(P, 3, F, B) f32 histograms of the planned tiles (module doc)."""
    P, B, F = int(num_cols), int(total_bins), int(num_features)
    _check(rec, src, tile_leaf, P, B, F, itemsize)
    if rec.device.type == "cpu":
        return hist_tiles_plain(rec, src, tile_leaf, P, B, F, itemsize)
    if rec.device.type != "cuda":
        raise ValueError(f"unsupported device {rec.device}")
    if not rec.is_contiguous():
        raise ValueError("rec must be contiguous")
    dev = rec.device
    src = src.to(torch.int32).contiguous()
    tile_leaf = tile_leaf.to(torch.int32).contiguous()
    n_sel = src.numel()
    # items: runs of <= TILES_PER_ITEM consecutive plan tiles of one leaf.
    # Their count is data-dependent; n_items is its static bound (each
    # leaf adds at most one partial item), so nothing is fetched here.
    idx = torch.arange(n_sel, device=dev, dtype=torch.int64)
    first = torch.ones(n_sel, dtype=torch.bool, device=dev)
    first[1:] = tile_leaf[1:] != tile_leaf[:-1]
    run_start = torch.cummax(torch.where(first, idx, 0), 0).values
    istart = ((idx - run_start) % TILES_PER_ITEM) == 0
    item_id = torch.cumsum(istart.to(torch.int64), 0) - 1
    n_items = n_sel // TILES_PER_ITEM + P + 1
    # dropped scatters: non-start slots write the sentinel cell n_items,
    # which is sliced off (index_put_ has no mode="drop")
    tgt = torch.where(istart, item_id, n_items)
    item_first = torch.full((n_items + 1,), n_sel, dtype=torch.int32,
                            device=dev)
    item_first[tgt] = idx.to(torch.int32)
    item_leaf = torch.full((n_items + 1,), P, dtype=torch.int32, device=dev)
    item_leaf[tgt] = tile_leaf
    item_first = item_first[:n_items].contiguous()
    leaf_item_start = torch.searchsorted(
        item_leaf[:n_items].contiguous(),
        torch.arange(P + 1, dtype=torch.int32, device=dev)).to(
            torch.int32).contiguous()
    # fp64 g/h + fp32 count per cell; balanced feature chunks
    n_chunks = -(-F // max(1, _HIST_SMEM // (20 * B)))
    f_chunk = -(-F // n_chunks)
    partials = torch.empty((n_items, 3, F, B), dtype=torch.float64,
                           device=dev)
    out = torch.empty((P, 3, F, B), dtype=torch.float32, device=dev)
    fn = cuda_build.lib("hist").dryad_hist_tiles
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.counts["hist"] += 1
    cuda_build.check(fn(rec.data_ptr(), src.data_ptr(), tile_leaf.data_ptr(),
                        item_first.data_ptr(), n_sel, n_items,
                        partials.data_ptr(), F, B, int(itemsize), f_chunk,
                        n_chunks, leaf_item_start.data_ptr(), out.data_ptr(),
                        P, stream), "hist kernel")
    return out


def unpack_rows(rec: torch.Tensor, num_features: int, itemsize: int):
    """(g, h, valid, bins) of records (..., 128) uint8; bins as int64."""
    g = rec[..., 0:4].contiguous().view(torch.float32)[..., 0]
    h = rec[..., 4:8].contiguous().view(torch.float32)[..., 0]
    valid = rec[..., 8] == 1
    F = num_features
    if itemsize == 1:
        bins = rec[..., 9:9 + F].to(torch.int64)
    else:
        lo = rec[..., 9:9 + 2 * F:2].to(torch.int64)
        hi = rec[..., 10:10 + 2 * F:2].to(torch.int64)
        bins = lo | (hi << 8)
    return g, h, valid, bins


def hist_tiles_plain(rec, src, tile_leaf, P, B, F, itemsize):
    """The plain PyTorch version of K1: gather the planned tiles, then one
    ``index_add_`` of (g*valid, h*valid, valid) into flat (leaf, f, bin)
    cells.  Rows that add nothing go to one sentinel cell, sliced off.

    The sums run in float64 and round to fp32 once, so the result barely
    depends on the order of the adds (``index_add_`` on CUDA adds in no
    fixed order): at 10M rows a fp32 sum in arbitrary order can drift past
    the comparison tolerance on its own."""
    T = TILE_ROWS
    n_in = rec.shape[0] // T
    src = src.to(torch.int64)
    live = src >= 0
    tiles = rec.view(n_in, T, REC_WB)[src.clamp(0, n_in - 1)]
    g, h, valid, bins = unpack_rows(tiles, F, itemsize)    # (n_sel, T[, F])
    valid = valid & live[:, None]
    w = valid.to(torch.float32)
    vals = torch.stack([g * w, h * w, w], dim=-1).to(torch.float64)
    dead = P * F * B
    cell = ((tile_leaf.to(torch.int64)[:, None, None] * F
             + torch.arange(F, device=rec.device)) * B + bins)
    cell = torch.where(valid[..., None] & (bins < B), cell, dead)
    out = torch.zeros((dead + 1, 3), dtype=torch.float64, device=rec.device)
    out.index_add_(0, cell.reshape(-1),
                   vals[:, :, None, :].expand(-1, -1, F, -1).reshape(-1, 3))
    return (out[:dead].to(torch.float32).view(P, F, B, 3)
            .permute(0, 3, 1, 2).contiguous())
