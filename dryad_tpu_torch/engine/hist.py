"""K1: leaf-segmented histograms of planned 512-row tiles.

Replaces the TPU kernel ``dryad_tpu/engine/pallas_hist.py::_hist_kernel``
(launched by ``_hist_tiles``).  It computes the same function, not the
TPU's mechanics: no one-hot product, no bf16 limb split, no feature-major
transpose.  The result is (P, 3, F, B) f32: per leaf the sums of g, h and
1 over the live rows per (feature, bin).  Every leaf in ``[0, P)`` is
written; a leaf without live rows is zero.  ``tile_leaf`` (one entry per
plan tile) names each tile's output leaf and is non-decreasing.

Two modes share one kernel source (``csrc/hist.cu``) and its accumulation:

* layout mode, ``hist_tiles`` (the wired path): a record buffer ``rec``
  (n_tiles_in*512, 128) uint8 in the layout format of ``leafperm`` (g f32
  at byte 0, h f32 at 4, valid flag at 8, bins from 9); ``src[i]`` is the
  source tile of plan tile i (-1 = dead).
* row mode, ``hist_rows`` (the legacy plan arm, and the root pass): a
  per-tree record table ``recs`` (N, 2 + ceil(F*itemsize/4)) int32 of
  words [g, h, bin bytes] (``tile_plan.make_records``) of any width, and a
  plan ``buf`` of row ids, where N marks an empty slot.

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
its plain version.  There is no fallback from one to the other.
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
# (row, feature) cells per index_add_ in the plain versions: bounds their
# scratch (an Epsilon-wide pass would otherwise expand to tens of GB)
_PLAIN_CELLS = 1 << 25


def supports(total_bins: int) -> bool:
    return int(total_bins) <= MAX_BINS


def _check_common(tile_leaf, num_cols, total_bins, itemsize, device):
    if not supports(total_bins):
        raise ValueError(f"total_bins={total_bins} exceeds the histogram "
                         f"kernel's cap of {MAX_BINS}")
    if itemsize not in (1, 2):
        raise ValueError(f"bin itemsize must be 1 or 2, got {itemsize}")
    if tile_leaf.dim() != 1 or tile_leaf.numel() == 0:
        raise ValueError("tile_leaf must be non-empty 1-D")
    if num_cols < 1:
        raise ValueError("num_cols must be >= 1")
    if tile_leaf.device != device:
        raise ValueError("all inputs must lie on one device")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")


def _check(rec, src, tile_leaf, num_cols, total_bins, num_features, itemsize):
    _check_common(tile_leaf, num_cols, total_bins, itemsize, rec.device)
    if 9 + num_features * itemsize > REC_WB:
        raise ValueError("feature bytes exceed the 128-byte record")
    if rec.dtype != torch.uint8 or rec.dim() != 2 or rec.shape[1] != REC_WB:
        raise ValueError(f"rec must be (n, {REC_WB}) uint8, got "
                         f"{tuple(rec.shape)} {rec.dtype}")
    if rec.shape[0] % TILE_ROWS:
        raise ValueError(f"rec rows {rec.shape[0]} are not a multiple of "
                         f"{TILE_ROWS}")
    if src.shape != tile_leaf.shape:
        raise ValueError("src and tile_leaf must be equal 1-D")
    if src.device != rec.device:
        raise ValueError("all inputs must lie on one device")


def record_words(num_features: int, itemsize: int) -> int:
    """Words of one row-mode record: g, h, then the bin bytes."""
    return 2 + -(-num_features * itemsize // 4)


def _check_rows(recs, buf, tile_leaf, num_cols, total_bins, num_features,
                itemsize):
    _check_common(tile_leaf, num_cols, total_bins, itemsize, recs.device)
    W = record_words(num_features, itemsize)
    if recs.dtype != torch.int32 or recs.dim() != 2 or recs.shape[1] != W:
        raise ValueError(f"recs must be (N, {W}) int32, got "
                         f"{tuple(recs.shape)} {recs.dtype}")
    if recs.shape[0] < 1 or recs.shape[0] >= 2 ** 31:
        raise ValueError("recs must hold between 1 and 2^31 - 1 rows")
    if buf.dim() != 1 or buf.numel() != tile_leaf.numel() * TILE_ROWS:
        raise ValueError(f"buf must hold {TILE_ROWS} slots per plan tile")
    if buf.device != recs.device:
        raise ValueError("all inputs must lie on one device")


def _plan_items(tile_leaf: torch.Tensor, P: int):
    """Work items of the CUDA kernel: runs of <= TILES_PER_ITEM consecutive
    plan tiles of one leaf.  Their count is data-dependent; ``n_items`` is
    its static bound (each leaf adds at most one partial item), so nothing
    is fetched here.  Returns (item_first, leaf_item_start, n_items)."""
    dev = tile_leaf.device
    n_sel = tile_leaf.numel()
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
    return item_first, leaf_item_start, n_items


def balanced_chunks(n: int, cap: int) -> tuple[int, int]:
    """(chunk, n_chunks): n split into balanced chunks of at most cap."""
    k = -(-n // max(1, cap))
    return -(-n // k), k


def _feature_chunks(F: int, B: int) -> tuple[int, int]:
    """(f_chunk, n_chunks): balanced feature chunks whose fp64 g/h + fp32
    count cells (20 B each) fit one block's histogram budget."""
    return balanced_chunks(F, _HIST_SMEM // (20 * B))


def hist_tiles(rec: torch.Tensor, src: torch.Tensor, tile_leaf: torch.Tensor,
               num_cols: int, total_bins: int, num_features: int,
               itemsize: int) -> torch.Tensor:
    """(P, 3, F, B) f32 histograms of the planned layout tiles (module
    doc, layout mode)."""
    P, B, F = int(num_cols), int(total_bins), int(num_features)
    _check(rec, src, tile_leaf, P, B, F, itemsize)
    if rec.device.type == "cpu":
        return hist_tiles_plain(rec, src, tile_leaf, P, B, F, itemsize)
    if not rec.is_contiguous():
        raise ValueError("rec must be contiguous")
    dev = rec.device
    src = src.to(torch.int32).contiguous()
    tile_leaf = tile_leaf.to(torch.int32).contiguous()
    item_first, leaf_item_start, n_items = _plan_items(tile_leaf, P)
    f_chunk, n_chunks = _feature_chunks(F, B)
    partials = torch.empty((n_items, 3, F, B), dtype=torch.float64,
                           device=dev)
    out = torch.empty((P, 3, F, B), dtype=torch.float32, device=dev)
    fn = cuda_build.lib("hist").dryad_hist_tiles
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.counts["hist"] += 1
    cuda_build.check(fn(rec.data_ptr(), src.data_ptr(), tile_leaf.data_ptr(),
                        item_first.data_ptr(), src.numel(), n_items,
                        partials.data_ptr(), F, B, int(itemsize), f_chunk,
                        n_chunks, leaf_item_start.data_ptr(), out.data_ptr(),
                        P, stream), "hist kernel")
    return out


def hist_rows(recs: torch.Tensor, buf: torch.Tensor,
              tile_leaf: torch.Tensor, num_cols: int, total_bins: int,
              num_features: int, itemsize: int) -> torch.Tensor:
    """(P, 3, F, B) f32 histograms of the planned rows (module doc, row
    mode).  Tiles without a live row are skipped."""
    P, B, F = int(num_cols), int(total_bins), int(num_features)
    _check_rows(recs, buf, tile_leaf, P, B, F, itemsize)
    if recs.device.type == "cpu":
        return hist_rows_plain(recs, buf, tile_leaf, P, B, F, itemsize)
    if not recs.is_contiguous():
        raise ValueError("recs must be contiguous")
    dev = recs.device
    N, W = recs.shape
    T = TILE_ROWS
    n_tiles = tile_leaf.numel()
    buf = buf.to(torch.int32).contiguous()
    live = (buf.view(n_tiles, T) < N).any(1)
    src = torch.where(live, torch.arange(n_tiles, device=dev), -1).to(
        torch.int32).contiguous()
    tile_leaf = tile_leaf.to(torch.int32).contiguous()
    item_first, leaf_item_start, n_items = _plan_items(tile_leaf, P)
    f_chunk, n_chunks = _feature_chunks(F, B)
    partials = torch.empty((n_items, 3, F, B), dtype=torch.float64,
                           device=dev)
    out = torch.empty((P, 3, F, B), dtype=torch.float32, device=dev)
    fn = cuda_build.lib("hist").dryad_hist_rows
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.counts["hist_rows"] += 1
    cuda_build.check(fn(recs.data_ptr(), W, N, buf.data_ptr(), src.data_ptr(),
                        tile_leaf.data_ptr(), item_first.data_ptr(), n_tiles,
                        n_items, partials.data_ptr(), F, B, int(itemsize),
                        f_chunk, n_chunks, leaf_item_start.data_ptr(),
                        out.data_ptr(), P, stream), "hist rows kernel")
    return out


def unpack_rows(rec: torch.Tensor, num_features: int, itemsize: int):
    """(g, h, valid, bins) of records (..., 128) uint8; bins as int64."""
    g = rec[..., 0:4].contiguous().view(torch.float32)[..., 0]
    h = rec[..., 4:8].contiguous().view(torch.float32)[..., 0]
    valid = rec[..., 8] == 1
    return g, h, valid, bin_bytes(rec, 9, 0, num_features, itemsize)


def bin_bytes(raw: torch.Tensor, at: int, f0: int, f1: int,
              itemsize: int) -> torch.Tensor:
    """Bins of features [f0, f1) as int64 from byte rows ``raw`` (..., n)
    uint8 whose bins start at byte ``at`` (little-endian u16 when
    ``itemsize`` is 2)."""
    if itemsize == 1:
        return raw[..., at + f0:at + f1].to(torch.int64)
    lo = raw[..., at + 2 * f0:at + 2 * f1:2].to(torch.int64)
    hi = raw[..., at + 2 * f0 + 1:at + 2 * f1 + 1:2].to(torch.int64)
    return lo | (hi << 8)


def plain_sums(leaf: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
               h: torch.Tensor, bins_of, P: int, F: int,
               B: int) -> torch.Tensor:
    """The plain PyTorch histogram, shared by the plain versions of K1 and
    K3: per row ``leaf`` (n,) in [0, P), live flag ``w`` (n,), weights g
    and h; ``bins_of(f0, f1)`` gives the (n, f1 - f0) int64 bins of a
    feature chunk.  One ``index_add_`` per chunk of (g, h, 1) into flat
    (leaf, feature, bin) cells; rows that add nothing go to one sentinel
    cell, sliced off.

    The sums run in float64 and round to fp32 once, so the result barely
    depends on the order of the adds (``index_add_`` on CUDA adds in no
    fixed order): at 10M rows a fp32 sum in arbitrary order can drift past
    the comparison tolerance on its own."""
    n = leaf.numel()
    dev = leaf.device
    dead = P * F * B
    leaf = leaf.to(torch.int64)
    vals = torch.stack([g.to(torch.float64), h.to(torch.float64),
                        torch.ones(n, dtype=torch.float64, device=dev)], -1)
    vals = vals * w.to(torch.float64)[:, None]
    out = torch.zeros((dead + 1, 3), dtype=torch.float64, device=dev)
    fc = max(1, _PLAIN_CELLS // max(n, 1))
    for f0 in range(0, F, fc):
        f1 = min(F, f0 + fc)
        bins = bins_of(f0, f1)
        cell = ((leaf[:, None] * F + torch.arange(f0, f1, device=dev)) * B
                + bins)
        cell = torch.where(w[:, None] & (bins < B), cell, dead)
        out.index_add_(0, cell.reshape(-1),
                       vals[:, None, :].expand(-1, f1 - f0, -1).reshape(-1, 3))
    return (out[:dead].to(torch.float32).view(P, F, B, 3)
            .permute(0, 3, 1, 2).contiguous())


def hist_tiles_plain(rec, src, tile_leaf, P, B, F, itemsize):
    """The plain PyTorch version of K1's layout mode: gather the planned
    tiles, then ``plain_sums``."""
    T = TILE_ROWS
    n_in = rec.shape[0] // T
    src = src.to(torch.int64)
    rows = rec.view(n_in, T, REC_WB)[src.clamp(0, n_in - 1)].view(-1, REC_WB)
    valid = (rows[:, 8] == 1) & (src >= 0).repeat_interleave(T)
    g = rows[:, 0:4].contiguous().view(torch.float32)[:, 0]
    h = rows[:, 4:8].contiguous().view(torch.float32)[:, 0]
    leaf = tile_leaf.to(torch.int64).repeat_interleave(T)
    return plain_sums(leaf, valid, g, h,
                      lambda f0, f1: bin_bytes(rows, 9, f0, f1, itemsize),
                      P, F, B)


def hist_rows_plain(recs, buf, tile_leaf, P, B, F, itemsize):
    """The plain PyTorch version of K1's row mode: gather the planned rows
    of the record table, then ``plain_sums``."""
    N = recs.shape[0]
    buf = buf.to(torch.int64)
    valid = buf < N
    rows = recs[buf.clamp(max=N - 1)]
    g = rows[:, 0].view(torch.float32)
    h = rows[:, 1].view(torch.float32)
    raw = rows.view(torch.uint8)
    leaf = tile_leaf.to(torch.int64).repeat_interleave(TILE_ROWS)
    return plain_sums(leaf, valid, g, h,
                      lambda f0, f1: bin_bytes(raw, 8, f0, f1, itemsize),
                      P, F, B)
