"""K1: leaf-segmented histograms of planned 512-row tiles.

Replaces the TPU kernel ``dryad_tpu/engine/pallas_hist.py::_hist_kernel``
(launched by ``_hist_tiles``).  It computes the same function, not the
TPU's mechanics: no one-hot product, no bf16 limb split, no feature-major
transpose.  The result is (P, 3, F, B) f32: per leaf the sums of g, h and
1 over the live rows per (feature, bin).  Every leaf in ``[0, P)`` is
written; a leaf without live rows is zero.  ``tile_leaf`` (one entry per
plan tile) names each tile's output leaf and is non-decreasing.

Two modes share one kernel source (``csrc/hist.cu``) and its arithmetic
(``csrc/hist_accum.cuh``):

* layout mode, ``hist_tiles`` (the wired path): a record buffer ``rec``
  (n_tiles_in*512, 128) uint8 in the layout format of ``leafperm`` (g f32
  at byte 0, h f32 at 4, valid flag at 8, bins from 9); ``src[i]`` is the
  source tile of plan tile i (-1 = dead).
* row mode, ``hist_rows`` (the legacy plan arm, and the root pass): a
  per-tree record table ``recs`` (N, 2 + ceil(F*itemsize/4)) int32 of
  words [g, h, bin bytes] (``make_records``) of any width, and a
  plan ``buf`` of row ids, where N marks an empty slot.

Fixed-point sums.  The grower picks one shift per tree for g and one for h
(``fixed_point_shift``): the (2,) int32 ``shift`` s = 62 - k - e for
N <= 2^k rows and max|x| < 2^e, so N * max|x| * 2^s <= 2^62 and no cell
can overflow.  Every row adds rint(x * 2^s) to an int64 cell;
each cell is rounded once to fp32 and scaled by 2^-s.  Integer sums are
exact, so the result does not depend on the order of the adds: the kernels
add with atomics, in no fixed order, and still equal each other (K1's two
modes and K3, ``hist_nat``) and their plain versions bit for bit.  The
quantisation error is at most count * 2^-(s+1) per cell, nonzero only for
values below 2^-s: at 10M rows 2^-s is at most 2^-37 of max|x|, so a
logloss hessian (max 0.25) is kept to 2^-39, about 1.8e-12.  A non-finite g
or h is refused where the shift is chosen (a device-side assert on the
card, RuntimeError on the CPU): an integer cell has no NaN.

What bounds the kernels on the H100 is the shared-memory atomic updates,
at least three per live (row, feature) pair (g, h and the count) plus a
high-word add for each of g and h that reaches past 32 bits, and the
latency of staging rows, not the bytes (``csrc/hist.cu``).

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
# the fixed point: cell sums stay within 2^FIXED_POINT_BITS.  SHIFT_MAX
# caps the shift of tiny or all-zero weights (2^-SHIFT_MAX stays a normal
# fp32)
FIXED_POINT_BITS = 62
SHIFT_MAX = 126
# (row, feature) cells per index_add_ in the plain versions: bounds their
# scratch (an Epsilon-wide pass would otherwise expand to tens of GB)
_PLAIN_CELLS = 1 << 25


def fixed_point_shift(g: torch.Tensor, h: torch.Tensor,
                      num_rows: int | None = None) -> torch.Tensor:
    """The tree's (2,) int32 fixed-point shifts [s_g, s_h], on g's device:
    s = 62 - k - e with N <= 2^k and max|x| < 2^e, so that
    N * max|x| * 2^s <= 2^62; capped at ``SHIFT_MAX``, which an all-zero
    weight gets.  ``num_rows`` (N) defaults to g's length.  Nothing is
    fetched: a non-finite weight fails a device-side assert."""
    n = g.numel() if num_rows is None else int(num_rows)
    return shift_of_max(weight_max(g, h), n)


def weight_max(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """(2,) f32 [max|g|, max|h|], zeros for no rows; a non-finite weight
    fails a device-side assert."""
    if g.numel() == 0:
        m = torch.zeros(2, dtype=torch.float32, device=g.device)
    else:
        m = torch.stack([g.abs().amax(), h.abs().amax()]).to(torch.float32)
    torch._assert_async(torch.isfinite(m).all(),
                        "fixed_point_shift: g or h is not finite")
    return m


def shift_of_max(m: torch.Tensor, num_rows: int) -> torch.Tensor:
    """``fixed_point_shift`` of (2,) ``weight_max`` values over
    ``num_rows`` rows (a process group passes its global maxima and row
    count, so every rank sums in one shift)."""
    k = max(0, int(num_rows) - 1).bit_length()      # n <= 2^k
    _, e = torch.frexp(m)                           # m < 2^e
    s = torch.where(m > 0, FIXED_POINT_BITS - k - e.to(torch.int64),
                    SHIFT_MAX)
    return s.clamp(max=SHIFT_MAX).to(torch.int32)


def pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e as float32, exact for integer e in [-126, 127]."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def quantize(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """rint(x * 2^s) as int64, rounding half to even as ``__float2ll_rn``
    does; the product is exact (a power-of-two scaling in fp32)."""
    return torch.round(x.to(torch.float32) * pow2(s)).to(torch.int64)


def sums_to_float(acc: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """(P, 3, F, B) int64 sums -> f32: each rounded once to nearest, g and
    h then scaled by 2^-s (exact).  Bitwise the kernels' own conversion
    pass (``hist_out_kernel``)."""
    out = acc.to(torch.float32)
    out[:, 0] *= pow2(-shift[0])
    out[:, 1] *= pow2(-shift[1])
    return out


def finish(acc: torch.Tensor, shift: torch.Tensor, reduce=None
           ) -> torch.Tensor:
    """The int64 sums -> f32 histograms, through ``reduce(acc)`` first when
    given (a process group's sum over ranks, or this rank's reduced
    feature slice: ``engine/distributed.reduce_hist``)."""
    if reduce is not None:
        acc = reduce(acc)
    return sums_to_float(acc, shift)


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


def check_shift(shift, device):
    if (shift.dtype != torch.int32 or tuple(shift.shape) != (2,)
            or shift.device != device):
        raise ValueError("shift must be the tree's (2,) int32 fixed-point "
                         "shifts on the inputs' device (fixed_point_shift)")


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


def make_records(Xb: torch.Tensor, g: torch.Tensor,
                 h: torch.Tensor) -> torch.Tensor:
    """Per-tree (N, 2 + ceil(F*itemsize/4)) int32 record table
    [g, h, bin words]: the bits of g and h, then the bins' little-endian
    bytes (u16 bins as 2-byte units), padded to whole words.  g/h do not
    change within a tree, so every level reads rows from this one table."""
    N, F = Xb.shape
    isz = 1 if Xb.dtype == torch.uint8 else 2    # leafperm.bin_itemsize
    W = record_words(F, isz)
    xb = Xb if isz == 1 else Xb.to(torch.int16)
    rec = torch.zeros((N, W), dtype=torch.int32, device=Xb.device)
    rec[:, 0] = g.to(torch.float32).view(torch.int32)
    rec[:, 1] = h.to(torch.float32).view(torch.int32)
    rec.view(torch.uint8)[:, 8:8 + F * isz] = (
        xb.contiguous().view(torch.uint8).view(N, F * isz))
    return rec


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


def _outputs(P, F, B, dev, reduce):
    """A kernel's zeroed (P, 3, F, B) int64 accumulator, its f32 output
    (None under ``reduce``: the launch then only accumulates) and its
    one-word scratch (the plan tiles in use)."""
    return (torch.zeros((P, 3, F, B), dtype=torch.int64, device=dev),
            None if reduce is not None else
            torch.empty((P, 3, F, B), dtype=torch.float32, device=dev),
            torch.empty(1, dtype=torch.int32, device=dev))


def out_ptr(out) -> int | None:
    """A kernel's output pointer: NULL (accumulate only) for None."""
    return None if out is None else out.data_ptr()


def hist_tiles(rec: torch.Tensor, src: torch.Tensor, tile_leaf: torch.Tensor,
               num_cols: int, total_bins: int, num_features: int,
               itemsize: int, shift: torch.Tensor, *,
               reduce=None) -> torch.Tensor:
    """(P, 3, F, B) f32 histograms of the planned layout tiles (module
    doc, layout mode), with the tree's fixed-point ``shift``.  Under
    ``reduce`` the launch only accumulates, and the int64 sums go through
    ``finish(acc, shift, reduce)``."""
    P, B, F = int(num_cols), int(total_bins), int(num_features)
    _check(rec, src, tile_leaf, P, B, F, itemsize)
    check_shift(shift, rec.device)
    with cuda_build.boundary("hist_tiles", rec, src, tile_leaf):
        if rec.device.type == "cpu":
            return hist_tiles_plain(rec, src, tile_leaf, P, B, F, itemsize,
                                    shift, reduce)
        if not rec.is_contiguous():
            raise ValueError("rec must be contiguous")
        dev = rec.device
        src = src.to(torch.int32).contiguous()
        tile_leaf = tile_leaf.to(torch.int32).contiguous()
        acc, out, n_used = _outputs(P, F, B, dev, reduce)
        cuda_build.launch_hist(
            "hist", cuda_build.lib("hist").dryad_hist_tiles, dev,
            rec.data_ptr(), src.data_ptr(), tile_leaf.data_ptr(),
            src.numel(), n_used.data_ptr(), acc.data_ptr(), F, B,
            int(itemsize), shift.data_ptr(), out_ptr(out), P)
        return out if out is not None else finish(acc, shift, reduce)


def hist_rows(recs: torch.Tensor, buf: torch.Tensor,
              tile_leaf: torch.Tensor, num_cols: int, total_bins: int,
              num_features: int, itemsize: int,
              shift: torch.Tensor, *, reduce=None) -> torch.Tensor:
    """(P, 3, F, B) f32 histograms of the planned rows (module doc, row
    mode), with the tree's fixed-point ``shift``.  Tiles without a live
    row are skipped.  ``reduce`` as in ``hist_tiles``."""
    P, B, F = int(num_cols), int(total_bins), int(num_features)
    _check_rows(recs, buf, tile_leaf, P, B, F, itemsize)
    check_shift(shift, recs.device)
    with cuda_build.boundary("hist_rows", recs, buf, tile_leaf):
        if recs.device.type == "cpu":
            return hist_rows_plain(recs, buf, tile_leaf, P, B, F, itemsize,
                                   shift, reduce)
        if not recs.is_contiguous():
            raise ValueError("recs must be contiguous")
        dev = recs.device
        N, W = recs.shape
        n_tiles = tile_leaf.numel()
        buf = buf.to(torch.int32).contiguous()
        tile_leaf = tile_leaf.to(torch.int32).contiguous()
        # the kernel marks the plan tiles with a live row here
        src = torch.empty(n_tiles, dtype=torch.int32, device=dev)
        acc, out, n_used = _outputs(P, F, B, dev, reduce)
        cuda_build.launch_hist(
            "hist_rows", cuda_build.lib("hist").dryad_hist_rows, dev,
            recs.data_ptr(), W, N, buf.data_ptr(), src.data_ptr(),
            tile_leaf.data_ptr(), n_tiles, n_used.data_ptr(),
            acc.data_ptr(), F, B, int(itemsize), shift.data_ptr(),
            out_ptr(out), P)
        return out if out is not None else finish(acc, shift, reduce)


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


def add_cells(acc: torch.Tensor, leaf: torch.Tensor, w: torch.Tensor,
              g: torch.Tensor, h: torch.Tensor, bins_of, F: int, B: int,
              shift: torch.Tensor) -> torch.Tensor:
    """Add rows into ``acc`` (P * F * B, 3) int64, the flat (leaf,
    feature, bin) cells, in place: per row ``leaf`` (n,), live flag ``w``
    (n,) and weights g and h; ``bins_of(f0, f1)`` gives the (n, f1 - f0)
    int64 bins of a feature chunk.  A live pair with a bin below B adds
    rint(g 2^s_g), rint(h 2^s_h) and 1 (``quantize`` with the tree's
    ``shift``, as the kernels do); every other pair adds zeros to a cell
    of its own row, so no shared dump cell serialises the card's atomics.
    One int64 ``index_add_`` per feature chunk, exact in any order on the
    CPU and the card alike."""
    n = leaf.numel()
    dev = leaf.device
    P = acc.shape[0] // (F * B)
    leaf = leaf.to(torch.int64).clamp(0, P - 1)
    vals = torch.stack([quantize(g, shift[0]), quantize(h, shift[1]),
                        torch.ones(n, dtype=torch.int64, device=dev)], -1)
    fc = max(1, _PLAIN_CELLS // max(n, 1))
    for f0 in range(0, F, fc):
        f1 = min(F, f0 + fc)
        bins = bins_of(f0, f1)
        live = w[:, None] & (bins < B)
        cell = ((leaf[:, None] * F + torch.arange(f0, f1, device=dev)) * B
                + bins.clamp(max=B - 1))
        acc.index_add_(0, cell.reshape(-1),
                       torch.where(live[..., None], vals[:, None, :], 0)
                       .reshape(-1, 3))
    return acc


def cells_to_hist(acc: torch.Tensor, P: int, F: int, B: int
                  ) -> torch.Tensor:
    """``add_cells``' flat cells -> the (P, 3, F, B) int64 sums."""
    return acc.view(P, F, B, 3).permute(0, 3, 1, 2).contiguous()


def plain_sums(leaf: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
               h: torch.Tensor, bins_of, P: int, F: int, B: int,
               shift: torch.Tensor, reduce=None) -> torch.Tensor:
    """The plain PyTorch histogram, shared by the plain versions of K1 and
    K3: ``add_cells`` of the rows (``leaf`` in [0, P)), then the (P, 3, F,
    B) int64 sums through ``finish`` (and ``reduce``)."""
    acc = torch.zeros((P * F * B, 3), dtype=torch.int64, device=leaf.device)
    add_cells(acc, leaf, w, g, h, bins_of, F, B, shift)
    return finish(cells_to_hist(acc, P, F, B), shift, reduce)


def hist_tiles_plain(rec, src, tile_leaf, P, B, F, itemsize, shift,
                     reduce=None):
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
                      P, F, B, shift, reduce)


def hist_rows_plain(recs, buf, tile_leaf, P, B, F, itemsize, shift,
                    reduce=None):
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
                      P, F, B, shift, reduce)
