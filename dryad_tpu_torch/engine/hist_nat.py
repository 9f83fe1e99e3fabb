"""K3: the natural-order multi-slot histogram pass of the legacy plan arm.

The counterpart of the natural-order half of
``dryad_tpu/engine/pallas_hist.py`` (``natural_tiles``,
``nat_gate_admits``/``maybe_natural_tiles``, ``build_hist_small`` and
``build_hist_nat``, which launches the TPU kernel ``_nat_kernel``).  The
shallow levels of the legacy arm, with at most 16 candidate slots, read
every row once in natural order with its slot id: no sort, no plan, no
gather.

``natural_tiles`` is a feature-major (F, n_pad) copy of the bins (u8, or
u16 held as int16), zero-padded to whole 512-row tiles, so the kernel's
reads of one feature over consecutive rows are contiguous.  The grower
builds it once per tree, as the reference does.

The sums are the fixed-point integer sums of ``hist`` with the tree's
``shift`` (``hist.fixed_point_shift``), so K3 equals K1 bit for bit on the
same rows and slots whatever the order of the adds, and is within
count * 2^-(s+1) of the exact sum per cell.  What bounds the kernel on the
H100 is its shared-memory atomic updates, three to five per kept (row,
feature) pair (``csrc/hist_nat.cu``).  Each launch follows ``nat_plan``,
made here from the shapes and the card's limits: features and slots a
block, stage rows, the ring's depth and the grid; ``nat_blocks`` lists
the (features, slots, rows) each block takes.  The kernel stages with
bulk copies, so ``nat_tiles``, g, h and sel must each start 16-byte
aligned; the wrapper raises on one that does not.

On a CUDA tensor ``build_hist_nat`` launches ``csrc/hist_nat.cu``; on a CPU
tensor it runs ``build_hist_nat_plain``.  There is no fallback from one to
the other.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as nnf

from dryad_tpu_torch.engine import cuda_build, hist
from dryad_tpu_torch.engine.leafperm import bin_itemsize

NAT_SLOTS = 16
NAT_DROP = 31          # sel sentinel (any value >= NAT_SLOTS drops the row)
# the gate on the whole bin matrix, MB: the reference's default
# (pallas_hist._NAT_GATE_MB), a constant of the port
NAT_GATE_MB = 512


# the launch plan: consumer warps (warp 0 is the producer), the ring's
# stages, the bounds of a stage's rows (a multiple of 32: whole groups of
# a warp; at most 4096: a map entry holds the row in 12 bits)
NAT_CONSUMERS = 31
NAT_STAGES = 3
NAT_MIN_STAGE_ROWS = 512
NAT_MAX_STAGE_ROWS = 4096
# the ring's mbarriers and the consumer warps' maps (32 u16 each)
NAT_FIXED = 16 * NAT_STAGES + NAT_CONSUMERS * 32 * 2


def cell_stride(B: int) -> int:
    """Words of a feature's (or slot's) cells: B made odd (hist_nat.cu)."""
    return B | 1


def nat_smem(f_chunk: int, s_chunk: int, B: int, stage_rows: int,
             itemsize: int) -> int:
    """A K3 block's shared memory: the ring (per stage sel, g, h and each
    feature's bins 32 bytes apart), its barriers and maps, the cells."""
    stage = 12 * stage_rows + f_chunk * (stage_rows * itemsize + 32)
    return (NAT_STAGES * stage + NAT_FIXED
            + hist.CELL_BYTES * f_chunk * s_chunk * cell_stride(B))


@functools.lru_cache(maxsize=1024)
def nat_plan(num_rows: int, F: int, B: int, P: int, itemsize: int,
             optin: int, n_sm: int) -> dict:
    """K3's launch plan: every slot of as many features as fit beside a
    ring of 512-row stages, else one feature and slot groups; the stage
    then grows into what is left (up to 4096 rows); one block per SM over
    (feature chunk x slot group) x row ranges, at least one block a group.
    Raises when not one slot of one feature fits.  Memoised (the search
    is Python, once per shape): read the plan, do not change it."""
    def fits(fc, sc, R=NAT_MIN_STAGE_ROWS):
        return nat_smem(fc, sc, B, R, itemsize) <= optin

    if fits(1, P):
        cap = 1
        while cap < F and fits(cap + 1, P):
            cap += 1
        f_chunk, s_chunk = hist.balanced(F, cap), P
    else:
        cap = 0
        while cap < P and fits(1, cap + 1):
            cap += 1
        if cap == 0:
            raise ValueError(f"K3: not one slot of {B} bins fits {optin} "
                             "bytes of shared memory")
        f_chunk, s_chunk = 1, hist.balanced(P, cap)
    R = NAT_MAX_STAGE_ROWS
    while R > NAT_MIN_STAGE_ROWS and not fits(f_chunk, s_chunk, R):
        R -= 32
    n_fchunks = -(-F // f_chunk)
    n_groups = n_fchunks * -(-P // s_chunk)
    n_stages = max(1, -(-int(num_rows) // R))
    return {"f_chunk": f_chunk, "s_chunk": s_chunk, "stage_rows": R,
            "stages": NAT_STAGES, "n_fchunks": n_fchunks,
            "n_groups": n_groups,
            "grid": max(n_groups, min(n_sm, n_groups * n_stages)),
            "smem": nat_smem(f_chunk, s_chunk, B, R, itemsize)}


def nat_blocks(plan: dict, num_rows: int, F: int, P: int) -> list:
    """Per block of ``plan``: (first feature, features, first slot, slots,
    first row, end row), as ``nat_kernel`` derives them from its index."""
    R, G = plan["stage_rows"], plan["n_groups"]
    n_stages = -(-int(num_rows) // R)
    out = []
    for b in range(plan["grid"]):
        gi, rk = b % G, b // G
        nr = (plan["grid"] - gi + G - 1) // G
        st0, st1 = rk * n_stages // nr, (rk + 1) * n_stages // nr
        f0 = gi % plan["n_fchunks"] * plan["f_chunk"]
        s0 = gi // plan["n_fchunks"] * plan["s_chunk"]
        out.append((f0, min(plan["f_chunk"], F - f0), s0,
                    min(plan["s_chunk"], P - s0), st0 * R,
                    min(int(num_rows), st1 * R)))
    return out


def nat_gate_admits(num_rows: int, num_features: int, itemsize: int) -> bool:
    """The natural-order gate: the bin matrix is at most ``NAT_GATE_MB``."""
    return num_rows * num_features * itemsize <= NAT_GATE_MB * (1 << 20)


def natural_admits(total_bins: int, num_rows: int, num_features: int,
                   itemsize: int) -> bool:
    """Whether a level plan takes the natural-order pass: the kernels take
    the bins (``hist.supports``) and the gate admits the matrix."""
    return (hist.supports(total_bins)
            and nat_gate_admits(int(num_rows), num_features, itemsize))


def natural_tiles(Xb: torch.Tensor) -> torch.Tensor:
    """(F, n_pad) feature-major bins, n_pad the rows rounded up to whole
    512-row tiles (zero tail)."""
    N = Xb.shape[0]
    xb = Xb if bin_itemsize(Xb) == 1 else Xb.to(torch.int16)
    return nnf.pad(xb.t(), (0, (-N) % hist.TILE_ROWS)).contiguous()


def maybe_natural_tiles(Xb: torch.Tensor, total_bins: int,
                        gate_rows: int | None = None
                        ) -> torch.Tensor | None:
    """``natural_tiles`` when the gate admits the matrix, else None: no
    natural tiles past the kernels' bins cap (``hist.supports``), as the
    reference's gate returns none there.  The gate reads ``gate_rows`` rows
    when given (a process group passes its largest rank's, so every rank
    makes the same choice and runs the same level plan), else the
    matrix's own."""
    N, F = Xb.shape
    if not natural_admits(total_bins, N if gate_rows is None else gate_rows,
                          F, bin_itemsize(Xb)):
        return None
    return natural_tiles(Xb)


def build_hist_small(nat_tiles: torch.Tensor, g: torch.Tensor,
                     h: torch.Tensor, sel: torch.Tensor, num_cols: int,
                     total_bins: int, num_features: int,
                     shift: torch.Tensor, *, reduce=None) -> torch.Tensor:
    """(P, 3, F, B) via the natural-order pass for a level's smaller
    children: ``sel`` (N,) in [0, P], where P means "drop"; ``shift`` is
    the tree's (``hist.fixed_point_shift``); ``reduce`` as in
    ``build_hist_nat``."""
    P = int(num_cols)
    if P > NAT_SLOTS:
        raise ValueError(f"the natural-order pass holds at most {NAT_SLOTS} "
                         f"slots, got {P}")
    sel_nat = torch.where(sel >= P, NAT_DROP, sel)
    return build_hist_nat(nat_tiles, g, h, sel_nat, shift,
                          total_bins=total_bins,
                          num_features=num_features, num_cols=P,
                          reduce=reduce)


def _check(xt, g, h, sel, P, B, F):
    if not hist.supports(B):
        raise ValueError(f"total_bins={B} exceeds the histogram kernels' "
                         f"cap of {hist.MAX_BINS}")
    if not 1 <= P <= NAT_SLOTS:
        raise ValueError(f"num_cols must be in [1, {NAT_SLOTS}], got {P}")
    if xt.dtype not in (torch.uint8, torch.int16) or xt.dim() != 2:
        raise ValueError("nat_tiles must be (F, n_pad) uint8 or int16")
    N = g.shape[0]
    if xt.shape[0] != F or xt.shape[1] < N or xt.shape[1] % hist.TILE_ROWS:
        raise ValueError(f"nat_tiles {tuple(xt.shape)} do not cover {F} "
                         f"features x {N} rows in whole tiles")
    if h.shape != g.shape or sel.shape != g.shape or g.dim() != 1:
        raise ValueError("g, h and sel must be equal 1-D")
    if N >= 2 ** 31:
        raise ValueError("at most 2^31 - 1 rows")
    for t in (g, h, sel):
        if t.device != xt.device:
            raise ValueError("all inputs must lie on one device")
    if xt.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xt.device}")


def build_hist_nat(nat_tiles: torch.Tensor, g: torch.Tensor,
                   h: torch.Tensor, sel: torch.Tensor, shift: torch.Tensor,
                   *, total_bins: int,
                   num_features: int,
                   num_cols: int = NAT_SLOTS, reduce=None) -> torch.Tensor:
    """(num_cols, 3, F, B) f32 histograms from natural-order tiles: per
    slot the sums of g, h and 1 per (feature, bin) over the rows whose
    ``sel`` is that slot; a row with ``sel`` outside [0, num_cols) adds
    nothing, and the padded tail past ``g``'s rows is never read.
    ``shift`` is the tree's fixed-point shift.  Under ``reduce`` the
    launch only accumulates (``hist.finish``)."""
    P, B, F = int(num_cols), int(total_bins), int(num_features)
    _check(nat_tiles, g, h, sel, P, B, F)
    hist.check_shift(shift, nat_tiles.device)
    with cuda_build.boundary("hist_nat", nat_tiles, g, h, sel):
        if nat_tiles.device.type == "cpu":
            return build_hist_nat_plain(nat_tiles, g, h, sel, shift, P, B,
                                        F, reduce)
        if not nat_tiles.is_contiguous():
            raise ValueError("nat_tiles must be contiguous")
        dev = nat_tiles.device
        N = g.shape[0]
        n_pad = nat_tiles.shape[1]
        g = g.to(torch.float32).contiguous()
        h = h.to(torch.float32).contiguous()
        sel = sel.to(torch.int32).contiguous()
        hist.check_aligned("build_hist_nat", nat_tiles, g, h, sel)
        isz = nat_tiles.element_size()
        if n_pad * isz % 16 or n_pad < N:
            raise ValueError("build_hist_nat: each feature's row of "
                             "nat_tiles must hold every row in whole 16 "
                             "bytes (natural_tiles pads to 512-row tiles)")
        acc = torch.zeros((P, 3, F, B), dtype=torch.int64, device=dev)
        out = (None if reduce is not None else
               torch.empty((P, 3, F, B), dtype=torch.float32, device=dev))
        plan = nat_plan(N, F, B, P, isz, *cuda_build.device_limits(dev))
        cuda_build.launch_hist(
            "nat", cuda_build.lib("hist_nat").dryad_hist_nat, dev, plan,
            nat_tiles.data_ptr(), isz, n_pad, g.data_ptr(), h.data_ptr(),
            sel.data_ptr(), N, acc.data_ptr(), F, B, P, plan["f_chunk"],
            plan["s_chunk"], plan["stage_rows"], plan["grid"], plan["smem"],
            shift.data_ptr(), hist.out_ptr(out))
        return out if out is not None else hist.finish(acc, shift, reduce)


def build_hist_nat_plain(nat_tiles, g, h, sel, shift, P, B, F, reduce=None):
    """The plain PyTorch version of K3: ``hist.plain_sums`` over the rows
    in natural order, keyed by ``sel``."""
    N = g.shape[0]
    s = sel.to(torch.int64)
    keep = (s >= 0) & (s < P)

    def bins_of(f0, f1):                  # u16 held as int16: mask the sign
        return nat_tiles[f0:f1, :N].t().to(torch.int64) & 0xFFFF

    return hist.plain_sums(torch.where(keep, s, 0), keep, g, h, bins_of,
                           P, F, B, shift, reduce)
