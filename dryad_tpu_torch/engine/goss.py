"""Gradient-based one-side sampling (GOSS) on the device.

The counterparts of ``dryad_tpu/engine/train.py``'s ``_goss_uniform_dev``
and ``_goss_body``.  Each iteration keeps every row whose gradient
magnitude reaches the ``goss_top_rate`` quantile (ties at the threshold
included), picks each other row with the probability that leaves
``goss_other_rate * N`` of them on average, and amplifies the picked rows'
g and h by ``(1 - top) / other`` so that histogram sums stay unbiased.
The selection replaces the bag: it gates the histograms, while every row
is still routed.

The uniforms are a murmur3 finalizer of (seed, iteration, row id), drawn on
the device; ``loop_state.goss_uniform`` is the numpy copy.  Torch's uint32
arithmetic is thin, so the hash runs in int64 on values below 2^32: each
32-bit product is split into 16-bit halves so that nothing overflows, and
every step is reduced modulo 2^32.

Under a process group (``group``) each rank draws the uniforms of its own
global row ids, so its slice is the single process's, and the selection's
two cross-row quantities come from the group: the threshold, the
``top_n``-th largest ``|g|`` over every rank's rows, by an exact radix
select (``distributed.group_order_statistic``: four all-reduces of 256
counts, 2 KB each), and the number of top rows, a SUM all-reduce.  Every
rank's mask and amplified g and h are then the single process's slice bit
for bit, and a rank without rows in the bag still enters both
collectives.

``|g|`` is a correctly rounded float32 root (``correct_sqrt``), as numpy
and XLA give it.  Rows whose sums of squares sit one ulp apart must keep
roots that order them as the reference's do, since one ulp moves a row
across the threshold.
"""

from __future__ import annotations

import torch

from dryad_tpu_torch.engine import distributed as _dist
from dryad_tpu_torch.engine.loop_state import (
    GOSS_GOLDEN,
    GOSS_M1,
    GOSS_M2,
    goss_key,
)
from dryad_tpu_torch.objectives import row_sum

_U32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32) and a u32 constant,
    with every intermediate below 2^49."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def goss_uniform_dev(seed: int, iteration: int, num_rows: int,
                     device, row_offset: int = 0) -> torch.Tensor:
    """(N,) f32 uniforms in [0, 1) of one iteration for the global rows
    ``row_offset .. row_offset + N``, drawn on ``device``, bitwise those
    rows of ``loop_state.goss_uniform``."""
    x = torch.arange(row_offset, row_offset + num_rows, dtype=torch.int64,
                     device=device)
    x = _mul32(x, GOSS_GOLDEN) ^ goss_key(seed, iteration)
    x ^= x >> 16
    x = _mul32(x, GOSS_M1)
    x ^= x >> 13
    x = _mul32(x, GOSS_M2)
    x ^= x >> 16
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def correct_sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root of float32 ``x`` on every
    device: a float64 root, rounded once to float32 (53 bits are at least
    2 x 24 + 2, so the double rounding gives the correctly rounded root).
    ``torch.sqrt`` of float32 on some CPU builds is one ulp off for a
    sizable share of inputs."""
    return torch.sqrt(x.double()).float()


def top_threshold(absg: torch.Tensor, top_n: int) -> torch.Tensor:
    """The ``top_n``-th largest of ``absg``, from one full sort: the
    selection's one sort an iteration (``engine/probes.py`` times it)."""
    return torch.sort(absg).values[absg.shape[0] - top_n]


def goss_select(p, N: int, g_all: torch.Tensor, h_all: torch.Tensor,
                u: torch.Tensor, valid: torch.Tensor, group=None):
    """(g, h, mask): the amplified (n, K) g and h and the (n,) row mask of
    this process's n rows; ``N`` is the row count of the whole selection
    (every rank's, under ``group``).  ``valid`` (n,) bool excludes rows
    that must never compete (they take -1 and can never reach the
    threshold).  ``|g|`` is ``sqrt`` of the sum of squares over the K
    columns, added column by column, the order XLA reduces a short row
    in; at K = 1 that is ``sqrt(g * g)``, rounded correctly
    (``correct_sqrt``).  The threshold is the ``top_n``-th largest value:
    of a full sort, or of the group's radix select."""
    absg = correct_sqrt(row_sum(g_all * g_all)[:, 0])
    absg = torch.where(valid, absg, -1.0)
    top_n = max(1, int(round(p.goss_top_rate * N)))
    if group is None:
        thr = top_threshold(absg, top_n)
    else:
        thr = _dist.group_order_statistic(absg, N - top_n, group,
                                          what="goss")
    is_top = valid & (absg >= thr)
    n_top = is_top.sum(dtype=torch.int32)
    if group is not None:
        n_top = group.all_reduce(n_top.reshape(1).to(torch.int64),
                                 what="goss")[0].to(torch.int32)
    p_pick = torch.clamp(
        torch.tensor(float(p.goss_other_rate * N), dtype=torch.float32,
                     device=g_all.device)
        / torch.clamp(N - n_top, min=1).to(torch.float32), max=1.0)
    picked = valid & ~is_top & (u < p_pick)
    amp = torch.tensor((1.0 - p.goss_top_rate) / p.goss_other_rate,
                       dtype=torch.float32, device=g_all.device)
    w = torch.where(picked, amp, 1.0)[:, None]
    return g_all * w, h_all * w, is_top | picked


def goss_columns(p, iteration: int, gh: list, valid: torch.Tensor,
                 group=None):
    """One iteration's GOSS on the loop's K (g, h) column pairs: returns
    (the amplified pairs, each contiguous, and the (n,) row mask that
    replaces the bag).  Under ``group`` the selection spans every rank's
    rows (module doc)."""
    n = valid.shape[0]
    N, offset = ((n, 0) if group is None
                 else (group.global_rows, group.row_offset))
    g_all = torch.stack([g for g, _ in gh], 1)
    h_all = torch.stack([h for _, h in gh], 1)
    u = goss_uniform_dev(p.seed, iteration, n, valid.device, offset)
    g_all, h_all, mask = goss_select(p, N, g_all, h_all, u, valid, group)
    return ([(g_all[:, k].contiguous(), h_all[:, k].contiguous())
             for k in range(len(gh))], mask)
