"""Data-parallel training over a ``torch.distributed`` process group.

The counterpart of ``dryad_tpu/engine/distributed.py``.  The reference is
one process driving a device mesh under ``shard_map``; the port follows
the PyTorch idiom of one process per rank.  Each rank holds its own
contiguous row range (in rank order, of any length: no padding), builds
its local histograms (K1/K3) and moves its local rows (K2), and one
collective per histogram pass makes every rank see the same histograms,
so every rank grows the same trees.

Exactness.  Every histogram is an int64 fixed-point sum in one shift per
tree (``hist.fixed_point_shift``), and ``global_shift`` picks that shift
from the group's global maxima and row count.  A rank's kernel therefore
only accumulates (``reduce=`` on each histogram entry point), the int64
sums are added across ranks (exact in any order), and then converted to
f32 once, as a single process converts its own.  N ranks equal one
process bit for bit, by construction.

Two arms (``config.hist_reduce_resolved``):

* "fused": one int64 SUM all-reduce of the whole (P, 3, F, B) stack of
  each pass; every rank runs the full split scan.
* "feature": each level's pass is reduce-scattered over the zero-padded
  feature axis, so a rank receives only the Fs = ceil(F / n) features it
  owns (``feature_slice_width``), fully summed; it scans its slice
  (``split.find_best_split_sliced``), and one all-gather of packed best-
  split records per level (``combine_best_splits``) gives every rank the
  fused scan's winner.  The root stays fused: its totals read feature 0,
  and it is one slot.

``RowGroup`` carries the group down to every histogram entry point as the
keyword ``group`` (the reference's ``axis_name``); ``group=None`` is the
single-process program, unchanged.  Under the gloo backend (CPU processes,
or several ranks sharing one card) tensors on a card go through explicit
host copies for ``reduce_scatter`` and ``all_gather``, which gloo takes
only on the CPU; ``all_reduce`` takes them as they are.  NCCL never takes
the host path, and nothing falls back on its own.

Every collective runs under the process group's timeout (``dryad_tpu_torch
.distributed.initialize``), so a rank that stops fails the others instead
of hanging them.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch
import torch.distributed as dist

from dryad_tpu_torch.engine import hist as _hist
from dryad_tpu_torch.engine.split import (
    LOCAL_SPLIT_WORDS,
    combine_local_splits,
    find_best_split_sliced,
    pack_local_split,
)


class RowGroup:
    """A process group and this rank's place in it: ``rank``, ``world``,
    ``row_offset`` (the first global row this rank holds),
    ``global_rows`` and ``max_rank_rows`` (the most rows any rank holds:
    a gate on local rows reads it, so every rank decides alike).
    ``stats[what][kind]`` counts the bytes each kind of collective
    delivers to a rank (an all-reduce its whole buffer, a reduce-scatter
    this rank's block, an all-gather every rank's part) and
    ``stats[what]["calls"]`` the calls, by purpose ("hist": the histogram
    passes, "splits": the feature arm's combine, "shift": the fixed-point
    shift, "goss": GOSS's threshold and top count, "renew": the leaf
    renewal's gathered residuals, "rank_plan": lambdarank's padded width,
    "mapper": the bin mappers' digests, "setup": rows, labels and flags),
    and ``collective_host_ms`` the host's time inside them.  With
    ``time_collectives`` each collective on a card is also bracketed by
    CUDA events (``collective_ms``)."""

    def __init__(self, pg, *, row_offset: int, global_rows: int,
                 device: torch.device, time_collectives: bool = False):
        self.pg = pg
        self.rank = dist.get_rank(pg)
        self.world = dist.get_world_size(pg)
        self.backend = str(dist.get_backend(pg))
        # gloo takes card tensors only for all_reduce and broadcast
        self.host_staged = self.backend == "gloo"
        self.row_offset = int(row_offset)
        self.global_rows = int(global_rows)
        self.max_rank_rows = int(global_rows)
        # where host arrays travel: the card under NCCL, else the CPU
        self.comm_device = (device if self.backend == "nccl"
                            else torch.device("cpu"))
        self.time_collectives = bool(time_collectives)
        self._events: list = []
        self.reset_stats()

    @classmethod
    def build(cls, num_rows: int, pg=None, *, device: torch.device,
              time_collectives: bool = False) -> "RowGroup":
        """The group over the default (or given) process group, with the
        row offsets taken from every rank's ``num_rows`` in rank order;
        ``device`` is this rank's (its card under NCCL)."""
        grp = cls(pg, row_offset=0, global_rows=0, device=device,
                  time_collectives=time_collectives)
        counts = [int(c[0]) for c in all_gather_host(
            np.array([num_rows], np.int64), grp)]
        grp.row_offset = sum(counts[:grp.rank])
        grp.global_rows = sum(counts)
        grp.max_rank_rows = max(counts)
        grp.reset_stats()
        return grp

    def reset_stats(self) -> None:
        self.stats: dict[str, dict[str, int]] = {}
        self._events = []
        self._host_s: dict[str, float] = {}

    def collective_host_ms(self, what: str | None = None) -> float:
        """The host's milliseconds inside the collectives (of purpose
        ``what``, or all) since the last ``reset_stats``: issuing them, and
        waiting where the backend makes the host wait."""
        return 1e3 * sum(v for w, v in self._host_s.items()
                         if what in (None, w))

    def collective_ms(self, what: str | None = None) -> float:
        """Milliseconds inside the timed collectives (of purpose ``what``,
        or all) since the last ``reset_stats``; synchronises with the
        card."""
        ev = [(a, b) for w, a, b in self._events if what in (None, w)]
        if not ev:
            return 0.0
        ev[-1][1].synchronize()
        return float(sum(a.elapsed_time(b) for a, b in ev))

    def _run(self, what: str, kind: str, nbytes: int, dev: torch.device,
             fn):
        st = self.stats.setdefault(what, {"calls": 0})
        st[kind] = st.get(kind, 0) + int(nbytes)
        st["calls"] += 1
        t0 = time.perf_counter()
        if not (self.time_collectives and dev.type == "cuda"):
            out = fn()
        else:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            self._events.append((what, a, b))
        self._host_s[what] = (self._host_s.get(what, 0.0)
                              + time.perf_counter() - t0)
        return out

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM,
                   what: str = "setup") -> torch.Tensor:
        """In place, and returned."""
        self._run(what, "all_reduce_bytes", t.numel() * t.element_size(),
                  t.device, lambda: dist.all_reduce(t, op=op, group=self.pg))
        return t

    def reduce_scatter(self, t: torch.Tensor,
                       what: str = "hist") -> torch.Tensor:
        """t (world * m, ...) -> this rank's (m, ...) block of the sum."""
        dev = t.device

        def run():
            src = t.cpu() if self.host_staged else t
            parts = list(src.chunk(self.world))
            out = torch.empty_like(parts[0])
            dist.reduce_scatter(out, parts, group=self.pg)
            return out.to(dev)

        return self._run(what, "reduce_scatter_bytes",
                         t.numel() * t.element_size() // self.world, dev,
                         run)

    def all_gather(self, t: torch.Tensor,
                   what: str = "setup") -> torch.Tensor:
        """t (...) of equal shape on every rank -> (world, ...) in rank
        order."""
        dev = t.device

        def run():
            src = t.cpu() if self.host_staged else t.contiguous()
            parts = [torch.empty_like(src) for _ in range(self.world)]
            dist.all_gather(parts, src, group=self.pg)
            return torch.stack(parts).to(dev)

        return self._run(what, "all_gather_bytes",
                         t.numel() * t.element_size() * self.world, dev,
                         run)

    def barrier(self) -> None:
        self.all_reduce(torch.zeros(1, device=self.comm_device))


def all_gather_host(arr: np.ndarray, group: RowGroup,
                    what: str = "setup") -> list[np.ndarray]:
    """Every rank's numpy array (equal trailing shape, any length) in rank
    order; bools travel as uint8."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    is_bool = arr.dtype == np.bool_
    t = torch.from_numpy(arr.view(np.uint8) if is_bool else arr)
    got = all_gather_rows(t.to(group.comm_device), group, what,
                          concat=False)
    out = [o.cpu().numpy() for o in got]
    return [o.view(np.bool_) for o in out] if is_bool else out


def all_gather_rows(t: torch.Tensor, group: RowGroup, what: str,
                    concat: bool = True):
    """Every rank's rows of ``t`` (equal trailing shape, any length, on its
    device) in rank order: concatenated on ``t``'s device, or the list of
    parts with ``concat=False``.  Two all-gathers: the lengths, then the
    rows padded to the longest."""
    dev = t.device
    sizes = group.all_gather(torch.tensor([t.shape[0]], dtype=torch.int64,
                                          device=dev),
                             what=what).cpu()[:, 0].tolist()
    m = max(sizes)
    pad = torch.zeros((m,) + tuple(t.shape[1:]), dtype=t.dtype, device=dev)
    pad[:t.shape[0]] = t
    got = group.all_gather(pad, what=what)
    parts = [got[i, :n] for i, n in enumerate(sizes)]
    return torch.cat(parts) if concat else parts


def all_reduce_max_int(value: int, group: RowGroup, what: str) -> int:
    """The largest of every rank's host integer ``value``."""
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=group.comm_device)
    return int(group.all_reduce(t, dist.ReduceOp.MAX, what=what).item())


def ordered_key(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 in [0, 2^32) whose order is the floats' (-0.0 just
    below +0.0; no NaN)."""
    u = x.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)


def _key_to_f32(key: torch.Tensor) -> torch.Tensor:
    u = torch.where(key >= 0x80000000, key ^ 0x80000000, key ^ 0xFFFFFFFF)
    return torch.where(u >= 0x80000000, u - (1 << 32), u).to(
        torch.int32).view(torch.float32)


def group_order_statistic(x: torch.Tensor, rank_asc: int, group: RowGroup,
                          what: str) -> torch.Tensor:
    """The element at ascending position ``rank_asc`` (0-based) of the
    concatenation of every rank's f32 vector ``x``, exactly: a radix
    select over the floats' ordered bit patterns, four rounds of one
    byte, each one SUM all-reduce of 256 int64 counts (2 KB).  Every rank
    enters every round, rows or none; nothing is read back to the host.
    Returns a () f32 tensor on ``x``'s device, one of the elements bit
    for bit (a zero keeps its sign)."""
    dev = x.device
    key = ordered_key(x)
    prefix = torch.zeros((), dtype=torch.int64, device=dev)
    r = torch.tensor(int(rank_asc), dtype=torch.int64, device=dev)
    mask = 0
    for shift in (24, 16, 8, 0):
        digit = (key >> shift) & 0xFF
        live = (key & mask) == prefix
        counts = torch.zeros(257, dtype=torch.int64, device=dev)
        counts.scatter_add_(0, torch.where(live, digit, 256),
                            torch.ones_like(digit))
        counts = group.all_reduce(counts[:256].contiguous(), what=what)
        cum = torch.cumsum(counts, 0)
        d = torch.searchsorted(cum, r, right=True)
        r = r - torch.where(d > 0, cum[torch.clamp(d - 1, min=0)], 0)
        prefix = prefix | (d << shift)
        mask |= 0xFF << shift
    return _key_to_f32(prefix)


def check_same_mapper(mapper, group: RowGroup) -> None:
    """Raise ``ValueError`` on every rank when any rank's bin mapper
    differs from rank 0's (an all-gather of the SHA-256 digests of
    ``mapper.to_bytes()``): ranks that bin through different edges or
    bundles would grow different trees without a word."""
    mine = np.frombuffer(hashlib.sha256(mapper.to_bytes()).digest(),
                         np.uint8)
    got = all_gather_host(mine, group, what="mapper")
    bad = [r for r, d in enumerate(got) if not np.array_equal(d, got[0])]
    if bad:
        raise ValueError(
            f"the bin mapper of rank(s) {bad} differs from rank 0's: every "
            "rank must bin through one mapper (sketch it once, e.g. "
            "sketch_distributed, and pass mapper= to each rank's Dataset)")


def global_shift(g: torch.Tensor, h: torch.Tensor,
                 group: RowGroup | None, num_rows: int) -> torch.Tensor:
    """The tree's fixed-point shift: of this process's rows without a
    group, else of the group's MAX-reduced ``max|g|, max|h|`` over its
    global row count, so every rank sums in one shift."""
    if group is None:
        return _hist.fixed_point_shift(g, h, num_rows)
    m = group.all_reduce(_hist.weight_max(g, h), dist.ReduceOp.MAX,
                         what="shift")
    return _hist.shift_of_max(m, group.global_rows)


def feature_slice_width(num_features: int, n_ranks: int) -> int:
    """Features each rank owns on the feature arm: ceil(F / n); the tail
    is zero padding that no scan can pick."""
    return -(-num_features // max(n_ranks, 1))


def feature_shard_offset(group: RowGroup | None, num_features: int) -> int:
    """This rank's first owned global feature (0 without a group)."""
    if group is None:
        return 0
    return group.rank * feature_slice_width(num_features, group.world)


def feature_shard_slice(arr: torch.Tensor, group: RowGroup | None,
                        axis: int = 0) -> torch.Tensor:
    """This rank's owned features of a feature-indexed array, zero (False)
    past F; the whole array without a group."""
    if group is None:
        return arr
    F = arr.shape[axis]
    Fs = feature_slice_width(F, group.world)
    off = feature_shard_offset(group, F)
    take = arr.narrow(axis, min(off, F), max(0, min(Fs, F - off)))
    if take.shape[axis] == Fs:
        return take
    shape = list(arr.shape)
    shape[axis] = Fs - take.shape[axis]
    return torch.cat([take, torch.zeros(shape, dtype=arr.dtype,
                                        device=arr.device)], axis)


def reduce_hist(acc: torch.Tensor, group: RowGroup, mode: str
                ) -> torch.Tensor:
    """The cross-rank sum of a (P, 3, F, B) int64 accumulator: all of it
    ("fused", an in-place all-reduce) or this rank's (P, 3, Fs, B) owned
    slice ("feature", a reduce-scatter over the zero-padded feature
    axis)."""
    if mode == "fused":
        return group.all_reduce(acc, what="hist")
    P, _, F, B = acc.shape
    Fs = feature_slice_width(F, group.world)
    t = torch.zeros((Fs * group.world, P, 3, B), dtype=acc.dtype,
                    device=acc.device)
    t[:F] = acc.permute(2, 0, 1, 3)
    return group.reduce_scatter(t).permute(1, 2, 0, 3).contiguous()


def reducer(group: RowGroup | None, mode: str):
    """The ``reduce=`` hook of the histogram entry points (None without a
    group)."""
    if group is None:
        return None
    return lambda acc: reduce_hist(acc, group, mode)


def combine_best_splits(rec: dict, group: RowGroup, *, allow,
                        min_split_gain: float) -> dict:
    """Every rank's ``find_best_split_sliced`` record -> the fused scan's
    result on every rank: one all-gather of the packed words, with the
    raw categorical rows beside them when there are any."""
    words = pack_local_split(rec)
    cat = rec["cat_mask"]
    if cat is not None:
        words = torch.cat([words, cat.to(torch.int32)], -1)
    got = group.all_gather(words, what="splits")
    n8 = LOCAL_SPLIT_WORDS
    return combine_local_splits(
        got[..., :n8].contiguous(),
        None if cat is None else got[..., n8:] != 0,
        allow=allow, min_split_gain=min_split_gain)


class FeatureArm:
    """One tree's feature-arm state on this rank: the owned slice of the
    feature masks, and the sliced level scan with its combine."""

    def __init__(self, p, group: RowGroup, num_features: int, *,
                 feat_mask, learn_missing, is_cat_feat, bundled_mask,
                 monotone):
        self.p = p
        self.group = group
        self.F = int(num_features)
        self.width = feature_slice_width(self.F, group.world)
        self.offset = feature_shard_offset(group, self.F)
        self.learn_missing = learn_missing

        def cut(a):
            return None if a is None else feature_shard_slice(a, group)

        self.feat_mask = cut(feat_mask)
        self.is_cat_feat = cut(is_cat_feat)
        self.bundled_mask = cut(bundled_mask)
        self.monotone = cut(monotone)

    def slice_hist(self, h: torch.Tensor) -> torch.Tensor:
        """(..., 3, F, B) -> this rank's (..., 3, Fs, B)."""
        return feature_shard_slice(h, self.group, axis=h.dim() - 2)

    def best(self, hist, G, H, C, allow, lo=None, hi=None) -> dict:
        """The level scan over the owned slice, combined across ranks."""
        p = self.p
        rec = find_best_split_sliced(
            hist, G, H, C, feat_offset=self.offset,
            num_features_total=self.F, lambda_l2=p.lambda_l2,
            min_child_weight=p.min_child_weight,
            min_data_in_leaf=p.min_data_in_leaf, feat_mask=self.feat_mask,
            learn_missing=self.learn_missing, is_cat_feat=self.is_cat_feat,
            bundled_mask=self.bundled_mask, monotone=self.monotone, lo=lo,
            hi=hi)
        return combine_best_splits(rec, self.group, allow=allow,
                                   min_split_gain=p.min_split_gain)
