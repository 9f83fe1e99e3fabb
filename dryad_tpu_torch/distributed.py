"""Data-parallel training over several processes, one rank each.

The counterpart of ``dryad_tpu/distributed.py``.  Every rank runs the same
script: ``initialize()`` joins the process group (NCCL on the card; under
``torchrun`` its environment gives the rank, the world size and the
address), ``host_row_range`` names the contiguous rows this rank reads,
``sketch_distributed`` gives every rank the same bin mapper from a keyed
sample of every rank's rows, and ``train_distributed`` trains, returning
the same booster on every rank, bit for bit the booster of one process on
all the rows (``engine/distributed.py``)::

    # torchrun --nproc_per_node=4 script.py
    import dryad_tpu_torch as dt
    from dryad_tpu_torch import distributed as dd

    dd.initialize()
    rank, world = torch.distributed.get_rank(), ...get_world_size()
    lo, hi = dd.host_row_range(n_total, rank, world)
    mapper = dd.sketch_distributed(X[lo:hi], n_total, lo)
    ds = dt.Dataset(X[lo:hi], y[lo:hi], mapper=mapper)
    booster = dd.train_distributed(params, ds, valid=valid_ds)

For ranking, ``query_row_range`` cuts the blocks at query boundaries
(each query whole on one rank) and ``rank_queries`` gives the rank's
``group=``.  A CSR set bins through the one mapper every rank shares
(``Dataset(None, y, csr=..., mapper=mapper)``, a ``BundledMapper`` where
the whole data bundles); training checks that every rank's mapper is the
same and raises ``ValueError`` naming the ranks that differ.  Every
training mode of one process runs over a group; a streamed set does not,
as in the reference.

The reference's mesh helpers (``make_mesh``, ``padded_rows``,
``shard_rows``, ``replicate``, ``global_mesh``) have no counterpart: each
rank holds its own rows, of any count, so nothing is padded or placed.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dryad_tpu_torch.data.streaming import keyed_uniform
from dryad_tpu_torch.engine.distributed import RowGroup, all_gather_host

DEFAULT_TIMEOUT_S = 600


def initialize(backend: Optional[str] = None,
               init_method: Optional[str] = None,
               rank: Optional[int] = None,
               world_size: Optional[int] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the default process group.  ``backend`` defaults to NCCL (a
    card is required: pass ``backend="gloo"`` for CPU processes);
    ``init_method``, ``rank`` and ``world_size`` default to torchrun's
    environment (``env://``, ``RANK``, ``WORLD_SIZE``).  Under NCCL the
    rank's card is ``LOCAL_RANK`` (default: the rank modulo the cards).
    Every collective then fails after ``timeout_s`` seconds instead of
    hanging."""
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize(): NCCL needs a CUDA device; pass "
                "backend='gloo' to train CPU processes")
        backend = "nccl"
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else int(world_size))
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=float(timeout_s)))


def host_row_range(num_rows: int, rank: int,
                   world_size: int) -> tuple[int, int]:
    """[start, stop) of the rows rank ``rank`` of ``world_size`` reads:
    contiguous blocks in rank order, balanced to within one row."""
    base, rem = divmod(int(num_rows), int(world_size))
    start = rank * base + min(rank, rem)
    return start, start + base + (1 if rank < rem else 0)


def query_row_range(query_offsets, rank: int,
                    world_size: int) -> tuple[int, int]:
    """[start, stop) of the rows rank ``rank`` of ``world_size`` reads for
    ranking: contiguous blocks in rank order, cut only at query
    boundaries (``query_offsets`` (Q + 1,), the LightGBM group
    convention's running sum), each cut at the boundary nearest the even
    row split (the earlier one on a tie), so no query straddles two ranks
    and the blocks are balanced by rows.  A lambdarank group needs it: a
    rank's lambdas read only its own documents (LightGBM's distributed
    ranking keeps each query on one machine too).  The rank's query sizes
    are ``np.diff`` of the offsets inside its block."""
    off = np.asarray(query_offsets, np.int64)
    n = int(off[-1])

    def cut(r: int) -> int:
        if r <= 0:
            return 0
        if r >= world_size:
            return n
        target = r * n / world_size
        i = int(np.searchsorted(off, target))
        lo = off[max(i - 1, 0)]
        hi = off[min(i, off.size - 1)]
        return int(lo if target - lo <= hi - target else hi)

    return cut(int(rank)), cut(int(rank) + 1)


def rank_queries(query_offsets, start: int, stop: int) -> np.ndarray:
    """The sizes of the queries inside rows [start, stop) of a
    ``query_row_range`` block: the ``group=`` of the rank's Dataset."""
    off = np.asarray(query_offsets, np.int64)
    inside = off[(off >= start) & (off <= stop)]
    return np.diff(inside)


def sketch_distributed(X_local: np.ndarray, total_rows: int,
                       row_offset: int, *, max_bins: int = 256,
                       categorical_features: Sequence[int] = (),
                       sample_rows: int = 1 << 20, seed: int = 0,
                       allgather=None):
    """The same bin mapper on every rank from its own rows: each rank keeps
    the rows whose keyed draw (``keyed_uniform`` of the global row id)
    falls under ``sample_rows / total_rows``, the samples are gathered in
    rank order, and the union is sketched, so the edges depend only on the
    rows, not on how they are split.  ``allgather(arr) -> [arr, ...]``
    exchanges the samples (default: the default process group)."""
    from dryad_tpu_torch.data.sketch import sketch_features

    n = X_local.shape[0]
    rate = min(1.0, sample_rows / max(total_rows, 1))
    keep = keyed_uniform(row_offset, n, seed) < rate
    local_sample = np.ascontiguousarray(X_local[keep], np.float32)
    if allgather is None:
        group = RowGroup(None, row_offset=row_offset, global_rows=total_rows,
                         device=_default_device())
        parts = all_gather_host(local_sample, group)
    else:
        parts = allgather(local_sample)
    return sketch_features(np.concatenate(parts, axis=0), max_bins=max_bins,
                           categorical_features=categorical_features)


def _default_device() -> torch.device:
    """This rank's card under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def train_distributed(params, data_local, valid=None, *, group=None,
                      device=None, **kw):
    """``dryad_tpu_torch.train`` over this rank's rows ``data_local`` (a
    Dataset binned through the mapper every rank shares) as one rank of
    the process group ``group`` (default: the default group; a
    ``RowGroup`` is taken as it is).  ``valid`` (a Dataset or a list) is
    whole on every rank.  ``device`` defaults to this rank's card (the
    current CUDA device); pass ``device="cpu"`` for CPU processes.  The
    other keywords go to ``train`` (callbacks, checkpoint_dir, resume,
    ...).  Returns the same booster on every rank."""
    from dryad_tpu_torch import resolve_device, train

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to train "
                "CPU processes")
        device = torch.device("cuda", torch.cuda.current_device())
    dev = resolve_device(device)
    if not isinstance(group, RowGroup):
        group = RowGroup.build(data_local.num_rows, group, device=dev)
    if valid is not None and not isinstance(valid, (list, tuple)):
        valid = [valid]
    return train(params, data_local, valid, group=group, device=dev, **kw)
