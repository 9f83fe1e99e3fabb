"""Scatter helpers for the reference's ``.at[idx].set(..., mode="drop")``.

JAX drops an update whose index is out of range; the level body uses that
as an idiom, sending updates it means to discard to index ``L``, ``L+1``
or ``M``.  ``index_put_`` would raise on such an index on the CPU and may
write out of bounds on CUDA.  These helpers map every out-of-range index
to one sentinel row appended past the end, scatter, and slice the
sentinel off.  No mask is fetched to the host.
"""

from __future__ import annotations

import torch


def _sentinel_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    idx = idx.to(torch.int64)
    return torch.where((idx >= 0) & (idx < n), idx, n)


def drop_set(arr: torch.Tensor, idx: torch.Tensor,
             val: torch.Tensor) -> torch.Tensor:
    """``arr.at[idx].set(val, mode="drop")`` along dim 0 (a new tensor)."""
    n = arr.shape[0]
    ext = torch.cat([arr, arr[:1]])
    ext[_sentinel_index(idx, n)] = val.to(arr.dtype)
    return ext[:n]


def drop_add(arr: torch.Tensor, idx: torch.Tensor,
             val: torch.Tensor) -> torch.Tensor:
    """``arr.at[idx].add(val, mode="drop")`` along dim 0 (a new tensor).
    Meant for integer tensors, whose sums do not depend on order."""
    n = arr.shape[0]
    ext = torch.cat([arr, arr[:1]])
    ext.index_add_(0, _sentinel_index(idx, n), val.to(arr.dtype))
    return ext[:n]
