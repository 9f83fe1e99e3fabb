"""LambdaMART grad/hess on the device: the counterpart of
``dryad_tpu/engine/lambdarank.py`` (XLA code in the reference, so plain
torch ops here).

The ragged per-query pairwise lambda computation runs on a dense layout:
queries are padded to a fixed document budget ``S`` (the largest query
rounded up to a multiple of 8), giving a (Q, S) layout on which ranks,
|delta NDCG| weights and the S x S pair grid of every query are batched.
Padding slots carry relevance -1 and score -1e30: they sink below every
document in the ranking and take part in no valid pair.

Semantics are ``dryad_tpu.objectives.LambdaRank.grad_hess_np``'s (the
reference's host oracle): a stable sort by -score for ranks, gain
2^rel - 1, log2 discounts, truncation to pairs that touch the top k, and
sigma-weighted lambdas.

Memory.  The pair grid is Q S^2 entries: 18,919 MSLR queries at S = 240
make 1.09e9, 4.4 GB for each fp32 temporary.  The reference bounds it
with ``lax.map`` batches of 2^22 / S^2 queries; here the queries go in
chunks of at most ``CHUNK_BYTES`` per fp32 temporary (a handful of chunks
at MSLR's size, each a few dozen launches).  A query's lambdas depend only
on its own documents, and every chunk keeps the global S, so the chunking
changes no value.

Determinism.  The scatter into (Q, S) sets unique (query, slot) cells, the
ranks are a scatter of a permutation, and every per-query sum is a dense
reduction over S: no float atomics, so a run repeats bit for bit.  Sums
are taken in torch's order, not XLA's, so g/h match the reference's device
path within fp32 rounding, not bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

# bytes of one fp32 (q, S, S) temporary per chunk of queries
CHUNK_BYTES = 1 << 29
_BIG_NEG = -1e30


def padded_width(query_offsets: np.ndarray) -> int:
    """The document budget S of these queries: the largest query rounded
    up to a multiple of 8, at least 8 (8 for no queries)."""
    sizes = np.diff(np.asarray(query_offsets, np.int64))
    return int(max(8, -(-int(sizes.max(initial=0)) // 8) * 8))


class PaddingPlan:
    """The loop-invariant (Q, S) scatter plan of ragged query groups, on
    ``device``: the flat padded slot ``q * S + col`` of every row, and the
    (Q, S) mask of slots that hold a document.  Built once per dataset;
    the boosting loop hoists it out of the iterations.  ``S`` defaults to
    these queries' ``padded_width``; a process group passes the largest
    over its ranks, so every rank pads, chunks and reduces over the S of
    the single process."""

    def __init__(self, query_offsets: np.ndarray, device="cpu",
                 S: int | None = None):
        sizes = np.diff(np.asarray(query_offsets, np.int64))
        self.Q = int(sizes.size)
        own = padded_width(query_offsets)
        if S is not None and int(S) < own:
            raise ValueError(f"S={S} is below the queries' padded width "
                             f"{own}")
        self.S = own if S is None else int(S)
        row = np.repeat(np.arange(self.Q, dtype=np.int64), sizes)
        col = np.arange(int(sizes.sum()), dtype=np.int64) - np.repeat(
            np.asarray(query_offsets, np.int64)[:-1], sizes)
        self.slot = torch.from_numpy(row * self.S + col).to(device)
        present = torch.zeros(self.Q * self.S, dtype=torch.bool,
                              device=device)
        present[self.slot] = True
        self.present = present.view(self.Q, self.S)


def _pad(x: torch.Tensor, plan: PaddingPlan, fill: float) -> torch.Tensor:
    out = torch.full((plan.Q * plan.S,), fill, dtype=torch.float32,
                     device=x.device)
    out[plan.slot] = x.to(torch.float32)
    return out.view(plan.Q, plan.S)


def _lambda_chunk(s: torch.Tensor, rel: torch.Tensor, pres: torch.Tensor,
                  sigma: float, truncation: int):
    """(g, h), each (q, S), for q padded queries: the reference's
    ``per_query`` batched over the chunk, in its op order."""
    q, S = s.shape
    dev = s.device
    ar = torch.arange(S, dtype=torch.int64, device=dev)
    # ranks: stable descending sort, padding sinks to the bottom
    order = torch.argsort(-s, dim=1, stable=True)
    rank_of = torch.empty((q, S), dtype=torch.int64, device=dev)
    rank_of.scatter_(1, order, ar.expand(q, S))
    rel_clip = torch.clamp(rel, min=0.0)
    gains = torch.pow(2.0, rel_clip) - 1.0
    discounts = 1.0 / torch.log2(rank_of.to(torch.float32) + 2.0)
    # ideal DCG over the query's own documents (descending relevance)
    rel_sorted = torch.sort(rel_clip * pres, dim=1, descending=True).values
    ideal_disc = 1.0 / torch.log2(ar.to(torch.float32) + 2.0)
    max_dcg = ((torch.pow(2.0, rel_sorted) - 1.0) * ideal_disc
               * (rel_sorted >= 0)).sum(dim=1)
    inv_max_dcg = torch.where(max_dcg > 0, 1.0 / max_dcg,
                              torch.zeros_like(max_dcg))

    topk = rank_of < truncation
    # rel_i - rel_j > 0 holds exactly when rel_i > rel_j (finite floats)
    valid = rel[:, :, None] > rel[:, None, :]
    valid &= pres[:, :, None]
    valid &= pres[:, None, :]
    valid &= topk[:, :, None] | topk[:, None, :]
    # rho = 1 / (1 + exp(sigma * (s_i - s_j))), in place
    rho = s[:, :, None] - s[:, None, :]
    rho.mul_(sigma).exp_().add_(1.0)
    rho = torch.reciprocal(rho, out=rho)
    delta = (gains[:, :, None] - gains[:, None, :]).abs_()
    delta.mul_((discounts[:, :, None] - discounts[:, None, :]).abs_())
    delta.mul_(inv_max_dcg[:, None, None])
    # lam = sigma * rho * delta; hes = sigma^2 * rho * (1 - rho) * delta
    lam = torch.mul(rho, sigma)
    lam.mul_(delta).masked_fill_(~valid, 0.0)
    g = -lam.sum(dim=2) + lam.sum(dim=1)
    hes = torch.mul(rho, float(np.float32(sigma * sigma)), out=lam)
    rho.neg_().add_(1.0)
    hes.mul_(rho).mul_(delta).masked_fill_(~valid, 0.0)
    h = hes.sum(dim=2) + hes.sum(dim=1)
    return g, h


def lambda_grad_padded(score: torch.Tensor, rel: torch.Tensor,
                       plan: PaddingPlan, sigma: float, truncation: int):
    """fp32 (g, h), each (N,), of the lambda pass over the plan's queries,
    in chunks of queries of at most ``CHUNK_BYTES`` per fp32 pair-grid
    temporary."""
    S = plan.S
    s_pad = _pad(score, plan, _BIG_NEG)
    r_pad = _pad(rel, plan, -1.0)
    g_pad = torch.empty_like(s_pad)
    h_pad = torch.empty_like(s_pad)
    step = max(1, CHUNK_BYTES // (S * S * 4))
    for q0 in range(0, plan.Q, step):
        q1 = min(plan.Q, q0 + step)
        g_pad[q0:q1], h_pad[q0:q1] = _lambda_chunk(
            s_pad[q0:q1], r_pad[q0:q1], plan.present[q0:q1], float(sigma),
            int(truncation))
    return g_pad.view(-1)[plan.slot], h_pad.view(-1)[plan.slot]


def grad_hess_ranking(obj, score: torch.Tensor, y: torch.Tensor,
                      weight, plan: PaddingPlan):
    """The lambda pass's (g, h) for one boosting iteration, times the
    sample weight after the pass, as the reference applies it."""
    g, h = lambda_grad_padded(score, y, plan, obj.sigma, obj.truncation)
    if weight is not None:
        g, h = g * weight, h * weight
    return g, h
