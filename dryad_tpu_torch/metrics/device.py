"""Evaluation metrics computed where the scores live, the counterpart of
``dryad_tpu/metrics/device.py``.

An eval returns a 0-d fp32 tensor on the valid set's device, so the
boosting loop fetches one scalar per eval, or nothing until a checkpoint
or the end of training when nothing needs the value mid-run.  The one
exception is NDCG on skewed query sizes, whose padded (Q, S) view would
dwarf the data: it is scored on the host (``make_evaluator``).  The numpy
functions in ``dryad_tpu_torch.metrics`` are the oracles: device sums are
fp32 reductions (~1e-6 relative at 1M rows).
"""

from __future__ import annotations

import numpy as np
import torch

from dryad_tpu_torch.metrics import HIGHER_BETTER, ndcg_at_k, resolve_metric
from dryad_tpu_torch.objectives import row_sum, softmax

_EPS = 1e-15


def auc_device(y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """ROC-AUC via the midrank statistic, a mirror of ``metrics.auc``.

    Tie-group bounds are exact int32 running maxima (fp32 indices would
    collapse above 2^24 rows); the rank sum is an fp32 reduction.  NaN
    when one class is absent."""
    n = s.shape[0]
    order = torch.argsort(s, stable=True)
    ss = s[order]
    pos_sorted = y[order] > 0.5
    i_arr = torch.arange(n, dtype=torch.int32, device=s.device)
    edge = ss[1:] != ss[:-1]
    one = torch.ones(1, dtype=torch.bool, device=s.device)
    is_first = torch.cat([one, edge])
    is_last = torch.cat([edge, one])
    minus1 = torch.full_like(i_arr, -1)
    # group start: running max of first-of-group indices; group end: the
    # same on the reversed array
    gs = torch.cummax(torch.where(is_first, i_arr, minus1), 0).values
    ge_rev = torch.cummax(torch.where(is_last.flip(0), i_arr, minus1),
                          0).values
    ge = (n - 1) - ge_rev.flip(0)
    ranks = 0.5 * (gs + ge).to(torch.float32) + 1.0     # 1-based midranks
    n_pos = pos_sorted.to(torch.float32).sum()
    n_neg = n - n_pos
    sum_pos_ranks = torch.where(pos_sorted, ranks, 0.0).sum()
    value = (sum_pos_ranks - n_pos * (n_pos + 1.0) * 0.5) / (n_pos * n_neg)
    return torch.where((n_pos == 0) | (n_neg == 0),
                       torch.full_like(value, float("nan")), value)


def binary_logloss_device(y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Stable form ``softplus(s) - y s`` (softplus as the reference's
    ``logaddexp(s, 0)``); the per-row cap mirrors the oracle's eps clip,
    so saturated scores give a finite loss."""
    softplus = torch.clamp(s, min=0.0) + torch.log1p(torch.exp(-s.abs()))
    loss = softplus - y * s
    return torch.clamp(loss, max=float(np.float32(-np.log(_EPS)))).mean()


def multi_logloss_device(y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Softmax of the (N, K) raw scores (``jax.nn.softmax``'s op order, as
    ``objectives.Multiclass``), clipped to [eps, 1] and renormalised; the
    mean negative log probability of the label's class."""
    p = torch.clamp(softmax(s), _EPS, 1.0)
    p = p / row_sum(p)
    py = p.gather(1, y.to(torch.int64)[:, None])[:, 0]
    return -torch.log(py).mean()


def error_device(y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Misclassification fraction: of binary raw scores (class 1 iff the
    score is above 0), or of (N, K) scores by their argmax."""
    if s.ndim == 1:
        pred = (s > 0).to(torch.int32)
    else:
        pred = torch.argmax(s, dim=1).to(torch.int32)
    return 1.0 - (pred == y.to(torch.int32)).to(torch.float32).mean()


def rmse_device(y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    d = y - s
    return torch.sqrt((d * d).mean())


def mse_device(y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    d = y - s
    return (d * d).mean()


def mae_device(y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return (y - s).abs().mean()


def poisson_deviance_device(y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Mean Poisson deviance of raw log-rate scores, a mirror of
    ``metrics.poisson_deviance`` with its 1e-30 clamp."""
    mu = torch.exp(s)
    ylog = torch.where(y > 0, y * torch.log(torch.clamp(y, min=1e-30) / mu),
                       0.0)
    return (2.0 * (ylog - (y - mu))).mean()


def _pad_queries(query_offsets: np.ndarray) -> tuple[np.ndarray, int]:
    """(Q, S) row ids of each query's documents, S the largest query's
    size (no rounding); a padding slot holds N, one past the last row.
    Returns (ids int64, N)."""
    qoff = np.asarray(query_offsets, np.int64)
    sizes = np.diff(qoff)
    Q, S, N = sizes.size, int(sizes.max(initial=1)), int(qoff[-1])
    col = np.arange(S, dtype=np.int64)[None, :]
    ids = np.where(col < sizes[:, None], qoff[:-1, None] + col, N)
    return ids, N


def ndcg_device(y: torch.Tensor, s: torch.Tensor, qids: torch.Tensor,
                k: int) -> torch.Tensor:
    """Mean NDCG@k over the padded (Q, S) query views of ``qids``
    (``_pad_queries``), a mirror of ``metrics.ndcg_at_k`` with its
    conventions: a stable sort by -score, and a query whose ideal DCG is 0
    counts as 1.0.  Padding slots take relevance 0 and score -inf, so they
    rank last."""
    Q, S = qids.shape
    n = y.shape[0]
    idx = torch.clamp(qids, max=n - 1)
    pad = qids >= n
    rel = torch.where(pad, 0.0, y[idx])
    sc = torch.where(pad, float("-inf"), s[idx])
    pos = torch.arange(S, dtype=torch.float32, device=s.device)[None, :]
    order = torch.argsort(-sc, dim=1, stable=True)
    rel_by_score = torch.gather(rel, 1, order)
    rel_ideal = torch.sort(rel, dim=1, descending=True).values
    topk = (pos < k) & (pos < (~pad).sum(dim=1)[:, None])
    disc = torch.where(topk, 1.0 / torch.log2(pos + 2.0), 0.0)
    dcg = ((torch.exp2(rel_by_score) - 1.0) * disc).sum(dim=1)
    idcg = ((torch.exp2(rel_ideal) - 1.0) * disc).sum(dim=1)
    return torch.where(idcg == 0.0, 1.0, dcg / idcg).mean()


_DEVICE_FN = {"auc": auc_device, "binary_logloss": binary_logloss_device,
              "multi_logloss": multi_logloss_device, "error": error_device,
              "rmse": rmse_device, "mse": mse_device, "mae": mae_device,
              "poisson_deviance": poisson_deviance_device}


# metrics of (N, K) scores; the others take one score per row
_MULTI_OUTPUT = ("multi_logloss", "error", "accuracy")


def _check_metric(name: str, num_outputs: int) -> None:
    """Raise ``ValueError`` for a metric the port cannot compute on
    ``num_outputs`` score columns."""
    if name not in HIGHER_BETTER:
        raise ValueError(f"unknown metric {name!r}")
    if num_outputs > 1 and name not in _MULTI_OUTPUT:
        raise ValueError(f"metric {name!r} takes one score per row, not "
                         f"{num_outputs} columns")
    if num_outputs == 1 and name == "multi_logloss":
        raise ValueError("metric 'multi_logloss' takes (N, K) multiclass "
                         "scores")


def eval_value(name: str, y: torch.Tensor, raw_score: torch.Tensor,
               qids: torch.Tensor | None = None,
               ndcg_at: int = 10) -> torch.Tensor:
    """The metric ``name`` of raw scores: (N,) or (N, 1) for one output,
    (N, K) for multiclass; ``ndcg`` also takes the (Q, S) query plan
    ``qids`` of ``_pad_queries`` and its cut-off.  A metric that has no
    meaning for the scores' shape raises ``ValueError``."""
    s = raw_score
    if s.ndim == 2 and s.shape[1] == 1:
        s = s[:, 0]
    _check_metric(name, s.shape[1] if s.ndim == 2 else 1)
    if name == "accuracy":
        return 1.0 - error_device(y, s)
    if name == "ndcg":
        return ndcg_device(y, s, qids, ndcg_at)
    return _DEVICE_FN[name](y, s)


def make_evaluator(objective: str, metric: str, valid_ds, device,
                   num_outputs: int = 1, ndcg_at: int = 10):
    """(name, higher_better, fn): ``fn(vscore) -> 0-d fp32 tensor`` on
    ``device`` for scores of ``num_outputs`` columns.  The valid set's
    labels, and for ``ndcg`` its (Q, S) query plan, upload once.

    ``fn.host_only`` is True for NDCG whose padded view is much larger
    than the data (``Q * S > max(8 N, 2^24)``, e.g. 100k tiny queries and
    one huge one): it fetches the scores and evaluates ``ndcg_at_k`` on
    the host, one fetch per eval, so the loop evaluates it synchronously."""
    name = resolve_metric(objective, metric)
    _check_metric(name, num_outputs)
    qids = None
    if name == "ndcg":
        qoff = valid_ds.query_offsets
        if qoff is None:
            raise ValueError("ndcg requires query groups on the validation "
                             "set (Dataset(..., group=...))")
        sizes = np.diff(qoff)
        Q, S, N = sizes.size, int(sizes.max(initial=1)), int(qoff[-1])
        if Q * S > max(8 * N, 1 << 24):
            y_np = np.asarray(valid_ds.y, np.float32)

            def fn_host(vscore: torch.Tensor) -> torch.Tensor:
                s = vscore.cpu().numpy()
                if s.ndim == 2:
                    s = s[:, 0]
                return torch.tensor(ndcg_at_k(y_np, s, qoff, ndcg_at),
                                    dtype=torch.float32, device=device)

            fn_host.host_only = True
            return name, HIGHER_BETTER[name], fn_host
        qids = torch.from_numpy(_pad_queries(qoff)[0]).to(device)
    y = torch.from_numpy(np.asarray(valid_ds.y, np.float32)).to(device)

    def fn(vscore: torch.Tensor) -> torch.Tensor:
        return eval_value(name, y, vscore, qids, ndcg_at)

    fn.host_only = False
    return name, HIGHER_BETTER[name], fn
