"""Evaluation metrics computed where the scores live, the counterpart of
``dryad_tpu/metrics/device.py``.

An eval returns a 0-d fp32 tensor on the valid set's device, so the
boosting loop fetches one scalar per eval, or nothing until a checkpoint
or the end of training when nothing needs the value mid-run.  The numpy
functions in ``dryad_tpu_torch.metrics`` are the oracles: device sums are
fp32 reductions (~1e-6 relative at 1M rows).
"""

from __future__ import annotations

import numpy as np
import torch

from dryad_tpu_torch.metrics import HIGHER_BETTER, resolve_metric

_EPS = 1e-15

# metrics of the reference that need a later slice of the port
_LATER_SLICE = {"multi_logloss": "M8 (multiclass)",
                "poisson_deviance": "M9 (the remaining objectives)",
                "ndcg": "M9 (ranking)"}


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


def error_device(y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Misclassification fraction of binary raw scores (class 1 iff the
    score is above 0)."""
    pred = (s > 0).to(torch.int32)
    return 1.0 - (pred == y.to(torch.int32)).to(torch.float32).mean()


def rmse_device(y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    d = y - s
    return torch.sqrt((d * d).mean())


def mse_device(y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    d = y - s
    return (d * d).mean()


def mae_device(y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return (y - s).abs().mean()


_DEVICE_FN = {"auc": auc_device, "binary_logloss": binary_logloss_device,
              "error": error_device, "rmse": rmse_device,
              "mse": mse_device, "mae": mae_device}


def _check_metric(name: str) -> None:
    if name in _LATER_SLICE:
        raise ValueError(f"metric {name!r} needs a later slice of the port: "
                         f"{_LATER_SLICE[name]}")
    if name not in HIGHER_BETTER:
        raise ValueError(f"unknown metric {name!r}")


def eval_value(name: str, y: torch.Tensor,
               raw_score: torch.Tensor) -> torch.Tensor:
    """The metric ``name`` of single-output raw scores ((N,) or (N, 1))."""
    _check_metric(name)
    s = raw_score[:, 0] if raw_score.ndim == 2 else raw_score
    if name == "accuracy":
        return 1.0 - error_device(y, s)
    return _DEVICE_FN[name](y, s)


def make_evaluator(objective: str, metric: str, valid_ds, device):
    """(name, higher_better, fn): ``fn(vscore) -> 0-d fp32 tensor`` on
    ``device``.  The valid set's labels upload once."""
    name = resolve_metric(objective, metric)
    _check_metric(name)
    y = torch.from_numpy(np.asarray(valid_ds.y, np.float32)).to(device)

    def fn(vscore: torch.Tensor) -> torch.Tensor:
        return eval_value(name, y, vscore)

    return name, HIGHER_BETTER[name], fn
