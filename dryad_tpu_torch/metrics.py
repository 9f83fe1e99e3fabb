"""Host metrics in numpy."""

from __future__ import annotations

import numpy as np


def auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Exact ROC-AUC via the rank statistic, with midrank tie handling
    (the same value as ``dryad_tpu.metrics.auc``, vectorised)."""
    y_true = np.asarray(y_true).astype(np.float64).ravel()
    y_score = np.asarray(y_score).astype(np.float64).ravel()
    pos = y_true > 0.5
    n_pos = int(pos.sum())
    n_neg = y_true.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(y_score, kind="mergesort")
    s = y_score[order]
    # first and last sorted index of each run of equal scores -> midrank
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    ends = np.r_[starts[1:], s.size] - 1
    run = np.repeat(np.arange(starts.size), ends - starts + 1)
    ranks = np.empty(y_true.size, np.float64)
    ranks[order] = 0.5 * (starts + ends)[run] + 1.0
    sum_pos_ranks = ranks[pos].sum()
    return float((sum_pos_ranks - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def rmse(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Root mean squared error in float64 (``dryad_tpu.metrics.rmse``)."""
    d = np.asarray(y_true, np.float64) - np.asarray(y_pred, np.float64)
    return float(np.sqrt(np.mean(d * d)))
