"""Host metrics in numpy (the oracles of `metrics.device`), and the
reference's metric tables: default per objective, direction, aliases."""

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


_EPS = 1e-15


def binary_logloss(y_true: np.ndarray, y_prob: np.ndarray) -> float:
    y = np.asarray(y_true, np.float64)
    p = np.clip(np.asarray(y_prob, np.float64), _EPS, 1.0 - _EPS)
    return float(-(y * np.log(p) + (1 - y) * np.log(1 - p)).mean())


def multi_logloss(y_true: np.ndarray, y_prob: np.ndarray) -> float:
    """Mean negative log probability of the label's class ((N, K)
    probabilities, clipped to [eps, 1] and renormalised)."""
    y = np.asarray(y_true).astype(np.int64)
    p = np.clip(np.asarray(y_prob, np.float64), _EPS, 1.0)
    p = p / p.sum(axis=1, keepdims=True)
    return float(-np.log(p[np.arange(y.size), y]).mean())


def accuracy(y_true: np.ndarray, y_prob: np.ndarray) -> float:
    """Fraction of rows whose argmax class is the label ((N, K) scores)."""
    y = np.asarray(y_true).astype(np.int64)
    pred = np.asarray(y_prob).argmax(axis=1)
    return float((pred == y).mean())


def error_rate(y_true: np.ndarray, y_prob: np.ndarray) -> float:
    """Misclassification fraction (LightGBM's 'error' convention)."""
    return 1.0 - accuracy(y_true, y_prob)


def mse(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    d = np.asarray(y_true, np.float64) - np.asarray(y_pred, np.float64)
    return float(np.mean(d * d))


def mae(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    d = np.asarray(y_true, np.float64) - np.asarray(y_pred, np.float64)
    return float(np.mean(np.abs(d)))


def poisson_deviance(y_true: np.ndarray, raw_score: np.ndarray) -> float:
    """Mean Poisson deviance of raw (log-rate) scores, mu = exp(raw); the
    y log(y / mu) term drops for y == 0 (its limit).  The 1e-30 clamp is
    ``metrics.device.poisson_deviance_device``'s, so both evaluate one
    formula."""
    y = np.asarray(y_true, np.float64)
    mu = np.exp(np.asarray(raw_score, np.float64))
    ylog = np.where(y > 0, y * np.log(np.maximum(y, 1e-30) / mu), 0.0)
    return float(np.mean(2.0 * (ylog - (y - mu))))


def dcg_at_k(rels: np.ndarray, k: int) -> float:
    """DCG of the first k relevances in the given order: gain 2^rel - 1,
    discount 1 / log2(rank + 2)."""
    rels = np.asarray(rels, np.float64)[:k]
    if rels.size == 0:
        return 0.0
    gains = np.power(2.0, rels) - 1.0
    discounts = 1.0 / np.log2(np.arange(2, rels.size + 2))
    return float((gains * discounts).sum())


def ndcg_at_k(y_true: np.ndarray, y_score: np.ndarray,
              query_offsets: np.ndarray, k: int = 10) -> float:
    """Mean NDCG@k over queries, each ranked by a stable mergesort of
    -score; a query whose ideal DCG is 0 counts as 1.0 (the LightGBM
    convention)."""
    y_true = np.asarray(y_true, np.float64)
    y_score = np.asarray(y_score, np.float64)
    total, nq = 0.0, 0
    for q in range(query_offsets.size - 1):
        a, b = int(query_offsets[q]), int(query_offsets[q + 1])
        rels = y_true[a:b]
        order = np.argsort(-y_score[a:b], kind="mergesort")
        idcg = dcg_at_k(np.sort(rels)[::-1], k)
        total += 1.0 if idcg == 0.0 else dcg_at_k(rels[order], k) / idcg
        nq += 1
    return float(total / max(nq, 1))


_METRIC_ALIASES = {"l2": "mse", "l2_root": "rmse", "l1": "mae",
                   "logloss": "binary_logloss", "binary_error": "error",
                   "multi_error": "error"}

DEFAULT_METRIC = {
    "binary": "auc",
    "multiclass": "multi_logloss",
    "regression": "rmse",
    "lambdarank": "ndcg",
    "l1": "mae",
    "huber": "rmse",
    "fair": "rmse",
    "quantile": "mae",
    "poisson": "poisson_deviance",
}

HIGHER_BETTER = {"auc": True, "ndcg": True, "accuracy": True, "error": False,
                 "binary_logloss": False, "multi_logloss": False,
                 "rmse": False, "mse": False, "mae": False,
                 "poisson_deviance": False}


def resolve_metric(objective: str, metric: str) -> str:
    """The metric's canonical name: the objective's default for ``""``,
    aliases resolved."""
    name = metric or DEFAULT_METRIC[objective]
    return _METRIC_ALIASES.get(name, name)
