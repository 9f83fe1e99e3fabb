"""Objectives: init score in numpy, grad/hess in torch fp32.  Binary
logloss on logit scores, softmax cross-entropy over K classes,
squared-error regression, the robust and count family (L1, Huber, Fair,
Quantile, Poisson) and LambdaMART ranking: the counterparts of the nine
objectives of ``dryad_tpu.objectives``, with optional sample weights.
Each ``grad_hess`` follows the op order of the reference's
``grad_hess_jax``; LambdaRank's lambda pass is
``engine/lambdarank.grad_hess_ranking``.

Sign convention: ``g = dL/ds`` for raw score s; the Newton leaf value is
``-G/(H + lambda_l2)``.  After growth the L1 family's leaves are renewed
to residual quantiles (``renew_alpha``, ``engine/train.renew_values``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _sigmoid_np(x):
    return 1.0 / (1.0 + np.exp(-x))


class Binary:
    """Binary cross-entropy on logit scores.  ``scale_pos_weight``
    multiplies the positive class's grad/hess (and its share of the init
    score): an implicit per-row weight that composes multiplicatively with
    explicit sample weights."""

    name = "binary"
    num_outputs = 1

    def __init__(self, scale_pos_weight: float = 1.0):
        self.spw = float(scale_pos_weight)

    def _weights_np(self, y, weight):
        w = (np.ones_like(y, np.float32) if weight is None
             else np.asarray(weight, np.float32))
        if self.spw != 1.0:
            w = w * np.where(y > 0.5, np.float32(self.spw), np.float32(1.0))
        return w

    def init_score(self, y: np.ndarray, weight=None) -> float:
        w = self._weights_np(np.asarray(y, np.float32), weight)
        p = float(np.clip(np.average(y, weights=w), 1e-12, 1 - 1e-12))
        return float(np.log(p / (1 - p)))

    def grad_hess(self, score: torch.Tensor, y: torch.Tensor,
                  weight: Optional[torch.Tensor] = None):
        """fp32 (g, h) from the raw score, in the reference's op order:
        ``p = 1 / (1 + exp(-s))``, ``g = p - y``, ``h = p (1 - p)``; the
        sample weight and ``scale_pos_weight`` combine into one vector
        before they multiply g and h (the reference's rounding order)."""
        p = 1.0 / (1.0 + torch.exp(-score))
        g, h = p - y, p * (1.0 - p)
        w = weight
        if self.spw != 1.0:
            wp = torch.where(y > 0.5, torch.tensor(self.spw, dtype=y.dtype,
                                                   device=y.device),
                             torch.ones((), dtype=y.dtype, device=y.device))
            w = wp if w is None else w * wp
        if w is not None:
            g, h = g * w, h * w
        return g, h

    @staticmethod
    def transform_np(score: np.ndarray) -> np.ndarray:
        return _sigmoid_np(score)


class Regression:
    """Squared error on raw scores (the Epsilon config)."""

    name = "regression"
    num_outputs = 1

    def init_score(self, y: np.ndarray, weight=None) -> float:
        y = np.asarray(y)
        return float(np.average(y, weights=np.ones_like(y) if weight is None
                                else weight))

    def grad_hess(self, score: torch.Tensor, y: torch.Tensor,
                  weight: Optional[torch.Tensor] = None):
        """fp32 ``g = s - y``, ``h = 1``, times the sample weight."""
        g = score - y
        h = torch.ones_like(g)
        if weight is not None:
            g, h = g * weight, h * weight
        return g, h

    @staticmethod
    def transform_np(score: np.ndarray) -> np.ndarray:
        return score


def _weighted(g, h, weight):
    if weight is not None:
        g, h = g * weight, h * weight
    return g, h


def _weighted_percentile(y: np.ndarray, weight, q: float) -> float:
    """Percentile of y at level q in [0, 1], weight-aware (sorted cumsum
    convention; unweighted it is the lower-interpolation percentile): the
    init score of the robust family."""
    y = np.asarray(y, np.float64)
    order = np.argsort(y, kind="mergesort")
    ys = y[order]
    w = (np.ones_like(ys) if weight is None
         else np.asarray(weight, np.float64)[order])
    cw = np.cumsum(w)
    idx = int(np.searchsorted(cw, q * cw[-1], side="left"))
    return float(ys[min(idx, ys.size - 1)])


def _identity_np(score: np.ndarray) -> np.ndarray:
    return score


class L1:
    """Absolute error: ``g = sign(s - y)``, ``h = 1`` (LightGBM's
    formulation); the leaves are renewed to their in-bag residual medians
    after growth (``renew_alpha``)."""

    name = "l1"
    num_outputs = 1
    transform_np = staticmethod(_identity_np)

    def init_score(self, y: np.ndarray, weight=None) -> float:
        return _weighted_percentile(y, weight, 0.5)

    def grad_hess(self, score, y, weight=None):
        g = torch.sign(score - y)
        return _weighted(g, torch.ones_like(g), weight)


class Huber:
    """Huber loss with ``delta`` (``params.alpha``): g is the residual
    clipped to +-delta, h stays 1; median renewal as L1."""

    name = "huber"
    num_outputs = 1
    transform_np = staticmethod(_identity_np)

    def __init__(self, delta: float = 0.9):
        self.delta = float(delta)

    def init_score(self, y: np.ndarray, weight=None) -> float:
        return _weighted_percentile(y, weight, 0.5)

    def grad_hess(self, score, y, weight=None):
        d = float(np.float32(self.delta))
        g = torch.clamp(score - y, -d, d)
        return _weighted(g, torch.ones_like(g), weight)


class Fair:
    """Fair loss c^2 (|r|/c - log(1 + |r|/c)) with ``c = params.fair_c``:
    ``g = c r / (|r| + c)``, ``h = c^2 / (|r| + c)^2``."""

    name = "fair"
    num_outputs = 1
    transform_np = staticmethod(_identity_np)

    def __init__(self, c: float = 1.0):
        self.c = float(c)

    def init_score(self, y: np.ndarray, weight=None) -> float:
        return _weighted_percentile(y, weight, 0.5)

    def grad_hess(self, score, y, weight=None):
        c32 = np.float32(self.c)
        c, cc = float(c32), float(c32 * c32)       # c * c in fp32
        r = score - y
        denom = torch.abs(r) + c
        g = c * r / denom
        # a tensor numerator: torch computes ``float / tensor`` as a
        # reciprocal times the float, which rounds twice
        h = torch.full_like(denom, cc) / (denom * denom)
        return _weighted(g, h, weight)


class Quantile:
    """Pinball loss at level ``alpha``: ``g = -alpha`` where the score is
    below the label, else ``1 - alpha``; ``h = 1``; the leaves are renewed
    to their in-bag residual alpha-quantiles."""

    name = "quantile"
    num_outputs = 1
    transform_np = staticmethod(_identity_np)

    def __init__(self, alpha: float = 0.9):
        self.alpha = float(alpha)

    def init_score(self, y: np.ndarray, weight=None) -> float:
        return _weighted_percentile(y, weight, self.alpha)

    def grad_hess(self, score, y, weight=None):
        a = np.float32(self.alpha)
        g = torch.where(score < y, float(-a), float(np.float32(1.0) - a))
        return _weighted(g, torch.ones_like(g), weight)


class Poisson:
    """Poisson regression on a log link (raw score = log rate; predict
    applies exp): ``g = exp(s) - y``, ``h = exp(s + max_delta_step)``."""

    name = "poisson"
    num_outputs = 1

    def __init__(self, max_delta_step: float = 0.7):
        self.mds = float(max_delta_step)

    def init_score(self, y: np.ndarray, weight=None) -> float:
        ya = np.asarray(y, np.float64)
        if (ya < 0).any():
            raise ValueError("poisson objective requires non-negative labels")
        w = np.ones_like(ya) if weight is None else weight
        return float(np.log(max(float(np.average(ya, weights=w)), 1e-12)))

    def grad_hess(self, score, y, weight=None):
        g = torch.exp(score) - y
        h = torch.exp(score + float(np.float32(self.mds)))
        return _weighted(g, h, weight)

    @staticmethod
    def transform_np(score: np.ndarray) -> np.ndarray:
        return np.exp(score)


class LambdaRank:
    """LambdaMART with |delta NDCG| weighting over query groups; its grad
    and hess come from the padded per-query lambda pass
    (``engine/lambdarank.grad_hess_ranking``) on the training set's
    ``PaddingPlan``."""

    name = "lambdarank"
    num_outputs = 1
    transform_np = staticmethod(_identity_np)

    def __init__(self, sigmoid: float = 1.0, truncation: int = 30):
        self.sigma = float(sigmoid)
        self.truncation = int(truncation)

    def init_score(self, y: np.ndarray, weight=None) -> float:
        return 0.0


def renew_alpha(params, weighted: bool = False) -> float | None:
    """The percentile level of post-growth leaf renewal, or None (the
    reference's gate, whole): LightGBM refits the L1 family's leaves to
    residual percentiles (RenewTreeOutput): the median for l1 and huber,
    ``params.alpha`` for quantile.  Off for weighted data (the percentile
    is unweighted), under dart and rf, and under monotone constraints (a
    renewed value could leave its bounds)."""
    if weighted or params.boosting not in ("gbdt", "goss"):
        return None
    if any(params.monotone_constraints):
        return None
    if params.objective in ("l1", "huber"):
        return 0.5
    if params.objective == "quantile":
        return params.alpha
    return None


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """(N, 1) row sums of (N, K), added column by column: the order XLA
    reduces a short row in, so the sums match the reference's bitwise."""
    total = x[:, 0]
    for k in range(1, x.shape[1]):
        total = total + x[:, k]
    return total[:, None]


def softmax(score: torch.Tensor) -> torch.Tensor:
    """Row softmax of (N, K) fp32 scores as ``jax.nn.softmax`` writes it:
    ``exp(s - max)`` over its row sum."""
    e = torch.exp(score - score.amax(dim=1, keepdim=True))
    return e / row_sum(e)


class Multiclass:
    """Softmax cross-entropy over K classes (the Covertype config): scores
    (N, K), labels hold class ids, K trees per iteration."""

    name = "multiclass"

    def __init__(self, num_class: int):
        self.num_class = int(num_class)
        self.num_outputs = self.num_class

    def init_score(self, y: np.ndarray, weight=None) -> np.ndarray:
        """All-zero logits: the uniform prior, as the reference starts."""
        return np.zeros(self.num_class, np.float32)

    def grad_hess(self, score: torch.Tensor, y: torch.Tensor,
                  weight: Optional[torch.Tensor] = None):
        """fp32 (g, h), each (N, K), from the (N, K) score, in the op
        order of the reference's ``grad_hess_jax``: ``softmax``, then
        ``g = p - onehot(y)``, ``h = p (1 - p)``, times the weight."""
        p = softmax(score)
        # jax.nn.one_hot's semantics (a label outside 0..K-1 gives a zero
        # row), with no device-side range check
        classes = torch.arange(self.num_class, device=y.device)
        onehot = (y.to(torch.int64)[:, None] == classes).to(torch.float32)
        g, h = p - onehot, p * (1.0 - p)
        if weight is not None:
            g, h = g * weight[:, None], h * weight[:, None]
        return g, h

    @staticmethod
    def transform_np(score: np.ndarray) -> np.ndarray:
        """Class probabilities: the stable softmax in float64, rounded to
        float32."""
        s = score.astype(np.float64)
        s -= s.max(axis=1, keepdims=True)
        e = np.exp(s)
        return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def get_objective(params):
    if params.objective == "binary":
        return Binary(params.scale_pos_weight)
    if params.objective == "regression":
        return Regression()
    if params.objective == "l1":
        return L1()
    if params.objective == "huber":
        return Huber(params.alpha)
    if params.objective == "fair":
        return Fair(params.fair_c)
    if params.objective == "quantile":
        return Quantile(params.alpha)
    if params.objective == "poisson":
        return Poisson(params.poisson_max_delta_step)
    if params.objective == "multiclass":
        return Multiclass(params.num_class)
    if params.objective == "lambdarank":
        return LambdaRank(params.sigmoid, params.lambdarank_truncation)
    raise ValueError(f"unknown objective {params.objective!r}")
