"""Objectives: init score in numpy, grad/hess in torch fp32.  Binary
logloss on logit scores, softmax cross-entropy over K classes and
squared-error regression, the counterparts of
``dryad_tpu.objectives.Binary``, ``Multiclass`` and ``Regression``, with
optional sample weights.

Sign convention: ``g = dL/ds`` for raw score s; the Newton leaf value is
``-G/(H + lambda_l2)``.
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


def get_objective(params) -> Binary | Multiclass | Regression:
    if params.objective == "binary":
        return Binary(params.scale_pos_weight)
    if params.objective == "multiclass":
        return Multiclass(params.num_class)
    if params.objective == "regression":
        return Regression()
    raise ValueError(f"objective {params.objective!r} is outside this "
                     "slice of the port")
