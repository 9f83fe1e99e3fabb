"""Objectives: init score in numpy, grad/hess in torch fp32.  Binary
logloss on logit scores and squared-error regression, the counterparts of
``dryad_tpu.objectives.Binary`` and ``Regression``, with optional sample
weights.

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


def get_objective(params) -> Binary | Regression:
    if params.objective == "binary":
        return Binary(params.scale_pos_weight)
    if params.objective == "regression":
        return Regression()
    raise ValueError(f"objective {params.objective!r} is outside this "
                     "slice of the port")
