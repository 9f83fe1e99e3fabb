"""Objectives: init score in numpy, grad/hess in torch fp32.  Binary
logloss on logit scores and squared-error regression, the counterparts of
``dryad_tpu.objectives.Binary`` and ``Regression``.

Sign convention: ``g = dL/ds`` for raw score s; the Newton leaf value is
``-G/(H + lambda_l2)``.
"""

from __future__ import annotations

import numpy as np
import torch


def _sigmoid_np(x):
    return 1.0 / (1.0 + np.exp(-x))


class Binary:
    name = "binary"
    num_outputs = 1

    @staticmethod
    def init_score(y: np.ndarray) -> float:
        y = np.asarray(y, np.float32)
        w = np.ones_like(y, np.float32)
        p = float(np.clip(np.average(y, weights=w), 1e-12, 1 - 1e-12))
        return float(np.log(p / (1 - p)))

    @staticmethod
    def grad_hess(score: torch.Tensor, y: torch.Tensor):
        """fp32 (g, h) from the raw score, in the reference's op order:
        ``p = 1 / (1 + exp(-s))``, ``g = p - y``, ``h = p (1 - p)``."""
        p = 1.0 / (1.0 + torch.exp(-score))
        return p - y, p * (1.0 - p)

    @staticmethod
    def transform_np(score: np.ndarray) -> np.ndarray:
        return _sigmoid_np(score)


class Regression:
    """Squared error on raw scores (the Epsilon config)."""

    name = "regression"
    num_outputs = 1

    @staticmethod
    def init_score(y: np.ndarray) -> float:
        y = np.asarray(y)
        return float(np.average(y, weights=np.ones_like(y)))

    @staticmethod
    def grad_hess(score: torch.Tensor, y: torch.Tensor):
        """fp32 ``g = s - y``, ``h = 1``."""
        g = score - y
        return g, torch.ones_like(g)

    @staticmethod
    def transform_np(score: np.ndarray) -> np.ndarray:
        return score


_OBJECTIVES = {"binary": Binary, "regression": Regression}


def get_objective(params) -> Binary | Regression:
    if params.objective not in _OBJECTIVES:
        raise ValueError(f"objective {params.objective!r} is outside this "
                         "slice of the port")
    return _OBJECTIVES[params.objective]()
