"""dryad_tpu_torch: the PyTorch/CUDA port of dryad_tpu for one NVIDIA H100.

    import dryad_tpu_torch as dryad
    ds = dryad.Dataset(X, y)
    booster = dryad.train({"objective": "binary"}, ds)
    p = dryad.predict(booster, X_test)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request they raise rather than fall back.  On
the CPU every kernel runs its plain PyTorch version.

The port trains binary and regression objectives with the reference's
growers: leaf-wise (the default; the batched expansion plus selection for
a finite depth cap, which ``max_depth=-1`` maps to as the reference does,
else the sequential grower) and depthwise, each on the wired leaf-ordered
layout or the legacy plan arm; and it predicts.  It imports nothing of
``jax`` or of ``dryad_tpu``.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from dryad_tpu_torch.booster import Booster
from dryad_tpu_torch.config import Params, make_params
from dryad_tpu_torch.dataset import Dataset

__all__ = ["train", "predict", "Dataset", "Booster", "Params",
           "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``cuda`` when ``device`` is None; raises when no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def train(params: "Params | Mapping[str, Any] | None" = None,
          dataset: Optional[Dataset] = None, *, device=None,
          **kw: Any) -> Booster:
    """Train a booster on ``device`` (default: the card)."""
    from dryad_tpu_torch.engine.train import train_device

    p = make_params(params, **kw)
    if dataset is None:
        raise ValueError("dataset is required")
    return train_device(p, dataset, device=resolve_device(device))


def predict(booster: Booster, X: np.ndarray, *, raw_score: bool = False,
            num_iteration: Optional[int] = None, device=None) -> np.ndarray:
    """Predict raw features through the booster's frozen mapper; returns
    the objective's transform of the scores (probabilities for binary),
    or raw scores with ``raw_score=True``, shape (N,)."""
    from dryad_tpu_torch.engine.predict import predict_binned
    from dryad_tpu_torch.objectives import get_objective

    dev = resolve_device(device)
    Xb = booster.mapper.transform(np.asarray(X, np.float32))
    raw = predict_binned(booster, Xb, device=dev, num_iteration=num_iteration)
    if raw_score:
        return raw[:, 0]
    return get_objective(booster.params).transform_np(raw)[:, 0]
