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
layout or the legacy plan arm; with sample weights, bagging and column
sampling, valid sets scored on the device, early stopping, callbacks,
checkpoint/resume and warm starts; it saves and loads model files in the
reference's format, and it predicts.  It imports nothing of ``jax`` or of
``dryad_tpu``.
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
          train_set: Optional[Dataset] = None,
          valid_sets: Optional[list[Dataset]] = None, *,
          valid_names: Optional[list[str]] = None,
          init_booster: Optional[Booster] = None,
          init_model: Optional[Booster] = None,
          callback=None, callbacks=None,
          checkpoint_dir: Optional[str] = None, checkpoint_every: int = 10,
          resume: bool = False, device=None, **kw: Any) -> Booster:
    """Train a booster on ``device`` (default: the card).

    Every valid set is scored on the device after each ``eval_period``-th
    iteration and the last; early stopping (``early_stopping_rounds``)
    watches the first.  ``callbacks`` is a list of ``fn(iteration,
    info)``; ``callback`` is a single-function alias.
    ``checkpoint_dir`` writes an atomic checkpoint every
    ``checkpoint_every`` iterations; ``resume=True`` continues from the
    newest one there, reproducing the uninterrupted run bit for bit.
    ``init_model`` appends ``num_trees`` new trees to a model (0 returns a
    predict-identical copy) on rows binned in its frozen bin space
    (``Dataset(X, y, mapper=model.mapper)``); ``init_booster`` is the
    total-count continuation the checkpoints use.  Pass one or the
    other."""
    from dryad_tpu_torch.callbacks import combine
    from dryad_tpu_torch.engine.train import train_device

    p = make_params(params, **kw)
    if train_set is None:
        raise ValueError("train_set is required")
    if init_model is not None:
        if init_booster is not None:
            raise ValueError("pass init_model (append semantics) or "
                             "init_booster (total-count resume), not both")
        if resume:
            raise ValueError(
                "init_model with resume=True is ambiguous (the checkpoint "
                "would be shadowed by the warm start)")
        _check_append_compatible(p, train_set, init_model)
        p = p.replace(num_trees=p.num_trees + init_model.num_iterations)
        init_booster = init_model
    elif p.num_trees == 0:
        raise ValueError("num_trees=0 is only meaningful with init_model "
                         "(a 0-tree warm-start append)")
    valid = list(valid_sets) if valid_sets else None
    if valid_names is not None:
        if valid is None or len(valid_names) != len(valid):
            raise ValueError("valid_names must match valid_sets in length")
        valid = list(zip(valid_names, valid))
    dev = resolve_device(device)

    checkpointer = None
    if checkpoint_dir is not None:
        from dryad_tpu_torch.checkpoint import Checkpointer

        checkpointer = Checkpointer(checkpoint_dir, every=checkpoint_every)
        if resume and init_booster is None:
            latest = checkpointer.latest()
            if latest is not None:
                init_booster = latest[0]
    elif resume:
        raise ValueError("resume=True requires checkpoint_dir")

    cb = combine(([callback] if callback else []) + list(callbacks or []))
    return train_device(p, train_set, valid, init_booster=init_booster,
                        callback=cb, checkpointer=checkpointer, device=dev)


def _check_append_compatible(p: Params, train_set: Dataset,
                             model: Booster) -> None:
    """A warm-start append replays the model's trees over the new binned
    rows, so they must live in the model's frozen bin space, and the tree
    tables must stack."""
    m_new, m_old = train_set.mapper, model.mapper
    if m_new is not m_old and m_new.to_json_dict() != m_old.to_json_dict():
        raise ValueError(
            "init_model append: the training set was binned with a "
            "different mapper than the model's frozen bin space; build "
            "it as Dataset(X, y, mapper=model.mapper)")
    if p.max_nodes != model.params.max_nodes:
        raise ValueError(
            f"init_model append: params imply max_nodes={p.max_nodes} but "
            f"the model was grown with {model.params.max_nodes}; derive "
            "the append params from model.params (e.g. "
            "model.params.replace(num_trees=K))")


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
