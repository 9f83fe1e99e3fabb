"""dryad_tpu_torch: the PyTorch/CUDA port of dryad_tpu for one NVIDIA H100.

    import dryad_tpu_torch as dryad
    ds = dryad.Dataset(X, y)
    booster = dryad.train({"objective": "binary"}, ds)
    p = dryad.predict(booster, X_test)

    # sparse rows with categorical features (Criteo-shaped)
    ds = dryad.Dataset(None, y, csr=(indptr, indices, values, F),
                       categorical_features=cat_ids)
    booster = dryad.train({"objective": "binary",
                           "categorical_features": cat_ids}, ds)

    # the rest of the model API
    res = dryad.cv({"objective": "binary"}, ds, nfold=5)
    leaves = dryad.predict(booster, X_test, pred_leaf=True)      # (N, T)
    shap = dryad.predict(booster, X_test, pred_contrib=True)     # (N, F+1)
    adapted = booster.refit(X_new, y_new, decay_rate=0.9)
    booster.save_text("model.json")
    same = dryad.Booster.load_any("model.json")    # npz or text
    from dryad_tpu_torch.sklearn import DryadClassifier
    clf = DryadClassifier(num_trees=50).fit(X, labels)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request they raise rather than fall back.  On
the CPU every kernel runs its plain PyTorch version.

The port trains the reference's nine objectives (binary, multiclass
softmax with K trees per iteration, regression, l1, huber, fair, quantile
and poisson with the L1 family's leaf renewal, and lambdarank on query
groups, ``Dataset(X, y, group=...)``), on dense or CSR rows
(``Dataset(None, y, csr=...)``, with exclusive feature bundling) and with
categorical features (sorted-subset splits, node bitsets), with the
reference's growers:
leaf-wise (the default; the batched expansion plus selection for a
finite depth cap, which ``max_depth=-1`` maps to as the reference does,
else the sequential grower) and depthwise, each on the wired leaf-ordered
layout or the legacy plan arm, with monotone constraints; in the
boosting modes gbdt, goss, dart and rf; with sample weights, bagging and
column sampling, valid sets scored on the device, early stopping,
callbacks, checkpoint/resume and warm starts; it saves and loads model
files in the reference's formats (npz and versioned text), and it
predicts scores, leaf ids (``pred_leaf``) and TreeSHAP contributions
(``pred_contrib``), through packed node words or, for models whose fields
overflow them, the structure-of-arrays traversal (``predict_layout``).
It refits leaf values on new rows (``Booster.refit``), cross-validates
(``cv``) and wraps all of this in scikit-learn-style estimators
(``dryad_tpu_torch.sklearn``).  It trains over a process group, one rank
per process, bit for bit as one process would
(``dryad_tpu_torch.distributed``), supervises long runs through device
faults (``dryad_tpu_torch.resilience.supervise_train``), and sketches and
bins raw rows in C++ when ``g++`` is present (``dryad_tpu_torch.native``).
It imports nothing of ``jax`` or of ``dryad_tpu``.
"""

from __future__ import annotations

import importlib
import os
from typing import TYPE_CHECKING, Any, Mapping, Optional

import numpy as np

# torch-free at import (its Dataset is imported where it runs); bound
# here because the submodule ``cv`` would otherwise shadow the function
from dryad_tpu_torch.cv import cv

if TYPE_CHECKING:
    import torch

    from dryad_tpu_torch.booster import Booster
    from dryad_tpu_torch.config import Params
    from dryad_tpu_torch.dataset import Dataset

__all__ = ["train", "predict", "cv", "Dataset", "Booster", "Params",
           "resolve_device", "distributed"]

#: the Chrome trace ``train(profile_dir=)`` writes
TRACE_FILE = "train_trace.json"

# imported at first use (PEP 562), so that a torch-free subpackage
# (``dryad_tpu_torch.policy``) imports without torch
_LAZY = {"Booster": ("dryad_tpu_torch.booster", "Booster"),
         "Params": ("dryad_tpu_torch.config", "Params"),
         "make_params": ("dryad_tpu_torch.config", "make_params"),
         "Dataset": ("dryad_tpu_torch.dataset", "Dataset"),
         "distributed": ("dryad_tpu_torch.distributed", None)}


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module, attr = _LAZY[name]
    mod = importlib.import_module(module)
    value = mod if attr is None else getattr(mod, attr)
    globals()[name] = value
    return value


def resolve_device(device=None) -> "torch.device":
    """``cuda`` when ``device`` is None; raises when no card is present."""
    import torch

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
          resume: bool = False, device=None, group=None,
          profile_dir: Optional[str] = None, chunk_hook=None,
          chunk_policy=None, **kw: Any) -> Booster:
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
    other.  ``group`` (an ``engine/distributed.RowGroup``) trains this
    rank's rows as one of a process group; ``distributed.
    train_distributed`` builds it.  ``profile_dir`` traces the whole run
    with ``torch.profiler`` (host ops, and the card's kernels on
    ``cuda``) and writes the Chrome trace ``train_trace.json`` there
    (open it in Perfetto or ``chrome://tracing``).  The returned model
    carries its drift baseline (``booster.profile``, ``data/profile.py``)
    unless ``DRYAD_PROFILE=0`` or it trained under ``group``.
    ``chunk_hook``/``chunk_policy`` are the supervisor's loop surfaces
    (``engine/train.py``; most callers want ``resilience.
    supervise_train``)."""
    from dryad_tpu_torch.callbacks import combine
    from dryad_tpu_torch.config import make_params
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
    if (any(p.monotone_constraints)
            and getattr(train_set.mapper, "bundled_mask", None) is not None):
        # bundling stacks columns, so positional per-feature constraints
        # would land on the wrong (and non-ordinal) columns
        raise ValueError(
            "monotone_constraints are positional over the original "
            "features and are incompatible with feature bundling; rebuild "
            "the Dataset with bundle=False")
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
    if profile_dir is None:
        booster = train_device(p, train_set, valid,
                               init_booster=init_booster, callback=cb,
                               checkpointer=checkpointer, device=dev,
                               group=group, chunk_hook=chunk_hook,
                               chunk_policy=chunk_policy)
    else:
        import torch

        act = torch.profiler.ProfilerActivity
        os.makedirs(profile_dir, exist_ok=True)
        with torch.profiler.profile(activities=[act.CPU] + (
                [act.CUDA] if dev.type == "cuda" else [])) as prof:
            booster = train_device(p, train_set, valid,
                                   init_booster=init_booster, callback=cb,
                                   checkpointer=checkpointer, device=dev,
                                   group=group, chunk_hook=chunk_hook,
                                   chunk_policy=chunk_policy)
        prof.export_chrome_trace(os.path.join(profile_dir, TRACE_FILE))
    if group is None:
        # a rank holds only its own rows; a group's model has no profile
        _attach_profile(booster, train_set, valid, dev)
    return booster


def _check_append_compatible(p: Params, train_set: Dataset,
                             model: Booster) -> None:
    """A warm-start append replays the model's trees over the new binned
    rows, so they must live in the model's frozen bin space, and the tree
    tables must stack (rf and non-rf trees do not mix: the trainer refuses
    that for every continuation)."""
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


def _attach_profile(booster, train_set, valid_sets, device) -> None:
    """Embed the drift baseline (``data/profile.py``) in the trained
    model: a stride subsample and one predict on the run's device.
    ``DRYAD_PROFILE=0`` skips it.  A failed capture warns and leaves the
    model without a profile; the trees and predictions do not depend on
    it."""
    if os.environ.get("DRYAD_PROFILE", "1") == "0":
        return
    try:
        from dryad_tpu_torch.data.profile import build_reference_profile

        booster.profile = build_reference_profile(booster, train_set,
                                                  valid_sets, device=device)
    except Exception as e:  # noqa: BLE001 — telemetry must not fail a run
        import warnings

        warnings.warn(f"reference-profile capture failed ({e!r}); "
                      "the model has no drift baseline")


def predict(booster: Booster, X: np.ndarray, *, raw_score: bool = False,
            num_iteration: Optional[int] = None, pred_leaf: bool = False,
            pred_contrib: bool = False, device=None, sharded: bool = False,
            devices=None) -> np.ndarray:
    """Predict raw features through the booster's frozen mapper on
    ``device`` (default: the card); returns the objective's transform of
    the scores (probabilities for binary and multiclass, rates for
    poisson), or raw scores with ``raw_score=True``: shape (N,) for one
    output, (N, K) for a K-class model.  ``pred_leaf=True`` gives the
    (N, T) int32 leaf node ids of the first T = n_iter * K trees,
    ``pred_contrib=True`` the (N, [K,] F + 1) float64 TreeSHAP values, the
    last column the bias (it takes precedence over ``pred_leaf``).
    ``sharded=True`` splits the rows over ``devices`` (default: every
    visible card), bitwise the single-device scores."""
    return booster.predict(X, raw_score=raw_score,
                           num_iteration=num_iteration, pred_leaf=pred_leaf,
                           pred_contrib=pred_contrib, device=device,
                           sharded=sharded, devices=devices)
