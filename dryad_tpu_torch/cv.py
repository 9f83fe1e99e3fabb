"""k-fold cross-validation, the counterpart of ``dryad_tpu/cv.py`` (the
LightGBM ``cv()`` surface).

Rows are binned once: every fold's training and holdout sets are row
slices of the input Dataset's binned matrix through ``Dataset.from_binned``
(its frozen mapper shared).  Each fold trains on ``device`` with its
holdout as the valid set, and the per-iteration metric values aggregate to
mean and standard-deviation curves.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dryad_tpu_torch.config import make_params
from dryad_tpu_torch.dataset import Dataset


def _fold_indices(y: np.ndarray, nfold: int, stratified: bool,
                  shuffle: bool, seed: int) -> list[np.ndarray]:
    """Per-fold holdout row ids; stratified keeps label proportions by
    interleaving each class's (optionally shuffled) rows round-robin."""
    N = y.shape[0]
    rng = np.random.default_rng(seed)
    if stratified:
        classes = np.unique(y)
        buckets: list[list[np.ndarray]] = [[] for _ in range(nfold)]
        for c in classes:
            rows = np.flatnonzero(y == c)
            if shuffle:
                rows = rng.permutation(rows)
            for k in range(nfold):
                buckets[k].append(rows[k::nfold])
        return [np.sort(np.concatenate(b)) for b in buckets]
    rows = rng.permutation(N) if shuffle else np.arange(N)
    return [np.sort(rows[k::nfold]) for k in range(nfold)]


def cv(params, train_set: Dataset, nfold: int = 5, *,
       stratified: Optional[bool] = None, shuffle: bool = True,
       seed: int = 0, device=None, return_boosters: bool = False) -> dict:
    """k-fold CV on ``device`` (default: the card): returns
    ``{"valid_<metric>-mean": [...], "valid_<metric>-stdv": [...]}``
    per-iteration curves, truncated to the shortest fold when early
    stopping ends folds at different lengths; ``return_boosters=True``
    adds the per-fold boosters under ``"boosters"``, each with its
    curves in ``train_state["eval_history"]`` (``{name: [[iteration,
    value], ...]}``).

    ``stratified`` defaults to True for binary and multiclass, else
    False.  Ranking data (query groups) is refused: row-level folds would
    split queries."""
    from dryad_tpu_torch import resolve_device, train

    p = make_params(params)
    if train_set.group is not None:
        raise ValueError("cv does not support ranking data: row-level "
                         "folds would split query groups")
    if nfold < 2:
        raise ValueError("nfold must be >= 2")
    y = train_set.y
    if y is None:
        raise ValueError("cv needs labels on the Dataset")
    if stratified is None:
        stratified = p.objective in ("binary", "multiclass")
    dev = resolve_device(device)

    folds = _fold_indices(y, nfold, stratified, shuffle, seed)
    all_rows = np.arange(train_set.num_rows)
    Xb = train_set.X_binned
    w = train_set.weight
    curves: list[dict[str, np.ndarray]] = []
    boosters = []
    for hold in folds:
        tr = np.setdiff1d(all_rows, hold, assume_unique=True)
        ds_tr = Dataset.from_binned(
            Xb[tr], train_set.mapper, y[tr],
            weight=None if w is None else w[tr],
            categorical_features=train_set.categorical_features)
        ds_va = Dataset.from_binned(
            Xb[hold], train_set.mapper, y[hold],
            weight=None if w is None else w[hold],
            categorical_features=train_set.categorical_features)
        hist: dict[str, list] = {}

        def record(it: int, info: dict, hist=hist) -> None:
            for name, v in info.items():
                if name != "iteration":
                    hist.setdefault(name, []).append([it, v])

        b = train(p, ds_tr, [ds_va], callbacks=[record], device=dev)
        # the fold's curves, where the reference's CPU trainer keeps them
        b.train_state["eval_history"] = hist
        boosters.append(b)
        curves.append({name: np.asarray([v for _, v in rows], np.float64)
                       for name, rows in hist.items()})

    out: dict = {}
    for name in curves[0]:
        L = min(c[name].shape[0] for c in curves)
        stack = np.stack([c[name][:L] for c in curves])
        out[f"{name}-mean"] = stack.mean(axis=0).tolist()
        out[f"{name}-stdv"] = stack.std(axis=0).tolist()
    if return_boosters:
        out["boosters"] = boosters
    return out
