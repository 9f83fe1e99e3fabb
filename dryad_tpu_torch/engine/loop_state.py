"""Host-side state of the boosting loop, numpy only: copies of
``dryad_tpu/cpu/trainer.py``'s ``sample_masks``, ``normalize_valids`` and
``update_best``, so the port draws the same bags and keeps the same
early-stopping books as the reference."""

from __future__ import annotations

import numpy as np

from dryad_tpu_torch.dataset import Dataset


def sample_masks(params, iteration: int, num_rows: int, num_features: int):
    """(row mask or None, feature mask or None) of one iteration: the
    Philox(seed, iteration) draw of the reference, bit for bit, so bagged
    runs agree across packages and a resumed run redraws the same bags."""
    row_mask = None
    feat_mask = None
    if params.subsample < 1.0 or params.colsample < 1.0:
        rng = np.random.Generator(np.random.Philox(key=params.seed,
                                                   counter=iteration))
        if params.subsample < 1.0:
            row_mask = rng.uniform(size=num_rows) < params.subsample
        if params.colsample < 1.0:
            k = max(1, int(round(params.colsample * num_features)))
            feat_mask = np.zeros(num_features, bool)
            feat_mask[rng.permutation(num_features)[:k]] = True
    return row_mask, feat_mask


def normalize_valids(valid) -> list[tuple[str, Dataset]]:
    """None | Dataset | list[Dataset | (name, Dataset)] -> [(name, ds)].

    A single anonymous set is named ``valid`` (keys like ``valid_auc``);
    several anonymous sets become ``valid_0``, ``valid_1``, ... Early
    stopping watches the first set."""
    if valid is None:
        return []
    if isinstance(valid, Dataset):
        return [("valid", valid)]
    out: list[tuple[str, Dataset]] = []
    single = len(valid) == 1
    for i, v in enumerate(valid):
        if isinstance(v, tuple):
            out.append((str(v[0]), v[1]))
        else:
            out.append(("valid" if single else f"valid_{i}", v))
    return out


def update_best(p, best_iteration, best_value, stale, iteration, value,
                higher):
    """Early-stopping bookkeeping of one eval: returns (best_iteration,
    best_value, stale).  Under DART (a later slice, M10) it is a no-op by
    construction: drops after the best iteration rescale earlier trees, so
    the prefix ending there is not the ensemble that scored best."""
    if getattr(p, "boosting", "gbdt") == "dart":
        return best_iteration, best_value, stale
    improved = best_value is None or (
        value > best_value if higher else value < best_value)
    if improved:
        return iteration + 1, value, 0
    return best_iteration, best_value, stale + 1
