"""Host-side state of the boosting loop, numpy only: copies of
``dryad_tpu/cpu/trainer.py``'s ``sample_masks``, ``goss_uniform``,
``dart_drop_set``, ``normalize_valids`` and ``update_best``, so the port
draws the same bags, GOSS uniforms and DART drop sets and keeps the same
early-stopping books as the reference."""

from __future__ import annotations

import numpy as np

from dryad_tpu_torch.dataset import Dataset


def sample_masks(params, iteration: int, num_rows: int, num_features: int,
                 row_range: tuple[int, int] | None = None):
    """(row mask or None, feature mask or None) of one iteration: the
    Philox(seed, iteration) draw of the reference, bit for bit, so bagged
    runs agree across packages and a resumed run redraws the same bags.
    ``row_range`` [start, stop) keeps a rank's rows of the bag drawn over
    all ``num_rows`` rows of its process group, so the ranks' bags are the
    single process's."""
    row_mask = None
    feat_mask = None
    if params.subsample < 1.0 or params.colsample < 1.0:
        rng = np.random.Generator(np.random.Philox(key=params.seed,
                                                   counter=iteration))
        if params.subsample < 1.0:
            row_mask = rng.uniform(size=num_rows) < params.subsample
            if row_range is not None:
                row_mask = row_mask[row_range[0]:row_range[1]]
        if params.colsample < 1.0:
            k = max(1, int(round(params.colsample * num_features)))
            feat_mask = np.zeros(num_features, bool)
            feat_mask[rng.permutation(num_features)[:k]] = True
    return row_mask, feat_mask


GOSS_M1, GOSS_M2, GOSS_GOLDEN = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9


def goss_key(seed: int, iteration: int) -> int:
    """The u32 key of one iteration's GOSS hash: the murmur3 finalizer of
    (seed, iteration), in Python ints."""
    key = (seed * GOSS_GOLDEN + iteration * 0x7FEB352D
           + 0x165667B1) % (1 << 32)
    key ^= key >> 16
    key = (key * GOSS_M1) % (1 << 32)
    key ^= key >> 13
    key = (key * GOSS_M2) % (1 << 32)
    return key ^ (key >> 16)


def goss_uniform(params, iteration: int, num_rows: int) -> np.ndarray:
    """Uniforms of one iteration's GOSS pick: a counter-based murmur3
    finalizer hash of (seed, iteration, row id), a pure u32 function, so
    the card draws the same values (``engine/goss.goss_uniform_dev``).
    The 24-bit mantissa uniform is exact in f32."""
    M1, M2 = GOSS_M1, GOSS_M2
    key = goss_key(params.seed, iteration)
    x = np.arange(num_rows, dtype=np.uint32) * np.uint32(GOSS_GOLDEN)
    x ^= np.uint32(key)
    x ^= x >> np.uint32(16)
    x = x * np.uint32(M1)
    x ^= x >> np.uint32(13)
    x = x * np.uint32(M2)
    x ^= x >> np.uint32(16)
    return (x >> np.uint32(8)).astype(np.float32) * np.float32(1.0 / (1 << 24))


def dart_drop_set(params, iteration: int, n_prev: int) -> np.ndarray:
    """The iterations DART drops at ``iteration`` (ascending ids): none
    with prob ``skip_drop``, else each of the ``n_prev`` earlier ones with
    prob ``drop_rate``, a uniform subsample of ``max_drop`` when more are
    drawn.  Philox keyed like ``sample_masks`` on its own counter
    stream."""
    if n_prev == 0 or params.drop_rate <= 0.0:
        return np.empty(0, np.int64)
    rng = np.random.Generator(np.random.Philox(
        key=params.seed, counter=(1 << 32) + iteration))
    if rng.uniform() < params.skip_drop:
        return np.empty(0, np.int64)
    sel = np.nonzero(rng.uniform(size=n_prev) < params.drop_rate)[0]
    if sel.size > params.max_drop:
        sel = np.sort(rng.permutation(sel)[: params.max_drop])
    return sel.astype(np.int64)


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
    best_value, stale).  Under DART it is a no-op by construction: drops
    after the best iteration rescale earlier trees, so the prefix ending
    there is not the ensemble that scored best."""
    if p.boosting == "dart":
        return best_iteration, best_value, stale
    improved = best_value is None or (
        value > best_value if higher else value < best_value)
    if improved:
        return iteration + 1, value, 0
    return best_iteration, best_value, stale + 1
