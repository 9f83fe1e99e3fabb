"""Synthetic Higgs-, Covertype-, Epsilon-, MSLR- and Criteo-shaped data,
copies of ``dryad_tpu.datasets.higgs_like``, ``covertype_like``,
``epsilon_like``, ``mslr_like`` and ``criteo_like`` so that both packages
make the same rows from the same seed."""

from __future__ import annotations

import numpy as np


def _rng(seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(seed))


def higgs_like(n: int = 100_000, num_features: int = 28, seed: int = 7):
    """Binary physics-ish task: nonlinear signal over dense float features
    (HIGGS is 11M x 28 dense, binary)."""
    rng = _rng(seed)
    X = rng.normal(size=(n, num_features)).astype(np.float32)
    w1 = rng.normal(size=num_features).astype(np.float32)
    score = (
        X @ w1
        + 0.9 * np.sin(X[:, 0] * X[:, 1])
        + 0.8 * (X[:, 2] * X[:, 3])
        + 0.7 * np.square(X[:, 4])
        - 0.5 * np.abs(X[:, 5])
    )
    score = (score - score.mean()) / (score.std() + 1e-9)
    p = 1.0 / (1.0 + np.exp(-1.5 * score))
    y = (rng.uniform(size=n) < p).astype(np.float32)
    return X, y


def covertype_like(n: int = 100_000, num_features: int = 54,
                   num_class: int = 7, seed: int = 11):
    """Multiclass task shaped like Covertype (581k x 54, 7 classes); the
    last ``num_features - 10`` features are sparse 0/1 indicators, like
    Covertype's soil and wilderness one-hots."""
    rng = _rng(seed)
    dense = rng.normal(size=(n, 10)).astype(np.float32)
    binary = (rng.uniform(size=(n, num_features - 10)) < 0.15).astype(
        np.float32)
    X = np.concatenate([dense, binary], axis=1)
    W = rng.normal(size=(num_features, num_class)).astype(np.float32)
    logits = X @ W + 0.8 * np.square(dense[:, :1]) @ rng.normal(
        size=(1, num_class)).astype(np.float32)
    logits += rng.gumbel(size=(n, num_class)).astype(np.float32)
    y = np.argmax(logits, axis=1).astype(np.float32)
    return X, y


def epsilon_like(n: int = 50_000, num_features: int = 2000, seed: int = 13):
    """Wide dense regression (Epsilon is 400k x 2000)."""
    rng = _rng(seed)
    X = rng.normal(size=(n, num_features)).astype(np.float32)
    w = (rng.normal(size=num_features)
         * (rng.uniform(size=num_features) < 0.05)).astype(np.float32)
    y = (X @ w + 0.5 * np.sin(X[:, 0]) * X[:, 1]
         + rng.normal(size=n).astype(np.float32) * 0.1)
    return X, y.astype(np.float32)


def mslr_like(num_queries: int = 1000,
              docs_per_query: tuple[int, int] = (5, 120),
              num_features: int = 136, seed: int = 17):
    """LambdaMART ranking task shaped like MSLR-WEB30K: returns (X, y,
    group) with graded relevance labels 0-4 and query sizes drawn uniform
    in ``docs_per_query``."""
    rng = _rng(seed)
    group = rng.integers(docs_per_query[0], docs_per_query[1] + 1,
                         size=num_queries)
    n = int(group.sum())
    X = rng.normal(size=(n, num_features)).astype(np.float32)
    w = rng.normal(size=num_features).astype(np.float32) * 0.3
    # per-query bias, so relevance is only meaningful within a query
    qbias = np.repeat(rng.normal(size=num_queries).astype(np.float32), group)
    score = X @ w + qbias + rng.normal(size=n).astype(np.float32) * 0.7
    # graded relevance 0..4 by global quantiles of the score
    qs = np.quantile(score, [0.5, 0.75, 0.9, 0.97])
    y = np.digitize(score, qs).astype(np.float32)
    return X, y, group.astype(np.int64)


def criteo_like(n: int = 200_000, num_dense: int = 13, num_cat: int = 26,
                cat_cardinality: int = 1000, density: float = 0.7,
                seed: int = 19):
    """Sparse CTR task shaped like Criteo (13 dense + 26 categorical
    features).  Returns the CSR triple with its width, ``(indptr, indices,
    values, F)``, the labels and the categorical feature ids.  Dense slots
    are present with probability ``density``; categorical values are
    skewed (Zipf-like) integer ids."""
    rng = _rng(seed)
    F = num_dense + num_cat
    present = rng.uniform(size=(n, F)) < density
    present[:, num_dense:] |= rng.uniform(size=(n, num_cat)) < 0.5
    dense_vals = np.log1p(rng.exponential(scale=3.0, size=(n, num_dense))
                          ).astype(np.float32)
    cat_vals = (rng.zipf(a=1.3, size=(n, num_cat))
                % cat_cardinality).astype(np.float32)
    allvals = np.concatenate([dense_vals, cat_vals], axis=1)
    w_d = rng.normal(size=num_dense).astype(np.float32)
    cat_w = rng.normal(size=(num_cat, cat_cardinality)).astype(
        np.float32) * 0.5
    logit = (dense_vals * present[:, :num_dense]) @ w_d - 1.0
    for j in range(num_cat):
        logit += np.where(present[:, num_dense + j],
                          cat_w[j, cat_vals[:, j].astype(np.int64)], 0.0)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logit))).astype(
        np.float32)

    rows, cols = np.nonzero(present)
    values = allvals[rows, cols]
    counts = np.bincount(rows, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    cat_ids = tuple(range(num_dense, F))
    return ((indptr, cols.astype(np.int64), values.astype(np.float32), F),
            y, cat_ids)
