"""The train-time reference profile: a model's own drift baseline.

When ``dryad_tpu_torch.train`` ends, a compact profile of the training
distribution is computed and kept in the model (``Booster.profile``; a
section of the text model and a key of the npz meta, both read back by
``Booster.load_any``), so every served model carries the baseline its
drift monitor (``obs/drift.py``) compares traffic with:

* **per-feature binned counts** over the mapper's frozen bin space, the
  space serving bins every request into (bin 0 is the missing bin, so
  the missing rate rides along);
* **bin-edge deciles** of each numerical feature (for inspection);
* **score histograms** of the model's raw scores on the training rows and
  the first valid set, on ``obs.drift.SCORE_BUCKETS``.

The profile reads a deterministic stride subsample of at most
``max_rows`` rows, so a 10M-row run pays one bounded predict; its counts
are integers throughout.  The reference scores the sample with its CPU
predict; the port scores it with its own predict on the run's device,
which is bitwise the CPU predict by the port's contract, so the profile
is the same on either device and equals the reference's over the same
model and rows.  ``DRYAD_PROFILE=0`` skips the capture.

Imports no torch (the predict it calls does, when it runs).  The
counterpart of ``dryad_tpu/data/profile.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from dryad_tpu_torch.obs.drift import new_score_state, observe_scores_state

PROFILE_VERSION = 1
#: profile subsample cap: bounds the predict at the end of training
DEFAULT_MAX_ROWS = 65536
#: decile grid for the per-feature edge-quantile summary
_QUANTILE_GRID = tuple(i / 10 for i in range(11))


class ReferenceProfile:
    """The compact baseline embedded in the model artifact."""

    __slots__ = ("version", "n_rows", "feature_counts", "quantiles",
                 "score_hist")

    def __init__(self, feature_counts: Sequence[Sequence[int]],
                 quantiles: Sequence[Sequence[float]],
                 score_hist: dict, n_rows: int,
                 version: int = PROFILE_VERSION):
        self.version = int(version)
        self.n_rows = int(n_rows)
        self.feature_counts = [list(map(int, c)) for c in feature_counts]
        self.quantiles = [[float(v) for v in q] for q in quantiles]
        # split name -> [counts, sum, count] on obs.drift.SCORE_BUCKETS
        self.score_hist = {
            str(k): [list(map(int, st[0])), float(st[1]), int(st[2])]
            for k, st in (score_hist or {}).items()}

    @property
    def num_features(self) -> int:
        return len(self.feature_counts)

    def missing_rate(self) -> list[float]:
        """Per-feature missing rate — bin 0 is the missing bin by the
        frozen sketch contract."""
        return [(c[0] / s if (s := sum(c)) else 0.0)
                for c in self.feature_counts]

    # ---- serialization (json-safe; floats round-trip exactly) --------------
    def to_json_dict(self) -> dict:
        return {
            "profile_version": self.version,
            "n_rows": self.n_rows,
            "feature_counts": [list(c) for c in self.feature_counts],
            "quantiles": [list(q) for q in self.quantiles],
            "score_hist": {k: [list(st[0]), st[1], st[2]]
                           for k, st in self.score_hist.items()},
        }

    @classmethod
    def from_json_dict(cls, d: dict) -> "ReferenceProfile":
        return cls(d["feature_counts"], d.get("quantiles") or [],
                   d.get("score_hist") or {}, d.get("n_rows", 0),
                   d.get("profile_version", PROFILE_VERSION))

    def __eq__(self, other) -> bool:
        return (isinstance(other, ReferenceProfile)
                and self.to_json_dict() == other.to_json_dict())

    def __repr__(self) -> str:
        return (f"ReferenceProfile({self.num_features} features, "
                f"{self.n_rows} rows, splits={sorted(self.score_hist)})")


def _subsample(Xb: np.ndarray, max_rows: int) -> np.ndarray:
    """Deterministic stride subsample — chunk/backend invariant (the
    stride depends only on N and the cap, never on data values)."""
    n = int(Xb.shape[0])
    if n <= max_rows:
        return Xb
    stride = -(-n // max_rows)          # ceil: at most max_rows rows
    return Xb[::stride]


def _feature_counts(Xb: np.ndarray, n_bins: Sequence[int]) -> list:
    counts = []
    for f, nb in enumerate(n_bins):
        col = np.minimum(Xb[:, f].astype(np.int64, copy=False), int(nb) - 1)
        counts.append(np.bincount(col, minlength=int(nb)).tolist())
    return counts


def _edge_quantiles(mapper) -> list:
    """Decile summary of each numerical feature's sketch edges (empty
    for categorical features and for bundled mappers, whose columns are
    synthetic stacks without a single edge vector)."""
    feats = getattr(mapper, "features", None)
    if feats is None:
        return []
    out = []
    for fb in feats:
        edges = np.asarray(fb.edges, np.float32)
        if fb.is_categorical or edges.size == 0:
            out.append([])
            continue
        idx = [min(int(round(q * (edges.size - 1))), edges.size - 1)
               for q in _QUANTILE_GRID]
        out.append([float(edges[i]) for i in idx])
    return out


def profile_from_binned(booster, Xb: np.ndarray,
                        valid_binned: Optional[dict] = None, *,
                        max_rows: int = DEFAULT_MAX_ROWS,
                        device=None) -> ReferenceProfile:
    """Build a profile from an already-binned matrix (the core of
    ``build_reference_profile`` and of the serving bench).  The scores
    come from the port's predict on ``device`` (default: the card),
    bitwise the CPU predict, so the profile is the same on either."""
    mapper = booster.mapper
    sample = _subsample(np.asarray(Xb), int(max_rows))
    n_bins = [int(b) for b in mapper.n_bins]
    score_hist: dict = {}
    for split, mat in dict({"train": sample}, **(valid_binned or {})).items():
        mat = _subsample(np.asarray(mat), int(max_rows))
        if mat.shape[0] == 0:
            continue
        raw = booster.predict_binned(mat, raw_score=True, device=device)
        state = new_score_state()
        observe_scores_state(state, np.asarray(raw, np.float64))
        score_hist[split] = state
    return ReferenceProfile(
        _feature_counts(sample, n_bins), _edge_quantiles(mapper),
        score_hist, sample.shape[0])


def build_reference_profile(booster, train_set, valid_sets=None, *,
                            max_rows: int = DEFAULT_MAX_ROWS,
                            device=None) -> ReferenceProfile:
    """The end-of-training hook: profile the training set's binned matrix
    and the scores of the first valid set (the one early stopping
    watches), with the predict on ``device`` (default: the card)."""
    valid_binned: dict = {}
    for item in (valid_sets or [])[:1]:
        ds = item[1] if isinstance(item, tuple) else item
        valid_binned["valid"] = ds.X_binned
    if getattr(train_set, "is_streamed", False):
        # the streamed stride sample is X_binned[::stride] read chunk by
        # chunk, so a streamed run embeds the resident run's profile
        n = int(train_set.num_rows)
        stride = 1 if n <= int(max_rows) else -(-n // int(max_rows))
        Xb_train = train_set.strided_rows(stride)
    else:
        Xb_train = train_set.X_binned
    return profile_from_binned(booster, Xb_train, valid_binned,
                               max_rows=max_rows, device=device)
