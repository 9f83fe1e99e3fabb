"""Exclusive feature bundling (EFB) for sparse data, a copy of
``dryad_tpu/data/bundling.py``.

Criteo-shaped matrices carry many near-one-hot columns that are almost
never non-default in the same row.  Bundling folds strictly exclusive
sparse columns into one column whose bin space is the offset-stacked union
of the members' bins, so the grower sees fewer, denser features with the
same information.

The plan is a pure function of the binned matrix and the frozen mapper
(features scanned in ascending id order, first fit into bundles), and it
is stored with the mapper, so predict folds as training did.

Bundle encoding (members f_1..f_m with bin counts n_1..n_m):

* bundle bin 0: every member at its default (zero-value) bin;
* ``offset_k + b``: member f_k at bin b (offset_1 = 1,
  offset_{k+1} = offset_k + n_k).

A member's missing value (its bin 0) encodes at ``offset_k``, so a bundle
column's bin 0 never means "missing": bundled columns stay out of the
missing-direction scan (``Dataset.has_missing``, ``bundled_mask``).
Categorical columns bundle only with other categoricals; the bundle column
is then categorical, and node bitsets address its offset-stacked bins.
"""

from __future__ import annotations

import io
import warnings
from typing import Sequence

import numpy as np

from dryad_tpu_torch.data.binning import bin_matrix, zero_bins
from dryad_tpu_torch.data.sketch import BinMapper


def _conflicts(sorted_idx: np.ndarray, idx: np.ndarray) -> bool:
    """True when any element of ``idx`` appears in ``sorted_idx``."""
    if sorted_idx.size == 0 or idx.size == 0:
        return False
    pos = np.minimum(np.searchsorted(sorted_idx, idx), sorted_idx.size - 1)
    return bool((sorted_idx[pos] == idx).any())


def plan_bundles(Xb: np.ndarray, mapper: BinMapper, max_bins: int, *,
                 min_default_frac: float = 0.8,
                 sample_rows: int = 1 << 20,
                 max_scan: int = 256) -> list[list[int]]:
    """Greedy strictly exclusive bundling plan: member-id lists (len >= 2).

    A feature is eligible when its default (zero-value) bin covers at least
    ``min_default_frac`` of the rows.  Kinds never mix: categoricals bundle
    with categoricals (capped at 255 bins, so that the 8-word node bitsets
    cover them) and numericals with numericals (capped at ``max_bins -
    1``).  Exclusivity is planned on a row prefix of up to ``sample_rows``
    rows by sorted nonzero-row intersection, scanning at most ``max_scan``
    candidate bundles per feature, then verified over every row: members
    that conflict beyond the prefix are evicted back to singletons."""
    zb = zero_bins(mapper)
    n_bins = mapper.n_bins
    is_cat = mapper.is_categorical
    F = mapper.num_features
    N = Xb.shape[0]
    S = min(N, int(sample_rows))

    bundles: list[dict] = []
    for f in range(F):
        nz_idx = np.flatnonzero(Xb[:S, f] != zb[f]).astype(np.int64)
        if nz_idx.size > (1.0 - min_default_frac) * S:
            continue
        kind_cat = bool(is_cat[f])
        cap = min(max_bins - 1, 255) if kind_cat else max_bins - 1
        placed = False
        for bd in bundles[:max_scan]:
            if bd["cat"] != kind_cat:
                continue
            if bd["bins"] + int(n_bins[f]) > cap:
                continue
            if _conflicts(bd["idx"], nz_idx):
                continue
            bd["members"].append(f)
            bd["idx"] = np.union1d(bd["idx"], nz_idx)
            bd["bins"] += int(n_bins[f])
            placed = True
            break
        if not placed:
            bundles.append({"members": [f], "idx": nz_idx,
                            "bins": int(n_bins[f]), "cat": kind_cat})

    plan = [bd["members"] for bd in bundles if len(bd["members"]) >= 2]
    if S == N:
        return plan

    # every row: rebuild each bundle greedily, evicting members whose
    # non-default rows collide beyond the planning prefix
    verified: list[list[int]] = []
    for members in plan:
        kept: list[int] = []
        mask = np.zeros(N, bool)
        for f in members:
            nz = Xb[:, f] != zb[f]
            if (mask & nz).any():
                continue
            mask |= nz
            kept.append(f)
        if len(kept) >= 2:
            verified.append(kept)
    return verified


def fold_bundles(Xb: np.ndarray, mapper: BinMapper,
                 bundles: Sequence[Sequence[int]], out_dtype: np.dtype,
                 conflict_out: list | None = None) -> np.ndarray:
    """Fold an original-layout binned matrix into the bundled layout:
    bundle columns first, then the unbundled features in ascending id
    order.  Plans are exclusive on the training rows; on other rows, when
    two members are non-default in one row, the lowest member wins and the
    other value is dropped.  Such conflicts are counted (appended to
    ``conflict_out`` when given) and warned about."""
    zb = zero_bins(mapper)
    n_bins = mapper.n_bins
    N = Xb.shape[0]
    in_bundle = np.zeros(mapper.num_features, bool)
    cols = []
    conflicts = 0
    for members in bundles:
        enc = np.zeros(N, np.int32)
        taken = np.zeros(N, bool)
        off = 1
        for f in members:
            in_bundle[f] = True
            b = Xb[:, f].astype(np.int32)
            on = b != zb[f]
            conflicts += int(np.count_nonzero(on & taken))
            nz = on & ~taken              # the lowest member wins
            enc[nz] = off + b[nz]
            taken |= nz
            off += int(n_bins[f])
        cols.append(enc)
    if conflict_out is not None:
        conflict_out.append(conflicts)
    if conflicts:
        warnings.warn(
            f"EFB fold dropped {conflicts} non-default values: bundle "
            "members exclusive on the training data conflicted in this "
            "matrix (lowest member wins); predictions lose that feature "
            "information", RuntimeWarning, stacklevel=2)
    rest = [Xb[:, f].astype(np.int32)
            for f in range(mapper.num_features) if not in_bundle[f]]
    return np.stack(cols + rest, axis=1).astype(out_dtype)


class BundledMapper:
    """A base mapper plus a bundling plan, with the ``BinMapper`` surface
    the trainer and predict read: raw features bin through the base
    mapper, then fold through the plan."""

    def __init__(self, base: BinMapper, bundles: list[list[int]]):
        self.base = base
        self.bundles = [list(map(int, m)) for m in bundles]
        in_bundle = np.zeros(base.num_features, bool)
        for m in self.bundles:
            in_bundle[m] = True
        self.rest = [f for f in range(base.num_features) if not in_bundle[f]]
        base_bins = base.n_bins
        self._n_bins = np.array(
            [1 + sum(int(base_bins[f]) for f in m) for m in self.bundles]
            + [int(base_bins[f]) for f in self.rest], np.int32)
        # True for the bundle columns: their bin 0 means "all default"
        self.bundled_mask = np.array(
            [True] * len(self.bundles) + [False] * len(self.rest), bool)
        # conflicts dropped by the latest transform() or fold()
        self.last_conflict_count = 0

    @property
    def num_features(self) -> int:
        return len(self.bundles) + len(self.rest)

    @property
    def n_bins(self) -> np.ndarray:
        return self._n_bins

    @property
    def total_bins(self) -> int:
        return int(self._n_bins.max(initial=2))

    @property
    def bin_dtype(self) -> np.dtype:
        return np.dtype(np.uint8 if self.total_bins <= 256 else np.uint16)

    @property
    def is_categorical(self) -> np.ndarray:
        """A bundle of categoricals is categorical (kinds never mix)."""
        base_cat = self.base.is_categorical
        return np.array([bool(base_cat[m[0]]) for m in self.bundles]
                        + [bool(base_cat[f]) for f in self.rest], bool)

    def transform(self, X: np.ndarray) -> np.ndarray:
        return self.fold(bin_matrix(np.asarray(X, np.float32), self.base))

    def fold(self, Xb_base: np.ndarray) -> np.ndarray:
        """Fold a binned matrix of the base layout (CSR ingest)."""
        out: list[int] = []
        Xb = fold_bundles(Xb_base, self.base, self.bundles, self.bin_dtype,
                          conflict_out=out)
        self.last_conflict_count = out[0]
        return Xb

    # ---- serialization (byte for byte the reference's) --------------------
    def to_json_dict(self) -> dict:
        return {"type": "bundled", "base": self.base.to_json_dict(),
                "bundles": [list(map(int, m)) for m in self.bundles]}

    @classmethod
    def from_json_dict(cls, d: dict) -> "BundledMapper":
        return cls(BinMapper.from_json_dict(d["base"]), d["bundles"])

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        arrs = {"efb_base": np.frombuffer(self.base.to_bytes(), np.uint8),
                "efb_count": np.array([len(self.bundles)], np.int64)}
        for i, m in enumerate(self.bundles):
            arrs[f"efb_members_{i}"] = np.asarray(m, np.int64)
        np.savez_compressed(buf, **arrs)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "BundledMapper":
        with np.load(io.BytesIO(data)) as z:
            base = BinMapper.from_bytes(bytes(z["efb_base"]))
            count = int(z["efb_count"][0])
            bundles = [z[f"efb_members_{i}"].tolist() for i in range(count)]
            return cls(base, bundles)


def mapper_from_json_dict(d: dict):
    """A plain or bundled mapper from its JSON form."""
    if d.get("type", "plain") == "bundled":
        return BundledMapper.from_json_dict(d)
    return BinMapper.from_json_dict(d)
