"""Model-quality drift telemetry: PSI monitors over the serving bin
space.

Every served request is binned into the model's frozen per-feature bin
space (the batcher's ``_prepare``) and its raw scores come back to the
host, so drift accounting is a count over arrays the serving path
already holds:

* **host-side, no torch**: the monitor sees numpy arrays on the host;
* **nothing when disabled**: with the obs registry disabled or drift off
  the server keeps its monitor table ``None`` and allocates no drift
  state;
* **merge counts, never ratios**: a monitor exports raw window bin
  counts (``export_state``); ``merge_drift_states`` adds integer counts
  exactly and PSI is computed once on the merge, so the verdict over
  several replicas equals the verdict over the concatenated traffic bit
  for bit.

The baseline rides in the model file: ``data/profile.py`` stores a
per-feature binned-count distribution and a score histogram on this
module's fixed ``SCORE_BUCKETS`` layout when training ends.

PSI (population stability index): ``sum_b (q_b - p_b) * ln(q_b / p_b)``
with a proportion floor.  Rule of thumb (the default budget): < 0.1
stable, 0.1-0.2 moderate, > 0.2 significant shift.

Lock contract: ``DriftMonitor._lock`` guards the rotating window (the
two-epoch recency idiom of ``serve/metrics.py``); gauges are set outside
it.  ``DriftGate._lock`` guards the breach streaks; health notes, gauges
and the ``on_breach`` callback run outside it.  Neither lock nests with
another.

The counterpart of ``dryad_tpu/obs/drift.py``, its arithmetic copied bit
for bit.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Optional, Sequence

import numpy as np

from dryad_tpu_torch.obs.health import HealthState
from dryad_tpu_torch.obs.registry import Registry, default_registry

__all__ = [
    "SCORE_BUCKETS", "DEFAULT_PSI_BUDGET", "score_bucket_index",
    "new_score_state", "observe_scores_state", "psi", "drift_report",
    "merge_drift_states", "DriftMonitor", "DriftGate", "parse_psi_budget",
]

# ---- the fixed score-bucket scheme ------------------------------------------
#
# Raw margin scores are signed and span decades, so the layout is a
# signed log grid: 4 buckets per decade over |s| in 1e-3 .. 1e4, mirrored
# around zero (scores inside ±1e-3 land in the first positive bucket).
# Like registry.LOG_BUCKETS the bounds are CODE, not configuration —
# every process shares the layout by construction, which is what makes
# the cross-replica count-merge exact.  Never give a score histogram
# custom buckets.
SCORE_MIN = 1e-3
SCORE_PER_DECADE = 4
SCORE_DECADES = 7
_POS = tuple(SCORE_MIN * 10.0 ** (i / SCORE_PER_DECADE)
             for i in range(SCORE_PER_DECADE * SCORE_DECADES + 1))
SCORE_BUCKETS = tuple(-b for b in reversed(_POS)) + _POS
# every array this module touches is a host numpy array the serving
# path already holds (the binned batch, the fetched raw scores)
_SCORE_BOUNDS_NP = np.array(SCORE_BUCKETS, np.float64)

#: PSI above this is "significant shift" (the canonical 0.2 rule); the
#: default budget for both the per-feature max and the score shift
DEFAULT_PSI_BUDGET = 0.2
#: proportion floor inside the PSI log — an empty bin must not blow the
#: index to infinity (standard practice)
PSI_EPS = 1e-4


def parse_psi_budget(spec: str) -> Optional[float]:
    """CLI shape for ``--drift-psi``: a float budget, empty -> the
    default, ``off``/``none`` -> None (drift gating disabled)."""
    if not spec:
        return DEFAULT_PSI_BUDGET
    if spec.strip().lower() in ("off", "none"):
        return None
    return float(spec)


def score_bucket_index(value: float) -> int:
    """The 'le' bucket index on SCORE_BUCKETS: the smallest ``i`` with
    ``value <= SCORE_BUCKETS[i]``, overflow for values past the last
    bound; non-finite values land in the overflow bucket."""
    if value != value or value == float("inf"):      # NaN / +inf
        return len(SCORE_BUCKETS)
    lo, hi = 0, len(SCORE_BUCKETS)
    while lo < hi:
        mid = (lo + hi) // 2
        if value <= SCORE_BUCKETS[mid]:
            hi = mid
        else:
            lo = mid + 1
    return lo


def new_score_state() -> list:
    """A fresh ``[counts, sum, count]`` state on the SCORE_BUCKETS
    layout (mirrors registry.new_hist_state on LOG_BUCKETS)."""
    return [[0] * (len(SCORE_BUCKETS) + 1), 0.0, 0]


def observe_scores_state(state: list, values: np.ndarray) -> None:
    """Histogram a raw-score array into a standalone score state (caller
    locks; ``values`` is a host numpy array).  Vectorized: one
    searchsorted + one bincount per batch."""
    flat = np.ravel(values).astype(np.float64, copy=False)
    if flat.size == 0:
        return
    idx = np.searchsorted(_SCORE_BOUNDS_NP, flat, side="left")
    # non-finite scores overflow (searchsorted puts NaN at the end for
    # nan-last ordering, but be explicit so the layout contract holds)
    idx[~np.isfinite(flat)] = len(SCORE_BUCKETS)
    counts = np.bincount(idx, minlength=len(SCORE_BUCKETS) + 1)
    for i in np.flatnonzero(counts):
        state[0][int(i)] += int(counts[i])
    state[1] += float(np.where(np.isfinite(flat), flat, 0.0).sum())
    state[2] += int(flat.size)


def psi(ref_counts: Sequence[int], obs_counts: Sequence[int],
        eps: float = PSI_EPS) -> float:
    """Population stability index between two count vectors sharing one
    bin layout.  Proportions are floored at ``eps`` so empty bins
    contribute finitely; either side empty -> 0.0 (no evidence)."""
    if len(ref_counts) != len(obs_counts):
        raise ValueError("PSI needs one shared bin layout "
                         f"({len(ref_counts)} vs {len(obs_counts)} bins)")
    rt = float(sum(ref_counts))
    ot = float(sum(obs_counts))
    if rt <= 0 or ot <= 0:
        return 0.0
    s = 0.0
    for r, o in zip(ref_counts, obs_counts):
        p = max(r / rt, eps)
        q = max(o / ot, eps)
        s += (q - p) * math.log(q / p)
    return s


# ---- export / merge ---------------------------------------------------------


def merge_drift_states(blocks: Sequence[dict]) -> dict:
    """Exact count-merge of replica ``export_state`` blocks for ONE
    model: integer window counts add losslessly (the histogram-merge
    discipline — merge counts, never quantiles or PSI values), so the
    merged block is the block of the concatenated observations.  The
    reference side is static (every replica serves the same artifact)
    and is taken from the first block; a block whose bin layout differs
    is rejected."""
    blocks = [b for b in blocks if isinstance(b, dict) and "features" in b]
    if not blocks:
        raise ValueError("nothing to merge")
    first = blocks[0]
    bins = list(first.get("bins") or [len(c) for c in first["features"]])
    out = {
        "model": first.get("model", "model"),
        "bins": bins,
        "rows": 0,
        "features": [[0] * nb for nb in bins],
        "ref_features": [list(map(int, c))
                         for c in first.get("ref_features") or []],
        "score": None,
        "ref_score": first.get("ref_score"),
    }
    score_states: list = []
    for b in blocks:
        feats = b["features"]
        if [len(c) for c in feats] != bins:
            raise ValueError("cannot merge drift blocks with different "
                             "bin layouts")
        for f, c in enumerate(feats):
            dst = out["features"][f]
            for i, v in enumerate(c):
                dst[i] += int(v)
        out["rows"] += int(b.get("rows", 0))
        if b.get("score") is not None:
            score_states.append(b["score"])
    if score_states:
        n = len(score_states[0][0])
        counts = [0] * n
        total = 0.0
        cnt = 0
        for c, s, k in score_states:
            if len(c) != n:
                raise ValueError("cannot merge score histograms with "
                                 "different layouts")
            for i, v in enumerate(c):
                counts[i] += int(v)
            total += float(s)
            cnt += int(k)
        out["score"] = [counts, total, cnt]
    return out


def drift_report(state: dict, *, budget_psi: Optional[float] = None,
                 top_k: int = 5) -> dict:
    """The one shared PSI readout — replicas (``DriftMonitor.snapshot``)
    and the fleet router (on the merged state) run THIS on an
    ``export_state``-shaped block, so local and fleet verdicts are the
    same arithmetic.  Returns per-feature PSI top-k, the max, the score
    shift, and (when a budget is given) the breach flags."""
    feats = state.get("features") or []
    refs = state.get("ref_features") or []
    rows = int(state.get("rows", 0))
    per_feature: list = []
    for f, counts in enumerate(feats):
        ref = refs[f] if f < len(refs) else None
        if not ref or sum(counts) == 0:
            continue
        per_feature.append((f, psi(ref, counts)))
    per_feature.sort(key=lambda t: (-t[1], t[0]))
    psi_max = per_feature[0][1] if per_feature else 0.0
    score_psi = 0.0
    if state.get("score") is not None and state.get("ref_score") is not None:
        score_psi = psi(state["ref_score"][0], state["score"][0])
    report = {
        "model": state.get("model", "model"),
        "rows": rows,
        "psi_max": round(psi_max, 6),
        "score_psi": round(score_psi, 6),
        "top": [{"feature": f, "psi": round(v, 6)}
                for f, v in per_feature[:max(0, int(top_k))]],
    }
    if budget_psi is not None:
        report["budget_psi"] = float(budget_psi)
        report["features_over"] = sum(1 for _f, v in per_feature
                                      if v > budget_psi)
        report["breached"] = bool(rows > 0 and (psi_max > budget_psi
                                                or score_psi > budget_psi))
    return report


# ---- the serve-path monitor -------------------------------------------------


class DriftMonitor:
    """Windowed per-feature bin-count + score-histogram accumulator.

    Fed from the serve pipeline's already-binned ``_prepare`` output
    (``observe_features``) and the already-fetched raw predictions
    (``observe_scores``); compares a two-epoch rotating window of recent
    traffic (the serve/metrics.py recency idiom: between window/2 and
    window rows) against the model's embedded reference profile.

    Lock contract: ``_lock`` guards the rotating window — the flat
    feature-count array, the row counter, the score states, and the
    previous-epoch snapshots; observes come from the batcher's collector
    AND executor threads concurrently.  Registry gauges are set outside
    the lock (each family has its own), and nothing blocking ever runs
    under it."""

    GUARDED_BY = {"_cur": "_lock", "_prev": "_lock",
                  "_cur_rows": "_lock", "_prev_rows": "_lock",
                  "_score_cur": "_lock", "_score_prev": "_lock"}

    def __init__(self, ref_feature_counts: Sequence[Sequence[int]], *,
                 ref_score_state: Optional[Sequence] = None,
                 model: str = "model", window_rows: int = 8192,
                 registry: Optional[Registry] = None, top_k: int = 5):
        self.model = str(model)
        self.ref_features = [list(map(int, c)) for c in ref_feature_counts]
        self.ref_score = (None if ref_score_state is None
                          else [list(map(int, ref_score_state[0])),
                                float(ref_score_state[1]),
                                int(ref_score_state[2])])
        self.n_features = len(self.ref_features)
        self._bins = [len(c) for c in self.ref_features]
        # flat layout: feature f's counts live at [_base[f], _base[f+1])
        base = np.zeros(self.n_features + 1, np.int64)
        np.cumsum(self._bins, out=base[1:])
        self._base = base
        self._col_base = base[:-1][None, :]            # (1, F) offsets
        self._nb_max = (np.array(self._bins, np.int64) - 1)[None, :]
        self._total_bins = int(base[-1])
        self.window_rows = max(2, int(window_rows))
        self._half = max(1, self.window_rows // 2)
        self.top_k = int(top_k)
        self._registry = registry
        self._lock = threading.Lock()
        self._cur = np.zeros(self._total_bins, np.int64)
        self._prev: Optional[np.ndarray] = None
        self._cur_rows = 0
        self._prev_rows = 0
        self._score_cur = new_score_state()
        self._score_prev: Optional[list] = None

    def _reg(self) -> Registry:
        return (self._registry if self._registry is not None
                else default_registry())

    # ---- recording ---------------------------------------------------------
    def observe_features(self, Xb: np.ndarray) -> None:
        """Fold one already-binned batch (n, F) into the current window.
        One vectorized bincount per batch — no per-row Python work."""
        n = int(Xb.shape[0])
        if n == 0 or int(Xb.shape[1]) != self.n_features:
            return
        # defensive two-sided clip: a client-binned request could carry
        # ids past the mapper's bin count — or, through the signed
        # direct API, below zero — and neither may bleed into another
        # feature's flat range (or crash the bincount)
        idx = np.clip(Xb.astype(np.int64, copy=False), 0, self._nb_max)
        counts = np.bincount((idx + self._col_base).ravel(),
                             minlength=self._total_bins)
        with self._lock:
            self._cur += counts
            self._cur_rows += n
            if self._cur_rows >= self._half:
                # two-epoch rotation: readers see prev + cur, i.e. the
                # most recent window/2 .. window rows
                self._prev = self._cur
                self._prev_rows = self._cur_rows
                self._cur = np.zeros(self._total_bins, np.int64)
                self._cur_rows = 0
                self._score_prev = self._score_cur
                self._score_cur = new_score_state()

    def observe_scores(self, raw: np.ndarray) -> None:
        """Fold one batch of raw margin scores (n,) or (n, K) into the
        current window's score histogram (multi-output models histogram
        every output — a shift in any class margin is a shift)."""
        flat = np.ravel(raw).astype(np.float64, copy=False)
        if flat.size == 0:
            return
        idx = np.searchsorted(_SCORE_BOUNDS_NP, flat, side="left")
        idx[~np.isfinite(flat)] = len(SCORE_BUCKETS)
        counts = np.bincount(idx, minlength=len(SCORE_BUCKETS) + 1)
        total = float(np.where(np.isfinite(flat), flat, 0.0).sum())
        with self._lock:
            st = self._score_cur
            for i in np.flatnonzero(counts):
                st[0][int(i)] += int(counts[i])
            st[1] += total
            st[2] += int(flat.size)

    # ---- reading -----------------------------------------------------------
    def _window_locked(self) -> tuple:
        """(flat counts, rows, score_state) of prev + cur — called with
        ``_lock`` held."""
        counts = (self._cur.copy() if self._prev is None
                  else self._cur + self._prev)
        rows = self._cur_rows + self._prev_rows
        sc, ss, sn = self._score_cur
        score = [list(sc), float(ss), int(sn)]
        if self._score_prev is not None:
            pc, ps, pn = self._score_prev
            score = [[a + b for a, b in zip(score[0], pc)],
                     score[1] + float(ps), score[2] + int(pn)]
        return counts, rows, score

    def export_state(self) -> dict:
        """The raw-count block a replica serves on ``/obs`` for the fleet
        router's exact merge: window counts per feature, the row count,
        the score state, and the static reference — COUNTS only, never a
        ratio or a PSI value (those are computed after the merge)."""
        with self._lock:
            counts, rows, score = self._window_locked()
        flat = counts.tolist()
        return {
            "model": self.model,
            "rows": int(rows),
            "window_rows": self.window_rows,
            "bins": list(self._bins),
            "features": [flat[int(self._base[f]):int(self._base[f + 1])]
                         for f in range(self.n_features)],
            "ref_features": [list(c) for c in self.ref_features],
            "score": score if score[2] else None,
            "ref_score": (None if self.ref_score is None
                          else [list(self.ref_score[0]),
                                self.ref_score[1], self.ref_score[2]]),
        }

    def snapshot(self, budget_psi: Optional[float] = None) -> dict:
        """The local PSI verdict (``drift_report`` on the window) plus
        the ``dryad_drift_*`` gauge mirror — gauges are set OUTSIDE the
        window lock (registry families own their locks)."""
        report = drift_report(self.export_state(), budget_psi=budget_psi,
                              top_k=self.top_k)
        reg = self._reg()
        if reg.enabled:
            reg.gauge("dryad_drift_psi_max",
                      "Max per-feature PSI over the recent window").labels(
                model=self.model).set(report["psi_max"])
            reg.gauge("dryad_drift_score_psi",
                      "Prediction-score PSI over the recent window").labels(
                model=self.model).set(report["score_psi"])
            reg.gauge("dryad_drift_rows",
                      "Rows in the drift window").labels(
                model=self.model).set(report["rows"])
            fam = reg.gauge("dryad_drift_psi",
                            "Per-feature PSI, top offenders")
            for item in report["top"]:
                fam.labels(model=self.model,
                           feature=item["feature"]).set(item["psi"])
        return report


# ---- the verdict gate -------------------------------------------------------


class DriftGate:
    """Sustained-drift verdicts over per-model drift reports.

    The SloGate shape, with one deliberate difference: drift is
    WARN-ONLY by default — a drifted model still serves (degrading the
    fleet for a data shift would trade availability for freshness), so
    a sustained breach surfaces ``drift:<model>`` in /healthz PAYLOADS
    and fires ``on_breach`` (the router journals ``drift_breach`` — the
    continual-boosting retrain/rollback trigger) without flipping the
    probe to 503.  Construct with ``degrade=True`` to make it gate
    health like the SLO does.

    Lock contract: ``_lock`` guards the streaks and the latched
    verdicts; gauges, health notes and the ``on_breach`` callback (a
    ctor-injected user callback — never callable under a lock) all run
    OUTSIDE it."""

    GUARDED_BY = {"_streaks": "_lock", "_verdicts": "_lock"}

    def __init__(self, budget_psi: float = DEFAULT_PSI_BUDGET, *,
                 breach_after: int = 2, degrade: bool = False,
                 registry: Optional[Registry] = None,
                 health: Optional[HealthState] = None,
                 on_breach: Optional[Callable] = None):
        self.budget_psi = float(budget_psi)
        self.breach_after = int(breach_after)
        self.degrade = bool(degrade)
        self._registry = registry
        self._health = health
        self.on_breach = on_breach
        self._lock = threading.Lock()
        self._streaks: dict[str, int] = {}
        self._verdicts: dict[str, dict] = {}

    def _reg(self) -> Registry:
        return (self._registry if self._registry is not None
                else default_registry())

    def evaluate(self, reports: dict) -> dict:
        """One pass over ``{model: drift_report}``.  An empty window
        (rows == 0) is no evidence — the streak and any standing warning
        HOLD, exactly like the SLO gate's empty-window rule; a breached
        non-empty window advances the streak, ``breach_after``
        consecutive make it sustained (journal + warning), an in-budget
        non-empty window clears it."""
        transitions: list = []
        with self._lock:
            for model, report in sorted(reports.items()):
                rows = int(report.get("rows", 0))
                breached = bool(rows > 0
                                and (report.get("psi_max", 0.0)
                                     > self.budget_psi
                                     or report.get("score_psi", 0.0)
                                     > self.budget_psi))
                prev = self._streaks.get(model, 0)
                streak = prev if rows <= 0 else (prev + 1 if breached else 0)
                self._streaks[model] = streak
                sustained = streak >= self.breach_after
                newly = sustained and prev < self.breach_after
                verdict = dict(report)
                verdict.update(budget_psi=self.budget_psi, breached=breached,
                               streak=streak, sustained=sustained)
                self._verdicts[model] = verdict
                transitions.append((model, verdict, rows, newly))
        reg = self._reg()
        health = self._health
        out: dict = {}
        for model, verdict, rows, newly in transitions:
            out[model] = verdict
            if reg.enabled:
                reg.gauge("dryad_drift_breach_streak",
                          "Consecutive over-budget drift windows").labels(
                    model=model).set(verdict["streak"])
                reg.gauge("dryad_drift_sustained",
                          "1 while the model's drift breach is "
                          "sustained").labels(model=model).set(
                    1 if verdict["sustained"] else 0)
            if health is not None and self.degrade:
                if verdict["sustained"]:
                    health.degrade(f"drift:{model}",
                                   f"psi_max {verdict['psi_max']} / "
                                   f"score {verdict['score_psi']} over "
                                   f"budget {self.budget_psi}")
                elif rows > 0 or verdict["streak"] == 0:
                    health.clear(f"drift:{model}")
            if newly and self.on_breach is not None:
                self.on_breach(model, verdict)
        return out

    def warnings(self) -> list[str]:
        """``drift:<model>`` for every model in sustained breach — the
        /healthz payload's warning list (warn-only: the payload carries
        it, the status code does not)."""
        with self._lock:
            return sorted(f"drift:{m}" for m, s in self._streaks.items()
                          if s >= self.breach_after)

    def verdicts(self) -> dict:
        """The latched per-model verdicts of the last evaluation."""
        with self._lock:
            return {m: dict(v) for m, v in self._verdicts.items()}

    @property
    def ok(self) -> bool:
        with self._lock:
            return all(s < self.breach_after for s in self._streaks.values())
