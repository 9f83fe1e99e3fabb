"""Per-priority latency SLO gates over the mergeable log histograms.

``SloGate`` turns declared per-priority budgets into a verdict over
histogram states (``registry.LOG_BUCKETS``): a window whose quantile
exceeds its budget advances a breach streak, ``breach_after`` consecutive
ones degrade ``slo:<priority>`` in the health state, and a non-empty
in-budget window clears it.  An empty window is no evidence: streak and
degradation hold.

Evaluation runs on the observer's cadence (a probe, a bench report),
never per request; it reads states the caller already holds.  Stdlib
only, no torch.  Lock contract: ``_lock`` guards the streaks; the health
state and the gauges are updated outside it.

The counterpart of ``dryad_tpu/obs/slo.py``; its caller, the fleet
router, is not ported yet.
"""

from __future__ import annotations

import threading
from typing import Optional

from dryad_tpu_torch.obs.health import HealthState, default_health
from dryad_tpu_torch.obs.registry import Registry, default_registry, hist_quantile

#: default budgets, milliseconds — deliberately generous: the gate ships
#: as a tripwire for serving cliffs, not a 1% latency referee (the same
#: stance as the bench trend tolerance)
DEFAULT_BUDGETS_MS = {"interactive": 250.0, "bulk": 2000.0}


def parse_budgets(spec: str) -> dict:
    """``"interactive=250,bulk=2000"`` -> {"interactive": 250.0, ...}
    (the CLI flag shape); empty spec -> the defaults; ``off``/``none``
    -> ``{}``, which disables SLO health-gating entirely (a gate with no
    budgets never degrades)."""
    if not spec:
        return dict(DEFAULT_BUDGETS_MS)
    if spec.strip().lower() in ("off", "none"):
        return {}
    out = {}
    for part in spec.split(","):
        name, _, val = part.partition("=")
        if not name or not val:
            raise ValueError(f"bad SLO budget {part!r} "
                             "(want priority=milliseconds, or 'off')")
        out[name.strip()] = float(val)
    return out


class SloGate:
    """Sustained-breach evaluation of per-priority p-quantile budgets."""

    GUARDED_BY = {"_streaks": "_lock"}

    def __init__(self, budgets_ms: Optional[dict] = None, *,
                 quantile: float = 0.99, breach_after: int = 3,
                 registry: Optional[Registry] = None,
                 health: Optional[HealthState] = None):
        self.budgets_ms = dict(budgets_ms if budgets_ms is not None
                               else DEFAULT_BUDGETS_MS)
        self.quantile = float(quantile)
        self.breach_after = int(breach_after)
        self._registry = registry
        self._health = health
        self._lock = threading.Lock()
        self._streaks: dict[str, int] = {}

    def _reg(self) -> Registry:
        return (self._registry if self._registry is not None
                else default_registry())

    def _hstate(self) -> HealthState:
        return (self._health if self._health is not None
                else default_health())

    def evaluate(self, states: dict) -> dict:
        """One evaluation pass.  ``states`` maps priority -> a histogram
        ``(counts, sum, count)`` state on the fixed log scheme — a
        WINDOW of recent traffic (the router passes the delta since the
        previous evaluation), not a lifetime cumulative: cumulative
        state would let history dilute both breach detection and
        recovery.  Verdicts per priority: a window whose quantile
        exceeds its budget advances the breach streak; ``breach_after``
        consecutive breached windows degrade ``slo:<priority>``; an
        in-budget NON-EMPTY window clears it.  An EMPTY window (no
        traffic since the last evaluation) is no evidence either way —
        the streak and any active degradation HOLD, so a burst-induced
        incident neither clears itself through silence nor does silence
        ever raise one."""
        verdicts: dict = {}
        transitions: list = []
        with self._lock:
            for priority, budget_ms in sorted(self.budgets_ms.items()):
                counts, _total, n = states.get(priority) or ([], 0.0, 0)
                # n <= 0 is the empty/no-evidence case — including a
                # degenerate negative window a buggy caller could hand
                # us; it must hold, never flip verdicts
                p_ms = (hist_quantile(counts, self.quantile) * 1e3
                        if n > 0 else 0.0)
                breached = n > 0 and p_ms > budget_ms
                if n <= 0:
                    streak = self._streaks.get(priority, 0)   # hold
                else:
                    streak = self._streaks.get(priority, 0) + 1 \
                        if breached else 0
                self._streaks[priority] = streak
                sustained = streak >= self.breach_after
                verdicts[priority] = {
                    "p_ms": round(p_ms, 3), "budget_ms": budget_ms,
                    "count": int(n), "breached": breached,
                    "streak": streak, "sustained": sustained,
                }
                transitions.append((priority, p_ms, n, streak, sustained))
        # mirrors OUTSIDE _lock: health and registry own their locks
        reg = self._reg()
        health = self._hstate()
        for priority, p_ms, n, streak, sustained in transitions:
            if sustained:
                health.degrade(
                    f"slo:{priority}",
                    f"p{int(self.quantile * 100)} {p_ms:.1f} ms over "
                    f"budget {self.budgets_ms[priority]:.0f} ms "
                    f"({streak} consecutive windows)")
            elif n > 0 or streak == 0:
                # recovery needs evidence (a non-empty in-budget window)
                # or a never-breached priority; an empty window holds
                health.clear(f"slo:{priority}")
            if reg.enabled:
                reg.gauge("dryad_slo_p_ms",
                          "Evaluated per-priority SLO window quantile").labels(
                    priority=priority).set(p_ms)
                reg.gauge("dryad_slo_breach_streak",
                          "Consecutive over-budget windows").labels(
                    priority=priority).set(streak)
        return verdicts

    @property
    def ok(self) -> bool:
        """False while any priority's breach is sustained."""
        with self._lock:
            return all(s < self.breach_after for s in self._streaks.values())
