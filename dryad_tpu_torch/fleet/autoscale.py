"""SLO-driven elastic capacity for the serving fleet.

The fleet's telemetry makes it measurable — exact merged per-priority
p99 gauges, sustained-breach SLO verdicts, admission depth — and without
this loop the router's only overload response is shedding.
``CapacityController`` closes the telemetry→capacity loop: it polls the
router's live signals and drives the supervisor's (now mutable) slot
registry, so a sustained p99 breach or admission-depth saturation ADDS
a replica before the router sheds users, and sustained headroom drains
one back out through the rolling push's zero-drop discipline.

Control discipline (the ``RetrainScheduler`` debounce idiom, applied to
capacity):

* **Hysteresis.**  Per-direction streak counters over the controller's
  own poll cadence: ``breach_after`` consecutive pressure polls admit a
  scale-up, ``idle_after`` consecutive headroom polls admit a
  scale-down.  Pressure is any sustained per-priority SLO verdict OR
  admission depth at ``saturation`` of ``max_inflight``; headroom is no
  breached window at all AND depth under ``idle_below`` of the cap.  A
  poll that is neither resets both streaks — flapping traffic never
  accumulates toward an action.
* **Exactly one action per burst.**  The decision is an atomic
  check-and-mark under one lock (``_admit``): an admitted action marks
  itself in flight, resets its streak, and runs on a worker thread
  OUTSIDE the lock; every refused poll is journaled as
  ``scale_skipped`` with a machine-readable reason — ``cooldown``,
  ``at-bound``, ``already-in-flight``, ``insufficient-sustain`` —
  debounced so a sustained condition journals each reason once, not
  once per poll.
* **Per-direction cooldowns.**  A finished action (either outcome)
  starts its direction's cooldown clock, so one breach burst yields one
  replica, not a ramp-to-max.
* **Bounds.**  Never below ``min_replicas``, never above
  ``max_replicas`` (the census counts slots that still represent
  capacity: not failed closed, not already retiring).

Every decision lands in the supervisor's journal next to crashes and
swaps (``scale_up`` / ``scale_down`` / ``scale_skipped`` /
``scale_failed``), and ``dryad_fleet_scale_*`` counters plus the
supervisor's ``dryad_fleet_replicas{state}`` census gauge mirror it for
scrapers.

This module imports no torch.  ``GUARDED_BY`` declares what the lock
guards, and blocking work (spawn, ready wait, drain) never happens under
the lock.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from dryad_tpu_torch.obs.registry import Registry, default_registry

#: the journaled refusal reasons (the drill and the smoke assert on
#: these exact strings)
SKIP_COOLDOWN = "cooldown"
SKIP_AT_BOUND = "at-bound"
SKIP_IN_FLIGHT = "already-in-flight"
SKIP_SUSTAIN = "insufficient-sustain"


class CapacityController:
    """Poll router signals, decide, drive the supervisor's slot pool.

    ``signals`` is a zero-argument callable returning the router's live
    view (``_RouterState.capacity_signals()`` in production; drills and
    tests inject their own):

    ``{"slo": {priority: verdict}, "inflight": int, "max_inflight": int,
    "slots": {name: {"inflight": int, ...}}}``

    where each verdict carries the ``SloGate`` keys (``breached``,
    ``sustained``).  The controller inherits the gate's hysteresis
    semantics — ``sustained`` already means ``breach_after`` consecutive
    over-budget windows — and layers its own per-direction sustain on
    top, so one slow request can never buy a replica.
    """

    GUARDED_BY = {
        "_up_streak": "_lock", "_down_streak": "_lock",
        "_cooldown_until": "_lock", "_action": "_lock",
        "_last_skip": "_lock", "_workers": "_lock",
        "_actions_total": "_lock",
    }

    def __init__(self, supervisor, signals: Callable[[], dict], *,
                 min_replicas: int, max_replicas: int,
                 breach_after: int = 2, idle_after: int = 4,
                 cooldown_up_s: float = 30.0,
                 cooldown_down_s: float = 60.0,
                 saturation: float = 0.8, idle_below: float = 0.25,
                 poll_interval_s: float = 1.0,
                 drain_timeout_s: float = 30.0,
                 registry: Optional[Registry] = None):
        if not 1 <= int(min_replicas) <= int(max_replicas):
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        if int(breach_after) < 1 or int(idle_after) < 1:
            raise ValueError("breach_after and idle_after must be >= 1")
        self.supervisor = supervisor
        self._signals = signals
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.breach_after = int(breach_after)
        self.idle_after = int(idle_after)
        self.cooldown_s = {"up": float(cooldown_up_s),
                           "down": float(cooldown_down_s)}
        self.saturation = float(saturation)
        self.idle_below = float(idle_below)
        self.poll_interval_s = float(poll_interval_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self._registry = registry
        self._lock = threading.Lock()
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown_until = {"up": 0.0, "down": 0.0}
        self._action: Optional[str] = None
        self._last_skip: dict = {"up": None, "down": None}
        self._actions_total = {"up": 0, "down": 0}
        self._workers: list = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- plumbing (all called WITHOUT the lock held) ------------------------
    def _reg(self) -> Registry:
        return (self._registry if self._registry is not None
                else default_registry())

    def _journal(self, kind: str, /, **fields) -> None:
        jr = getattr(self.supervisor, "journal", None)
        if jr is not None:
            jr(kind, **fields)

    def _count(self, name: str, help: str, **labels) -> None:
        reg = self._reg()
        if reg.enabled:
            fam = reg.counter(name, help)
            (fam.labels(**labels) if labels else fam).inc()

    # ---- lifecycle ----------------------------------------------------------
    def start(self) -> "CapacityController":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dryad-fleet-autoscale")
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None
        with self._lock:
            workers = list(self._workers)
        for t in workers:
            # an in-flight scale-up unblocks when the supervisor stops
            # (its _spawn observes the stop event); best-effort join —
            # the supervisor's teardown sweep reaps any child either way
            t.join(timeout=timeout_s)

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poke()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                self._journal("autoscale_error", message=str(e)[:300])

    # ---- the decision pass --------------------------------------------------
    def _census(self) -> int:
        """Slots that still represent capacity (bound accounting):
        failed-closed slots serve nothing and retiring slots are already
        leaving, so neither counts against the bounds."""
        return sum(1 for s in self.supervisor.slots
                   if not s.fail_closed and not s.retiring)

    def _classify(self, sig: dict) -> tuple:
        """(pressure, headroom, why) from one signals sample."""
        slo = sig.get("slo") or {}
        inflight = int(sig.get("inflight") or 0)
        max_inflight = int(sig.get("max_inflight") or 0)
        sustained = sorted(p for p, v in slo.items() if v.get("sustained"))
        breached = sorted(p for p, v in slo.items()
                          if v.get("breached") or v.get("sustained"))
        saturated = (max_inflight > 0
                     and inflight >= self.saturation * max_inflight)
        pressure = bool(sustained) or saturated
        headroom = (not breached and max_inflight > 0
                    and inflight <= self.idle_below * max_inflight)
        why = {"inflight": inflight, "max_inflight": max_inflight,
               "slo_sustained": sustained, "saturated": saturated}
        return pressure, headroom, why

    def _admit(self, pressure: bool, headroom: bool,
               census: int) -> tuple:
        """The atomic check-and-mark: advance the streaks and either
        claim the action (marking it in flight so a concurrent poke —
        or the next poll during a slow spawn — cannot double-launch) or
        produce the refusal reason.  Returns ``(decision, direction,
        reason, journal_skip)``; everything else (journal, metrics, the
        action itself) happens OUTSIDE the lock: split the check from
        the mark and two concurrent pokes both launch."""
        now = time.monotonic()
        with self._lock:
            if pressure:
                self._down_streak = 0
                self._up_streak += 1
                direction, streak, sustain_n = ("up", self._up_streak,
                                                self.breach_after)
                bound_hit = census >= self.max_replicas
            elif headroom:
                self._up_streak = 0
                self._down_streak += 1
                direction, streak, sustain_n = ("down", self._down_streak,
                                                self.idle_after)
                bound_hit = census <= self.min_replicas
            else:
                self._up_streak = 0
                self._down_streak = 0
                self._last_skip = {"up": None, "down": None}
                return None, None, None, False
            if self._action is not None:
                reason = SKIP_IN_FLIGHT
            elif bound_hit:
                reason = SKIP_AT_BOUND
            elif streak < sustain_n:
                reason = SKIP_SUSTAIN
            elif now < self._cooldown_until[direction]:
                reason = SKIP_COOLDOWN
            else:
                self._action = direction
                if direction == "up":
                    self._up_streak = 0
                else:
                    self._down_streak = 0
                self._last_skip[direction] = None
                return ("scale_up" if direction == "up" else "scale_down",
                        direction, None, False)
            journal_skip = reason != self._last_skip[direction]
            self._last_skip[direction] = reason
            return None, direction, reason, journal_skip

    def poke(self) -> Optional[str]:
        """One decision pass (the poll loop's body; drills call it
        directly).  Returns the admitted decision kind or None."""
        sig = self._signals()
        pressure, headroom, why = self._classify(sig)
        census = self._census()
        decision, direction, reason, journal_skip = self._admit(
            pressure, headroom, census)
        self.supervisor.gauge_replicas()
        if decision is None:
            if journal_skip:
                self._journal("scale_skipped", direction=direction,
                              reason=reason, replicas=census, **why)
                self._count("dryad_fleet_scale_skipped_total",
                            "Refused capacity decisions by reason",
                            direction=direction, reason=reason)
            return None
        t = threading.Thread(
            target=self._run_action, args=(decision, census, why),
            daemon=True, name=f"dryad-fleet-scale-{direction}")
        with self._lock:
            self._workers = [w for w in self._workers if w.is_alive()]
            self._workers.append(t)
        t.start()
        return decision

    # ---- the actions (worker thread; no controller lock held) ---------------
    def _run_action(self, decision: str, census: int, why: dict) -> None:
        direction = "up" if decision == "scale_up" else "down"
        try:
            if decision == "scale_up":
                slot = self.supervisor.add_slot()
                if slot is not None:
                    self._journal("scale_up", replica=slot.name,
                                  replicas=census + 1, **why)
                    self._count("dryad_fleet_scale_up_total",
                                "Replicas added by the capacity loop")
                else:
                    self._journal("scale_failed", direction="up",
                                  replicas=census, **why)
            else:
                victim = self._pick_victim()
                if victim is not None and self.supervisor.retire_slot(
                        victim.name, drain_timeout_s=self.drain_timeout_s):
                    self._journal("scale_down", replica=victim.name,
                                  replicas=census - 1, **why)
                    self._count("dryad_fleet_scale_down_total",
                                "Replicas drained out by the capacity "
                                "loop")
                else:
                    self._journal("scale_failed", direction="down",
                                  replicas=census,
                                  replica=(victim.name if victim else None),
                                  **why)
        finally:
            now = time.monotonic()
            with self._lock:
                self._action = None
                self._cooldown_until[direction] = (
                    now + self.cooldown_s[direction])
                self._actions_total[direction] += 1
        self.supervisor.gauge_replicas()

    def _pick_victim(self):
        """Highest-index routable slot — the most recently added
        capacity leaves first, and the fleet never drains its last
        routable replica (capacity below ``min_replicas`` is a bound
        violation; zero routable is an outage)."""
        routable = self.supervisor.routable_slots()
        if len(routable) < 2:
            return None
        return max(routable, key=lambda s: s.index)

    # ---- observability ------------------------------------------------------
    def state(self) -> dict:
        with self._lock:
            return {
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "up_streak": self._up_streak,
                "down_streak": self._down_streak,
                "action_in_flight": self._action,
                "cooldown_until": dict(self._cooldown_until),
                "actions_total": dict(self._actions_total),
            }
