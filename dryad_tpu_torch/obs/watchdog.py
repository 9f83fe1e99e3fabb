"""Fetch-stall watchdog: the age of an in-flight fetch as a live gauge.

A device-to-host fetch that waits behind a hung or starved card is
visible only after the fact, unless something watches it while it is
pending.  The boosting loop brackets each of its real fetch sites
(``engine/train.py``: ``eval``, ``checkpoint``, ``final``) with
``watch_fetch(site, iteration)``, and a daemon monitor thread exports

* ``dryad_fetch_inflight_age_seconds`` (gauge): age of the OLDEST
  in-flight fetch, 0 when idle;
* ``dryad_fetch_stalls_total{site=...}`` (counter): fetches whose age
  crossed the stall threshold (default 30 s; ``DRYAD_FETCH_STALL_S``
  overrides);
* ``/healthz`` degraded (reason ``fetch_stall``) while any watched fetch
  is past the threshold, cleared when it completes.

``last_stall()`` keeps the latest stall's (site, iteration, age).

Host-side only (it reads wall clocks; it never touches a tensor), and
zero-cost when the registry is disabled: ``watch_fetch`` returns a shared
null context before touching the clock, and the monitor thread exists
only once a watched fetch was seen on an enabled registry.  The
counterpart of ``dryad_tpu/obs/watchdog.py``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from dryad_tpu_torch.obs.health import HealthState, default_health
from dryad_tpu_torch.obs.registry import Registry, default_registry

#: stall threshold default
STALL_THRESHOLD_S = 30.0
HEALTH_REASON = "fetch_stall"


class _NullWatch:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullWatch()


class _Watch:
    __slots__ = ("_dog", "site", "iteration", "token")

    def __init__(self, dog: "FetchWatchdog", site: str, iteration: int):
        self._dog = dog
        self.site = site
        self.iteration = iteration
        self.token = None

    def __enter__(self):
        self.token = self._dog.begin(self.site, self.iteration)
        return self

    def __exit__(self, *exc):
        self._dog.end(self.token)
        return False


class FetchWatchdog:
    """Tracks in-flight fetches and exports their age from a monitor
    thread.  One instance serves the whole process (``default_watchdog``);
    tests build private ones with tiny thresholds.

    ``_lock`` guards the in-flight table and its token counter (producer
    threads begin/end watches while the monitor ticks ages); gauge and
    counter publication happens OUTSIDE the lock so a contended registry
    family never extends this critical section."""

    GUARDED_BY = {"_inflight": "_lock", "_next_token": "_lock",
                  "_last_stall": "_lock", "_thread": "_lock"}

    def __init__(self, registry: Optional[Registry] = None,
                 threshold_s: Optional[float] = None,
                 poll_interval_s: float = 0.5,
                 health: Optional[HealthState] = None):
        if threshold_s is None:
            try:
                threshold_s = float(
                    os.environ.get("DRYAD_FETCH_STALL_S", "")
                    or STALL_THRESHOLD_S)
            except ValueError:
                threshold_s = STALL_THRESHOLD_S
        self.threshold_s = float(threshold_s)
        self.poll_interval_s = float(poll_interval_s)
        self._registry = registry
        self._health = health
        self._lock = threading.Lock()
        self._inflight: dict[int, dict] = {}
        self._next_token = 0
        self._last_stall: Optional[dict] = None
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()

    def _reg(self) -> Registry:
        return (self._registry if self._registry is not None
                else default_registry())

    def _hp(self) -> HealthState:
        return self._health if self._health is not None else default_health()

    # ---- producer side (the trainer's fetch sites) -------------------------
    def watch(self, site: str, iteration: int):
        """Context manager bracketing ONE real device->host fetch.  The
        null context comes back when the registry is disabled (the
        zero-cost contract)."""
        if not self._reg().enabled:
            return _NULL
        return _Watch(self, site, int(iteration))

    def begin(self, site: str, iteration: int) -> Optional[int]:
        reg = self._reg()
        if not reg.enabled:
            return None
        now = time.perf_counter()
        with self._lock:
            token = self._next_token
            self._next_token += 1
            self._inflight[token] = {"site": str(site),
                                     "iteration": int(iteration),
                                     "t0": now, "stalled": False}
            oldest = now - min(w["t0"] for w in self._inflight.values())
        # publish the gauge at begin time so the family exists from the
        # FIRST watched fetch (scrapers see 0 rather than nothing); the
        # monitor ticks it upward while the fetch is pending
        reg.gauge("dryad_fetch_inflight_age_seconds",
                  "Age of the oldest in-flight device fetch").set(
            round(oldest, 3))
        self._ensure_thread()
        self._wake.set()
        return token

    def end(self, token: Optional[int]) -> None:
        if token is None:
            return
        now = time.perf_counter()
        with self._lock:
            info = self._inflight.pop(token, None)
            any_stalled = any(w["stalled"] for w in self._inflight.values())
            if info is not None and info["stalled"]:
                self._last_stall = {
                    "site": info["site"], "iteration": info["iteration"],
                    "age_s": round(now - info["t0"], 3), "ended_at": now}
            idle = not self._inflight
        reg = self._reg()
        if reg.enabled and idle:
            reg.gauge("dryad_fetch_inflight_age_seconds",
                      "Age of the oldest in-flight device fetch").set(0.0)
        if info is not None and info["stalled"] and not any_stalled:
            self._hp().clear(HEALTH_REASON)

    def last_stall(self) -> Optional[dict]:
        """Most recent completed-or-aborted stall (site, iteration, age_s,
        ended_at perf_counter timestamp); None until a stall was seen."""
        with self._lock:
            return dict(self._last_stall) if self._last_stall else None

    # ---- monitor thread ----------------------------------------------------
    def _ensure_thread(self) -> None:
        # double-checked fast path: the per-begin() liveness probe; the
        # locked re-check below is the authoritative spawn decision
        # dryadlint: disable=guarded-by -- benign double-checked read (see above)
        if self._thread is None or not self._thread.is_alive():
            with self._lock:
                if self._thread is None or not self._thread.is_alive():
                    self._thread = threading.Thread(
                        target=self._run, daemon=True,
                        name="dryad-fetch-watchdog")
                    self._thread.start()

    def _run(self) -> None:
        while True:
            with self._lock:
                busy = bool(self._inflight)
            if not busy:
                # park until the next begin() (no spin while idle)
                self._wake.wait()
                self._wake.clear()
                continue
            self._tick()
            time.sleep(self.poll_interval_s)

    def _tick(self) -> None:
        now = time.perf_counter()
        newly_stalled = []
        with self._lock:
            if not self._inflight:
                return
            oldest = max(now - w["t0"] for w in self._inflight.values())
            for w in self._inflight.values():
                if not w["stalled"] and now - w["t0"] >= self.threshold_s:
                    w["stalled"] = True
                    newly_stalled.append((w["site"], w["iteration"]))
        reg = self._reg()
        if reg.enabled:
            reg.gauge("dryad_fetch_inflight_age_seconds",
                      "Age of the oldest in-flight device fetch").set(
                round(oldest, 3))
            for site, iteration in newly_stalled:
                reg.counter("dryad_fetch_stalls_total",
                            "Fetches pending past the stall threshold"
                            ).labels(site=site).inc()
        if newly_stalled:
            site, iteration = newly_stalled[-1]
            self._hp().degrade(
                HEALTH_REASON,
                f"fetch at {site} (iteration {iteration}) pending "
                f">{self.threshold_s:g}s")


_default: Optional[FetchWatchdog] = None
_default_lock = threading.Lock()


def default_watchdog() -> FetchWatchdog:
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = FetchWatchdog()
    return _default


def set_default_watchdog(dog: FetchWatchdog) -> FetchWatchdog:
    """Swap the process default (tests use tiny thresholds); returns the
    old one so callers can restore it."""
    global _default
    with _default_lock:
        old = _default if _default is not None else FetchWatchdog()
        _default = dog
    return old


def watch_fetch(site: str, iteration: int):
    """Module-level convenience over the default watchdog, the form the
    boosting loop's fetch sites use."""
    return default_watchdog().watch(site, iteration)
