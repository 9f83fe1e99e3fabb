"""Recompile tripwire: "nothing compiles after warmup" as a live alarm.

In the port a compile boundary is the first call at a (version, bucket)
shape of the serving cache, where a CUDA graph is captured on the card.
The producer calls ``note_compile(program, key)`` at each boundary; once
its expected compiles are done it calls ``arm(program)``.  A new key on
an armed program increments
``dryad_recompile_unexpected_total{program=...}`` and degrades
``/healthz`` (reason ``recompile:<program>``).  ``disarm`` opens a deploy
window (a model load compiles new shapes) and ``arm`` again closes it and
clears the degradation: re-warm and re-arm is the recovery path.
``begin_program`` starts a new generation (forgets keys, disarms).

The counterpart of ``dryad_tpu/obs/tripwire.py``; host-side only, and
``note_compile`` returns at once with the registry disabled.
"""

from __future__ import annotations

import threading
from typing import Optional

from dryad_tpu_torch.obs.health import HealthState, default_health
from dryad_tpu_torch.obs.registry import Registry, default_registry


def health_reason(program: str) -> str:
    """The degradation key, scoped per program family."""
    return f"recompile:{program}"


class RecompileTripwire:
    def __init__(self, registry: Optional[Registry] = None,
                 health: Optional[HealthState] = None):
        self._registry = registry
        self._health = health
        self._lock = threading.Lock()
        self._keys: dict[str, set] = {}      # program -> seen keys
        self._armed: dict[str, bool] = {}

    def _reg(self) -> Registry:
        return (self._registry if self._registry is not None
                else default_registry())

    def _hp(self) -> HealthState:
        return self._health if self._health is not None else default_health()

    def begin_program(self, program: str) -> None:
        """A new generation of ``program``: forget its keys, disarm, clear
        its degradation."""
        with self._lock:
            self._keys[program] = set()
            self._armed[program] = False
        self._hp().clear(health_reason(program))

    def arm(self, program: str) -> None:
        """Any further new key on ``program`` is unexpected.  A family with
        no noted key stays inert (with the registry disabled none is
        noted, and an armed empty family cannot tell expected from
        unexpected).  Arming clears the family's degradation."""
        with self._lock:
            if not self._keys.get(program):
                return
            self._armed[program] = True
        self._hp().clear(health_reason(program))

    def disarm(self, program: str) -> None:
        """Open a deploy window, keeping the key history."""
        with self._lock:
            self._armed[program] = False
        self._hp().clear(health_reason(program))

    def armed(self, program: str) -> bool:
        with self._lock:
            return bool(self._armed.get(program))

    def note_compile(self, program: str, key, detail: str = "") -> bool:
        """Record one compile boundary; True when the key is new.  A new
        key on an armed program fires the tripwire."""
        reg = self._reg()
        if not reg.enabled:
            return False
        with self._lock:
            seen = self._keys.setdefault(program, set())
            new = key not in seen
            if new:
                seen.add(key)
            fired = new and self._armed.get(program, False)
        if new:
            reg.counter("dryad_prog_compiles_total",
                        "Compile boundaries by program family").labels(
                program=program).inc()
        if fired:
            reg.counter("dryad_recompile_unexpected_total",
                        "Compiles observed after the expected-compile "
                        "budget was spent").labels(program=program).inc()
            self._hp().degrade(
                health_reason(program),
                f"unexpected recompile in {program}: "
                + (detail or f"new program key {key!r} after warmup"))
        return new


_default: Optional[RecompileTripwire] = None
_default_lock = threading.Lock()


def default_tripwire() -> RecompileTripwire:
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = RecompileTripwire()
    return _default
