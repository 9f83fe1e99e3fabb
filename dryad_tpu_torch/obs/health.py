"""Process health state behind ``/healthz``.

Subsystems raise named degradation reasons and clear them on recovery
(the recompile tripwire raises ``recompile:<program>``); ``/healthz``
answers 200 ``{"ok": true}`` while the set is empty and 503 ``{"ok":
false, "degraded": [...]}`` otherwise.  The set mirrors into the registry
as the ``dryad_health_degraded{reason=...}`` gauge.  The counterpart of
``dryad_tpu/obs/health.py``.
"""

from __future__ import annotations

import threading
from typing import Optional

from dryad_tpu_torch.obs.registry import Registry, default_registry

_GAUGE = "dryad_health_degraded"
_GAUGE_HELP = "1 while the named degradation is active"


class HealthState:
    """A named set of active degradation reasons, mirrored to a gauge."""

    GUARDED_BY = {"_reasons": "_lock"}

    def __init__(self, registry: Optional[Registry] = None):
        self._lock = threading.Lock()
        self._reasons: dict[str, str] = {}   # reason -> detail
        self._registry = registry

    def _reg(self) -> Registry:
        # resolved at each call, so a swapped default registry is seen
        return (self._registry if self._registry is not None
                else default_registry())

    def degrade(self, reason: str, detail: str = "") -> None:
        with self._lock:
            self._reasons[str(reason)] = str(detail)
        reg = self._reg()
        if reg.enabled:
            reg.gauge(_GAUGE, _GAUGE_HELP).labels(reason=reason).set(1)

    def clear(self, reason: str) -> None:
        with self._lock:
            self._reasons.pop(str(reason), None)
        reg = self._reg()
        if reg.enabled:
            reg.gauge(_GAUGE, _GAUGE_HELP).labels(reason=reason).set(0)

    @property
    def ok(self) -> bool:
        with self._lock:
            return not self._reasons

    def reasons(self) -> dict[str, str]:
        with self._lock:
            return dict(self._reasons)


def healthz_payload(health: Optional[HealthState] = None) -> tuple[int, dict]:
    """(status code, body) of a ``/healthz`` GET."""
    h = health if health is not None else default_health()
    if h.ok:
        return 200, {"ok": True}
    return 503, {"ok": False, "degraded": sorted(h.reasons())}


_default: Optional[HealthState] = None
_default_lock = threading.Lock()


def default_health() -> HealthState:
    """The process-wide health state every ``/healthz`` serves."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = HealthState()
    return _default
