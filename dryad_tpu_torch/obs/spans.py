"""Stage spans over the registry: per-path wall seconds and counts.

    with span("serve.collect"):
        ... host-side work ...

Each exit adds the span's wall seconds to ``dryad_span_seconds_total`` and
1 to ``dryad_span_count_total``, labeled with its path; a span opened
inside another on the same thread records under ``parent/name``.
``record_at`` records a stage that already ended, from timestamps the
caller carried (the serving request path stamps its stages across the
batcher's threads).  The timing is host wall around work the caller
already does; no span adds a device synchronisation.  With the registry
disabled ``span`` returns one shared null context and ``record_at``
returns at once: nothing is allocated.

``record`` records a stage that just ended, from its duration (the
training loop's per-iteration series).

A trace sink (``set_trace_sink``) receives every completed span as
``(path, t0_s, dur_s[, trace])``, the request's trace id included:
``obs/trace_export.py`` installs its ring there and renders Chrome
trace_event JSON from it.  The sink fires only while the registry
records, and an exception in it never reaches the caller.

The counterpart of ``dryad_tpu/obs/spans.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from dryad_tpu_torch.obs.registry import Registry, default_registry

SECONDS = "dryad_span_seconds_total"
COUNT = "dryad_span_count_total"

_TLS = threading.local()

#: the trace sink: None, or a callable(path, t0_s, dur_s[, trace])
_TRACE_SINK = None


def set_trace_sink(sink) -> None:
    """Install (or clear, with None) the span trace sink; it must be cheap
    and accept ``(path, t0_s, dur_s)`` and an optional fourth ``trace``
    argument (``trace_export.SpanTrace.record``)."""
    global _TRACE_SINK
    _TRACE_SINK = sink


def sink_active() -> bool:
    """Whether a span trace sink is installed."""
    return _TRACE_SINK is not None


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


def _emit(reg: Registry, path: str, seconds: float) -> None:
    # the count before the seconds: a scrape between the two sees at worst
    # a span counted with its wall not yet summed
    reg.counter(COUNT, "Completions per span path").labels(span=path).inc()
    reg.counter(SECONDS, "Aggregate wall seconds per span path").labels(
        span=path).inc(seconds)


class _Span:
    __slots__ = ("_reg", "name", "path", "_t0")

    def __init__(self, reg: Registry, name: str):
        self._reg = reg
        self.name = name
        self.path = name
        self._t0 = 0.0

    def __enter__(self):
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        if stack:
            self.path = stack[-1].path + "/" + self.name
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        stack = _TLS.stack
        if stack and stack[-1] is self:
            stack.pop()
        _emit(self._reg, self.path, dt)
        sink = _TRACE_SINK
        if sink is not None:
            try:
                sink(self.path, self._t0, dt)
            except Exception:   # noqa: BLE001 — tracing never breaks
                pass            # the caller
        return False


def span(name: str, registry: Optional[Registry] = None):
    """A context manager timing one stage (nested under the thread's
    enclosing span, if any)."""
    reg = registry if registry is not None else default_registry()
    if not reg.enabled:
        return _NULL
    return _Span(reg, name)


def record(name: str, seconds: float,
           registry: Optional[Registry] = None) -> None:
    """Record a stage that just ended and lasted ``seconds``; ``name`` is
    the full path (no nesting prefix)."""
    reg = registry if registry is not None else default_registry()
    if not reg.enabled:
        return
    _emit(reg, name, seconds)
    sink = _TRACE_SINK
    if sink is not None:
        try:
            # the stage just ended: its start is its duration ago
            sink(name, time.perf_counter() - seconds, seconds)
        except Exception:   # noqa: BLE001 — tracing never breaks the caller
            pass


def record_at(name: str, t0_s: float, seconds: float,
              trace: Optional[str] = None,
              registry: Optional[Registry] = None) -> None:
    """Record a completed stage that started at ``t0_s`` (a
    ``perf_counter`` time) and lasted ``seconds``; ``name`` is the full
    path; ``trace`` is the request's trace id, kept in the trace sink."""
    reg = registry if registry is not None else default_registry()
    if not reg.enabled:
        return
    _emit(reg, name, seconds)
    sink = _TRACE_SINK
    if sink is not None:
        try:
            sink(name, t0_s, seconds, trace)
        except Exception:   # noqa: BLE001 — tracing never breaks the caller
            pass


def snapshot(registry: Optional[Registry] = None) -> dict:
    """``{path: {"count": n, "total_s": s, "mean_ms": m}}``: the span slice
    of the registry, as ``/stats`` serves it."""
    reg = registry if registry is not None else default_registry()
    walls = reg.counter(SECONDS).series()     # the seconds first (_emit)
    counts = reg.counter(COUNT).series()
    out = {}
    for lbl, total in walls.items():
        # the label block is span="<path>"
        path = lbl.split('"', 2)[1] if '"' in lbl else lbl
        n = counts.get(lbl, 0.0)
        out[path] = {"count": int(n), "total_s": round(total, 6),
                     "mean_ms": round(total / n * 1e3, 3) if n else 0.0}
    return out
