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

The counterpart of ``dryad_tpu/obs/spans.py``; its trace sink (the span
ring behind ``/trace``) is not ported, so the ``trace`` id a request
carries is accepted and not recorded.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from dryad_tpu_torch.obs.registry import Registry, default_registry

SECONDS = "dryad_span_seconds_total"
COUNT = "dryad_span_count_total"

_TLS = threading.local()


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
        return False


def span(name: str, registry: Optional[Registry] = None):
    """A context manager timing one stage (nested under the thread's
    enclosing span, if any)."""
    reg = registry if registry is not None else default_registry()
    if not reg.enabled:
        return _NULL
    return _Span(reg, name)


def record_at(name: str, t0_s: float, seconds: float,
              trace: Optional[str] = None,
              registry: Optional[Registry] = None) -> None:
    """Record a completed stage that started at ``t0_s`` (a
    ``perf_counter`` time) and lasted ``seconds``; ``name`` is the full
    path."""
    reg = registry if registry is not None else default_registry()
    if not reg.enabled:
        return
    _emit(reg, name, seconds)
