"""Chrome trace_event export of the span ring, the run journal and the
stage walls, loadable in Perfetto or ``chrome://tracing``.

* **spans**: complete events (``ph: "X"``) under pid 1, one track per
  thread, captured by ``SpanTrace``, a bounded ring installed as the span
  trace sink (``enable_tracing()``).  A child span's interval lies inside
  its parent's on the same tid, and at equal ts the longer event sorts
  first, so viewers stack them.
* **journal events**: instant events (``ph: "i"``) under pid 2, on the
  journal's own run-relative clock (``elapsed_s``).
* **stage walls**: complete events under pid 3, laid back to back; a
  probe's wall is a minimum of timed runs (``engine/probes.py``), not a
  recorded timeline.

``fleet_trace_events`` merges several processes' span tracks onto one
clock, keeping the trace-tagged events of a tail sample (``TailSampler``).
Consumers: ``GET /trace`` of the metrics exporter and the HTTP front end,
and ``train --trace-out``.  Stdlib only, no torch.

The counterpart of ``dryad_tpu/obs/trace_export.py``, with its pids and
ordering rules.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Optional, Sequence

from dryad_tpu_torch.obs import spans

#: ring capacity: ~64k spans ≈ hours of chunked training at obs cadence
DEFAULT_CAPACITY = 65536


class SpanTrace:
    """Bounded thread-safe ring of completed spans ``(path, t0_s, dur_s,
    tid, trace)`` — the span trace sink (spans.set_trace_sink).  ``trace``
    is the request's trace id or None for untagged spans."""

    GUARDED_BY = {"_events": "_lock", "dropped": "_lock"}

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._events: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self.dropped = 0

    def record(self, path: str, t0_s: float, dur_s: float,
               trace: Optional[str] = None) -> None:
        tid = threading.get_ident() & 0xFFFF
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append((path, t0_s, dur_s, tid, trace))

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def export(self) -> tuple:
        """(events, dropped) in one consistent read — the shape the
        ``/trace/events`` endpoint serializes."""
        with self._lock:
            return list(self._events), self.dropped

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0


_default: Optional[SpanTrace] = None
_default_lock = threading.Lock()


def enable_tracing(capacity: int = DEFAULT_CAPACITY) -> SpanTrace:
    """Install (idempotently) the process-default SpanTrace as the span
    sink and return it.  Spans record into it only while the registry is
    enabled (the zero-cost-disabled contract is untouched).  The ring is
    process-wide and NOT cleared here (a live /trace endpoint may still
    be serving it); a caller scoping a trace to one run clears the
    returned buffer itself — the train CLI's --trace-out does.  A
    ``capacity`` different from the existing default ring's is ignored."""
    global _default
    with _default_lock:
        if _default is None:
            _default = SpanTrace(capacity)
    spans.set_trace_sink(_default.record)
    return _default


def disable_tracing() -> None:
    spans.set_trace_sink(None)


def default_trace() -> Optional[SpanTrace]:
    return _default


def active_trace() -> Optional[SpanTrace]:
    """The SpanTrace actually receiving spans right now: the ring whose
    bound ``record`` is installed as the sink (a test/caller-scoped ring
    counts), else the process default.  Consumers that SERVE the ring
    (the fleet router's /trace) resolve through this, so they follow
    whatever sink is live instead of insisting on the default."""
    sink = spans._TRACE_SINK
    if sink is None:
        return None
    owner = getattr(sink, "__self__", None)
    return owner if isinstance(owner, SpanTrace) else _default


def tracing_active(registry=None) -> bool:
    """Whether request tracing is ON: a span ring is installed AND the
    registry records.  This is the per-request gate the serve/fleet
    request paths check FIRST — when it is False the request path mints
    no trace id and allocates no per-request context (the zero-cost-
    disabled contract, same idiom as the spans null context)."""
    from dryad_tpu_torch.obs.registry import default_registry

    reg = registry if registry is not None else default_registry()
    return reg.enabled and spans.sink_active()


class TailSampler:
    """Tail sampling for merged traces: remember the slowest requests.

    ``observe(trace_id, dur_s)`` is O(window) only on eviction, O(1)
    amortized; ``slowest(k)`` returns the trace ids of the k slowest
    requests inside the current window (the last ``window`` observed
    requests).  The merged ``/trace`` endpoint keeps FULL span detail
    for those ids and drops the per-request detail of everything else,
    bounding trace size under sustained load while guaranteeing the
    interesting (slow) requests keep their whole story."""

    GUARDED_BY = {"_ring": "_lock"}

    def __init__(self, window: int = 512):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=int(window))

    def observe(self, trace_id: Optional[str], dur_s: float) -> None:
        if trace_id is None:
            return
        with self._lock:
            self._ring.append((float(dur_s), str(trace_id)))

    def slowest(self, k: int) -> set:
        """Trace ids of the ``k`` slowest requests in the window
        (``k <= 0`` means keep everything observed)."""
        with self._lock:
            items = list(self._ring)
        if k <= 0:
            return {t for _, t in items}
        items.sort(key=lambda x: -x[0])
        return {t for _, t in items[:int(k)]}


def _span_event(ev, pid: int, offset_s: float = 0.0) -> dict:
    """ONE renderer for a ring event ``(path, t0_s, dur_s, tid[,
    trace])`` → a Chrome complete event — shared by the single-process
    and fleet documents so the tuple shape has exactly one decoder."""
    path, t0, dur, tid = ev[:4]
    trace = ev[4] if len(ev) > 4 else None
    args = {"path": str(path)}
    if trace is not None:
        args["trace"] = str(trace)
    return {
        "ph": "X", "cat": "span", "pid": int(pid), "tid": int(tid),
        "name": str(path).rsplit("/", 1)[-1],
        "ts": round((float(t0) + offset_s) * 1e6, 3),
        "dur": round(float(dur) * 1e6, 3),
        "args": args,
    }


def to_trace_events(span_events: Sequence = (),
                    journal_events: Sequence[dict] = (),
                    stages: Sequence[dict] = ()) -> list:
    """One flat, ts-sorted trace_event list from the three sources.
    Timestamps are microseconds; span ts keep their perf_counter origin
    (arbitrary but shared), journal ts are run-relative (own pid)."""
    meta = [
        {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
         "args": {"name": "dryad spans (host walls)"}},
        {"ph": "M", "pid": 2, "tid": 0, "name": "process_name",
         "args": {"name": "dryad journal (run-relative)"}},
        {"ph": "M", "pid": 3, "tid": 0, "name": "process_name",
         "args": {"name": "dryad stage walls (timed-fori minima)"}},
    ]
    evs = [_span_event(ev, pid=1) for ev in span_events]
    for e in journal_events:
        args = {k: v for k, v in e.items()
                if k not in ("event", "elapsed_s")
                and isinstance(v, (str, int, float, bool))}
        evs.append({
            "ph": "i", "cat": "journal", "pid": 2, "tid": 0, "s": "p",
            "name": str(e.get("event", "event")),
            "ts": round(float(e.get("elapsed_s", 0.0)) * 1e6, 3),
            "args": args,
        })
    cursor = 0.0
    for st in stages:
        name = str(st.get("stage", "stage"))
        if st.get("arm"):
            name = f"{name}[{st['arm']}]"
        dur = max(float(st.get("ms", 0.0)) * 1e3, 0.0)
        args = {k: v for k, v in st.items()
                if isinstance(v, (str, int, float, bool))}
        evs.append({"ph": "X", "cat": "stage", "pid": 3, "tid": 0,
                    "name": name, "ts": round(cursor, 3),
                    "dur": round(dur, 3), "args": args})
        cursor += dur
    # monotonic ts; longer events first at equal ts so nesting stacks
    evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
    return meta + evs


def dumps_trace(span_events: Sequence = (),
                journal_events: Sequence[dict] = (),
                stages: Sequence[dict] = ()) -> str:
    """The loadable JSON document (object form, ms display unit)."""
    return json.dumps({
        "traceEvents": to_trace_events(span_events, journal_events, stages),
        "displayTimeUnit": "ms",
    })


def write_trace(path: str, span_events: Sequence = (),
                journal_events: Sequence[dict] = (),
                stages: Sequence[dict] = ()) -> None:
    with open(path, "w") as f:
        f.write(dumps_trace(span_events, journal_events, stages))
        f.write("\n")


# ---------------------------------------------------------------------------
# fleet trace assembly: one merged, clock-aligned document


def fleet_trace_events(tracks: Sequence[dict],
                       journal_events: Sequence[dict] = (),
                       keep: Optional[set] = None) -> list:
    """One merged trace from per-process span tracks.

    Each track is ``{"pid": int, "name": str, "events": [(path, t0_s,
    dur_s, tid, trace), ...], "offset_s": float}`` — ``offset_s`` maps
    the process's ``perf_counter`` origin onto the shared wall clock
    (the registration-time clock handshake), so router and replica spans
    line up on ONE timeline.  ``keep`` (when not None) is the tail
    sample: trace-TAGGED events survive only if their id is in it;
    untagged infrastructure spans always survive.  Journal events ride
    their own pid-0 track on the journal's run-relative clock (they
    annotate, not align — same convention as ``to_trace_events``)."""
    meta = [{"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
             "args": {"name": "fleet journal (run-relative)"}}]
    evs = []
    for e in journal_events:
        args = {k: v for k, v in e.items()
                if k not in ("event", "elapsed_s")
                and isinstance(v, (str, int, float, bool))}
        evs.append({"ph": "i", "cat": "journal", "pid": 0, "tid": 0,
                    "s": "p", "name": str(e.get("event", "event")),
                    "ts": round(float(e.get("elapsed_s", 0.0)) * 1e6, 3),
                    "args": args})
    for track in tracks:
        pid = int(track["pid"])
        meta.append({"ph": "M", "pid": pid, "tid": 0,
                     "name": "process_name",
                     "args": {"name": str(track["name"])}})
        offset = float(track.get("offset_s") or 0.0)
        for ev in track["events"]:
            trace = ev[4] if len(ev) > 4 else None
            if keep is not None and trace is not None and trace not in keep:
                continue
            evs.append(_span_event(ev, pid=pid, offset_s=offset))
    evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
    return meta + evs


def dumps_fleet_trace(tracks: Sequence[dict],
                      journal_events: Sequence[dict] = (),
                      keep: Optional[set] = None) -> str:
    return json.dumps({
        "traceEvents": fleet_trace_events(tracks, journal_events, keep),
        "displayTimeUnit": "ms",
    })
