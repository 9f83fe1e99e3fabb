"""Process-wide telemetry registry: counters, gauges and log-bucket
histograms, read as one ``snapshot()`` dict or as the Prometheus text
``exposition()`` that ``/metrics`` serves.

The counterpart of ``dryad_tpu/obs/registry.py``, less its linear
histogram kind.  Its contracts hold here too:

* host-side only: producers record values the host already holds (a wall
  delta, a count, a queue depth), never a device tensor;
* zero-cost when disabled: every record method's first action is the
  ``enabled`` check, and the disabled path allocates nothing;
* thread-safe when enabled: one lock per family, so concurrent writers
  never lose an increment.

``default_registry()`` is created enabled unless ``DRYAD_OBS=0``.

Histograms use one fixed layout, ``LOG_BUCKETS`` (10 buckets a decade
from 0.1 ms to 100 s): observing is O(1), and two processes' counts add
exactly, so the layout is the reference's and series merge across
packages.  ``hist_quantile`` is the nearest-rank readout.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Optional, Sequence

COUNTER = "counter"
GAUGE = "gauge"
LOG_HISTOGRAM = "loghistogram"

#: the per-(priority, stage) request-latency family (one name at every
#: replica, so series merge by label)
REQUEST_LATENCY = "dryad_request_latency_seconds"

LOG_MIN = 1e-4            # seconds: the first bucket's bound
LOG_PER_DECADE = 10
LOG_DECADES = 6           # 0.1 ms .. 100 s
LOG_BUCKETS = tuple(LOG_MIN * 10.0 ** (i / LOG_PER_DECADE)
                    for i in range(LOG_PER_DECADE * LOG_DECADES + 1))
_LOG_SCALE = LOG_PER_DECADE / math.log(10.0)


def log_bucket_index(value: float) -> int:
    """The smallest ``i`` with ``value <= LOG_BUCKETS[i]`` ('le'
    semantics), or ``len(LOG_BUCKETS)`` for the overflow bucket: one log,
    corrected by at most a step each way so edge values land where a
    linear scan would put them."""
    if value <= LOG_MIN:
        return 0
    n = len(LOG_BUCKETS)
    i = int(math.ceil(math.log(value / LOG_MIN) * _LOG_SCALE))
    i = min(max(i, 0), n)
    while i > 0 and value <= LOG_BUCKETS[i - 1]:
        i -= 1
    while i < n and value > LOG_BUCKETS[i]:
        i += 1
    return i


def new_hist_state(n_bounds: int = len(LOG_BUCKETS)) -> list:
    """A fresh mutable histogram state ``[counts, sum, count]``."""
    return [[0] * (n_bounds + 1), 0.0, 0]


def observe_log_state(state: list, value: float) -> None:
    """O(1) observe into a standalone log-bucket state (caller locks)."""
    state[0][log_bucket_index(value)] += 1
    state[1] += float(value)
    state[2] += 1


def merge_hist_states(states: Sequence) -> tuple:
    """Exact merge of ``(counts, sum, count)`` states of one layout."""
    states = list(states)
    if not states:
        return tuple(new_hist_state())
    n = len(states[0][0])
    counts = [0] * n
    total, count = 0.0, 0
    for c, s, k in states:
        if len(c) != n:
            raise ValueError("cannot merge histograms with different "
                             f"bucket layouts ({len(c)} vs {n})")
        for i, v in enumerate(c):
            counts[i] += v
        total += s
        count += k
    return (counts, total, count)


def hist_quantile(counts: Sequence[int], q: float,
                  bounds: Sequence[float] = LOG_BUCKETS) -> float:
    """Nearest-rank quantile from bucket counts, in the bounds' unit: each
    bucket reports its upper bound, the overflow bucket the last finite
    one; an empty histogram gives 0.0."""
    total = sum(counts)
    if total == 0:
        return 0.0
    target = max(1, math.ceil(float(q) * total))
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= target:
            return bounds[min(i, len(bounds) - 1)]
    return bounds[-1]


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(value: str) -> str:
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in key) + "}"


def _fmt_value(v: float) -> str:
    # integers render without the trailing .0, so counters stay greppable
    return str(int(v)) if float(v).is_integer() and abs(v) < 1e15 else repr(v)


class _Series:
    """Bound handle for one label set of a family (the hot-path object)."""

    __slots__ = ("_fam", "_key")

    def __init__(self, fam: "_Family", key: tuple):
        self._fam = fam
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        fam = self._fam
        if not fam.registry.enabled:
            return
        if fam.kind == COUNTER and amount < 0:
            raise ValueError("counters only go up")
        if fam.kind == LOG_HISTOGRAM:
            raise TypeError(f"{fam.name} is a histogram")
        with fam.lock:
            fam.values[self._key] = fam.values.get(self._key, 0.0) + amount

    def set(self, value: float) -> None:
        fam = self._fam
        if not fam.registry.enabled:
            return
        if fam.kind != GAUGE:
            raise TypeError(f"{fam.name} is a {fam.kind}, not a gauge")
        with fam.lock:
            fam.values[self._key] = float(value)

    def observe(self, value: float) -> None:
        fam = self._fam
        if not fam.registry.enabled:
            return
        if fam.kind != LOG_HISTOGRAM:
            raise TypeError(f"{fam.name} is a {fam.kind}, not a histogram")
        i = log_bucket_index(value)
        with fam.lock:
            state = fam.values.get(self._key)
            if state is None:
                state = fam.values[self._key] = new_hist_state()
            state[0][i] += 1
            state[1] += float(value)
            state[2] += 1

    def value(self):
        """Counter/gauge float, or a histogram's (counts, sum, count)
        copy; zero when never recorded."""
        fam = self._fam
        with fam.lock:
            if fam.kind == LOG_HISTOGRAM:
                state = fam.values.get(self._key) or new_hist_state()
                return (list(state[0]), state[1], state[2])
            return fam.values.get(self._key, 0.0)


class _Family:
    """One named metric family; it doubles as its own unlabeled series."""

    __slots__ = ("registry", "name", "kind", "help", "lock", "values",
                 "_children", "_unlabeled")

    #: ``lock`` guards the series and the handle cache; ``_Series`` takes
    #: the same lock for every ``fam.values`` touch (the schedule drills
    #: check it at run time: a lexical lint cannot see the alias)
    GUARDED_BY = {"values": "lock", "_children": "lock"}

    def __init__(self, registry: "Registry", name: str, kind: str,
                 help: str = ""):
        self.registry = registry
        self.name = name
        self.kind = kind
        self.help = help
        self.lock = threading.Lock()
        self.values: dict = {}
        self._children: dict = {}
        self._unlabeled = _Series(self, ())

    def labels(self, **labels) -> _Series:
        if not labels:
            return self._unlabeled
        key = _label_key(labels)
        # a racy read first; the locked setdefault is the authoritative
        # insert
        # dryadlint: disable=guarded-by -- benign double-checked read (see above)
        child = self._children.get(key)
        if child is None:
            with self.lock:
                child = self._children.setdefault(key, _Series(self, key))
        return child

    def inc(self, amount: float = 1.0) -> None:
        self._unlabeled.inc(amount)

    def set(self, value: float) -> None:
        self._unlabeled.set(value)

    def observe(self, value: float) -> None:
        self._unlabeled.observe(value)

    def value(self):
        return self._unlabeled.value()

    def series(self) -> dict:
        """Label-block string -> value, for ``snapshot``."""
        with self.lock:
            keys = list(self.values.keys())
        return {_fmt_labels(key).strip("{}"): _Series(self, key).value()
                for key in keys}


class Registry:
    """Named families, created on first use (a kind mismatch raises)."""

    GUARDED_BY = {"_families": "_lock"}

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def _family(self, name: str, kind: str, help: str) -> _Family:
        # a racy read first; the locked re-check is the authoritative
        # create (families are never removed, only reset)
        # dryadlint: disable=guarded-by -- benign double-checked read (see above)
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = self._families[name] = _Family(self, name, kind,
                                                         help)
        if fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as a {fam.kind}")
        return fam

    def reset_prefix(self, prefix: str) -> None:
        """Drop every series of the families whose name starts with
        ``prefix``: a journal's new ``run_start`` begins a new run, whose
        ``dryad_run_*`` series must not carry the last run's counts."""
        with self._lock:
            fams = [f for f in self._families.values()
                    if f.name.startswith(prefix)]
        for fam in fams:
            with fam.lock:
                fam.values.clear()

    def counter(self, name: str, help: str = "") -> _Family:
        return self._family(name, COUNTER, help)

    def gauge(self, name: str, help: str = "") -> _Family:
        return self._family(name, GAUGE, help)

    def log_histogram(self, name: str, help: str = "") -> _Family:
        return self._family(name, LOG_HISTOGRAM, help)

    def snapshot(self) -> dict:
        """``{"counters": {name: {labelblock: value}}, "gauges": {...},
        "histograms": {name: {labelblock: {"bounds", "counts", "sum",
        "count", "log"}}}}``."""
        with self._lock:
            fams = list(self._families.values())
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for fam in fams:
            if fam.kind == LOG_HISTOGRAM:
                out["histograms"][fam.name] = {
                    lbl: {"bounds": list(LOG_BUCKETS), "counts": counts,
                          "sum": total, "count": n, "log": True}
                    for lbl, (counts, total, n) in fam.series().items()}
            else:
                out[fam.kind + "s"][fam.name] = fam.series()
        return out

    def exposition(self) -> str:
        """Prometheus text exposition (format 0.0.4) of every family."""
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        lines: list[str] = []
        for fam in fams:
            if fam.help:
                lines.append(f"# HELP {fam.name} {_escape(fam.help)}")
            kind = "histogram" if fam.kind == LOG_HISTOGRAM else fam.kind
            lines.append(f"# TYPE {fam.name} {kind}")
            with fam.lock:
                for key, val in sorted(fam.values.items()):
                    if fam.kind != LOG_HISTOGRAM:
                        lines.append(
                            f"{fam.name}{_fmt_labels(key)} {_fmt_value(val)}")
                        continue
                    counts, total, n = val
                    cum = 0
                    for bound, c in zip(LOG_BUCKETS, counts):
                        cum += c
                        lk = _fmt_labels(key + (("le", repr(float(bound))),))
                        lines.append(f"{fam.name}_bucket{lk} {cum}")
                    lk = _fmt_labels(key + (("le", "+Inf"),))
                    lines.append(f"{fam.name}_bucket{lk} {cum + counts[-1]}")
                    lines.append(
                        f"{fam.name}_sum{_fmt_labels(key)} {_fmt_value(total)}")
                    lines.append(f"{fam.name}_count{_fmt_labels(key)} {n}")
        return "\n".join(lines) + ("\n" if lines else "")


_default: Optional[Registry] = None
_default_lock = threading.Lock()


def default_registry() -> Registry:
    """The shared registry training and serving record into; created
    enabled unless ``DRYAD_OBS=0``; ``set_default_registry`` swaps it."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = Registry(
                    enabled=os.environ.get("DRYAD_OBS", "1") != "0")
    return _default



def set_default_registry(registry: Registry) -> Registry:
    """Replace the process default (tests); returns the old one, so the
    caller can restore it."""
    global _default
    with _default_lock:
        old = _default if _default is not None else Registry(
            enabled=os.environ.get("DRYAD_OBS", "1") != "0")
        _default = registry
    return old
