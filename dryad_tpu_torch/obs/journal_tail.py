"""Tail a run journal (``resilience/journal.py``, JSONL) into registry
series.

The tail reads the file, not the journal object: the journal appends
line-buffered, so a poll sees every completed event of a live run, and
the same ``poll()`` replays a finished journal (its counts equal
``RunJournal.read()``'s).  A partial last line (a write caught mid-poll)
is carried to the next poll, never half-parsed.  A ``run_start`` begins a
new run: the ``dryad_run_*`` series are reset, so the live endpoint shows
the last run alone, as ``RunJournal.read_last_run`` reads it.

Series (the reference's names):

* ``dryad_run_events_total{event=...}``: every event, by kind
* ``dryad_run_faults_total{kind=...}``: fault classifications
* ``dryad_run_chunk_backoffs_total`` and the gauge ``dryad_run_ch_max``
* ``dryad_run_resumes_total`` and ``dryad_run_resume_iteration``
* ``dryad_run_fail_closed_total``
* ``dryad_run_iteration``: the last chunk_dispatch or chunk_fetch
  iteration
* ``dryad_run_attempt``: the segment attempt
* ``dryad_run_wall_seconds`` and ``dryad_run_iterations``, from
  ``complete``

Stdlib file reads only, no torch.  The counterpart of
``dryad_tpu/obs/journal_tail.py``.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

from dryad_tpu_torch.obs.registry import Registry, default_registry


class JournalTail:
    """Incrementally fold a journal file's events into ``registry``.

    ``poll()`` consumes everything appended since the last poll and
    returns the number of events folded; ``start()`` polls on a daemon
    thread for live runs (``stop()`` runs one final poll so no tail
    events are lost at shutdown).  ``_lock`` serializes whole polls —
    offset, carry, and the fold are one atomic unit, so a caller's poll
    racing the background tick can never double-fold a line."""

    GUARDED_BY = {"_offset": "_lock", "_carry": "_lock",
                  "events_seen": "_lock"}

    def __init__(self, path: str, registry: Optional[Registry] = None,
                 poll_interval_s: float = 0.25):
        self.path = os.fspath(path)
        self.registry = registry if registry is not None else default_registry()
        self.poll_interval_s = float(poll_interval_s)
        self.events_seen = 0
        self._offset = 0
        self._carry = ""
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- consuming ---------------------------------------------------------
    def poll(self) -> int:
        """Fold newly appended events; safe to call concurrently with the
        background thread and after the run finished (post-hoc replay of a
        whole journal is just one big first poll)."""
        with self._lock:
            try:
                with open(self.path, "r") as fh:
                    fh.seek(self._offset)
                    chunk = fh.read()
                    self._offset = fh.tell()
            except (FileNotFoundError, OSError):
                return 0     # journal not created yet — not an error
            if not chunk:
                return 0
            data = self._carry + chunk
            lines = data.split("\n")
            self._carry = lines.pop()      # '' when chunk ended on a newline
            n = 0
            for line in lines:
                if not line.strip():
                    continue
                try:
                    event = json.loads(line)
                except ValueError:
                    continue               # torn/foreign line: skip, don't die
                self._fold(event)
                n += 1
            self.events_seen += n
            return n

    def _fold(self, e: dict) -> None:
        reg = self.registry
        kind = str(e.get("event", "unknown"))
        if kind == "run_start":
            # an appended journal begins a new run here: drop the last
            # run's series (RunJournal.read_last_run's view)
            reg.reset_prefix("dryad_run_")
        reg.counter("dryad_run_events_total",
                    "Supervised-run journal events by kind").labels(
            event=kind).inc()
        if kind == "fault":
            reg.counter("dryad_run_faults_total",
                        "Classified faults by class").labels(
                kind=str(e.get("kind", "unknown"))).inc()
        elif kind == "backoff_chunks":
            reg.counter("dryad_run_chunk_backoffs_total",
                        "Chunk-cap degradations").inc()
            if "ch_max_to" in e:
                reg.gauge("dryad_run_ch_max",
                          "Live supervised chunk cap (0 = uncapped)").set(
                    e["ch_max_to"])
        elif kind == "resume":
            reg.counter("dryad_run_resumes_total",
                        "Auto-resumes from checkpoint").inc()
            if "from_iteration" in e:
                reg.gauge("dryad_run_resume_iteration",
                          "Last resume point").set(e["from_iteration"])
        elif kind == "fail_closed":
            reg.counter("dryad_run_fail_closed_total",
                        "Supervisor fail-closed exits").inc()
        elif kind in ("chunk_dispatch", "chunk_fetch"):
            if "iteration" in e:
                reg.gauge("dryad_run_iteration",
                          "Last journaled loop iteration").set(e["iteration"])
        elif kind == "segment_start":
            if "attempt" in e:
                reg.gauge("dryad_run_attempt",
                          "Supervised segment attempt").set(e["attempt"])
            if "ch_max" in e:
                reg.gauge("dryad_run_ch_max",
                          "Live supervised chunk cap (0 = uncapped)").set(
                    e["ch_max"])
        elif kind == "complete":
            if "wall_s" in e:
                reg.gauge("dryad_run_wall_seconds",
                          "Completed run wall").set(e["wall_s"])
            if "iterations" in e:
                reg.gauge("dryad_run_iterations",
                          "Completed run iterations").set(e["iterations"])

    # ---- live tailing ------------------------------------------------------
    def start(self) -> "JournalTail":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="dryad-journal-tail")
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            self.poll()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.poll()    # final sweep: events appended after the last tick

    def __enter__(self) -> "JournalTail":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
