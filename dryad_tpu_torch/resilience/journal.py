"""Append-only JSONL run journal.

One JSON object per line, line-buffered, keyed by ``event`` with the
seconds since the journal opened (``elapsed_s``).  ``obs/journal_tail.py``
folds a journal into live series and ``train --trace-out`` renders it as
instant events.  The event vocabulary is the reference's (``run_start``,
``segment_start``, ``chunk_dispatch``, ``chunk_fetch``, ``fault``,
``backoff_chunks``, ``resume``, ``fail_closed``, ``complete``, and the
fleet's and continual loop's families), so a journal of either package
reads in the other.  Stdlib only.

The counterpart of ``dryad_tpu/resilience/journal.py``; its producer is
``resilience/supervisor.py`` (the fleet's supervisor is not ported yet).
"""

from __future__ import annotations

import json
import threading
import time


class RunJournal:
    """Append one JSON event line per event to ``path``.

    Lock contract: a journal is written from more than one thread, so
    ``_lock`` makes each ``event()`` line atomic (serialize and write
    under it), and ``close()`` takes it too, so no event hits a closed
    handle."""

    GUARDED_BY = {"_fh": "_lock"}

    def __init__(self, path: str):
        self.path = path
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._fh = open(path, "a", buffering=1)

    def event(self, kind: str, /, **fields) -> None:
        rec = {"event": kind,
               "elapsed_s": round(time.perf_counter() - self._t0, 6)}
        rec.update(fields)
        line = json.dumps(rec) + "\n"
        with self._lock:
            self._fh.write(line)

    def close(self) -> None:
        with self._lock:
            self._fh.close()

    def __enter__(self) -> "RunJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @staticmethod
    def read(path: str) -> list[dict]:
        """Parse a journal back into its event dicts."""
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]

    @classmethod
    def read_last_run(cls, path: str) -> list[dict]:
        """The events of the last run only: the file is appended across
        invocations, so a consumer counting faults or resumes reads from
        the last ``run_start``."""
        events = cls.read(path)
        starts = [i for i, e in enumerate(events)
                  if e["event"] == "run_start"]
        return events[starts[-1]:] if starts else events
