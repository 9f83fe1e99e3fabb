"""Training callbacks, copies of ``dryad_tpu/callbacks.py``.

A callback is ``fn(iteration, info)`` where ``info`` carries
``{"iteration": int}`` plus ``<valid name>_<metric>`` entries on
iterations that evaluate.  ``train`` accepts a list and fans out in order.
Iterations end in a synchronisation of the card (the per-tree wall time),
so wall-clock deltas between callbacks measure whole iterations.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Optional, Sequence

Callback = Callable[[int, dict], None]


def combine(callbacks: Optional[Sequence[Callback]]) -> Optional[Callback]:
    if not callbacks:
        return None
    if len(callbacks) == 1:
        return callbacks[0]

    def fan_out(it: int, info: dict) -> None:
        for cb in callbacks:
            cb(it, info)

    return fan_out


def log_evaluation(period: int = 1,
                   printer: Callable[[str], None] = print) -> Callback:
    """Print per-iteration eval metrics every ``period`` iterations."""

    def cb(it: int, info: dict) -> None:
        if period > 0 and it % period == 0:
            metrics = {k: v for k, v in info.items() if k != "iteration"}
            body = "  ".join(f"{k}: {v:.6g}" if isinstance(v, float)
                             else f"{k}: {v}" for k, v in metrics.items())
            printer(f"[{it}] {body}" if body else f"[{it}]")

    return cb


class JsonlLogger:
    """Append one JSON line per iteration to ``path``."""

    def __init__(self, path: str):
        self.path = path
        self._t0 = time.perf_counter()
        self._last = self._t0
        self._fh = open(path, "a", buffering=1)

    def __call__(self, it: int, info: dict) -> None:
        now = time.perf_counter()
        rec = dict(info)
        rec["dispatch_s"] = round(now - self._last, 6)
        rec["elapsed_s"] = round(now - self._t0, 6)
        self._last = now
        self._fh.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._fh.close()
