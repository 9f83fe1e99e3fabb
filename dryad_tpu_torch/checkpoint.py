"""Checkpoint/resume, a copy of ``dryad_tpu/checkpoint.py`` for the port's
Booster.

A checkpoint is the partial booster in the model-file format, written at
iteration boundaries.  Resume feeds it back as ``init_booster``: the scores
are replayed tree by tree in the straight run's fp32 order and the bags
are redrawn from Philox(seed, iteration), so the rest of the run
reproduces the uninterrupted one bit for bit.

Writes are atomic (a temporary file, then ``os.replace``), so a crash
mid-write never corrupts the latest checkpoint; older checkpoints are
pruned to the newest ``keep``.
"""

from __future__ import annotations

import os
import re
from typing import Optional

from dryad_tpu_torch.booster import Booster

_PATTERN = re.compile(r"^ckpt_(\d{8})\.dryad$")


class Checkpointer:
    """Periodic atomic booster snapshots in a directory."""

    def __init__(self, directory: str, every: int = 10, keep: int = 2):
        if every < 1:
            raise ValueError("checkpoint 'every' must be >= 1")
        self.directory = directory
        self.every = int(every)
        self.keep = int(keep)
        os.makedirs(directory, exist_ok=True)

    @staticmethod
    def has_checkpoints(directory: str) -> bool:
        """Whether ``directory`` holds a checkpoint, without creating it
        (the CLI's ``--supervise`` guard asks before any data loads)."""
        try:
            return any(_PATTERN.match(name)
                       for name in os.listdir(directory))
        except OSError:
            return False

    def _path(self, iteration: int) -> str:
        return os.path.join(self.directory, f"ckpt_{iteration:08d}.dryad")

    def iterations(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _PATTERN.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> Optional[tuple[Booster, int]]:
        """(booster, iteration) of the newest checkpoint, or None."""
        its = self.iterations()
        if not its:
            return None
        it = its[-1]
        return Booster.load(self._path(it)), it

    def save(self, booster: Booster, iteration: int) -> str:
        path = self._path(iteration)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(booster.to_bytes())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)           # atomic on POSIX
        for it in self.iterations()[: -self.keep]:
            try:
                os.remove(self._path(it))
            except OSError:
                pass
        return path

    def due(self, iteration: int) -> bool:
        """True when ``iteration`` (the count of completed iterations) hits
        the period."""
        return iteration % self.every == 0
