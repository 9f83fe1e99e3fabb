"""Retry and degradation policy for supervised runs.

The counterpart of ``dryad_tpu/resilience/policy.py``, whole:

* ``RetryPolicy``: the static knobs (retry budget, exponential backoff,
  the chunk-cap degradation ladder, checkpoint-cadence tightening).
* ``ChunkCapPolicy``: the live chunk-cap controller the supervisor hands
  to ``train(chunk_policy=...)``.  A chunked trainer consults ``cap()``
  per chunk and reports ``note_dispatch`` / ``note_clean_chunk``.

The port has no chunked dispatch: its loop runs the reference's
per-iteration arm and never consults the cap.  So a supervised port run
journals ``backoff_chunks`` with ``cap_consulted: false``, which the
reference defines as "remedy inapplicable"; the ladder walk below is
kept whole, so the journal's ``ch_max_from``/``ch_max_to`` read as the
reference's.

Degradation walks ``ch_max_ladder`` stepwise toward its floor;
re-widening walks back up one step after ``rewiden_after_clean_chunks``
consecutive clean chunks, and never back to a length a fault was
observed at.
"""

from __future__ import annotations

import dataclasses


def _default_ladder() -> tuple[int, ...]:
    """The ladder of the policy table's ``chunk_cap`` gate (the committed
    default is ``(8, 4, 2)``).  The policy package imports no torch."""
    from dryad_tpu_torch.policy.gates import gate_value

    return tuple(int(s) for s in gate_value("chunk_cap", "ladder"))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Static supervision knobs (module docstring)."""

    #: total classified faults tolerated before failing closed
    retry_budget: int = 5
    #: faults tolerated at one resume point (no checkpoint progress in
    #: between) before failing closed
    same_point_retries: int = 3
    backoff_base_s: float = 1.0
    backoff_factor: float = 2.0
    backoff_max_s: float = 60.0
    #: chunk-cap degradation steps, widest first, ending on the floor
    ch_max_ladder: tuple[int, ...] = dataclasses.field(
        default_factory=_default_ladder)
    #: initial cap (0 = uncapped until the first fetch death)
    ch_max_start: int = 0
    #: consecutive clean chunks before the cap re-widens one step
    rewiden_after_clean_chunks: int = 32
    #: checkpoint cadence after a fault: halved, never below the floor and
    #: never above the current cadence (each checkpoint is a bulk fetch)
    checkpoint_tighten_factor: int = 2
    checkpoint_every_min: int = 5

    def backoff_s(self, fault_index: int) -> float:
        """Exponential backoff for the (0-based) Nth fault."""
        return min(self.backoff_base_s * self.backoff_factor ** fault_index,
                   self.backoff_max_s)

    def next_checkpoint_every(self, every: int) -> int:
        """Tightened cadence: monotone non-increasing (a caller already
        below the floor keeps their cadence)."""
        return min(every, max(self.checkpoint_every_min,
                              every // self.checkpoint_tighten_factor))


class ChunkCapPolicy:
    """Live chunk-length cap: the supervisor degrades it on fetch-death
    faults; a chunked trainer's clean-chunk feedback re-widens it."""

    def __init__(self, policy: RetryPolicy | None = None):
        self.policy = policy or RetryPolicy()
        if not self.policy.ch_max_ladder:
            raise ValueError("ch_max_ladder must have at least one step")
        # widest first, whatever order the caller spelled it in
        self._ladder = tuple(sorted(set(self.policy.ch_max_ladder),
                                    reverse=True))
        self._cap = int(self.policy.ch_max_start)
        self._clean = 0
        self._seen = 0        # longest chunk actually run (trainer feedback)
        self._fatal = 0       # shortest length a fault was observed at
        #: whether the last degrade() stepped below the length that was
        #: running (False: the remedy had no room left)
        self.last_shrunk = False
        #: whether a trainer consulted cap(); False means a non-chunked
        #: path, where degradation is a no-op ("remedy inapplicable")
        self.consulted = False

    def cap(self) -> int:
        """Current cap on iterations per chunk; 0 = uncapped.  The
        trainer's entry point: reading it marks the cap consulted."""
        self.consulted = True
        return self._cap

    def peek(self) -> int:
        """The cap without marking it consulted."""
        return self._cap

    def degrade(self) -> int:
        """Step the cap down the ladder to the first step strictly below
        what has been running (the observed chunk length when known), and
        remember that length as fatal.  A cap already at or below the
        floor is kept: degrading never widens chunks."""
        self._clean = 0
        self.last_shrunk = False
        floor = self._ladder[-1]
        ref = min([v for v in (self._cap, self._seen) if v], default=0)
        if ref:
            self._fatal = ref if self._fatal == 0 else min(self._fatal, ref)
        if self._cap != 0 and self._cap <= floor:
            return self._cap
        for step in self._ladder:
            if ref == 0 or step < ref:
                self._cap = step
                self.last_shrunk = True
                return self._cap
        # the fatal length is at or below the floor: cap there anyway
        self._cap = floor
        return self._cap

    def note_dispatch(self, n: int) -> None:
        """A chunk of ``n`` iterations is about to be enqueued."""
        if n:
            self._seen = max(self._seen, int(n))

    def note_clean_chunk(self, n: int = 0) -> None:
        """One chunk of ``n`` iterations completed without a fault; after
        ``rewiden_after_clean_chunks`` in a row the cap walks one step back
        up, strictly below any known-fatal length."""
        if n:
            self._seen = max(self._seen, int(n))
        if self._cap == 0:
            return
        self._clean += 1
        if self._clean < self.policy.rewiden_after_clean_chunks:
            return
        self._clean = 0
        wider = [s for s in self._ladder
                 if s > self._cap and (self._fatal == 0 or s < self._fatal)]
        if wider:
            self._cap = wider[-1]
        elif self._fatal == 0:
            self._cap = 0
