"""Fault classification and deterministic injection for supervised runs.

The counterpart of ``dryad_tpu/resilience/faults.py``.  ``classify_fault``
keeps the reference's signatures and its return set, so a journal reads
the same from either package, and adds CUDA's:

* **oom** — ``torch.cuda.OutOfMemoryError`` or "CUDA out of memory" (and
  the reference's ``RESOURCE_EXHAUSTED`` / "out of memory").  Not sticky:
  the allocation failed, the context lives on.
* **device_unavailable** — the sticky CUDA errors ("an illegal memory
  access was encountered", "device-side assert triggered", "unspecified
  launch failure", "misaligned address", "an illegal instruction"), at any
  site; ``is_sticky`` says that they poison the process's CUDA context,
  so no in-process retry can succeed (the supervisor fails closed on them
  and the run resumes from its checkpoint in a fresh process).  Also the
  collective failures of a process group (``torch.distributed.
  DistBackendError``, "Watchdog caught collective operation timeout",
  "Connection closed by peer") and the reference's ``UNAVAILABLE`` family
  ("all CUDA-capable devices are busy or unavailable" among them) away
  from a fetch site.
* **fetch_death** — the same non-sticky family raised at a fetch site
  (the supervisor tracks the site through the trainer's ``chunk_hook``),
  or a message that announces a killed or timed-out fetch itself.
* **preemption** — ``ABORTED`` / "preempted".
* **unknown** — everything else.  The supervisor fails closed on these:
  retrying an unrecognised error hides real bugs behind checkpoints.

Only runtime-shaped errors (``RuntimeError``, ``OSError`` and their
subclasses, which torch's CUDA and distributed errors are) can be device
faults.  Types are matched by class name along the MRO, so this module
imports no torch.

``FaultInjector`` is the deterministic injection layer: it is a
``chunk_hook`` (``engine/train.py``: ``"dispatch"`` at the head of each
iteration, ``"fetch"`` inside each fetch's watchdog bracket) and raises
CUDA's canonical messages at configured (site, iteration) points, so
every resilience path runs on the CPU in tier-1.  Not passing one costs
nothing.  Kind ``STALL`` sleeps at the hook instead (a hung fetch, seen by
the fetch watchdog).

The same injector shape is the serving front end's replica hook
(``serve/http.py``: ``("request", n)`` per ``/predict``, ``("health", n)``
per ``/healthz``), armed through ``DRYAD_REPLICA_FAULTS`` (``encode_points``
/ ``decode_points``): **replica_crash** hard-exits the process with
``REPLICA_CRASH_EXIT``, **slow_health** sleeps ``stall_s``, and
**reject_503** raises ``InjectedReject``, which the front end answers with
503.  The continual kind **bad_generation** is consumed through
``take()``.  These are injection kinds: ``classify_fault`` never returns
them.
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
import time

FETCH_DEATH = "fetch_death"
DEVICE_UNAVAILABLE = "device_unavailable"
OOM = "oom"
PREEMPTION = "preemption"
UNKNOWN = "unknown"
#: an injection kind, not a class: the injector sleeps ``stall_s`` at the
#: hook site instead of raising (a hung fetch; the hook fires inside the
#: trainer's watch_fetch bracket, so the in-flight age gauge sees it)
STALL = "stall"

#: replica-level injection kinds (module docstring)
REPLICA_CRASH = "replica_crash"
SLOW_HEALTH = "slow_health"
REJECT_503 = "reject_503"
REPLICA_KINDS = (REPLICA_CRASH, SLOW_HEALTH, REJECT_503)

#: the continual-boosting injection kind: ``take()`` returns the fired
#: point and the retrain worker trains on the wrong data distribution
BAD_GENERATION = "bad_generation"
CONTINUAL_KINDS = (BAD_GENERATION,)
#: the exit code an injected replica_crash dies with
REPLICA_CRASH_EXIT = 23

#: classes the supervisor may retry; UNKNOWN always fails closed
RETRYABLE = (FETCH_DEATH, DEVICE_UNAVAILABLE, OOM, PREEMPTION)

#: the site vocabulary of the trainer's chunk_hook
SITES = ("dispatch", "fetch")
#: the site vocabulary of the serve front end's replica fault hook
REPLICA_SITES = ("request", "health")
#: the site vocabulary of the continual retrain worker's fault hook
CONTINUAL_SITES = ("retrain",)


class InjectedReject(RuntimeError):
    """The reject drill: the HTTP front end answers 503 at this site.
    Deliberately not classifiable (``classify_fault`` gives UNKNOWN)."""


_OOM_PAT = re.compile(r"RESOURCE_EXHAUSTED|out of memory|hbm.*exceeds",
                      re.IGNORECASE)
# "preempt" in any casing, the status token only as the exact uppercase
# word: prose like "compilation aborted" is not a retryable preemption
_PREEMPT_PAT = re.compile(r"(?i:preempt)|\bABORTED\b")
_UNAVAILABLE_PAT = re.compile(
    r"UNAVAILABLE|TPU device error|worker process crashed"
    r"|socket closed|connection reset", re.IGNORECASE)
# a process group's collective failures (NCCL's watchdog, gloo's pairs)
_COLLECTIVE_PAT = re.compile(
    r"Watchdog caught collective operation timeout"
    r"|Connection closed by peer", re.IGNORECASE)
# a fetch death announced in the message itself
_FETCH_PAT = re.compile(r"DEADLINE_EXCEEDED|fetch.*(timed out|killed)",
                        re.IGNORECASE)
# CUDA's sticky errors: the context is poisoned, every later call fails
_STICKY_PAT = re.compile(
    r"an illegal memory access was encountered|device-side assert triggered"
    r"|unspecified launch failure|misaligned address"
    r"|an illegal instruction", re.IGNORECASE)


def _is_a(exc: BaseException, name: str) -> bool:
    return any(c.__name__ == name for c in type(exc).__mro__)


def is_sticky(exc: BaseException) -> bool:
    """True for a CUDA error that poisons the process's context (an
    illegal address, a device-side assert, a launch failure): every later
    CUDA call in the process fails, so only a fresh process can resume."""
    return (isinstance(exc, (RuntimeError, OSError))
            and _STICKY_PAT.search(str(exc)) is not None)


def classify_fault(exc: BaseException, at_fetch: bool = False) -> str:
    """Map a raised exception onto the fault classes.

    ``at_fetch`` says whether the trainer's last chunk_hook event before
    the raise was a ``"fetch"`` site; it splits fetch_death from
    device_unavailable for the overlapping non-sticky families."""
    # only runtime-shaped errors can be device faults: a ValueError from
    # config validation (or any non-Exception) must never be retried
    if not isinstance(exc, (RuntimeError, OSError)):
        return UNKNOWN
    msg = f"{type(exc).__name__}: {exc}"
    if _is_a(exc, "OutOfMemoryError") or _OOM_PAT.search(msg):
        return OOM
    if _PREEMPT_PAT.search(msg):
        return PREEMPTION
    if _FETCH_PAT.search(msg):
        return FETCH_DEATH
    if _STICKY_PAT.search(msg):
        return DEVICE_UNAVAILABLE
    if (_is_a(exc, "DistBackendError") or _COLLECTIVE_PAT.search(msg)
            or _UNAVAILABLE_PAT.search(msg)):
        return FETCH_DEATH if at_fetch else DEVICE_UNAVAILABLE
    return UNKNOWN


# the messages injection raises: CUDA's own wording where it has one, so
# classify_fault treats injected and genuine faults identically.  None is
# sticky: an injected fault must be retryable in the same process.
_CANONICAL_MSG = {
    # "fetch ... timed out" classifies as fetch_death by message alone, so
    # make_fault's contract holds at any site
    FETCH_DEATH: ("CUDA error: device-to-host fetch timed out behind "
                  "queued work (fetch pending >60s killed) [injected]"),
    DEVICE_UNAVAILABLE: ("CUDA error: all CUDA-capable devices are busy "
                         "or unavailable [injected]"),
    OOM: ("CUDA out of memory. Tried to allocate 2.00 GiB while "
          "allocating a device buffer [injected]"),
    PREEMPTION: "ABORTED: the worker was preempted [injected]",
    UNKNOWN: "injected fault with no recorded signature",
}


def _error_class(kind: str):
    """``torch.cuda.OutOfMemoryError`` for an oom where torch can
    construct it, else ``RuntimeError``: classification reads the type and
    the message, so both take the same supervisor paths."""
    if kind == OOM:
        try:
            import torch

            torch.cuda.OutOfMemoryError("constructibility probe")
            return torch.cuda.OutOfMemoryError
        except (ImportError, AttributeError, TypeError):
            pass
    return RuntimeError


def make_fault(kind: str) -> BaseException:
    """An exception instance that classifies as ``kind`` (UNKNOWN
    included: its message matches no signature)."""
    if kind not in _CANONICAL_MSG:
        raise ValueError(f"unknown fault kind {kind!r}")
    return _error_class(kind)(_CANONICAL_MSG[kind])


@dataclasses.dataclass(frozen=True)
class FaultPoint:
    """One configured injection: fire at the first hook event with
    ``site`` at or after ``iteration``.  ``kind=STALL``/``SLOW_HEALTH``
    sleeps ``stall_s`` seconds at the hook instead of raising.
    ``sticky=True`` keeps the point armed after it fires (the latched
    form of the stuck-503 drill)."""

    iteration: int
    kind: str = DEVICE_UNAVAILABLE
    site: str = "dispatch"
    stall_s: float = 0.0
    sticky: bool = False

    def __post_init__(self):
        all_sites = SITES + REPLICA_SITES + CONTINUAL_SITES
        if self.site not in all_sites:
            raise ValueError(f"site must be one of {all_sites}, "
                             f"got {self.site!r}")
        if (self.kind not in (STALL,) + REPLICA_KINDS + CONTINUAL_KINDS
                and self.kind not in _CANONICAL_MSG):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        # kinds and sites partition strictly: a mistyped drill must fail
        # loudly, not arm nothing
        if self.kind in REPLICA_KINDS and self.site not in REPLICA_SITES:
            raise ValueError(
                f"replica fault kind {self.kind!r} fires only at replica "
                f"sites {REPLICA_SITES}, got site {self.site!r}")
        if self.kind in CONTINUAL_KINDS and self.site not in CONTINUAL_SITES:
            raise ValueError(
                f"continual fault kind {self.kind!r} fires only at "
                f"continual sites {CONTINUAL_SITES}, got site {self.site!r}")
        if self.kind not in REPLICA_KINDS and self.site in REPLICA_SITES:
            raise ValueError(
                f"fault kind {self.kind!r} is a trainer class and never "
                f"fires at replica site {self.site!r}; use one of "
                f"{REPLICA_KINDS}")
        if (self.kind not in CONTINUAL_KINDS
                and self.site in CONTINUAL_SITES):
            raise ValueError(
                f"fault kind {self.kind!r} never fires at continual site "
                f"{self.site!r}; use one of {CONTINUAL_KINDS}")
        if self.kind in (STALL, SLOW_HEALTH) and self.stall_s <= 0:
            raise ValueError(f"a {self.kind} point needs stall_s > 0")


class FaultInjector:
    """Deterministic fault injection, shaped as a trainer ``chunk_hook``.

    Each point fires once per injector lifetime: the supervisor keeps one
    injector across retries, so a resumed segment replays past a point
    that already fired.  ``fired`` records (point index, site, iteration,
    kind).  ``_lock`` makes the armed check-and-clear atomic (the serve
    front end calls the hook from its handler threads); the fault's
    action (sleep, raise, exit) runs outside it."""

    GUARDED_BY = {"_armed": "_lock", "fired": "_lock"}

    def __init__(self, points):
        self.points = [p if isinstance(p, FaultPoint) else FaultPoint(*p)
                       for p in points]
        self._armed = [True] * len(self.points)
        self.fired: list[dict] = []
        self._lock = threading.Lock()

    def __call__(self, site: str, iteration: int) -> None:
        to_fire: list[FaultPoint] = []
        with self._lock:
            for i, pt in enumerate(self.points):
                if (self._armed[i] and site == pt.site
                        and iteration >= pt.iteration):
                    if not pt.sticky:
                        self._armed[i] = False
                    self.fired.append({"point": i, "site": site,
                                       "iteration": int(iteration),
                                       "kind": pt.kind})
                    to_fire.append(pt)
                    if pt.kind not in (STALL, SLOW_HEALTH):
                        # a raising point ends this call's scan: later
                        # points stay armed for later events
                        break
        for pt in to_fire:
            if pt.kind in CONTINUAL_KINDS:
                raise ValueError(
                    f"{pt.kind} is an action-at-caller kind: consume it "
                    "with FaultInjector.take(), not the raising hook")
            if pt.kind in (STALL, SLOW_HEALTH):
                # a hang, not a death: hold the hook (inside the trainer's
                # watch_fetch bracket, or the replica's probe), then go on
                time.sleep(pt.stall_s)
                continue
            if pt.kind == REPLICA_CRASH:
                # no atexit, no flushes: what a real crash leaves behind
                os._exit(REPLICA_CRASH_EXIT)
            if pt.kind == REJECT_503:
                raise InjectedReject(
                    f"injected 503 rejection at {site} #{iteration}")
            raise make_fault(pt.kind)

    def take(self, site: str, iteration: int) -> "FaultPoint | None":
        """Atomic check-and-clear for action-at-caller kinds: returns the
        first matching armed point (recorded in ``fired``) instead of
        raising.  Shares ``_armed`` with ``__call__``."""
        with self._lock:
            for i, pt in enumerate(self.points):
                if (self._armed[i] and site == pt.site
                        and iteration >= pt.iteration):
                    if not pt.sticky:
                        self._armed[i] = False
                    self.fired.append({"point": i, "site": site,
                                       "iteration": int(iteration),
                                       "kind": pt.kind})
                    return pt
        return None

    @property
    def pending(self) -> int:
        with self._lock:
            return sum(self._armed)


# ---------------------------------------------------------------------------
# the environment wire format: ``site:iteration:kind[:stall_s][:sticky]``
# specs, comma-separated, e.g. ``request:3:replica_crash`` or
# ``health:1:slow_health:6.0:sticky``; an absent or empty variable arms
# nothing

REPLICA_FAULTS_ENV = "DRYAD_REPLICA_FAULTS"
CONTINUAL_FAULTS_ENV = "DRYAD_CONTINUAL_FAULTS"


def encode_points(points) -> str:
    """``FaultPoint``s (or their tuple spellings) -> the env-var string."""
    specs = []
    for p in points:
        if not isinstance(p, FaultPoint):
            p = FaultPoint(*p)
        spec = f"{p.site}:{p.iteration}:{p.kind}"
        if p.stall_s:
            spec += f":{p.stall_s}"
        if p.sticky:
            spec += ":sticky" if p.stall_s else ":0:sticky"
        specs.append(spec)
    return ",".join(specs)


def decode_points(value: str) -> list[FaultPoint]:
    """The env-var string -> validated ``FaultPoint``s (a malformed spec
    raises ValueError)."""
    points = []
    for spec in (value or "").split(","):
        spec = spec.strip()
        if not spec:
            continue
        parts = spec.split(":")
        if len(parts) < 3:
            raise ValueError(f"malformed replica fault spec {spec!r} "
                             "(want site:iteration:kind[:stall_s][:sticky])")
        sticky = False
        if parts[-1] == "sticky":
            sticky = True
            parts = parts[:-1]
        if len(parts) > 4:
            raise ValueError(
                f"malformed replica fault spec {spec!r}: unrecognized "
                f"trailing field {parts[4]!r} "
                "(want site:iteration:kind[:stall_s][:sticky])")
        stall_s = float(parts[3]) if len(parts) > 3 else 0.0
        points.append(FaultPoint(site=parts[0], iteration=int(parts[1]),
                                 kind=parts[2], stall_s=stall_s,
                                 sticky=sticky))
    return points


def injector_from_env(environ=None,
                      env_var: str = REPLICA_FAULTS_ENV
                      ) -> "FaultInjector | None":
    """An injector from the named variable (default: the replica drills'
    ``DRYAD_REPLICA_FAULTS``), or None when it is unset or empty."""
    value = (environ if environ is not None else os.environ).get(env_var, "")
    points = decode_points(value)
    return FaultInjector(points) if points else None
