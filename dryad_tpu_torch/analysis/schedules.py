"""dryadlint layer 3 (dynamic half): the deterministic-schedule race
harness of the port.

The counterpart of ``dryad_tpu/analysis/schedules.py``.  The static rules
(``concurrency.py``) check LEXICAL lock discipline; this module checks
BEHAVIOR.  It runs the port's threaded host-plane classes (the serve
micro-batcher, the fleet supervisor and capacity controller, the retrain
scheduler, the obs registry and drift monitors, the fault injector, the
chunk prefetcher) under a seeded cooperative scheduler that serializes
every thread and chooses, at each synchronization point, which runnable
thread proceeds.  Many seeds give many interleavings; the same seed
always replays the same interleaving (the scheduler consumes one shared
``random.Random`` and execution is fully serialized), so a failing
schedule is a reproducible artifact, not a flake.  No drill needs a card.

How it works:

* ``Scheduler.instrument()`` patches ``threading.Lock/Event/Thread``,
  ``queue.Queue`` and ``time.sleep`` with shims that route every
  acquire/release/wait/set/put/get/spawn through the scheduler.  The
  code under test is UNMODIFIED: it constructs its locks and threads
  normally and gets the instrumented ones.
* Each managed thread runs on a real OS thread but is gated by a
  semaphore pair: exactly one runs at a time, and it hands control back
  at every schedule point.  With ``preempt_p > 0`` a ``sys.settrace``
  hook adds line-granular preemption inside the target modules, which is
  what exposes torn multi-statement updates (the registry histogram's
  counts/sum/count triple) that lock-op-only preemption never
  interleaves.
* Timeouts are VIRTUAL: a blocked-with-timeout task carries a deadline
  on the virtual clock, and deadlines fire only when no task is
  runnable: the deterministic model of "the timeout elapsed while
  everyone else was stuck", the regime the batcher's stop()-timeout race
  needs.
* Every lock acquisition is recorded against the locks already held:
  after a run the union graph must be acyclic or ``check_lock_order``
  raises with BOTH acquisition stacks.  An actual deadlock (nobody
  runnable, no deadline) raises ``DeadlockError`` with every blocked
  task's stack.

The DRILLS at the bottom re-run the recorded race classes: batcher
stop-vs-start-vs-predict, supervisor monitor-vs-recovery-vs-crash,
rolling push vs replica death, registry record-vs-snapshot-vs-reset,
injector concurrent fire, and the rest of ``DRILLS``, each asserting its
subsystem's stated invariants.  ``run_ci_drills`` is what ``python -m
dryad_tpu_torch.analysis --ci`` executes (exit 6 on any failure); the
test suite also proves each drill still DETECTS its race when the shipped
fix is mechanically reverted.
"""

from __future__ import annotations

import queue as _queue_mod
import random
import sys
import threading as _threading
import time as _time_mod
import traceback
from collections import deque
from typing import Callable, Optional

# the REAL primitives, captured before any instrument() patches the
# public names — the harness itself must never run on its own shims.
# Gating uses raw _thread locks as binary semaphores: the pure-Python
# threading.Semaphore/Event resolve ``Lock``/``Condition`` from the
# (patched) module globals at call time, so the harness cannot ride them.
import _thread

_RealThread = _threading.Thread
_RealEvent = _threading.Event
_real_allocate_lock = _thread.allocate_lock
_real_sleep = _time_mod.sleep
_THREADING_FILE = (_threading.__file__ or "threading.py").replace(
    ".pyc", ".py")


def _gate():
    """A raw lock in the 'parked' state: ``acquire()`` blocks until the
    peer ``release()``s — the ping-pong gate managed threads ride."""
    g = _real_allocate_lock()
    g.acquire()
    return g

_READY, _RUNNING, _BLOCKED, _DONE = "ready", "running", "blocked", "done"


class DeadlockError(AssertionError):
    """No task runnable, no pending virtual timeout — the report carries
    every blocked task's resource and stack."""


class LockOrderError(AssertionError):
    """The recorded acquisition graph contains a cycle — the report
    carries the two acquisition stacks of the closing edge."""


class ScheduleBudgetError(RuntimeError):
    """A schedule exceeded max_steps — a livelock or a runaway drill."""


class _ScheduleCancelled(BaseException):
    """Raised inside leftover task threads once the schedule ends (e.g.
    after a DeadlockError) so they unwind and exit instead of spinning
    on shim state nobody will ever change again.  BaseException so drill
    ``except Exception`` blocks cannot swallow it."""


def _trim_stack(limit: int = 18) -> str:
    """Current stack rendered without harness frames — the drill/code
    frames a human needs to localize a verdict."""
    frames = [f for f in traceback.extract_stack()
              if "analysis/schedules" not in f.filename.replace("\\", "/")]
    return "".join(traceback.format_list(frames[-limit:]))


def _creation_site() -> str:
    for f in reversed(traceback.extract_stack()):
        fn = f.filename.replace("\\", "/")
        if "analysis/schedules" not in fn and "/threading" not in fn:
            tail = (fn.split("dryad_tpu_torch/")[-1]
                    if "dryad_tpu_torch/" in fn else fn.rsplit("/", 1)[-1])
            return f"{tail}:{f.lineno}"
    return "?"


class _Task:
    __slots__ = ("tid", "name", "sem", "state", "blocked_on", "deadline",
                 "timed_out", "error", "stack", "thread", "daemon",
                 "held_locks")

    def __init__(self, tid: int, name: str, daemon: bool = False):
        self.tid = tid
        self.name = name
        self.sem = _gate()
        self.state = _READY
        self.blocked_on = None
        self.deadline: Optional[float] = None
        self.timed_out = False
        self.error: Optional[BaseException] = None
        self.stack: Optional[str] = None
        self.thread: Optional[_RealThread] = None
        self.daemon = daemon
        self.held_locks: list = []


class Scheduler:
    """One deterministic schedule: seed -> interleaving."""

    def __init__(self, seed: int = 0, preempt_p: float = 0.0,
                 trace_files: tuple = (), max_steps: int = 50000):
        self.rng = random.Random(int(seed))
        self.seed = int(seed)
        self.preempt_p = float(preempt_p)
        self.trace_files = tuple(trace_files)
        self.max_steps = int(max_steps)
        self.steps = 0
        self.vtime = 0.0
        self.tasks: list[_Task] = []
        self._by_ident: dict[int, _Task] = {}
        self._sched_sem = _gate()
        self._running = False
        self._cancelled = False
        #: (holder_lock_name, acquired_lock_name) -> (holder's acquisition
        #: stack, this acquisition's stack): the union graph
        #: check_lock_order walks for cycles
        self.lock_edges: dict = {}
        self._acq_stacks: dict = {}    # lock name -> last acquisition stack
        self._patched: list = []

    # ---- task plumbing -----------------------------------------------------
    def _cur(self) -> Optional[_Task]:
        return self._by_ident.get(_threading.get_ident())

    def spawn(self, fn: Callable, name: Optional[str] = None,
              daemon: bool = False) -> _Task:
        task = _Task(len(self.tasks), name or f"task{len(self.tasks)}",
                     daemon)
        self.tasks.append(task)

        def main() -> None:
            self._by_ident[_threading.get_ident()] = task
            task.sem.acquire()
            if self.preempt_p > 0 and self.trace_files:
                sys.settrace(self._trace)
            try:
                fn()
            except BaseException as e:   # noqa: BLE001 — replayed by run()
                task.error = e
            finally:
                sys.settrace(None)
                task.state = _DONE
                self._wake(("join", task))
                try:
                    self._sched_sem.release()
                except RuntimeError:
                    pass    # post-run zombie: nobody is waiting anymore

        t = _RealThread(target=main, daemon=True,
                        name=f"sched-{self.seed}-{task.name}")
        task.thread = t
        t.start()
        return task

    def _switch(self, state: str = _READY, blocked_on=None,
                timeout: Optional[float] = None) -> bool:
        """Hand control to the scheduler; returns True when the wait was
        resolved by a virtual timeout."""
        task = self._cur()
        if task is None:
            return False
        if not self._running:
            if self._cancelled:
                raise _ScheduleCancelled()
            return False
        task.state = state
        task.blocked_on = blocked_on
        task.deadline = (None if timeout is None
                         else self.vtime + max(float(timeout), 0.0))
        task.timed_out = False
        if state == _BLOCKED:
            task.stack = _trim_stack()
        self._sched_sem.release()
        task.sem.acquire()
        task.stack = None
        if self._cancelled:
            raise _ScheduleCancelled()
        return task.timed_out

    def pause(self) -> None:
        """An explicit schedule point (drill fakes call this to model 'any
        amount of real work happens here')."""
        self._switch()

    def sleep(self, seconds: float) -> None:
        """The time.sleep shim: a virtual-clock delay (schedule point even
        for sleep(0))."""
        if self._cur() is None:
            return
        self._switch(_BLOCKED, ("sleep", None), max(float(seconds), 1e-9))

    def _wake(self, resource) -> None:
        for t in self.tasks:
            if t.state == _BLOCKED and t.blocked_on == resource:
                t.state = _READY
                t.blocked_on = None
                t.deadline = None

    # ---- line-granular preemption ------------------------------------------
    def _trace(self, frame, event, arg):
        fn = frame.f_code.co_filename.replace("\\", "/")
        if event == "call":
            return self._trace if fn.endswith(self.trace_files) else None
        if event == "line" and self._running and fn.endswith(self.trace_files):
            if self.rng.random() < self.preempt_p:
                self._switch()
        return self._trace

    # ---- lock-order recording ----------------------------------------------
    def record_acquire(self, lock: "SchedLock", task: _Task) -> None:
        stack = _trim_stack()
        for held in task.held_locks:
            key = (held.name, lock.name)
            if key not in self.lock_edges:
                self.lock_edges[key] = (
                    self._acq_stacks.get(held.name, "<unknown>"), stack)
        self._acq_stacks[lock.name] = stack

    def check_lock_order(self) -> None:
        """Raise LockOrderError when the recorded acquisition graph has a
        cycle — with the two stacks that close it."""
        graph: dict[str, set] = {}
        for a, b in self.lock_edges:
            graph.setdefault(a, set()).add(b)
        color: dict[str, int] = {}
        path: list[str] = []

        def visit(node: str):
            color[node] = 1
            path.append(node)
            for nxt in sorted(graph.get(node, ())):
                if color.get(nxt) == 1:
                    cyc = path[path.index(nxt):] + [nxt]
                    edges = list(zip(cyc, cyc[1:]))
                    detail = "\n".join(
                        f"--- {a} held while acquiring {b} ---\n"
                        f"{self.lock_edges[(a, b)][1]}"
                        for a, b in edges)
                    raise LockOrderError(
                        "lock acquisition cycle (deadlock verdict): "
                        + " -> ".join(cyc) + "\n" + detail)
                if color.get(nxt) is None:
                    visit(nxt)
            path.pop()
            color[node] = 2

        for node in sorted(graph):
            if color.get(node) is None:
                visit(node)

    # ---- the schedule loop -------------------------------------------------
    def run(self) -> None:
        self._running = True
        try:
            while True:
                for t in self.tasks:
                    if t.error is not None:
                        raise t.error
                if all(t.state == _DONE for t in self.tasks
                       if not t.daemon):
                    break
                ready = [t for t in self.tasks if t.state == _READY]
                if not ready:
                    timed = [t for t in self.tasks
                             if t.state == _BLOCKED and t.deadline is not None]
                    if not timed:
                        raise DeadlockError(self._deadlock_report())
                    t = min(timed, key=lambda x: (x.deadline, x.tid))
                    self.vtime = max(self.vtime, t.deadline)
                    t.timed_out = True
                    t.state = _READY
                    t.blocked_on = None
                    t.deadline = None
                    continue
                self.steps += 1
                if self.steps > self.max_steps:
                    raise ScheduleBudgetError(
                        f"schedule exceeded {self.max_steps} steps "
                        f"(seed {self.seed}) — livelock or runaway drill")
                t = self.rng.choice(ready)
                t.state = _RUNNING
                t.sem.release()
                self._sched_sem.acquire()
        finally:
            self._running = False
            self._cancelled = True
            # wake every leftover task: its next _switch raises
            # _ScheduleCancelled, so it unwinds and exits instead of
            # spinning on shim state nobody will change again
            for t in self.tasks:
                if t.state != _DONE:
                    t.state = _DONE
                    t.sem.release()

    def _deadlock_report(self) -> str:
        lines = ["no runnable task and no pending virtual timeout — "
                 "deadlock:"]
        for t in self.tasks:
            if t.state == _BLOCKED:
                res = t.blocked_on
                what = res[0] if isinstance(res, tuple) else repr(res)
                target = res[1] if isinstance(res, tuple) else None
                tn = getattr(target, "name", "")
                lines.append(f"  task {t.name!r} blocked on {what} {tn}\n"
                             f"{t.stack or ''}")
        return "\n".join(lines)

    # ---- instrumentation ---------------------------------------------------
    def instrument(self) -> "_Instrument":
        return _Instrument(self)

    def monkeypatch(self, obj, attr: str, value) -> None:
        """Drill-scoped attribute patch, restored by run_schedule."""
        self._patched.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    def restore_patches(self) -> None:
        while self._patched:
            obj, attr, old = self._patched.pop()
            setattr(obj, attr, old)


class _Instrument:
    """Context manager that swaps the public synchronization constructors
    for scheduler shims (and restores them)."""

    def __init__(self, sched: Scheduler):
        self._sched = sched
        self._saved: list = []

    def __enter__(self) -> "_Instrument":
        s = self._sched
        self._saved = [
            (_threading, "Lock", _threading.Lock),
            (_threading, "Event", _threading.Event),
            (_threading, "Thread", _threading.Thread),
            (_queue_mod, "Queue", _queue_mod.Queue),
            (_time_mod, "sleep", _time_mod.sleep),
            (_time_mod, "perf_counter", _time_mod.perf_counter),
            (_time_mod, "monotonic", _time_mod.monotonic),
        ]

        # threading.py's OWN internals (Thread._started, Condition inside
        # Semaphore, ...) resolve Lock/Event from the patched module
        # globals at call time — hand THEM the real primitives, shim
        # everything else
        def _from_threading_internals() -> bool:
            return sys._getframe(2).f_code.co_filename.endswith(
                ("threading.py", _THREADING_FILE))

        def lock_factory():
            if _from_threading_internals():
                return _real_allocate_lock()
            return SchedLock(s)

        def event_factory():
            if _from_threading_internals():
                return _RealEvent()
            return SchedEvent(s)

        def thread_factory(group=None, target=None, name=None, args=(),
                           kwargs=None, *, daemon=None):
            return SchedThread(s, target=target, name=name, args=args,
                               kwargs=kwargs, daemon=daemon)

        _threading.Lock = lock_factory
        _threading.Event = event_factory
        _threading.Thread = thread_factory
        _queue_mod.Queue = lambda maxsize=0: SchedQueue(s, maxsize)
        _time_mod.sleep = s.sleep
        # the clocks go VIRTUAL: wall time elapses between schedule points
        # by arbitrary real amounts (suspended threads), so any deadline
        # computed from a real clock would make schedules wall-dependent;
        # vtime advances only when a virtual timeout fires
        _time_mod.perf_counter = lambda: s.vtime
        _time_mod.monotonic = lambda: s.vtime
        return self

    def __exit__(self, *exc) -> None:
        for obj, attr, val in self._saved:
            setattr(obj, attr, val)


# ---------------------------------------------------------------------------
# shims


class SchedLock:
    """threading.Lock shim: scheduler-managed, order-recorded,
    non-reentrant (like the real thing)."""

    def __init__(self, sched: Scheduler, name: Optional[str] = None):
        self._sched = sched
        self.name = name or f"Lock@{_creation_site()}"
        self._owner: Optional[object] = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        sched = self._sched
        task = sched._cur()
        if task is None or not sched._running:
            # setup/teardown phase: single-threaded direct execution
            if self._owner is not None:
                raise RuntimeError(
                    f"{self.name} contended outside the scheduler")
            self._owner = "setup"
            return True
        sched._switch()                      # acquire is a schedule point
        while self._owner is not None:
            if not blocking:
                return False
            timed_out = sched._switch(
                _BLOCKED, ("lock", self),
                timeout if timeout is not None and timeout > 0 else None)
            if timed_out:
                return False
        sched.record_acquire(self, task)
        self._owner = task
        task.held_locks.append(self)
        return True

    def release(self) -> None:
        sched = self._sched
        task = sched._cur()
        if task is None or not sched._running:
            self._owner = None
            return
        if self._owner is not task:
            raise RuntimeError(f"{self.name} released by a non-owner")
        task.held_locks.remove(self)
        self._owner = None
        sched._wake(("lock", self))
        sched._switch()                      # release is a schedule point

    def locked(self) -> bool:
        return self._owner is not None

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class SchedEvent:
    """threading.Event shim with virtual-timeout wait."""

    def __init__(self, sched: Scheduler):
        self._sched = sched
        self._flag = False

    def is_set(self) -> bool:
        return self._flag

    def set(self) -> None:
        self._flag = True
        self._sched._wake(("event", self))
        self._sched._switch()

    def clear(self) -> None:
        self._flag = False

    def wait(self, timeout: Optional[float] = None) -> bool:
        sched = self._sched
        task = sched._cur()
        if task is None or not sched._running:
            return self._flag
        sched._switch()
        while not self._flag:
            if sched._switch(_BLOCKED, ("event", self), timeout):
                break
        return self._flag


class SchedQueue:
    """queue.Queue shim (FIFO, bounded, virtual timeouts; raises the real
    queue.Empty/queue.Full so caller except-clauses keep working)."""

    def __init__(self, sched: Scheduler, maxsize: int = 0):
        self._sched = sched
        self.maxsize = int(maxsize)
        self._items: deque = deque()

    def qsize(self) -> int:
        return len(self._items)

    def empty(self) -> bool:
        return not self._items

    def full(self) -> bool:
        return self.maxsize > 0 and len(self._items) >= self.maxsize

    def put(self, item, block: bool = True,
            timeout: Optional[float] = None) -> None:
        sched = self._sched
        task = sched._cur()
        if task is not None and sched._running:
            sched._switch()
        while self.full():
            if task is None or not sched._running or not block:
                raise _queue_mod.Full
            if sched._switch(_BLOCKED, ("queue_put", self), timeout):
                raise _queue_mod.Full
        self._items.append(item)
        sched._wake(("queue_get", self))

    def put_nowait(self, item) -> None:
        self.put(item, block=False)

    def get(self, block: bool = True, timeout: Optional[float] = None):
        sched = self._sched
        task = sched._cur()
        if task is not None and sched._running:
            sched._switch()
        while not self._items:
            if task is None or not sched._running or not block:
                raise _queue_mod.Empty
            if sched._switch(_BLOCKED, ("queue_get", self), timeout):
                raise _queue_mod.Empty
        item = self._items.popleft()
        sched._wake(("queue_put", self))
        return item

    def get_nowait(self):
        return self.get(block=False)


class SchedThread:
    """threading.Thread shim: start() registers a managed task."""

    def __init__(self, sched: Scheduler, *, target=None, name=None,
                 args=(), kwargs=None, daemon=None):
        self._sched = sched
        self._target = target
        self._args = tuple(args)
        self._kwargs = dict(kwargs or {})
        self.name = name or f"thread-{id(self):x}"
        self.daemon = bool(daemon)
        self._task: Optional[_Task] = None

    def start(self) -> None:
        if self._task is not None:
            raise RuntimeError("threads can only be started once")
        self._task = self._sched.spawn(
            lambda: self._target(*self._args, **self._kwargs),
            name=self.name, daemon=self.daemon)
        if self._sched._cur() is not None:
            self._sched._switch()

    def is_alive(self) -> bool:
        return self._task is not None and self._task.state != _DONE

    def join(self, timeout: Optional[float] = None) -> None:
        sched = self._sched
        task = sched._cur()
        if self._task is None or self._task.state == _DONE:
            return
        if task is None or not sched._running:
            return
        sched._switch()
        while self._task.state != _DONE:
            if sched._switch(_BLOCKED, ("join", self._task), timeout):
                return


# ---------------------------------------------------------------------------
# running schedules


def _prewarm_defaults() -> None:
    """Materialize the process-wide singletons (default registry/health/
    watchdog/tripwire, numpy) BEFORE the shims go in: a lazy first touch
    from inside an instrumented drill would bake scheduler-bound shim
    locks into objects that outlive the schedule — the first run would
    then differ from every later one AND leak dead shims process-wide."""
    import concurrent.futures.thread  # noqa: F401 — lazily bound
    import numpy  # noqa: F401 — drills build Request rows

    # the drilled modules and what they import (torch among them): an
    # import inside the instrumented window would run module-level lock
    # and thread set-up on the shims
    import dryad_tpu_torch.continual.publish  # noqa: F401
    import dryad_tpu_torch.continual.scheduler  # noqa: F401
    import dryad_tpu_torch.data.stream_dataset  # noqa: F401
    import dryad_tpu_torch.fleet.autoscale  # noqa: F401
    import dryad_tpu_torch.fleet.supervisor  # noqa: F401
    import dryad_tpu_torch.obs.drift  # noqa: F401
    import dryad_tpu_torch.resilience.faults  # noqa: F401
    import dryad_tpu_torch.serve.batcher  # noqa: F401

    from dryad_tpu_torch.obs import spans  # noqa: F401
    from dryad_tpu_torch.obs.health import default_health
    from dryad_tpu_torch.obs.registry import default_registry
    from dryad_tpu_torch.obs.tripwire import default_tripwire
    from dryad_tpu_torch.obs.watchdog import default_watchdog

    default_registry()
    default_health()
    default_watchdog()
    default_tripwire()


def run_schedule(drill: Callable, seed: int, *, preempt_p: float = 0.0,
                 trace_files: tuple = (), max_steps: int = 50000) -> Scheduler:
    """One deterministic schedule of ``drill``: instrument, let the drill
    register tasks (and return an optional post-run check), run, verify
    the recorded lock order.  Raises on any invariant failure, deadlock,
    or lock-order cycle; returns the scheduler (steps/edges) on success.
    """
    _prewarm_defaults()
    from dryad_tpu_torch.obs.registry import default_registry

    # the PROCESS default registry stays out of the schedule: a span
    # recorded from drilled code would otherwise lazily create families
    # (locks included) INSIDE the instrumented window — shim locks baked
    # into a process-wide singleton, and first-run schedules that differ
    # from every later one.  Drills that exercise the registry build
    # their own instance under instrumentation instead.
    reg = default_registry()
    was_enabled = reg.enabled
    reg.disable()
    sched = Scheduler(seed, preempt_p=preempt_p, trace_files=trace_files,
                      max_steps=max_steps)
    try:
        with sched.instrument():
            check = drill(sched)
            sched.run()
            if check is not None:
                check()
        sched.check_lock_order()
    finally:
        sched.restore_patches()
        if was_enabled:
            reg.enable()
    return sched


def run_schedules(drill: Callable, seeds, **kw) -> int:
    """Run ``drill`` across ``seeds``; raises (annotated with the seed) on
    the first failing schedule, returns the number run otherwise."""
    n = 0
    for seed in seeds:
        try:
            run_schedule(drill, seed, **kw)
        except BaseException as e:
            msg = f"[schedule seed {seed}] {e}"
            try:
                wrapped = type(e)(msg)
            except Exception:        # exotic exception signatures
                wrapped = AssertionError(msg)
            raise wrapped from e
        n += 1
    return n


# ---------------------------------------------------------------------------
# drills — the recorded race classes, as reusable schedule programs.
# Each returns a post-run check; invariants also assert inside tasks.


def drill_batcher_stop_start(sched: Scheduler):
    """MicroBatcher stop-vs-start-vs-predict — the generation race.

    A dispatch wedges (gate event), stop() times out behind it, start()
    reinstates service, the dispatch un-wedges.  Invariant: the stale
    stop token must NOT kill the reinstated worker — a request submitted
    after reinstatement completes.  Mechanically reverting the fix
    (``_stop_live`` returning True for stale tokens) fails every
    schedule that reaches the reinstatement."""
    import numpy as np

    from dryad_tpu_torch.serve.batcher import MicroBatcher, Request

    gate = _threading.Event()        # shimmed: created under instrument()
    entered = _threading.Event()
    results: dict = {}

    def dispatch(batch):
        entered.set()
        gate.wait()
        return [r.rows for r in batch]

    b = MicroBatcher(dispatch, max_wait_ms=1.0, queue_size=8)

    def submit(tag: str, timeout: float) -> None:
        req = Request(np.zeros((1, 2), np.float32))
        try:
            results[tag] = ("ok", b.submit(req, timeout=timeout))
        except BaseException as e:   # noqa: BLE001 — the verdict payload
            results[tag] = ("err", e)

    def service() -> None:
        b.start()
        submit("r1", 30.0)

    def controller() -> None:
        entered.wait()               # the worker is wedged in dispatch
        b.stop(timeout=0.05)         # join times out; token stays queued
        b.start()                    # deliberate reinstatement
        gate.set()                   # un-wedge the old dispatch
        submit("r2", 10.0)           # service must still be alive
        b.stop(timeout=30.0)         # clean shutdown drains

    sched.spawn(service, "service")
    sched.spawn(controller, "controller")

    def check() -> None:
        assert results.get("r1", ("?",))[0] == "ok", \
            f"r1 lost through the wedged dispatch: {results.get('r1')}"
        assert results.get("r2", ("?",))[0] == "ok", (
            "stop/start generation race: a stale stop token killed the "
            f"reinstated worker and dropped r2 ({results.get('r2')})")

    return check


class _FakeReplicaProc:
    """Drill-controlled stand-in for fleet.replica.ReplicaProcess — same
    surface the supervisor touches, no subprocesses.  ``script`` hooks:
    ``on_start(proc)`` may block (a slow spawn)."""

    def __init__(self, sched: Scheduler, registry: list, script: dict,
                 make_argv, name="r0", env=None, startup_timeout_s=60.0,
                 log_dir=None):
        self._sched = sched
        self._script = script
        self.name = name
        self.env = dict(env or {})
        self.exit_code: Optional[int] = None
        self.health_status: "int | None" = 200
        self.host, self.port = "127.0.0.1", 1
        self.loaded_versions: list = []
        registry.append(self)

    def start(self):
        self._sched.pause()
        hook = self._script.get("on_start")
        if hook is not None:
            hook(self)
        return self

    def poll(self) -> Optional[int]:
        return self.exit_code

    @property
    def alive(self) -> bool:
        return self.exit_code is None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def clock_offset(self, timeout_s: float = 2.0) -> Optional[float]:
        # the registration handshake: a fake replica has no /clock
        # (the protocol stubs' answer before the handshake)
        return None

    def health(self, timeout_s: float = 2.0):
        self._sched.pause()
        if self.exit_code is not None:
            return None, 0.0
        return self.health_status, 0.0

    def stop(self, grace_s: float = 3.0) -> Optional[int]:
        if self.exit_code is None:
            self.exit_code = -15
        return self.exit_code

    def load_model(self, path, *, name=None, activate=True, auth_token=None,
                   timeout_s=120.0) -> int:
        self._sched.pause()
        if self.exit_code is not None:
            raise OSError(f"replica {self.name} is dead")
        self.loaded_versions.append(path)
        return 2


class _MemJournal:
    """In-memory journal with the RunJournal lock discipline — the drills
    assert on its event sequence."""

    GUARDED_BY = {"events": "_lock"}

    def __init__(self):
        self._lock = _threading.Lock()   # shimmed under instrument()
        self.events: list = []

    def event(self, kind: str, /, **fields) -> None:
        with self._lock:
            self.events.append((kind, fields))

    def kinds(self) -> list:
        with self._lock:
            return [k for k, _ in self.events]

    def close(self) -> None:
        pass


def _make_fleet(sched: Scheduler, script: dict, n: int = 2):
    from dryad_tpu_torch.fleet import supervisor as sup_mod
    from dryad_tpu_torch.obs.registry import Registry
    from dryad_tpu_torch.resilience.policy import RetryPolicy

    procs: list = []

    def proc_factory(make_argv, *, name="r0", env=None,
                     startup_timeout_s=60.0, log_dir=None):
        return _FakeReplicaProc(sched, procs, script, make_argv, name=name,
                                env=env, startup_timeout_s=startup_timeout_s,
                                log_dir=log_dir)

    sched.monkeypatch(sup_mod, "ReplicaProcess", proc_factory)
    journal = _MemJournal()
    fs = sup_mod.FleetSupervisor(
        lambda i, pf: ["stub"], n,
        policy=RetryPolicy(retry_budget=3, backoff_base_s=0.01,
                           backoff_max_s=0.02),
        journal=journal, registry=Registry(enabled=False),
        probe_interval_s=0.05, probe_timeout_s=0.01,
        unhealthy_after=1, recycle_after=3, startup_timeout_s=5.0)
    return fs, journal, procs


def _wait_until(pred: Callable[[], bool], what: str,
                tries: int = 4000) -> None:
    for _ in range(tries):
        if pred():
            return
        _time_mod.sleep(0.01)        # shimmed: a virtual-clock tick
    raise AssertionError(f"condition never held: {what}")


def drill_supervisor_recovery(sched: Scheduler):
    """FleetSupervisor monitor-vs-recovery-vs-crash.

    Slot 0 crashes and its RESPAWN is wedged (slow spawn); slot 1 then
    crashes too.  Invariant: the monitor, not blocked by slot 0's
    recovery (the async-recovery fix), detects and respawns slot 1
    while slot 0 is still wedged; both slots end healthy at generation 1
    with exactly one spawn per (slot, generation); stop() leaves no live
    process.  Mechanically reverting recovery to the monitor thread
    deadlocks the second detection and fails the drill."""
    hold = _threading.Event()

    def on_start(proc: _FakeReplicaProc) -> None:
        if proc.name == "r0g1":      # slot 0's respawn only
            hold.wait()

    fs, journal, procs = _make_fleet(sched, {"on_start": on_start}, n=2)

    def by_name(name: str) -> _FakeReplicaProc:
        for p in procs:
            if p.name == name:
                return p
        raise AssertionError(f"no spawned proc named {name}")

    def controller() -> None:
        fs.start()
        by_name("r0g0").exit_code = 23           # injected crash, slot 0
        _wait_until(lambda: any(p.name == "r0g1" for p in procs),
                    "slot 0 respawn dispatched")
        by_name("r1g0").exit_code = 23           # crash slot 1 MID-recovery
        _wait_until(lambda: fs.slots[1].generation == 1
                    and fs.slots[1].healthy,
                    "slot 1 respawned while slot 0 recovery is wedged")
        hold.set()                               # release slot 0's spawn
        _wait_until(lambda: fs.slots[0].generation == 1
                    and fs.slots[0].healthy, "slot 0 recovered")
        fs.stop()

    sched.spawn(controller, "controller")

    def check() -> None:
        names = [p.name for p in procs]
        assert len(names) == len(set(names)), \
            f"double-dispatched recovery: duplicate spawns {names}"
        assert sorted(names) == ["r0g0", "r0g1", "r1g0", "r1g1"], names
        for slot in fs.slots:
            assert not slot.recovering, f"{slot.name} left recovering"
        assert all(p.exit_code is not None for p in procs), \
            "stop() left a live replica process"
        kinds = journal.kinds()
        assert kinds.count("replica_crash") == 2, kinds
        assert kinds[-1] == "fleet_stop", kinds

    return check


def drill_rolling_push_vs_death(sched: Scheduler):
    """rolling_push vs router traffic vs a replica dying mid-push.

    Invariants: the drain always reaches zero (no in-flight request is
    dropped or leaked — final inflight == 0 on every slot), ``draining``
    is always restored, the dead slot's swap fails/skips cleanly while
    the other swaps, and the swap-lock/journal-lock runtime order stays
    acyclic (checked by the harness on every schedule)."""
    fs, journal, procs = _make_fleet(sched, {}, n=2)
    push_result: list = []

    def traffic() -> None:
        # a router-shaped client: mark in-flight, re-check routable (the
        # pick->inc window close), do some work, unmark
        for i in range(8):
            slot = fs.slots[i % 2]
            slot.inflight_inc()
            if not slot.routable:
                slot.inflight_dec()
                continue
            _time_mod.sleep(0.003)
            slot.inflight_dec()

    def pusher() -> None:
        _wait_until(lambda: fs._monitor is not None, "fleet started")
        push_result.append(fs.rolling_push("model-v2", drain_timeout_s=5.0))

    def killer() -> None:
        _wait_until(lambda: any(s.draining for s in fs.slots)
                    or push_result, "push began draining")
        fs.slots[1].proc.exit_code = 23

    def controller() -> None:
        fs.start()
        t = [sched.spawn(traffic, "traffic"), sched.spawn(pusher, "pusher"),
             sched.spawn(killer, "killer")]
        _wait_until(lambda: push_result, "push completed")
        _wait_until(lambda: all(x.state == _DONE for x in t),
                    "traffic drained")
        fs.stop()

    sched.spawn(controller, "controller")

    def check() -> None:
        assert push_result, "rolling_push never returned"
        res = push_result[0]
        for slot in fs.slots:
            assert slot.inflight == 0, \
                f"{slot.name} leaked inflight={slot.inflight}"
            assert not slot.draining, f"{slot.name} left draining"
        swapped = set(res["versions"])
        untouched = set(res["errors"]) | set(res["skipped"])
        assert swapped | untouched == {"r0", "r1"}, res
        assert "r0" in swapped, f"healthy slot failed to swap: {res}"

    return check


def drill_registry_snapshot(sched: Scheduler):
    """obs Registry record-vs-snapshot-vs-exposition-vs-reset.

    Invariant: a snapshot is INTERNALLY consistent — no torn labeled
    series: every histogram state satisfies count == sum(bucket counts)
    and (all observations being 1.0) sum == count; final totals are
    exact.  Runs with line-granular preemption inside obs/registry.py so
    a lock-free reader (the mutation the pytest suite seeds) tears."""
    from dryad_tpu_torch.obs.registry import Registry

    reg = Registry(enabled=True)
    c = reg.counter("dryad_drill_total", "drill counter")
    # the port's one histogram kind is the fixed log-bucket scheme
    h = reg.log_histogram("dryad_drill_lat", "drill histogram")
    tmp = reg.counter("dryad_drill_tmp_total", "reset fodder")
    snaps: list = []

    def writer(tag: str) -> Callable[[], None]:
        def run() -> None:
            for _ in range(6):
                c.labels(worker=tag).inc()
                h.labels(worker=tag).observe(1.0)
        return run

    def snapshotter() -> None:
        for _ in range(5):
            snaps.append(reg.snapshot())
            reg.exposition()

    def resetter() -> None:
        for _ in range(3):
            tmp.inc()
            reg.reset_prefix("dryad_drill_tmp")

    sched.spawn(writer("a"), "writer-a")
    sched.spawn(writer("b"), "writer-b")
    sched.spawn(snapshotter, "snapshotter")
    sched.spawn(resetter, "resetter")

    def check() -> None:
        final = reg.snapshot()
        for snap in snaps + [final]:
            for name, series in snap["histograms"].items():
                for lbl, st in series.items():
                    assert st["count"] == sum(st["counts"]), (
                        f"torn histogram snapshot {name}{{{lbl}}}: "
                        f"count={st['count']} counts={st['counts']}")
                    assert abs(st["sum"] - st["count"]) < 1e-9, (
                        f"torn histogram sum {name}{{{lbl}}}: {st}")
        for tag in ("a", "b"):
            key = f'worker="{tag}"'
            assert final["counters"]["dryad_drill_total"][key] == 6
            assert final["histograms"]["dryad_drill_lat"][key]["count"] == 6

    return check


def drill_loghist_scrape_tear(sched: Scheduler):
    """log-histogram scrape-tear: concurrent O(1) observes into two
    registries (two "replicas") while a scraper snapshots both and
    EXACT-MERGES their series — the fleet router's /metrics shape.

    Invariants: every scraped state is internally consistent (count ==
    sum of bucket counts — a torn counts/sum/count triple is the race
    the line-granular preemption exposes), every merged state is too,
    and the FINAL merge is bitwise-equal to one histogram of the
    concatenated observations (dyadic values make the float sums
    associative, so "bitwise" is exact, not approximate)."""
    from dryad_tpu_torch.obs.registry import (REQUEST_LATENCY, Registry,
                                        merge_hist_states)

    regs = [Registry(enabled=True), Registry(enabled=True)]
    fams = [r.log_histogram(REQUEST_LATENCY, "drill") for r in regs]
    values = [2.0 ** -k for k in range(1, 7)]      # dyadic: exact sums
    merges: list = []

    def writer(ri: int) -> Callable[[], None]:
        series = fams[ri].labels(priority="interactive", stage="total")

        def run() -> None:
            for v in values:
                series.observe(v)
        return run

    def scraper() -> None:
        for _ in range(5):
            blocks = [r.snapshot()["histograms"].get(REQUEST_LATENCY, {})
                      for r in regs]
            per_label: dict = {}
            for block in blocks:
                for lbl, st in block.items():
                    assert st["count"] == sum(st["counts"]), (
                        f"torn scraped state {lbl}: {st}")
                    per_label.setdefault(lbl, []).append(
                        (st["counts"], st["sum"], st["count"]))
            merged = {lbl: merge_hist_states(sts)
                      for lbl, sts in per_label.items()}
            for lbl, (counts, _s, n) in merged.items():
                assert n == sum(counts), f"torn merge {lbl}"
            merges.append(merged)

    sched.spawn(writer(0), "replica-a")
    sched.spawn(writer(1), "replica-b")
    sched.spawn(scraper, "scraper")

    def check() -> None:
        ref = Registry(enabled=True)
        series = ref.log_histogram(REQUEST_LATENCY, "ref").labels(
            priority="interactive", stage="total")
        for _ in regs:                     # the concatenated observations
            for v in values:
                series.observe(v)
        final = merge_hist_states(
            [f.labels(priority="interactive", stage="total").value()
             for f in fams])
        want = series.value()
        assert final[0] == want[0], "merged counts != concatenated"
        assert final[1] == want[1], "merged sum != concatenated (bitwise)"
        assert final[2] == want[2]
        assert merges, "the scraper never ran"

    return check


def drill_drift_window_tear(sched: Scheduler):
    """drift-window tear: concurrent binned-batch/score observes into
    two replica DriftMonitors while a third rotates its two-epoch window
    and a scraper snapshots + EXACT-MERGES the export blocks — the fleet
    router's /drift shape, under line-granular preemption inside
    obs/drift.py.

    Invariants: every scraped block is internally consistent (each
    feature's window counts sum to the block's row count — a row
    increments exactly one bin per feature, so a torn counts-vs-rows
    read is the race the preemption exposes; the score state likewise),
    every merge of consistent blocks is consistent, and the FINAL merge
    equals one monitor fed the concatenated observations bitwise
    (integer counts — the merge-counts-never-ratios discipline), with
    PSI on the merge equal to PSI on the concatenation."""
    import numpy as np

    from dryad_tpu_torch.obs.drift import (DriftMonitor, drift_report,
                                     merge_drift_states)
    from dryad_tpu_torch.obs.registry import Registry

    ref = [[4, 4, 4, 4], [1, 2, 4, 9]]
    reg = Registry(enabled=False)
    mons = [DriftMonitor(ref, model="v1", window_rows=10 ** 6, registry=reg)
            for _ in range(2)]
    rot = DriftMonitor(ref, model="rot", window_rows=8, registry=reg)
    batches = [np.asarray([[0, 1], [1, 2], [2, 3]], np.uint8),
               np.asarray([[3, 0]], np.uint8),
               np.asarray([[2, 2], [1, 1]], np.uint8)]
    scores = [np.asarray([0.5, -0.5, 2.0]), np.asarray([0.25]),
              np.asarray([-2.0, 1.0])]
    merges: list = []

    def consistent(st: dict) -> None:
        for counts in st["features"]:
            assert sum(counts) == st["rows"], (
                f"torn drift block {st['model']}: rows={st['rows']} "
                f"counts={st['features']}")
        if st["score"] is not None:
            assert st["score"][2] == sum(st["score"][0]), (
                f"torn score state {st['model']}: {st['score']}")

    def writer(mi: int) -> Callable[[], None]:
        def run() -> None:
            for batch, sc in zip(batches, scores):
                mons[mi].observe_features(batch)
                mons[mi].observe_scores(sc)
        return run

    def rotator() -> None:
        # window 8 -> half 4: these 20 rows rotate the epochs repeatedly
        # while the scraper reads — a torn prev/cur swap breaks the
        # counts-vs-rows invariant
        for _ in range(4):
            rot.observe_features(batches[0])
            rot.observe_features(batches[2])

    def scraper() -> None:
        for _ in range(5):
            states = [m.export_state() for m in mons]
            for st in states + [rot.export_state()]:
                consistent(st)
            merged = merge_drift_states(states)
            for counts in merged["features"]:
                assert sum(counts) == merged["rows"], f"torn merge {merged}"
            merges.append(merged)

    sched.spawn(writer(0), "replica-a")
    sched.spawn(writer(1), "replica-b")
    sched.spawn(rotator, "rotator")
    sched.spawn(scraper, "scraper")

    def check() -> None:
        ref_mon = DriftMonitor(ref, model="ref", window_rows=10 ** 6,
                               registry=reg)
        for _ in mons:                     # the concatenated observations
            for batch, sc in zip(batches, scores):
                ref_mon.observe_features(batch)
                ref_mon.observe_scores(sc)
        merged = merge_drift_states([m.export_state() for m in mons])
        want = ref_mon.export_state()
        assert merged["features"] == want["features"], \
            "merged counts != concatenated"
        assert merged["rows"] == want["rows"]
        assert merged["score"][0] == want["score"][0], \
            "merged score counts != concatenated"
        assert merged["score"][2] == want["score"][2]
        assert (drift_report(merged)["psi_max"]
                == drift_report(want)["psi_max"]), \
            "PSI on the merge != PSI on the concatenation"
        assert merges, "the scraper never ran"

    return check


def drill_injector_concurrent_fire(sched: Scheduler):
    """FaultInjector concurrent fire — the atomic check-and-clear.

    Four handler threads hit a ONE-SHOT reject point simultaneously.
    Invariant: it fires exactly once (one InjectedReject, one ``fired``
    record, zero left armed).  The non-atomic pre-fix version double-
    fires under line preemption (seeded by the pytest mutation test)."""
    from dryad_tpu_torch.resilience.faults import (FaultInjector, FaultPoint,
                                             InjectedReject)

    inj = FaultInjector([FaultPoint(0, kind="reject_503", site="request")])
    rejections: list = []

    def caller(i: int) -> Callable[[], None]:
        def run() -> None:
            try:
                inj("request", i)
            except InjectedReject:
                rejections.append(i)
        return run

    for i in range(4):
        sched.spawn(caller(i), f"handler-{i}")

    def check() -> None:
        assert len(rejections) == 1, (
            f"one-shot injection fired {len(rejections)} times "
            f"(callers {sorted(rejections)}) — the armed check-and-clear "
            "is not atomic")
        assert len(inj.fired) == 1 and inj.pending == 0

    return check


def drill_scheduler_breach_vs_push(sched: Scheduler):
    """RetrainScheduler concurrent breach-vs-retrain-vs-push-vs-death.

    The REAL RetrainScheduler and ProbationPublisher run against the live
    FleetSupervisor: two breach tasks each deliver 2 drift-breach events
    for the same model while the first admitted retrain (fake launcher on
    the virtual clock) is in flight, a concurrent rolling push swaps an
    unrelated model, and a replica dies mid-everything.  Invariants: the
    debounce admits EXACTLY ONE retrain for the burst (every other
    delivery journals ``retrain_skipped``), the completed generation
    settles to exactly one publish outcome, no in-flight state leaks, and
    the runtime lock order stays acyclic.  Mechanically splitting
    ``_admit``'s checks from its in-flight mark (the unlocked-streak
    mutation, seeded by the pytest mutation test) double-launches and
    fails the drill."""
    from dryad_tpu_torch.continual.publish import ProbationPublisher
    from dryad_tpu_torch.continual.scheduler import RetrainScheduler
    from dryad_tpu_torch.obs.registry import Registry
    from dryad_tpu_torch.resilience.policy import RetryPolicy

    fs, journal, procs = _make_fleet(sched, {}, n=2)
    launched: list = []

    def launch(model: str, gen: int, job: int, artifact: str):
        launched.append((model, gen, job))
        _time_mod.sleep(0.05)            # the retrain's virtual wall
        return True, f"{artifact}-g{gen}", ""

    def verdicts() -> dict:
        # clean traffic with rows flowing — probation must promote (the
        # rollback arm is the smoke's territory; here the race is the
        # debounce, not the verdict)
        return {"m": {"rows": 64, "breached": False, "sustained": False,
                      "psi_max": 0.01, "score_psi": 0.0, "streak": 0}}

    def push(path: str, model: str):
        res = fs.rolling_push(path, name=model, drain_timeout_s=5.0)
        errs = list(res.get("errors") or [])
        return (not errs), "; ".join(str(e) for e in errs)

    pub = ProbationPublisher(push, verdicts, journal=journal.event,
                             probation_polls=2, poll_interval_s=0.01,
                             clear_after=1, registry=Registry(enabled=False))
    rs = RetrainScheduler(
        {"m": "art-g0"}, launch, journal=journal.event, publisher=pub,
        policy=RetryPolicy(retry_budget=3, backoff_base_s=0.01),
        cooldown_s=1000.0, max_concurrent=1,
        has_profile=lambda p: True, registry=Registry(enabled=False))

    def breacher() -> None:
        for _ in range(2):
            rs.trigger("m", origin="drill")

    def pusher() -> None:
        _wait_until(lambda: fs._monitor is not None, "fleet started")
        fs.rolling_push("other-model", name="other", drain_timeout_s=5.0)

    def killer() -> None:
        _wait_until(lambda: launched, "retrain admitted")
        procs[1].exit_code = 23

    def controller() -> None:
        fs.start()
        tasks = [sched.spawn(breacher, "breach-a"),
                 sched.spawn(breacher, "breach-b"),
                 sched.spawn(pusher, "pusher"),
                 sched.spawn(killer, "killer")]
        _wait_until(lambda: all(x.state == _DONE for x in tasks),
                    "drill tasks done")
        _wait_until(lambda: not rs.state()["inflight"], "retrain drained")
        fs.stop()

    sched.spawn(controller, "controller")

    def check() -> None:
        kinds = journal.kinds()
        assert len(launched) == 1, (
            f"debounce double-launched: {launched} — _admit's check and "
            "in-flight mark are not one critical section")
        assert kinds.count("retrain_triggered") == 1, kinds
        assert kinds.count("retrain_complete") == 1, kinds
        assert kinds.count("retrain_skipped") == 3, kinds
        assert kinds.count("generation_rolled_back") == 0, kinds
        st = rs.state()
        assert not st["inflight"], f"in-flight state leaked: {st}"
        promoted = kinds.count("generation_promoted")
        failed = kinds.count("push_failed")
        # the killed replica may or may not be respawned by the time the
        # probation push lands — per seed exactly one outcome settles
        assert promoted + failed == 1, kinds
        if promoted:
            assert st["generation"]["m"] == 1, st
            assert st["artifacts"]["m"] == "art-g0-g1", st
        else:
            assert st["generation"]["m"] == 0, st
            assert st["artifacts"]["m"] == "art-g0", st

    return check


def drill_stream_prefetch(sched: Scheduler):
    """The data plane: ChunkPrefetcher producer-vs-consumer-vs-
    cancel.  Three REAL prefetchers run under line preemption: (a) a full
    sweep that must see every (i, chunk) pair exactly once, in order and
    untorn; (b) an early-abandon consumer whose mid-stream close() must
    unwedge a producer racing a depth-1 queue and reap its thread — the
    drain-outside-the-lock + cancellable-put contract (mechanically
    reverting the cancellable put wedges this arm on the sentinel put);
    (c) a reader that raises mid-stream — the error must surface in the
    consumer, never vanish into the producer thread."""
    from dryad_tpu_torch.data.stream_dataset import ChunkPrefetcher

    state = {"full": [], "cancelled": False, "error": None}

    def full_sweep() -> None:
        pf = ChunkPrefetcher(lambda i: [i] * 4, 6, depth=2)
        try:
            for i, chunk in pf:
                assert chunk == [i] * 4, f"torn chunk pairing: {i}, {chunk}"
                state["full"].append(i)
        finally:
            pf.close()
        assert not pf._thread.is_alive(), "full-sweep producer leaked"

    def cancel_midstream() -> None:
        # 50 chunks against a depth-1 queue: the producer is essentially
        # always one put ahead, blocked, when close() lands
        pf = ChunkPrefetcher(lambda i: [i] * 4, 50, depth=1)
        it = iter(pf)
        next(it)
        pf.close()
        assert not pf._thread.is_alive(), (
            "close() left the producer wedged on the full queue")
        state["cancelled"] = True

    def error_stream() -> None:
        def read(i: int):
            if i == 2:
                raise RuntimeError("disk gone")
            return [i] * 4

        pf = ChunkPrefetcher(read, 5, depth=2)
        got = []
        try:
            for i, _chunk in pf:
                got.append(i)
        except RuntimeError as e:
            state["error"] = str(e)
        finally:
            pf.close()
        assert got == [0, 1], got

    sched.spawn(full_sweep, "full-sweep")
    sched.spawn(cancel_midstream, "cancel-midstream")
    sched.spawn(error_stream, "error-stream")

    def check() -> None:
        assert state["full"] == list(range(6)), (
            f"chunks lost/reordered/duplicated: {state['full']}")
        assert state["cancelled"], "mid-stream close never completed"
        assert state["error"] == "disk gone", state["error"]

    return check


def drill_capacity_breach_vs_push(sched: Scheduler):
    """elastic capacity: CapacityController vs concurrent breach
    deliveries vs rolling push vs a replica crash.

    The REAL CapacityController drives the REAL FleetSupervisor slot
    registry (fake replica processes on the virtual clock): two scaler
    tasks poke the controller concurrently under sustained pressure
    while a rolling push swaps models and a replica dies mid-everything;
    once the new replica is routable the signal flips to sustained
    headroom and the pool must drain back down.  Invariants: EXACTLY ONE
    scale-up for the burst (every refused poke journals
    ``scale_skipped`` with a canonical reason), exactly one scale-down,
    the retired slot is never resurrected by the monitor, pokes at the
    min bound journal ``at-bound``, router-shaped traffic never leaks
    inflight through the drain, and the runtime lock order stays
    acyclic.  Mechanically splitting ``_admit``'s checks from its
    in-flight mark (the unlocked mutation in the pytest revert test)
    double-launches the spawn and fails the drill."""
    from dryad_tpu_torch.fleet.autoscale import (SKIP_AT_BOUND, SKIP_COOLDOWN,
                                           SKIP_IN_FLIGHT, SKIP_SUSTAIN,
                                           CapacityController)
    from dryad_tpu_torch.obs.registry import Registry

    fs, journal, procs = _make_fleet(sched, {}, n=2)
    sig = {"mode": "calm"}

    def signals() -> dict:
        # the drill's router stand-in: pressure = admission saturation,
        # headroom = near-empty fleet, calm = neither (streaks reset)
        mode = sig["mode"]
        inflight = {"pressure": 8, "headroom": 0, "calm": 4}[mode]
        slo = ({"interactive": {"breached": True, "sustained": True,
                                "p_ms": 900.0, "budget_ms": 250.0}}
               if mode == "pressure" else {})
        return {"slo": slo, "inflight": inflight, "max_inflight": 10,
                "slots": {}}

    ctrl = CapacityController(
        fs, signals, min_replicas=2, max_replicas=3,
        breach_after=1, idle_after=1,
        cooldown_up_s=1000.0, cooldown_down_s=1000.0,
        poll_interval_s=0.01, drain_timeout_s=5.0,
        registry=Registry(enabled=False))

    def by_name(name: str) -> _FakeReplicaProc:
        for p in procs:
            if p.name == name:
                return p
        raise AssertionError(f"no spawned proc named {name}")

    def scaler() -> None:
        for _ in range(2):
            ctrl.poke()
            _time_mod.sleep(0.003)

    def traffic() -> None:
        # router-shaped clients: mark in-flight, re-check routable (the
        # pick->inc window close), work, unmark — the retire drain must
        # wait these out, never drop them
        for i in range(12):
            slots = fs.slots
            slot = slots[i % len(slots)]
            slot.inflight_inc()
            if not slot.routable:
                slot.inflight_dec()
                continue
            _time_mod.sleep(0.003)
            slot.inflight_dec()

    def pusher() -> None:
        _wait_until(lambda: fs._monitor is not None, "fleet started")
        fs.rolling_push("model-v2", drain_timeout_s=5.0)

    def killer() -> None:
        _wait_until(lambda: any(p.name.startswith("r2") for p in procs),
                    "scale-up spawn dispatched")
        by_name("r0g0").exit_code = 23       # crash slot 0 mid-scale-up

    def downscaler() -> None:
        for _ in range(60):
            ctrl.poke()
            if (len(fs.slots) == 2
                    and ctrl.state()["action_in_flight"] is None):
                break
            _time_mod.sleep(0.01)
        ctrl.poke()                          # at the min bound now:
        ctrl.poke()                          # must journal ``at-bound``

    def controller() -> None:
        fs.start()
        sig["mode"] = "pressure"
        tasks = [sched.spawn(scaler, "scale-a"),
                 sched.spawn(scaler, "scale-b"),
                 sched.spawn(traffic, "traffic"),
                 sched.spawn(pusher, "pusher"),
                 sched.spawn(killer, "killer")]
        _wait_until(lambda: "scale_up" in journal.kinds(),
                    "the burst admitted a scale-up")
        _wait_until(lambda: len(fs.slots) == 3 and fs.slots[2].routable,
                    "new replica routable")
        _wait_until(lambda: fs.slots[0].generation == 1
                    and fs.slots[0].healthy, "crashed replica respawned")
        _wait_until(lambda: all(x.state == _DONE for x in tasks),
                    "pressure-phase tasks done")
        _wait_until(lambda: ctrl.state()["action_in_flight"] is None,
                    "scale-up settled")
        sig["mode"] = "headroom"
        down = sched.spawn(downscaler, "downscaler")
        _wait_until(lambda: down.state == _DONE, "drain-down done")
        ctrl.stop(timeout_s=1.0)
        fs.stop()

    sched.spawn(controller, "controller")

    def check() -> None:
        kinds = journal.kinds()
        assert kinds.count("scale_up") == 1, (
            f"capacity burst not exactly-one: {kinds} — _admit's check "
            "and in-flight mark are not one critical section")
        assert kinds.count("scale_down") == 1, kinds
        assert kinds.count("scale_failed") == 0, kinds
        assert kinds.count("replica_retired") == 1, kinds
        reasons = [f.get("reason") for k, f in journal.events
                   if k == "scale_skipped"]
        assert set(reasons) <= {SKIP_AT_BOUND, SKIP_COOLDOWN,
                                SKIP_IN_FLIGHT, SKIP_SUSTAIN}, reasons
        assert SKIP_AT_BOUND in reasons, (
            f"min-bound pokes never journaled at-bound: {reasons}")
        r2_spawns = [p.name for p in procs if p.name.startswith("r2")]
        assert r2_spawns == ["r2g0"], (
            f"retired slot resurrected: {r2_spawns}")
        names = [s.name for s in fs.slots]
        assert names == ["r0", "r1"], f"pool did not settle: {names}"
        for slot in fs.slots:
            assert not slot.retiring, f"{slot.name} left retiring"
            assert slot.inflight == 0, \
                f"{slot.name} leaked inflight={slot.inflight}"
        assert all(p.exit_code is not None for p in procs), \
            "stop() left a live replica process"
        st = ctrl.state()
        assert st["action_in_flight"] is None, st
        assert st["actions_total"] == {"up": 1, "down": 1}, st

    return check


#: name -> (drill, schedules to run in CI, preempt_p, trace file suffixes)
DRILLS: dict = {
    "batcher-stop-start": (drill_batcher_stop_start, 20, 0.1,
                           ("serve/batcher.py",)),
    "supervisor-recovery": (drill_supervisor_recovery, 10, 0.05,
                            ("fleet/supervisor.py",)),
    "rolling-push-vs-death": (drill_rolling_push_vs_death, 10, 0.05,
                              ("fleet/supervisor.py",)),
    "registry-snapshot": (drill_registry_snapshot, 20, 0.25,
                          ("obs/registry.py",)),
    "loghist-scrape-tear": (drill_loghist_scrape_tear, 20, 0.25,
                            ("obs/registry.py",)),
    "drift-window-tear": (drill_drift_window_tear, 15, 0.25,
                          ("obs/drift.py",)),
    "injector-concurrent-fire": (drill_injector_concurrent_fire, 20, 0.3,
                                 ("resilience/faults.py",)),
    "scheduler-breach-vs-push": (drill_scheduler_breach_vs_push, 10, 0.1,
                                 ("continual/scheduler.py",)),
    "stream-prefetch": (drill_stream_prefetch, 15, 0.25,
                        ("data/stream_dataset.py",)),
    "capacity-vs-breach-vs-push": (drill_capacity_breach_vs_push, 10, 0.1,
                                   ("fleet/autoscale.py",
                                    "fleet/supervisor.py")),
}


def run_ci_drills(schedules: Optional[int] = None, quiet: bool = False,
                  drills=None) -> list:
    """Run every drill across its seed range; returns failure strings
    (empty = pass).  This is the ``--ci``/``--concurrency`` entry.  A
    verdict (an invariant, a deadlock, a lock-order cycle, a runaway
    schedule) is a failure; any other exception is a crashed drill and
    propagates (the CLI's internal error, exit 5, never a pass)."""
    failures = []
    if drills is not None:
        unknown = set(drills) - set(DRILLS)
        if unknown:
            # a typo'd --drill must fail loudly, never "pass" by running
            # zero drills (mirrors run_lint's unknown-rule rejection)
            raise ValueError(f"unknown drill(s): {sorted(unknown)} "
                             f"(known: {sorted(DRILLS)})")
    for name, (drill, n, preempt_p, trace_files) in sorted(DRILLS.items()):
        if drills is not None and name not in drills:
            continue
        count = int(schedules) if schedules is not None else n
        t0 = _time_mod.perf_counter()
        try:
            run_schedules(drill, range(count), preempt_p=preempt_p,
                          trace_files=trace_files)
        except (AssertionError, ScheduleBudgetError) as e:
            failures.append(f"{name}: {e}")
            if not quiet:
                print(f"drill {name}: FAIL — {e}")
            continue
        if not quiet:
            print(f"drill {name}: {count} schedules ok "
                  f"({_time_mod.perf_counter() - t0:.2f}s)")
    return failures
