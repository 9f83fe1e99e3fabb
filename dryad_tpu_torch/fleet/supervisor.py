"""Replica lifecycle supervision: spawn N, probe, respawn, swap.

The training supervisor (resilience/supervisor.py) survives device faults
by classify -> degrade -> resume; this is its serving twin.  The fault
surface is different — a replica is a PROCESS, so death is an exit code
and sickness is a failing ``/healthz`` — but the policy machinery is
deliberately the same ``RetryPolicy`` (budgeted retries, exponential
backoff) and the same append-only ``RunJournal``, so a fleet incident
reads exactly like a training incident: a stream of classified events
with every decision on the record.

Detection model (the monitor thread, one pass per ``probe_interval_s``):

* **crash** — ``proc.poll()`` returns an exit code.  Respawn under the
  budget.  An injected ``replica_crash`` drill dies with the recorded
  ``REPLICA_CRASH_EXIT`` so tests can tell drills from real bugs.
* **hang / slow health** — the process is alive but ``/healthz`` times
  out or refuses.  ``unhealthy_after`` consecutive bad probes take the
  replica out of routing (the cheap, reversible remedy — the router
  simply stops picking it); ``recycle_after`` consecutive bad probes
  kill + respawn it (the expensive remedy, same budget as a crash).
* **stuck-503** — ``/healthz`` ANSWERS, but 503 (the serve tripwire
  latched, or the ``reject_503`` drill): same ladder — out of routing
  first, recycled if it never recovers.  A 503 that clears (e.g. the
  deploy-window recompile case) costs only the routing pause.

Respawn budget is PER SLOT: ``policy.retry_budget`` respawns, backoff
``policy.backoff_s(n)`` between attempts, then the slot FAILS CLOSED
(journaled; the rest of the fleet keeps serving — shared-nothing means
one bad slot never takes the pool down).  Drill faults ride the spawn
environment for generation 0 only: a respawned replica is clean, so a
crash drill proves exactly one death + one recovery.

``rolling_push`` is the zero-drop deploy: replica by replica it DRAINS
(router stops routing to the slot, in-flight requests finish at the
version they resolved — per-process pinning is serve/registry.py's
submit-time contract), then loads + activates the new model through the
replica's own ``/models/load``, waits for health, and restores routing.
In-flight requests are never cut: a drain that cannot reach zero within
``drain_timeout_s`` ABORTS that replica's swap (old model keeps serving)
rather than dropping work.  NOTE a later respawn re-runs the spawn argv,
so a respawned replica comes back with the spawn-time model set — ship a
push by also updating the argv the supervisor was built with (the CLI
does this by restarting the fleet on the new path).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from dryad_tpu_torch.fleet.replica import ReplicaProcess, ReplicaStartupError
from dryad_tpu_torch.obs.registry import Registry, default_registry
from dryad_tpu_torch.resilience.faults import REPLICA_FAULTS_ENV
from dryad_tpu_torch.resilience.journal import RunJournal
from dryad_tpu_torch.resilience.policy import RetryPolicy


class ReplicaSlot:
    """One position in the fleet: the live process (across respawns) plus
    the routing state the router reads.  ``inflight`` is the router's
    in-flight request count against this slot — the drain condition, so
    it is the one field that must never tear: router handler threads
    inc/dec it while ``rolling_push`` waits on it reaching zero.  The
    remaining flags (``healthy``/``draining``/...) are single-writer
    (monitor or push path) with benignly racy reads — ``routable`` is a
    point-in-time answer by design, and the router re-checks it AFTER
    the in-flight mark to close the pick->inc window."""

    def __init__(self, index: int):
        self.index = index
        self.name = f"r{index}"
        self.proc: Optional[ReplicaProcess] = None
        self.healthy = False
        self.draining = False
        self.recovering = False
        # elastic capacity: a slot being drained OUT OF THE FLEET
        # (scale-down).  Single-writer (the retiring thread) like
        # ``draining``; the monitor must never respawn a retiring slot —
        # resurrection would undo the capacity decision mid-drain.
        self.retiring = False
        self.fail_closed = False
        self.generation = 0
        self.respawns = 0
        self.consecutive_bad = 0
        self.last_status: Optional[int] = None
        # perf→wall clock offset captured at registration: the
        # router's merged /trace aligns this slot's spans with it; reset
        # per generation (a respawn is a new perf_counter origin).
        # Single-writer (the spawning thread) with benignly racy reads,
        # like the health flags above.
        self.clock_offset: Optional[float] = None
        self._inflight = 0        # guarded-by: _lock
        self._lock = threading.Lock()

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def inflight_inc(self) -> None:
        with self._lock:
            self._inflight += 1

    def inflight_dec(self) -> None:
        with self._lock:
            self._inflight -= 1

    @property
    def routable(self) -> bool:
        """Whether the router may pick this slot for a new request."""
        return (self.healthy and not self.draining and not self.retiring
                and not self.fail_closed
                and self.proc is not None and self.proc.alive)

    def state(self) -> dict:
        """The observability view (/healthz + /stats on the router)."""
        return {
            "healthy": self.healthy, "draining": self.draining,
            "retiring": self.retiring,
            "fail_closed": self.fail_closed, "generation": self.generation,
            "respawns": self.respawns, "inflight": self.inflight,
            "alive": self.proc is not None and self.proc.alive,
            "url": (self.proc.url if self.proc is not None
                    and self.proc.host is not None else None),
        }


class FleetSupervisor:
    """Own ``n_replicas`` serve processes; keep them alive and swappable.

    ``make_argv(index, port_file)`` builds each replica's command line
    (``fleet.replica.serve_argv`` for production; tests pass a stub).
    ``fault_env`` maps replica index -> a ``DRYAD_REPLICA_FAULTS`` spec
    string armed for that replica's FIRST generation only (drills).
    ``journal`` takes a path (owned/closed here) or an open RunJournal,
    exactly like ``supervise_train``.

    Lock contract: three locks, in the order ``_swap_lock`` before
    ``_slots_lock`` before ``_journal_lock``.  ``_journal_lock``
    guards the journal HANDLE — monitor, recovery threads, and the push
    path all journal concurrently, and ``stop()`` swaps the owned handle
    to None under it (each ``event()`` line is additionally atomic under
    the journal's own lock).  ``_swap_lock`` is a pure serialization
    mutex — one rolling push at a time; nothing else ever acquires it,
    which is why blocking inside it (the drain wait) is allowed.
    ``_slots_lock`` guards the MUTABLE slot
    registry: the autoscaler adds and retires slots at runtime, so every
    reader takes a point-in-time snapshot through the ``slots`` property
    (append/remove are the only mutations, both short critical
    sections); slot STATE still crosses threads via each slot's own
    lock (the in-flight count) and single-writer flags.
    """

    GUARDED_BY = {"_journal": "_journal_lock", "_slots": "_slots_lock",
                  "_next_index": "_slots_lock"}

    def __init__(self, make_argv, n_replicas: int, *,
                 policy: Optional[RetryPolicy] = None,
                 journal: "RunJournal | str | None" = None,
                 registry: Optional[Registry] = None,
                 probe_interval_s: float = 0.25,
                 probe_timeout_s: float = 2.0,
                 unhealthy_after: int = 2,
                 recycle_after: int = 8,
                 startup_timeout_s: float = 60.0,
                 fault_env: Optional[dict] = None,
                 log_dir: Optional[str] = None):
        if n_replicas < 1:
            raise ValueError("a fleet needs at least one replica")
        if recycle_after < unhealthy_after:
            raise ValueError("recycle_after must be >= unhealthy_after "
                             "(out-of-routing is the first rung)")
        self.make_argv = make_argv
        self.policy = policy or RetryPolicy()
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.unhealthy_after = int(unhealthy_after)
        self.recycle_after = int(recycle_after)
        self.startup_timeout_s = float(startup_timeout_s)
        self.fault_env = dict(fault_env or {})
        self.log_dir = log_dir
        self._slots = [ReplicaSlot(i) for i in range(int(n_replicas))]
        self._next_index = int(n_replicas)
        self._slots_lock = threading.Lock()
        self._registry = registry
        self._own_journal = isinstance(journal, (str, os.PathLike))
        self._journal = (RunJournal(os.fspath(journal)) if self._own_journal
                         else journal)
        # the readable journal location (when there is one): the router's
        # merged /trace reads it back as the fleet's annotation track
        self.journal_path = (os.fspath(journal) if self._own_journal
                             else getattr(journal, "path", None))
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._swap_lock = threading.Lock()
        self._journal_lock = threading.Lock()
        self._recoveries: list[threading.Thread] = []

    # ---- plumbing ----------------------------------------------------------
    def _reg(self) -> Registry:
        return (self._registry if self._registry is not None
                else default_registry())

    def _event(self, kind: str, /, **fields) -> None:
        # recovery threads journal concurrently with the monitor — one
        # lock keeps event lines whole (and guards the close in stop())
        with self._journal_lock:
            if self._journal is not None:
                self._journal.event(kind, **fields)

    def journal(self, kind: str, /, **fields) -> None:
        """Public journal passthrough for fleet-level observers that own
        no journal of their own — the router's drift gate records its
        ``drift_breach`` verdicts here, so a model-quality incident
        reads in the same flight recorder as a crash or a swap."""
        self._event(kind, **fields)

    @property
    def slots(self) -> "list[ReplicaSlot]":
        """Point-in-time snapshot of the slot registry.  The list is
        MUTABLE at runtime (the autoscaler adds and retires slots), so
        every iteration — monitor, router, push, teardown — runs over
        its own snapshot; the slot OBJECTS stay shared and carry their
        own synchronization."""
        with self._slots_lock:
            return list(self._slots)

    def gauge_replicas(self) -> None:
        """The fleet census gauge the capacity loop (and operators)
        read: ``dryad_fleet_replicas{state=...}``."""
        reg = self._reg()
        if not reg.enabled:
            return
        slots = self.slots
        fam = reg.gauge("dryad_fleet_replicas",
                        "Fleet slot census by state")
        fam.labels(state="total").set(len(slots))
        fam.labels(state="routable").set(
            sum(1 for s in slots if s.routable))
        fam.labels(state="retiring").set(
            sum(1 for s in slots if s.retiring))
        fam.labels(state="recovering").set(
            sum(1 for s in slots if s.recovering))
        fam.labels(state="fail_closed").set(
            sum(1 for s in slots if s.fail_closed))

    def _gauge_healthy(self, slot: ReplicaSlot) -> None:
        reg = self._reg()
        if reg.enabled:
            reg.gauge("dryad_fleet_replica_healthy",
                      "1 while the replica is in routing").labels(
                replica=slot.name).set(1 if slot.routable else 0)

    def _count(self, name: str, help: str, slot: ReplicaSlot) -> None:
        reg = self._reg()
        if reg.enabled:
            reg.counter(name, help).labels(replica=slot.name).inc()

    # ---- lifecycle ---------------------------------------------------------
    def start(self) -> "FleetSupervisor":
        self._event("fleet_start", replicas=len(self.slots),
                    retry_budget=self.policy.retry_budget,
                    probe_interval_s=self.probe_interval_s)
        for slot in self.slots:
            if not self._spawn(slot, first=True):
                # budget burned before the slot ever served: fail closed
                # and keep bringing up the REST of the fleet
                continue
        if not any(s.routable for s in self.slots):
            self.stop()
            raise ReplicaStartupError("no replica became ready at fleet "
                                      "start (see the journal / logs)")
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True,
                                         name="dryad-fleet-monitor")
        self._monitor.start()
        self.gauge_replicas()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None
        # terminate children FIRST: a recovery thread mid-ready-wait sees
        # its child die, raises, observes _stop, and exits — then the
        # joins below converge instead of waiting out a startup timeout
        for slot in self.slots:
            if slot.proc is not None:
                slot.proc.stop()
            slot.healthy = False
            self._gauge_healthy(slot)
        for t in self._recoveries:
            t.join(timeout=5.0)
        self._recoveries = []
        # one more sweep: a recovery thread may have spawned a replica
        # between the first sweep and its _stop check
        for slot in self.slots:
            if slot.proc is not None:
                slot.proc.stop()
        self._event("fleet_stop",
                    respawns=sum(s.respawns for s in self.slots))
        with self._journal_lock:
            if self._own_journal and self._journal is not None:
                self._journal.close()
                self._journal = None

    def __enter__(self) -> "FleetSupervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- spawn / recover ---------------------------------------------------
    def _spawn_env(self, slot: ReplicaSlot) -> dict:
        """Drill faults arm generation 0 ONLY: a respawned replica is
        clean, so one crash drill proves one death + one recovery instead
        of a crash loop that burns the budget.  The override is ALWAYS
        returned (empty when not arming) because replicas inherit this
        process's environment — a DRYAD_REPLICA_FAULTS set on the fleet
        process itself would otherwise re-arm EVERY generation and turn
        one drill into a budget-exhausting fleet outage; supervisor-owned
        replicas take drills only through ``fault_env``."""
        if slot.generation == 0 and slot.index in self.fault_env:
            return {REPLICA_FAULTS_ENV: self.fault_env[slot.index]}
        return {REPLICA_FAULTS_ENV: ""}

    def _spawn(self, slot: ReplicaSlot, first: bool = False) -> bool:
        """Spawn (or respawn) the slot's process; on startup failure keep
        retrying under the slot's budget.  True when the slot serves."""
        while True:
            if self._stop.is_set():
                # a fleet stop() mid-recovery must not leak a fresh
                # subprocess the teardown loop will never see
                return False
            self._event("replica_spawn", replica=slot.name,
                        generation=slot.generation, first=first)
            proc = ReplicaProcess(
                lambda pf: self.make_argv(slot.index, pf),
                name=f"{slot.name}g{slot.generation}",
                env=self._spawn_env(slot),
                startup_timeout_s=self.startup_timeout_s,
                log_dir=self.log_dir)
            # registered on the slot BEFORE the (long) ready wait: a fleet
            # stop() terminates this child even while it is still paying
            # its torch import — the slot is not routable until healthy
            # flips below, so nothing routes to the half-born process
            slot.proc = proc
            try:
                proc.start()
            except ReplicaStartupError as e:
                self._event("replica_spawn_failed", replica=slot.name,
                            generation=slot.generation,
                            exit_code=e.exit_code, message=str(e)[:300])
                proc.stop()
                if not self._charge_budget(slot):
                    return False
                continue
            if self._stop.is_set():
                proc.stop()
                return False
            # the registration-time clock handshake: map this process
            # generation's perf_counter onto the wall clock so the merged
            # fleet /trace can align its spans (None for replicas that do
            # not speak /clock — stubs)
            slot.clock_offset = proc.clock_offset()
            slot.healthy = True
            slot.consecutive_bad = 0
            slot.last_status = 200
            self._gauge_healthy(slot)
            self._event("replica_ready", replica=slot.name,
                        generation=slot.generation, url=proc.url,
                        clock_offset_s=slot.clock_offset)
            return True

    def _charge_budget(self, slot: ReplicaSlot) -> bool:
        """One respawn attempt against the slot's budget; sleeps the
        backoff.  False (and fail-closed) when the budget is exhausted."""
        slot.respawns += 1
        if slot.respawns > self.policy.retry_budget:
            slot.fail_closed = True
            slot.healthy = False
            self._gauge_healthy(slot)
            self._event("replica_fail_closed", replica=slot.name,
                        reason="retry_budget_exhausted",
                        respawns=slot.respawns - 1)
            return False
        sleep_s = self.policy.backoff_s(slot.respawns - 1)
        self._event("replica_backoff", replica=slot.name,
                    attempt=slot.respawns, sleep_s=sleep_s)
        if sleep_s > 0:
            # interruptible: a fleet stop() must not wait out a backoff
            self._stop.wait(sleep_s)
        slot.generation += 1
        return True

    def _recover(self, slot: ReplicaSlot, reason: str,
                 exit_code: Optional[int] = None) -> None:
        self._count("dryad_fleet_respawn_total",
                    "Replica respawns by the fleet supervisor", slot)
        slot.healthy = False
        self._gauge_healthy(slot)
        if slot.proc is not None:
            slot.proc.stop()
        self._event("replica_respawn", replica=slot.name, reason=reason,
                    exit_code=exit_code, generation=slot.generation)
        if self._charge_budget(slot):
            self._spawn(slot)

    def _recover_async(self, slot: ReplicaSlot, reason: str,
                       exit_code: Optional[int] = None) -> None:
        """Run the (slow: backoff + spawn + ready wait) recovery on its
        own thread so the monitor keeps probing the OTHER slots — a
        second failure during one slot's recovery must still be detected
        and taken out of routing.  ``slot.recovering`` keeps the monitor
        from double-dispatching the same slot."""
        slot.recovering = True

        def run() -> None:
            try:
                self._recover(slot, reason, exit_code=exit_code)
            finally:
                slot.recovering = False

        t = threading.Thread(target=run, daemon=True,
                             name=f"dryad-fleet-recover-{slot.name}")
        self._recoveries.append(t)
        self._recoveries = [x for x in self._recoveries
                            if x.is_alive() or x is t]
        t.start()

    # ---- monitor -----------------------------------------------------------
    @staticmethod
    def _monitor_skips(slot: ReplicaSlot) -> bool:
        """Slots the monitor must leave alone this pass.  ``retiring``
        is load-bearing: a scale-down drains the slot and then
        KILLS its process — without the guard the monitor would read
        that planned death as a crash and respawn the replica the
        capacity decision just removed."""
        return (slot.fail_closed or slot.recovering or slot.retiring
                or slot.proc is None)

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            for slot in self.slots:
                if self._monitor_skips(slot):
                    continue
                if self._stop.is_set():
                    return
                code = slot.proc.poll()
                if code is not None:
                    self._count("dryad_fleet_crash_total",
                                "Replica processes found dead", slot)
                    self._event("replica_crash", replica=slot.name,
                                exit_code=code, generation=slot.generation)
                    self._recover_async(slot, "crash", exit_code=code)
                    continue
                status, _latency = slot.proc.health(
                    timeout_s=self.probe_timeout_s)
                slot.last_status = status
                if status == 200:
                    if not slot.healthy:
                        self._event("replica_recovered", replica=slot.name,
                                    generation=slot.generation)
                    slot.healthy = True
                    slot.consecutive_bad = 0
                    self._gauge_healthy(slot)
                    continue
                # alive but sick: probe timeout/refused (None) or a 503
                slot.consecutive_bad += 1
                if (slot.consecutive_bad == self.unhealthy_after
                        and slot.healthy):
                    slot.healthy = False
                    self._gauge_healthy(slot)
                    self._event("replica_unhealthy", replica=slot.name,
                                status=status,
                                consecutive=slot.consecutive_bad)
                if slot.consecutive_bad >= self.recycle_after:
                    self._count("dryad_fleet_recycle_total",
                                "Hung/stuck replicas killed and respawned",
                                slot)
                    self._event("replica_hang", replica=slot.name,
                                status=status,
                                consecutive=slot.consecutive_bad)
                    slot.consecutive_bad = 0
                    self._recover_async(slot, "hang")

    # ---- elastic capacity --------------------------------------------------
    def add_slot(self) -> Optional[ReplicaSlot]:
        """Grow the fleet by one slot: register it, spawn its replica,
        wait for readiness (the same ``_spawn`` budgeted path a respawn
        takes).  The slot joins the registry BEFORE the long ready wait
        so a concurrent ``stop()`` terminates the half-born child in its
        normal sweep; ``recovering`` keeps the monitor off it until it
        serves.  Returns the routable slot, or None (spawn failed under
        budget, or the fleet is stopping — either way the registry is
        left without the dead slot)."""
        if self._stop.is_set():
            return None
        with self._slots_lock:
            slot = ReplicaSlot(self._next_index)
            self._next_index += 1
            slot.recovering = True
            self._slots.append(slot)
        try:
            ok = self._spawn(slot, first=True)
        finally:
            slot.recovering = False
        if not ok:
            with self._slots_lock:
                if slot in self._slots:
                    self._slots.remove(slot)
            self.gauge_replicas()
            return None
        self.gauge_replicas()
        return slot

    def retire_slot(self, name: str, *,
                    drain_timeout_s: float = 30.0) -> bool:
        """Shrink the fleet by one slot through the rolling push's
        zero-drop discipline: mark it non-routable (``retiring``), wait
        for its in-flight count to reach zero (requests already on the
        slot finish normally), then reap the process and drop the slot
        from the registry.  A drain that cannot reach zero within
        ``drain_timeout_s`` ABORTS the retire (the slot returns to
        routing) rather than dropping work.  The wait holds NO lock —
        ``retiring`` is a single-writer flag and the router re-checks
        ``routable`` after its in-flight mark, the same window-closing
        discipline ``draining`` rides."""
        slot = next((s for s in self.slots if s.name == name), None)
        if slot is None or slot.retiring:
            return False
        self._event("replica_retire", replica=slot.name,
                    inflight=slot.inflight)
        slot.retiring = True
        self._gauge_healthy(slot)
        deadline = time.monotonic() + float(drain_timeout_s)
        while slot.inflight > 0:
            if self._stop.is_set() or time.monotonic() > deadline:
                slot.retiring = False
                self._gauge_healthy(slot)
                self._event("replica_retire_aborted", replica=slot.name,
                            inflight=slot.inflight,
                            stopping=self._stop.is_set())
                return False
            time.sleep(0.002)
        if slot.proc is not None:
            slot.proc.stop()
        slot.healthy = False
        with self._slots_lock:
            if slot in self._slots:
                self._slots.remove(slot)
        self._gauge_healthy(slot)
        self._event("replica_retired", replica=slot.name,
                    generation=slot.generation, respawns=slot.respawns)
        self.gauge_replicas()
        return True

    # ---- routing / observability views -------------------------------------
    def routable_slots(self) -> list[ReplicaSlot]:
        return [s for s in self.slots if s.routable]

    def fleet_ok(self, min_healthy: int = 1) -> bool:
        return len(self.routable_slots()) >= int(min_healthy)

    def states(self) -> dict:
        return {s.name: s.state() for s in self.slots}

    # ---- rolling model push -------------------------------------------------
    def rolling_push(self, path: str, *, name: Optional[str] = None,
                     activate: bool = True,
                     drain_timeout_s: float = 30.0,
                     load_timeout_s: float = 120.0,
                     auth_token: Optional[str] = None) -> dict:
        """Push ``path`` replica by replica with a version-pinned drain.

        Per replica: stop routing to it (``draining``), wait for its
        in-flight count to reach zero (those requests complete at the
        version they resolved at submit — serve pins versions, so a swap
        can never change a queued request), POST ``/models/load`` through
        the replica's own registry (hot-swap + rollback stay available
        per process), wait for health, restore routing.  Replicas swap
        ONE at a time, so the rest of the pool serves throughout.

        Returns ``{"versions": {replica: version}, "errors": {replica:
        reason}, "skipped": [replica, ...]}``; a drain timeout or load
        failure aborts THAT replica's swap (it keeps serving the old
        model) and the push continues — zero in-flight requests are
        dropped in every outcome.
        """
        with self._swap_lock:
            versions: dict = {}
            errors: dict = {}
            skipped: list = []
            self._event("push_start", path=path, name=name,
                        activate=bool(activate))
            for slot in self.slots:
                if not slot.routable:
                    skipped.append(slot.name)
                    continue
                self._event("replica_drain", replica=slot.name,
                            inflight=slot.inflight)
                slot.draining = True
                self._gauge_healthy(slot)
                try:
                    deadline = time.monotonic() + float(drain_timeout_s)
                    while slot.inflight > 0:
                        if time.monotonic() > deadline:
                            raise TimeoutError(
                                f"drain timed out with {slot.inflight} "
                                "in flight")
                        # dryadlint: disable=no-blocking-under-lock -- the swap mutex has a sole acquirer; the drain wait under it IS the zero-drop design
                        time.sleep(0.002)
                    version = slot.proc.load_model(
                        path, name=name, activate=activate,
                        auth_token=auth_token, timeout_s=load_timeout_s)
                    status, _ = slot.proc.health(
                        timeout_s=self.probe_timeout_s)
                    if status != 200:
                        raise RuntimeError(
                            f"post-swap health probe answered {status}")
                    versions[slot.name] = version
                    self._event("replica_swapped", replica=slot.name,
                                version=version)
                except Exception as e:  # noqa: BLE001 — per-replica verdict
                    errors[slot.name] = repr(e)
                    self._event("replica_swap_failed", replica=slot.name,
                                message=str(e)[:300])
                finally:
                    slot.draining = False
                    self._gauge_healthy(slot)
            reg = self._reg()
            if reg.enabled:
                reg.counter("dryad_fleet_push_total",
                            "Rolling model pushes").inc()
            self._event("push_complete", swapped=sorted(versions),
                        errors=sorted(errors), skipped=skipped)
            return {"versions": versions, "errors": errors,
                    "skipped": skipped}
