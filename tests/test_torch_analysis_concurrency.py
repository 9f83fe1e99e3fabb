"""The port's concurrency contract auditor (dryad_tpu_torch/analysis,
layer 3): the counterparts of tests/test_analysis_concurrency.py.

Static half: the guarded-by / no-blocking-under-lock / lock-order rules
follow the dryadlint mutation discipline: (a) clean on the shipped tree,
(b) FAIL on a seeded violation of their own class, (c) waivers and
goldens behave.  Dynamic half: the schedule harness is seed-
deterministic, its drills pass on the shipped tree, and each drill
DETECTS its recorded race when the shipped fix is mechanically reverted
(the batcher stop/start generation race, the injector's non-atomic
check-and-clear, recovery blocking the monitor, a torn lock-free
registry snapshot, a torn drift export, the unlocked scheduler and
capacity admits, a wedged prefetch producer).  CLI: concurrency
violations exit 6 (distinct from lint's 2), and the waiver-count ratchet
fails when waivers outgrow the committed budget.
"""

from __future__ import annotations

import json
import textwrap

import pytest
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

from dryad_tpu_torch.analysis.concurrency import LOCK_ORDER_GOLDENS, RULE_NAMES
from dryad_tpu_torch.analysis.lint import SourceTree, run_lint
from dryad_tpu_torch.analysis.schedules import (DRILLS, DeadlockError,
                                          LockOrderError, run_schedule,
                                          run_schedules)

ROOT = __file__.rsplit("/tests/", 1)[0]
PKG = "dryad_tpu_torch"


def _violations(rule, overrides=None):
    return run_lint(ROOT, rule_names=[rule], overrides=overrides)


def _rule_hits(report, rule):
    return [v for v in report.violations if v.rule == rule]


# ---------------------------------------------------------------------------
# the shipped tree is clean under the concurrency rules


def test_shipped_tree_clean_concurrency_rules():
    report = run_lint(ROOT, rule_names=list(RULE_NAMES))
    assert not report.violations, "\n".join(
        v.format() for v in report.violations)
    # the documented lock-free fast paths are waived, not invisible
    assert any(w.rule == "guarded-by" for _, w in report.waived)
    assert any(w.rule == "no-blocking-under-lock" for _, w in report.waived)


# ---------------------------------------------------------------------------
# guarded-by


def test_guarded_by_seeded_unguarded_access():
    src = SourceTree(ROOT).read(f"{PKG}/serve/batcher.py")
    bad = src + textwrap.dedent("""

        class _Sneaky:
            GUARDED_BY = {"_x": "_lock"}

            def __init__(self):
                self._lock = threading.Lock()
                self._x = 0

            def bump(self):
                self._x += 1
    """)
    rep = _violations("guarded-by", {f"{PKG}/serve/batcher.py": bad})
    hits = _rule_hits(rep, "guarded-by")
    assert hits and any("self._x" in v.message for v in hits)


def test_guarded_by_missing_declaration_on_lock_owner():
    src = SourceTree(ROOT).read(f"{PKG}/obs/health.py")
    bad = src + textwrap.dedent("""

        class _Bare:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0
    """)
    rep = _violations("guarded-by", {f"{PKG}/obs/health.py": bad})
    assert any("declares no GUARDED_BY" in v.message
               for v in _rule_hits(rep, "guarded-by"))


_COMMENT_FORM = textwrap.dedent("""
    import threading


    class Counted:
        def __init__(self):
            self._n = 0   # guarded-by: _lock
            self._lock = threading.Lock()

        def bump(self):
            BODY
""")


def test_guarded_by_comment_form_detects_and_passes():
    bad = _COMMENT_FORM.replace("BODY", "self._n += 1")
    rep = _violations("guarded-by", {f"{PKG}/obs/_fixture_gb.py": bad})
    assert _rule_hits(rep, "guarded-by")
    ok = _COMMENT_FORM.replace(
        "BODY", "with self._lock:\n            self._n += 1")
    rep = _violations("guarded-by", {f"{PKG}/obs/_fixture_gb.py": ok})
    assert not _rule_hits(rep, "guarded-by")


_LOCKED_HELPER = textwrap.dedent("""
    import threading


    class Cache:
        GUARDED_BY = {"_d": "_lock"}

        def __init__(self):
            self._lock = threading.Lock()
            self._d = {}

        def _insert_locked(self, k, v):
            self._d[k] = v

        def put(self, k, v):
            BODY
""")


def test_guarded_by_locked_suffix_idiom():
    # the helper body is exempt; the CALL must hold the lock
    bad = _LOCKED_HELPER.replace("BODY", "self._insert_locked(k, v)")
    rep = _violations("guarded-by", {f"{PKG}/serve/_fixture_gb.py": bad})
    assert any("_locked" in v.message
               for v in _rule_hits(rep, "guarded-by"))
    ok = _LOCKED_HELPER.replace(
        "BODY", "with self._lock:\n            self._insert_locked(k, v)")
    rep = _violations("guarded-by", {f"{PKG}/serve/_fixture_gb.py": ok})
    assert not _rule_hits(rep, "guarded-by")


def test_guarded_by_declaration_must_name_a_real_lock():
    src = textwrap.dedent("""
        import threading


        class Typo:
            GUARDED_BY = {"_x": "_lokc"}

            def __init__(self):
                self._lock = threading.Lock()
                self._x = 0
    """)
    rep = _violations("guarded-by", {f"{PKG}/obs/_fixture_gb.py": src})
    assert any("_lokc" in v.message for v in _rule_hits(rep, "guarded-by"))


# ---------------------------------------------------------------------------
# no-blocking-under-lock


def test_no_blocking_seeded_sleep_under_lock():
    src = SourceTree(ROOT).read(f"{PKG}/obs/watchdog.py")
    bad = src + ("\n\ndef _stall(lock):\n"
                 "    with lock:\n"
                 "        time.sleep(1.0)\n")
    rep = _violations("no-blocking-under-lock",
                      {f"{PKG}/obs/watchdog.py": bad})
    assert _rule_hits(rep, "no-blocking-under-lock")


def test_no_blocking_thread_join_flagged_str_join_clean():
    tmpl = ("import threading\n"
            "def f(lock, t, parts):\n"
            "    with lock:\n"
            "        {stmt}\n")
    rep = _violations("no-blocking-under-lock", {
        f"{PKG}/fleet/_fixture_nb.py": tmpl.format(
            stmt="t.join(timeout=5.0)")})
    assert _rule_hits(rep, "no-blocking-under-lock")
    rep = _violations("no-blocking-under-lock", {
        f"{PKG}/fleet/_fixture_nb.py": tmpl.format(
            stmt="out = ','.join(parts)")})
    assert not _rule_hits(rep, "no-blocking-under-lock")


def test_no_blocking_queue_get_flagged_dict_get_clean():
    tmpl = ("def f(lock, q, d, k):\n"
            "    with lock:\n"
            "        {stmt}\n")
    rep = _violations("no-blocking-under-lock", {
        f"{PKG}/serve/_fixture_nb.py": tmpl.format(stmt="x = q.get()")})
    assert _rule_hits(rep, "no-blocking-under-lock")
    rep = _violations("no-blocking-under-lock", {
        f"{PKG}/serve/_fixture_nb.py": tmpl.format(stmt="x = d.get(k)")})
    assert not _rule_hits(rep, "no-blocking-under-lock")


def test_no_blocking_user_callback_under_lock():
    src = textwrap.dedent("""
        import threading


        class Notifier:
            GUARDED_BY = {"_subs": "_lock"}

            def __init__(self, on_change):
                self._lock = threading.Lock()
                self._subs = []
                self.on_change = on_change

            def add(self, s):
                with self._lock:
                    self._subs.append(s)
                    self.on_change(s)
    """)
    rep = _violations("no-blocking-under-lock",
                      {f"{PKG}/obs/_fixture_cb.py": src})
    assert any("constructor-injected user callback" in v.message
               for v in _rule_hits(rep, "no-blocking-under-lock"))


def test_no_blocking_injector_action_moved_under_lock_is_caught():
    # the fix keeps fault ACTIONS outside the injector lock; pulling
    # the stall sleep back inside must trip the rule
    src = SourceTree(ROOT).read(f"{PKG}/resilience/faults.py")
    bad = src + ("\n\ndef _regressed(self, pt):\n"
                 "    with self._lock:\n"
                 "        import time\n"
                 "        time.sleep(pt.stall_s)\n")
    rep = _violations("no-blocking-under-lock",
                      {f"{PKG}/resilience/faults.py": bad})
    assert _rule_hits(rep, "no-blocking-under-lock")


# ---------------------------------------------------------------------------
# lock-order


def test_lock_order_inversion_seeded_in_supervisor():
    src = SourceTree(ROOT).read(f"{PKG}/fleet/supervisor.py")
    anchor = "    # ---- plumbing"
    assert anchor in src
    method = ("    def _sneaky(self):\n"
              "        with self._journal_lock:\n"
              "            with self._swap_lock:\n"
              "                pass\n\n")
    bad = src.replace(anchor, method + anchor, 1)
    rep = _violations("lock-order", {f"{PKG}/fleet/supervisor.py": bad})
    assert any("INVERTS" in v.message for v in _rule_hits(rep, "lock-order"))


_TWO_LOCKS = textwrap.dedent("""
    import threading


    class Pair:
        GUARDED_BY = {"_a": "_la", "_b": "_lb"}

        def __init__(self):
            self._la = threading.Lock()
            self._lb = threading.Lock()
            self._a = 0
            self._b = 0

        def both(self):
            with self._la:
                with self._lb:
                    self._a = self._b
""")


def test_lock_order_new_edge_needs_goldens_commit():
    rep = _violations("lock-order",
                      {f"{PKG}/obs/_fixture_lo.py": _TWO_LOCKS})
    hits = _rule_hits(rep, "lock-order")
    assert hits and any("not in the committed partial order" in v.message
                        for v in hits)
    shipped = json.loads(SourceTree(ROOT).read(LOCK_ORDER_GOLDENS))
    committed = json.dumps(
        {"edges": shipped["edges"] + [["Pair._la", "Pair._lb"]]})
    rep = _violations("lock-order", {
        f"{PKG}/obs/_fixture_lo.py": _TWO_LOCKS,
        LOCK_ORDER_GOLDENS: committed,
    })
    assert not _rule_hits(rep, "lock-order")


def test_lock_order_transitive_through_self_call():
    src = textwrap.dedent("""
        import threading


        class Chain:
            GUARDED_BY = {"_x": "_la"}

            def __init__(self):
                self._la = threading.Lock()
                self._lb = threading.Lock()
                self._x = 0

            def _inner(self):
                with self._lb:
                    pass

            def outer(self):
                with self._la:
                    self._inner()
    """)
    rep = _violations("lock-order", {f"{PKG}/serve/_fixture_lo.py": src})
    hits = _rule_hits(rep, "lock-order")
    assert hits and any("Chain._la" in v.message and "Chain._lb" in v.message
                        for v in hits)


def test_lock_order_self_deadlock_direct_and_via_call():
    direct = textwrap.dedent("""
        import threading


        class Re:
            GUARDED_BY = {"_x": "_l"}

            def __init__(self):
                self._l = threading.Lock()
                self._x = 0

            def f(self):
                with self._l:
                    with self._l:
                        pass
    """)
    rep = _violations("lock-order", {f"{PKG}/obs/_fixture_sd.py": direct})
    assert any("re-acquires" in v.message.lower()
               for v in _rule_hits(rep, "lock-order"))
    via_call = textwrap.dedent("""
        import threading


        class Re:
            GUARDED_BY = {"_x": "_l"}

            def __init__(self):
                self._l = threading.Lock()
                self._x = 0

            def g(self):
                with self._l:
                    pass

            def f(self):
                with self._l:
                    self.g()
    """)
    rep = _violations("lock-order",
                      {f"{PKG}/obs/_fixture_sd.py": via_call})
    assert any("self-deadlock" in v.message
               for v in _rule_hits(rep, "lock-order"))


def test_lock_order_committed_cycle_rejected():
    cyclic = json.dumps({"edges": [["A._l1", "B._l2"], ["B._l2", "A._l1"]]})
    rep = _violations("lock-order", {LOCK_ORDER_GOLDENS: cyclic})
    assert any("CYCLIC" in v.message for v in _rule_hits(rep, "lock-order"))


# ---------------------------------------------------------------------------
# the schedule harness: shipped drills pass, same seed == same schedule


def test_drills_shipped_tree_pass_first_seeds():
    for name, (drill, _n, p, tf) in sorted(DRILLS.items()):
        run_schedules(drill, range(3), preempt_p=p, trace_files=tf)


def test_schedule_harness_is_seed_deterministic():
    for name in ("batcher-stop-start", "registry-snapshot"):
        drill, _n, p, tf = DRILLS[name]
        a = run_schedule(drill, 7, preempt_p=p, trace_files=tf)
        b = run_schedule(drill, 7, preempt_p=p, trace_files=tf)
        assert a.steps == b.steps, name
        assert sorted(a.lock_edges) == sorted(b.lock_edges), name
    # different seeds explore different interleavings (not a fixed path)
    drill, _n, p, tf = DRILLS["batcher-stop-start"]
    steps = {run_schedule(drill, s, preempt_p=p, trace_files=tf).steps
             for s in range(6)}
    assert len(steps) > 1, "every seed produced the identical schedule"


def test_supervisor_drill_records_runtime_lock_edges():
    drill, _n, p, tf = DRILLS["rolling-push-vs-death"]
    s = run_schedule(drill, 0, preempt_p=p, trace_files=tf)
    edges = sorted(s.lock_edges)
    assert any("supervisor.py" in a and "supervisor.py" in b
               for a, b in edges), edges


def test_abba_deadlock_gets_a_verdict_with_stacks():
    import threading

    def drill_abba(sched):
        la, lb = threading.Lock(), threading.Lock()

        def t1():
            with la:
                sched.pause()
                with lb:
                    pass

        def t2():
            with lb:
                sched.pause()
                with la:
                    pass

        sched.spawn(t1, "t1")
        sched.spawn(t2, "t2")
        return None

    hits = 0
    msgs = []
    for seed in range(12):
        try:
            run_schedule(drill_abba, seed)
        except (DeadlockError, LockOrderError) as e:
            hits += 1
            msgs.append(str(e))
    assert hits > 0, "no schedule produced the ABBA deadlock verdict"
    # the verdict carries the two halves: lock names and stacks
    assert any("Lock@" in m for m in msgs)


# ---------------------------------------------------------------------------
# mutation checks: each drill detects its recorded race when the shipped
# fix is mechanically reverted


def _first_failing_seed(drill_name, max_seeds, extra_trace=()):
    """First seed whose schedule detects the seeded race (invariant
    assertion, deadlock verdict, or budget blowup), else None."""
    drill, _n, p, tf = DRILLS[drill_name]
    for seed in range(max_seeds):
        try:
            run_schedule(drill, seed, preempt_p=p,
                         trace_files=tuple(tf) + tuple(extra_trace))
        except (AssertionError, RuntimeError):
            return seed
    return None


def test_harness_reproduces_batcher_stop_race(monkeypatch):
    from dryad_tpu_torch.serve.batcher import MicroBatcher

    monkeypatch.setattr(MicroBatcher, "_stop_live",
                        lambda self, token: True)
    seed = _first_failing_seed("batcher-stop-start", 200)
    assert seed is not None and seed < 200, \
        "the reverted generation race was not reproduced in <200 schedules"


def test_harness_detects_torn_lock_free_snapshot(monkeypatch):
    from dryad_tpu_torch.obs import registry as regmod

    def lockfree_value(self):
        fam = self._fam
        if fam.kind == regmod.LOG_HISTOGRAM:
            state = fam.values.get(self._key) or regmod.new_hist_state()
            return (list(state[0]), state[1], state[2])
        return fam.values.get(self._key, 0.0)

    monkeypatch.setattr(regmod._Series, "value", lockfree_value)
    seed = _first_failing_seed("registry-snapshot", 60)
    assert seed is not None, \
        "a lock-free snapshot reader never produced a torn histogram"


def test_harness_detects_torn_drift_export(monkeypatch):
    """a drift /obs export that reads the rotating window WITHOUT
    the monitor lock tears against concurrent observes/rotation — the
    drift-window-tear drill's counts-vs-rows invariant must catch it."""
    import contextlib

    from dryad_tpu_torch.obs import drift as dmod

    real = dmod.DriftMonitor.export_state
    null = contextlib.nullcontext()

    def lockfree_export(self):
        lock, self._lock = self._lock, null
        try:
            return real(self)
        finally:
            self._lock = lock

    monkeypatch.setattr(dmod.DriftMonitor, "export_state", lockfree_export)
    seed = _first_failing_seed("drift-window-tear", 60)
    assert seed is not None, \
        "a lock-free drift export never produced a torn window block"


def test_harness_detects_nonatomic_injector_fire(monkeypatch):
    from dryad_tpu_torch.resilience import faults as fmod

    def racy_call(self, site, iteration):
        # the unfixed shape: check-then-clear with no lock
        for i, pt in enumerate(self.points):
            if (self._armed[i] and site == pt.site
                    and iteration >= pt.iteration):
                if not pt.sticky:
                    self._armed[i] = False
                self.fired.append({"point": i, "site": site,
                                   "iteration": int(iteration),
                                   "kind": pt.kind})
                raise fmod.InjectedReject("injected")

    monkeypatch.setattr(fmod.FaultInjector, "__call__", racy_call)
    seed = _first_failing_seed("injector-concurrent-fire", 100,
                               extra_trace=(
                                   "test_torch_analysis_concurrency.py",))
    assert seed is not None, \
        "the non-atomic check-and-clear never double-fired"


def test_harness_detects_unlocked_scheduler_admit(monkeypatch):
    """the retrain debounce's checks and its in-flight mark must be
    ONE critical section — the mechanically reverted unlocked version
    lets two concurrent breach deliveries both pass the checks before
    either marks, double-launching the retrain; the
    scheduler-breach-vs-push drill's exactly-once invariant catches it."""
    from dryad_tpu_torch.continual import scheduler as cmod

    def racy_admit(self, model):
        # the unlocked-streak shape: check, then mark, no critical section
        now = cmod.time.monotonic()
        if model in self._inflight:
            return False, "in_flight", 0, 0
        if len(self._inflight) >= self.max_concurrent:
            return False, "budget", 0, 0
        if now < self._cooldown_until.get(model, 0.0):
            return False, "cooldown", 0, 0
        if self._fails.get(model, 0) > self.policy.retry_budget:
            return False, "retry_budget_exhausted", 0, 0
        self._inflight.add(model)
        gen = self._generation.get(model, 0) + 1
        job = self._jobs
        self._jobs += 1
        return True, "", gen, job

    monkeypatch.setattr(cmod.RetrainScheduler, "_admit", racy_admit)
    seed = _first_failing_seed("scheduler-breach-vs-push", 100,
                               extra_trace=(
                                   "test_torch_analysis_concurrency.py",))
    assert seed is not None, \
        "the unlocked debounce never double-launched a retrain"


def test_harness_detects_unlocked_capacity_admit(monkeypatch):
    """the capacity decision's streak/bound/cooldown checks and its
    in-flight mark must be ONE critical section — the mechanically
    reverted unlocked version lets two concurrent pokes both pass the
    checks before either marks, double-spawning a replica past the
    declared bounds; the capacity-vs-breach-vs-push drill's exactly-one
    invariant catches it."""
    from dryad_tpu_torch.fleet import autoscale as amod

    def racy_admit(self, pressure, headroom, census):
        # the unlocked shape: check, then mark, no critical section
        now = amod.time.monotonic()
        if pressure:
            self._down_streak = 0
            self._up_streak += 1
            direction, streak, sustain_n = ("up", self._up_streak,
                                            self.breach_after)
            bound_hit = census >= self.max_replicas
        elif headroom:
            self._up_streak = 0
            self._down_streak += 1
            direction, streak, sustain_n = ("down", self._down_streak,
                                            self.idle_after)
            bound_hit = census <= self.min_replicas
        else:
            self._up_streak = 0
            self._down_streak = 0
            self._last_skip = {"up": None, "down": None}
            return None, None, None, False
        if self._action is not None:
            reason = amod.SKIP_IN_FLIGHT
        elif bound_hit:
            reason = amod.SKIP_AT_BOUND
        elif streak < sustain_n:
            reason = amod.SKIP_SUSTAIN
        elif now < self._cooldown_until[direction]:
            reason = amod.SKIP_COOLDOWN
        else:
            self._action = direction
            if direction == "up":
                self._up_streak = 0
            else:
                self._down_streak = 0
            self._last_skip[direction] = None
            return ("scale_up" if direction == "up" else "scale_down",
                    direction, None, False)
        journal_skip = reason != self._last_skip[direction]
        self._last_skip[direction] = reason
        return None, direction, reason, journal_skip

    monkeypatch.setattr(amod.CapacityController, "_admit", racy_admit)
    seed = _first_failing_seed("capacity-vs-breach-vs-push", 100,
                               extra_trace=(
                                   "test_torch_analysis_concurrency.py",))
    assert seed is not None, \
        "the unlocked capacity debounce never double-launched a scale-up"


def test_harness_detects_wedged_prefetch_producer(monkeypatch):
    """ChunkPrefetcher's producer must put through the cancellable
    timeout loop — mechanically reverting it to a plain blocking put lets
    a mid-stream close() strand the producer (the post-drain sentinel put
    wedges forever on the refilled queue); the stream-prefetch drill's
    thread-reaped assertion catches it."""
    from dryad_tpu_torch.data import stream_dataset as smod

    def blocking_put(self, item):
        self._q.put(item)   # the pre-fix shape: no cancellation window
        return True

    monkeypatch.setattr(smod.ChunkPrefetcher, "_put",
                        blocking_put)
    seed = _first_failing_seed("stream-prefetch", 60)
    assert seed is not None, \
        "a non-cancellable producer put never wedged past close()"


def test_harness_detects_recovery_blocking_the_monitor(monkeypatch):
    from dryad_tpu_torch.fleet import supervisor as smod

    def sync_recover(self, slot, reason, exit_code=None):
        slot.recovering = True
        try:
            self._recover(slot, reason, exit_code=exit_code)
        finally:
            slot.recovering = False

    monkeypatch.setattr(smod.FleetSupervisor, "_recover_async", sync_recover)
    drill, _n, p, tf = DRILLS["supervisor-recovery"]
    with pytest.raises(Exception) as ei:
        run_schedules(drill, range(3), preempt_p=p, trace_files=tf)
    assert "slot 1 respawned" in str(ei.value) or "deadlock" in \
        str(ei.value).lower()


# ---------------------------------------------------------------------------
# CLI: exit code 6 + the waiver ratchet


def test_cli_concurrency_lint_violation_exits_6(tmp_path):
    pkg = tmp_path / "dryad_tpu_torch" / "obs"
    pkg.mkdir(parents=True)
    (pkg / "bad.py").write_text(textwrap.dedent("""
        import threading


        class Sneaky:
            GUARDED_BY = {"_x": "_lock"}

            def __init__(self):
                self._lock = threading.Lock()
                self._x = 0

            def bump(self):
                self._x += 1
    """))
    goldens = tmp_path / "dryad_tpu_torch" / "analysis" / "goldens"
    goldens.mkdir(parents=True)
    (goldens / "lock_order.json").write_text('{"edges": []}')
    budget = goldens / "waiver_budget.json"
    budget.write_text('{"waivers": 0}')
    from dryad_tpu_torch.analysis.__main__ import main

    assert main(["--lint", "-q", "--root", str(tmp_path),
                 "--waiver-budget", str(budget)]) == 6


def test_cli_drill_failure_exits_6(monkeypatch):
    from dryad_tpu_torch.analysis.__main__ import main
    from dryad_tpu_torch.serve.batcher import MicroBatcher

    monkeypatch.setattr(MicroBatcher, "_stop_live",
                        lambda self, token: True)
    rc = main(["--concurrency", "-q", "--drill", "batcher-stop-start",
               "--schedules", "2"])
    assert rc == 6


def test_cli_crashed_drill_exits_5(monkeypatch):
    """A drill that crashes (not a verdict) is an internal error."""
    from dryad_tpu_torch.analysis import schedules
    from dryad_tpu_torch.analysis.__main__ import main

    def drill_crash(sched):
        raise TypeError("drill crashed")

    monkeypatch.setitem(schedules.DRILLS, "batcher-stop-start",
                        (drill_crash, 1, 0.0, ()))
    assert main(["--concurrency", "-q", "--drill", "batcher-stop-start",
                 "--schedules", "1"]) == 5


def test_cli_shipped_concurrency_layer_passes():
    from dryad_tpu_torch.analysis.__main__ import main

    assert main(["--concurrency", "-q", "--schedules", "2"]) == 0


def test_cli_waiver_ratchet_fails_over_budget(tmp_path):
    budget = tmp_path / "waiver_budget.json"
    budget.write_text('{"waivers": 0}')
    from dryad_tpu_torch.analysis.__main__ import main

    # the shipped tree carries its documented waivers; budget 0 must fail
    assert main(["--lint", "-q", "--waiver-budget", str(budget)]) == 2


def test_waiver_budget_matches_shipped_tree_exactly():
    report = run_lint(ROOT)
    with open(f"{ROOT}/{PKG}/analysis/goldens/waiver_budget.json") as f:
        budget = json.load(f)["waivers"]
    assert len(report.waived) <= budget
    assert budget <= len(report.waived) + 2, (
        f"budget {budget} has slack over the real count "
        f"{len(report.waived)} — ratchet it down")


# ---------------------------------------------------------------------------
# docs cannot drift: every registered rule is in both catalogs


def test_rule_catalog_in_readme():
    """Every registered rule is in the README's port section (the
    reference's other catalog file is the reference's own)."""
    from dryad_tpu_torch.analysis.lint import registry

    readme = SourceTree(ROOT).read("README.md")
    section = readme[readme.index("python -m dryad_tpu_torch.analysis"):]
    missing = {n for n in registry() if n not in section}
    assert not missing, f"README is missing rule(s): {sorted(missing)}"
    assert "GUARDED_BY" in section and "exit" in section.lower()


def test_cli_unknown_drill_is_an_internal_error():
    """A typo'd --drill must fail loudly (5), never pass by running zero
    drills."""
    from dryad_tpu_torch.analysis.__main__ import main

    assert main(["--concurrency", "-q", "--drill", "no-such-drill"]) == 5
