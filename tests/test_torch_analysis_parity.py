"""The port's audit engines held against the reference's, on the same
inputs.

``dryad_tpu_torch/analysis``'s lint engine, concurrency rules, import
graph and schedule harness are copies of ``dryad_tpu/analysis``'s, which
use only the standard library.  The other analysis tests hold the port
against verdicts written into them; these hold it against the reference
itself:

* the same fixture sources, written under ``dryad_tpu/...`` for the
  reference and ``dryad_tpu_torch/...`` for the port in one root, give
  equal violations (rule, file, line, message) and equal waiver handling
  under ``guarded-by``, ``no-blocking-under-lock`` and ``lock-order``,
  and so do both packages' shipped threaded files;
* the waiver parser gives equal waivers and errors on the same lines;
* the import graph gives equal chains, and the ``*-jax-free`` rules and
  their ``*-torch-free`` counterparts flag the same lines, on one
  fixture package written with ``jax`` for the reference and ``torch``
  for the port;
* the same toy programs, and the port's ten drills, run under both
  schedule harnesses with the same seeds give identical interleavings,
  step counts, virtual clocks, lock edges and verdicts, and a reverted
  fix is caught at the same first seed by both.

The op census has no counterpart to hold it against (the reference
traces jaxprs); its own tests check its invariants.
"""

from __future__ import annotations

import json
import os
import queue
import re
import textwrap
import threading
import time

import pytest
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

from dryad_tpu.analysis import concurrency as ref_conc
from dryad_tpu.analysis import importgraph as ref_ig
from dryad_tpu.analysis import lint as ref_lint
from dryad_tpu.analysis import rules as ref_rules  # noqa: F401 (registers)
from dryad_tpu.analysis import schedules as ref_sched
from dryad_tpu_torch.analysis import concurrency as port_conc
from dryad_tpu_torch.analysis import importgraph as port_ig
from dryad_tpu_torch.analysis import lint as port_lint
from dryad_tpu_torch.analysis import schedules as port_sched

ROOT = __file__.rsplit("/tests/", 1)[0]
REF, PORT = "dryad_tpu", "dryad_tpu_torch"
CONC_RULES = list(port_conc.RULE_NAMES)
THIS_FILE = os.path.basename(__file__)


def _strip(path: str, pkg: str) -> str:
    return path[len(pkg) + 1:] if path.startswith(pkg + "/") else path


def _text(s: str, pkg: str) -> str:
    """A message with the package's own name taken out."""
    return re.sub(rf"\b{pkg}\b", "<pkg>", s)


def _key(rep, pkg: str) -> dict:
    return {
        "violations": sorted((v.rule, _strip(v.path, pkg), v.line,
                              _text(v.message, pkg))
                             for v in rep.violations),
        "waived": sorted((v.rule, _strip(v.path, pkg), v.line, w.rule,
                          w.line, w.reason) for v, w in rep.waived),
        "errors": sorted(_text(e, pkg) for e in rep.errors),
    }


def _lint_both(tmp_path, rules, files: dict, goldens=None) -> tuple:
    """(reference key, port key) of ``rules`` over ``files`` (package-
    relative path -> source; ``{pkg}`` in a source names the package)
    written under each package in one empty root."""
    ov_ref = {f"{REF}/{p}": s.replace("{pkg}", REF)
              for p, s in files.items()}
    ov_port = {f"{PORT}/{p}": s.replace("{pkg}", PORT)
               for p, s in files.items()}
    if goldens is not None:
        ov_ref[ref_conc.LOCK_ORDER_GOLDENS] = goldens
        ov_port[port_conc.LOCK_ORDER_GOLDENS] = goldens
    ref = ref_lint.run_lint(str(tmp_path), rule_names=rules,
                            overrides=ov_ref)
    port = port_lint.run_lint(str(tmp_path), rule_names=rules,
                              overrides=ov_port)
    return _key(ref, REF), _key(port, PORT)


# ---------------------------------------------------------------------------
# the concurrency rules on the same fixtures

_HEAD = "import threading\nimport time\nimport queue\n\n\n"

_CONC_FIXTURES = {
    "unguarded_access": """
        class Sneaky:
            GUARDED_BY = {"_x": "_lock"}

            def __init__(self):
                self._lock = threading.Lock()
                self._x = 0

            def bump(self):
                self._x += 1

            def read(self):
                with self._lock:
                    return self._x
    """,
    "missing_declaration": """
        class Bare:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0

            def bump(self):
                with self._lock:
                    self._n += 1
    """,
    "comment_form": """
        class Counted:
            def __init__(self):
                self._n = 0   # guarded-by: _lock
                self._m = 0   # guarded-by: _lock
                self._lock = threading.Lock()

            def bump(self):
                self._n += 1
                with self._lock:
                    self._m += 1
    """,
    "locked_suffix": """
        class Cache:
            GUARDED_BY = {"_d": "_lock"}

            def __init__(self):
                self._lock = threading.Lock()
                self._d = {}

            def _insert_locked(self, k, v):
                self._d[k] = v

            def put(self, k, v):
                self._insert_locked(k, v)

            def put_ok(self, k, v):
                with self._lock:
                    self._insert_locked(k, v)
    """,
    "declaration_typo": """
        class Typo:
            GUARDED_BY = {"_x": "_lokc"}

            def __init__(self):
                self._lock = threading.Lock()
                self._x = 0
    """,
    "blocking_calls": """
        def sleeps(lock):
            with lock:
                time.sleep(1.0)

        def joins(lock, t, parts):
            with lock:
                t.join(timeout=5.0)
                out = ','.join(parts)
            return out

        def gets(lock, q, d, k):
            with lock:
                x = q.get()
                y = d.get(k)
            return x, y

        def waits(lock, ev):
            with lock:
                ev.wait(1.0)
    """,
    "user_callback": """
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
    """,
    "two_locks": """
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

            def inverted(self):
                with self._lb:
                    with self._la:
                        self._b = self._a
    """,
    "transitive_self_call": """
        class Chain:
            GUARDED_BY = {"_x": "_la"}

            def __init__(self):
                self._la = threading.Lock()
                self._lb = threading.Lock()
                self._lc = threading.Lock()
                self._x = 0

            def _deepest(self):
                with self._lc:
                    pass

            def _inner(self):
                with self._lb:
                    self._deepest()

            def outer(self):
                with self._la:
                    self._inner()
    """,
    "self_deadlock": """
        class Re:
            GUARDED_BY = {"_x": "_l"}

            def __init__(self):
                self._l = threading.Lock()
                self._r = threading.RLock()
                self._x = 0

            def direct(self):
                with self._l:
                    with self._l:
                        pass

            def g(self):
                with self._l:
                    pass

            def via_call(self):
                with self._l:
                    self.g()

            def reentrant(self):
                with self._r:
                    with self._r:
                        pass
    """,
    "waivers": """
        class Waived:
            GUARDED_BY = {"_x": "_lock", "_y": "_lock"}

            def __init__(self):
                self._lock = threading.Lock()
                self._x = 0
                self._y = 0

            def fast(self):
                return self._x  # dryadlint: disable=guarded-by -- racy read
                # dryadlint: disable=guarded-by -- the line below
            def slow(self):
                return self._y
            def wrong_rule(self):
                return self._y  # dryadlint: disable=lock-order -- not it
            def no_reason(self):
                return self._x  # dryadlint: disable=guarded-by
            def multi(self, lock):
                with self._lock:  # dryadlint: disable=lock-order,no-blocking-under-lock -- two
                    time.sleep(0.1)
    """,
    "file_waiver": """
        # dryadlint: disable-file=no-blocking-under-lock -- drills only
        def sleeps(lock):
            with lock:
                time.sleep(1.0)

        class Sneaky:
            GUARDED_BY = {"_x": "_lock"}

            def __init__(self):
                self._lock = threading.Lock()
                self._x = 0

            def bump(self):
                self._x += 1
    """,
}

_GOLDENS = {
    "empty": {"edges": []},
    "pair": {"edges": [["Pair._la", "Pair._lb"]]},
    "chain": {"edges": [["Chain._la", "Chain._lb"],
                        ["Chain._lb", "Chain._lc"]]},
    "cyclic": {"edges": [["A._l1", "B._l2"], ["B._l2", "A._l1"]]},
}


@pytest.mark.parametrize("goldens", sorted(_GOLDENS))
@pytest.mark.parametrize("fixture", sorted(_CONC_FIXTURES))
def test_concurrency_rules_agree_with_the_reference(tmp_path, fixture,
                                                    goldens):
    src = _HEAD + textwrap.dedent(_CONC_FIXTURES[fixture])
    files = {"serve/_fixture.py": src, "obs/_fixture.py": src,
             "engine/_untargeted.py": src}
    ref, port = _lint_both(tmp_path, CONC_RULES, files,
                           json.dumps(_GOLDENS[goldens]))
    assert port == ref
    if goldens == "empty" and fixture != "declaration_typo":
        # the fixture really exercises the rules
        assert ref["violations"] or ref["waived"] or ref["errors"], fixture


def _package_files(pkg: str, patterns) -> dict:
    tree = ref_lint.SourceTree(ROOT)
    return {_strip(rel, pkg): tree.read(rel) for rel in tree.find(
        [p.replace(PORT, pkg) for p in patterns])}


@pytest.mark.parametrize("source", [REF, PORT])
def test_shipped_threaded_files_agree_with_the_reference(tmp_path, source):
    """Both packages' threaded files, each under both engines with the
    same committed lock order: the same hits and the same waivers."""
    files = _package_files(source, port_conc.TARGETS)
    assert len(files) > 20
    goldens = ref_lint.SourceTree(ROOT).read(
        ref_conc.LOCK_ORDER_GOLDENS if source == REF
        else port_conc.LOCK_ORDER_GOLDENS)
    ref, port = _lint_both(tmp_path, CONC_RULES, files, goldens)
    assert port == ref
    assert ref["waived"], "the shipped waivers were not seen"


# ---------------------------------------------------------------------------
# the waiver parser

_WAIVER_LINES = [
    "x = 1  # dryadlint: disable=guarded-by -- the reason",
    "x = 1  #dryadlint:disable=guarded-by--tight",
    "# dryadlint: disable=a-rule,b_rule -- two rules -- dashes inside",
    "# dryadlint: disable-file=lock-order -- whole file",
    "x = 1  # dryadlint: disable=guarded-by",
    "x = 1  # dryadlint: disable=guarded-by --   ",
    "x = 1  # dryadlint: disable=guarded-by -",
    "x = 1  # dryadlint: disable= -- no rule",
    "x = 1  # dryadlint disable=guarded-by -- no colon",
    "s = '# dryadlint: disable=guarded-by -- in a string'",
    "x = 1  # DRYADLINT: disable=guarded-by -- upper case",
    "x = 1  # dryadlint: disable-file=guarded-by",
]


@pytest.mark.parametrize("i", range(len(_WAIVER_LINES)))
def test_waiver_parser_agrees_with_the_reference(i):
    src = "a = 0\n" + _WAIVER_LINES[i] + "\nb = 2\n"
    out = []
    for mod in (ref_lint, port_lint):
        rep = mod.LintReport()
        lines, filewide = mod.parse_waivers("m.py", src, rep)
        out.append((
            {ln: {r: (w.rule, w.line, w.reason) for r, w in ws.items()}
             for ln, ws in lines.items()},
            {r: (w.rule, w.line, w.reason) for r, w in filewide.items()},
            rep.errors))
    assert out[1] == out[0]


def test_unknown_rule_rejected_by_both(tmp_path):
    for mod in (ref_lint, port_lint):
        with pytest.raises(ValueError, match="unknown rule"):
            mod.run_lint(str(tmp_path), rule_names=["no-such-rule"])


# ---------------------------------------------------------------------------
# the import graph and the *-free rules on one fixture package

_IMPORT_TREE = {
    "obs/__init__.py": "from . import spans\nfrom .registry import Registry\n",
    "obs/spans.py": "import os\n\n\ndef f():\n    import {banned}\n",
    "obs/registry.py": ("from ..engine import helper\n"
                        "import numpy as np\n\n\n"
                        "class Registry:\n    pass\n\n\n"
                        "def g(x):\n    return np.asarray(x)\n"),
    "engine/__init__.py": "",
    "engine/helper.py": ("try:\n    import {banned}.numpy as bnp\n"
                         "except ImportError:\n    bnp = None\n"),
    "fleet/__init__.py": "from .router import route\n",
    "fleet/router.py": ("import {pkg}.obs.spans as sp\n"
                        "from {pkg}.continual import scheduler\n\n\n"
                        "def route():\n    return sp\n"),
    "continual/__init__.py": "",
    "continual/scheduler.py": ("if False:\n    from {banned} import nn\n\n\n"
                               "class A:\n    import {banned} as b\n"),
    "policy/__init__.py": "from . import table\n",
    "policy/device.py": ("def kind():\n"
                         "    import {banned}  # lazy\n"
                         "    return {banned}\n"),
    "policy/table.py": ("from {pkg}.policy import device\n"
                        "from . import missing_module\n"
                        "from .. import engine\n"
                        "from ..engine.helper import bnp\n"),
}


def _render(pkg: str, banned: str) -> dict:
    return {f"{pkg}/{p}": s.replace("{pkg}", pkg).replace("{banned}", banned)
            for p, s in _IMPORT_TREE.items()}


def _unmap(obj, pkg: str, banned: str):
    s = json.dumps(obj, sort_keys=True)
    s = re.sub(rf"\b{pkg}\b", "<pkg>", s)
    return json.loads(re.sub(rf"\b{banned}\b", "<banned>", s))


def test_module_level_imports_agree_with_the_reference():
    ref_tree, port_tree = _render(REF, "jax"), _render(PORT, "torch")
    for sub in _IMPORT_TREE:
        out = []
        for ig, files, pkg, banned in ((ref_ig, ref_tree, REF, "jax"),
                                       (port_ig, port_tree, PORT, "torch")):
            import ast

            rel = f"{pkg}/{sub}"
            got = ig.module_level_imports(
                ast.parse(files[rel]), ig.module_name(rel),
                rel.endswith("__init__.py"))
            out.append(_unmap(sorted(got), pkg, banned))
        assert out[1] == out[0], sub


@pytest.mark.parametrize("entry", ["obs", "fleet", "continual", "policy",
                                   "engine"])
def test_banned_chains_agree_with_the_reference(tmp_path, entry):
    out = []
    for ig, lint, pkg, banned in ((ref_ig, ref_lint, REF, "jax"),
                                  (port_ig, port_lint, PORT, "torch")):
        files = _render(pkg, banned)
        tree = lint.SourceTree(str(tmp_path), files)
        entries = sorted(p for p in files if p.startswith(f"{pkg}/{entry}/"))
        chains = ig.find_banned_chains(entries, tree, (banned,))
        out.append(_unmap(sorted(chains), pkg, banned))
    assert out[1] == out[0]
    if entry in ("obs", "fleet", "policy"):
        assert out[0], f"the fixture's {entry} chain was not found"


@pytest.mark.parametrize("sub", ["obs", "fleet", "continual", "policy"])
def test_free_rules_agree_with_the_reference(tmp_path, sub):
    """``<sub>-jax-free`` on the fixture written with jax and
    ``<sub>-torch-free`` on it written with torch flag the same lines:
    direct, lazy, aliased, conditional and transitive."""
    keys = []
    for lint, pkg, banned, rule in (
            (ref_lint, REF, "jax", f"{sub}-jax-free"),
            (port_lint, PORT, "torch", f"{sub}-torch-free")):
        rep = lint.run_lint(str(tmp_path), rule_names=[rule],
                            overrides=_render(pkg, banned))
        keys.append(sorted((_strip(v.path, pkg), v.line)
                           for v in rep.violations))
    assert keys[1] == keys[0]
    assert keys[0], f"the fixture raised nothing under {sub}"


# ---------------------------------------------------------------------------
# the schedule harness: the same program, the same seeds, both harnesses


def _lock_name(name: str) -> str:
    """A lock's name without the harness's path prefix (the reference
    trims creation sites at ``dryad_tpu/``, the port at its own name)."""
    kind, _, site = name.partition("@")
    return f"{kind}@{site.rsplit('/', 1)[-1]}"


def _edges(sched) -> list:
    return sorted((_lock_name(a), _lock_name(b)) for a, b in sched.lock_edges)


def _verdict(e: BaseException) -> tuple:
    first = str(e).splitlines()[0] if str(e) else ""
    first = re.sub(r"Lock@[^\s,)]*", lambda m: _lock_name(m.group(0)), first)
    return type(e).__name__, first


def _toy_abba(log):
    def drill(sched):
        la, lb = threading.Lock(), threading.Lock()

        def t1():
            with la:
                log.append("t1 a")
                sched.pause()
                with lb:
                    log.append("t1 b")

        def t2():
            with lb:
                log.append("t2 b")
                sched.pause()
                with la:
                    log.append("t2 a")

        sched.spawn(t1, "t1")
        sched.spawn(t2, "t2")
        return None
    return drill


def _toy_pipeline(log):
    """A bounded queue, an event with timeouts, sleeps, a join with a
    timeout and a lock: every shim."""
    def drill(sched):
        q = queue.Queue(maxsize=1)
        done = threading.Event()
        lock = threading.Lock()
        state = {"sum": 0}

        def producer():
            for i in range(5):
                try:
                    q.put(i, timeout=0.2)
                    log.append(f"put {i} @{time.monotonic():.3f}")
                except queue.Full:
                    log.append(f"full {i}")
                time.sleep(0.01 * i)
            done.set()

        def consumer(tag):
            def run():
                while not done.is_set() or not q.empty():
                    try:
                        item = q.get(timeout=0.05)
                    except queue.Empty:
                        log.append(f"{tag} empty")
                        continue
                    with lock:
                        state["sum"] += item
                    log.append(f"{tag} got {item}")
            return run

        def watcher():
            t = threading.Thread(target=lambda: log.append("inner"))
            t.start()
            t.join(timeout=0.5)
            log.append(f"waited {done.wait(timeout=0.3)}")

        sched.spawn(producer, "producer")
        sched.spawn(consumer("c1"), "c1")
        sched.spawn(consumer("c2"), "c2")
        sched.spawn(watcher, "watcher")

        def check():
            assert state["sum"] == sum(
                int(x.split()[1]) for x in log if x.startswith("put"))
        return check
    return drill


def _toy_preempted(log):
    """An unlocked read-modify-write, preempted between lines of this
    file: the torn update is the verdict on some seeds."""
    def drill(sched):
        box = {"n": 0}

        def bump(tag):
            def run():
                for _ in range(3):
                    n = box["n"]
                    log.append(f"{tag} read {n}")
                    box["n"] = n + 1
            return run

        for tag in ("a", "b", "c"):
            sched.spawn(bump(tag), tag)

        def check():
            assert box["n"] == 9, f"torn update: {box['n']} of 9"
        return check
    return drill


_TOYS = {"abba": (_toy_abba, 0.0), "pipeline": (_toy_pipeline, 0.0),
         "preempted": (_toy_preempted, 0.05)}
#: what the ten seeds must show: ABBA always gets a verdict (a deadlock,
#: or the recorded lock-order cycle when one thread ran through first)
_TOY_OUTCOMES = {"abba": {"DeadlockError", "LockOrderError"},
                 "pipeline": {"pass"},
                 "preempted": {"pass", "AssertionError"}}


def _run(harness, drill, seed, p, tf):
    try:
        s = harness.run_schedule(drill, seed, preempt_p=p, trace_files=tf)
    except (AssertionError, RuntimeError) as e:
        return ("verdict",) + _verdict(e)
    return ("pass", s.steps, s.vtime, _edges(s))


@pytest.mark.parametrize("toy", sorted(_TOYS))
def test_toy_schedules_identical_under_both_harnesses(toy):
    make, p = _TOYS[toy]
    tf = (THIS_FILE,) if p else ()
    outcomes = set()
    for seed in range(10):
        got = []
        for harness in (ref_sched, port_sched):
            log: list = []
            got.append((_run(harness, make(log), seed, p, tf), log))
        assert got[1] == got[0], f"{toy} seed {seed}"
        out = got[0][0]
        outcomes.add(out[1] if out[0] == "verdict" else out[0])
    assert outcomes == _TOY_OUTCOMES[toy]


def _run_port_drill_under(harness, drill, seed, p, tf):
    """One port drill under ``harness``; the port's process singletons are
    made first and its default registry is kept out, as the port's own
    ``run_schedule`` does."""
    from dryad_tpu_torch.obs.registry import default_registry

    port_sched._prewarm_defaults()
    reg = default_registry()
    was = reg.enabled
    reg.disable()
    try:
        return _run(harness, drill, seed, p, tf)
    finally:
        if was:
            reg.enable()


@pytest.mark.parametrize("name", sorted(port_sched.DRILLS))
def test_port_drills_identical_under_both_harnesses(name):
    drill, _n, p, tf = port_sched.DRILLS[name]
    for seed in (0, 1):
        ref = _run_port_drill_under(ref_sched, drill, seed, p, tf)
        port = _run_port_drill_under(port_sched, drill, seed, p, tf)
        assert port == ref, f"{name} seed {seed}"
        assert port[0] == "pass", port


def _first_verdict(harness, name, max_seeds, extra_trace=()):
    drill, _n, p, tf = port_sched.DRILLS[name]
    for seed in range(max_seeds):
        out = _run_port_drill_under(harness, drill, seed, p,
                                    tuple(tf) + tuple(extra_trace))
        if out[0] == "verdict":
            return seed, out
    return None


def test_reverted_fixes_caught_at_the_same_seed_by_both(monkeypatch):
    """The batcher's stop/start generation race and the injector's
    non-atomic fire, reverted: both harnesses give the same verdict at
    the same first seed."""
    from dryad_tpu_torch.resilience import faults as fmod
    from dryad_tpu_torch.serve.batcher import MicroBatcher

    monkeypatch.setattr(MicroBatcher, "_stop_live", lambda self, token: True)
    ref = _first_verdict(ref_sched, "batcher-stop-start", 200)
    assert ref is not None
    assert _first_verdict(port_sched, "batcher-stop-start", 200) == ref

    def racy_call(self, site, iteration):
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
    ref = _first_verdict(ref_sched, "injector-concurrent-fire", 100,
                         (THIS_FILE,))
    assert ref is not None
    assert _first_verdict(port_sched, "injector-concurrent-fire", 100,
                          (THIS_FILE,)) == ref
