"""dryadlint layer 3 (static half): concurrency contracts for the port's
threaded host plane.

The counterpart of ``dryad_tpu/analysis/concurrency.py``, over the port's
threaded classes: the fleet router and supervisor, the capacity
controller, the retrain scheduler, the serve micro-batcher, model
registry and compiled-predict cache, the obs registry, health, tripwire,
watchdog and drift monitors, the resilience journal and injector, and the
data plane's chunk prefetcher.  Exit code 6 (see __main__.py)
distinguishes a concurrency-contract violation from ordinary lint.

The conventions the rules enforce:

* **GUARDED_BY declarations.**  A class that owns a lock
  (``self.<x> = threading.Lock()`` in ``__init__``) MUST declare which
  attributes that lock guards — either a class constant
  ``GUARDED_BY = {"_attr": "_lock"}`` (a literal dict) or, for small
  classes, a ``# guarded-by: _lock`` comment on the attribute's
  ``__init__`` assignment line.  Every read/write of a guarded attribute
  outside ``__init__`` must then sit lexically inside a
  ``with self.<lock>:`` block.  Helper methods whose name ends in
  ``_locked`` are the documented called-with-the-lock-held idiom: their
  bodies are exempt, and in exchange every CALL of a ``self.*_locked``
  method must itself sit under a ``with self.<lock>:`` block.
  Benign lock-free fast paths (the double-checked create in
  ``Registry._family``) carry the standard mandatory-reason waiver, so
  every exception is on the record.

* **No blocking under a lock.**  Inside any ``with <lock>:`` body
  (anything whose final name component contains "lock") the blocking
  primitives are banned: ``sleep``, thread/process ``join``/``wait``/
  ``communicate``, blocking queue ``get``/``put``, socket/HTTP verbs
  (``request``/``getresponse``/``urlopen``/``connect``/``accept``/
  ``recv``/``sendall``), and calls of constructor-injected user
  callbacks (``self.cb(...)`` where ``__init__`` stored a parameter on
  ``self``).  This is the class the registry-eviction and
  replica-recovery fixes belong to: a lock held across a blocking call
  turns one slow peer into a plane-wide stall.

* **Lock order.**  Every statically visible two-lock nesting (a
  ``with self.<A>:`` region that acquires ``self.<B>`` — directly or
  through intra-class ``self.<method>()`` calls, transitively) must be
  derivable from the committed partial order in
  ``analysis/goldens/lock_order.json``.  A nesting that INVERTS a
  committed edge is the deadlock shape; a new nesting must be committed
  consciously (the goldens diff is the review event, exactly like the
  census goldens).  Re-acquiring a held non-reentrant lock — directly or
  through a self-call — is always a violation.  Cross-OBJECT order
  (e.g. a registry lock taken inside an entry lock) is invisible to a
  lexical scan; the schedule harness (analysis/schedules.py) records
  those orders at runtime and raises on cycles.
"""

from __future__ import annotations

import ast
import json
import re
from typing import Iterable, Optional

from dryad_tpu_torch.analysis.lint import Rule, Violation, register
from dryad_tpu_torch.analysis.rules import dotted

#: the threaded host plane: the packages the schedule harness drills,
#: and the data plane's chunk prefetcher
TARGETS = ("dryad_tpu_torch/continual/**", "dryad_tpu_torch/fleet/**",
           "dryad_tpu_torch/serve/**",
           "dryad_tpu_torch/obs/**", "dryad_tpu_torch/resilience/**",
           "dryad_tpu_torch/data/stream_dataset.py")

LOCK_ORDER_GOLDENS = "dryad_tpu_torch/analysis/goldens/lock_order.json"

#: the rules whose violations exit with code 6 instead of 2 (see
#: __main__.py) — the concurrency layer's distinct CI signal
RULE_NAMES = ("guarded-by", "no-blocking-under-lock", "lock-order")

_GUARD_COMMENT_RE = re.compile(r"#\s*guarded-by:\s*(\w+)")
_LOCK_CTORS = {"threading.Lock", "threading.RLock", "Lock", "RLock"}


# ---------------------------------------------------------------------------
# shared class-shape helpers


def _classes(tree: ast.AST) -> Iterable[ast.ClassDef]:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            yield node


def _methods(cls: ast.ClassDef) -> Iterable[ast.FunctionDef]:
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _init_of(cls: ast.ClassDef):
    for m in _methods(cls):
        if m.name == "__init__":
            return m
    return None


def _self_attr(node: ast.AST) -> Optional[str]:
    """'x' for ``self.x`` Attribute nodes, else None."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _lock_attrs(cls: ast.ClassDef) -> dict:
    """Attributes assigned a ``threading.Lock()``/``RLock()`` in
    ``__init__`` -> assignment line."""
    out: dict[str, int] = {}
    init = _init_of(cls)
    if init is None:
        return out
    for node in ast.walk(init):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            if dotted(node.value.func) in _LOCK_CTORS:
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        out[attr] = node.lineno
    return out


def _guarded_by(cls: ast.ClassDef, src: str):
    """The class's guard declaration: ``{attr: lock_attr}`` merged from
    the ``GUARDED_BY`` class constant and ``# guarded-by: <lock>`` field
    comments in ``__init__``; None when the class declares nothing.
    Returns (mapping_or_None, problems) where problems are non-literal
    declarations."""
    mapping: Optional[dict] = None
    problems: list[tuple[int, str]] = []
    for node in cls.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "GUARDED_BY":
                    if not isinstance(node.value, ast.Dict):
                        problems.append((node.lineno,
                                         "GUARDED_BY must be a literal dict"))
                        continue
                    mapping = {} if mapping is None else mapping
                    for k, v in zip(node.value.keys, node.value.values):
                        if (isinstance(k, ast.Constant)
                                and isinstance(v, ast.Constant)):
                            mapping[str(k.value)] = str(v.value)
                        else:
                            problems.append(
                                (node.lineno, "GUARDED_BY keys/values must "
                                              "be string literals"))
    init = _init_of(cls)
    if init is not None:
        lines = src.splitlines()
        for node in ast.walk(init):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                if node.lineno > len(lines):
                    continue
                m = _GUARD_COMMENT_RE.search(lines[node.lineno - 1])
                if not m:
                    continue
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        mapping = {} if mapping is None else mapping
                        mapping[attr] = m.group(1)
    return mapping, problems


def _held_locks_map(fn: ast.AST) -> dict:
    """id(node) -> frozenset of self-lock attribute names lexically held
    at that node (``with self.<lock>:`` ancestry within ``fn``)."""
    held_at: dict[int, frozenset] = {}

    def locks_of(with_node: ast.With) -> frozenset:
        out = set()
        for item in with_node.items:
            attr = _self_attr(item.context_expr)
            if attr is not None:
                out.add(attr)
        return frozenset(out)

    def visit(node: ast.AST, held: frozenset) -> None:
        held_at[id(node)] = held
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                visit(item, held)
            inner = held | locks_of(node)
            for st in node.body:
                visit(st, inner)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    visit(fn, frozenset())
    return held_at


# ---------------------------------------------------------------------------
# guarded-by


def _check_guarded_by(path, src, tree):
    out = []
    for cls in _classes(tree):
        locks = _lock_attrs(cls)
        gb, problems = _guarded_by(cls, src)
        for line, msg in problems:
            out.append(Violation("guarded-by", path, line,
                                 f"{cls.name}: {msg} (the lint reads it "
                                 "statically)"))
        if locks and gb is None:
            out.append(Violation(
                "guarded-by", path, cls.lineno,
                f"class {cls.name} owns a lock "
                f"({', '.join(sorted(locks))}) but declares no GUARDED_BY "
                "map — every threaded class must state which attributes "
                "its lock guards (GUARDED_BY = {\"_attr\": \"_lock\"} or a "
                "'# guarded-by: _lock' field comment)"))
            continue
        if not gb:
            continue
        for attr, lock in sorted(gb.items()):
            if lock not in locks:
                out.append(Violation(
                    "guarded-by", path, cls.lineno,
                    f"{cls.name}.GUARDED_BY guards {attr!r} with "
                    f"{lock!r}, but __init__ assigns no "
                    f"self.{lock} = threading.Lock()"))
        method_names = {m.name for m in _methods(cls)}
        seen: set = set()   # one violation per (line, attr): a line like
        # `if self._t is None or not self._t.is_alive():` touches the
        # attr twice but holds ONE waiver slot in the ratchet
        for m in _methods(cls):
            if m.name == "__init__" or m.name.endswith("_locked"):
                continue
            held_at = _held_locks_map(m)
            for node in ast.walk(m):
                attr = _self_attr(node)
                if attr is None or (node.lineno, attr) in seen:
                    continue
                if attr in gb and gb[attr] not in held_at.get(
                        id(node), frozenset()):
                    seen.add((node.lineno, attr))
                    out.append(Violation(
                        "guarded-by", path, node.lineno,
                        f"{cls.name}.{m.name} touches self.{attr} "
                        f"(GUARDED_BY self.{gb[attr]}) outside a "
                        f"`with self.{gb[attr]}:` block — either take the "
                        "lock, move the access into a *_locked helper "
                        "called under it, or waive with the reason the "
                        "lock-free access is benign"))
                    continue
                if (attr.endswith("_locked") and attr in method_names
                        and isinstance(node, ast.Attribute)):
                    # a *_locked helper promises its CALLERS hold the lock
                    if not held_at.get(id(node), frozenset()):
                        out.append(Violation(
                            "guarded-by", path, node.lineno,
                            f"{cls.name}.{m.name} calls self.{attr} "
                            "without holding a class lock — *_locked "
                            "helpers are the called-with-the-lock-held "
                            "idiom; take the lock at the call site"))
    return out


register(Rule(
    name="guarded-by",
    doc="threaded classes declare lock-guarded attributes (GUARDED_BY) "
        "and touch them only under the declared lock",
    targets=TARGETS,
    check=_check_guarded_by,
))


# ---------------------------------------------------------------------------
# no-blocking-under-lock

_BLOCKING_LEAVES = {"sleep", "wait", "communicate", "getresponse", "urlopen",
                    "recv", "recv_into", "accept", "connect", "sendall",
                    "request"}


def _is_lockish(expr: ast.AST) -> bool:
    d = dotted(expr)
    return bool(d) and "lock" in d.rsplit(".", 1)[-1].lower()


def _numeric_const(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value,
                                                         (int, float))


def _blocking_reason(call: ast.Call) -> Optional[str]:
    """Why this call is a blocking primitive, or None."""
    name = dotted(call.func) or ""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _BLOCKING_LEAVES:
        return f"{name or leaf}(...) blocks"
    kwnames = {k.arg for k in call.keywords}
    if leaf == "join" and isinstance(call.func, ast.Attribute):
        if isinstance(call.func.value, ast.Constant):
            return None         # "sep".join(...) — string join
        if (not call.args and not call.keywords) or "timeout" in kwnames \
                or (len(call.args) == 1 and _numeric_const(call.args[0])):
            return "thread join blocks"
        return None
    if leaf == "get" and isinstance(call.func, ast.Attribute):
        # blocking queue get: zero positional args, or timeout/block kw;
        # dict.get(key[, default]) always passes the key positionally
        if not call.args or kwnames & {"timeout", "block"}:
            return "blocking queue get"
        return None
    if leaf == "put" and isinstance(call.func, ast.Attribute):
        return "bounded-queue put can block (use put_nowait or move it " \
               "outside the lock)"
    return None


def _callback_attrs(cls: ast.ClassDef) -> set:
    """Constructor-injected callables: ``self.X = P`` in __init__ where P
    is a bare parameter name — calling one under a lock hands the lock's
    critical section to arbitrary user code."""
    init = _init_of(cls)
    if init is None:
        return set()
    a = init.args
    params = {p.arg for p in (list(a.posonlyargs) + list(a.args)
                              + list(a.kwonlyargs))}
    out = set()
    for node in ast.walk(init):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Name) \
                and node.value.id in params:
            for t in node.targets:
                attr = _self_attr(t)
                if attr is not None:
                    out.add(attr)
    return out


def _check_no_blocking(path, src, tree):
    out = []
    seen: set = set()

    # class context first, so callback calls are recognizable
    cls_of: dict[int, ast.ClassDef] = {}
    for cls in _classes(tree):
        for node in ast.walk(cls):
            cls_of.setdefault(id(node), cls)
    callbacks = {cls.name: _callback_attrs(cls) for cls in _classes(tree)}

    for with_node in ast.walk(tree):
        if not isinstance(with_node, (ast.With, ast.AsyncWith)):
            continue
        if not any(_is_lockish(item.context_expr)
                   for item in with_node.items):
            continue
        lock_repr = ", ".join(dotted(item.context_expr) or "?"
                              for item in with_node.items
                              if _is_lockish(item.context_expr))
        for st in with_node.body:
            for node in ast.walk(st):
                if not isinstance(node, ast.Call):
                    continue
                reason = _blocking_reason(node)
                cls = cls_of.get(id(with_node))
                if reason is None and cls is not None:
                    attr = _self_attr(node.func)
                    if attr in callbacks.get(cls.name, ()):
                        reason = (f"self.{attr} is a constructor-injected "
                                  "user callback — invoking it hands the "
                                  "critical section to arbitrary code")
                if reason is None:
                    continue
                key = (node.lineno, dotted(node.func) or "")
                if key in seen:
                    continue
                seen.add(key)
                out.append(Violation(
                    "no-blocking-under-lock", path, node.lineno,
                    f"{reason} inside `with {lock_repr}:` — a lock held "
                    "across a blocking call turns one slow peer into a "
                    "plane-wide stall (the registry-eviction / "
                    "replica-recovery fix class); do the blocking work "
                    "outside the lock"))
    return out


register(Rule(
    name="no-blocking-under-lock",
    doc="no sleep/join/wait/socket/queue-blocking or user-callback calls "
        "inside a `with <lock>:` body",
    targets=TARGETS,
    check=_check_no_blocking,
))


# ---------------------------------------------------------------------------
# lock-order


def _direct_lock_withs(fn: ast.AST, locks: dict) -> list:
    """(with_node, frozenset(lock_attrs)) for every ``with self.<lock>``
    in ``fn`` whose lock attr is a declared class lock."""
    out = []
    for node in ast.walk(fn):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = frozenset(a for item in node.items
                                 for a in [_self_attr(item.context_expr)]
                                 if a in locks)
            if acquired:
                out.append((node, acquired))
    return out


def _self_calls(node: ast.AST, method_names: set) -> list:
    out = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            attr = _self_attr(sub.func)
            if attr in method_names:
                out.append((sub, attr))
    return out


def _closure_locks(cls: ast.ClassDef, locks: dict) -> dict:
    """method name -> set of class locks the method may acquire, through
    any chain of intra-class self-calls (fixpoint; cycle-safe)."""
    methods = {m.name: m for m in _methods(cls)}
    direct = {name: {a for _, acq in _direct_lock_withs(m, locks)
                     for a in acq}
              for name, m in methods.items()}
    calls = {name: {c for _, c in _self_calls(m, set(methods))}
             for name, m in methods.items()}
    closure = {name: set(direct[name]) for name in methods}
    changed = True
    while changed:
        changed = False
        for name in methods:
            for callee in calls[name]:
                add = closure[callee] - closure[name]
                if add:
                    closure[name] |= add
                    changed = True
    return closure


def _observed_edges(path, tree):
    """[(outer_id, inner_id, line, detail)] for statically visible
    nestings, plus [(line, message)] for held-lock re-acquisitions."""
    edges = []
    reacquired = []
    for cls in _classes(tree):
        locks = _lock_attrs(cls)
        if not locks:
            continue
        methods = {m.name for m in _methods(cls)}
        closure = _closure_locks(cls, locks)

        def qual(attr: str) -> str:
            return f"{cls.name}.{attr}"

        for m in _methods(cls):
            held_at = _held_locks_map(m)
            for with_node, acquired in _direct_lock_withs(m, locks):
                held = held_at.get(id(with_node), frozenset()) & set(locks)
                for a in acquired:
                    if a in held:
                        reacquired.append((
                            with_node.lineno,
                            f"{cls.name}.{m.name} re-acquires held "
                            f"non-reentrant lock self.{a}"))
                    for h in held:
                        if h != a:
                            edges.append((qual(h), qual(a), with_node.lineno,
                                          f"{cls.name}.{m.name}"))
            for call, callee in _self_calls(m, methods):
                held = held_at.get(id(call), frozenset()) & set(locks)
                if not held:
                    continue
                for a in closure.get(callee, ()):
                    if a in held:
                        reacquired.append((
                            call.lineno,
                            f"{cls.name}.{m.name} holds self.{a} and calls "
                            f"self.{callee}(), which (transitively) "
                            f"acquires self.{a} again — self-deadlock"))
                    else:
                        for h in held:
                            edges.append((qual(h), qual(a), call.lineno,
                                          f"{cls.name}.{m.name} -> "
                                          f"self.{callee}()"))
    return edges, reacquired


def _transitive(pairs) -> set:
    closed = set(pairs)
    changed = True
    while changed:
        changed = False
        for a, b in list(closed):
            for c, d in list(closed):
                if b == c and (a, d) not in closed:
                    closed.add((a, d))
                    changed = True
    return closed


def _committed_order(tree):
    """(allowed transitive closure, error message or None).  A tree that
    carries no goldens of its own (fixture roots in tests) falls back to
    the package's committed file."""
    try:
        try:
            raw = tree.read(LOCK_ORDER_GOLDENS)
        except FileNotFoundError:
            import os

            with open(os.path.join(os.path.dirname(__file__), "goldens",
                                   "lock_order.json")) as f:
                raw = f.read()
        doc = json.loads(raw)
        edges = [tuple(e) for e in doc["edges"]]
    except FileNotFoundError:
        return set(), (f"{LOCK_ORDER_GOLDENS} is missing — commit the "
                       "lock partial order")
    except (ValueError, KeyError, TypeError) as e:
        return set(), f"{LOCK_ORDER_GOLDENS} is malformed: {e!r}"
    closed = _transitive(edges)
    for a, b in closed:
        if (b, a) in closed or a == b:
            return set(), (f"{LOCK_ORDER_GOLDENS} commits a CYCLIC order "
                           f"({a} <-> {b}) — a partial order cannot "
                           "contain both directions")
    return closed, None


def _tree_check_lock_order(sources, tree):
    out = []
    allowed, err = _committed_order(tree)
    first_path = min(sources) if sources else LOCK_ORDER_GOLDENS
    if err is not None:
        return [Violation("lock-order", first_path, 1, err)]
    for rel in sorted(sources):
        _, mod = sources[rel]
        edges, reacquired = _observed_edges(rel, mod)
        for line, msg in reacquired:
            out.append(Violation("lock-order", rel, line, msg))
        seen = set()
        for a, b, line, where in edges:
            if (a, b) in seen:
                continue
            seen.add((a, b))
            if (a, b) in allowed:
                continue
            if (b, a) in allowed:
                out.append(Violation(
                    "lock-order", rel, line,
                    f"{where} acquires {b} while holding {a} — this "
                    f"INVERTS the committed order ({b} before {a}, "
                    f"{LOCK_ORDER_GOLDENS}); the opposite nesting exists "
                    "somewhere, so this is the deadlock shape"))
            else:
                out.append(Violation(
                    "lock-order", rel, line,
                    f"{where} acquires {b} while holding {a}, an order "
                    f"not in the committed partial order — if intentional "
                    f"add [\"{a}\", \"{b}\"] to {LOCK_ORDER_GOLDENS} "
                    "(check the new edge keeps the order acyclic) and "
                    "commit the diff"))
    return out


register(Rule(
    name="lock-order",
    doc="two-lock nestings (direct or via intra-class calls) must follow "
        "the committed partial order in analysis/goldens/lock_order.json",
    targets=TARGETS,
    tree_check=_tree_check_lock_order,
))
