"""dryadlint core: source tree, waiver parsing, rule registry, runner.

The counterpart of ``dryad_tpu/analysis/lint.py``, over the port's tree.

* Rules run against EITHER the real repo tree or a patched overlay of it
  (tests seed violations into copies of the real files: the mutation
  check each rule must pass), so all file access goes through
  ``SourceTree``.
* Waivers are per-line and must carry a reason.  A waiver suppresses one
  rule on one line (the line it sits on, or, for long expressions, the
  line directly below it); ``disable-file=`` waives a rule for a whole
  file.  Waived violations are still counted and the CLI checks the
  count against the committed budget (``goldens/waiver_budget.json``).
* Everything here is stdlib-only (``ast``, no torch, no numpy): the
  linter runs before, and independently of, any device runtime.
"""

from __future__ import annotations

import ast
import fnmatch
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

# ``# dryadlint: disable=rule-a,rule-b -- reason`` (reason mandatory);
# ``disable-file=`` at any line waives the rule for the WHOLE file
_WAIVER_RE = re.compile(
    r"#\s*dryadlint:\s*(disable|disable-file)=([A-Za-z0-9_,-]+)"
    r"\s*--\s*(.+?)\s*$")
# a disable marker with NO reason — always an error, never a suppression
_BAD_WAIVER_RE = re.compile(
    r"#\s*dryadlint:\s*(?:disable|disable-file)=([A-Za-z0-9_,-]+)\s*$")


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str          # repo-relative, forward slashes
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass(frozen=True)
class Waiver:
    rule: str
    path: str
    line: int
    reason: str


@dataclass
class LintReport:
    violations: list[Violation] = field(default_factory=list)
    waived: list[tuple[Violation, Waiver]] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)   # parse/bad-waiver

    @property
    def ok(self) -> bool:
        return not self.violations and not self.errors

    def summary(self) -> str:
        return (f"dryadlint: {len(self.violations)} violation(s), "
                f"{len(self.waived)} waived, {len(self.errors)} error(s)")


class SourceTree:
    """Read-only view of the repo's Python sources, with optional overrides.

    ``overrides`` maps repo-relative paths to replacement source text —
    the mutation tests patch one file in memory and re-run a rule without
    touching disk.  An override for a path that does not exist on disk
    adds a virtual file (fixture trees).
    """

    def __init__(self, root: str, overrides: Optional[dict] = None):
        self.root = os.path.abspath(root)
        self.overrides = dict(overrides or {})

    def read(self, relpath: str) -> str:
        if relpath in self.overrides:
            return self.overrides[relpath]
        with open(os.path.join(self.root, relpath), encoding="utf-8") as f:
            return f.read()

    def exists(self, relpath: str) -> bool:
        return relpath in self.overrides or os.path.exists(
            os.path.join(self.root, relpath))

    def find(self, patterns: Iterable[str]) -> list[str]:
        """Repo-relative python files matching any glob pattern (``**``
        crosses directories).  Overrides participate, disk paths that an
        override shadows are deduped."""
        out: set[str] = set()
        for rel in self._walk_disk():
            if any(_match(rel, p) for p in patterns):
                out.add(rel)
        for rel in self.overrides:
            if any(_match(rel, p) for p in patterns):
                out.add(rel)
        return sorted(out)

    def _walk_disk(self) -> Iterable[str]:
        skip = {"__pycache__", ".git", ".pytest_cache"}
        for dirpath, dirnames, filenames in os.walk(self.root):
            dirnames[:] = [d for d in dirnames if d not in skip]
            for fn in filenames:
                if fn.endswith(".py"):
                    full = os.path.join(dirpath, fn)
                    yield os.path.relpath(full, self.root).replace(os.sep, "/")


def _match(rel: str, pattern: str) -> bool:
    if "**" in pattern:
        # fnmatch's * does not cross "/"; translate ** manually
        rx = re.escape(pattern).replace(r"\*\*", ".*").replace(r"\*", "[^/]*")
        return re.fullmatch(rx, rel) is not None
    return fnmatch.fnmatch(rel, pattern)


@dataclass(frozen=True)
class Rule:
    """One named analysis.  ``check(path, src, tree)`` returns a list of
    Violations for one parsed file; ``targets`` are repo-relative globs;
    ``tree_check(sources, tree)`` (when set) runs ONCE over the whole
    file set instead of per file — rules that need a cross-file view
    (the transitive import analysis) use it.
    """

    name: str
    doc: str
    targets: tuple
    check: Optional[Callable] = None
    tree_check: Optional[Callable] = None


_REGISTRY: dict[str, Rule] = {}


def register(rule: Rule) -> Rule:
    if rule.name in _REGISTRY:
        raise ValueError(f"duplicate rule {rule.name!r}")
    _REGISTRY[rule.name] = rule
    return rule


def registry() -> dict[str, Rule]:
    # rules.py / concurrency.py register on import; keep the imports here
    # so ``registry()`` is always complete regardless of import order
    from dryad_tpu_torch.analysis import concurrency as _conc  # noqa: F401
    from dryad_tpu_torch.analysis import rules as _rules  # noqa: F401

    return dict(_REGISTRY)


def parse_waivers(path: str, src: str, report: LintReport) -> tuple:
    """(line -> {rule: Waiver}, {rule: Waiver} file-wide).  A line waiver
    covers its own line and the next line (so a comment line can waive the
    long expression under it); ``disable-file`` covers the whole file."""
    out: dict[int, dict[str, Waiver]] = {}
    filewide: dict[str, Waiver] = {}
    for i, text in enumerate(src.splitlines(), start=1):
        bad = _BAD_WAIVER_RE.search(text)
        if bad and not _WAIVER_RE.search(text):
            report.errors.append(
                f"{path}:{i}: dryadlint waiver for {bad.group(1)!r} has no "
                f"'-- reason' (the reason is mandatory)")
            continue
        m = _WAIVER_RE.search(text)
        if not m:
            continue
        for rule in m.group(2).split(","):
            w = Waiver(rule.strip(), path, i, m.group(3))
            if m.group(1) == "disable-file":
                filewide[w.rule] = w
            else:
                for covered in (i, i + 1):
                    out.setdefault(covered, {})[w.rule] = w
    return out, filewide


def run_lint(root: str, rule_names: Optional[Iterable[str]] = None,
             overrides: Optional[dict] = None) -> LintReport:
    """Run the registered rules over the tree rooted at ``root``."""
    tree = SourceTree(root, overrides)
    rules = registry()
    if rule_names is not None:
        unknown = set(rule_names) - set(rules)
        if unknown:
            raise ValueError(f"unknown rule(s): {sorted(unknown)}")
        rules = {k: rules[k] for k in rule_names}

    report = LintReport()
    parsed: dict[str, tuple] = {}

    def get_parsed(rel: str):
        if rel not in parsed:
            src = tree.read(rel)
            try:
                mod = ast.parse(src, filename=rel)
            except SyntaxError as e:
                report.errors.append(f"{rel}: syntax error: {e}")
                mod = None
            parsed[rel] = (src, mod, parse_waivers(rel, src, report))
        return parsed[rel]

    for rule in rules.values():
        files = tree.find(rule.targets)
        raw: list[Violation] = []
        if rule.tree_check is not None:
            sources = {}
            for rel in files:
                src, mod, _ = get_parsed(rel)
                if mod is not None:
                    sources[rel] = (src, mod)
            raw.extend(rule.tree_check(sources, tree))
        if rule.check is not None:
            for rel in files:
                src, mod, _ = get_parsed(rel)
                if mod is None:
                    continue
                raw.extend(rule.check(rel, src, mod))
        for v in raw:
            _, _, (waivers, filewide) = get_parsed(v.path) if tree.exists(
                v.path) else ("", None, ({}, {}))
            w = waivers.get(v.line, {}).get(v.rule) or filewide.get(v.rule)
            if w is not None:
                report.waived.append((v, w))
            else:
                report.violations.append(v)

    report.violations.sort(key=lambda v: (v.path, v.line, v.rule))
    return report
