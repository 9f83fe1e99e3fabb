"""dryadlint of the port (dryad_tpu_torch/analysis, layer 1): every rule
(a) passes on the shipped tree, (b) FAILS on a seeded violation (the
mutation check: direct, lazy, transitive and aliased forms), and (c)
honors the waiver syntax, reasons mandatory.  The counterparts of
tests/test_analysis_lint.py's cases for every rule the port carries.

Mutation fixtures patch REAL port files in memory (SourceTree overrides),
so the checks exercise the exact file set the CLI lints.
"""

from __future__ import annotations

import json
import textwrap

import pytest
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

from dryad_tpu_torch.analysis.lint import (
    LintReport,
    SourceTree,
    parse_waivers,
    run_lint,
)

ROOT = __file__.rsplit("/tests/", 1)[0]
PKG = "dryad_tpu_torch"


def _violations(rule, overrides=None):
    return run_lint(ROOT, rule_names=[rule], overrides=overrides)


def _rule_hits(report, rule):
    return [v for v in report.violations if v.rule == rule]


def _src(rel):
    return SourceTree(ROOT).read(f"{PKG}/{rel}")


def _seeded(rule, rel, text, prepend=False, extra=None):
    """Hits of ``rule`` with ``text`` appended to (or put before) the real
    file ``rel``; ``extra`` adds more overrides."""
    src = _src(rel)
    over = {f"{PKG}/{rel}": (text + src) if prepend else (src + text)}
    over.update(extra or {})
    return _rule_hits(_violations(rule, over), rule)


# ---------------------------------------------------------------------------
# the shipped tree is clean


def test_shipped_tree_clean_all_rules():
    report = run_lint(ROOT)
    assert report.ok, "\n".join(v.format() for v in report.violations)
    with open(f"{ROOT}/{PKG}/analysis/goldens/waiver_budget.json") as f:
        budget = json.load(f)["waivers"]
    assert len(report.waived) <= budget


# ---------------------------------------------------------------------------
# wired-grower-sort


def test_wired_grower_sort_seeded_tile_plan():
    hits = _seeded("wired-grower-sort", "engine/levelwise.py",
                   "\n_resurrected = tile_plan\n")
    assert any("tile_plan" in v.message for v in hits)


def test_wired_grower_sort_seeded_row_sort():
    hits = _seeded("wired-grower-sort", "engine/leafwise_fast.py",
                   "\ndef _sneaky(rows):\n    return torch.argsort(rows)\n")
    assert hits


def test_wired_grower_existing_slot_argsort_is_waived():
    rep = _violations("wired-grower-sort")
    assert not rep.violations
    assert any(w.rule == "wired-grower-sort" for _, w in rep.waived), \
        "the (L,)-slot gain argsort must be waived, not invisible"


def test_wired_grower_sort_seeded_aliased_import():
    """``from ... import tile_plan as _tp`` dodges a Name scan: the
    import itself must trip the rule."""
    hits = _seeded("wired-grower-sort", "engine/levelwise.py",
                   "\nfrom dryad_tpu_torch.engine import tile_plan as _tp\n")
    assert any("import" in v.message for v in hits)


@pytest.mark.parametrize("expr", [
    "torch.msort(a)", "a.topk(3)", "torch.kthvalue(a, 2)",
    "torch.sort(a).values", "torch.where(a > 0, a, b).argsort()",
    "torch.unique(a)"])
def test_wired_grower_sort_seeded_torch_sort_family(expr):
    hits = _seeded("wired-grower-sort", "engine/levelwise.py",
                   f"\ndef _sneaky(a, b):\n    return {expr}\n")
    assert hits, expr


def test_wired_grower_sort_unsorted_unique_is_clean():
    hits = _seeded("wired-grower-sort", "engine/levelwise.py",
                   "\ndef _ok(a):\n    return torch.unique(a, sorted=False)\n")
    assert not hits


# ---------------------------------------------------------------------------
# batcher-device-fetch


@pytest.mark.parametrize("snippet", [
    "import torch\n",
    "from torch import nn\n",
    "def _f(x):\n    return np.asarray(x)\n",
    "def _f(x):\n    return x.cpu()\n",
    "def _f(x):\n    return x.item()\n",
    "def _f():\n    import triton\n    return triton\n",
])
def test_batcher_fetch_seeded(snippet):
    assert _seeded("batcher-device-fetch", "serve/batcher.py",
                   "\n" + snippet)


# ---------------------------------------------------------------------------
# obs-torch-free (direct + transitive)


def test_obs_direct_torch_import_seeded():
    assert _seeded("obs-torch-free", "obs/spans.py", "\nimport torch\n")


def test_obs_lazy_function_level_torch_import_also_banned():
    assert _seeded("obs-torch-free", "obs/spans.py",
                   "\ndef _lazy():\n    import torch\n    return torch\n")


def test_obs_device_fetch_shapes_banned():
    for snippet in ("\ndef _f(x):\n    return x.cpu()\n",
                    "\ndef _f(x):\n    return np.asarray(x)\n"):
        assert _seeded("obs-torch-free", "obs/registry.py", snippet)


def test_obs_transitive_torch_import_seeded():
    # registry.py -> engine.hist -> torch: no obs file mentions torch,
    # only the import-graph walk can see it
    hits = _seeded("obs-torch-free", "obs/registry.py",
                   "from dryad_tpu_torch.engine.hist import TILE_ROWS\n",
                   prepend=True)
    assert any("transitive" in v.message for v in hits), \
        [v.message for v in hits]


def test_obs_transitive_through_new_internal_module():
    helper = "import torch\n\ndef now():\n    return 0.0\n"
    hits = _seeded("obs-torch-free", "obs/spans.py",
                   "from dryad_tpu_torch._timeutil import now\n",
                   prepend=True,
                   extra={f"{PKG}/_timeutil.py": helper})
    assert any("transitive" in v.message for v in hits)


def test_obs_clean_tree_has_no_transitive_torch():
    assert not _violations("obs-torch-free").violations


def test_obs_trends_is_covered_by_the_transitive_torch_walk():
    assert _seeded("obs-torch-free", "obs/trends.py", "\nimport torch\n")
    helper = "import torch\n\ndef rev():\n    return 'x'\n"
    hits = _seeded("obs-torch-free", "obs/trends.py",
                   "from dryad_tpu_torch._gitutil import rev\n",
                   prepend=True, extra={f"{PKG}/_gitutil.py": helper})
    assert any("transitive" in v.message for v in hits)


# ---------------------------------------------------------------------------
# fleet-torch-free, continual-torch-free, policy-torch-free


def test_fleet_direct_torch_import_seeded():
    assert _seeded("fleet-torch-free", "fleet/router.py", "\nimport torch\n")


def test_fleet_lazy_torch_import_also_banned():
    assert _seeded("fleet-torch-free", "fleet/supervisor.py",
                   "\ndef _lazy():\n    from torch import nn\n    return nn\n")


def test_fleet_transitive_torch_import_seeded():
    hits = _seeded("fleet-torch-free", "fleet/replica.py",
                   "from dryad_tpu_torch.engine.hist import TILE_ROWS\n",
                   prepend=True)
    assert hits and any("transitive" in v.message for v in hits)


def test_fleet_device_fetch_shape_banned():
    assert _seeded("fleet-torch-free", "fleet/router.py",
                   "\ndef _peek(x):\n    return x.numpy()\n")


@pytest.mark.parametrize("snippet,transitive", [
    ("\nimport torch\n", False),
    ("\ndef _lazy():\n    import torch\n    return torch\n", False),
    ("from dryad_tpu_torch.engine.split import NEG_INF\n", True),
])
def test_continual_torch_free_seeded(snippet, transitive):
    hits = _seeded("continual-torch-free", "continual/scheduler.py",
                   snippet, prepend=transitive)
    assert hits
    if transitive:
        assert any("transitive" in v.message for v in hits)


@pytest.mark.parametrize("snippet,transitive", [
    ("\nimport torch\n", False),
    ("\ndef _probe():\n    import torch\n    return torch\n", False),
    ("from dryad_tpu_torch.engine.hist import TILE_ROWS\n", True),
])
def test_policy_torch_free_seeded(snippet, transitive):
    hits = _seeded("policy-torch-free", "policy/table.py", snippet,
                   prepend=transitive)
    assert hits
    if transitive:
        assert any("transitive" in v.message for v in hits)


def test_policy_device_probe_is_the_one_waived_torch_touch():
    rep = _violations("policy-torch-free")
    assert not rep.violations
    waived = [v.path for v, w in rep.waived if w.rule == "policy-torch-free"]
    assert waived == [f"{PKG}/policy/device.py"]


# ---------------------------------------------------------------------------
# gate-through-policy


@pytest.mark.parametrize("expr", ["4096", "1 << 15", "2 ** 10"])
def test_gate_literal_seeded_in_a_gate_function(expr):
    src = _src("engine/leafwise_fast.py")
    anchor = "def leafwise_layout_supported("
    assert anchor in src
    bad = src.replace(anchor, f"_X = 0\n\n\n{anchor}", 1) + (
        f"\n\ndef deep_layout_supported(p):\n    return p.x < {expr}\n")
    hits = _rule_hits(_violations("gate-through-policy",
                                  {f"{PKG}/engine/leafwise_fast.py": bad}),
                      "gate-through-policy")
    assert len(hits) == 1, expr


def test_gate_shape_arithmetic_and_other_functions_are_clean():
    assert not _seeded(
        "gate-through-policy", "engine/levelwise.py",
        "\ndef _helper(F):\n    return 4096 + 9 + F\n")
    assert not _violations("gate-through-policy").violations


# ---------------------------------------------------------------------------
# bench-real-fetch (the probe harness's timed loops)

_BENCH_BAD = textwrap.dedent("""
    import time

    def probe(step, s0):
        t0 = time.perf_counter()
        for _ in range(8):
            s0 = step(s0)
        return time.perf_counter() - t0
""")


def test_bench_real_fetch_seeded():
    assert _seeded("bench-real-fetch", "__main__.py", _BENCH_BAD)


def test_bench_real_fetch_item_fetch_is_clean():
    ok = _BENCH_BAD.replace("    return time.perf_counter",
                            "    s0.item()\n    return time.perf_counter")
    assert not _seeded("bench-real-fetch", "__main__.py", ok)


def test_bench_real_fetch_shipped_harness_is_clean():
    assert not _violations("bench-real-fetch").violations


def test_bench_real_fetch_host_scalar_float_is_not_a_fetch():
    """``float(K)`` converts a host scalar: it must NOT satisfy the fetch
    requirement (only conversions of call results count)."""
    bad = _BENCH_BAD.replace("return time.perf_counter() - t0\n",
                             "return (time.perf_counter() - t0) / float(8)\n")
    assert _seeded("bench-real-fetch", "__main__.py", bad)


def test_bench_real_fetch_float_of_call_result_name_counts():
    ok = _BENCH_BAD.replace("    return time.perf_counter",
                            "    r = step(s0)\n    float(r)\n"
                            "    return time.perf_counter")
    assert not _seeded("bench-real-fetch", "__main__.py", ok)


def test_bench_real_fetch_covers_the_harness_module():
    """engine/probes.py is in the rule's targets: strip timed_fori's
    terminal fetches and the rule must fire there."""
    src = _src("engine/probes.py")
    head, tail = src.split("def timed_fori(", 1)
    body, rest = tail.split("\n# ----", 1)
    assert body.count(".item()") == 4           # the four fetch sites
    bad = head + "def timed_fori(" + body.replace(".item()", "") \
        + "\n# ----" + rest
    hits = _rule_hits(_violations("bench-real-fetch",
                                  {f"{PKG}/engine/probes.py": bad}),
                      "bench-real-fetch")
    assert any(v.path == f"{PKG}/engine/probes.py" for v in hits)


# ---------------------------------------------------------------------------
# dead-perturbation


@pytest.mark.parametrize("expr", [
    "tab[(s + 0.001).to(torch.int32)]",
    "tab[(s + 1e-3).long()]",
    "tab[int(s + 0.001)]",
    "tab[(s - 0.25).astype(np.int64)]",
    "tab[torch.tensor(s + 0.5, dtype=torch.int64)]",
])
def test_dead_perturbation_seeded(expr):
    src = ("import torch\nimport numpy as np\n\n"
           f"def f(s, tab):\n    return {expr}\n")
    hits = _rule_hits(_violations(
        "dead-perturbation", {f"{PKG}/engine/_fixture_perturb.py": src}),
        "dead-perturbation")
    assert hits, expr


def test_dead_perturbation_whole_unit_advance_is_clean():
    src = ("import torch\n"
           "def f(s, tab):\n"
           "    return tab[(s + 1.0).to(torch.int32)]\n")
    assert not _rule_hits(_violations(
        "dead-perturbation", {f"{PKG}/engine/_fixture_perturb.py": src}),
        "dead-perturbation")


def test_dead_perturbation_covers_the_harness_module():
    hits = _seeded("dead-perturbation", "engine/probes.py",
                   "\ndef _sneaky(s, tab):\n"
                   "    return tab[(s + 0.001).to(torch.int32)]\n")
    assert any(v.path == f"{PKG}/engine/probes.py" for v in hits)


# ---------------------------------------------------------------------------
# unharnessed-timed-fori

_UNHARNESSED = textwrap.dedent("""
    import torch

    def my_loop_time(step, s0):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(8):
            s0 = step(s0)
        e1.record()
        s0.item()
        return e0.elapsed_time(e1)
""")


def test_unharnessed_fori_seeded_in_profile_cli():
    assert _seeded("unharnessed-timed-fori", "__main__.py", _UNHARNESSED)


def test_unharnessed_fori_seeded_in_bench():
    assert _seeded("unharnessed-timed-fori", "fleet/bench.py", _UNHARNESSED)
    assert _seeded("unharnessed-timed-fori", "serve/bench.py", _UNHARNESSED)


def test_unharnessed_fori_harness_call_is_clean():
    ok = textwrap.dedent("""
        from dryad_tpu_torch.engine.probes import timed_fori

        def measure(step, args):
            ms, spread = timed_fori(step, 3, 2, *args, label="x")
            return ms
    """)
    assert not _seeded("unharnessed-timed-fori", "serve/bench.py", ok)


def test_unharnessed_fori_shipped_tree_clean_and_harness_out_of_scope():
    """The bench modules are clean, and the harness itself (where the
    discipline lives) is outside the rule's targets rather than waived."""
    assert not _violations("unharnessed-timed-fori").violations
    assert not _seeded("unharnessed-timed-fori", "engine/probes.py",
                       _UNHARNESSED)


# ---------------------------------------------------------------------------
# introspect-compile-only


def test_introspect_peak_reset_seeded_outside_introspect():
    hits = _seeded("introspect-compile-only", "engine/levelwise.py",
                   "\ndef _peek():\n"
                   "    torch.cuda.reset_peak_memory_stats()\n"
                   "    return torch.cuda.max_memory_allocated()\n")
    assert any("reset_peak_memory_stats" in v.message for v in hits)


def test_introspect_profiler_read_seeded_in_serve():
    hits = _seeded("introspect-compile-only", "serve/cache.py",
                   "\ndef _events(prof):\n"
                   "    return prof.profiler.kineto_results.events()\n")
    assert any("kineto_results" in v.message for v in hits)


def test_introspect_plain_memory_read_is_clean():
    # only the peak reset/read is the boundary's; a plain allocated-bytes
    # read is not introspection
    assert not _seeded("introspect-compile-only", "resilience/faults.py",
                       "\ndef _used():\n"
                       "    import torch\n"
                       "    return torch.cuda.memory_allocated()\n")


def test_introspect_capture_inside_graph_capture_seeded():
    hits = _seeded("introspect-compile-only", "serve/cache.py",
                   "\ndef _hot(g, fn, x):\n"
                   "    with torch.cuda.graph(g):\n"
                   "        introspect.capture('predict', ('k',), fn, x)\n")
    assert any("graph capture" in v.message for v in hits)


def test_introspect_expensive_call_in_loop_inside_introspect_py():
    assert _seeded("introspect-compile-only", "engine/introspect.py",
                   "\ndef _sweep(fns):\n"
                   "    out = []\n"
                   "    for fn in fns:\n"
                   "        out.append(torch.profiler.profile())\n"
                   "    return out\n")


def test_introspect_shipped_tree_clean():
    rep = _violations("introspect-compile-only")
    assert not rep.violations, "\n".join(v.format() for v in rep.violations)


# ---------------------------------------------------------------------------
# waiver machinery


def test_waiver_suppresses_and_is_counted():
    rep = _violations("batcher-device-fetch", {
        f"{PKG}/serve/batcher.py": _src("serve/batcher.py") + (
            "\ndef _f(x):\n"
            "    # dryadlint: disable=batcher-device-fetch -- fixture reason\n"
            "    return x.cpu()\n")})
    assert not _rule_hits(rep, "batcher-device-fetch")
    assert any(w.reason == "fixture reason" for _, w in rep.waived)


def test_waiver_without_reason_is_an_error():
    rep = LintReport()
    parse_waivers("x.py", "y = 1  # dryadlint: disable=some-rule\n", rep)
    assert rep.errors and "reason" in rep.errors[0]


def test_file_level_waiver_covers_whole_file():
    rep = _violations("batcher-device-fetch", {
        f"{PKG}/serve/batcher.py":
            "# dryadlint: disable-file=batcher-device-fetch -- fixture\n"
            + _src("serve/batcher.py")
            + "\ndef _f(x):\n    return x.cpu()\n"})
    assert not _rule_hits(rep, "batcher-device-fetch")
    assert rep.waived


def test_unknown_rule_name_rejected():
    with pytest.raises(ValueError):
        run_lint(ROOT, rule_names=["no-such-rule"])


# ---------------------------------------------------------------------------
# CLI


def test_cli_list_rules_and_lint_pass():
    from dryad_tpu_torch.analysis.__main__ import main

    assert main(["--list-rules"]) == 0
    assert main(["--lint", "-q"]) == 0


def test_cli_lint_failure_exit_code(tmp_path):
    # a minimal bad tree: exit code 2 distinguishes lint from census fails
    pkg = tmp_path / PKG / "obs"
    pkg.mkdir(parents=True)
    (pkg / "bad.py").write_text("import torch\n")
    from dryad_tpu_torch.analysis.__main__ import main

    assert main(["--lint", "-q", "--root", str(tmp_path)]) == 2


def test_cli_crashed_rule_exits_5(monkeypatch):
    """A rule that crashes is an internal error (5), never a pass."""
    from dryad_tpu_torch.analysis.__main__ import main
    from dryad_tpu_torch.analysis.lint import _REGISTRY, Rule, registry

    registry()          # every rule registered before the swap

    def boom(path, src, tree):
        raise RuntimeError("rule crashed")

    monkeypatch.setitem(_REGISTRY, "wired-grower-sort", Rule(
        "wired-grower-sort", "crashes", (f"{PKG}/engine/levelwise.py",),
        check=boom))
    assert main(["--lint", "-q", "--rule", "wired-grower-sort"]) == 5
