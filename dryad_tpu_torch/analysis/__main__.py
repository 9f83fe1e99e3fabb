"""CLI: ``python -m dryad_tpu_torch.analysis [--ci|--lint|--audit|
--concurrency|--update-goldens|--list-rules|--rule R|--drill D]``.

Exit codes (the reference's, ``dryad_tpu/analysis/__main__.py``):

    0  everything passed
    2  dryadlint violations (or malformed waivers, or the waiver count
       exceeding the committed budget, goldens/waiver_budget.json)
    3  op census invariant failure (kernel events, row-scale sorts,
       collectives against RowGroup.stats and comm_stats; on the card,
       counts against the CPU goldens and host syncs against the card's)
    4  census digest drift against the committed goldens
    5  internal error (a rule, an arm or a drill crashed: never "pass by
       crash")
    6  concurrency-contract violation: a guarded-by / no-blocking-under-
       lock / lock-order hit, or a schedule drill failure (invariant,
       deadlock or lock-order cycle)

``--update-goldens`` re-runs the arms and rewrites
``goldens/census.json`` (a subset with ``--arm`` merges); run it when a
program change is INTENTIONAL and commit the diff.  With ``--device
cuda`` the audit runs on the card: its counts are held against the CPU
goldens, and ``--update-goldens`` then writes the card section (host
syncs, stamped with the card's name and power limit); without ``--arm``
it also runs one headline tree (Higgs-10M's widths, depth 8) and writes
its entry, which ``chip_smoke.py`` phase 40 holds its tree against.  The
lock order (``goldens/lock_order.json``) and the waiver budget
(``goldens/waiver_budget.json``) are edited by hand, in the same diff as
the change that needs them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

WAIVER_BUDGET_PATH = "dryad_tpu_torch/analysis/goldens/waiver_budget.json"


def check_waiver_budget(n_waived: int, budget_path: str):
    """(ok, message): the waiver-count ratchet; growing the waiver set
    requires bumping the committed budget in the same diff."""
    try:
        with open(budget_path) as f:
            budget = int(json.load(f)["waivers"])
    except (OSError, ValueError, KeyError) as e:
        return False, f"waiver budget unreadable ({budget_path}): {e!r}"
    if n_waived > budget:
        return False, (
            f"waiver ratchet: {n_waived} waived > budget {budget} "
            f"({budget_path}): a new waiver is a review event; bump the "
            "budget in the same diff or fix the violation")
    slack = budget - n_waived
    note = (f"waivers {n_waived}/{budget}"
            + (f" (budget can ratchet down by {slack})" if slack else ""))
    return True, note


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dryad_tpu_torch.analysis",
        description="dryadlint + op census + concurrency harness "
                    "(see dryad_tpu_torch/analysis)")
    ap.add_argument("--ci", action="store_true",
                    help="run all three layers on the CPU")
    ap.add_argument("--lint", action="store_true", help="dryadlint only")
    ap.add_argument("--audit", action="store_true", help="op census only")
    ap.add_argument("--concurrency", action="store_true",
                    help="schedule-harness drills only")
    ap.add_argument("--update-goldens", action="store_true",
                    help="re-run the census arms and rewrite the goldens")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--rule", action="append", default=None,
                    help="restrict lint to the named rule(s)")
    ap.add_argument("--arm", action="append", default=None,
                    help="restrict the census to the named arm(s)")
    ap.add_argument("--drill", action="append", default=None,
                    help="restrict the concurrency drills by name")
    ap.add_argument("--schedules", type=int, default=None,
                    help="schedules per drill (default: each drill's own)")
    ap.add_argument("--device", default="cpu",
                    help="where the census arms run (cpu or cuda)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: the package's parent)")
    ap.add_argument("--goldens", default=None,
                    help="census goldens path override (tests)")
    ap.add_argument("--waiver-budget", default=None,
                    help="waiver budget path override (tests)")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    root = args.root or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    if args.list_rules:
        from dryad_tpu_torch.analysis.lint import registry

        for name, rule in sorted(registry().items()):
            print(f"{name:24s} {rule.doc}")
            print(f"{'':24s}   targets: {', '.join(rule.targets)}")
        return 0

    explicit = args.lint or args.audit or args.concurrency \
        or args.update_goldens
    do_lint = args.ci or args.lint or not explicit
    do_audit = args.ci or args.audit or args.update_goldens
    do_conc = args.ci or args.concurrency

    rc = 0
    try:
        if do_lint:
            from dryad_tpu_torch.analysis.concurrency import RULE_NAMES as CONC
            from dryad_tpu_torch.analysis.lint import run_lint

            report = run_lint(root, rule_names=args.rule)
            for v in report.violations:
                print("VIOLATION", v.format())
            for e in report.errors:
                print("ERROR", e)
            if not args.quiet:
                for v, w in report.waived:
                    print(f"waived   {v.path}:{v.line} [{v.rule}] -- "
                          f"{w.reason}")
            budget_path = args.waiver_budget or os.path.join(
                root, WAIVER_BUDGET_PATH)
            if args.waiver_budget is None and not os.path.exists(budget_path):
                # fixture roots (tests) carry no goldens: ratchet against
                # the package's committed budget
                budget_path = os.path.join(os.path.dirname(
                    os.path.abspath(__file__)), "goldens",
                    "waiver_budget.json")
            budget_ok, budget_msg = check_waiver_budget(
                len(report.waived), budget_path)
            if not budget_ok:
                print("ERROR", budget_msg)
            print(report.summary() + " | " + (budget_msg if budget_ok
                                              else "over budget"))
            if any(v.rule in CONC for v in report.violations):
                rc = max(rc, 6)
            if (not report.ok and any(v.rule not in CONC
                                      for v in report.violations)) \
                    or report.errors or not budget_ok:
                rc = max(rc, 2)

        if do_conc:
            from dryad_tpu_torch.analysis.schedules import run_ci_drills

            failures = run_ci_drills(schedules=args.schedules,
                                     quiet=args.quiet, drills=args.drill)
            for f in failures:
                print("CONCURRENCY FAIL", f)
            print(f"schedule harness: {len(failures)} failing drill(s)")
            if failures:
                rc = max(rc, 6)

        if do_audit:
            from dryad_tpu_torch.analysis.census import run_census

            audit = run_census(arm_names=args.arm,
                               goldens_path=args.goldens,
                               update_goldens=args.update_goldens,
                               device=args.device)
            for arm in audit.arms:
                c = arm.census
                print(f"arm {arm.name}: kernels={dict(c.kernels)} "
                      f"collectives={dict(c.collectives)} "
                      f"row_sorts={c.row_sorts} slot_sorts={c.slot_sorts} "
                      f"table_gathers={c.table_gathers} syncs={c.syncs} "
                      f"digest={c.digest[:12]}")
                for f in arm.failures:
                    print("  INVARIANT FAIL:", f)
            for d in audit.drift:
                print("DIGEST DRIFT:", d)
            for n in audit.notes:
                print("NOTE:", n)
            print(audit.summary())
            if args.update_goldens:
                from dryad_tpu_torch.analysis.digests import GOLDENS_PATH

                print("goldens written:", args.goldens or GOLDENS_PATH)
            if not audit.ok:
                rc = max(rc, 3)
            elif not audit.drift_ok:
                rc = max(rc, 4)
    except Exception:
        import traceback

        traceback.print_exc()
        return 5
    return rc


if __name__ == "__main__":
    sys.exit(main())
