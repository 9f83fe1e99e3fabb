"""Static and dynamic analysis of the port's measured invariants.

The counterpart of ``dryad_tpu/analysis``, in three layers and one CLI
(``python -m dryad_tpu_torch.analysis --ci``):

* **dryadlint** (``lint.py``, ``rules.py``, ``importgraph.py``): a
  stdlib-``ast`` rule engine over ``dryad_tpu_torch/``: no row sort and
  no tile plan on the wired growers, a torch-free and fetch-free serve
  batcher, a torch-free control plane (``obs/``, ``fleet/``,
  ``continual/``, ``policy/``, directly and transitively), dispatch gates
  read from the policy table, and the probe harness's timing hygiene.
  Violations are waivable per line with::

      # dryadlint: disable=RULE -- reason

  (the reason is mandatory; waivers are counted against
  ``goldens/waiver_budget.json``).
* **the op census** (``census.py``, ``digests.py``): each audited arm runs
  once, for real, at a small size under a ``TorchDispatchMode`` that
  counts what it dispatches: row-scale sorts, collectives (held against
  ``RowGroup.stats`` and ``train.comm_stats``), kernel events at the
  wrappers' boundaries, and on the card the host syncs; a canonical digest
  of each arm's op stream is pinned by ``goldens/census.json``.
* **the concurrency layer** (``concurrency.py``, ``schedules.py``): the
  guarded-by, no-blocking-under-lock and lock-order rules, and a
  deterministic schedule harness that drills the threaded host plane's
  recorded race classes.

Tests, the CLI and ``chip_smoke.py`` import this package; nothing on the
training or serving path does.
"""

from dryad_tpu_torch.analysis.lint import (  # noqa: F401
    LintReport,
    Rule,
    Violation,
    Waiver,
    registry,
    run_lint,
)
