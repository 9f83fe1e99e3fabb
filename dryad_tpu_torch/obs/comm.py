"""The collective accounting of a process-group run
(``engine/train.comm_stats``) as gauges: the counterpart of
``dryad_tpu/obs/comm.py``.

The engine computes the accounting, a pure function of the params, the
shape and the rank count, and hands the finished dict here once per run;
this module only records values.  Labels: ``growth`` (depthwise or
leafwise), ``arm`` (the resolved ``hist_reduce``, fused or feature) and
``shards`` (the rank count).

Series:

* ``dryad_comm_psum_bytes_per_iter``: the all-reduce payload per boosting
  iteration (on the feature arm only the roots ride it);
* ``dryad_comm_collective_calls_per_iter``: collective calls per iteration
  (all-reduce, reduce-scatter and the combine's all-gather);
* ``dryad_comm_reduce_scatter_bytes_per_iter``,
  ``dryad_comm_all_gather_bytes_per_iter`` and
  ``dryad_comm_collective_bytes_per_iter``: the feature arm's breakdown
  and the total a rank receives.
"""

from __future__ import annotations

from typing import Optional

from dryad_tpu_torch.obs.registry import Registry, default_registry

_GAUGES = (
    ("dryad_comm_psum_bytes_per_iter",
     "All-reduce histogram payload per boosting iteration (bytes)",
     "psum_bytes_per_iter"),
    ("dryad_comm_collective_calls_per_iter",
     "Collective calls per boosting iteration (all-reduce + rs + ag)",
     "collective_calls_per_iter"),
    ("dryad_comm_reduce_scatter_bytes_per_iter",
     "Feature-arm reduce-scatter payload per iteration (bytes a rank)",
     "reduce_scatter_bytes_per_iter"),
    ("dryad_comm_all_gather_bytes_per_iter",
     "Feature-arm combine all-gather payload per iteration (bytes)",
     "all_gather_bytes_per_iter"),
    ("dryad_comm_collective_bytes_per_iter",
     "Total collective payload a rank receives per iteration (bytes)",
     "collective_bytes_per_iter"),
)


def export_comm_stats(comm: dict, *, growth: str,
                      registry: Optional[Registry] = None) -> int:
    """Record one training run's collective accounting; returns the number
    of series set (0 on a disabled registry)."""
    reg = registry if registry is not None else default_registry()
    if not reg.enabled or not comm:
        return 0
    labels = dict(growth=growth,
                  arm=str(comm.get("hist_reduce", "fused")),
                  shards=int(comm.get("n_shards", 1)))
    n = 0
    for name, doc, key in _GAUGES:
        if key in comm:
            reg.gauge(name, doc).labels(**labels).set(float(comm[key]))
            n += 1
    return n
