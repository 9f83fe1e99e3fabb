"""Host-side telemetry of the port: the metric registry (``registry``),
stage spans and their trace sink (``spans``), Chrome trace export of the
span ring (``trace_export``), the health state behind ``/healthz``
(``health``), the recompile tripwire (``tripwire``), the fetch watchdog
(``watchdog``), the stage profiler's gauges (``profiler``), trend
reports (``trends``), the collective gauges (``comm``), the metrics
exporter and its bearer check (``exporter``), the run-journal tail
(``journal_tail``), model drift (``drift``) and latency SLO gates
(``slo``).

These are the counterparts of ``dryad_tpu/obs``, copied so the port
imports nothing of the reference.  Nothing here touches a device, and
``drift``, ``slo``, ``trace_export``, ``journal_tail`` and ``exporter``
import no torch."""
