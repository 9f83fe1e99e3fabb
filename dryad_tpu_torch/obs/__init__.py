"""Host-side telemetry for the port's serving stack: the metric registry
(``registry``), stage spans (``spans``), the health state behind
``/healthz`` (``health``), the recompile tripwire (``tripwire``) and the
bearer check of the HTTP endpoints (``exporter``).

These are the parts of ``dryad_tpu/obs`` that serving uses, copied so the
port imports nothing of the reference.  Nothing here touches a device."""
