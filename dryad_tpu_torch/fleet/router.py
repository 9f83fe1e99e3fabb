"""Health-routed HTTP front door for a replica fleet.

A thin stdlib router in front of the supervisor's slots: requests land
here, get admission-controlled, and are forwarded over plain HTTP to one
healthy replica.  The router holds NO model state and never imports
torch (the fleet package is torch-free) — it is deliberately the
smallest thing that can make N shared-nothing serve processes look like
one endpoint.

Routing and degradation, in order:

1. **Admission (priority shedding).**  Each request carries a priority
   class (``X-Dryad-Priority: interactive|bulk``; default interactive;
   the body stays opaque bytes — a body ``"priority"`` is honored only
   when a per-model cap already forces a body parse).  Bulk
   sheds FIRST: when total in-flight reaches ``bulk_max_inflight`` new
   bulk requests get 503 while interactive traffic still flows; at
   ``max_inflight`` everything sheds.  Optional per-model caps
   (``model_caps``) bound any one model's in-flight share the same way.
   This is LAYERED ON the per-replica micro-batcher queue: the router
   bounds what enters the fleet, each replica's bounded queue
   (``ServeOverloaded`` -> 503) remains the final backstop.
2. **Routing.**  Round-robin over routable slots (healthy, not draining,
   not failed closed) — the supervisor's monitor updates that set, the
   router just reads it.
3. **Retry.**  A forwarded request that dies on the wire (connect error,
   timeout) or answers 5xx is retried EXACTLY ONCE against a different
   routable replica.  One retry is the whole budget: the recorded
   fleet drills (crash mid-request, stuck-503) need exactly one, and
   unbounded retries would amplify overload into a retry storm.

Observability: ``/metrics`` serves the router's own ``dryad_fleet_*``
series PLUS every live replica's scrape, each sample relabeled with
``replica="rN"`` — one endpoint scrapes the whole fleet — and
``dryad_fleet_latency_ms{priority,stage,q}`` gauges: fleet-wide
p50/p95/p99 computed by EXACT count-merge of the replicas'
fixed-log-bucket ``dryad_request_latency_seconds`` histograms (scraped
as JSON from each replica's ``/obs``) plus the router's own
stage="router" series.  ``/healthz`` (auth-exempt, like every other
healthz in this repo) answers 200 while at least ``min_healthy``
replicas are routable AND no per-priority p99 SLO budget is in
sustained breach (obs/slo.py; verdicts ride the payload).  ``/stats``
returns the JSON view (slot states + shed/retry counters).  Model
drift: each replica's ``/obs`` answer also carries its raw drift-window
bin counts (serve-side ``DriftMonitor``); the router merges the COUNTS
per model bitwise (never PSI values or ratios), computes fleet-wide PSI
once on the merged state, serves ``dryad_fleet_drift_*`` gauges on
``/metrics`` and a ``GET /drift`` JSON report, and a DriftGate turns a
SUSTAINED breach into a journaled ``drift_breach`` + a ``drift:<model>``
warning in /healthz payloads (warn-only: a drifted model still serves —
the event is the retrain/rollback trigger, not an outage).  ``/trace``
assembles the fleet-wide Chrome trace: router spans, every live
replica's span ring clock-aligned by the registration-time offset
handshake, and the supervisor journal as an annotation track —
tail-sampled to the slowest ``?k=`` requests per window.  Request
tracing: the router mints (or honors) ``X-Dryad-Trace`` per /predict,
forwards it to the replica, echoes it on the response, and records every
forward ATTEMPT as a trace-tagged span, so a request that survives a
replica crash shows both attempts under one id.  Bearer auth reuses the
obs exporter's scheme.
"""

from __future__ import annotations

import http.client
import json
import re
import socket
import sys
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from dryad_tpu_torch.obs.drift import (DriftGate, drift_report,
                                       merge_drift_states)
from dryad_tpu_torch.obs.exporter import authorized, send_unauthorized
from dryad_tpu_torch.obs.health import HealthState
from dryad_tpu_torch.obs.registry import (LOG_BUCKETS, REQUEST_LATENCY,
                                          Registry, default_registry,
                                          hist_quantile, merge_hist_states)
from dryad_tpu_torch.obs.slo import SloGate
from dryad_tpu_torch.obs.spans import record_at
from dryad_tpu_torch.obs.trace_export import (TailSampler, active_trace,
                                              dumps_fleet_trace,
                                              tracing_active)

PRIORITIES = ("interactive", "bulk")
TRACE_HEADER = "X-Dryad-Trace"
#: statuses that count as "this replica failed us" for the single retry
RETRYABLE_STATUSES = (500, 502, 503, 504)
#: hop-by-hop / recomputed headers never forwarded either direction
_SKIP_HEADERS = {"host", "content-length", "connection", "transfer-encoding",
                 "keep-alive"}
#: label parser for registry label blocks ('priority="bulk",stage="total"')
_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')


def relabel_exposition(text: str, replica: str) -> str:
    """Inject ``replica="rN"`` into every sample line of a Prometheus
    text exposition.  Comment lines (# HELP/# TYPE) are dropped — N
    replicas would repeat them per family, which scrapers reject."""
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        # sample shape: name[{labels}] value [timestamp]
        brace = line.find("{")
        space = line.find(" ")
        if brace != -1 and (space == -1 or brace < space):
            out.append(line[:brace + 1] + f'replica="{replica}",'
                       + line[brace + 1:])
        elif space != -1:
            out.append(f'{line[:space]}{{replica="{replica}"}}{line[space:]}')
    return "\n".join(out) + ("\n" if out else "")


class _RouterState:
    """Everything the handler threads share (rides on the HTTP server).
    ``_lock`` guards the admission ledger (total + per-model in-flight)
    and the round-robin cursor; admit/release are single short critical
    sections so shedding decisions are atomic against concurrent handler
    threads, and no forward/scrape I/O ever happens under it."""

    GUARDED_BY = {"_inflight_total": "_lock", "_inflight_model": "_lock",
                  "_inflight_priority": "_lock",
                  "_rr": "_lock", "_slo_last": "_lock"}

    def __init__(self, supervisor, *, registry: Optional[Registry],
                 max_inflight: int, bulk_max_inflight: Optional[int],
                 model_caps: Optional[dict], request_timeout_s: float,
                 min_healthy: int, auth_token: Optional[str],
                 slo_budgets_ms: Optional[dict] = None,
                 slo_quantile: float = 0.99, slo_breach_after: int = 3,
                 tail_window: int = 512, tail_keep: int = 16,
                 drift_budget_psi: Optional[float] = None,
                 drift_breach_after: int = 2, drift_top_k: int = 5):
        self.supervisor = supervisor
        self.registry = (registry if registry is not None
                         else default_registry())
        # request-scoped observability: the tail sampler feeds the
        # merged /trace (full detail for the slowest requests per
        # window), the SLO gate turns per-priority p99 budgets into
        # /healthz verdicts.  The gate gets its OWN health state so a
        # sustained breach degrades THIS router's /healthz, not the
        # process-global surface another subsystem may be serving.
        self.sampler = TailSampler(window=tail_window)
        self.tail_keep = int(tail_keep)
        self.slo_health = HealthState(registry=self.registry)
        self.slo = SloGate(slo_budgets_ms, quantile=slo_quantile,
                           breach_after=slo_breach_after,
                           registry=self.registry, health=self.slo_health)
        self._slo_last: dict[str, tuple] = {}
        # drift verdicts (obs/drift.py): WARN-ONLY by default — a
        # drifted model keeps serving; a sustained breach journals
        # ``drift_breach`` through the supervisor (the continual-
        # boosting retrain/rollback trigger) and rides /healthz PAYLOADS
        # as a ``drift:<model>`` warning.  None disables the layer.
        self.drift_top_k = int(drift_top_k)
        self.drift = (None if drift_budget_psi is None else DriftGate(
            float(drift_budget_psi), breach_after=drift_breach_after,
            registry=self.registry, on_breach=self._journal_drift_breach))
        self.max_inflight = int(max_inflight)
        self.bulk_max_inflight = (int(bulk_max_inflight)
                                  if bulk_max_inflight is not None
                                  else max(1, self.max_inflight // 2))
        if not 0 < self.bulk_max_inflight <= self.max_inflight:
            raise ValueError("need 0 < bulk_max_inflight <= max_inflight "
                             "(bulk sheds first, never last)")
        self.model_caps = {str(k): int(v)
                           for k, v in (model_caps or {}).items()}
        self.request_timeout_s = float(request_timeout_s)
        self.min_healthy = int(min_healthy)
        self.auth_token = auth_token
        self._lock = threading.Lock()
        self._inflight_total = 0
        self._inflight_model: dict[str, int] = {}
        self._inflight_priority: dict[str, int] = {p: 0
                                                   for p in PRIORITIES}
        self._rr = 0
        # the capacity loop (fleet/autoscale.py), when the CLI arms one;
        # purely observational here — /stats surfaces its state
        self.autoscale = None

    # ---- admission ---------------------------------------------------------
    def admit(self, priority: str, model: Optional[str]) -> Optional[str]:
        """Take an admission slot, or return the refusal reason.  The
        caller MUST pair a None return with a later ``release``."""
        with self._lock:
            if self._inflight_total >= self.max_inflight:
                return "fleet at max_inflight"
            if (priority == "bulk"
                    and self._inflight_total >= self.bulk_max_inflight):
                return "bulk shed (fleet beyond bulk_max_inflight)"
            if model is not None and model in self.model_caps:
                if (self._inflight_model.get(model, 0)
                        >= self.model_caps[model]):
                    return f"model {model!r} at its admission cap"
            self._inflight_total += 1
            self._inflight_priority[priority] = (
                self._inflight_priority.get(priority, 0) + 1)
            if model is not None:
                self._inflight_model[model] = (
                    self._inflight_model.get(model, 0) + 1)
            return None

    def release(self, priority: str, model: Optional[str]) -> None:
        with self._lock:
            self._inflight_total -= 1
            self._inflight_priority[priority] = (
                self._inflight_priority.get(priority, 1) - 1)
            if model is not None:
                self._inflight_model[model] = (
                    self._inflight_model.get(model, 1) - 1)

    @property
    def inflight_total(self) -> int:
        with self._lock:
            return self._inflight_total

    def inflight_by_priority(self) -> dict:
        with self._lock:
            return dict(self._inflight_priority)

    # ---- slot choice -------------------------------------------------------
    def pick(self, exclude=()) -> Optional[object]:
        slots = [s for s in self.supervisor.routable_slots()
                 if s.name not in exclude]
        if not slots:
            return None
        with self._lock:
            self._rr += 1
            return slots[self._rr % len(slots)]

    # ---- metrics helpers ---------------------------------------------------
    def count(self, name: str, help: str, **labels) -> None:
        if self.registry.enabled:
            fam = self.registry.counter(name, help)
            (fam.labels(**labels) if labels else fam).inc()

    def gauge_inflight(self) -> None:
        """Live admission-depth gauges: per-priority fleet depth
        plus each slot's router-side in-flight count — the numbers the
        capacity loop steers on, exported so operators read the same
        signal the controller does."""
        if not self.registry.enabled:
            return
        with self._lock:
            per = dict(self._inflight_priority)
            total = self._inflight_total
        fam = self.registry.gauge(
            "dryad_fleet_inflight",
            "Requests currently inside the fleet, by priority class")
        for priority in PRIORITIES:
            fam.labels(priority=priority).set(per.get(priority, 0))
        fam.labels(priority="total").set(total)
        slot_fam = self.registry.gauge(
            "dryad_fleet_slot_inflight",
            "Router-side in-flight requests per replica slot")
        for s in self.supervisor.slots:
            slot_fam.labels(replica=s.name).set(s.inflight)

    def capacity_signals(self) -> dict:
        """The autoscaler's one-call view of the router: a fresh
        SLO window evaluation (the gate's streaks advance — sustained
        semantics are shared with /healthz), the admission ledger, and
        per-slot in-flight.  Torch-free, scrape-free, one short critical
        section."""
        slo = self.evaluate_slo()
        with self._lock:
            per = dict(self._inflight_priority)
            total = self._inflight_total
        return {
            "slo": slo,
            "inflight": total,
            "inflight_priority": per,
            "max_inflight": self.max_inflight,
            "slots": {s.name: {"inflight": s.inflight,
                               "routable": s.routable,
                               "retiring": s.retiring}
                      for s in self.supervisor.slots},
        }

    # ---- drift -------------------------------------------------------------
    def _journal_drift_breach(self, model: str, verdict: dict) -> None:
        """DriftGate's on_breach: one journal line per NEW sustained
        breach, in the supervisor's flight recorder next to crashes and
        swaps (stub supervisors without a journal are skipped)."""
        jr = getattr(self.supervisor, "journal", None)
        if jr is not None:
            jr("drift_breach", model=model,
               psi_max=verdict.get("psi_max"),
               score_psi=verdict.get("score_psi"),
               features_over=verdict.get("features_over"),
               features=[t["feature"] for t in verdict.get("top", [])],
               streak=verdict.get("streak"))
        self.count("dryad_fleet_drift_breach_total",
                   "Sustained fleet drift breaches journaled", model=model)

    def update_drift(self, blocks: list) -> dict:
        """Fold per-replica drift blocks (each ``{model: export_state}``)
        into fleet verdicts: counts are merged EXACTLY per model (the
        histogram discipline — merge counts, never PSI values), PSI
        runs once on the merged state, ``dryad_fleet_drift_*`` gauges
        mirror it, and the gate advances its sustained-breach streaks.
        Runs on the scrape cadence (/metrics and /drift), never inside
        /healthz — the health path stays scrape-free and reads the
        LATCHED verdicts."""
        if self.drift is None:
            return {}
        per_model: dict[str, list] = {}
        for block in blocks:
            if not isinstance(block, dict):
                continue
            for model, st in block.items():
                per_model.setdefault(str(model), []).append(st)
        reports: dict = {}
        for model, sts in sorted(per_model.items()):
            try:
                merged = merge_drift_states(sts)
            except ValueError:
                # a malformed or mixed-version replica block must not
                # kill the whole fleet scrape — skip it, on the record
                self.count("dryad_fleet_drift_merge_error_total",
                           "Replica drift blocks that failed the exact "
                           "merge", model=model)
                continue
            reports[model] = drift_report(
                merged, budget_psi=self.drift.budget_psi,
                top_k=self.drift_top_k)
        if self.registry.enabled:
            fam = self.registry.gauge(
                "dryad_fleet_drift_psi",
                "Fleet-merged per-feature PSI, top offenders")
            for model, r in reports.items():
                for name, key in (("dryad_fleet_drift_psi_max", "psi_max"),
                                  ("dryad_fleet_drift_score_psi",
                                   "score_psi"),
                                  ("dryad_fleet_drift_rows", "rows"),
                                  ("dryad_fleet_drift_features_over",
                                   "features_over")):
                    self.registry.gauge(
                        name, "Fleet-merged drift telemetry").labels(
                        model=model).set(float(r.get(key, 0)))
                for item in r["top"]:
                    fam.labels(model=model,
                               feature=item["feature"]).set(item["psi"])
        return self.drift.evaluate(reports)

    def evaluate_slo(self) -> dict:
        """One SLO evaluation pass from the router's OWN per-priority
        end-to-end histograms (stage="router" covers queueing, retries
        and the replica — every request traverses this process, so the
        local series already IS fleet-wide).  Called on the /healthz
        cadence; deliberately no replica scrape in the health path.

        The gate sees the WINDOW since the previous evaluation (the
        delta of the cumulative series — counts subtract exactly), not
        the lifetime state: cumulative history would both mask a fresh
        regression after long uptime and keep one past slow burst
        breaching forever."""
        fam = self.registry.log_histogram(
            REQUEST_LATENCY,
            "Request latency by priority class and pipeline stage")
        windows: dict = {}
        # snapshot AND delta under _lock: /healthz is polled by several
        # probers concurrently, and an out-of-order commit to _slo_last
        # would hand the gate a negative window (which could spuriously
        # clear a sustained breach).  The family reads take each
        # family's own lock inside ours — that order never inverts
        # (registry code never acquires router state locks).
        with self._lock:
            for priority in self.slo.budgets_ms:
                counts, total, n = fam.labels(priority=priority,
                                              stage="router").value()
                last = self._slo_last.get(priority)
                if last is None:
                    windows[priority] = (counts, total, n)
                else:
                    lc, lt, ln = last
                    windows[priority] = (
                        [a - b for a, b in zip(counts, lc)],
                        total - lt, n - ln)
                self._slo_last[priority] = (counts, total, n)
        return self.slo.evaluate(windows)


class _Handler(BaseHTTPRequestHandler):
    # the _RouterState rides on the server object (see make_fleet_router)

    def log_message(self, fmt, *args):  # quiet by default
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _send(self, code: int, payload: dict,
              extra_headers: Optional[dict] = None) -> None:
        self._send_raw(code, json.dumps(payload).encode(),
                       "application/json", extra_headers)

    def _send_raw(self, code: int, body: bytes, ctype: str,
                  extra_headers: Optional[dict] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if extra_headers:
            for k, v in extra_headers.items():
                self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _authorized(self) -> bool:
        if authorized(self, self.server.state.auth_token):
            return True
        send_unauthorized(self)
        return False

    # ---- GET ---------------------------------------------------------------
    def do_GET(self):  # noqa: N802 — stdlib handler API
        state: _RouterState = self.server.state
        if self.path == "/healthz":
            states = state.supervisor.states()
            fleet_ok = state.supervisor.fleet_ok(state.min_healthy)
            # SLO verdicts ride the health probe's cadence: a SUSTAINED
            # per-priority p99 breach degrades the router like a lost
            # replica would — latency budgets are part of "healthy"
            slo = state.evaluate_slo()
            ok = fleet_ok and state.slo_health.ok
            payload = {"ok": ok, "replicas": states, "slo": slo,
                       "degraded": sorted(state.slo_health.reasons())}
            if state.drift is not None:
                # drift verdicts are WARN-ONLY: the payload surfaces
                # ``drift:<model>`` (latched on the scrape cadence — no
                # replica scrape ever runs in the health path) but the
                # status code stays governed by replicas + SLO
                payload["drift"] = {
                    "warnings": state.drift.warnings(),
                    "models": state.drift.verdicts()}
            self._send(200 if ok else 503, payload)
            return
        if not self._authorized():
            return
        if self.path == "/metrics":
            self._send_raw(200, self._aggregate_metrics().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
        elif self.path == "/stats":
            self._send(200, {
                "replicas": state.supervisor.states(),
                "inflight": state.inflight_total,
                "inflight_priority": state.inflight_by_priority(),
                "max_inflight": state.max_inflight,
                "bulk_max_inflight": state.bulk_max_inflight,
                "model_caps": state.model_caps,
                "autoscale": (state.autoscale.state()
                              if state.autoscale is not None else None),
                "fleet": state.registry.snapshot(),
            })
        elif self.path == "/trace" or self.path.startswith("/trace?"):
            self._send_raw(200, self._merged_trace().encode(),
                           "application/json")
        elif self.path == "/drift" or self.path.startswith("/drift?"):
            self._send(200, self._drift_report())
        else:
            self._send(404, {"error": f"unknown path {self.path}"})

    def _aggregate_metrics(self) -> str:
        state: _RouterState = self.server.state
        state.gauge_inflight()
        # replica /metrics honors the same bearer auth as ours — an authed
        # fleet must not silently lose every per-replica series
        headers = ({"Authorization": f"Bearer {state.auth_token}"}
                   if state.auth_token else {})
        live = [s for s in state.supervisor.slots
                if s.proc is not None and s.proc.alive
                and s.proc.host is not None]
        results: dict[str, str] = {}
        obs_blocks: dict[str, dict] = {}
        drift_blocks: dict[str, dict] = {}

        def scrape(slot) -> None:
            # ONE ~4 s budget covers BOTH requests to this slot, so the
            # join below (4.5 s) always outlives the thread — a replica
            # slow on /metrics cannot push its /obs answer past the
            # join and get silently dropped from the merged gauges
            deadline = time.monotonic() + 4.0
            try:
                status, body = slot.proc.request("GET", "/metrics",
                                                 headers=headers,
                                                 timeout_s=2.0)
            except OSError:
                status, body = None, b""
            if status == 200:
                results[slot.name] = relabel_exposition(
                    body.decode(errors="replace"), slot.name)
            else:
                state.count("dryad_fleet_scrape_error_total",
                            "Replica /metrics scrapes that failed",
                            replica=slot.name)
            # the exact-merge feed: the replica's histogram counts as
            # JSON (/obs).  Optional — a stub replica without /obs just
            # contributes nothing to the merged percentiles.
            try:
                status, body = slot.proc.request(
                    "GET", "/obs", headers=headers,
                    timeout_s=max(0.2, deadline - time.monotonic()))
                if status == 200:
                    doc = json.loads(body)
                    block = doc.get("histograms", {}).get(REQUEST_LATENCY)
                    if block:
                        obs_blocks[slot.name] = block
                    # the drift counts ride the same /obs answer
                    dblock = doc.get("drift")
                    if isinstance(dblock, dict) and dblock:
                        drift_blocks[slot.name] = dblock
            except (OSError, ValueError):
                pass

        # concurrent scrapes: one hung replica costs the whole request
        # its OWN per-slot budget (~4 s), not that much per sick slot
        threads = [threading.Thread(target=scrape, args=(s,), daemon=True)
                   for s in live]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=4.5)
        self._merged_latency_gauges(state, list(obs_blocks.values()))
        state.update_drift(list(drift_blocks.values()))
        parts = [state.registry.exposition()]
        parts += [results[s.name] for s in live if s.name in results]
        return "".join(parts)

    @staticmethod
    def _merged_latency_gauges(state: "_RouterState",
                               blocks: list) -> None:
        """Fold the replicas' request-latency histograms into fleet-wide
        per-(priority, stage) p50/p95/p99 gauges by EXACT count-merge
        (the fixed log-bucket layout makes the merged histogram equal
        the histogram of the concatenated observations).  The router's
        own stage="router" series joins through the same path."""
        if not state.registry.enabled:
            return
        own = state.registry.snapshot()["histograms"].get(
            REQUEST_LATENCY, {})
        n_bounds = len(LOG_BUCKETS) + 1
        series: dict[str, list] = {}
        for block in [own] + blocks:
            if not isinstance(block, dict):
                continue
            for lbl, st in block.items():
                # defensive shape check: a malformed or mixed-version
                # replica block (wrong keys, different bucket layout)
                # is SKIPPED, never allowed to raise out of /metrics —
                # one bad replica must not kill the whole fleet scrape
                try:
                    counts = list(st["counts"])
                    entry = (counts, float(st["sum"]), int(st["count"]))
                except (TypeError, KeyError, ValueError):
                    continue
                if len(counts) != n_bounds:
                    continue
                series.setdefault(str(lbl), []).append(entry)
        fam = state.registry.gauge(
            "dryad_fleet_latency_ms",
            "Fleet-wide latency quantiles by priority/stage "
            "(exact histogram merge across replicas)")
        for lbl, sts in series.items():
            counts, _total, n = merge_hist_states(sts)
            labels = dict(_LABEL_RE.findall(lbl))
            if not n or "priority" not in labels:
                continue
            for q, name in ((0.50, "p50"), (0.95, "p95"), (0.99, "p99")):
                fam.labels(q=name, **labels).set(
                    hist_quantile(counts, q) * 1e3)

    def _merged_trace(self) -> str:
        """The fleet-wide Chrome trace: the router's span ring, every
        live replica's ring (clock-aligned by the registration-time
        offset handshake, falling back to the replica's self-reported
        wall−perf pair), and the supervisor journal as an annotation
        track.  Tail-sampled: full span detail only for the slowest
        ``?k=`` requests in the sampler window (default the router's
        ``tail_keep``; ``k=0`` keeps everything)."""
        state: _RouterState = self.server.state
        params = urllib.parse.parse_qs(
            urllib.parse.urlparse(self.path).query)
        try:
            k = int(params.get("k", [state.tail_keep])[0])
        except ValueError:
            k = state.tail_keep
        keep = state.sampler.slowest(k) if k > 0 else None
        tracks: list = []
        buf = active_trace()
        if buf is not None:
            # one wall−perf sample maps this process's whole ring: the
            # perf_counter origin is constant for the process lifetime
            tracks.append({"pid": 1, "name": "fleet router",
                           "events": buf.events(),
                           "offset_s": time.time() - time.perf_counter()})
        headers = ({"Authorization": f"Bearer {state.auth_token}"}
                   if state.auth_token else {})
        live = [s for s in state.supervisor.slots
                if s.proc is not None and s.proc.alive
                and s.proc.host is not None]
        results: dict[str, tuple] = {}

        def scrape(slot) -> None:
            try:
                status, body = slot.proc.request("GET", "/trace/events",
                                                 headers=headers,
                                                 timeout_s=3.0)
                if status != 200:
                    return
                doc = json.loads(body)
            except (OSError, ValueError):
                return
            offset = slot.clock_offset
            clock = doc.get("clock") or {}
            if offset is None and "wall_s" in clock and "perf_s" in clock:
                offset = float(clock["wall_s"]) - float(clock["perf_s"])
            results[slot.name] = (doc.get("events") or [], offset)

        threads = [threading.Thread(target=scrape, args=(s,), daemon=True)
                   for s in live]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=4.0)
        for slot in live:
            if slot.name in results:
                events, offset = results[slot.name]
                tracks.append({"pid": 10 + slot.index,
                               "name": f"replica {slot.name}",
                               "events": events, "offset_s": offset})
        journal_events: list = []
        journal_path = getattr(state.supervisor, "journal_path", None)
        if journal_path:
            from dryad_tpu_torch.resilience.journal import RunJournal

            try:
                journal_events = RunJournal.read(journal_path)
            except (OSError, ValueError):
                journal_events = []
        return dumps_fleet_trace(tracks, journal_events, keep)

    def _drift_report(self) -> dict:
        """``GET /drift``: a fresh concurrent ``/obs`` scrape of the
        live replicas, the per-model EXACT count-merge, PSI on the
        merged state, and the gate's sustained-breach verdicts — the
        operator's one-call answer to "does serving traffic still look
        like the training data"."""
        state: _RouterState = self.server.state
        if state.drift is None:
            return {"enabled": False}
        headers = ({"Authorization": f"Bearer {state.auth_token}"}
                   if state.auth_token else {})
        live = [s for s in state.supervisor.slots
                if s.proc is not None and s.proc.alive
                and s.proc.host is not None]
        blocks: dict[str, dict] = {}

        def scrape(slot) -> None:
            try:
                status, body = slot.proc.request("GET", "/obs",
                                                 headers=headers,
                                                 timeout_s=3.0)
                if status != 200:
                    return
                dblock = json.loads(body).get("drift")
                if isinstance(dblock, dict) and dblock:
                    blocks[slot.name] = dblock
            except (OSError, ValueError):
                pass

        threads = [threading.Thread(target=scrape, args=(s,), daemon=True)
                   for s in live]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=3.5)
        verdicts = state.update_drift(list(blocks.values()))
        return {
            "enabled": True,
            "budget_psi": state.drift.budget_psi,
            "breach_after": state.drift.breach_after,
            "replicas": sorted(blocks),
            "models": verdicts,
            "warnings": state.drift.warnings(),
        }

    # ---- POST --------------------------------------------------------------
    def do_POST(self):  # noqa: N802 — stdlib handler API
        if not self._authorized():
            return
        state: _RouterState = self.server.state
        try:
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            if self.path == "/predict":
                self._route_predict(body)
            elif self.path == "/models/push":
                spec = json.loads(body or b"{}")
                result = state.supervisor.rolling_push(
                    spec["path"], name=spec.get("name"),
                    activate=bool(spec.get("activate", True)),
                    auth_token=state.auth_token)
                self._send(200 if not result["errors"] else 502, result)
            else:
                self._send(404, {"error": f"unknown path {self.path}"})
        except (KeyError, ValueError) as e:
            self._send(400, {"error": repr(e)})
        except Exception as e:  # noqa: BLE001 — surface, don't kill the router
            self._send(500, {"error": repr(e)})

    def _priority_and_model(self, body: bytes) -> tuple[str, Optional[str]]:
        """Priority from the ``X-Dryad-Priority`` header; the body stays
        opaque bytes on the default path (parsing MB-scale bulk payloads
        at the router just to read one key would double the JSON cost of
        every request).  Only a configured per-model cap forces a body
        parse (the model name lives there unless ``X-Dryad-Model`` is
        set), and THAT parse also honors a body ``"priority"`` as a
        convenience — header-less priority classing without model caps
        defaults to interactive."""
        state: _RouterState = self.server.state
        priority = (self.headers.get("X-Dryad-Priority") or "").lower()
        model = self.headers.get("X-Dryad-Model")
        if state.model_caps and model is None and body:
            try:
                doc = json.loads(body)
                priority = priority or str(doc.get("priority", "")).lower()
                model = doc.get("model")
            except ValueError:
                pass
        if priority not in PRIORITIES:
            priority = "interactive"
        return priority, model

    def _route_predict(self, body: bytes) -> None:
        state: _RouterState = self.server.state
        priority, model = self._priority_and_model(body)
        # trace context: honor a client-supplied id, mint one while
        # tracing is on (minting rides the traced path only — with
        # tracing off an id-less request stays allocation-free)
        trace = self.headers.get(TRACE_HEADER)
        if trace is None and tracing_active(state.registry):
            trace = uuid.uuid4().hex[:16]
        state.count("dryad_fleet_request_total",
                    "Requests entering the fleet router",
                    priority=priority)
        reason = state.admit(priority, model)
        if reason is not None:
            state.count("dryad_fleet_shed_total",
                        "Requests shed by fleet admission control",
                        priority=priority)
            self._send(503, {"error": f"shed: {reason}",
                             "priority": priority},
                       extra_headers=({TRACE_HEADER: trace}
                                      if trace else None))
            return
        t0 = time.perf_counter()
        try:
            status, payload, replica = self._forward(body, trace)
            if status is None:
                self._send(503, {"error": "no healthy replica"},
                           extra_headers=({TRACE_HEADER: trace}
                                          if trace else None))
                return
            self._send_raw(status, payload, "application/json",
                           extra_headers=({TRACE_HEADER: trace}
                                          if trace else None))
            if state.registry.enabled:
                dur = time.perf_counter() - t0
                # the mergeable per-priority family (stage="router" is
                # the fleet-wide end-to-end view — every request passes
                # here); the span ring gets the trace-tagged request
                # span; the tail sampler ranks it for /trace detail
                state.registry.log_histogram(
                    REQUEST_LATENCY,
                    "Request latency by priority class and pipeline "
                    "stage").labels(
                    priority=priority, stage="router").observe(dur)
                record_at("fleet.request", t0, dur, trace=trace,
                          registry=state.registry)
                state.sampler.observe(trace, dur)
                if replica is not None:
                    state.count("dryad_fleet_routed_total",
                                "Requests served, by replica",
                                replica=replica)
        finally:
            state.release(priority, model)

    def _forward(self, body: bytes, trace: Optional[str] = None):
        """Forward to one routable replica; retry once elsewhere on a
        wire failure or 5xx.  Returns (status, payload, replica_name) —
        status None when no replica was available at all.  Every attempt
        — including the failed one a retry follows — records a
        trace-tagged ``fleet.forward/<replica>`` span, so a request that
        survives a replica crash shows BOTH attempts under one id in the
        merged trace."""
        state: _RouterState = self.server.state
        headers = {k: v for k, v in self.headers.items()
                   if k.lower() not in _SKIP_HEADERS}
        headers["Content-Type"] = "application/json"
        if trace is not None:
            headers[TRACE_HEADER] = trace
        tried: list[str] = []
        last: Optional[tuple] = None
        for attempt in (0, 1):
            slot = state.pick(exclude=tried)
            if slot is None:
                break
            tried.append(slot.name)
            if attempt == 1:
                state.count("dryad_fleet_retry_total",
                            "Requests retried on a second replica")
            slot.inflight_inc()
            if not slot.routable:
                # closed the pick->inc window: a drain (rolling swap) or
                # health flip between pick() and the in-flight mark must
                # not slip this request onto the slot — the drain's
                # inflight==0 wait reads the count AFTER the flag
                slot.inflight_dec()
                continue
            t_a = time.perf_counter()
            try:
                conn = http.client.HTTPConnection(
                    slot.proc.host, slot.proc.port,
                    timeout=state.request_timeout_s)
                try:
                    conn.request("POST", "/predict", body=body,
                                 headers=headers)
                    resp = conn.getresponse()
                    status, payload = resp.status, resp.read()
                finally:
                    conn.close()
            except (OSError, http.client.HTTPException, socket.timeout):
                state.count("dryad_fleet_upstream_error_total",
                            "Forwards that died on the wire",
                            replica=slot.name)
                record_at(f"fleet.forward/{slot.name}", t_a,
                          time.perf_counter() - t_a, trace=trace,
                          registry=state.registry)
                last = (502, json.dumps(
                    {"error": f"replica {slot.name} unreachable"}).encode(),
                    slot.name)
                continue
            finally:
                slot.inflight_dec()
            record_at(f"fleet.forward/{slot.name}", t_a,
                      time.perf_counter() - t_a, trace=trace,
                      registry=state.registry)
            if status in RETRYABLE_STATUSES:
                state.count("dryad_fleet_upstream_5xx_total",
                            "5xx answers from replicas",
                            replica=slot.name)
                last = (status, payload, slot.name)
                continue
            return status, payload, slot.name
        if last is not None:
            return last
        return None, b"", None


def make_fleet_router(supervisor, host: str = "127.0.0.1", port: int = 0, *,
                      registry: Optional[Registry] = None,
                      max_inflight: int = 64,
                      bulk_max_inflight: Optional[int] = None,
                      model_caps: Optional[dict] = None,
                      request_timeout_s: float = 30.0,
                      min_healthy: int = 1,
                      auth_token: Optional[str] = None,
                      verbose: bool = False,
                      slo_budgets_ms: Optional[dict] = None,
                      slo_quantile: float = 0.99,
                      slo_breach_after: int = 3,
                      tail_window: int = 512,
                      tail_keep: int = 16,
                      drift_budget_psi: Optional[float] = None,
                      drift_breach_after: int = 2,
                      drift_top_k: int = 5) -> ThreadingHTTPServer:
    """Bind the fleet router (port 0 picks a free one; read it back from
    ``httpd.server_address``); the caller runs ``serve_forever()`` /
    ``shutdown()``, exactly like ``serve.http.make_http_server``.
    ``slo_budgets_ms`` declares per-priority p-quantile budgets
    (obs/slo.py defaults when None); ``tail_window``/``tail_keep`` shape
    the merged ``/trace`` endpoint's tail sampling.  ``drift_budget_psi``
    arms the model-drift layer: replica drift counts are merged
    exactly on the scrape cadence, ``GET /drift`` reports per-model PSI
    verdicts, and a sustained breach journals ``drift_breach`` + warns in
    /healthz payloads (None = drift reporting off)."""
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.daemon_threads = True
    httpd.verbose = verbose
    httpd.state = _RouterState(
        supervisor, registry=registry, max_inflight=max_inflight,
        bulk_max_inflight=bulk_max_inflight, model_caps=model_caps,
        request_timeout_s=request_timeout_s, min_healthy=min_healthy,
        auth_token=auth_token, slo_budgets_ms=slo_budgets_ms,
        slo_quantile=slo_quantile, slo_breach_after=slo_breach_after,
        tail_window=tail_window, tail_keep=tail_keep,
        drift_budget_psi=drift_budget_psi,
        drift_breach_after=drift_breach_after, drift_top_k=drift_top_k)
    return httpd


class FleetRouter:
    """Bind-and-serve wrapper around ``make_fleet_router`` (the shape of
    ``obs.exporter.MetricsExporter``): ``start()`` serves on a daemon
    thread, ``stop()`` shuts down; tests and the fleet bench drive it
    in-process."""

    def __init__(self, supervisor, host: str = "127.0.0.1", port: int = 0,
                 **kw):
        self._args = (supervisor, host, port)
        self._kw = kw
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def host(self) -> str:
        return self._httpd.server_address[0] if self._httpd else self._args[1]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._args[2]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def state(self) -> "Optional[_RouterState]":
        """The live router state (None before start()) — the capacity
        controller's signal source in tests and the smoke."""
        return self._httpd.state if self._httpd is not None else None

    def start(self) -> "FleetRouter":
        if self._httpd is not None:
            return self
        supervisor, host, port = self._args
        self._httpd = make_fleet_router(supervisor, host, port, **self._kw)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="dryad-fleet-router")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def main_loop(httpd: ThreadingHTTPServer, quiet: bool = False) -> None:
    """Foreground serve_forever with a clean KeyboardInterrupt exit (the
    CLI's inner loop; split out so tests can cover the construction
    without serving)."""
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        if not quiet:
            print("fleet router stopped", file=sys.stderr)
