"""The fleet router's request tracing, merged latency histograms and SLO
gate in the port (``dryad_tpu_torch/fleet/router.py``): the router cases
of ``tests/test_fleet_trace.py``, over the reference's protocol stub
(``tests/fleet_stub_server.py``).

* trace ids round-trip (supplied and minted), the merged per-priority
  p50/p95/p99 gauges on ``/metrics`` come from an exact merge of the
  replicas' ``/obs`` histograms, and the merged ``/trace`` holds router,
  replica and journal tracks with one id end to end;
* a malformed replica histogram block is skipped, never raised;
* tail sampling keeps the slowest ``?k=`` requests' detail;
* a sustained per-priority SLO breach degrades the router's ``/healthz``;
* ``obs/trends.py`` tracks the fleet percentile fields like bench walls.

Also the ``obs`` cases the router leans on: the fixed log-bucket family
and its exact merge, the serve metrics' windowed percentiles, the trace
context across the micro-batcher's hand-off, no allocation with tracing
off, the tail sampler and two SLO gate edges.  The other SLO gate cases
are held by ``tests/test_torch_obs_exporter.py``.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import os
import sys
import threading
import tracemalloc

import numpy as np
import pytest

from dryad_tpu_torch.fleet import FleetRouter, FleetSupervisor
from dryad_tpu_torch.obs import trace_export
from dryad_tpu_torch.obs.registry import (LOG_BUCKETS, REQUEST_LATENCY,
                                          Registry, hist_quantile,
                                          log_bucket_index,
                                          merge_hist_states,
                                          set_default_registry)
from dryad_tpu_torch.obs.slo import SloGate
from dryad_tpu_torch.obs.trace_export import SpanTrace, TailSampler
from dryad_tpu_torch.resilience.policy import RetryPolicy
from dryad_tpu_torch.serve.batcher import MicroBatcher, Request, RequestTrace
from dryad_tpu_torch.serve.metrics import ServeMetrics
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "fleet_stub_server.py")


def stub_argv(*extra: str):
    def make(index: int, port_file: str) -> list:
        return [sys.executable, STUB, "--port-file", port_file, *extra]
    return make


# ---------------------------------------------------------------------------
# the histogram family, the batcher hand-off, the tail sampler


def test_log_bucket_index_matches_linear_scan_and_edges():
    def scan(v):
        i = 0
        while i < len(LOG_BUCKETS) and v > LOG_BUCKETS[i]:
            i += 1
        return i

    import random
    rng = random.Random(7)
    values = ([rng.uniform(0.0, 150.0) for _ in range(4000)]
              + [rng.uniform(0.0, 1e-3) for _ in range(1000)]
              + list(LOG_BUCKETS) + [0.0, -1.0, 1e-12, 1e9])
    for v in values:
        assert log_bucket_index(v) == scan(v), v
    # 'le' semantics: a value ON a bound lands in that bound's bucket
    for i, b in enumerate(LOG_BUCKETS):
        assert log_bucket_index(b) == i


def test_merge_is_bitwise_equal_to_concatenated_observations():
    """The acceptance pin: per-replica histograms, exactly merged, ==
    one histogram of the concatenated observations — counts AND sums."""
    replica_obs = [
        [2.0 ** -k for k in range(1, 9)],          # replica 0
        [0.75, 0.125, 3.0, 1.5, 0.25, 0.0625],     # replica 1
        [42.0, 2.0 ** -10, 0.5, 0.5, 8.0],         # replica 2
    ]
    states = []
    for obs in replica_obs:
        fam = Registry().log_histogram(REQUEST_LATENCY)
        for v in obs:
            fam.observe(v)
        states.append(fam.value())
    merged = merge_hist_states(states)
    ref = Registry().log_histogram(REQUEST_LATENCY)
    for obs in replica_obs:
        for v in obs:
            ref.observe(v)
    want = ref.value()
    assert merged[0] == want[0]          # bucket counts, bitwise
    assert merged[1] == want[1]          # dyadic sums are associative
    assert merged[2] == want[2]
    # and the quantiles of the merge are the quantiles of the whole
    for q in (0.5, 0.95, 0.99):
        assert hist_quantile(merged[0], q) == hist_quantile(want[0], q)


def test_merge_rejects_mismatched_layouts_and_quantile_shapes():
    with pytest.raises(ValueError):
        merge_hist_states([([0] * 62, 0.0, 0), ([0] * 10, 0.0, 0)])
    assert hist_quantile([0] * 62, 0.99) == 0.0         # empty -> 0
    counts = [0] * 62
    counts[5] = 100
    assert hist_quantile(counts, 0.5) == LOG_BUCKETS[5]
    counts[61] = 1000                                    # overflow bucket
    assert hist_quantile(counts, 0.99) == LOG_BUCKETS[-1]
    # monotone in q
    qs = [hist_quantile(counts, q) for q in (0.01, 0.5, 0.9, 0.999)]
    assert qs == sorted(qs)


def test_serve_metrics_percentiles_from_histogram():
    m = ServeMetrics(registry=Registry())
    for ms in (1, 2, 5, 10, 100):
        m.record_request(1, ms / 1e3, version=1)
    snap = m.snapshot()
    # bucket-resolution percentiles: p50 lands on the 5 ms observation's
    # upper bound, p99 on the 100 ms one's
    assert abs(snap["p50_ms"] - 5.012) < 0.1
    assert 100.0 <= snap["p99_ms"] <= 101.0
    assert abs(snap["mean_ms"] - 23.6) < 1e-6           # exact (sum/count)
    assert snap["models"][1]["p99_ms"] == snap["p99_ms"]


# ---------------------------------------------------------------------------
# trace context across the batcher hand-off


def test_trace_survives_batcher_thread_handoff():
    reg = Registry()
    old = set_default_registry(reg)
    ring = SpanTrace(capacity=256)
    try:
        from dryad_tpu_torch.obs import spans
        spans.set_trace_sink(ring.record)
        m = ServeMetrics(registry=reg)
        submitter = threading.get_ident() & 0xFFFF

        def dispatch(batch):
            return [np.zeros(r.rows.shape[0]) for r in batch]

        b = MicroBatcher(dispatch, max_wait_ms=0.5, metrics=m)
        b.start()
        try:
            req = Request(np.zeros((3, 2), np.float32), version=1,
                          priority="bulk",
                          tctx=RequestTrace("feedc0de", "bulk"))
            b.submit(req, timeout=10.0)
        finally:
            b.stop()
        tagged = [e for e in ring.events() if e[4] == "feedc0de"]
        assert sorted(e[0] for e in tagged) == [
            "serve.request/batch_assembly", "serve.request/predict",
            "serve.request/queue_wait"]
        # the spans were emitted from the WORKER threads, not the
        # submitting one — the hand-off really crossed threads
        assert all(e[3] != submitter for e in tagged)
        # stage timestamps are ordered: queue_wait before batch_assembly
        # before predict on the shared perf_counter clock
        by = {e[0]: e for e in tagged}
        assert (by["serve.request/queue_wait"][1]
                <= by["serve.request/batch_assembly"][1]
                <= by["serve.request/predict"][1])
        # and the per-(priority, stage) histograms saw each stage
        fam = reg.log_histogram(REQUEST_LATENCY)
        for stage in ("queue_wait", "batch_assembly", "predict", "total"):
            assert fam.labels(priority="bulk", stage=stage).value()[2] == 1, \
                stage
    finally:
        from dryad_tpu_torch.obs import spans
        spans.set_trace_sink(None)
        set_default_registry(old)


def test_tracing_disabled_allocates_no_request_context():
    """The zero-cost pin: with obs disabled, submitting requests leaves
    no net allocations from the trace-context sites (tctx stays None and
    every stamp site is one attribute check)."""
    reg = Registry(enabled=False)
    old = set_default_registry(reg)
    try:
        m = ServeMetrics(registry=reg)
        assert m.obs_enabled is False

        def dispatch(batch):
            return [np.zeros(r.rows.shape[0]) for r in batch]

        b = MicroBatcher(dispatch, max_wait_ms=0.2, metrics=m)
        b.start()
        rows = np.zeros((1, 2), np.float32)
        try:
            for _ in range(32):              # warm every code path
                b.submit(Request(rows, version=1), timeout=10.0)

            def leaked() -> list:
                tracemalloc.start()
                for _ in range(200):
                    b.submit(Request(rows, version=1), timeout=10.0)
                snap_mem = tracemalloc.take_snapshot()
                tracemalloc.stop()
                return [st for st in snap_mem.statistics("filename")
                        if st.traceback[0].filename.endswith(
                            ("obs/spans.py", "obs/trace_export.py"))]

            # re-measure up to 3x: tracemalloc attributes by file, and a
            # stray daemon thread from another test could touch obs once
            for _ in range(3):
                bad = leaked()
                if not bad:
                    break
            assert not bad, f"disabled trace path allocated: {bad}"
        finally:
            b.stop()
    finally:
        set_default_registry(old)


# ---------------------------------------------------------------------------
# SLO gate + tail sampler units


def test_slo_gate_clean_window_resets_streak():
    """One in-budget NON-EMPTY window zeroes the streak — breaches on
    either side never add up across it."""
    gate = SloGate({"interactive": 10.0}, breach_after=2,
                   registry=Registry())
    slow = Registry().log_histogram(REQUEST_LATENCY)
    fast = Registry().log_histogram(REQUEST_LATENCY)
    for _ in range(5):
        slow.observe(0.5)
        fast.observe(0.001)
    assert gate.evaluate(
        {"interactive": slow.value()})["interactive"]["streak"] == 1
    clean = gate.evaluate({"interactive": fast.value()})["interactive"]
    assert clean["streak"] == 0 and not clean["breached"]
    again = gate.evaluate({"interactive": slow.value()})["interactive"]
    assert again["streak"] == 1 and not again["sustained"], \
        "a pre-reset breach leaked into the new streak"
    assert gate.ok


def test_slo_gate_no_budgets_never_degrades():
    gate = SloGate({}, breach_after=1, registry=Registry())
    assert gate.evaluate({"interactive": ([0] * 62, 0.0, 0)}) == {}
    assert gate.ok


def test_serve_metrics_percentiles_track_recent_window():
    """The recency contract the reservoir had: after a regression, the
    windowed percentiles reflect the NEW latencies within one window,
    however many fast requests came before."""
    m = ServeMetrics(latency_window=64, registry=Registry())
    for _ in range(10_000):
        m.record_request(1, 0.001)            # a long fast history
    assert m.snapshot()["p99_ms"] < 2.0
    for _ in range(64):
        m.record_request(1, 0.5)              # regression: 500 ms
    assert m.snapshot()["p99_ms"] > 400.0     # visible within one window
    assert m.snapshot()["requests"] == 10_064  # counters stay lifetime


def test_tail_sampler_keeps_slowest_k_per_window():
    s = TailSampler(window=4)
    for i, d in enumerate([0.9, 0.1, 0.2, 0.3, 0.4]):   # 0.9 evicted
        s.observe(f"t{i}", d)
    assert s.slowest(2) == {"t4", "t3"}
    assert s.slowest(0) == {"t1", "t2", "t3", "t4"}
    s.observe(None, 9.9)                                 # untraced: ignored
    assert len(s.slowest(0)) == 4


# ---------------------------------------------------------------------------
# router integration over protocol stubs


@contextlib.contextmanager
def traced_fleet(tmp_path, n=2, *, router_kw=None, stub_args=()):
    reg = Registry()
    old = set_default_registry(reg)
    ring = trace_export.SpanTrace(capacity=4096)
    from dryad_tpu_torch.obs import spans
    spans.set_trace_sink(ring.record)
    sup = FleetSupervisor(
        stub_argv(*stub_args), n, policy=RetryPolicy(backoff_base_s=0.0),
        journal=str(tmp_path / "fleet.jsonl"), registry=reg,
        probe_interval_s=0.05, probe_timeout_s=1.0, startup_timeout_s=20.0)
    sup.start()
    router = FleetRouter(sup, registry=reg, **(router_kw or {})).start()
    try:
        yield sup, router, reg
    finally:
        router.stop()
        sup.stop()
        spans.set_trace_sink(None)
        set_default_registry(old)


def http_call(host, port, method, path, body=None, headers=None,
              timeout=15.0):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        payload = (json.dumps(body).encode() if isinstance(body, dict)
                   else (body or b""))
        conn.request(method, path, body=payload, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def test_router_trace_roundtrip_merge_and_merged_trace(tmp_path):
    with traced_fleet(tmp_path) as (sup, router, reg):
        # supplied id round-trips; minted id is returned when absent
        st, _, hdrs = http_call(router.host, router.port, "POST", "/predict",
                                {"rows": [[1.0, 2.0]]},
                                {"X-Dryad-Trace": "abc123"})
        assert st == 200 and hdrs.get("X-Dryad-Trace") == "abc123"
        st, _, hdrs = http_call(router.host, router.port, "POST",
                                "/predict", {"rows": [[1.0, 2.0]]})
        minted = hdrs.get("X-Dryad-Trace")
        assert st == 200 and minted and minted != "abc123"
        # registration-time clock handshake succeeded against the stub
        assert all(s.clock_offset is not None for s in sup.slots)
        # /metrics: merged per-priority gauges from replica /obs scrapes
        # (the stubs report one 31.6 ms-bucket observation per request)
        st, body, _ = http_call(router.host, router.port, "GET", "/metrics")
        text = body.decode()
        assert st == 200
        line = [ln for ln in text.splitlines()
                if ln.startswith("dryad_fleet_latency_ms")
                and 'stage="total"' in ln and 'q="p99"' in ln]
        assert line, text[:1500]
        assert line[0].split()[-1].startswith("31.6")
        # the router's own end-to-end series merged through the same path
        assert any('stage="router"' in ln and 'q="p99"' in ln
                   for ln in text.splitlines()
                   if ln.startswith("dryad_fleet_latency_ms"))
        # /trace: router + replica tracks, journal track, one id end2end
        st, body, _ = http_call(router.host, router.port, "GET", "/trace?k=0")
        doc = json.loads(body)
        tracks = [e["args"]["name"] for e in doc["traceEvents"]
                  if e["ph"] == "M"]
        assert "fleet router" in tracks
        assert any(t.startswith("replica r") for t in tracks)
        assert "fleet journal (run-relative)" in tracks
        spans_of = {}
        for e in doc["traceEvents"]:
            if e["ph"] == "X" and e["args"].get("trace"):
                spans_of.setdefault(e["args"]["trace"], []).append(
                    (e["pid"], e["args"]["path"]))
        assert "abc123" in spans_of
        paths = spans_of["abc123"]
        assert ("fleet.request" in {p for _, p in paths})
        assert any(pid >= 10 and p == "serve.request/predict"
                   for pid, p in paths)
        # journal instants landed on the journal track (pid 0)
        assert any(e["ph"] == "i" and e["pid"] == 0
                   and e["name"] == "replica_ready"
                   for e in doc["traceEvents"])


def test_merged_gauges_skip_malformed_replica_blocks():
    """One bad replica /obs block (wrong keys, wrong layout) must be
    SKIPPED, never raise out of the /metrics path."""
    from dryad_tpu_torch.fleet.router import _Handler, _RouterState

    class _NoSup:
        slots = ()

    reg = Registry()
    state = _RouterState(_NoSup(), registry=reg, max_inflight=4,
                         bulk_max_inflight=None, model_caps=None,
                         request_timeout_s=1.0, min_healthy=1,
                         auth_token=None)
    good = [0] * 62
    good[10] = 4
    blocks = [
        {'priority="interactive",stage="total"':
         {"counts": good, "sum": 0.01, "count": 4}},
        {"bad-no-keys": {}},                              # missing keys
        {'priority="interactive",stage="total"':
         {"counts": [1, 2], "sum": 1.0, "count": 3}},     # wrong layout
        "not-a-dict",                                     # wrong shape
    ]
    _Handler._merged_latency_gauges(state, blocks)        # must not raise
    v = reg.gauge("dryad_fleet_latency_ms").labels(
        priority="interactive", stage="total", q="p99").value()
    assert v == pytest.approx(hist_quantile(good, 0.99) * 1e3)


def test_router_tail_sampling_drops_fast_request_detail(tmp_path):
    with traced_fleet(tmp_path, router_kw=dict(tail_keep=1)) as (
            sup, router, reg):
        ids = []
        for i in range(4):
            st, _, hdrs = http_call(router.host, router.port, "POST",
                                    "/predict", {"rows": [[1.0, 2.0]]},
                                    {"X-Dryad-Trace": f"t{i:04d}"})
            assert st == 200
            ids.append(hdrs["X-Dryad-Trace"])
        st, body, _ = http_call(router.host, router.port, "GET", "/trace")
        doc = json.loads(body)
        kept = {e["args"]["trace"] for e in doc["traceEvents"]
                if e["ph"] == "X" and e["args"].get("trace")}
        assert len(kept) == 1 and kept <= set(ids)   # slowest-1 only
        # ?k=0 keeps everything
        st, body, _ = http_call(router.host, router.port, "GET",
                                "/trace?k=0")
        doc = json.loads(body)
        kept = {e["args"]["trace"] for e in doc["traceEvents"]
                if e["ph"] == "X" and e["args"].get("trace")}
        assert set(ids) <= kept


def test_router_healthz_degrades_on_sustained_slo_breach(tmp_path):
    # stub predicts take ~50 ms; a 1 ms interactive budget breaches each
    # window, and breach_after=2 needs two CONSECUTIVE breached windows
    # (each /healthz evaluates the delta since the previous one — fresh
    # slow traffic must arrive between probes)
    with traced_fleet(
            tmp_path, stub_args=("--predict-delay", "0.05"),
            router_kw=dict(slo_budgets_ms={"interactive": 1.0},
                           slo_breach_after=2)) as (sup, router, reg):
        for _ in range(2):
            assert http_call(router.host, router.port, "POST", "/predict",
                             {"rows": [[1.0, 2.0]]})[0] == 200
        st, body, _ = http_call(router.host, router.port, "GET", "/healthz")
        doc = json.loads(body)
        assert st == 200 and doc["ok"]            # 1st breached window: warn
        assert doc["slo"]["interactive"]["breached"]
        # an empty window between probes HOLDS the streak, never clears
        st, body, _ = http_call(router.host, router.port, "GET", "/healthz")
        doc = json.loads(body)
        assert st == 200 and doc["slo"]["interactive"]["streak"] == 1
        for _ in range(2):
            assert http_call(router.host, router.port, "POST", "/predict",
                             {"rows": [[1.0, 2.0]]})[0] == 200
        st, body, _ = http_call(router.host, router.port, "GET", "/healthz")
        doc = json.loads(body)
        assert st == 503 and not doc["ok"]        # 2nd breached window
        assert doc["slo"]["interactive"]["sustained"]
        assert "slo:interactive" in doc["degraded"]
        # the replicas themselves are fine — it is the SLO that tripped
        assert all(s["healthy"] for s in doc["replicas"].values())


# ---------------------------------------------------------------------------
# trends ingestion of the fleet percentile fields


def test_trends_track_fleet_percentiles():
    from dryad_tpu_torch.obs.trends import (_direction, _spread_fields_of,
                                            compare)

    assert _direction("fleet_interactive_p99_ms_n2") == "lower_better"
    assert _direction("fleet_bulk_p50_ms_n4") == "lower_better"
    assert _direction("fleet_trace_mismatches_n2") is None   # context
    assert _spread_fields_of("fleet_interactive_p99_ms_n2") == (
        "fleet_spread_n2",)
    hist = [{"round": r, "path": f"BENCH_FLEET_r{r}.json", "metrics":
             {"fleet_interactive_p99_ms_n2": 40.0, "fleet_spread_n2": 0.01}}
            for r in (1, 2, 3)]
    hist.append({"round": 4, "path": "BENCH_FLEET_r4.json", "metrics":
                 {"fleet_interactive_p99_ms_n2": 80.0,
                  "fleet_spread_n2": 0.01}})
    report = compare(hist)
    assert report["metrics"]["fleet_interactive_p99_ms_n2"][
        "verdict"] == "regression"
    assert not report["ok"]
    # the spread veto still applies (suspect capture, never a regression)
    hist[-1]["metrics"]["fleet_spread_n2"] = 0.2
    report = compare(hist)
    assert report["metrics"]["fleet_interactive_p99_ms_n2"][
        "verdict"] == "suspect"
    assert report["ok"]
