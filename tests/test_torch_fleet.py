"""The port's serving fleet (``dryad_tpu_torch/fleet/``): the counterpart
of ``tests/test_fleet.py``.

The supervisor and router only ever see the wire protocol, so most cases
spawn the reference's pure-stdlib protocol stub
(``tests/fleet_stub_server.py``, about 100 ms a replica).  Every case of
``tests/test_fleet.py`` runs here against the port's classes; the serve
front end's drill runs against the port's ``PredictServer``.

Against the reference: the reference's ``FleetSupervisor`` and the port's
run the same stub drills (a crash and its respawn, the respawn budget
spent, the stuck-503 recycle ladder), and their journals hold the same
event kinds in the same order with the same fields.

The ``serve`` command's fleet wiring, with real ``python -m
dryad_tpu_torch serve --device cpu`` replicas (each pays a torch import):
``DRYAD_REPLICA_FAULTS`` arms the drill, a malformed spec stops start-up
before the port file appears, ``/trace/events`` holds the request's spans
(none under ``DRYAD_TRACE=0``), and predictions through the port's router
equal ``dryad_tpu.Booster.predict`` on the same model file bit for bit.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from dryad_tpu_torch.fleet import (FleetRouter, FleetSupervisor,
                                   ReplicaProcess, ReplicaStartupError,
                                   serve_argv)
from dryad_tpu_torch.fleet.router import relabel_exposition
from dryad_tpu_torch.obs.registry import Registry
from dryad_tpu_torch.resilience import faults as F
from dryad_tpu_torch.resilience.journal import RunJournal
from dryad_tpu_torch.resilience.policy import RetryPolicy
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
STUB = os.path.join(HERE, "fleet_stub_server.py")
REAL_STARTUP_S = 120.0      # a real replica imports torch under the suite's load


def stub_argv(*extra: str):
    """make_argv for a fleet where every replica runs the stub with the
    same flags; per-index shapes build their own closure."""
    def make(index: int, port_file: str) -> list:
        return [sys.executable, STUB, "--port-file", port_file, *extra]
    return make


@contextlib.contextmanager
def fleet(make_argv, n, tmp_path, *, policy=None, router_kw=None, **sup_kw):
    reg = Registry()
    journal = str(tmp_path / "fleet.jsonl")
    sup_kw.setdefault("startup_timeout_s", 20.0)
    sup = FleetSupervisor(
        make_argv, n,
        policy=policy or RetryPolicy(backoff_base_s=0.0),
        journal=journal, registry=reg,
        probe_interval_s=0.05, probe_timeout_s=1.0, **sup_kw)
    sup.start()
    router = FleetRouter(sup, registry=reg, **(router_kw or {})).start()
    try:
        yield sup, router, reg, journal
    finally:
        router.stop()
        sup.stop()


def http_call(host, port, method, path, body=None, headers=None,
              timeout=15.0):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        payload = (json.dumps(body).encode() if isinstance(body, dict)
                   else (body or b""))
        conn.request(method, path, body=payload, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def predict(router, rows=1, headers=None, timeout=15.0):
    status, body = http_call(router.host, router.port, "POST", "/predict",
                             {"rows": [[1.0, 2.0]] * rows},
                             headers=headers, timeout=timeout)
    try:
        return status, json.loads(body or b"{}")
    except ValueError:
        return status, {}


def wait_until(cond, timeout_s=10.0, interval_s=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval_s)
    return False


def events_of(journal_path, kind):
    return [e for e in RunJournal.read(journal_path) if e["event"] == kind]


# ---------------------------------------------------------------------------
# fault-point plumbing (no subprocess)

def test_replica_fault_points_roundtrip_and_validation():
    pts = [F.FaultPoint(site="request", iteration=3, kind=F.REPLICA_CRASH),
           F.FaultPoint(site="health", iteration=1, kind=F.SLOW_HEALTH,
                        stall_s=2.5, sticky=True),
           F.FaultPoint(site="request", iteration=2, kind=F.REJECT_503,
                        sticky=True)]
    assert F.decode_points(F.encode_points(pts)) == pts
    assert F.injector_from_env({}) is None
    assert F.injector_from_env({F.REPLICA_FAULTS_ENV: ""}) is None
    with pytest.raises(ValueError):
        F.decode_points("request:replica_crash")       # missing iteration
    with pytest.raises(ValueError):
        # a misspelt "sticky" must fail loudly, not arm the one-shot form
        F.decode_points("health:1:reject_503:0:stikcy")
    with pytest.raises(ValueError):
        F.FaultPoint(site="nowhere", iteration=1, kind=F.REPLICA_CRASH)
    with pytest.raises(ValueError):
        F.FaultPoint(site="health", iteration=1, kind=F.SLOW_HEALTH)  # no stall
    with pytest.raises(ValueError):
        # kinds and sites partition strictly: a replica kind at a trainer
        # site would end a training run (or never fire)
        F.FaultPoint(site="dispatch", iteration=1, kind=F.REPLICA_CRASH)
    with pytest.raises(ValueError):
        F.FaultPoint(site="request", iteration=1, kind=F.FETCH_DEATH)
    # drilled rejections must never classify as a retryable device fault
    assert F.classify_fault(F.InjectedReject("injected 503")) == F.UNKNOWN


def test_spawn_env_strips_inherited_fault_spec():
    """Replicas inherit the fleet process's environment: a
    DRYAD_REPLICA_FAULTS set there is overridden to empty for every slot
    the supervisor is not arming, and an armed slot is clean from
    generation 1 on (one drill = one death, never a respawn loop)."""
    sup = FleetSupervisor(lambda i, pf: ["true"], 2,
                          fault_env={0: "request:2:replica_crash"})
    armed, clean = sup.slots
    assert sup._spawn_env(armed) == {
        F.REPLICA_FAULTS_ENV: "request:2:replica_crash"}
    assert sup._spawn_env(clean) == {F.REPLICA_FAULTS_ENV: ""}
    armed.generation = 1                       # post-respawn: clean again
    assert sup._spawn_env(armed) == {F.REPLICA_FAULTS_ENV: ""}


def test_sticky_point_fires_repeatedly_exactly_once_otherwise():
    inj = F.FaultInjector([
        F.FaultPoint(site="request", iteration=2, kind=F.REJECT_503,
                     sticky=True),
        F.FaultPoint(site="health", iteration=2, kind=F.REJECT_503)])
    inj("request", 1)                                  # below threshold
    for n in (2, 3, 4):                                # sticky: every time
        with pytest.raises(F.InjectedReject):
            inj("request", n)
    with pytest.raises(F.InjectedReject):
        inj("health", 5)
    inj("health", 6)                                   # one-shot: disarmed
    assert [f["kind"] for f in inj.fired] == [F.REJECT_503] * 4
    assert inj.pending == 1                            # the sticky point


def test_relabel_exposition():
    text = ("# HELP x_total help\n# TYPE x_total counter\n"
            "x_total 3\n"
            'x_latency{path="/p",code="200"} 1.5\n'
            "x_hist_bucket{le=\"+Inf\"} 7\n")
    out = relabel_exposition(text, "r1")
    assert '# HELP' not in out                         # comments dropped
    assert 'x_total{replica="r1"} 3' in out
    assert 'x_latency{replica="r1",path="/p",code="200"} 1.5' in out
    assert 'x_hist_bucket{replica="r1",le="+Inf"} 7' in out


def test_serve_argv_builds_the_port_command():
    argv = serve_argv(["m=a.dryad", "b.dryad"], "/tmp/pf", warmup=True,
                      drift_window=512, auth_token="t")
    assert argv[1:4] == ["-m", "dryad_tpu_torch", "serve"]
    assert argv[argv.index("--device") + 1] == "cuda"   # the port's default
    assert "--backend" not in argv
    assert argv[argv.index("--port") + 1] == "0"
    assert [argv[i + 1] for i, a in enumerate(argv) if a == "--model"] == [
        "m=a.dryad", "b.dryad"]
    assert "--warmup" in argv and "--quiet" in argv
    argv = serve_argv(["m.dryad"], "/tmp/pf", device="cpu")
    assert argv[argv.index("--device") + 1] == "cpu"
    # every flag serve_argv emits parses in the port's serve command
    from dryad_tpu_torch.__main__ import build_parser

    args = build_parser().parse_args(serve_argv(
        ["m.dryad"], "/tmp/pf", device="cpu", max_batch_rows=64,
        max_wait_ms=0.5, queue_size=8, warmup=True, drift_window=0,
        auth_token="t")[3:])
    assert (args.device, args.port, args.port_file) == ("cpu", 0, "/tmp/pf")
    assert (args.max_batch_rows, args.queue_size, args.drift_window) == (
        64, 8, 0)


# ---------------------------------------------------------------------------
# routing + aggregation

def test_routing_metrics_aggregation_and_health(tmp_path):
    with fleet(stub_argv(), 2, tmp_path) as (sup, router, reg, journal):
        status, doc = predict(router, rows=3)
        assert status == 200 and len(doc["predictions"]) == 3
        # spread a few requests so both replicas serve
        for _ in range(5):
            assert predict(router)[0] == 200
        status, body = http_call(router.host, router.port, "GET", "/healthz")
        doc = json.loads(body)
        assert status == 200 and doc["ok"] is True
        assert set(doc["replicas"]) == {"r0", "r1"}
        status, body = http_call(router.host, router.port, "GET", "/metrics")
        text = body.decode()
        assert status == 200
        # per-replica labels injected, existing labels preserved, comments
        # not duplicated per replica
        assert 'stub_requests_total{replica="r0"}' in text
        assert 'stub_requests_total{replica="r1"}' in text
        assert 'stub_latency_ms{replica="r0",path="/predict"}' in text
        assert "# HELP stub_requests_total" not in text
        assert "dryad_fleet_request_total" in text
        # both replicas actually served (round robin)
        routed = reg.counter("dryad_fleet_routed_total", "")
        assert routed.labels(replica="r0").value() > 0
        assert routed.labels(replica="r1").value() > 0
        status, body = http_call(router.host, router.port, "GET", "/stats")
        snap = json.loads(body)
        assert snap["replicas"]["r0"]["healthy"] is True
        assert snap["max_inflight"] == 64


def test_authed_fleet_still_aggregates_replica_metrics(tmp_path):
    """With bearer auth on, the router scrapes replicas WITH the token,
    forwards authed predicts, and 401s clients that skip it, while
    /healthz stays open."""
    token = "sekrit-42"
    with fleet(stub_argv("--auth-token", token), 2, tmp_path,
               router_kw=dict(auth_token=token)) as (
            sup, router, reg, journal):
        auth = {"Authorization": f"Bearer {token}"}
        status, doc = predict(router, headers=auth)
        assert status == 200 and doc["version"] == 1
        status, body = http_call(router.host, router.port, "GET",
                                 "/metrics", headers=auth)
        text = body.decode()
        assert status == 200
        assert 'stub_requests_total{replica="r0"}' in text
        assert 'stub_requests_total{replica="r1"}' in text
        # no token -> the router itself 401s; /healthz stays exempt
        assert http_call(router.host, router.port, "GET",
                         "/metrics")[0] == 401
        assert predict(router)[0] == 401
        assert http_call(router.host, router.port, "GET", "/healthz")[0] == 200


# ---------------------------------------------------------------------------
# shed ordering + per-model admission

def test_shed_bulk_before_interactive(tmp_path):
    router_kw = dict(max_inflight=4, bulk_max_inflight=1)
    with fleet(stub_argv("--predict-delay", "0.4"), 2, tmp_path,
               router_kw=router_kw) as (sup, router, reg, journal):
        results = []

        def bg():
            results.append(predict(
                router, headers={"X-Dryad-Priority": "interactive"})[0])

        threads = [threading.Thread(target=bg) for _ in range(2)]
        for t in threads:
            t.start()
        # both interactive requests are in flight (delay 0.4s)
        assert wait_until(lambda: router.state.inflight_total >= 2,
                          timeout_s=2.0)
        # bulk sheds first: total inflight (2) >= bulk_max_inflight (1)
        status, doc = predict(router, headers={"X-Dryad-Priority": "bulk"})
        assert status == 503 and "shed" in doc["error"]
        # ... while interactive still admits (2 < max_inflight 4)
        assert predict(
            router, headers={"X-Dryad-Priority": "interactive"})[0] == 200
        for t in threads:
            t.join()
        assert results == [200, 200]
        shed = reg.counter("dryad_fleet_shed_total", "")
        assert shed.labels(priority="bulk").value() == 1
        assert shed.labels(priority="interactive").value() == 0


def test_per_model_admission_cap_and_body_priority(tmp_path):
    router_kw = dict(max_inflight=8, model_caps={"fraud": 1})
    with fleet(stub_argv("--predict-delay", "0.4"), 1, tmp_path,
               router_kw=router_kw) as (sup, router, reg, journal):
        codes = []

        def bg():
            codes.append(http_call(
                router.host, router.port, "POST", "/predict",
                {"rows": [[1.0]], "model": "fraud"})[0])

        t = threading.Thread(target=bg)
        t.start()
        assert wait_until(lambda: router.state.inflight_total >= 1,
                          timeout_s=2.0)
        # the capped model sheds its second in-flight request ...
        status, body = http_call(router.host, router.port, "POST",
                                 "/predict", {"rows": [[1.0]],
                                              "model": "fraud"})
        assert status == 503 and b"admission cap" in body
        # ... while other models still admit
        assert predict(router)[0] == 200
        t.join()
        assert codes == [200]
        # body-parsed priority (no header) still classifies the shed
        assert reg.counter("dryad_fleet_shed_total", "").labels(
            priority="interactive").value() == 1


# ---------------------------------------------------------------------------
# retry against a different replica

def test_retry_once_on_a_different_replica(tmp_path):
    def make(index, port_file):
        extra = ("--predict-503",) if index == 0 else ()
        return [sys.executable, STUB, "--port-file", port_file, *extra]

    with fleet(make, 2, tmp_path) as (sup, router, reg, journal):
        # every request answers 200: r0's stuck 503s are absorbed by the
        # single retry against r1
        for _ in range(6):
            assert predict(router)[0] == 200
        assert reg.counter("dryad_fleet_upstream_5xx_total", "").labels(
            replica="r0").value() >= 1
        assert reg.counter("dryad_fleet_retry_total", "").value() >= 1


# ---------------------------------------------------------------------------
# rolling swap: zero drops, pinned versions, journaled drains

def test_rolling_swap_zero_drop_and_pinned_versions(tmp_path):
    with fleet(stub_argv("--predict-delay", "0.1"), 2, tmp_path,
               router_kw=dict(max_inflight=32)) as (
            sup, router, reg, journal):
        seen = []
        seen_lock = threading.Lock()
        stop = [False]

        def client():
            while not stop[0]:
                status, doc = predict(router)
                with seen_lock:
                    seen.append((status, doc.get("version")))

        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.3)                      # requests in flight
        status, body = http_call(router.host, router.port, "POST",
                                 "/models/push", {"path": "v2.dryad"},
                                 timeout=60.0)
        push = json.loads(body)
        time.sleep(0.3)                      # traffic on the new version
        stop[0] = True
        for t in threads:
            t.join()
        assert status == 200, push
        assert push["errors"] == {} and push["skipped"] == []
        assert push["versions"] == {"r0": 2, "r1": 2}
        # ZERO dropped or failed requests across the swap ...
        assert {s for s, _ in seen} == {200}
        # ... and both versions served: old for requests pinned before
        # their replica swapped, new after
        assert {v for _, v in seen} == {1, 2}
        # the journal shows drain -> swap per replica, in order
        drains = events_of(journal, "replica_drain")
        swaps = events_of(journal, "replica_swapped")
        assert [e["replica"] for e in drains] == ["r0", "r1"]
        assert [(e["replica"], e["version"]) for e in swaps] == [
            ("r0", 2), ("r1", 2)]


# ---------------------------------------------------------------------------
# crash -> respawn, budget exhaustion, stuck-503 recycle ladder

def test_crash_respawn_journal_sequence(tmp_path):
    with fleet(stub_argv("--crash-on-path"), 2, tmp_path,
               policy=RetryPolicy(backoff_base_s=0.0, retry_budget=3)) as (
            sup, router, reg, journal):
        # hard-kill r0 through its crash path (connection dies mid-request)
        slot = sup.slots[0]
        with pytest.raises(OSError):
            slot.proc.request("GET", "/boom", timeout_s=2.0)
        # the monitor notices the corpse and respawns under the budget
        assert wait_until(lambda: slot.routable and slot.generation == 1)
        assert predict(router)[0] == 200
        crashes = events_of(journal, "replica_crash")
        assert crashes and crashes[0]["replica"] == "r0"
        assert crashes[0]["exit_code"] == F.REPLICA_CRASH_EXIT
        respawns = events_of(journal, "replica_respawn")
        assert respawns and respawns[0]["reason"] == "crash"
        assert events_of(journal, "replica_ready")[-1]["generation"] == 1
        assert slot.respawns == 1
        assert reg.counter("dryad_fleet_crash_total", "").labels(
            replica="r0").value() == 1


def test_respawn_budget_exhaustion_fails_closed(tmp_path):
    journal = str(tmp_path / "fleet.jsonl")
    sup = FleetSupervisor(
        stub_argv("--fail-start"), 1,
        policy=RetryPolicy(backoff_base_s=0.0, retry_budget=2),
        journal=journal, registry=Registry(),
        probe_interval_s=0.05, startup_timeout_s=20.0)
    with pytest.raises(ReplicaStartupError):
        sup.start()
    # initial attempt + 2 budgeted retries, then the slot fails closed
    fails = events_of(journal, "replica_spawn_failed")
    assert len(fails) == 3 and all(e["exit_code"] == 7 for e in fails)
    closed = events_of(journal, "replica_fail_closed")
    assert closed and closed[0]["reason"] == "retry_budget_exhausted"
    assert closed[0]["respawns"] == 2
    assert sup.slots[0].fail_closed


def _ladder_argv(index, port_file):
    extra = ("--health-503-after", "5") if index == 0 else ()
    return [sys.executable, STUB, "--port-file", port_file, *extra]


def test_stuck_503_walks_the_recycle_ladder(tmp_path):
    with fleet(_ladder_argv, 2, tmp_path,
               policy=RetryPolicy(backoff_base_s=0.0, retry_budget=1),
               unhealthy_after=2, recycle_after=3,
               startup_timeout_s=1.0) as (sup, router, reg, journal):
        slot = sup.slots[0]
        # rung 1: out of routing; rung 2: recycled; the respawned stub
        # latches 503 again, so the budget exhausts and the slot fails
        # closed, while r1 keeps the fleet healthy throughout
        assert wait_until(lambda: slot.fail_closed, timeout_s=20.0)
        kinds = [e["event"] for e in RunJournal.read(journal)]
        assert "replica_unhealthy" in kinds
        assert "replica_hang" in kinds
        assert "replica_fail_closed" in kinds
        for _ in range(3):
            assert predict(router)[0] == 200        # r1 serves on
        status, body = http_call(router.host, router.port, "GET", "/healthz")
        assert status == 200 and json.loads(body)["ok"] is True


# ---------------------------------------------------------------------------
# the same drills through the reference's supervisor: the journals match

#: fields whose values depend on the run (times, ports, paths)
_RUN_FIELDS = ("elapsed_s", "url", "clock_offset_s", "message")


def _drill(pkg: str, drill: str, tmp_path) -> list:
    """Run one stub drill through ``pkg``'s FleetSupervisor (``"ref"``:
    ``dryad_tpu.fleet``; ``"port"``: ``dryad_tpu_torch.fleet``) and return
    its journal, each event as (kind, field names, run-independent
    values)."""
    if pkg == "ref":
        from dryad_tpu.fleet import FleetSupervisor as Sup
        from dryad_tpu.fleet import ReplicaStartupError as StartErr
        from dryad_tpu.obs.registry import Registry as Reg
        from dryad_tpu.resilience.journal import RunJournal as Journal
        from dryad_tpu.resilience.policy import RetryPolicy as Policy
    else:
        Sup, StartErr, Reg, Journal, Policy = (
            FleetSupervisor, ReplicaStartupError, Registry, RunJournal,
            RetryPolicy)
    journal = str(tmp_path / f"{pkg}-{drill}.jsonl")
    # a probe timeout would journal its own events: the stub answers in
    # milliseconds, so only a starved host reaches 5 s
    kw = dict(journal=journal, registry=Reg(), probe_interval_s=0.05,
              probe_timeout_s=5.0)
    if drill == "crash":
        sup = Sup(stub_argv("--crash-on-path"), 2,
                  policy=Policy(backoff_base_s=0.0, retry_budget=3),
                  startup_timeout_s=20.0, **kw).start()
        try:
            slot = sup.slots[0]
            with pytest.raises(OSError):
                slot.proc.request("GET", "/boom", timeout_s=2.0)
            assert wait_until(lambda: slot.routable and slot.generation == 1)
        finally:
            sup.stop()
    elif drill == "budget":
        sup = Sup(stub_argv("--fail-start"), 1,
                  policy=Policy(backoff_base_s=0.0, retry_budget=2),
                  startup_timeout_s=20.0, **kw)
        with pytest.raises(StartErr):
            sup.start()
    else:
        sup = Sup(_ladder_argv, 2,
                  policy=Policy(backoff_base_s=0.0, retry_budget=1),
                  unhealthy_after=2, recycle_after=3, startup_timeout_s=20.0,
                  **kw).start()
        try:
            assert wait_until(lambda: sup.slots[0].fail_closed,
                              timeout_s=20.0)
        finally:
            sup.stop()
    out = []
    for e in Journal.read(journal):
        fields = {k: v for k, v in e.items() if k != "event"}
        out.append((e["event"], sorted(fields),
                    {k: v for k, v in fields.items()
                     if k not in _RUN_FIELDS}))
    return out


@pytest.mark.parametrize("drill", ["crash", "budget", "ladder"])
def test_drill_journals_match_the_reference(drill, tmp_path):
    ref = _drill("ref", drill, tmp_path)
    port = _drill("port", drill, tmp_path)
    assert [k for k, _, _ in port] == [k for k, _, _ in ref]
    assert port == ref
    kinds = [k for k, _, _ in port]
    want = {"crash": ["replica_crash", "replica_respawn", "replica_ready"],
            "budget": ["replica_spawn_failed", "replica_fail_closed"],
            "ladder": ["replica_unhealthy", "replica_hang",
                       "replica_fail_closed"]}[drill]
    it = iter(kinds)
    assert all(k in it for k in want), kinds          # in this order


# ---------------------------------------------------------------------------
# the drills through the serve HTTP front end (in-process)

@pytest.fixture(scope="module")
def served_model(tmp_path_factory):
    """A reference model (CPU trainer) saved as an npz model file, and
    rows of its training matrix."""
    import dryad_tpu as dryad
    from dryad_tpu.datasets import higgs_like

    X, y = higgs_like(400, seed=5)
    ds = dryad.Dataset(X, y, max_bins=32)
    booster = dryad.train(dict(objective="binary", num_trees=4,
                               num_leaves=7, max_bins=32), ds,
                          backend="cpu")
    path = str(tmp_path_factory.mktemp("served") / "m.dryad")
    booster.save(path)
    return booster, np.asarray(X[:64], np.float32), path


def test_serve_front_end_honors_reject_503_drill(served_model):
    from dryad_tpu_torch.serve import PredictServer
    from dryad_tpu_torch.serve.http import make_http_server

    _, X, path = served_model
    server = PredictServer(device="cpu", max_wait_ms=0.2)
    server.load_model(path)
    injector = F.FaultInjector([
        F.FaultPoint(site="request", iteration=2, kind=F.REJECT_503,
                     sticky=True),
        F.FaultPoint(site="health", iteration=3, kind=F.REJECT_503)])
    httpd = make_http_server(server, port=0, fault_hook=injector)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    host, port = httpd.server_address[:2]
    try:
        body = {"rows": X[:2].tolist()}
        assert http_call(host, port, "POST", "/predict", body)[0] == 200
        for _ in range(2):                   # sticky from request #2 on
            assert http_call(host, port, "POST", "/predict", body)[0] == 503
        assert http_call(host, port, "GET", "/healthz")[0] == 200
        assert http_call(host, port, "GET", "/healthz")[0] == 200
        assert http_call(host, port, "GET", "/healthz")[0] == 503  # probe 3
        assert http_call(host, port, "GET", "/healthz")[0] == 200  # one-shot
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()
        thread.join(timeout=5.0)


# ---------------------------------------------------------------------------
# the serve command's fleet wiring, with real port replicas on the CPU

def _real_env(**extra) -> dict:
    env = {"PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1"}
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def real_fleet(served_model, tmp_path_factory):
    """Two real ``python -m dryad_tpu_torch serve --device cpu`` replicas
    under the port's supervisor and router; r0 armed with a one-shot 503
    at its second request through ``DRYAD_REPLICA_FAULTS``.  The drill's
    three direct answers from r0 are taken before any routed traffic."""
    _, _, path = served_model
    d = tmp_path_factory.mktemp("real_fleet")
    reg = Registry()
    sup = FleetSupervisor(
        lambda i, pf: serve_argv([path], pf, device="cpu", max_wait_ms=0.5),
        2, policy=RetryPolicy(backoff_base_s=0.0, retry_budget=1),
        journal=str(d / "fleet.jsonl"), registry=reg,
        probe_interval_s=0.1, probe_timeout_s=5.0,
        startup_timeout_s=REAL_STARTUP_S,
        fault_env={0: "request:2:reject_503"}, log_dir=str(d))
    old = os.environ.copy()
    os.environ.update(_real_env())
    try:
        sup.start()
    finally:
        os.environ.clear()
        os.environ.update(old)
    router = FleetRouter(sup, registry=reg, request_timeout_s=30.0).start()
    body = json.dumps({"rows": [[0.5] * 28]}).encode()
    headers = {"Content-Type": "application/json"}
    drill = [sup.slots[0].proc.request("POST", "/predict", body, headers,
                                       timeout_s=30.0)[0] for _ in range(3)]
    try:
        yield sup, router, drill
    finally:
        router.stop()
        sup.stop()


def test_real_replica_arms_the_fault_drill_from_env(real_fleet):
    """``DRYAD_REPLICA_FAULTS`` (set by the supervisor for r0's first
    generation only) makes the port's serve answer 503 at the armed
    request, once."""
    sup, _, drill = real_fleet
    assert drill == [200, 503, 200]
    assert all(s.generation == 0 and s.routable for s in sup.slots)


def test_real_replicas_record_trace_events(real_fleet):
    """The port's serve turns request tracing on: a replica's
    ``/trace/events`` holds the served request's spans under its id."""
    sup, router, _ = real_fleet
    st, body = http_call(router.host, router.port, "POST", "/predict",
                         {"rows": [[0.25] * 28]},
                         {"X-Dryad-Trace": "feedbeef00000001"}, timeout=30)
    assert st == 200
    traces = set()
    for slot in sup.slots:
        st, body = slot.proc.request("GET", "/trace/events", timeout_s=10)
        assert st == 200
        events = json.loads(body)["events"]
        traces |= {e[4] for e in events if len(e) > 4}
    assert "feedbeef00000001" in traces


def test_router_predictions_equal_reference_predict(real_fleet,
                                                    served_model):
    ref, X, _ = served_model
    _, router, _ = real_fleet
    for n in (1, 7, 64):
        st, body = http_call(router.host, router.port, "POST", "/predict",
                             {"rows": X[:n].tolist()}, timeout=30)
        assert st == 200, body
        got = np.asarray(json.loads(body)["predictions"], np.float32)
        np.testing.assert_array_equal(got, ref.predict(X[:n]))
        st, body = http_call(router.host, router.port, "POST", "/predict",
                             {"rows": X[:n].tolist(), "raw": True},
                             timeout=30)
        got = np.asarray(json.loads(body)["predictions"], np.float32)
        np.testing.assert_array_equal(got, ref.predict(X[:n],
                                                       raw_score=True))


def test_real_replica_without_tracing_records_no_events(served_model,
                                                        tmp_path):
    _, X, path = served_model
    proc = ReplicaProcess(
        lambda pf: serve_argv([path], pf, device="cpu", max_wait_ms=0.5),
        name="notrace", env=_real_env(DRYAD_TRACE="0"),
        startup_timeout_s=REAL_STARTUP_S, log_dir=str(tmp_path))
    proc.start()
    try:
        st, _ = proc.request("POST", "/predict",
                             json.dumps({"rows": X[:3].tolist()}).encode(),
                             {"Content-Type": "application/json"},
                             timeout_s=30)
        assert st == 200
        st, body = proc.request("GET", "/trace/events", timeout_s=10)
        assert st == 200 and json.loads(body)["events"] == []
    finally:
        proc.stop()


def test_malformed_fault_spec_fails_serve_startup(served_model, tmp_path):
    _, _, path = served_model
    port_file = str(tmp_path / "r.port")
    env = dict(os.environ, **_real_env(
        DRYAD_REPLICA_FAULTS="request:replica_crash"))   # no iteration
    out = subprocess.run(serve_argv([path], port_file, device="cpu"),
                         env=env, capture_output=True, text=True,
                         timeout=REAL_STARTUP_S)
    assert out.returncode != 0
    assert "ValueError" in out.stderr
    assert not os.path.exists(port_file)


# ---------------------------------------------------------------------------
# elastic capacity: mutable slot registry + CapacityController

def test_elastic_add_and_retire_slot(tmp_path):
    with fleet(stub_argv(), 1, tmp_path) as (sup, router, reg, journal):
        assert [s.name for s in sup.slots] == ["r0"]
        slot = sup.add_slot()
        assert slot is not None and slot.name == "r1"
        assert wait_until(lambda: slot.routable)
        assert predict(router)[0] == 200
        # the census gauge and the router's admission gauges are live
        status, body = http_call(router.host, router.port, "GET", "/metrics")
        text = body.decode()
        assert status == 200
        assert 'dryad_fleet_replicas{state="total"} 2' in text
        assert 'dryad_fleet_inflight{priority="total"}' in text
        assert 'dryad_fleet_slot_inflight{replica="r1"}' in text
        # a held in-flight request stalls the drain (zero-drop), then
        # releasing it lets the retire complete
        slot.inflight_inc()
        done = []
        t = threading.Thread(target=lambda: done.append(
            sup.retire_slot("r1", drain_timeout_s=10.0)))
        t.start()
        assert wait_until(lambda: slot.retiring)
        assert not slot.routable
        time.sleep(0.1)
        assert not done, "retire completed with a request still in flight"
        slot.inflight_dec()
        t.join(timeout=10.0)
        assert done == [True]
        assert [s.name for s in sup.slots] == ["r0"]
        kinds = [e["event"] for e in RunJournal.read(journal)]
        assert "replica_retire" in kinds and "replica_retired" in kinds
        # retiring an unknown slot refuses cleanly
        assert sup.retire_slot("r1") is False


def test_retire_aborts_rather_than_dropping_inflight(tmp_path):
    with fleet(stub_argv(), 2, tmp_path) as (sup, router, reg, journal):
        slot = sup.slots[1]
        slot.inflight_inc()
        try:
            assert sup.retire_slot("r1", drain_timeout_s=0.1) is False
        finally:
            slot.inflight_dec()
        assert not slot.retiring, "aborted retire left the slot non-routable"
        assert slot.routable
        assert [s.name for s in sup.slots] == ["r0", "r1"]
        assert events_of(journal, "replica_retire_aborted")


def test_monitor_skips_retiring_slot(tmp_path):
    """A scale-down kills its process ON PURPOSE; the monitor must read
    that as the planned death it is, never as a crash to respawn."""
    with fleet(stub_argv(), 2, tmp_path) as (sup, router, reg, journal):
        slot = sup.slots[1]
        slot.retiring = True
        assert not slot.routable
        assert slot.state()["retiring"] is True
        slot.proc.stop()                 # the planned death
        time.sleep(0.5)                  # ~10 monitor cycles
        assert slot.generation == 0 and not slot.recovering
        assert not [e for e in events_of(journal, "replica_crash")
                    if e.get("replica") == "r1"], \
            "the monitor read a planned retire death as a crash"


def test_monitor_retiring_guard_is_load_bearing(tmp_path, monkeypatch):
    """Drop ``retiring`` from the monitor's skip predicate and the drained
    replica is resurrected: the bug the shipped predicate prevents."""
    monkeypatch.setattr(
        FleetSupervisor, "_monitor_skips",
        staticmethod(lambda slot: slot.fail_closed or slot.recovering
                     or slot.proc is None))
    with fleet(stub_argv(), 2, tmp_path) as (sup, router, reg, journal):
        slot = sup.slots[1]
        slot.retiring = True
        slot.proc.stop()
        assert wait_until(lambda: slot.generation == 1 and slot.healthy), \
            "without the guard the monitor no longer resurrects: " \
            "update this test alongside _monitor_skips"
        slot.retiring = False            # let teardown see a normal slot


def test_stop_reaps_in_flight_scale_up(tmp_path):
    """stop() during add_slot's ready wait: the half-born slot is
    registered BEFORE the wait, so the teardown sweep terminates its
    child, add_slot unblocks promptly and leaves no ghost slot."""
    def make(index: int, port_file: str) -> list:
        if index == 0:
            return [sys.executable, STUB, "--port-file", port_file]
        # a replica that never reports ready (the torch-import phase)
        return [sys.executable, "-c", "import time; time.sleep(60)"]

    sup = FleetSupervisor(
        make, 1, policy=RetryPolicy(backoff_base_s=0.0),
        journal=str(tmp_path / "fleet.jsonl"), registry=Registry(),
        probe_interval_s=0.05, probe_timeout_s=1.0,
        startup_timeout_s=30.0).start()
    try:
        got = []
        t = threading.Thread(target=lambda: got.append(sup.add_slot()))
        t.start()
        assert wait_until(lambda: len(sup.slots) == 2), \
            "half-born slot not registered before the ready wait"
        half = sup.slots[1]
        assert wait_until(lambda: half.proc is not None)
        sup.stop()
        t.join(timeout=15.0)
        assert not t.is_alive(), "add_slot stayed wedged past stop()"
        assert got == [None]
        assert [s.name for s in sup.slots] == ["r0"], \
            "failed scale-up left a ghost slot in the registry"
        assert not half.proc.alive, "stop() leaked the half-born child"
    finally:
        sup.stop()


def test_add_slot_registers_before_spawn_is_load_bearing(tmp_path,
                                                         monkeypatch):
    """Register the slot only AFTER the spawn and stop()'s sweeps can no
    longer see the half-born child: it outlives the fleet, the leak the
    shipped ordering prevents."""
    from dryad_tpu_torch.fleet.supervisor import ReplicaSlot

    seen = []

    def late_register(self):
        if self._stop.is_set():
            return None
        with self._slots_lock:
            slot = ReplicaSlot(self._next_index)
            self._next_index += 1
        seen.append(slot)
        slot.recovering = True
        try:
            ok = self._spawn(slot, first=True)
        finally:
            slot.recovering = False
        if not ok:
            return None
        with self._slots_lock:
            self._slots.append(slot)
        return slot

    monkeypatch.setattr(FleetSupervisor, "add_slot", late_register)

    def make(index: int, port_file: str) -> list:
        if index == 0:
            return [sys.executable, STUB, "--port-file", port_file]
        return [sys.executable, "-c", "import time; time.sleep(60)"]

    sup = FleetSupervisor(
        make, 1, policy=RetryPolicy(backoff_base_s=0.0),
        journal=str(tmp_path / "fleet.jsonl"), registry=Registry(),
        probe_interval_s=0.05, probe_timeout_s=1.0,
        startup_timeout_s=30.0).start()
    t = threading.Thread(target=lambda: sup.add_slot())
    t.start()
    try:
        assert wait_until(lambda: seen and seen[0].proc is not None
                          and seen[0].proc.alive)
        sup.stop()
        assert seen[0].proc.alive, \
            "the sweep saw the unregistered child: this test is stale"
    finally:
        if seen and seen[0].proc is not None:
            seen[0].proc.stop()          # reap the demonstrated leak
        t.join(timeout=15.0)


# ---------------------------------------------------------------------------
# CapacityController decision logic (no subprocesses)

class _CtrlSlot:
    def __init__(self, index: int):
        self.index = index
        self.name = f"r{index}"
        self.fail_closed = False
        self.retiring = False
        self.routable = True
        self.inflight = 0


class _CtrlSup:
    """Supervisor stand-in: exactly the surface the controller drives."""

    def __init__(self, n: int):
        self._slots = [_CtrlSlot(i) for i in range(n)]
        self.events: list = []

    @property
    def slots(self):
        return list(self._slots)

    def journal(self, kind, /, **fields):
        self.events.append((kind, fields))

    def kinds(self):
        return [k for k, _ in self.events]

    def skip_reasons(self):
        return [f["reason"] for k, f in self.events if k == "scale_skipped"]

    def gauge_replicas(self):
        pass

    def routable_slots(self):
        return [s for s in self._slots if s.routable and not s.retiring]

    def add_slot(self):
        s = _CtrlSlot(len(self._slots))
        self._slots.append(s)
        return s

    def retire_slot(self, name, *, drain_timeout_s=30.0):
        s = next((x for x in self._slots if x.name == name), None)
        if s is None:
            return False
        self._slots.remove(s)
        return True


def _sig(mode: str) -> dict:
    return {
        "pressure": {"slo": {"interactive": {"breached": True,
                                             "sustained": True}},
                     "inflight": 9, "max_inflight": 10},
        "saturated": {"slo": {}, "inflight": 9, "max_inflight": 10},
        "headroom": {"slo": {}, "inflight": 0, "max_inflight": 10},
        "calm": {"slo": {}, "inflight": 5, "max_inflight": 10},
    }[mode]


def _controller(sup, sig, **kw):
    from dryad_tpu_torch.fleet.autoscale import CapacityController

    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("breach_after", 2)
    kw.setdefault("idle_after", 2)
    kw.setdefault("cooldown_up_s", 0.0)
    kw.setdefault("cooldown_down_s", 0.0)
    return CapacityController(sup, lambda: _sig(sig["mode"]),
                              registry=Registry(enabled=False), **kw)


def _settle(ctrl):
    assert wait_until(lambda: ctrl.state()["action_in_flight"] is None)


def test_capacity_sustain_admits_at_exactly_breach_after():
    sup = _CtrlSup(1)
    sig = {"mode": "pressure"}
    ctrl = _controller(sup, sig, breach_after=3)
    assert ctrl.poke() is None
    assert ctrl.poke() is None
    # two refusals, ONE journaled skip (debounced on the reason)
    assert sup.skip_reasons() == ["insufficient-sustain"]
    assert ctrl.poke() == "scale_up"
    _settle(ctrl)
    assert sup.kinds().count("scale_up") == 1
    assert len(sup.slots) == 2
    assert ctrl.state()["actions_total"] == {"up": 1, "down": 0}


def test_capacity_flapping_resets_streaks():
    sup = _CtrlSup(1)
    sig = {"mode": "pressure"}
    ctrl = _controller(sup, sig, breach_after=2)
    assert ctrl.poke() is None
    sig["mode"] = "calm"
    assert ctrl.poke() is None
    assert ctrl.state()["up_streak"] == 0
    sig["mode"] = "pressure"
    assert ctrl.poke() is None, "flapping traffic accumulated to an action"
    assert sup.kinds().count("scale_up") == 0


def test_capacity_saturation_alone_is_pressure():
    sup = _CtrlSup(1)
    ctrl = _controller(sup, {"mode": "saturated"}, breach_after=1)
    assert ctrl.poke() == "scale_up"
    _settle(ctrl)
    up = next(f for k, f in sup.events if k == "scale_up")
    assert up["saturated"] is True and up["slo_sustained"] == []


def test_capacity_bound_and_cooldown_refusals():
    sup = _CtrlSup(2)
    sig = {"mode": "pressure"}
    ctrl = _controller(sup, sig, breach_after=1, max_replicas=3,
                       cooldown_up_s=60.0)
    assert ctrl.poke() == "scale_up"
    _settle(ctrl)
    assert len(sup.slots) == 3
    assert ctrl.poke() is None
    assert sup.skip_reasons()[-1] == "at-bound"
    sup._slots.pop()                     # headroom to grow again, but...
    assert ctrl.poke() is None           # ...inside the up cooldown
    assert sup.skip_reasons()[-1] == "cooldown"
    assert sup.kinds().count("scale_up") == 1


def test_capacity_never_below_min_never_last_routable():
    sup = _CtrlSup(2)
    ctrl = _controller(sup, {"mode": "headroom"}, idle_after=1,
                       min_replicas=2)
    assert ctrl.poke() is None
    assert sup.skip_reasons() == ["at-bound"]
    # min allows a drain, but only one slot is routable: the victim
    # picker refuses (zero routable is an outage) and journals the miss
    sup2 = _CtrlSup(2)
    sup2._slots[0].routable = False
    ctrl2 = _controller(sup2, {"mode": "headroom"}, idle_after=1,
                        min_replicas=1)
    assert ctrl2.poke() == "scale_down"
    _settle(ctrl2)
    assert sup2.kinds().count("scale_down") == 0
    failed = next(f for k, f in sup2.events if k == "scale_failed")
    assert failed["direction"] == "down"
    assert len(sup2.slots) == 2


def test_capacity_in_flight_action_refuses_second():
    sup = _CtrlSup(3)
    gate = threading.Event()
    orig = sup.retire_slot

    def slow_retire(name, *, drain_timeout_s=30.0):
        gate.wait(10.0)
        return orig(name, drain_timeout_s=drain_timeout_s)

    sup.retire_slot = slow_retire
    ctrl = _controller(sup, {"mode": "headroom"}, idle_after=1)
    try:
        assert ctrl.poke() == "scale_down"
        assert ctrl.poke() is None
        assert sup.skip_reasons() == ["already-in-flight"]
    finally:
        gate.set()
    _settle(ctrl)
    assert sup.kinds().count("scale_down") == 1
    assert [s.name for s in sup.slots] == ["r0", "r1"]
    ctrl.stop(timeout_s=5.0)


def test_capacity_poll_loop_runs_and_stops():
    sup = _CtrlSup(1)
    sig = {"mode": "pressure"}
    ctrl = _controller(sup, sig, breach_after=1, max_replicas=2,
                       poll_interval_s=0.01).start()
    try:
        assert wait_until(lambda: sup.kinds().count("scale_up") == 1)
        assert wait_until(lambda: "at-bound" in sup.skip_reasons())
    finally:
        ctrl.stop(timeout_s=5.0)
    n = len(sup.events)
    time.sleep(0.1)
    assert len(sup.events) == n, "the poll loop survived stop()"


def test_capacity_validates_bounds():
    sup = _CtrlSup(1)
    with pytest.raises(ValueError):
        _controller(sup, {"mode": "calm"}, min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError):
        _controller(sup, {"mode": "calm"}, breach_after=0)
