"""Closed-loop fleet benchmark: rows/s through the router, over HTTP.

The serve bench (``serve/bench.py``) measures one in-process
``PredictServer``; this measures the whole fleet path — router
admission, forwarding, the replicas' own HTTP front ends — with REAL
subprocess replicas.  It imports no torch: every number comes back over
the wire, so the bench measures what a client sees, not what the process
could do in-process.  On one card the replicas share the device, so the
replica sweep measures routing and shedding, not scale-out.

Two arms:

* **scaling** — the same closed loop against fleets of each replica
  count (``fleet_rows_per_s_nN`` and per-arm spreads).  Closed loop
  (clients wait for each answer, so concurrency is exact), arms with a
  spread field because walls here are end-to-end HTTP, and the payload
  bytes are pre-encoded so the client loop measures the FLEET, not
  ``json.dumps``.
* **rolling-swap drill** — a 2-replica fleet under continuous interactive
  load takes a ``/models/push`` mid-loop; the drill asserts zero failed
  requests (the zero-drop contract) and records the swap wall and the
  version mix the clients observed (both versions MUST appear: proof the
  swap really happened under load, not after it).
"""

from __future__ import annotations

import http.client
import json
import random
import threading
import time
from typing import Optional, Sequence

from dryad_tpu_torch.fleet.replica import serve_argv
from dryad_tpu_torch.fleet.router import FleetRouter
from dryad_tpu_torch.fleet.supervisor import FleetSupervisor
from dryad_tpu_torch.obs.registry import (REQUEST_LATENCY, Registry,
                                          hist_quantile)
from dryad_tpu_torch.resilience.policy import RetryPolicy

SPREAD_SUSPECT = 0.05    # per-arm spread above this flags the capture
#: the priorities the bench reports percentiles for (router admission
#: classes; bulk gets its own short loop so its series is populated)
BENCH_PRIORITIES = ("interactive", "bulk")


def _payloads(num_features: int, sizes: Sequence[int], seed: int) -> dict:
    """size -> pre-encoded /predict body bytes (one per size: the loop
    must measure the fleet, not request construction)."""
    rng = random.Random(seed)
    out = {}
    for n in sizes:
        rows = [[rng.uniform(-2.0, 2.0) for _ in range(num_features)]
                for _ in range(n)]
        out[n] = json.dumps({"rows": rows}).encode()
    return out


def _closed_loop(host: str, port: int, payloads: dict, *, clients: int,
                 duration_s: float, seed: int,
                 priority: str = "interactive",
                 trace: bool = False,
                 on_response=None) -> dict:
    """Run the closed loop; returns requests/rows/failures and elapsed.
    ``on_response(status, body_bytes)`` (when set) sees every answer —
    the swap drill uses it to tally versions.  With ``trace=True`` every
    request carries a unique ``X-Dryad-Trace`` id and the loop counts
    responses whose echoed id does not round-trip
    (``trace_mismatches``; a successful answer MUST echo the id)."""
    sizes = sorted(payloads)
    counts = [0] * clients
    rows = [0] * clients
    failures = [0] * clients
    mismatches = [0] * clients
    barrier = threading.Barrier(clients + 1)
    stop_at = [float("inf")]

    def client(ci: int) -> None:
        crng = random.Random(seed + 7919 * (ci + 1))
        conn = http.client.HTTPConnection(host, port, timeout=30.0)
        headers = {"Content-Type": "application/json",
                   "X-Dryad-Priority": priority}
        barrier.wait()
        try:
            while time.perf_counter() < stop_at[0]:
                n = crng.choice(sizes)
                if trace:
                    headers["X-Dryad-Trace"] = (
                        f"bench{seed & 0xffff:04x}{ci:02x}{counts[ci]:06x}")
                try:
                    conn.request("POST", "/predict", body=payloads[n],
                                 headers=headers)
                    resp = conn.getresponse()
                    body = resp.read()
                    status = resp.status
                    echoed = resp.getheader("X-Dryad-Trace")
                except (OSError, http.client.HTTPException):
                    conn.close()
                    conn = http.client.HTTPConnection(host, port,
                                                      timeout=30.0)
                    status, body, echoed = 0, b"", None
                counts[ci] += 1
                if status == 200:
                    rows[ci] += n
                    if trace and echoed != headers["X-Dryad-Trace"]:
                        mismatches[ci] += 1
                else:
                    failures[ci] += 1
                if on_response is not None:
                    on_response(status, body)
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(ci,), daemon=True)
               for ci in range(clients)]
    for t in threads:
        t.start()
    stop_at[0] = time.perf_counter() + float(duration_s)
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t0
    return {"requests": sum(counts), "rows": sum(rows),
            "failures": sum(failures), "elapsed_s": elapsed,
            "trace_mismatches": sum(mismatches),
            "rows_per_s": sum(rows) / elapsed if elapsed > 0 else 0.0}


def _start_fleet(model_path: str, n_replicas: int, *, device: str,
                 max_batch_rows: int, max_wait_ms: float,
                 warmup: bool, startup_timeout_s: float,
                 max_inflight: int) -> tuple:
    def make_argv(index: int, port_file: str) -> list:
        return serve_argv([model_path], port_file, device=device,
                          max_batch_rows=max_batch_rows,
                          max_wait_ms=max_wait_ms, warmup=warmup)

    # a PRIVATE registry per fleet: the router's per-priority latency
    # histograms are what the bench reads back as p50/p95/p99, so they
    # must not mix with a previous arm's (or the process default's)
    reg = Registry()
    sup = FleetSupervisor(make_argv, n_replicas,
                          policy=RetryPolicy(backoff_base_s=0.1),
                          registry=reg,
                          startup_timeout_s=startup_timeout_s)
    sup.start()
    router = FleetRouter(sup, registry=reg,
                         max_inflight=max_inflight).start()
    return sup, router, reg


def _replica_layouts(sup: FleetSupervisor) -> Optional[str]:
    """The fleet's served predict layout, read over the wire from one
    routable replica's ``/stats`` (the registry's
    ``memory.staged_layouts`` block).  This module imports no torch, so
    the layout is observed exactly as an operator would see it — via
    HTTP, never by loading the model.  None when no replica answers or
    the replica predates the field (protocol stubs in tests)."""
    for slot in sup.routable_slots():
        if slot.proc is None:
            continue
        try:
            status, payload = slot.proc.request("GET", "/stats",
                                                timeout_s=5.0)
            if status != 200:
                continue
            layouts = (json.loads(payload).get("memory") or {}).get(
                "staged_layouts") or {}
            if layouts:
                # one model per bench fleet; newest staged version wins
                return layouts[max(layouts, key=int)]
        except (OSError, ValueError):
            continue
    return None


def _router_states(reg: Registry) -> dict:
    """priority -> the router's end-to-end (stage="router") histogram
    state — snapshotted after warmup so percentiles cover MEASURED
    traffic only."""
    fam = reg.log_histogram(REQUEST_LATENCY)
    return {p: fam.labels(priority=p, stage="router").value()
            for p in BENCH_PRIORITIES}


def _router_percentiles(reg: Registry,
                        baseline: Optional[dict] = None) -> dict:
    """priority -> {p50_ms, p95_ms, p99_ms, count} from the router's
    log-bucket histograms, minus ``baseline`` (the post-warmup snapshot:
    cold-start first-connection latencies would otherwise sit exactly in
    the reported — and trend-gated — p99 tail)."""
    out = {}
    for priority, (counts, _total, n) in _router_states(reg).items():
        if baseline is not None and priority in baseline:
            bc, _bt, bn = baseline[priority]
            counts = [a - b for a, b in zip(counts, bc)]
            n -= bn
        out[priority] = {
            "count": int(n),
            "p50_ms": round(hist_quantile(counts, 0.50) * 1e3, 3),
            "p95_ms": round(hist_quantile(counts, 0.95) * 1e3, 3),
            "p99_ms": round(hist_quantile(counts, 0.99) * 1e3, 3),
        }
    return out


def run_fleet_bench(model_path: str, num_features: int, *,
                    device: str = "cuda",
                    replica_counts: Sequence[int] = (1, 2, 4),
                    clients: int = 8, duration_s: float = 2.0,
                    sizes: Sequence[int] = (1, 3, 9, 17),
                    arms: int = 2, seed: int = 0,
                    max_batch_rows: int = 256, max_wait_ms: float = 1.0,
                    warmup: bool = False,
                    swap_drill: bool = True,
                    swap_model_path: Optional[str] = None,
                    swap_replicas: int = 2,
                    startup_timeout_s: float = 120.0,
                    max_inflight: int = 256,
                    verbose: bool = False) -> dict:
    """The full fleet arm: scaling sweep + rolling-swap drill.  Returns a
    flat report dict (``fleet_rows_per_s_nN``, ``fleet_spread_nN``,
    ``fleet_scaling_nK``, ``fleet_swap_*``)."""
    payloads = _payloads(int(num_features), sizes, seed)
    report: dict = {"bench": "serve_fleet", "fleet_clients": clients,
                    "fleet_duration_s": duration_s,
                    "fleet_device": device}
    base_n = min(replica_counts)
    for n in replica_counts:
        sup, router, reg = _start_fleet(
            model_path, n, device=device, max_batch_rows=max_batch_rows,
            max_wait_ms=max_wait_ms, warmup=warmup,
            startup_timeout_s=startup_timeout_s, max_inflight=max_inflight)
        try:
            # one untimed pass warms every replica's compile caches so the
            # measured arms see steady state, not first-touch compiles
            _closed_loop(router.host, router.port, payloads,
                         clients=clients, duration_s=min(duration_s, 1.0),
                         seed=seed - 1)
            # percentile baseline AFTER warmup: the reported (and
            # trend-gated) p99 must cover measured traffic only
            pct_base = _router_states(reg)
            if "fleet_predict_layout" not in report:
                # which traversal layout (packed or SoA) the
                # replicas actually staged — read over the wire so the
                # rows/s numbers are attributable to a layout arm
                layout = _replica_layouts(sup)
                if layout is not None:
                    report["fleet_predict_layout"] = layout
            arm_rates = []
            failures = 0
            mismatches = 0
            for arm in range(max(1, int(arms))):
                loop = _closed_loop(router.host, router.port, payloads,
                                    clients=clients, duration_s=duration_s,
                                    seed=seed + 100 * (arm + 1),
                                    trace=True)
                arm_rates.append(loop["rows_per_s"])
                failures += loop["failures"]
                mismatches += loop["trace_mismatches"]
            # a short bulk pass populates the bulk-priority series so the
            # percentile report covers BOTH admission classes (kept out
            # of the timed arms: the rows/s trend keys off the historic
            # interactive-only workload)
            bulk = _closed_loop(router.host, router.port, payloads,
                                clients=min(2, clients),
                                duration_s=min(duration_s, 1.0),
                                seed=seed + 7, priority="bulk")
            failures += bulk["failures"]
            pcts = _router_percentiles(reg, baseline=pct_base)
        finally:
            router.stop()
            sup.stop()
        spread = (max(arm_rates) / min(arm_rates) - 1
                  if len(arm_rates) > 1 and min(arm_rates) > 0 else 0.0)
        rate = sum(arm_rates) / len(arm_rates)
        report[f"fleet_rows_per_s_n{n}"] = round(rate, 1)
        report[f"fleet_spread_n{n}"] = round(spread, 3)
        report[f"fleet_failures_n{n}"] = failures
        report[f"fleet_trace_mismatches_n{n}"] = mismatches
        # per-priority latency percentiles (p99 budgets per priority
        # class, not just rows/s) — obs/trends.py tracks these fields
        # like bench walls
        for priority, p in pcts.items():
            for key in ("p50_ms", "p95_ms", "p99_ms"):
                report[f"fleet_{priority}_{key}_n{n}"] = p[key]
        if verbose:
            print(f"fleet n={n}: {rate:.0f} rows/s "
                  f"(spread {spread:.3f}, {failures} failures; "
                  f"interactive p99 {pcts['interactive']['p99_ms']} ms)")
    for n in replica_counts:
        if n != base_n:
            base = report[f"fleet_rows_per_s_n{base_n}"]
            report[f"fleet_scaling_n{n}"] = round(
                report[f"fleet_rows_per_s_n{n}"] / base, 3) if base else 0.0
    report["suspect_capture"] = any(
        report.get(f"fleet_spread_n{n}", 0.0) > SPREAD_SUSPECT
        for n in replica_counts)

    if swap_drill:
        report.update(run_swap_drill(
            model_path, num_features,
            swap_model_path=swap_model_path or model_path,
            device=device, n_replicas=swap_replicas, clients=clients,
            duration_s=max(2.0, duration_s), sizes=sizes, seed=seed,
            max_batch_rows=max_batch_rows, max_wait_ms=max_wait_ms,
            startup_timeout_s=startup_timeout_s,
            max_inflight=max_inflight, verbose=verbose))
    return report


def run_swap_drill(model_path: str, num_features: int, *,
                   swap_model_path: str, device: str = "cuda",
                   n_replicas: int = 2, clients: int = 4,
                   duration_s: float = 2.0,
                   sizes: Sequence[int] = (1, 3, 9, 17), seed: int = 0,
                   max_batch_rows: int = 256, max_wait_ms: float = 1.0,
                   startup_timeout_s: float = 120.0,
                   max_inflight: int = 256,
                   verbose: bool = False) -> dict:
    """Rolling swap under load: zero failed requests, both versions seen."""
    payloads = _payloads(int(num_features), sizes, seed)
    sup, router, _reg = _start_fleet(
        model_path, n_replicas, device=device,
        max_batch_rows=max_batch_rows, max_wait_ms=max_wait_ms,
        warmup=False, startup_timeout_s=startup_timeout_s,
        max_inflight=max_inflight)
    versions: dict = {}
    vlock = threading.Lock()

    def on_response(status: int, body: bytes) -> None:
        if status != 200:
            return
        try:
            v = json.loads(body).get("version")
        except ValueError:
            return
        with vlock:
            versions[v] = versions.get(v, 0) + 1

    swap: dict = {}

    def pusher() -> None:
        # fire mid-loop so both versions serve under measurement
        time.sleep(duration_s * 0.3)
        t0 = time.perf_counter()
        swap.update(sup.rolling_push(swap_model_path))
        swap["wall_s"] = time.perf_counter() - t0

    try:
        push_thread = threading.Thread(target=pusher, daemon=True)
        push_thread.start()
        loop = _closed_loop(router.host, router.port, payloads,
                            clients=clients, duration_s=duration_s,
                            seed=seed + 31, on_response=on_response)
        push_thread.join(timeout=120.0)
    finally:
        router.stop()
        sup.stop()
    return {
        "fleet_swap_requests": loop["requests"],
        "fleet_swap_failed": loop["failures"] + len(swap.get("errors", {})),
        "fleet_swap_wall_s": round(swap.get("wall_s", float("nan")), 3),
        "fleet_swap_versions_seen": len(versions),
        "fleet_swap_replicas_swapped": len(swap.get("versions", {})),
    }
