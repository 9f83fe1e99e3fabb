"""Command line of the port: ``python -m dryad_tpu_torch
train|predict|dump|serve|profile``.

    python -m dryad_tpu_torch train --config params.json --data X.npy \
        --label y.npy [--valid Xv.npy --valid-label yv.npy] \
        [--model out.dryad] [--checkpoint-dir DIR --checkpoint-every N \
        --resume] [--supervise [--journal run.jsonl] [--retry-budget N]] \
        [--metrics-port N [--metrics-host H] [--auth-token T]] \
        [--trace-out trace.json] [--log-jsonl log.jsonl] \
        [--profile-dir DIR] [--device cuda|cpu] [--quiet]
    python -m dryad_tpu_torch predict --model m.dryad --data X.npy \
        --out preds.npy [--raw] [--device cuda|cpu]
    python -m dryad_tpu_torch dump --model m.dryad [--out m.json] [--text]
    python -m dryad_tpu_torch serve --model m.dryad --warmup
    python -m dryad_tpu_torch serve --model m.dryad --device cpu \
        --request rows.npy --out preds.npy
    python -m dryad_tpu_torch profile [--stage NAME ...] [--out p.json]
    python -m dryad_tpu_torch profile --calibrate --calib-out table.json
    python -m dryad_tpu_torch profile --check-calib
    python -m dryad_tpu_torch profile --selftest [--calibrate]

Data files: ``.npy`` (a dense matrix), ``.npz`` holding ``indptr``,
``indices``, ``values`` and ``num_features`` (CSR rows) or one array, or
``.csv`` (no header).  The params JSON takes the names and aliases of
``dryad_tpu_torch.train``.  Every command runs on the card unless given
``--device cpu``; with no card it raises (``predict`` too, where the
reference's ``--backend`` defaults to the CPU).

``train`` trains and saves a model file (npz; it loads in the reference
too) that carries its drift baseline (``data/profile.py``; set
``DRYAD_PROFILE=0`` to leave it out).  ``--metrics-port`` mounts the
metrics exporter (``obs/exporter.py``: ``/healthz``, ``/metrics``,
``/stats`` with the loop's spans, ``/trace``) before the data loads and
stops it after the run; ``DRYAD_METRICS_HOLD_S`` keeps it up that many
seconds more.  ``--trace-out`` writes the run's spans as Chrome
trace_event JSON (``obs/trace_export.py``), also when the run fails.
``--supervise`` trains under ``resilience.supervise_train`` (it needs
``--checkpoint-dir``; continuing a directory that already holds
checkpoints needs ``--resume``): classified faults resume from the newest
checkpoint within ``--retry-budget``, and ``--journal`` writes the run's
journal, tailed into the registry under ``--metrics-port``.  A sticky
CUDA error fails closed (exit non-zero); the same command with
``--resume`` continues the directory in a fresh process.  ``predict``
bins CSR ``.npz`` rows with ``bin_csr``.  ``dump`` prints ``dump_model()`` JSON, or with
``--text`` the versioned text model (``Booster.load_any`` reads it).

``serve`` loads one or more model files (npz or text, written by either
package; ``NAME=path`` registers a routing alias, the last model is
active) and answers HTTP requests (``serve/http.py``); ``--request`` runs
one matrix through the whole serving stack, writes the predictions to
``--out`` and exits.  ``--drift-window`` sets the drift monitors' window
in rows (0 turns them off).  ``--sharded auto|on|off`` splits big buckets
over every visible card (``serve/server.py``).

``profile`` is the reference's stage profiler: liveness-proven timed
walls of the named stage probes (``engine/probes.py``) on the card
(``--device cpu`` runs the plain versions), exported as
``dryad_stage_ms`` gauges and printed as a stamped PROFILE artifact
(``--out`` writes it; ``--trend-root`` compares it with a
``PROFILE_r*.json`` history).  ``--calibrate`` sweeps the policy gates'
probe pairs and derives this card's table entry (``--calib-out`` writes
the refreshed table); ``--check-calib`` compares a live sweep with the
committed table (exit 1 on drift).  ``--selftest`` is the CPU gate: the
seeded dead probe must be caught and every probe must pass liveness;
with ``--calibrate`` it checks the table and gates instead, no probes.
The reference's ``fleet`` and ``retrain`` commands are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _load_matrix(path: str):
    """A dense matrix from .npy, .npz (first array) or .csv, or
    ``("csr", (indptr, indices, values, num_features))`` from an .npz
    holding ``indptr``."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        z = np.load(path)
        if "indptr" in z.files:
            return ("csr", (z["indptr"], z["indices"], z["values"],
                            int(z["num_features"])))
        return z[z.files[0]]
    if path.endswith(".csv"):
        return np.loadtxt(path, delimiter=",", dtype=np.float32, ndmin=2)
    raise SystemExit(f"unsupported data format: {path} (use .npy/.npz/.csv)")


def _load_vector(path: str) -> np.ndarray:
    return np.asarray(_load_matrix(path)).reshape(-1)


def _make_dataset(data_path, label_path, group_path, params, mapper=None):
    import dryad_tpu_torch as dt

    y = _load_vector(label_path) if label_path else None
    group = _load_vector(group_path).astype(np.int64) if group_path else None
    X = _load_matrix(data_path)
    kw = dict(group=group, categorical_features=params.categorical_features,
              max_bins=params.max_bins, mapper=mapper)
    if isinstance(X, tuple):
        return dt.Dataset(None, y, csr=X[1], **kw)
    return dt.Dataset(X, y, **kw)


def cmd_train(args) -> int:
    import dryad_tpu_torch as dt
    from dryad_tpu_torch.callbacks import JsonlLogger, log_evaluation
    from dryad_tpu_torch.config import Params

    # argument checks first: a wrong invocation must not pay for the data
    # load (minutes at 10M rows)
    if args.valid and not args.valid_label:
        raise SystemExit("--valid requires --valid-label")
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")
    if args.supervise and not args.checkpoint_dir:
        raise SystemExit("--supervise requires --checkpoint-dir "
                         "(resume is the recovery mechanism)")
    if args.supervise and not args.resume:
        # faults mid-run always resume, but continuing a prior
        # invocation's checkpoints must be asked for, as without
        # supervision: a stale directory under changed params or data
        # would give a mixed model
        from dryad_tpu_torch.checkpoint import Checkpointer

        if Checkpointer.has_checkpoints(args.checkpoint_dir):
            raise SystemExit(
                f"--supervise found existing checkpoints in "
                f"{args.checkpoint_dir}; pass --resume to continue "
                "that run, or clear the directory to start fresh")
    if not args.supervise:
        if args.journal:
            raise SystemExit("--journal is the supervised-run journal; "
                             "it requires --supervise")
        if args.retry_budget is not None:
            raise SystemExit("--retry-budget configures the supervised "
                             "fault budget; it requires --supervise")
    try:
        hold = float(os.environ.get("DRYAD_METRICS_HOLD_S", "0") or 0)
    except ValueError:
        raise SystemExit("DRYAD_METRICS_HOLD_S must be a number, got "
                         f"{os.environ['DRYAD_METRICS_HOLD_S']!r}")
    if args.config:
        with open(args.config) as f:
            params = Params.from_dict(json.load(f))
    else:
        params = Params()
    # the device is resolved before the data loads: no card, no load
    device = dt.resolve_device(args.device)

    exporter = tail = None
    if args.metrics_port is not None:
        from dryad_tpu_torch.obs.exporter import start_exporter
        from dryad_tpu_torch.obs.trends import stats_provider

        # mounted before the data loads, so /healthz answers for the run;
        # /stats carries the trend report of the cwd's BENCH_r*.json
        # history under "bench_trends" (empty without one)
        exporter = start_exporter(host=args.metrics_host,
                                  port=args.metrics_port,
                                  auth_token=args.auth_token,
                                  extra_stats=[stats_provider()])
        if not args.quiet:
            print(f"metrics on http://{exporter.host}:{exporter.port}  "
                  "(GET /stats, /metrics, /trace, /healthz)")
        if args.journal:
            # the supervised run's fault, backoff and resume series appear
            # on /stats as they happen
            from dryad_tpu_torch.obs.journal_tail import JournalTail

            tail = JournalTail(args.journal).start()
    trace_buf = None
    if args.trace_out:
        from dryad_tpu_torch.obs import trace_export

        trace_buf = trace_export.enable_tracing()
        # the ring is process-wide: this run's trace holds this run's spans
        trace_buf.clear()

    logger = None
    # everything after the exporter starts runs under the finally that
    # stops it, so a bad --data path leaks no server thread
    try:
        ds = _make_dataset(args.data, args.label, args.group, params)
        valid_sets = None
        if args.valid:
            valid_sets = [_make_dataset(args.valid, args.valid_label,
                                        args.valid_group, params,
                                        mapper=ds.mapper)]
        callbacks = []
        if not args.quiet:
            callbacks.append(log_evaluation(period=args.log_period))
        if args.log_jsonl:
            logger = JsonlLogger(args.log_jsonl)
            callbacks.append(logger)
        if args.supervise:
            from dryad_tpu_torch.resilience import (RetryPolicy,
                                                    supervise_train)

            policy = (RetryPolicy() if args.retry_budget is None
                      else RetryPolicy(retry_budget=args.retry_budget))
            booster = supervise_train(
                params, ds, valid_sets, device=device, policy=policy,
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every,
                journal=args.journal, callbacks=callbacks,
                profile_dir=args.profile_dir)
        else:
            booster = dt.train(params, ds, valid_sets, callbacks=callbacks,
                               checkpoint_dir=args.checkpoint_dir,
                               checkpoint_every=args.checkpoint_every,
                               resume=args.resume, device=device,
                               profile_dir=args.profile_dir)
    finally:
        if trace_buf is not None:
            from dryad_tpu_torch.obs import trace_export

            try:
                journal_events = ()
                if args.journal and os.path.exists(args.journal):
                    from dryad_tpu_torch.resilience.journal import RunJournal

                    journal_events = RunJournal.read_last_run(args.journal)
                trace_export.write_trace(args.trace_out,
                                         span_events=trace_buf.events(),
                                         journal_events=journal_events)
                if not args.quiet:
                    print(f"wrote Chrome trace -> {args.trace_out}")
            except Exception as e:  # noqa: BLE001 — the trace must not
                print(f"trace export failed: {e!r}",  # hide a training
                      file=sys.stderr)                # error
            finally:
                trace_export.disable_tracing()
        if logger is not None:
            logger.close()
        if exporter is not None and hold > 0:
            time.sleep(hold)
        if tail is not None:
            tail.stop()
        if exporter is not None:
            exporter.stop()
    if args.model:
        booster.save(args.model)
        if not args.quiet:
            print(f"saved {booster.num_iterations} iterations -> {args.model}")
    return 0


def cmd_predict(args) -> int:
    import dryad_tpu_torch as dt

    device = dt.resolve_device(args.device)
    booster = dt.Booster.load_any(args.model)
    X = _load_matrix(args.data)
    if isinstance(X, tuple):
        from dryad_tpu_torch.data.binning import bin_csr

        indptr, indices, values, nf = X[1]
        Xb = bin_csr(indptr, indices, values, nf, booster.mapper)
        preds = booster.predict_binned(Xb, raw_score=args.raw, device=device)
    else:
        preds = booster.predict(np.asarray(X, np.float32), raw_score=args.raw,
                                device=device)
    np.save(args.out, preds)
    print(f"wrote predictions {preds.shape} -> {args.out}")
    return 0


def cmd_dump(args) -> int:
    import dryad_tpu_torch as dt

    booster = dt.Booster.load_any(args.model)
    text = (booster.dump_text() if args.text
            else json.dumps(booster.dump_model(), indent=2))
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    else:
        print(text)
    return 0


def cmd_serve(args) -> int:
    from dryad_tpu_torch.serve import PredictServer

    if args.request and not args.out:
        raise SystemExit("--request requires --out")
    server = PredictServer(
        device=args.device,
        max_batch_rows=args.max_batch_rows,
        max_wait_ms=args.max_wait_ms,
        queue_size=args.queue_size,
        pipeline_depth=args.pipeline_depth,
        device_budget_bytes=(args.device_budget_mb * (1 << 20)
                             if args.device_budget_mb else None),
        sharded={"auto": "auto", "on": True, "off": False}[args.sharded],
        drift="off" if args.drift_window == 0 else "auto",
        drift_window=args.drift_window,
    )
    for spec in args.model:
        # NAME=path registers an alias; a spec that exists on disk, or
        # whose left part looks like a path, is a plain path
        name, path = None, spec
        if "=" in spec and not os.path.exists(spec):
            cand, _, rest = spec.partition("=")
            if cand and "/" not in cand and "\\" not in cand:
                name, path = cand, rest
        version = server.load_model(path, name=name)
        if not args.quiet:
            alias = f" (name {name!r})" if name else ""
            print(f"loaded {path} -> version {version}{alias}")

    if args.warmup:
        touched = server.warmup()
        if not args.quiet:
            print(f"warmed {touched} (version, bucket) programs; "
                  "recompile tripwire armed")

    if args.request:
        X = _load_matrix(args.request)
        with server:
            if isinstance(X, tuple):
                from dryad_tpu_torch.data.binning import bin_csr

                indptr, indices, values, nf = X[1]
                mapper = server.registry.get().booster.mapper
                Xb = bin_csr(indptr, indices, values, nf, mapper)
                preds = server.predict(Xb, raw_score=args.raw, binned=True)
            else:
                preds = server.predict(np.asarray(X, np.float32),
                                       raw_score=args.raw)
        np.save(args.out, preds)
        if not args.quiet:
            print(f"wrote predictions {preds.shape} -> {args.out}")
            print(json.dumps(server.stats(), indent=1))
        return 0

    from dryad_tpu_torch.serve.http import make_http_server

    httpd = make_http_server(server, args.host, args.port,
                             verbose=not args.quiet,
                             log_requests=args.log_requests,
                             auth_token=args.auth_token)
    host, port = httpd.server_address[:2]
    if args.port_file:
        # write-then-rename, so a watcher never reads a half-written file
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{host} {port}\n")
        os.replace(tmp, args.port_file)
    print(f"dryad serving on http://{host}:{port}  "
          f"(device={server.device}; POST /predict, GET /stats)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.stop()
        print(json.dumps(server.stats(), indent=1))
    return 0


def cmd_profile(args) -> int:
    """The stage profiler and the calibration sweep (module doc)."""
    from dryad_tpu_torch.engine import probes

    if args.list:
        for name, probe in probes.PROBES.items():
            print(f"{name:26s} {probe.doc}")
        return 0
    if args.selftest and (args.calibrate or args.check_calib):
        from dryad_tpu_torch.policy import calibrate as calib

        return calib.run_selftest(quiet=args.quiet)
    if args.selftest:
        return probes.run_selftest(quiet=args.quiet)
    if args.calibrate or args.check_calib:
        return _profile_calibrate(args)

    names = args.stage or list(probes.PROBES)
    unknown = [n for n in names if n not in probes.PROBES]
    if unknown:
        raise SystemExit(f"unknown stage(s): {unknown} (see --list)")
    results = []
    for name in names:
        r = probes.run_probe(name, rows=args.rows, K=args.k,
                             reps=args.reps, num_slots=args.slots,
                             device=args.device)
        if not args.quiet:
            flag = ("  SUSPECT CAPTURE"
                    if r["spread"] > probes.SPREAD_SUSPECT else "")
            print(f"stage {name:26s} {r['ms']:10.3f} ms  "
                  f"spread {r['spread']:.3f}{flag}")
        results.append(r)

    from dryad_tpu_torch.obs.profiler import export_stages, profile_artifact
    from dryad_tpu_torch.obs.trends import (
        PROFILE_PATTERN,
        compare,
        load_history,
    )
    from dryad_tpu_torch.policy.device import current_device_kind

    export_stages(results)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    art = profile_artifact(results, device_kind=current_device_kind(),
                           root=root)
    print(json.dumps(art))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(art, f, indent=1)
            f.write("\n")
    if args.check_trend and not args.trend_root:
        raise SystemExit("--check-trend requires --trend-root (the "
                         "directory holding the PROFILE_r*.json history)")
    if args.trend_root:
        history = load_history(args.trend_root, pattern=PROFILE_PATTERN)
        if not history:
            # an empty or mistyped history must not pass a gate
            msg = (f"no loadable PROFILE_r*.json under {args.trend_root!r}"
                   " - nothing to compare")
            if args.check_trend:
                raise SystemExit(msg)
            print(msg, file=sys.stderr)
        else:
            report = compare(history)
            print(json.dumps({"profile_trends": report}))
            if args.check_trend and not report["ok"]:
                return 1
    return 0


def _profile_calibrate(args) -> int:
    """``profile --calibrate`` / ``--check-calib`` (module doc)."""
    from dryad_tpu_torch.policy import calibrate as calib
    from dryad_tpu_torch.policy import table as ptable
    from dryad_tpu_torch.policy.device import current_device_kind

    kind = current_device_kind()
    if args.check_calib:
        report = calib.check_calib(device_kind=kind, rows=args.rows,
                                   quiet=args.quiet, device=args.device)
        print(json.dumps({"calib_check": report}))
        return 0 if report["ok"] else 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    devices, artifact = calib.calibrate(device_kind=kind, rows=args.rows,
                                        quiet=args.quiet, device=args.device,
                                        root=root)
    print(json.dumps(artifact))
    if args.calib_out:
        ptable.save_table(devices, args.calib_out)
        if not args.quiet:
            print(f"calibration table ({len(devices)} device entr"
                  f"{'y' if len(devices) == 1 else 'ies'}) -> "
                  f"{args.calib_out}", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
            f.write("\n")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m dryad_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a booster")
    t.add_argument("--config", help="params JSON file")
    t.add_argument("--data", required=True)
    t.add_argument("--label", required=True)
    t.add_argument("--group", help="query sizes for ranking")
    t.add_argument("--valid")
    t.add_argument("--valid-label")
    t.add_argument("--valid-group")
    t.add_argument("--model", help="output model path")
    t.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    t.add_argument("--checkpoint-dir")
    t.add_argument("--checkpoint-every", type=int, default=10)
    t.add_argument("--resume", action="store_true")
    t.add_argument("--supervise", action="store_true",
                   help="supervised run: classify device faults and "
                        "resume from the newest checkpoint (needs "
                        "--checkpoint-dir)")
    t.add_argument("--journal",
                   help="supervised-run journal JSONL path (with --supervise)")
    t.add_argument("--retry-budget", type=int, default=None,
                   help="supervised-run fault budget before failing closed")
    t.add_argument("--log-jsonl", help="per-iteration metrics JSONL path")
    t.add_argument("--profile-dir",
                   help="trace the run with torch.profiler into this "
                        "directory (train_trace.json)")
    t.add_argument("--trace-out",
                   help="write the run's span tree as Chrome trace_event "
                        "JSON here (Perfetto-loadable)")
    t.add_argument("--log-period", type=int, default=1)
    t.add_argument("--metrics-port", type=int, default=None,
                   help="serve /stats, /metrics, /trace and /healthz on "
                        "this port for the run (0 = any free port)")
    t.add_argument("--metrics-host", default="127.0.0.1")
    t.add_argument("--auth-token", default=os.environ.get("DRYAD_AUTH_TOKEN"),
                   help="bearer token for the metrics endpoint (env "
                        "DRYAD_AUTH_TOKEN; /healthz stays open)")
    t.add_argument("--quiet", action="store_true")
    t.set_defaults(fn=cmd_train)

    pr = sub.add_parser("predict", help="predict with a saved model")
    pr.add_argument("--model", required=True)
    pr.add_argument("--data", required=True)
    pr.add_argument("--out", required=True)
    pr.add_argument("--raw", action="store_true", help="raw scores (no link)")
    pr.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pr.set_defaults(fn=cmd_predict)

    d = sub.add_parser("dump", help="dump the model as JSON")
    d.add_argument("--model", required=True)
    d.add_argument("--out")
    d.add_argument("--text", action="store_true",
                   help="the versioned text model (Booster.load_any reads "
                        "it back)")
    d.set_defaults(fn=cmd_dump)
    s = sub.add_parser("serve", help="online inference service")
    s.add_argument("--model", required=True, action="append",
                   help="model path (npz or text), or NAME=path for a "
                        "routing alias; repeat to co-serve several models, "
                        "the last one active")
    s.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--max-batch-rows", type=int, default=4096,
                   help="micro-batch row cap (also the largest bucket)")
    s.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="batch coalescing deadline")
    s.add_argument("--queue-size", type=int, default=256,
                   help="bounded request queue (backpressure)")
    s.add_argument("--pipeline-depth", type=int, default=2,
                   help="overlapped dispatch run-ahead (1 = serial loop)")
    s.add_argument("--device-budget-mb", type=int, default=0,
                   help="staged-model memory budget; 0 = unlimited (LRU "
                        "eviction, active version pinned)")
    s.add_argument("--sharded", default="auto", choices=["auto", "on", "off"],
                   help="split big predict buckets over every visible card "
                        "(auto: from 32768 row-outputs when there are two or "
                        "more; on: every bucket that divides)")
    s.add_argument("--drift-window", type=int, default=8192,
                   help="drift monitor window in rows of recent traffic, "
                        "for models that carry a reference profile; 0 "
                        "turns drift telemetry off")
    s.add_argument("--warmup", action="store_true",
                   help="capture every (version, bucket) program at "
                        "startup and arm the recompile tripwire")
    s.add_argument("--log-requests", action="store_true",
                   help="structured JSON request log on stderr")
    s.add_argument("--auth-token", default=os.environ.get("DRYAD_AUTH_TOKEN"),
                   help="bearer token required on every endpoint but "
                        "/healthz and /clock (env DRYAD_AUTH_TOKEN)")
    s.add_argument("--request", help="one-shot mode: predict this matrix "
                                     "through the serving stack and exit")
    s.add_argument("--out", help="one-shot mode: output .npy path")
    s.add_argument("--raw", action="store_true", help="raw scores (no link)")
    s.add_argument("--port-file",
                   help="write 'host port' here once listening (atomic "
                        "rename), for --port 0")
    s.add_argument("--quiet", action="store_true")
    s.set_defaults(fn=cmd_serve)

    pf = sub.add_parser("profile",
                        help="stage-level device profiler (timed harness "
                             "with runtime liveness proofs)")
    pf.add_argument("--selftest", action="store_true",
                    help="prove the liveness proof: the seeded dead probe "
                         "must be rejected, every shipped probe must pass "
                         "(CPU, seconds)")
    pf.add_argument("--list", action="store_true",
                    help="print the stage-probe catalog and exit")
    pf.add_argument("--stage", action="append", default=None,
                    help="restrict to the named stage(s); repeatable")
    pf.add_argument("--rows", type=int, default=None,
                    help="probe row count (default: 1M on the card, 8192 "
                         "on the CPU)")
    pf.add_argument("--k", type=int, default=3,
                    help="dependent steps inside one timed run")
    pf.add_argument("--reps", type=int, default=2,
                    help="timed runs per probe (min is the estimator)")
    pf.add_argument("--slots", type=int, default=64,
                    help="segment/slot count P for the per-level stages")
    pf.add_argument("--out", help="also write the stamped PROFILE (or, "
                                  "with --calibrate, CALIB) JSON here")
    pf.add_argument("--calibrate", action="store_true",
                    help="A/B-sweep the dispatch-gate probes and derive a "
                         "refreshed device-keyed policy table (with "
                         "--selftest: the seeded CPU table/gates gate, no "
                         "probes)")
    pf.add_argument("--check-calib", action="store_true",
                    help="compare a live sweep's gate resolutions with the "
                         "committed policy table; exit 1 on drift (spread-"
                         "vetoed)")
    pf.add_argument("--calib-out", default=None,
                    help="with --calibrate: write the refreshed calibration "
                         "table JSON here (committed devices + this one)")
    pf.add_argument("--trend-root", default=None,
                    help="compare against the PROFILE_r*.json history in "
                         "this directory (newest against median, spread "
                         "veto)")
    pf.add_argument("--check-trend", action="store_true",
                    help="exit 1 on a profile-trend regression verdict")
    pf.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the probes run (no card and no --device "
                         "cpu: it raises)")
    pf.add_argument("--quiet", action="store_true")
    pf.set_defaults(fn=cmd_profile)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
