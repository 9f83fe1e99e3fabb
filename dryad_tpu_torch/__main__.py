"""Command line of the port: ``python -m dryad_tpu_torch
train|predict|dump|serve|retrain|fleet|profile``.

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
    python -m dryad_tpu_torch retrain --model m.dryad --data fresh.npz \
        --out m-gen1.dryad [--trees 20] [--refit-decay 0.9] [--supervise] \
        [--job-index N] [--text] [--device cuda|cpu]
    python -m dryad_tpu_torch fleet --model m=m.dryad --replicas 2 \
        --port 8000 [--min-replicas 1 --max-replicas 3] \
        [--journal fleet.jsonl [--continual-data fresh.npz \
        --retrain-device cuda|cpu]] [--device cuda|cpu]
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

``serve`` records request spans for ``/trace`` and ``/trace/events``
unless ``DRYAD_TRACE=0``, and arms the replica fault drill of
``DRYAD_REPLICA_FAULTS`` (``resilience/faults.py``; a malformed spec stops
start-up).  ``retrain`` is the continual-boosting worker: it loads a
served artifact and appends ``--trees`` trees on fresh rows (an npz with
``X`` and ``y``, or a directory of npz shards streamed through
``data/streaming.py``) in the model's frozen bin space, and saves the
generation with a fresh drift profile; ``DRYAD_CONTINUAL_FAULTS`` arms its
``bad_generation`` drill.  ``fleet`` runs ``--replicas`` serve processes
(``--device``; several share one card) under ``fleet/``'s supervisor
behind its router; ``--min-replicas``/``--max-replicas`` arm the capacity
loop and ``--continual-data`` the drift-triggered retrain loop
(``continual/``; it needs ``--journal`` and ``NAME=path`` specs).  Unlike
the reference, whose retrains default to the CPU, ``--retrain-device``
defaults to the card; ``--retrain-device cpu`` keeps retrains off it.
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

    from dryad_tpu_torch.resilience.faults import injector_from_env
    from dryad_tpu_torch.serve.http import make_http_server

    # request tracing: the span ring behind /trace and /trace/events, which
    # a fleet router merges; DRYAD_TRACE=0 turns it off
    if os.environ.get("DRYAD_TRACE", "1") != "0":
        from dryad_tpu_torch.obs.trace_export import enable_tracing

        enable_tracing()

    # the replica fault drill (a fleet supervisor arms it through the
    # environment): an absent or empty variable costs nothing, a malformed
    # spec raises here, before the port file announces the replica
    fault_hook = injector_from_env()
    httpd = make_http_server(server, args.host, args.port,
                             verbose=not args.quiet,
                             log_requests=args.log_requests,
                             auth_token=args.auth_token,
                             fault_hook=fault_hook)
    host, port = httpd.server_address[:2]
    if args.port_file:
        # the fleet's readiness handshake for --port 0 replicas;
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


def cmd_retrain(args) -> int:
    """The continual-boosting retrain worker: the only torch-importing
    piece of the drift -> retrain -> publish loop.  The scheduler
    (``continual/scheduler.py``) launches one of these as a subprocess a
    job, so a wedged card fails here, not in the fleet's control plane.

    Loads the served artifact, warm-start APPENDS ``--trees`` new trees
    on the fresh rows (``--data``: an npz with ``X`` and ``y``, or a
    directory of npz shards, binned in the model's frozen bin space),
    optionally after a ``Booster.refit`` re-weighting pass, and saves the
    new generation with a fresh reference profile.
    ``DRYAD_CONTINUAL_FAULTS`` (e.g. ``retrain:1:bad_generation``) is the
    drill: a fired ``bad_generation`` point trains on the covariates
    scaled by 0.25, a valid model whose profile breaches against live
    traffic, as a poisoned data pipeline would ship (the probation window
    must catch it)."""
    # every generation ships a drift baseline unless explicitly disabled
    os.environ.setdefault("DRYAD_PROFILE", "1")

    import dryad_tpu_torch as dt
    from dryad_tpu_torch.resilience.faults import (BAD_GENERATION,
                                                   CONTINUAL_FAULTS_ENV,
                                                   injector_from_env)

    # argument checks and the device first: no card, no load
    is_dir = os.path.isdir(args.data)
    if is_dir and args.refit_decay:
        raise SystemExit(
            "--refit-decay needs a resident npz corpus (refit rebinning "
            "touches every raw row at once); drop it or pass one npz")
    device = dt.resolve_device(args.device)
    model = dt.Booster.load_any(args.model)

    injector = injector_from_env(env_var=CONTINUAL_FAULTS_ENV)
    fault_fired = None
    scale = None
    if injector is not None:
        pt = injector.take("retrain", args.job_index)
        if pt is not None and pt.kind == BAD_GENERATION:
            # the poisoned pipeline: covariates scaled, so the
            # generation's fresh profile is built on rows live traffic
            # never resembles
            scale = np.float32(0.25)
            fault_fired = pt.kind

    if is_dir:
        # a directory of npz shards (each with X and y, bound in sorted
        # filename order) streamed through the model's frozen mapper into
        # an on-disk spill: corpora that never fit in memory as one npz
        from dryad_tpu_torch.data.streaming import dataset_from_chunks

        shards = sorted(
            os.path.join(args.data, f) for f in os.listdir(args.data)
            if f.endswith(".npz"))
        if not shards:
            raise SystemExit(f"--data {args.data!r} holds no .npz shards")
        ys = []
        for sh in shards:
            with np.load(sh) as z:
                if "X" not in z.files or "y" not in z.files:
                    raise SystemExit(f"shard {sh!r} must hold X and y")
                ys.append(np.asarray(z["y"]))
        y = np.concatenate(ys)

        def corpus_chunks():
            for sh in shards:
                with np.load(sh) as z:
                    Xc = np.asarray(z["X"], np.float32)
                yield Xc if scale is None else Xc * scale

        ds = dataset_from_chunks(
            corpus_chunks, y, int(y.shape[0]), model.mapper.num_features,
            mapper=model.mapper, spill=args.out + ".bins")
    else:
        z = np.load(args.data)
        if "X" not in z.files or "y" not in z.files:
            raise SystemExit(f"--data {args.data!r} must be an npz with X "
                             "and y")
        X = np.asarray(z["X"], np.float32)
        y = np.asarray(z["y"])
        if scale is not None:
            X = X * scale
        if args.refit_decay:
            # re-weight the old trees' leaves toward the fresh rows first,
            # then append: structure is kept, so the frozen bin space and
            # tree geometry still match for the warm start
            model = model.refit(X, y, decay_rate=args.refit_decay,
                                device=device)
        ds = dt.Dataset(X, y, mapper=model.mapper)
    p = model.params.replace(num_trees=args.trees)

    if args.supervise:
        from dryad_tpu_torch.resilience import RetryPolicy, supervise_train

        booster = supervise_train(
            p, ds, device=device, policy=RetryPolicy(),
            checkpoint_dir=args.checkpoint_dir or (args.out + ".ckpt"),
            journal=args.journal, init_model=model)
    else:
        booster = dt.train(p, ds, device=device, init_model=model)

    if getattr(ds, "is_streamed", False):
        # the spill is a training temporary, not part of the generation
        try:
            os.unlink(ds.path)
        except OSError:
            pass

    if args.text:
        booster.save_text(args.out)
    else:
        booster.save(args.out)
    print(json.dumps({
        "retrain": args.model, "out": args.out,
        "trees_before": model.num_iterations,
        "trees_after": booster.num_iterations,
        "job_index": args.job_index,
        "fault": fault_fired,
        "profile": getattr(booster, "profile", None) is not None,
    }))
    return 0


def cmd_fleet(args) -> int:
    """Replicated serving: N ``serve`` subprocesses under lifecycle
    supervision (crash and hang detection, budgeted respawn, journal)
    behind the health-routed router (``fleet/``).  Imports no torch."""
    from dryad_tpu_torch.fleet import (CapacityController, FleetSupervisor,
                                       make_fleet_router, serve_argv)
    from dryad_tpu_torch.fleet.router import main_loop
    from dryad_tpu_torch.obs.drift import parse_psi_budget
    from dryad_tpu_torch.obs.slo import parse_budgets
    from dryad_tpu_torch.resilience.policy import RetryPolicy

    # argument checks first: continual boosting needs the journal (the
    # scheduler tails drift_breach from it) and STABLE model names (drift
    # verdicts are keyed by registry alias, so a bare-path spec would
    # change label on the first push and orphan its probation window)
    continual_models = {}
    if args.continual_data:
        if not args.journal:
            raise SystemExit("--continual-data requires --journal (the "
                             "retrain scheduler tails drift_breach events "
                             "from the fleet journal)")
        for spec in args.model:
            name, _, path = spec.partition("=")
            if not path or "/" in name or "\\" in name:
                raise SystemExit(
                    f"--continual-data requires NAME=path model specs "
                    f"(got {spec!r}) — generation pushes keep the alias, "
                    "so the drift verdict survives the swap")
            continual_models[name] = path

    # the router's own span ring, for the merged /trace (replicas turn on
    # theirs in cmd_serve)
    if os.environ.get("DRYAD_TRACE", "1") != "0":
        from dryad_tpu_torch.obs.trace_export import enable_tracing

        enable_tracing()

    model_caps = {}
    for spec in args.model_cap or []:
        name, _, cap = spec.partition("=")
        if not name or not cap.isdigit():
            raise SystemExit(f"--model-cap wants NAME=N, got {spec!r}")
        model_caps[name] = int(cap)

    def make_argv(index: int, port_file: str) -> list:
        return serve_argv(args.model, port_file, device=args.device,
                          max_batch_rows=args.max_batch_rows,
                          max_wait_ms=args.max_wait_ms,
                          queue_size=args.queue_size, warmup=args.warmup,
                          drift_window=args.drift_window,
                          auth_token=args.auth_token)

    # elastic bounds: --replicas alone keeps a fixed pool (min == max ==
    # replicas); explicit bounds arm the capacity controller, and the
    # pool starts inside them
    min_replicas = (args.min_replicas if args.min_replicas is not None
                    else args.replicas)
    max_replicas = (args.max_replicas if args.max_replicas is not None
                    else args.replicas)
    if not 1 <= min_replicas <= max_replicas:
        raise SystemExit("need 1 <= --min-replicas <= --max-replicas")
    n_start = min(max(args.replicas, min_replicas), max_replicas)

    policy = (RetryPolicy() if args.retry_budget is None
              else RetryPolicy(retry_budget=args.retry_budget))
    supervisor = FleetSupervisor(
        make_argv, n_start, policy=policy, journal=args.journal,
        probe_interval_s=args.probe_interval,
        startup_timeout_s=args.startup_timeout)
    # a process manager must not die leaving its children running: the
    # default SIGTERM ends python without unwinding, so route it through
    # the KeyboardInterrupt path main_loop handles, and the finally below
    # terminates the pool
    import signal

    def _term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    # start() is INSIDE the try: each replica pays a torch import and the
    # card's set-up, so a TERM or Ctrl-C during start-up must still reach
    # supervisor.stop(), which terminates whatever was spawned
    scheduler = None
    controller = None
    try:
        supervisor.start()
        httpd = make_fleet_router(
            supervisor, args.host, args.port,
            max_inflight=args.max_inflight,
            bulk_max_inflight=args.bulk_max_inflight,
            model_caps=model_caps or None,
            request_timeout_s=args.request_timeout,
            min_healthy=args.min_healthy,
            auth_token=args.auth_token, verbose=not args.quiet,
            slo_budgets_ms=parse_budgets(args.slo_ms),
            slo_breach_after=args.slo_breach_after,
            drift_budget_psi=parse_psi_budget(args.drift_psi),
            drift_breach_after=args.drift_breach_after)
        host, port = httpd.server_address[:2]
        if max_replicas > min_replicas:
            controller = CapacityController(
                supervisor, httpd.state.capacity_signals,
                min_replicas=min_replicas, max_replicas=max_replicas,
                breach_after=args.scale_breach_after,
                cooldown_up_s=args.scale_cooldown,
                cooldown_down_s=2.0 * args.scale_cooldown).start()
            httpd.state.autoscale = controller
        if not args.quiet:
            urls = {s.name: s.state()["url"] for s in supervisor.slots}
            elastic = (f", elastic {min_replicas}..{max_replicas}"
                       if controller is not None else "")
            print(f"dryad fleet on http://{host}:{port}  "
                  f"({n_start} replicas{elastic}: {urls}; POST /predict, "
                  "POST /models/push, GET /metrics aggregates the pool)")
        if continual_models:
            from dryad_tpu_torch.continual import (JournalTailer,
                                                   ProbationPublisher,
                                                   RetrainScheduler,
                                                   make_http_verdicts,
                                                   make_subprocess_launcher,
                                                   make_supervisor_push)

            out_dir = args.continual_out or os.path.join(
                os.path.dirname(os.path.abspath(args.journal)), "continual")
            launch = make_subprocess_launcher(
                args.continual_data, out_dir,
                trees=args.retrain_trees, device=args.retrain_device,
                timeout_s=args.retrain_timeout,
                refit_decay=args.retrain_refit_decay,
                supervise=args.retrain_supervise)
            publisher = ProbationPublisher(
                make_supervisor_push(supervisor, auth_token=args.auth_token),
                make_http_verdicts(host, port, auth_token=args.auth_token),
                journal=supervisor.journal,
                probation_polls=args.probation_polls,
                poll_interval_s=args.probation_interval)
            scheduler = RetrainScheduler(
                continual_models, launch,
                journal=supervisor.journal, publisher=publisher,
                policy=policy, cooldown_s=args.retrain_cooldown,
                max_concurrent=args.retrain_max_concurrent,
                source=JournalTailer(args.journal)).start()
            if not args.quiet:
                print(f"continual boosting armed: {sorted(continual_models)} "
                      f"-> {out_dir} (drift_breach triggers a warm-start "
                      "retrain; probationed rolling publish + rollback)")
        main_loop(httpd, quiet=args.quiet)
    finally:
        if scheduler is not None:
            scheduler.stop(timeout_s=5.0)
        if controller is not None:
            # signal first with a short join: an in-flight scale-up
            # unblocks when supervisor.stop() below reaps its child
            controller.stop(timeout_s=2.0)
        supervisor.stop()
        if controller is not None:
            controller.stop(timeout_s=5.0)
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

    rt = sub.add_parser("retrain",
                        help="continual-boosting retrain worker: warm-start "
                             "append on fresh rows (the scheduler's "
                             "subprocess; dryad_tpu_torch/continual)")
    rt.add_argument("--model", required=True,
                    help="served artifact to warm-start from (npz or text "
                         "model)")
    rt.add_argument("--data", required=True,
                    help="fresh rows: an .npz with X and y, or a DIRECTORY "
                         "of .npz shards streamed out-of-core (both binned "
                         "through the model's frozen mapper)")
    rt.add_argument("--out", required=True,
                    help="new-generation artifact path")
    rt.add_argument("--trees", type=int, default=20,
                    help="NEW trees to append (0 = a no-op generation, "
                         "predict-identical to --model)")
    rt.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the append trains (no card and no "
                         "--device cpu: it raises)")
    rt.add_argument("--refit-decay", type=float, default=0.0,
                    help="re-weight the old trees' leaves toward the fresh "
                         "rows first (Booster.refit decay_rate; 0 skips)")
    rt.add_argument("--supervise", action="store_true",
                    help="run the append under resilience.supervise_train "
                         "(fault classes degrade and resume bitwise)")
    rt.add_argument("--checkpoint-dir",
                    help="supervised-run checkpoint dir (default: "
                         "<out>.ckpt)")
    rt.add_argument("--journal",
                    help="supervised-run journal JSONL (with --supervise)")
    rt.add_argument("--job-index", type=int, default=0,
                    help="global retrain-job index: the "
                         "DRYAD_CONTINUAL_FAULTS iteration the injector "
                         "matches against")
    rt.add_argument("--text", action="store_true",
                    help="save the generation in the text format")
    rt.set_defaults(fn=cmd_retrain)

    fl = sub.add_parser("fleet",
                        help="replicated serving: supervised replica pool "
                             "behind a health-routed router "
                             "(dryad_tpu_torch/fleet)")
    fl.add_argument("--model", required=True, action="append",
                    help="model path or NAME=path alias; repeat to co-serve "
                         "(every replica loads the same set)")
    fl.add_argument("--replicas", type=int, default=2,
                    help="serve subprocesses in the pool (with elastic "
                         "bounds unset this is also min == max: a fixed "
                         "pool)")
    fl.add_argument("--min-replicas", type=int, default=None,
                    help="elastic floor: the capacity loop never drains "
                         "below this many slots (default --replicas)")
    fl.add_argument("--max-replicas", type=int, default=None,
                    help="elastic ceiling: the capacity loop never grows "
                         "past this many slots (default --replicas; max > "
                         "min arms the controller)")
    fl.add_argument("--scale-cooldown", type=float, default=60.0,
                    help="seconds after a scale-up before the next one "
                         "(scale-downs wait 2x this): one breach burst "
                         "buys one replica, not a ramp to the maximum")
    fl.add_argument("--scale-breach-after", type=int, default=2,
                    help="consecutive pressure polls (sustained SLO "
                         "breach or admission saturation) before a "
                         "scale-up is admitted")
    fl.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the replicas' device (serve --device); several "
                         "replicas share one card")
    fl.add_argument("--host", default="127.0.0.1")
    fl.add_argument("--port", type=int, default=8000,
                    help="router port (also serves the aggregated /metrics "
                         "and fleet /healthz; replicas bind free ports)")
    fl.add_argument("--max-batch-rows", type=int, default=4096)
    fl.add_argument("--max-wait-ms", type=float, default=2.0)
    fl.add_argument("--queue-size", type=int, default=256)
    fl.add_argument("--warmup", action="store_true",
                    help="each replica captures its buckets and arms the "
                         "recompile tripwire at startup")
    fl.add_argument("--max-inflight", type=int, default=64,
                    help="fleet admission cap: beyond this every request "
                         "sheds (503)")
    fl.add_argument("--bulk-max-inflight", type=int, default=None,
                    help="bulk requests shed beyond this in-flight count "
                         "(default max-inflight/2): interactive survives "
                         "overload first")
    fl.add_argument("--model-cap", action="append", default=None,
                    help="NAME=N per-model in-flight admission cap; "
                         "repeatable")
    fl.add_argument("--request-timeout", type=float, default=30.0,
                    help="per-forward timeout; one retry on a different "
                         "healthy replica")
    fl.add_argument("--min-healthy", type=int, default=1,
                    help="fleet /healthz answers 503 below this many "
                         "routable replicas")
    fl.add_argument("--probe-interval", type=float, default=0.25,
                    help="supervisor health-probe cadence (seconds)")
    fl.add_argument("--slo-ms", default="",
                    help="per-priority p99 budgets as "
                         "'interactive=250,bulk=2000' (ms; the defaults): "
                         "a SUSTAINED breach degrades the router /healthz; "
                         "'off' disables SLO health-gating")
    fl.add_argument("--slo-breach-after", type=int, default=3,
                    help="consecutive over-budget /healthz evaluations "
                         "before the SLO degrades the router")
    fl.add_argument("--drift-psi", default="",
                    help="PSI budget for the model-drift layer (default "
                         "0.2, the 'significant shift' rule; replicas' "
                         "window counts merge exactly, GET /drift "
                         "reports verdicts, a sustained breach journals "
                         "drift_breach and warns in /healthz payloads: "
                         "warn-only; 'off' disables drift reporting)")
    fl.add_argument("--drift-breach-after", type=int, default=2,
                    help="consecutive over-budget drift windows before "
                         "the breach is sustained (journal + warning)")
    fl.add_argument("--drift-window", type=int, default=8192,
                    help="per-replica drift monitor window in rows "
                         "(serve --drift-window; 0 turns the replicas' "
                         "monitors off)")
    fl.add_argument("--startup-timeout", type=float, default=120.0,
                    help="per-replica readiness deadline (a replica pays "
                         "its torch import, the model load and captures "
                         "here)")
    fl.add_argument("--retry-budget", type=int, default=None,
                    help="per-replica respawns before the slot fails "
                         "closed (resilience.RetryPolicy)")
    fl.add_argument("--journal",
                    help="fleet journal JSONL path (spawn, crash, respawn "
                         "and swap decisions, append-only)")
    fl.add_argument("--auth-token",
                    default=os.environ.get("DRYAD_AUTH_TOKEN"),
                    help="bearer token for router AND replicas "
                         "(/healthz stays open)")
    fl.add_argument("--continual-data", default=None,
                    help="arm continual boosting: fresh rows each drift-"
                         "triggered retrain appends on (an .npz with X/y "
                         "or a directory of .npz shards, streamed out-of-"
                         "core by the retrain worker); requires --journal "
                         "and NAME=path model specs "
                         "(dryad_tpu_torch/continual)")
    fl.add_argument("--continual-out", default=None,
                    help="generation artifact dir (default: "
                         "<journal dir>/continual)")
    fl.add_argument("--retrain-trees", type=int, default=20,
                    help="NEW trees each generation appends")
    fl.add_argument("--retrain-device", default="cuda",
                    choices=["cuda", "cpu"],
                    help="the retrain worker's device (retrain --device); "
                         "cpu keeps retrains off the card the replicas "
                         "serve from")
    fl.add_argument("--retrain-cooldown", type=float, default=300.0,
                    help="per-model seconds between finished retrains: "
                         "the breach debounce")
    fl.add_argument("--retrain-max-concurrent", type=int, default=1,
                    help="fleet-wide in-flight retrain budget")
    fl.add_argument("--retrain-timeout", type=float, default=1800.0,
                    help="retrain subprocess wall deadline (a wedged "
                         "worker is killed, never waited on)")
    fl.add_argument("--retrain-refit-decay", type=float, default=0.0,
                    help="Booster.refit re-weighting before each append "
                         "(0 skips)")
    fl.add_argument("--retrain-supervise", action="store_true",
                    help="run each retrain under "
                         "resilience.supervise_train")
    fl.add_argument("--probation-polls", type=int, default=5,
                    help="drift-verdict polls a pushed generation must "
                         "survive before promotion")
    fl.add_argument("--probation-interval", type=float, default=2.0,
                    help="seconds between probation polls (each poll is a "
                         "fresh replica scrape + gate evaluation)")
    fl.add_argument("--quiet", action="store_true")
    fl.set_defaults(fn=cmd_fleet)

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
