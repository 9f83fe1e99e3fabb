"""Command line of the port: ``python -m dryad_tpu_torch serve``.

    python -m dryad_tpu_torch serve --model m.dryad --warmup
    python -m dryad_tpu_torch serve --model m.dryad --device cpu \\
        --request rows.npy --out preds.npy

``serve`` loads one or more model files (npz or text, written by either
package; ``NAME=path`` registers a routing alias, the last model is
active) and answers HTTP requests (``serve/http.py``) on the card, or on
the CPU with ``--device cpu``; with no card and no ``--device cpu`` it
raises.  ``--request`` runs one matrix through the whole serving stack,
writes the predictions to ``--out`` and exits.  The counterpart of the
reference's ``serve`` command (``dryad_tpu/__main__.py``), without its
drift flags; its other commands are not ported.  ``--sharded auto|on|off``
splits big buckets over every visible card (``serve/server.py``).
"""

from __future__ import annotations

import argparse
import json
import os

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


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m dryad_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
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
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
