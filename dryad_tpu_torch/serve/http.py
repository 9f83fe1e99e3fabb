"""Stdlib HTTP front end for PredictServer (no extra dependencies).

Endpoints (JSON in and out):

    POST /predict   {"rows": [[...], ...], "raw": false, "version": null,
                     "model": null, "binned": false, "timeout": null}
                    -> {"predictions": [...], "version": v}
    GET  /stats     -> PredictServer.stats()
    GET  /models    -> {"active": v, "versions": [...], "aliases": {...}}
    POST /models/load      {"path": "...", "activate": true,
                            "name": null} -> {"version": v}
    POST /models/activate  {"version": v} -> {"version": v}
    POST /models/rollback  -> {"version": v}
    GET  /metrics   -> Prometheus text exposition of the telemetry
                       registry
    GET  /obs       -> the registry's snapshot() JSON, with a "drift"
                       block of raw window counts per profiled model
    GET  /trace     -> Chrome trace_event JSON of the span ring
                       (``obs/trace_export.py``; needs enable_tracing())
    GET  /trace/events -> the ring's raw events, its drop count and a
                       clock sample
    GET  /clock     -> {"perf_s", "wall_s"} (auth-exempt)
    GET  /healthz   -> 200 {"ok": true} | 503 {"ok": false, "degraded":
                       [...]} (always auth-exempt)

``X-Dryad-Trace`` on /predict is passed through with the request (a
16-hex id is minted when it is absent and tracing is on) and echoed on
the response; the request's stage spans land in the span ring under it.
``X-Dryad-Priority`` (``interactive`` or ``bulk``) labels the
per-(priority, stage) latency histograms.

Routing: ``version`` pins a registry version, ``model`` routes by name;
the default is the active version.

Bearer auth (``auth_token=``, ``--auth-token`` or ``DRYAD_AUTH_TOKEN``):
when set, every endpoint but ``/healthz`` and ``/clock`` requires
``Authorization: Bearer <token>`` and answers 401 otherwise.

Structured request logging (``log_requests=True``, ``--log-requests``)
writes one JSON line per request to ``log_stream``: method, path, status,
the resolved model version, rows and wall latency.

Requests ride the same micro-batcher as in-process callers
(``ThreadingHTTPServer`` gives a thread per connection, so concurrent
POSTs coalesce), and numbers cross as JSON: Python floats widen fp32
exactly, so a float32 reader gets the served bits back.

The counterpart of ``dryad_tpu/serve/http.py``.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from dryad_tpu_torch.obs import trace_export
from dryad_tpu_torch.obs.exporter import authorized, send_unauthorized
from dryad_tpu_torch.obs.health import healthz_payload
from dryad_tpu_torch.obs.registry import default_registry
from dryad_tpu_torch.resilience.faults import InjectedReject
from dryad_tpu_torch.serve.batcher import ServeOverloaded, ServeTimeout

TRACE_HEADER = "X-Dryad-Trace"
PRIORITY_HEADER = "X-Dryad-Priority"


class _Handler(BaseHTTPRequestHandler):
    # the PredictServer rides on the HTTP server object (make_http_server)

    def _fire_fault(self, site: str) -> None:
        """Call the fault hook (``resilience.faults``) with this site's
        count; it may raise ``InjectedReject`` (answered 503)."""
        hook = self.server.fault_hook
        if hook is None:
            return
        with self.server.fault_lock:
            n = self.server.fault_counts.get(site, 0) + 1
            self.server.fault_counts[site] = n
        hook(site, n)

    def _send(self, code: int, payload: dict,
              extra_headers: Optional[dict] = None) -> None:
        self._send_raw(code, json.dumps(payload).encode(),
                       "application/json", extra_headers)

    def _send_raw(self, code: int, body: bytes, ctype: str,
                  extra_headers: Optional[dict] = None) -> None:
        # logged before the status line goes out: a client reading an error
        # status returns on the headers alone, so its next request could
        # otherwise be logged ahead of this one
        self._log_request(code)
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _authorized(self) -> bool:
        if authorized(self, self.server.auth_token):
            return True
        self._log_request(401)
        send_unauthorized(self)
        return False

    def _log_request(self, status: int) -> None:
        """One structured JSON line per completed request (flag-gated)."""
        if not self.server.log_requests:
            return
        line = json.dumps({
            "ts": time.time(),
            "method": self.command,
            "path": self.path,
            "status": int(status),
            "version": getattr(self, "_req_version", None),
            "rows": getattr(self, "_req_rows", None),
            "latency_ms": round(
                (time.perf_counter() - getattr(self, "_req_t0",
                                               time.perf_counter())) * 1e3, 3),
        })
        with self.server.log_lock:
            self.server.log_stream.write(line + "\n")
            self.server.log_stream.flush()

    def _read_json(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if length == 0:
            return {}
        return json.loads(self.rfile.read(length).decode())

    def log_message(self, fmt, *args):  # quiet by default
        if self.server.verbose:
            super().log_message(fmt, *args)

    def do_GET(self):  # noqa: N802 — stdlib handler API
        self._req_t0 = time.perf_counter()
        if self.path == "/healthz":
            try:
                self._fire_fault("health")
            except InjectedReject as e:
                self._send(503, {"ok": False, "degraded": ["injected"],
                                 "error": str(e)})
                return
            code, body = healthz_payload()
            self._send(code, body)
            return
        if self.path == "/clock":
            self._send(200, {"perf_s": time.perf_counter(),
                             "wall_s": time.time()})
            return
        if not self._authorized():
            return
        server = self.server.predict_server
        if self.path == "/stats":
            self._send(200, server.stats())
        elif self.path == "/metrics":
            self._send_raw(200, self.server.obs_registry.exposition().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
        elif self.path == "/obs":
            doc = self.server.obs_registry.snapshot()
            drift = server.drift_state()
            if drift:
                doc["drift"] = drift
            self._send(200, doc)
        elif self.path == "/trace":
            buf = trace_export.active_trace()
            self._send_raw(200, trace_export.dumps_trace(
                buf.events() if buf is not None else ()).encode(),
                "application/json")
        elif self.path == "/trace/events":
            buf = trace_export.active_trace()
            events, dropped = buf.export() if buf is not None else ([], 0)
            self._send(200, {"events": [list(e) for e in events],
                             "dropped": dropped,
                             "clock": {"perf_s": time.perf_counter(),
                                       "wall_s": time.time()}})
        elif self.path == "/models":
            self._send(200, {"active": server.registry.active_version,
                             "versions": server.registry.versions(),
                             "aliases": server.registry.aliases()})
        else:
            self._send(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802 — stdlib handler API
        self._req_t0 = time.perf_counter()
        if not self._authorized():
            return
        server = self.server.predict_server
        try:
            body = self._read_json()
            if self.path == "/models/load":
                version = server.load_model(
                    body["path"], activate=bool(body.get("activate", True)),
                    name=body.get("name"))
                self._req_version = version
                self._send(200, {"version": version})
                return
            if self.path == "/models/activate":
                version = int(body["version"])
                server.activate(version)
                self._req_version = version
                self._send(200, {"version": version})
                return
            if self.path == "/models/rollback":
                version = server.rollback()
                self._req_version = version
                self._send(200, {"version": version})
                return
            if self.path != "/predict":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            self._fire_fault("request")
            trace = self.headers.get(TRACE_HEADER)
            priority = (self.headers.get(PRIORITY_HEADER)
                        or "interactive").lower()
            if priority not in ("interactive", "bulk"):
                priority = "interactive"
            if trace is None and trace_export.tracing_active(
                    self.server.obs_registry):
                # minted only while tracing is on: nothing is allocated
                # on the untraced path
                trace = uuid.uuid4().hex[:16]
            # resolve the entry first: binned rows arrive in the model's
            # bin dtype, and the answer names the version that served
            entry = server.registry.get(body.get("version"),
                                        name=body.get("model"))
            self._req_version = entry.version
            binned = bool(body.get("binned", False))
            rows = np.asarray(body["rows"],
                              entry.booster.mapper.bin_dtype if binned
                              else np.float32)
            self._req_rows = int(rows.shape[0]) if rows.ndim > 1 else 1
            preds = server.predict(
                rows, version=entry.version,
                raw_score=bool(body.get("raw", False)), binned=binned,
                timeout=body.get("timeout"), trace=trace, priority=priority)
            self._send(200, {"predictions": np.asarray(preds).tolist(),
                             "version": entry.version},
                       extra_headers=({TRACE_HEADER: trace}
                                      if trace else None))
        except (InjectedReject, ServeOverloaded) as e:
            self._send(503, {"error": str(e)})
        except ServeTimeout as e:
            self._send(504, {"error": str(e)})
        except (KeyError, LookupError, ValueError) as e:
            self._send(400, {"error": repr(e)})
        except Exception as e:  # noqa: BLE001 — answer, keep serving
            self._send(500, {"error": repr(e)})


def make_http_server(predict_server, host: str = "127.0.0.1",
                     port: int = 8000, *, verbose: bool = False,
                     log_requests: bool = False,
                     log_stream=None, auth_token=None,
                     obs_registry=None, fault_hook=None) -> ThreadingHTTPServer:
    """Bind (port 0 picks a free one: ``httpd.server_address``); the
    caller runs ``serve_forever()`` and ``shutdown()``.  ``auth_token``
    turns on bearer auth; ``obs_registry`` backs ``/metrics`` and ``/obs``
    (default: the process registry serving records into); ``fault_hook``
    is the drill hook of ``resilience.faults``."""
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.predict_server = predict_server
    httpd.verbose = verbose
    httpd.log_requests = log_requests
    httpd.log_stream = log_stream if log_stream is not None else sys.stderr
    httpd.log_lock = threading.Lock()
    httpd.auth_token = auth_token
    httpd.fault_hook = fault_hook
    httpd.fault_lock = threading.Lock()
    httpd.fault_counts = {}
    httpd.obs_registry = (obs_registry if obs_registry is not None
                          else default_registry())
    predict_server.start()
    return httpd
