"""The telemetry registry over stdlib HTTP, and the bearer check the
serving front end shares.

    GET /metrics   Prometheus text exposition (``registry.exposition()``)
    GET /stats     JSON: uptime, the span summary, counters, gauges and
                   histograms, with any ``extra_stats`` providers merged
    GET /trace     Chrome trace_event JSON of the span ring
                   (``obs/trace_export.py``; no events until
                   ``enable_tracing()``, which ``train --trace-out`` calls)
    GET /healthz   200 {"ok": true} while the health state is clean, 503
                   {"ok": false, "degraded": [...]} while a subsystem
                   holds a degradation (``obs/health.py``); always exempt
                   from auth

With ``auth_token`` set every endpoint but ``/healthz`` requires
``Authorization: Bearer <token>`` and answers 401 otherwise.  ``python -m
dryad_tpu_torch train --metrics-port N`` mounts it beside a training run.
The exporter only reads the registry; it touches no device and imports
no torch.

The counterpart of ``dryad_tpu/obs/exporter.py``.
"""

from __future__ import annotations

import hmac
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence

from dryad_tpu_torch.obs import spans
from dryad_tpu_torch.obs.health import healthz_payload
from dryad_tpu_torch.obs.registry import Registry, default_registry


def authorized(handler: BaseHTTPRequestHandler,
               token: Optional[str]) -> bool:
    """True when no token is set or the request carries ``Authorization:
    Bearer <token>`` (constant-time compare).  The caller exempts
    ``/healthz`` before calling this (``serve/http.py`` shares it)."""
    if not token:
        return True
    header = handler.headers.get("Authorization", "")
    return hmac.compare_digest(header.encode(), f"Bearer {token}".encode())


def send_unauthorized(handler: BaseHTTPRequestHandler) -> None:
    """The 401 answer, with the ``WWW-Authenticate`` header RFC 7235
    requires."""
    body = b'{"error": "unauthorized"}'
    handler.send_response(401)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("WWW-Authenticate", "Bearer")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


class _Handler(BaseHTTPRequestHandler):
    # the exporter rides on the server object (see MetricsExporter)

    def log_message(self, fmt, *args):  # quiet: a scrape target
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — stdlib handler API
        if self.path == "/healthz":
            code, body = healthz_payload()
            self._send(code, json.dumps(body).encode(), "application/json")
            return
        if not authorized(self, self.server.auth_token):
            send_unauthorized(self)
            return
        reg: Registry = self.server.obs_registry
        if self.path == "/metrics":
            self._send(200, reg.exposition().encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif self.path == "/trace":
            from dryad_tpu_torch.obs import trace_export

            buf = trace_export.default_trace()
            body = trace_export.dumps_trace(
                span_events=buf.events() if buf is not None else ())
            self._send(200, body.encode(), "application/json")
        elif self.path == "/stats":
            self._send(200, json.dumps(stats_payload(
                reg, self.server.started_at,
                self.server.extra_stats)).encode(), "application/json")
        else:
            self._send(404, b'{"error": "unknown path"}', "application/json")


def stats_payload(registry: Registry, started_at: float,
                  extra_stats: Sequence[Callable[[], dict]] = ()) -> dict:
    """The /stats JSON body: registry snapshot + span summary + uptime,
    with any extra provider dicts merged in under their returned keys."""
    payload = {"uptime_s": round(time.monotonic() - started_at, 3),
               "spans": spans.snapshot(registry)}
    payload.update(registry.snapshot())
    for provider in extra_stats or ():
        try:
            payload.update(provider())
        except Exception as e:  # noqa: BLE001 — a failing provider
            # must not take /stats down
            payload.setdefault("stats_errors", []).append(repr(e))
    return payload


class MetricsExporter:
    """The exporter on a thread of its own; ``port=0`` picks a free port
    (``.port`` after ``start()``)."""

    def __init__(self, registry: Optional[Registry] = None,
                 host: str = "127.0.0.1", port: int = 0, *,
                 auth_token: Optional[str] = None,
                 extra_stats: Sequence[Callable[[], dict]] = ()):
        self.registry = registry if registry is not None else default_registry()
        self._host, self._port = host, int(port)
        self._auth_token = auth_token
        self._extra_stats = tuple(extra_stats or ())
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def host(self) -> str:
        return self._httpd.server_address[0] if self._httpd else self._host

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "MetricsExporter":
        if self._httpd is not None:
            return self
        httpd = ThreadingHTTPServer((self._host, self._port), _Handler)
        httpd.daemon_threads = True
        httpd.obs_registry = self.registry
        httpd.auth_token = self._auth_token
        httpd.extra_stats = self._extra_stats
        httpd.started_at = time.monotonic()
        self._httpd = httpd
        self._thread = threading.Thread(target=httpd.serve_forever,
                                        daemon=True, name="dryad-obs-exporter")
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

    def __enter__(self) -> "MetricsExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def start_exporter(registry: Optional[Registry] = None,
                   host: str = "127.0.0.1", port: int = 0, *,
                   auth_token: Optional[str] = None,
                   extra_stats: Sequence[Callable[[], dict]] = ()
                   ) -> MetricsExporter:
    """Construct and start (``train --metrics-port``)."""
    return MetricsExporter(registry, host, port, auth_token=auth_token,
                           extra_stats=extra_stats).start()
