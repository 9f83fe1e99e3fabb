"""The bearer check the HTTP front end applies to every endpoint but
``/healthz`` (the counterpart of ``dryad_tpu/obs/exporter.py``'s shared
check; its standalone metrics exporter is not ported)."""

from __future__ import annotations

import hmac
from http.server import BaseHTTPRequestHandler
from typing import Optional


def authorized(handler: BaseHTTPRequestHandler,
               token: Optional[str]) -> bool:
    """True when no token is set or the request carries ``Authorization:
    Bearer <token>`` (constant-time compare).  The caller exempts
    ``/healthz`` before calling this."""
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
