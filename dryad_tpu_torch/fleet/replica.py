"""One serve replica as a supervised subprocess.

``ReplicaProcess`` owns exactly the mechanics a fleet supervisor needs:
spawn the process, discover where it bound (the serve CLI's
``--port-file`` handshake: replicas bind port 0, so the OS picks a free
port and the replica writes ``host port`` once it is LISTENING, which
makes readiness detection race-free), probe its ``/healthz``, send it
HTTP requests, and kill it.  Everything is stdlib (``subprocess`` and
``http.client``): the fleet package imports no torch, like
``dryad_tpu_torch/obs``; the replicas own the card, the supervisor only
owns processes.

The command line is caller-supplied (``make_argv(port_file) -> argv``):
production spawns ``python -m dryad_tpu_torch serve ...`` (``serve_argv``
below), tests spawn a protocol stub that speaks the same endpoints
without paying the torch import.  Fault drills ride the environment
(``resilience.faults.REPLICA_FAULTS_ENV``), so the SAME spawn path runs
clean replicas and drilled ones.
"""

from __future__ import annotations

import http.client
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence


class ReplicaStartupError(RuntimeError):
    """The replica never became ready (exited early, or the port-file /
    health handshake timed out).  ``exit_code`` is the process's exit
    status when it died, None when it was still running (hung startup)."""

    def __init__(self, message: str, exit_code: Optional[int] = None):
        super().__init__(message)
        self.exit_code = exit_code


def serve_argv(model_specs: Sequence[str], port_file: str, *,
               device: str = "cuda", host: str = "127.0.0.1",
               max_batch_rows: Optional[int] = None,
               max_wait_ms: Optional[float] = None,
               queue_size: Optional[int] = None,
               warmup: bool = False,
               drift_window: Optional[int] = None,
               auth_token: Optional[str] = None,
               python: Optional[str] = None) -> list[str]:
    """The production replica command: ``python -m dryad_tpu_torch
    serve`` on port 0 with the port-file handshake, on ``device``
    (``cuda``, the default, or ``cpu``).  ``model_specs`` are the serve
    CLI's ``--model`` values (paths or ``NAME=path`` aliases)."""
    argv = [python or sys.executable, "-m", "dryad_tpu_torch", "serve",
            "--host", host, "--port", "0", "--port-file", port_file,
            "--device", device, "--quiet"]
    for spec in model_specs:
        argv += ["--model", spec]
    if max_batch_rows is not None:
        argv += ["--max-batch-rows", str(int(max_batch_rows))]
    if max_wait_ms is not None:
        argv += ["--max-wait-ms", str(float(max_wait_ms))]
    if queue_size is not None:
        argv += ["--queue-size", str(int(queue_size))]
    if warmup:
        argv += ["--warmup"]
    if drift_window is not None:
        argv += ["--drift-window", str(int(drift_window))]
    if auth_token:
        argv += ["--auth-token", auth_token]
    return argv


class ReplicaProcess:
    """Spawn + address + probe one replica subprocess."""

    def __init__(self, make_argv, *, name: str = "r0",
                 env: Optional[dict] = None,
                 startup_timeout_s: float = 60.0,
                 log_dir: Optional[str] = None):
        self.make_argv = make_argv
        self.name = name
        self.env = dict(env) if env is not None else None
        self.startup_timeout_s = float(startup_timeout_s)
        self._log_dir = log_dir
        self.proc: Optional[subprocess.Popen] = None
        self.host: Optional[str] = None
        self.port: Optional[int] = None
        self.log_path: Optional[str] = None
        self._port_file: Optional[str] = None

    # ---- lifecycle ---------------------------------------------------------
    def start(self) -> "ReplicaProcess":
        """Spawn and wait until the replica is LISTENING and /healthz
        answers 200; raises ReplicaStartupError otherwise.  Idempotence is
        the caller's job — a live replica must be stopped first."""
        if self.proc is not None and self.proc.poll() is None:
            raise RuntimeError(f"replica {self.name} is already running")
        fd, self._port_file = tempfile.mkstemp(prefix=f"dryad-{self.name}-",
                                               suffix=".port")
        os.close(fd)
        os.unlink(self._port_file)          # the replica creates it when ready
        argv = self.make_argv(self._port_file)
        log_dir = self._log_dir or tempfile.gettempdir()
        self.log_path = os.path.join(log_dir, f"dryad-replica-{self.name}.log")
        log = open(self.log_path, "ab")
        try:
            env = dict(os.environ, **self.env) if self.env else None
            self.proc = subprocess.Popen(argv, stdout=log, stderr=log, env=env)
        finally:
            log.close()                      # the child holds its own handle
        self._await_ready()
        return self

    def _await_ready(self) -> None:
        deadline = time.monotonic() + self.startup_timeout_s
        while time.monotonic() < deadline:
            code = self.proc.poll()
            if code is not None:
                raise ReplicaStartupError(
                    f"replica {self.name} exited with code {code} before "
                    f"becoming ready (log: {self.log_path})", exit_code=code)
            if self.host is None and os.path.exists(self._port_file):
                try:
                    with open(self._port_file) as f:
                        host, port = f.read().split()
                    self.host, self.port = host, int(port)
                except (ValueError, OSError):
                    pass                     # partially written; retry
            if self.host is not None:
                status, _ = self.health(timeout_s=1.0)
                if status == 200:
                    return
            time.sleep(0.02)
        code = self.proc.poll()
        raise ReplicaStartupError(
            f"replica {self.name} not ready after {self.startup_timeout_s}s "
            f"(log: {self.log_path})", exit_code=code)

    def poll(self) -> Optional[int]:
        """The process exit code, or None while it runs."""
        return self.proc.poll() if self.proc is not None else None

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self, grace_s: float = 3.0) -> Optional[int]:
        """Terminate (then kill) the process; returns the exit code."""
        if self.proc is None:
            return None
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        if self._port_file and os.path.exists(self._port_file):
            try:
                os.unlink(self._port_file)
            except OSError:
                pass
        return self.proc.poll()

    # ---- wire --------------------------------------------------------------
    def request(self, method: str, path: str, body: Optional[bytes] = None,
                headers: Optional[dict] = None,
                timeout_s: float = 10.0) -> tuple[int, bytes]:
        """One HTTP round trip to the replica; raises OSError-family on
        connection failure (the caller classifies)."""
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout_s)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def clock_offset(self, timeout_s: float = 2.0) -> Optional[float]:
        """The replica's perf_counter→wall-clock offset via the
        auth-exempt ``GET /clock`` handshake: ``remote_perf + offset ≈
        wall``, with the local round trip's midpoint standing in for the
        instant the replica sampled its clocks (halves the RTT error).
        None when the replica does not speak /clock (e.g. a protocol
        stub) — the trace assembly then falls back to the replica's
        self-reported offset or renders unaligned."""
        t_a = time.time()
        try:
            status, body = self.request("GET", "/clock", timeout_s=timeout_s)
        except OSError:
            return None
        t_b = time.time()
        if status != 200:
            return None
        try:
            perf = float(json.loads(body)["perf_s"])
        except (ValueError, KeyError, TypeError):
            return None
        return (t_a + t_b) / 2.0 - perf

    def health(self, timeout_s: float = 2.0) -> tuple[Optional[int], float]:
        """(/healthz status or None on connect/timeout failure, latency)."""
        t0 = time.monotonic()
        try:
            status, _ = self.request("GET", "/healthz", timeout_s=timeout_s)
        except OSError:
            return None, time.monotonic() - t0
        return status, time.monotonic() - t0

    def load_model(self, path: str, *, name: Optional[str] = None,
                   activate: bool = True, auth_token: Optional[str] = None,
                   timeout_s: float = 120.0) -> int:
        """POST /models/load on the replica; returns the new version.
        The generous default timeout covers the capture of the new
        version's buckets on a card replica."""
        body = {"path": path, "activate": bool(activate)}
        if name is not None:
            body["name"] = name
        headers = {"Content-Type": "application/json"}
        if auth_token:
            headers["Authorization"] = f"Bearer {auth_token}"
        status, payload = self.request("POST", "/models/load",
                                       json.dumps(body).encode(),
                                       headers, timeout_s=timeout_s)
        if status != 200:
            raise RuntimeError(
                f"replica {self.name} /models/load -> {status}: "
                f"{payload[:300]!r}")
        return int(json.loads(payload)["version"])
