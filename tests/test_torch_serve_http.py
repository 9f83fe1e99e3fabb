"""The port's HTTP front end (``dryad_tpu_torch.serve.http``) and its
``serve`` command, on the CPU, all on 127.0.0.1 port 0.

* A round trip: ``/predict`` bitwise the direct predict (JSON floats widen
  fp32 exactly), binned rows, the trace header echoed, ``/stats``,
  ``/obs``, ``/clock``, 400 and 404.
* Bearer auth on ``/metrics``, ``/stats`` and ``/predict``; ``/healthz``
  stays open.
* ``/healthz`` turns 503 after an unexpected compile past
  ``warmup_complete()`` and 200 again after a re-warm.
* Structured request logging; the fault hook's 503.
* ``python -m dryad_tpu_torch serve --request ... --out ... --device
  cpu`` as a subprocess equals the direct predict; without ``--device
  cpu`` and with no card it fails.
* ``GET /models`` and ``POST /models/load|activate|rollback`` answer as
  the reference's server does, and the served answers after each are the
  direct predicts; ``/trace/events`` and ``/trace`` hold the request's
  spans under its trace id (minted when absent while tracing is on);
  ``/obs`` carries the drift block of a profiled model.
"""

import io
import json
import os
import pathlib
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import dryad_tpu
from dryad_tpu.datasets import higgs_like

import dryad_tpu_torch as dt
from dryad_tpu_torch.resilience.faults import InjectedReject
from dryad_tpu_torch.serve import PredictServer
from dryad_tpu_torch.serve.http import TRACE_HEADER, make_http_server
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(reference model file, raw rows, the port's booster of it)."""
    X, y = higgs_like(600, seed=7)
    jb = dryad_tpu.train(dict(objective="binary", num_trees=8, num_leaves=7,
                              max_bins=32),
                         dryad_tpu.Dataset(X, y, max_bins=32), backend="cpu")
    path = str(tmp_path_factory.mktemp("m") / "m.dryad")
    jb.save(path)
    return path, X, dt.Booster.load(path)


class _Http:
    """A served PredictServer on a free port, shut down on exit."""

    def __init__(self, server, **kw):
        self.server = server
        self.httpd = make_http_server(server, port=0, **kw)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.server.stop()
        self.thread.join(10)
        assert not self.thread.is_alive()

    def get(self, path, token=None):
        headers = {"Authorization": f"Bearer {token}"} if token else {}
        return urllib.request.urlopen(
            urllib.request.Request(self.base + path, headers=headers),
            timeout=10)

    def post(self, path, body, headers=None):
        req = urllib.request.Request(
            self.base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json", **(headers or {})})
        return urllib.request.urlopen(req, timeout=10)


def _server(model, **kw):
    path = model[0]
    server = PredictServer(device="cpu", max_wait_ms=0.5, **kw)
    server.load_model(path)
    return server


def test_http_round_trip(model):
    path, X, tb = model
    with _Http(_server(model)) as h:
        resp = h.post("/predict", {"rows": X[:5].tolist()},
                      headers={TRACE_HEADER: "abc123"})
        assert resp.headers[TRACE_HEADER] == "abc123"
        out = json.loads(resp.read())
        assert np.array_equal(np.asarray(out["predictions"], np.float32),
                              tb.predict(X[:5], device="cpu"))
        assert out["version"] == 1
        raw = json.loads(h.post("/predict", {"rows": X[:3].tolist(),
                                             "raw": True}).read())
        assert np.array_equal(np.asarray(raw["predictions"], np.float32),
                              tb.predict(X[:3], raw_score=True,
                                         device="cpu"))
        # binned rows arrive as JSON ints, cast to the model's bin dtype
        Xb = tb.mapper.transform(X[:3])
        binned = json.loads(h.post("/predict", {"rows": Xb.tolist(),
                                                "binned": True}).read())
        assert np.array_equal(np.asarray(binned["predictions"], np.float32),
                              tb.predict_binned(Xb, device="cpu"))
        stats = json.loads(h.get("/stats").read())
        assert stats["requests"] >= 3 and stats["device"] == "cpu"
        obs = json.loads(h.get("/obs").read())
        assert "dryad_serve_requests_total" in obs["counters"]
        assert set(json.loads(h.get("/clock").read())) == {"perf_s",
                                                           "wall_s"}
        with pytest.raises(urllib.error.HTTPError) as err:
            h.post("/predict", {"rows": X[:2].tolist(), "version": 99})
        assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            h.get("/nowhere")
        assert err.value.code == 404


def test_http_bearer_auth_and_metrics(model):
    path, X, tb = model
    with _Http(_server(model), auth_token="tok3n") as h:
        assert json.loads(h.get("/healthz").read()) == {"ok": True}
        for p in ("/stats", "/metrics", "/obs"):
            with pytest.raises(urllib.error.HTTPError) as err:
                h.get(p)
            assert err.value.code == 401
            assert err.value.headers["WWW-Authenticate"] == "Bearer"
        with pytest.raises(urllib.error.HTTPError) as err:
            h.get("/stats", token="wrong")
        assert err.value.code == 401
        with pytest.raises(urllib.error.HTTPError) as err:
            h.post("/predict", {"rows": X[:2].tolist()})
        assert err.value.code == 401
        out = json.loads(h.post("/predict", {"rows": X[:2].tolist()},
                                headers={"Authorization": "Bearer tok3n"})
                         .read())
        assert np.array_equal(np.asarray(out["predictions"], np.float32),
                              tb.predict(X[:2], device="cpu"))
        stats = json.loads(h.get("/stats", token="tok3n").read())
        assert stats["requests"] >= 1 and "counters" not in stats
        text = h.get("/metrics", token="tok3n").read().decode()
        assert "# TYPE dryad_serve_requests_total counter" in text
        assert "dryad_request_latency_seconds_bucket" in text


def test_healthz_degrades_on_unexpected_compile(model):
    """After ``warmup_complete()`` a first call at a new (version, bucket)
    shape fires the tripwire: ``/healthz`` answers 503 naming it; a
    re-warm re-arms and ``/healthz`` answers 200 again."""
    path, X, tb = model
    server = _server(model, max_batch_rows=64)
    with _Http(server) as h:
        h.post("/predict", {"rows": X[:3].tolist()})      # bucket 8 only
        server.warmup_complete()
        assert json.loads(h.get("/healthz").read()) == {"ok": True}
        h.post("/predict", {"rows": X[:20].tolist()})     # bucket 32: new
        with pytest.raises(urllib.error.HTTPError) as err:
            h.get("/healthz")
        assert err.value.code == 503
        body = json.loads(err.value.read())
        assert body["ok"] is False
        assert body["degraded"] == ["recompile:serve.predict"]
        text = h.get("/metrics").read().decode()
        assert ('dryad_recompile_unexpected_total{program="serve.predict"}'
                in text)
        assert server.warmup() == 4
        assert json.loads(h.get("/healthz").read()) == {"ok": True}
        h.post("/predict", {"rows": X[:50].tolist()})     # warm: bucket 64
        assert json.loads(h.get("/healthz").read()) == {"ok": True}


def test_http_structured_request_logging_and_fault_hook(model):
    path, X, tb = model
    stream = io.StringIO()
    calls = []

    def hook(site, n):
        calls.append((site, n))
        if site == "request" and n == 2:
            raise InjectedReject("drill")

    with _Http(_server(model), log_requests=True, log_stream=stream,
               fault_hook=hook) as h:
        h.post("/predict", {"rows": X[:3].tolist()}).read()
        with pytest.raises(urllib.error.HTTPError) as err:
            h.post("/predict", {"rows": X[:3].tolist()})
        assert err.value.code == 503
        with pytest.raises(urllib.error.HTTPError):
            h.post("/predict", {"rows": X[:2].tolist(), "version": 99})
        h.get("/stats").read()
    assert calls == [("request", 1), ("request", 2), ("request", 3)]
    lines = [json.loads(line) for line in stream.getvalue().splitlines()]
    assert [x["status"] for x in lines] == [200, 503, 400, 200]
    ok = lines[0]
    assert ok["path"] == "/predict" and ok["method"] == "POST"
    assert ok["version"] == 1 and ok["rows"] == 3 and ok["latency_ms"] >= 0
    assert lines[2]["version"] is None
    assert lines[3]["path"] == "/stats"


def _cli(args, env_extra=None, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "dryad_tpu_torch", "serve",
                           *args], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_one_shot_equals_direct_predict(model, tmp_path):
    path, X, tb = model
    rows = str(tmp_path / "rows.npy")
    np.save(rows, X[:37])
    out = str(tmp_path / "p.npy")
    res = _cli(["--model", path, "--model", f"champion={path}", "--request",
                rows, "--out", out, "--device", "cpu", "--warmup", "--raw",
                "--max-batch-rows", "16"])
    assert res.returncode == 0, res.stderr
    assert "version 2 (name 'champion')" in res.stdout
    assert "warmed 4 (version, bucket) programs" in res.stdout
    np.testing.assert_array_equal(np.load(out),
                                  tb.predict(X[:37], raw_score=True,
                                             device="cpu"))
    # the default device is the card: with none the command fails
    res = _cli(["--model", path, "--request", rows, "--out", out, "--quiet"],
               env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr


# ---- the model-admin routes, /trace and the drift block ---------------------

def _reference_http(path):
    from dryad_tpu.serve import PredictServer as JServer
    from dryad_tpu.serve.http import make_http_server as j_make

    server = JServer(backend="cpu", max_wait_ms=0.5)
    server.load_model(path)
    h = _Http.__new__(_Http)
    h.server = server
    h.httpd = j_make(server, port=0)
    h.base = f"http://127.0.0.1:{h.httpd.server_address[1]}"
    h.thread = threading.Thread(target=h.httpd.serve_forever, daemon=True)
    return h


def test_models_routes_match_reference(model, tmp_path):
    """``GET /models`` and ``POST /models/load|activate|rollback`` answer
    as the reference's server does, and every answer after them is
    bitwise the direct predict of the version that should serve."""
    path_a, X, tb_a = model
    Xb, yb = higgs_like(600, seed=8)
    jb = dryad_tpu.train(dict(objective="binary", num_trees=5, num_leaves=5,
                              max_bins=32),
                         dryad_tpu.Dataset(Xb, yb, max_bins=32),
                         backend="cpu")
    path_b = str(tmp_path / "b.dryad")
    jb.save(path_b)
    tb_b = dt.Booster.load(path_b)
    direct = {1: tb_a.predict(X[:7], device="cpu"),
              2: tb_b.predict(X[:7], device="cpu")}
    steps = [("GET", "/models", None),
             ("POST", "/models/load", {"path": path_b, "name": "next"}),
             ("GET", "/models", None),
             ("POST", "/models/activate", {"version": 1}),
             ("GET", "/models", None),
             ("POST", "/models/rollback", {}),
             ("GET", "/models", None),
             ("POST", "/models/load", {"path": path_a, "activate": False}),
             ("GET", "/models", None)]
    answers = []
    for h in (_Http(_server(model)), _reference_http(path_a)):
        got = []
        with h:
            for method, route, body in steps:
                resp = (h.get(route) if method == "GET"
                        else h.post(route, body))
                got.append(json.loads(resp.read()))
                out = json.loads(h.post("/predict",
                                        {"rows": X[:7].tolist()}).read())
                v = out["version"]
                if v in direct:
                    assert np.array_equal(
                        np.asarray(out["predictions"], np.float32),
                        direct[v]), (route, v)
            with pytest.raises(urllib.error.HTTPError) as err:
                h.post("/models/activate", {"version": 99})
            assert err.value.code == 400
        answers.append(got)
    assert answers[0] == answers[1]
    assert answers[0][1] == {"version": 2}
    assert answers[0][2]["active"] == 2 and answers[0][2]["aliases"] == {
        "next": 2}


def test_trace_events_carry_the_request_trace_id(model):
    from dryad_tpu_torch.obs.trace_export import (disable_tracing,
                                                  enable_tracing)

    path, X, tb = model
    buf = enable_tracing()
    buf.clear()
    try:
        with _Http(_server(model)) as h:
            resp = h.post("/predict", {"rows": X[:3].tolist()},
                          headers={TRACE_HEADER: "feedface"})
            assert resp.headers[TRACE_HEADER] == "feedface"
            # no header while tracing is on: an id is minted and echoed
            minted = h.post("/predict", {"rows": X[:2].tolist()}).headers[
                TRACE_HEADER]
            assert minted and len(minted) == 16 and minted != "feedface"
            ev = json.loads(h.get("/trace/events").read())
            assert set(ev) == {"events", "dropped", "clock"}
            tagged = {e[4] for e in ev["events"] if len(e) > 4 and e[4]}
            assert {"feedface", minted} <= tagged
            paths = {e[0] for e in ev["events"] if e[4] == "feedface"}
            assert "serve.request/predict" in paths, paths
            doc = json.loads(h.get("/trace").read())
            assert any(e.get("args", {}).get("trace") == "feedface"
                       for e in doc["traceEvents"] if e["ph"] == "X")
        disable_tracing()
        with _Http(_server(model)) as h:
            resp = h.post("/predict", {"rows": X[:2].tolist()})
            assert resp.headers.get(TRACE_HEADER) is None
            assert json.loads(h.get("/trace/events").read())["events"] == []
    finally:
        disable_tracing()
        buf.clear()


def test_obs_carries_the_drift_block(model, tmp_path):
    from dryad_tpu_torch.data.profile import build_reference_profile

    path, X, tb = model
    b = dt.Booster.load(path)
    b.profile = build_reference_profile(
        b, dt.Dataset(X, np.zeros(len(X), np.float32), mapper=b.mapper),
        device="cpu")
    with_profile = str(tmp_path / "p.dryad")
    b.save(with_profile)
    server = PredictServer(device="cpu", max_wait_ms=0.5)
    server.load_model(with_profile, name="champion")
    with _Http(server) as h:
        h.post("/predict", {"rows": X[:40].tolist()}).read()
        obs = json.loads(h.get("/obs").read())
        block = obs["drift"]["champion"]
        assert block["rows"] == 40 and block["score"][2] == 40
        assert block["ref_features"] == b.profile.feature_counts
        stats = json.loads(h.get("/stats").read())
        assert stats["drift"]["champion"]["rows"] == 40
    with _Http(_server(model)) as h:                # no profile: no block
        h.post("/predict", {"rows": X[:4].tolist()}).read()
        assert "drift" not in json.loads(h.get("/obs").read())
