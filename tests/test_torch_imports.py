"""The port stands alone: dryad_tpu_torch (and chip_smoke.py) import
neither jax nor dryad_tpu, directly or transitively, and its entry points
never fall back to the CPU on their own."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "dryad_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "dryad_tpu", "dryad")


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_pulls_in_no_jax_and_no_reference():
    code = (
        "import pkgutil, importlib, sys\n"
        "import dryad_tpu_torch\n"
        "for m in pkgutil.walk_packages(dryad_tpu_torch.__path__,"
        " 'dryad_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in"
        f" {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('clean', len([k for k in sys.modules"
        " if k.startswith('dryad_tpu_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_no_forbidden_import_statements(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path}: imports {n}"


def test_entry_points_refuse_without_a_card(monkeypatch):
    import dryad_tpu_torch as dt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.default_rng(0).normal(size=(600, 3)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    ds = dt.Dataset(X, y, max_bins=16)
    params = {"growth": "depthwise", "max_depth": 2, "num_trees": 1}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.train(params, ds)
    b = dt.train(params, ds, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.predict(b, X)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        b.predict(X, device="cuda")
    assert dt.predict(b, X, device="cpu").shape == (600,)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """With no card chip_smoke exits non-zero and prints no result; alone in
    a directory (no package beside it) it fails as well."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=str(ROOT), env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_scan_covers_the_training_loop_modules():
    names = {p.relative_to(PKG).as_posix() for p in _port_sources()
             if PKG in p.parents}
    assert {"engine/train.py", "engine/loop_state.py", "metrics/__init__.py",
            "metrics/device.py", "callbacks.py", "checkpoint.py",
            "booster.py", "dataset.py", "engine/lambdarank.py",
            "objectives.py", "data/bundling.py", "data/binning.py",
            "data/sketch.py", "engine/shap.py", "engine/refit.py",
            "cv.py", "sklearn.py", "policy/__init__.py", "policy/table.py",
            "policy/gates.py", "policy/device.py", "policy/calibrate.py",
            "engine/probes.py", "engine/introspect.py", "obs/trends.py",
            "obs/profiler.py", "obs/watchdog.py", "obs/drift.py",
            "obs/slo.py", "obs/trace_export.py", "obs/journal_tail.py",
            "obs/exporter.py", "obs/spans.py", "obs/registry.py",
            "resilience/journal.py", "data/profile.py", "__main__.py",
            "serve/server.py", "serve/http.py", "serve/bench.py",
            "convert.py", "native/__init__.py", "resilience/__init__.py",
            "resilience/faults.py", "resilience/policy.py",
            "resilience/supervisor.py", "fleet/__init__.py",
            "fleet/replica.py", "fleet/supervisor.py", "fleet/router.py",
            "fleet/autoscale.py", "fleet/bench.py",
            "continual/__init__.py", "continual/scheduler.py",
            "continual/publish.py"} <= names


def test_policy_imports_without_torch():
    """The policy package imports no torch, and resolves every gate on the
    committed table without it (so it works while a card is wedged); so
    do the host-side trend and profile modules."""
    code = (
        "import sys\n"
        "import dryad_tpu_torch.policy as p\n"
        "from dryad_tpu_torch.policy import calibrate, gates\n"
        "import dryad_tpu_torch.obs.trends, dryad_tpu_torch.obs.profiler\n"
        "import dryad_tpu_torch.obs.watchdog\n"
        "assert calibrate.run_selftest(quiet=True) == 0\n"
        "tab = p.current_table()\n"
        "for g, cases in calibrate.PARITY_CASES.items():\n"
        "    # a gate a card's entry changes reads the card (the one lazy\n"
        "    # device touch); the rest never do\n"
        "    kw = {'device_kind': None} if tab.overrides_gate(g) else {}\n"
        "    for feats, _ in cases:\n"
        "        gates.resolve(g, feats, **kw)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] == 'torch')\n"
        "assert not bad, bad[:5]\n"
        "print('torch-free')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "torch-free"


def test_obs_journal_and_profile_import_without_torch():
    """The new host-side modules import no torch: drift, slo, the trace
    export, the journal tail, the exporter, the run journal and the
    reference profile (whose predict imports torch only when it runs)."""
    code = (
        "import sys\n"
        "import dryad_tpu_torch.obs.drift, dryad_tpu_torch.obs.slo\n"
        "import dryad_tpu_torch.obs.trace_export\n"
        "import dryad_tpu_torch.obs.journal_tail\n"
        "import dryad_tpu_torch.obs.exporter\n"
        "import dryad_tpu_torch.resilience.journal\n"
        "import dryad_tpu_torch.data.profile\n"
        "from dryad_tpu_torch.obs.exporter import start_exporter\n"
        "ex = start_exporter(port=0); ex.stop()\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] == 'torch')\n"
        "assert not bad, bad[:5]\n"
        "print('torch-free')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "torch-free"


def test_native_and_resilience_stand_alone():
    """``native`` and ``resilience`` import neither jax nor the reference,
    in a fresh interpreter; the native layer imports no torch, builds from
    the port's own source into the port's ``_build/`` and loads nothing of
    the reference's ``native/``."""
    code = (
        "import sys\n"
        "from dryad_tpu_torch import native\n"
        "assert native.available()\n"
        "assert native.lib_path().startswith(%r)\n"
        "assert native.SOURCE.startswith(%r)\n"
        "assert not [k for k in sys.modules if k.split('.')[0] == 'torch']\n"
        "import dryad_tpu_torch.resilience as r\n"
        "from dryad_tpu_torch.resilience import faults, policy, supervisor\n"
        "assert r.RetryPolicy().ch_max_ladder\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in %r)\n"
        "assert not bad, bad\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'libdryad_native' not in maps\n"
        "print('alone')\n") % (str(PKG / "_build"), str(PKG / "native"),
                               FORBIDDEN)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("DRYAD_NATIVE", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "alone"
    src = (PKG / "native" / "src" / "dryad_native.cpp").read_text()
    assert "predict_accumulate(" not in src and "tree_leaves(" not in src


def _control_plane_sources():
    return sorted((PKG / "fleet").glob("*.py")) + sorted(
        (PKG / "continual").glob("*.py"))


def test_fleet_and_continual_import_without_torch():
    """The control plane (``fleet`` and ``continual``, every module,
    ``fleet.bench`` included) imports none of torch, jax or the reference,
    directly or transitively, in a fresh interpreter: it must keep
    supervising replicas while a card is wedged."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import dryad_tpu_torch.fleet as f, dryad_tpu_torch.continual as c\n"
        "for pkg in (f, c):\n"
        "    for m in pkgutil.walk_packages(pkg.__path__,"
        " pkg.__name__ + '.'):\n"
        "        importlib.import_module(m.name)\n"
        "from dryad_tpu_torch.fleet import FleetSupervisor, FleetRouter\n"
        "from dryad_tpu_torch.continual import RetrainScheduler\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in"
        f" {FORBIDDEN + ('torch',)!r})\n"
        "assert not bad, bad[:5]\n"
        "print('torch-free', len([k for k in sys.modules"
        " if k.startswith(('dryad_tpu_torch.fleet',"
        " 'dryad_tpu_torch.continual'))]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["torch-free", "9"]


@pytest.mark.parametrize("path", _control_plane_sources(),
                         ids=lambda p: f"{p.parent.name}/{p.name}")
def test_control_plane_has_no_torch_import_statement(path):
    """No import statement of the control plane names torch, even one
    deferred into a function body."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN + ("torch",), \
                f"{path}: imports {n}"


def test_cli_refuses_without_a_card(monkeypatch, tmp_path):
    """``train``, ``predict`` and ``retrain`` default to the card and raise
    with none, before any data is read."""
    from dryad_tpu_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "absent.npy")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train", "--data", missing, "--label", missing, "--quiet"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["predict", "--model", missing, "--data", missing,
              "--out", str(tmp_path / "p.npy")])
    # the continual worker too, before it reads the model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["retrain", "--model", missing, "--data", missing,
              "--out", str(tmp_path / "g.dryad")])
