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
            "cv.py", "sklearn.py"} <= names
