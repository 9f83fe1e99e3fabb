"""Data-parallel training over gloo groups of CPU processes (M12a): N
ranks grow exactly the trees of one process on all the rows.

A module fixture starts two groups at once, 2 ranks and 3 ranks over
4099 rows (uneven blocks), each rank a fresh interpreter running
``tests/torch_dist_worker.py`` with ``init_method=file://...`` (no TCP
port, so parallel test workers cannot collide).  Each rank trains every
config of ``torch_dist_worker.CONFIGS`` through ``train_distributed`` and
hands back its boosters' tree arrays; meanwhile this process trains the
same configs without a group.  The comparison is bit for bit: integer
arrays, leaf values, gains, covers, the init score, the best iteration
and the eval history, on every rank.

Covered: depthwise wired and legacy (K3 and K1 rows), batched leaf-wise
on both arms, the sequential grower, multiclass K=3, bagging with column
sampling, weights, a valid set with early stopping, another with its eval
history, DART, rf, monotone constraints, dense categoricals, the feature
arm (reduce-scatter + combine) on five of these against the fused single
process, a rank holding no rows on either arm, the legacy arm's
natural-order gate set between the ranks' row counts (and at 0, which
only an empty rank passes), a rank-0 checkpoint crashed and resumed
against the straight run, and the streamed set a group refuses.  On the
reference's tie-free fixture (``tests/test_hist_reduce.py``) the groups
of 2 and 3 ranks are also held against the reference's ``train_device``
over meshes of 2 and 3 devices, on both arms.  Every collective runs under a 60 s group timeout and the parent
joins with one, so a hang fails instead of stalling the suite.
"""

import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

import torch_dist_worker as W
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
WORLDS = (2, 3)
TIMEOUT_S = 60
JOIN_S = 240
NAMES = list(W.CONFIGS)
FEATURE_OF = {n: n[:-len("_feature")] for n in NAMES
              if n.endswith("_feature")}
FEATURE_OF["bagging_monotone_feature"] = None     # has no fused twin
FEATURE_OF["empty_rank_feature"] = None


def _spawn(tmp, world):
    d = tmp / f"world{world}"
    d.mkdir()
    spec = {"world": world, "store": str(d / "store"),
            "timeout_s": TIMEOUT_S, "configs": NAMES + ["resume"],
            "ckpt_dir": str(d / "ckpt"), "refused": list(W.REFUSED)}
    path = str(d / "spec.pkl")
    with open(path, "wb") as f:
        pickle.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, TESTS, os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        with open(f"{path}.{r}.log", "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(TESTS, "torch_dist_worker.py"),
                 path, str(r)], env=env, stdout=log,
                stderr=subprocess.STDOUT))
    return path, procs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("groups")
    spawned = {w: _spawn(tmp, w) for w in WORLDS}
    try:
        data = W.make_data()
        single = {n: W.run_config(n, data, group=False)
                  for n in NAMES + ["resume_straight"]}
        deadline = time.monotonic() + JOIN_S
        outs = {}
        for w, (path, procs) in spawned.items():
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            ranks = []
            for r, p in enumerate(procs):
                with open(f"{path}.{r}.log", errors="replace") as f:
                    log = f.read()[-3000:]
                assert p.returncode == 0, f"world {w} rank {r}:\n{log}"
                with open(f"{path}.{r}.out", "rb") as f:
                    ranks.append(pickle.load(f))
            outs[w] = ranks
    finally:
        for _, procs in spawned.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return single, outs


def _same(got: dict, want: dict, msg: str) -> None:
    assert got.keys() == want.keys(), msg
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=f"{msg}: {k}")
        else:
            assert got[k] == v, f"{msg}: {k}"


@pytest.mark.parametrize("world", WORLDS)
def test_no_rank_failed(runs, world):
    for r, out in enumerate(runs[1][world]):
        assert "error" not in out, f"rank {r}:\n{out.get('error')}"


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", NAMES)
def test_ranks_grow_the_single_process_trees(runs, name, world):
    single, outs = runs
    for r, out in enumerate(outs[world]):
        _same(out[name], single[name], f"{name} world {world} rank {r}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", [n for n, f in FEATURE_OF.items() if f])
def test_feature_arm_equals_fused_arm(runs, name, world):
    single, outs = runs
    twin = FEATURE_OF[name]
    for r, out in enumerate(outs[world]):
        _same(out[name], single[twin], f"{name} world {world} rank {r}")


@pytest.fixture(scope="module")
def reference_mesh():
    """The reference's ``train_device`` on its tie-free fixture over meshes
    of 2 and 3 of the 8 virtual CPU devices (``tests/conftest.py``), on
    both arms: its rows sharded as the ranks' are, its fp32 histograms
    psummed or reduce-scattered."""
    import jax

    import dryad_tpu
    from dryad_tpu.config import make_params
    from dryad_tpu.datasets import higgs_like
    from dryad_tpu.engine.distributed import make_mesh
    from dryad_tpu.engine.train import train_device

    X, y = higgs_like(W.REF_ROWS)
    ds = dryad_tpu.Dataset(X, y, max_bins=W.REF_PARAMS["max_bins"])
    base = dict(W.BASE, **W.REF_PARAMS)
    out = {}
    for n in WORLDS:
        mesh = make_mesh(jax.devices()[:n])
        for arm in ("fused", "feature"):
            out[arm, n] = train_device(make_params(dict(base,
                                                        hist_reduce=arm)),
                                       ds, mesh=mesh).tree_arrays()
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arm", ["fused", "feature"])
def test_ranks_match_the_reference_mesh(runs, reference_mesh, arm, world):
    """N ranks against the reference over N devices: the same trees,
    leaf values within 1e-5 relative or 1e-6 absolute (the reference sums
    fp32 histograms, the port fixed-point ones)."""
    name = "reference_fixture" + ("_feature" if arm == "feature" else "")
    want = reference_mesh[arm, world]
    for r, out in enumerate(runs[1][world]):
        got = out[name]
        msg = f"{arm} world {world} rank {r}"
        for k in ("feature", "threshold", "left", "right", "default_left"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=f"{msg}: {k}")
        np.testing.assert_allclose(got["value"], np.asarray(want["value"]),
                                   rtol=1e-5, atol=1e-6, err_msg=msg)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_holds_the_same_boosters(runs, world):
    outs = runs[1][world]
    for name in NAMES + ["resume"]:
        for r in range(1, world):
            _same(outs[r][name], outs[0][name], f"{name} rank {r}")


@pytest.mark.parametrize("world", WORLDS)
def test_rank0_checkpoint_crash_and_resume(runs, world):
    single, outs = runs
    for r, out in enumerate(outs[world]):
        _same(out["resume"], single["resume_straight"], f"resume rank {r}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", list(W.REFUSED))
def test_refused_modes_raise(runs, mode, world):
    """A streamed set is the one thing a group refuses, as the reference's
    mesh refuses it; every other mode is held to one process in
    ``tests/test_torch_distributed_modes.py``."""
    for out in runs[1][world]:
        msg = out["refused:" + mode]
        assert msg.startswith("ValueError") and "streamed" in msg, msg


def test_a_missing_rank_times_out(tmp_path):
    """Rank 1 never comes: rank 0 fails within its group timeout instead
    of waiting for ever."""
    code = ("import sys; from dryad_tpu_torch.distributed import initialize;"
            f"initialize(backend='gloo', init_method='file://{tmp_path}/s',"
            " rank=0, world_size=2, timeout_s=3)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert time.monotonic() - t0 < 100
