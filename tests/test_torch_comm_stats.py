"""The collective accounting of a process-group run (M12b):
``engine/train.comm_stats`` and its ``dryad_comm_*`` gauges.

* Call counts equal the reference's ``_comm_stats`` on a grid: depthwise
  (wired and legacy arm, with and without histogram subtraction) and
  leaf-wise (batched, and the sequential grower), fused and feature arm,
  K = 1 and 3, with and without categoricals, 2 and 3 shards.  The
  reference is asked for its Pallas arm (``platform="tpu"``,
  ``shared_roots=False``), the plan the port follows.  Where the port
  differs by design, the test names it: a categorical level's raw left
  sets ride the records' all-gather (one call a level where the
  reference makes two), and the sequential grower without subtraction
  makes two passes a split.  Bytes are the port's own sizes: the
  histogram payloads are twice the reference's (8-byte fixed-point cells
  against 4-byte floats), the split records 32 bytes plus 4 a bin under
  categoricals.
* Bytes and calls equal what ``RowGroup.stats`` counted in a two-rank
  gloo run of a set of configs (``tests/torch_dist_worker.py``), and the
  run exported its gauges.
"""

import os
import pickle
import subprocess
import sys
import time

import pytest

import torch_dist_worker as W
from torch_layout import one_torch_thread  # noqa: F401 (autouse)

from dryad_tpu_torch.config import effective_depth_params, make_params
from dryad_tpu_torch.engine.train import comm_stats
from dryad_tpu_torch.obs.comm import export_comm_stats
from dryad_tpu_torch.obs.registry import Registry

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
F, B, N = 12, 32, 4096

GROWTHS = {
    "wired": {"growth": "depthwise", "max_depth": 6, "num_leaves": 40},
    "legacy": {"growth": "depthwise", "max_depth": 6, "num_leaves": 40,
               "deep_layout": "legacy"},
    "wired_nosub": {"growth": "depthwise", "max_depth": 5, "num_leaves": 20,
                    "hist_subtraction": False},
    "legacy_nosub": {"growth": "depthwise", "max_depth": 5,
                     "num_leaves": 20, "deep_layout": "legacy",
                     "hist_subtraction": False},
    "leafwise": {"growth": "leafwise", "max_depth": 6, "num_leaves": 20},
    "sequential": {"growth": "leafwise", "num_leaves": 8,
                   "unbounded_depth": "exact"},
}


def _pair(growth, arm, K):
    kw = dict(GROWTHS[growth], max_bins=B, hist_reduce=arm)
    if K > 1:
        kw.update(objective="multiclass", num_class=K)
    from dryad_tpu.config import make_params as jmake_params

    mine = effective_depth_params(make_params(kw), F, B, N)
    ref = jmake_params(dict(kw, max_depth=mine.max_depth))
    return mine, ref


@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("has_cat", [False, True])
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("arm", ["fused", "feature"])
@pytest.mark.parametrize("growth", list(GROWTHS))
def test_calls_are_the_references(growth, arm, K, has_cat, shards):
    from dryad_tpu.engine.train import _comm_stats

    mine, ref = _pair(growth, arm, K)
    got = comm_stats(mine, F, B, K, shards, num_rows=N,
                     gate_rows=-(-N // shards), has_cat=has_cat)
    want = _comm_stats(ref, F, B, K, shards, shared_roots=False,
                       num_rows=N, padded_rows=N, platform="tpu",
                       has_cat=has_cat)
    assert got["hist_reduce"] == want["hist_reduce"]
    assert got["n_shards"] == want["n_shards"] == shards
    for k in ("psum_calls_per_iter", "reduce_scatter_calls_per_iter"):
        assert got[k] == want[k], k
    # by design: one all-gather a level carries the records and the raw
    # categorical rows together
    assert got["all_gather_calls_per_iter"] == (
        want["all_gather_calls_per_iter"] // (2 if has_cat else 1))
    # 8-byte cells against the reference's 4-byte floats
    assert got["psum_bytes_per_iter"] == 2 * want["psum_bytes_per_iter"]
    assert (got["reduce_scatter_bytes_per_iter"]
            == 2 * want["reduce_scatter_bytes_per_iter"])
    if not has_cat:
        assert (got["all_gather_bytes_per_iter"]
                == want["all_gather_bytes_per_iter"])


def test_sequential_without_subtraction_makes_two_passes_a_split():
    """By design (the reference counts one): both children of a split are
    their own masked pass."""
    mine, _ = _pair("sequential", "fused", 1)
    p = mine.replace(hist_subtraction=False)
    a = comm_stats(mine, F, B, 1, 2, num_rows=N)
    b = comm_stats(p, F, B, 1, 2, num_rows=N)
    L = mine.effective_num_leaves
    assert a["psum_calls_per_iter"] == 1 + (L - 1)
    assert b["psum_calls_per_iter"] == 1 + 2 * (L - 1)


def test_export_sets_the_gauges():
    reg = Registry()
    comm = comm_stats(_pair("wired", "feature", 1)[0], F, B, 1, 2,
                      num_rows=N)
    assert export_comm_stats(comm, growth="depthwise", registry=reg) == 5
    g = reg.snapshot()["gauges"]
    lbl = 'arm="feature",growth="depthwise",shards="2"'
    assert (g["dryad_comm_collective_bytes_per_iter"][lbl]
            == comm["collective_bytes_per_iter"])
    assert export_comm_stats(comm, growth="depthwise",
                             registry=Registry(enabled=False)) == 0


# configs of the two-rank run: every growth, both arms, multiclass and a
# categorical on the feature arm
RUN = ["depthwise_wired", "depthwise_legacy", "leafwise_batched",
       "leafwise_legacy", "sequential", "multiclass", "categorical",
       "depthwise_wired_feature", "depthwise_legacy_feature",
       "leafwise_batched_feature", "categorical_feature"]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("comm")
    spec = {"world": 2, "store": str(d / "store"), "timeout_s": 60,
            "comm": RUN}
    path = str(d / "spec.pkl")
    with open(path, "wb") as f:
        pickle.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, TESTS, os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    procs = []
    for r in range(2):
        with open(f"{path}.{r}.log", "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(TESTS, "torch_dist_worker.py"),
                 path, str(r)], env=env, stdout=log,
                stderr=subprocess.STDOUT))
    deadline = time.monotonic() + 240
    try:
        outs = []
        for r, p in enumerate(procs):
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
            with open(f"{path}.{r}.log", errors="replace") as f:
                log = f.read()[-3000:]
            assert p.returncode == 0, f"rank {r}:\n{log}"
            with open(f"{path}.{r}.out", "rb") as f:
                outs.append(pickle.load(f))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, out in enumerate(outs):
        assert "error" not in out, f"rank {r}:\n{out['error']}"
    return outs


@pytest.mark.parametrize("name", RUN)
def test_bytes_are_what_the_group_counted(two_ranks, name):
    for out in two_ranks:
        run = out[name]
        c, st, it = run["comm"], run["stats"], run["iterations"]
        hist = st["hist"]
        assert hist["calls"] == it * (c["psum_calls_per_iter"]
                                      + c["reduce_scatter_calls_per_iter"])
        assert hist.get("all_reduce_bytes", 0) == it * c["psum_bytes_per_iter"]
        assert (hist.get("reduce_scatter_bytes", 0)
                == it * c["reduce_scatter_bytes_per_iter"])
        splits = st.get("splits", {"calls": 0})
        assert splits["calls"] == it * c["all_gather_calls_per_iter"]
        assert (splits.get("all_gather_bytes", 0)
                == it * c["all_gather_bytes_per_iter"])
        lbl = (f'arm="{c["hist_reduce"]}",'
               f'growth="{W.CONFIGS[name][1]["growth"]}",shards="2"')
        assert (run["gauges"]["dryad_comm_collective_bytes_per_iter"][lbl]
                == c["collective_bytes_per_iter"])
