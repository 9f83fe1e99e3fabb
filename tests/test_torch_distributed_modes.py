"""The training modes that need cross-rank work of their own (M12b), over
gloo groups of CPU processes: every rank grows exactly the trees of one
process on all the rows.

A module fixture starts two groups at once, 2 and 3 ranks, each rank a
fresh interpreter running ``tests/torch_dist_worker.py`` on a
``file://`` store (as ``tests/test_torch_distributed.py`` does), and each
rank trains every config of ``torch_dist_worker.MODE_CONFIGS`` on both
``hist_reduce`` arms: GOSS (its group threshold and top count; also on
4001 rows, which divide neither world), lambdarank on
``query_row_range`` blocks (each query whole on one rank; the group's
padded width S), the leaf renewal of l1, huber and quantile (the
gathered in-bag residuals), l1 under GOSS (its mask is the bag), and a
bundled CSR set binned by every rank through one ``BundledMapper``.
Meanwhile this process trains the same configs without a group; the
comparison is bit for bit on every rank.  A group whose last rank
sketched its own mapper must raise on every rank.

On the reference's own fixtures (``tests/test_distributed.py``,
``tests/test_hist_reduce.py``, ``tests/test_multihost.py``) the two-rank
runs are also held to the reference's ``train_device`` over a mesh of two
of its virtual CPU devices, one run per mode: the same tree structure,
and leaf values within the reference tests' ``atol=1e-3`` where they
state one (GOSS, lambdarank), else ``rtol=1e-5``.  The bundled CSR set is
the exception: the reference's fp32 histograms (the larger child by
subtraction) lose 1.5e-5 on a 95-row leaf of its first tree (exact
0.17806783, the port 0.1780670, the reference 0.1780530), so its values
are held to the reference within ``atol=2e-5``, and the first tree's leaf
values to the float64 Newton values of the rows they hold within 1e-6.
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
JOIN_S = 300
NAMES = list(W.MODE_CONFIGS)
INT_KEYS = ("feature", "threshold", "left", "right", "default_left")


def _spawn(tmp, world):
    d = tmp / f"world{world}"
    d.mkdir()
    spec = {"world": world, "store": str(d / "store"),
            "timeout_s": TIMEOUT_S, "modes": NAMES}
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
    tmp = tmp_path_factory.mktemp("mode_groups")
    spawned = {w: _spawn(tmp, w) for w in WORLDS}
    try:
        data = W.make_mode_data()
        # one process has no arm: a "_feature" config's yardstick is its
        # fused twin's run
        base = {n: n.removesuffix("_feature") for n in NAMES}
        runs_ = {b: W.run_mode(b, data, group=False)
                 for b in set(base.values())}
        single = {n: runs_[base[n]] for n in NAMES}
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
    return data, single, outs


def _same(got: dict, want: dict, msg: str) -> None:
    got = {k: v for k, v in got.items() if k != "stats"}
    assert got.keys() == want.keys(), msg
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=f"{msg}: {k}")
        else:
            assert got[k] == v, f"{msg}: {k}"


@pytest.mark.parametrize("world", WORLDS)
def test_no_rank_failed(runs, world):
    for r, out in enumerate(runs[2][world]):
        assert "error" not in out, f"rank {r}:\n{out.get('error')}"


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", NAMES)
def test_ranks_grow_the_single_process_trees(runs, name, world):
    _, single, outs = runs
    for r, out in enumerate(outs[world]):
        _same(out[name], single[name], f"{name} world {world} rank {r}")


@pytest.mark.parametrize("world", WORLDS)
def test_each_mode_counts_its_collectives(runs, world):
    """Each new purpose appears in ``RowGroup.stats`` where its mode runs:
    GOSS's four radix rounds of 256 int64 counts and its top count each
    iteration, the renewal's two gathers (lengths, then 12-byte rows) each
    tree, lambdarank's one MAX of S, and the mapper digests' two."""
    for out in runs[2][world]:
        for name in NAMES:
            st = out[name]["stats"]
            p = W.MODE_CONFIGS[name][1]
            trees = p["num_trees"]
            assert st["mapper"]["calls"] == 2, name
            if p.get("boosting") == "goss":
                assert st["goss"] == {"calls": 5 * trees,
                                      "all_reduce_bytes":
                                          (4 * 256 + 1) * 8 * trees}, name
            else:
                assert "goss" not in st, name
            if p["objective"] in ("l1", "huber", "quantile"):
                assert st["renew"]["calls"] == 2 * trees, name
                assert st["renew"]["all_gather_bytes"] % 12 == 0, name
            else:
                assert "renew" not in st, name
            if p["objective"] == "lambdarank":
                assert st["rank_plan"] == {"calls": 1,
                                           "all_reduce_bytes": 8}, name


def test_query_blocks_hold_whole_queries(runs):
    """``query_row_range`` cuts at query boundaries, covers every row in
    order and balances the blocks to within the largest query."""
    from dryad_tpu_torch.distributed import query_row_range, rank_queries

    off = runs[0]["rank"][4]
    sizes = np.diff(off)
    for world in (1, 2, 3, 7):
        cuts = [query_row_range(off, r, world) for r in range(world)]
        assert cuts[0][0] == 0 and cuts[-1][1] == off[-1]
        for r, (lo, hi) in enumerate(cuts):
            assert lo in off and hi in off
            assert r == 0 or cuts[r - 1][1] == lo
            assert rank_queries(off, lo, hi).sum() == hi - lo
            assert abs((hi - lo) - off[-1] / world) <= sizes.max()


@pytest.mark.parametrize("world", WORLDS)
def test_different_mappers_raise(runs, world):
    for out in runs[2][world]:
        msg = out["mismatch"]
        assert msg.startswith("ValueError") and f"[{world - 1}]" in msg, msg


def test_csr_fixture_is_the_references(runs):
    """The worker's copy of the bundling fixture and its bundled mapper
    are the reference's, bit for bit."""
    from dryad_tpu.data.streaming import dataset_from_csr_chunks
    from dryad_tpu.distributed import sketch_distributed
    from tests.test_bundling import _onehot_csr

    (indptr, cols, vals, F), y = _onehot_csr(n=W.CSR_ROWS)
    csr, y2, mapper = runs[0]["csr"]
    for a, b in zip((indptr, cols, vals, F), csr):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(y, y2)
    assert mapper.to_bytes() == _reference_csr_mapper(
        sketch_distributed, dataset_from_csr_chunks).to_bytes()


def _reference_csr_mapper(sketch_distributed, dataset_from_csr_chunks):
    csr, _ = W.onehot_csr(n=W.CSR_ROWS)
    n = W.CSR_ROWS
    indptr, cols, vals, F = csr
    dense = np.zeros((n, F), np.float32)
    for r in range(n):
        dense[r, cols[indptr[r]:indptr[r + 1]]] = vals[indptr[r]:indptr[r + 1]]
    base = sketch_distributed(dense, n, 0, max_bins=64)

    def chunks():
        for lo in range(0, n, 1000):
            yield W.csr_rows(csr, lo, min(lo + 1000, n))[:3]

    return dataset_from_csr_chunks(chunks, np.zeros(n, np.float32), n, F,
                                   max_bins=64, mapper=base,
                                   plan_rows=1500).mapper


# one reference mesh run per mode, over two devices, on one arm each:
# name -> the values' absolute tolerance (None: rtol 1e-5)
REFERENCE = {"goss": 1e-3, "lambdarank": 1e-3, "l1_feature": None,
             "l1_goss": None, "csr_feature": 2e-5}


@pytest.fixture(scope="module")
def reference_mesh():
    """The reference's ``train_device`` over a mesh of two of the eight
    virtual CPU devices (``tests/conftest.py``) on each mode's fixture."""
    import jax

    import dryad_tpu
    from dryad_tpu.config import make_params
    from dryad_tpu.data.streaming import dataset_from_csr_chunks
    from dryad_tpu.datasets import higgs_like, mslr_like
    from dryad_tpu.distributed import sketch_distributed
    from dryad_tpu.engine.distributed import make_mesh
    from dryad_tpu.engine.train import train_device

    mesh = make_mesh(jax.devices()[:2])
    X, y = higgs_like(4096, seed=41)
    goss = dryad_tpu.Dataset(X, y, max_bins=32)
    X, y = higgs_like(4096, seed=43)
    robust = dryad_tpu.Dataset(X, y, max_bins=32)
    X, y, group = mslr_like(120, seed=45)
    rank = dryad_tpu.Dataset(X, y, group=group, max_bins=32)
    csr, y = W.onehot_csr(n=W.CSR_ROWS)
    mapper = _reference_csr_mapper(sketch_distributed,
                                   dataset_from_csr_chunks)
    n = W.CSR_ROWS

    def chunks():
        for lo in range(0, n, 1000):
            yield W.csr_rows(csr, lo, min(lo + 1000, n))[:3]

    csr_ds = dataset_from_csr_chunks(chunks, y, n, csr[3], max_bins=64,
                                     mapper=mapper.base, plan_rows=1500)
    sets = {"goss": goss, "lambdarank": rank, "l1_feature": robust,
            "l1_goss": robust, "csr_feature": csr_ds}
    return {name: train_device(make_params(W.MODE_CONFIGS[name][1]),
                               sets[name], mesh=mesh).tree_arrays()
            for name in REFERENCE}


@pytest.mark.parametrize("name", list(REFERENCE))
def test_two_ranks_match_the_reference_mesh(runs, reference_mesh, name):
    want = reference_mesh[name]
    atol = REFERENCE[name]
    for r, out in enumerate(runs[2][2]):
        got = out[name]
        msg = f"{name} rank {r}"
        for k in INT_KEYS:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=f"{msg}: {k}")
        if atol is not None:
            np.testing.assert_allclose(got["value"], want["value"], rtol=0,
                                       atol=atol, err_msg=msg)
        else:
            np.testing.assert_allclose(got["value"], want["value"],
                                       rtol=1e-5, err_msg=msg)


def test_csr_first_tree_values_are_exact(runs):
    """The bundled CSR run's first tree: each leaf's value is the Newton
    step of the rows it holds, computed in float64 from the init score's
    gradients, within 1e-6: the port's exact sums lose at most 8.3e-7
    here, in the fp32 subtraction that gives each larger child, and the
    reference's fp32 sums up to 1.5e-5."""
    from dryad_tpu_torch import make_params
    from dryad_tpu_torch.booster import ARRAY_KEYS, Booster

    data, _, outs = runs
    ds = W.mode_dataset("csr", data)
    p = make_params(W.MODE_CONFIGS["csr"][1])
    got = outs[2][0]["csr"]
    b = Booster(p, ds.mapper, {k: got[k][:1] for k in ARRAY_KEYS},
                got["init_score"], p.max_depth, 0, {})
    leaf = b.predict_binned(ds.X_binned, pred_leaf=True, device="cpu")[:, 0]
    prob = 1.0 / (1.0 + np.exp(-float(b.init_score[0])))
    value = b.tree_arrays()["value"][0]
    leaves = np.unique(leaf)
    assert leaves.size > 8
    for m in leaves:
        y = ds.y[leaf == m].astype(np.float64)
        G, H = (prob - y).sum(), prob * (1 - prob) * y.size
        exact = -G / (H + p.lambda_l2) * p.learning_rate
        np.testing.assert_allclose(value[m], exact, rtol=0, atol=1e-6)
