"""Rank worker and shared fixtures of the port's process-group tests
(imports no jax, so a fresh interpreter starts fast).

``python tests/torch_dist_worker.py SPEC RANK`` joins a gloo group through
``init_method=file://...``, trains every config of the pickled spec on its
own rows through ``dryad_tpu_torch.distributed.train_distributed`` on the
CPU, and pickles each config's trees (or the error it raised) to
``SPEC.RANK.out``.  The parent runs the same configs in one process
without a group (``run_config(..., group=False)``) and compares.
"""

from __future__ import annotations

import pickle
import sys
import traceback

import numpy as np

ROWS = 4099          # uneven over 2 and 3 ranks
BINS = 32
BASE = {"objective": "binary", "num_trees": 3, "max_bins": BINS,
        "learning_rate": 0.3, "min_data_in_leaf": 20}

# tests/test_hist_reduce.py's depthwise fixture: higgs_like(4096), 64 bins
REF_ROWS = 4096
REF_PARAMS = {"growth": "depthwise", "max_depth": 4, "num_leaves": 15,
              "max_bins": 64, "learning_rate": 0.2}

# name -> (dataset, params over BASE, row split); "split" names a rank
# that holds no rows ("empty0": rank 0, "empty1": rank 1)
CONFIGS = {
    "depthwise_wired": ("num", {"growth": "depthwise", "max_depth": 4,
                                "num_leaves": 15}, None),
    "depthwise_legacy": ("num", {"growth": "depthwise", "max_depth": 6,
                                 "num_leaves": 40, "deep_layout": "legacy"},
                         None),
    "leafwise_batched": ("num", {"growth": "leafwise", "max_depth": 4,
                                 "num_leaves": 12}, None),
    "leafwise_legacy": ("num", {"growth": "leafwise", "max_depth": 6,
                                "num_leaves": 20, "deep_layout": "legacy"},
                        None),
    "sequential": ("num", {"growth": "leafwise", "num_leaves": 8,
                           "unbounded_depth": "exact"}, None),
    "multiclass": ("multi", {"objective": "multiclass", "num_class": 3,
                             "growth": "depthwise", "max_depth": 3}, None),
    "bagging": ("num", {"growth": "depthwise", "max_depth": 4,
                        "subsample": 0.7, "colsample": 0.6, "seed": 5},
                None),
    "weights": ("weighted", {"growth": "depthwise", "max_depth": 4}, None),
    "valid_es": ("num", {"growth": "depthwise", "max_depth": 4,
                         "num_trees": 12, "metric": "auc",
                         "early_stopping_rounds": 2, "learning_rate": 0.8},
                 None),
    "valid_history": ("num", {"growth": "depthwise", "max_depth": 3,
                              "num_trees": 4}, None),
    "dart": ("num", {"growth": "depthwise", "max_depth": 3, "num_trees": 5,
                     "boosting": "dart", "drop_rate": 0.5,
                     "skip_drop": 0.0}, None),
    "rf": ("num", {"growth": "depthwise", "max_depth": 4, "boosting": "rf",
                   "subsample": 0.6}, None),
    "monotone": ("num", {"growth": "depthwise", "max_depth": 4,
                         "monotone_constraints": (1, -1, 0, 1)}, None),
    "categorical": ("cat", {"growth": "depthwise", "max_depth": 4,
                            "categorical_features": (0,)}, None),
    # the feature arm: the same trees as the fused arm, bit for bit
    "depthwise_wired_feature": ("num", {"growth": "depthwise",
                                        "max_depth": 4, "num_leaves": 15,
                                        "hist_reduce": "feature"}, None),
    "depthwise_legacy_feature": ("num", {"growth": "depthwise",
                                         "max_depth": 6, "num_leaves": 40,
                                         "deep_layout": "legacy",
                                         "hist_reduce": "feature"}, None),
    "leafwise_batched_feature": ("num", {"growth": "leafwise",
                                         "max_depth": 4, "num_leaves": 12,
                                         "hist_reduce": "feature"}, None),
    "categorical_feature": ("cat", {"growth": "depthwise", "max_depth": 4,
                                    "categorical_features": (0,),
                                    "hist_reduce": "feature"}, None),
    "bagging_monotone_feature": ("num", {
        "growth": "depthwise", "max_depth": 4, "subsample": 0.7,
        "colsample": 0.6, "seed": 5, "monotone_constraints": (1, -1, 0, 1),
        "hist_reduce": "feature"}, None),
    "empty_rank": ("num", {"growth": "depthwise", "max_depth": 4,
                           "num_leaves": 15}, "empty1"),
    "empty_rank_feature": ("num", {"growth": "leafwise", "max_depth": 4,
                                   "num_leaves": 12,
                                   "hist_reduce": "feature"}, "empty0"),
    # the reference's tie-free fixture (tests/test_hist_reduce.py), held
    # against its train_device over meshes of as many devices as ranks
    "reference_fixture": ("ref", REF_PARAMS, None),
    "reference_fixture_feature": ("ref", dict(REF_PARAMS,
                                              hist_reduce="feature"), None),
    # the natural-order gate between the ranks' row counts (NAT_GATE_ROWS)
    "legacy_gate_split": ("num", {"growth": "depthwise", "max_depth": 6,
                                  "num_leaves": 40, "deep_layout": "legacy"},
                          None),
    "legacy_gate_empty": ("num", {"growth": "depthwise", "max_depth": 6,
                                  "num_leaves": 40, "deep_layout": "legacy"},
                          "empty1"),
}

# name -> the rows the natural-order gate admits in a group of ``world``
# ranks (``hist_nat.NAT_GATE_MB`` lowered to that many rows of the matrix):
# the smallest rank's count, so the larger ranks would fail a gate on
# their own rows and the smaller pass it; or 0, which only an empty rank
# passes.  Each rank must still run the level plan of every other.
NAT_GATE_ROWS = {
    "legacy_gate_split": lambda world: ROWS // world,
    "legacy_gate_empty": lambda world: 0,
}

# the card test's group (tests/test_torch_cuda.py): the headline shape at
# 50k rows, both arms
CARD_ROWS = 50_000
CARD_CONFIGS = {
    "card_fused": ("card", {"growth": "depthwise", "max_depth": 8,
                            "num_leaves": 255, "max_bins": 256,
                            "learning_rate": 0.1, "num_trees": 4}, None),
    "card_feature": ("card", {"growth": "depthwise", "max_depth": 8,
                              "num_leaves": 255, "max_bins": 256,
                              "learning_rate": 0.1, "num_trees": 4,
                              "hist_reduce": "feature"}, None),
}

# the card test of the group's own collectives: GOSS's radix-select
# threshold and the renewal's gathered residuals on card tensors
CARD_MODE_CONFIGS = {
    "card_goss": ("card", {"growth": "depthwise", "max_depth": 6,
                           "num_leaves": 63, "max_bins": 256,
                           "num_trees": 3, "boosting": "goss",
                           "goss_top_rate": 0.2, "goss_other_rate": 0.1},
                  None),
    "card_l1_feature": ("card", {"objective": "l1", "growth": "depthwise",
                                 "max_depth": 6, "num_leaves": 63,
                                 "max_bins": 256, "num_trees": 3,
                                 "hist_reduce": "feature"}, None),
}

# the straight run a checkpointed, crashed and resumed run must equal
RESUME = ("num", {"growth": "depthwise", "max_depth": 4, "num_trees": 6})
RESUME_EVERY, RESUME_CRASH = 2, 4

# each must raise ValueError under a group (the reference refuses a
# streamed set under a mesh too)
REFUSED = {"streamed": {}}

# the modes that need cross-rank work beyond the histograms
# (tests/test_torch_distributed_modes.py), on the reference's own
# fixtures: name -> (dataset, params over MODE_BASE, row split); the split
# "query" cuts the rows at query boundaries (``query_row_range``)
MODE_BASE = {"objective": "binary", "max_bins": 32}
# the configs of tests/test_hist_reduce.py's feature-arm tests (depth 4:
# a deeper auto cap makes the CPU runs several times longer)
GOSS = {"boosting": "goss", "num_trees": 3, "num_leaves": 15,
        "max_depth": 4, "growth": "depthwise", "goss_top_rate": 0.3,
        "goss_other_rate": 0.2, "seed": 7}
ROBUST = {"num_trees": 3, "num_leaves": 15, "max_depth": 4,
          "growth": "leafwise"}
RANK = {"objective": "lambdarank", "num_trees": 3, "num_leaves": 15,
        "max_depth": 4}
CSR_PARAMS = {"num_trees": 4, "num_leaves": 15, "max_bins": 64,
              "max_depth": 5, "growth": "depthwise"}
_MODES = {
    # tests/test_distributed.py:101 and tests/test_hist_reduce.py:289, the
    # 4096-row fixture
    "goss": ("goss", GOSS, None),
    # tests/test_distributed.py:120: 4001 rows divide neither world
    "goss_uneven": ("goss_uneven", {"boosting": "goss", "num_trees": 4,
                                    "num_leaves": 8, "max_depth": 3},
                    None),
    # tests/test_distributed.py:136, whole queries per rank
    "lambdarank": ("rank", RANK, "query"),
    # tests/test_hist_reduce.py:301 and the other two renewals
    "l1": ("robust", dict(ROBUST, objective="l1"), None),
    "huber": ("robust", dict(ROBUST, objective="huber"), None),
    "quantile": ("robust", dict(ROBUST, objective="quantile", alpha=0.9),
                 None),
    # the renewal under GOSS, whose mask is the bag
    "l1_goss": ("robust", dict(ROBUST, objective="l1", boosting="goss",
                               goss_top_rate=0.3, goss_other_rate=0.2,
                               seed=7), None),
    # tests/test_multihost.py:136: bundled CSR rows, one mapper
    "csr": ("csr", CSR_PARAMS, None),
}
MODE_CONFIGS = {}
for _n, (_k, _p, _s) in _MODES.items():
    MODE_CONFIGS[_n] = (_k, dict(MODE_BASE, **_p), _s)
    MODE_CONFIGS[_n + "_feature"] = (_k, dict(MODE_BASE, **_p,
                                              hist_reduce="feature"), _s)
CSR_ROWS = 4096


def onehot_csr(n=6000, groups=6, levels=5, num_dense=3, seed=61):
    """A copy of ``tests/test_bundling.py::_onehot_csr`` (that module
    imports jax): num_dense dense columns and groups x levels one-hot
    columns, each group strictly exclusive, CSR encoded; y depends on the
    groups."""
    rng = np.random.default_rng(seed)
    F = num_dense + groups * levels
    dense = rng.normal(size=(n, num_dense)).astype(np.float32)
    cat = rng.integers(0, levels, size=(n, groups))
    rows, cols, vals = [], [], []
    for i in range(n):
        for d in range(num_dense):
            rows.append(i); cols.append(d); vals.append(dense[i, d])
        for gix in range(groups):
            rows.append(i)
            cols.append(num_dense + gix * levels + cat[i, gix])
            vals.append(1.0)
    order = np.lexsort((cols, rows))
    rows = np.asarray(rows)[order]
    cols = np.asarray(cols, np.int64)[order]
    vals = np.asarray(vals, np.float32)[order]
    indptr = np.searchsorted(rows, np.arange(n + 1)).astype(np.int64)
    logits = (dense[:, 0] + (cat[:, 0] == 2) * 1.5 - (cat[:, 1] >= 3) * 1.0
              + 0.3 * rng.normal(size=n))
    y = (logits > 0).astype(np.float32)
    return (indptr, cols, vals, F), y


def csr_rows(csr, lo: int, hi: int) -> tuple:
    """Rows [lo, hi) of a CSR quadruple, as a quadruple."""
    indptr, cols, vals, F = csr
    a, b = indptr[lo], indptr[hi]
    return (indptr[lo:hi + 1] - a, cols[a:b], vals[a:b], F)


def csr_mapper(csr, n: int):
    """The one bundled mapper of the CSR fixture, made as the reference's
    test makes it: ``sketch_distributed`` over the densified rows (one
    process: the gather is the identity), then the streamed CSR builder's
    bundle plan."""
    from dryad_tpu_torch.data.streaming import dataset_from_csr_chunks
    from dryad_tpu_torch.distributed import sketch_distributed

    indptr, cols, vals, F = csr
    dense = np.zeros((n, F), np.float32)
    for r in range(n):
        a, b = indptr[r], indptr[r + 1]
        dense[r, cols[a:b]] = vals[a:b]
    base = sketch_distributed(dense, n, 0, max_bins=64,
                              allgather=lambda a: [a])

    def chunks():
        for lo in range(0, n, 1000):
            yield csr_rows(csr, lo, min(lo + 1000, n))[:3]

    return dataset_from_csr_chunks(chunks, np.zeros(n, np.float32), n, F,
                                   max_bins=64, mapper=base,
                                   plan_rows=1500).mapper


def make_mode_data() -> dict:
    """The binned matrices of ``MODE_CONFIGS``' datasets: the reference
    tests' fixtures, binned by the port (``rank`` carries its query
    offsets, ``csr`` its rows and the bundled mapper)."""
    from dryad_tpu_torch import Dataset
    from dryad_tpu_torch.datasets import higgs_like, mslr_like

    out = {}
    for key, n, seed in (("goss", 4096, 41), ("goss_uneven", 4001, 43),
                         ("robust", 4096, 43)):
        X, y = higgs_like(n, seed=seed)
        ds = Dataset(X, y, max_bins=32)
        out[key] = (ds.X_binned, y, None, ds.mapper)
    X, y, group = mslr_like(120, seed=45)
    ds = Dataset(X, y, group=group, max_bins=32)
    out["rank"] = (ds.X_binned, y, None, ds.mapper, ds.query_offsets)
    csr, y = onehot_csr(n=CSR_ROWS)
    out["csr"] = (csr, y, csr_mapper(csr, CSR_ROWS))
    return out


def mode_dataset(name: str, data: dict, rank: int = 0, world: int = 1):
    """This rank's Dataset of a mode config (all rows without a group)."""
    from dryad_tpu_torch import Dataset
    from dryad_tpu_torch.distributed import (
        host_row_range,
        query_row_range,
        rank_queries,
    )

    key, _, split = MODE_CONFIGS[name]
    if key == "csr":
        csr, y, mapper = data["csr"]
        lo, hi = host_row_range(y.shape[0], rank, world)
        return Dataset(None, y[lo:hi], csr=csr_rows(csr, lo, hi),
                       mapper=mapper)
    Xb, y, w, mapper = data[key][:4]
    if split == "query":
        off = data[key][4]
        lo, hi = query_row_range(off, rank, world)
        return Dataset.from_binned(Xb[lo:hi], mapper, y[lo:hi],
                                   group=rank_queries(off, lo, hi))
    lo, hi = host_row_range(Xb.shape[0], rank, world)
    return Dataset.from_binned(Xb[lo:hi], mapper, y[lo:hi])


def run_mode(name: str, data: dict, rank: int = 0, world: int = 1,
             group: bool = True, device: str = "cpu") -> dict:
    """Train one ``MODE_CONFIGS`` config on this rank's rows (all rows
    without a group); with a group also the run's collective stats."""
    import torch

    import dryad_tpu_torch as dt
    from dryad_tpu_torch.distributed import train_distributed
    from dryad_tpu_torch.engine.distributed import RowGroup

    ds = mode_dataset(name, data, rank=rank, world=world if group else 1)
    p = MODE_CONFIGS[name][1]
    if not group:
        return _tree_out(dt.train(p, ds, device=device))
    g = RowGroup.build(ds.num_rows, device=torch.device(device))
    out = _tree_out(train_distributed(p, ds, group=g, device=device))
    out["stats"] = g.stats
    return out


def run_comm(name: str, data: dict, rank: int, world: int) -> dict:
    """One ``CONFIGS`` config on this rank's rows through an explicit
    group: its collective stats, the booster's ``comm_stats``, the
    iterations grown and the ``dryad_comm_*`` gauges it exported."""
    import torch

    from dryad_tpu_torch import Dataset
    from dryad_tpu_torch.distributed import train_distributed
    from dryad_tpu_torch.engine.distributed import RowGroup
    from dryad_tpu_torch.obs.registry import default_registry

    key, params, split = CONFIGS[name]
    Xb, y, w, mapper = data[key]
    lo, hi = split_rows(Xb.shape[0], rank, world, split)
    ds = Dataset.from_binned(Xb[lo:hi], mapper, y[lo:hi],
                             weight=None if w is None else w[lo:hi])
    g = RowGroup.build(ds.num_rows, device=torch.device("cpu"))
    b = train_distributed(dict(BASE, **params), ds, group=g, device="cpu")
    gauges = {k: v for k, v in default_registry().snapshot()["gauges"]
              .items() if k.startswith("dryad_comm_")}
    return {"stats": g.stats, "comm": b.comm_stats,
            "iterations": b.num_iterations, "gauges": gauges}


def run_mismatch(data: dict, rank: int, world: int) -> str:
    """The error of a group whose last rank sketched its own mapper."""
    from dryad_tpu_torch import Dataset
    from dryad_tpu_torch.distributed import host_row_range, train_distributed

    Xb, y, _, mapper = data["num"]
    lo, hi = host_row_range(Xb.shape[0], rank, world)
    if rank == world - 1:
        X = data["num_raw"][lo:hi]
        ds = Dataset(X, y[lo:hi], max_bins=BINS)
    else:
        ds = Dataset.from_binned(Xb[lo:hi], mapper, y[lo:hi])
    try:
        train_distributed(dict(BASE, growth="depthwise", max_depth=3), ds,
                          device="cpu")
    except ValueError as e:
        return f"ValueError: {e}"
    return "trained"


def make_data(seed: int = 3, card: bool = False) -> dict:
    """The binned matrices of the configs' datasets, made on the host from
    a seed: ``num`` has missing values only in its last rows (held by the
    last rank), ``cat`` a categorical feature 0, ``ref`` is the
    reference's fixture; with ``card``, only the card test's Higgs
    rows."""
    from dryad_tpu_torch import Dataset
    from dryad_tpu_torch.datasets import higgs_like

    if card:
        X, y = higgs_like(CARD_ROWS, seed=seed)
        ds = Dataset(X, y, max_bins=256)
        return {"card": (ds.X_binned, y, None, ds.mapper)}

    X, y = higgs_like(ROWS + 1000, num_features=8, seed=seed)
    rng = np.random.default_rng(seed)
    X = X.astype(np.float32)
    Xn = X.copy()
    miss = rng.random(X.shape) < 0.05
    miss[:ROWS - 600] = False
    Xn[miss] = np.nan
    ds = Dataset(Xn[:ROWS], y[:ROWS], max_bins=BINS)
    Xc = X.copy()
    Xc[:, 0] = rng.integers(0, 10, X.shape[0])
    y_c = (y + (Xc[:, 0] % 3 == 0)).clip(0, 1).astype(np.float32)
    dsc = Dataset(Xc[:ROWS], y_c[:ROWS], max_bins=BINS,
                  categorical_features=(0,))
    Xr, yr = higgs_like(REF_ROWS)
    dsr = Dataset(Xr, yr, max_bins=REF_PARAMS["max_bins"])
    q = np.quantile(X[:, 1], [1 / 3, 2 / 3])
    y3 = np.digitize(X[:, 1] + 0.5 * X[:, 2], q).astype(np.float32)
    w = rng.uniform(0.2, 3.0, ROWS).astype(np.float32)
    return {
        "num": (ds.X_binned, y[:ROWS], None, ds.mapper),
        "weighted": (ds.X_binned, y[:ROWS], w, ds.mapper),
        "cat": (dsc.X_binned, y_c[:ROWS], None, dsc.mapper),
        "ref": (dsr.X_binned, yr, None, dsr.mapper),
        "multi": (ds.X_binned, y3[:ROWS], None, ds.mapper),
        "valid": ds.bind(Xn[ROWS:], y[ROWS:]),
        "num_raw": Xn[:ROWS],
    }


def split_rows(n: int, rank: int, world: int, split) -> tuple[int, int]:
    from dryad_tpu_torch.distributed import host_row_range

    if split is None:
        return host_row_range(n, rank, world)
    empty = int(split[-1])
    if rank == empty:
        return 0, 0
    r = rank - (rank > empty)
    return host_row_range(n, r, world - 1)


def _tree_out(b) -> dict:
    out = {k: np.asarray(v) for k, v in b.tree_arrays().items()}
    out["init_score"] = np.asarray(b.init_score)
    out["best_iteration"] = b.best_iteration
    out["eval_history"] = b.train_state.get("eval_history")
    return out


def run_config(name: str, data: dict, rank: int = 0, world: int = 1,
               group: bool = True, ckpt_dir: str | None = None,
               device: str = "cpu") -> dict:
    """Train one config (``CONFIGS``, ``CARD_CONFIGS``, or
    "resume"/"resume_straight") on this rank's rows (all rows without a
    group) on ``device``."""
    import dryad_tpu_torch as dt
    from dryad_tpu_torch import Dataset
    from dryad_tpu_torch.distributed import train_distributed

    if name.startswith("resume"):
        key, params, split = RESUME[0], RESUME[1], None
    else:
        key, params, split = {**CONFIGS, **CARD_CONFIGS,
                              **CARD_MODE_CONFIGS}[name]
    Xb, y, w, mapper = data[key]
    lo, hi = ((0, Xb.shape[0]) if not group
              else split_rows(Xb.shape[0], rank, world, split))
    ds = Dataset.from_binned(Xb[lo:hi], mapper, y[lo:hi],
                             weight=None if w is None else w[lo:hi])
    p = dict(BASE, **params)
    kw = {}
    if name.startswith("valid"):
        kw["valid_sets"] = [data["valid"]]
    if name == "resume":
        kw = {"checkpoint_dir": ckpt_dir, "checkpoint_every": RESUME_EVERY}

    def fit(**extra):
        if group:
            valid = extra.pop("valid_sets", None)
            return train_distributed(p, ds, valid, device=device, **extra)
        return dt.train(p, ds, device=device, **extra)

    gate = NAT_GATE_ROWS.get(name) if group else None
    if gate is not None:
        from dryad_tpu_torch.engine import hist_nat

        old = hist_nat.NAT_GATE_MB
        hist_nat.NAT_GATE_MB = (gate(world) * Xb.shape[1] * Xb.itemsize
                                / (1 << 20))
        try:
            return _tree_out(fit(**kw))
        finally:
            hist_nat.NAT_GATE_MB = old

    if name == "resume":
        def crash(it, info):
            if it + 1 == RESUME_CRASH:
                raise KeyboardInterrupt("crash")
        try:
            fit(callbacks=[crash], **kw)
            raise AssertionError("the crash did not happen")
        except KeyboardInterrupt:
            pass
        return _tree_out(fit(resume=True, **kw))
    return _tree_out(fit(**kw))


# tests/test_torch_resilience.py's group: every rank under its own
# supervisor with the same injection points (a dispatch fault, then a
# fetch death at a checkpoint), against one process's straight run
SUPERVISED = {"growth": "depthwise", "max_depth": 4, "num_leaves": 15,
              "num_trees": 6}
SUPERVISED_POINTS = ((3, "device_unavailable", "dispatch"),
                     (4, "fetch_death", "fetch"))
SUPERVISED_EVERY = 2


def run_supervised(data: dict, rank: int = 0, world: int = 1,
                   group: bool = True, ckpt_dir: str | None = None,
                   journal: str | None = None) -> dict:
    """``SUPERVISED`` on this rank's rows under ``supervise_train`` (one
    process: the straight run on all the rows)."""
    import torch

    import dryad_tpu_torch as dt
    from dryad_tpu_torch import Dataset
    from dryad_tpu_torch.engine.distributed import RowGroup
    from dryad_tpu_torch.resilience import (FaultInjector, RetryPolicy,
                                            supervise_train)

    Xb, y, _, mapper = data["num"]
    p = dict(BASE, **SUPERVISED)
    if not group:
        return _tree_out(dt.train(p, Dataset.from_binned(Xb, mapper, y),
                                  device="cpu"))
    lo, hi = split_rows(Xb.shape[0], rank, world, None)
    ds = Dataset.from_binned(Xb[lo:hi], mapper, y[lo:hi])
    cpu = torch.device("cpu")
    injector = FaultInjector(SUPERVISED_POINTS)
    b = supervise_train(p, ds, device=cpu,
                        group=RowGroup.build(ds.num_rows, device=cpu),
                        checkpoint_dir=ckpt_dir,
                        checkpoint_every=SUPERVISED_EVERY, journal=journal,
                        fault_injector=injector,
                        policy=RetryPolicy(backoff_base_s=0.0))
    if injector.pending:
        raise AssertionError(f"rank {rank}: {injector.pending} points "
                             "never fired")
    return _tree_out(b)


def run_refused(name: str, data: dict, rank: int, world: int,
                tmp: str) -> str:
    """The error a refused set raises under a group."""
    from dryad_tpu_torch import Dataset
    from dryad_tpu_torch.data.stream_dataset import StreamedDataset
    from dryad_tpu_torch.distributed import host_row_range, train_distributed

    Xb, y, _, mapper = data["num"]
    lo, hi = host_row_range(Xb.shape[0], rank, world)
    p = dict(BASE, growth="depthwise", max_depth=3, **REFUSED[name])
    ds = StreamedDataset.from_dataset(
        Dataset.from_binned(Xb[lo:hi], mapper, y[lo:hi]),
        f"{tmp}.{rank}.bins", chunk_rows=512)
    try:
        train_distributed(p, ds, device="cpu")
    except ValueError as e:
        return f"ValueError: {e}"
    return "trained"


def main(spec_path: str, rank: int) -> None:
    import torch

    from dryad_tpu_torch.distributed import initialize

    torch.set_num_threads(1)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    world = spec["world"]
    initialize(backend="gloo", init_method="file://" + spec["store"],
               rank=rank, world_size=world, timeout_s=spec["timeout_s"])
    device = spec.get("device", "cpu")
    out = {}
    try:
        if spec.get("comm"):
            data = make_data()
            for name in spec["comm"]:
                out[name] = run_comm(name, data, rank, world)
        elif spec.get("supervise"):
            out["supervised"] = run_supervised(
                make_data(), rank, world, ckpt_dir=spec["ckpt_dir"],
                journal=f"{spec_path}.{rank}.journal")
        elif spec.get("modes"):
            data = make_mode_data()
            for name in spec["modes"]:
                out[name] = run_mode(name, data, rank, world, device=device)
            out["mismatch"] = run_mismatch(make_data(), rank, world)
        else:
            data = make_data(card=device != "cpu")
            for name in spec["configs"]:
                out[name] = run_config(name, data, rank, world,
                                       ckpt_dir=spec.get("ckpt_dir"),
                                       device=device)
            for name in spec.get("refused", ()):
                out["refused:" + name] = run_refused(name, data, rank,
                                                     world, spec["store"])
    except BaseException:                         # noqa: BLE001
        out["error"] = traceback.format_exc()
    with open(f"{spec_path}.{rank}.out", "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
