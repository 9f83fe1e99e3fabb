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

# the straight run a checkpointed, crashed and resumed run must equal
RESUME = ("num", {"growth": "depthwise", "max_depth": 4, "num_trees": 6})
RESUME_EVERY, RESUME_CRASH = 2, 4

# each must raise NotImplementedError under a group
REFUSED = {
    "goss": {"boosting": "goss"},
    "lambdarank": {"objective": "lambdarank"},
    "l1": {"objective": "l1"},
    "csr": {},
}


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
        "csr": (Xn[:ROWS], y[:ROWS]),
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
        key, params, split = {**CONFIGS, **CARD_CONFIGS}[name]
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


def run_refused(name: str, data: dict, rank: int, world: int) -> str:
    """The error a refused mode raises under a group."""
    from dryad_tpu_torch import Dataset
    from dryad_tpu_torch.distributed import host_row_range, train_distributed

    Xb, y, _, mapper = data["num"]
    lo, hi = host_row_range(Xb.shape[0], rank, world)
    p = dict(BASE, growth="depthwise", max_depth=3, **REFUSED[name])
    if name == "lambdarank":
        ds = Dataset.from_binned(Xb[lo:hi], mapper, y[lo:hi],
                                 group=[hi - lo])
    elif name == "csr":
        import scipy.sparse as sp

        Xr, yr = data["csr"]
        m = sp.csr_matrix(np.nan_to_num(Xr[lo:hi]))
        ds = Dataset(None, yr[lo:hi], max_bins=BINS,
                     csr=(m.indptr, m.indices, m.data, Xr.shape[1]))
    else:
        ds = Dataset.from_binned(Xb[lo:hi], mapper, y[lo:hi])
    try:
        train_distributed(p, ds, device="cpu")
    except NotImplementedError as e:
        return f"NotImplementedError: {e}"
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
    data = make_data(card=device != "cpu")
    out = {}
    try:
        for name in spec["configs"]:
            out[name] = run_config(name, data, rank, world,
                                   ckpt_dir=spec.get("ckpt_dir"),
                                   device=device)
        for name in spec.get("refused", ()):
            out["refused:" + name] = run_refused(name, data, rank, world)
    except BaseException:                         # noqa: BLE001
        out["error"] = traceback.format_exc()
    with open(f"{spec_path}.{rank}.out", "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
