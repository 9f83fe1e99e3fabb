"""The op census: what each audited arm really dispatches, counted.

The counterpart of ``dryad_tpu/analysis/jaxpr_audit.py``.  The reference
traces abstract programs and walks their jaxprs; the port has no traced
program, so each arm runs once, for real, at a small size, under a
``TorchDispatchMode`` that sees every aten and c10d op the arm dispatches
on its thread.  A training arm is one boosting iteration of
``engine/train.train_device``: the window opens at the loop's
``chunk_hook("dispatch", 0)`` and closes at its final
``chunk_hook("fetch", ...)``, so set-up and the final fetch stay out.  A
predict arm is one call.  The census counts:

* **kernel events**: each kernel wrapper's work runs inside
  ``cuda_build.boundary`` (K1's ``hist_tiles`` and ``hist_rows``, K3's
  ``hist_nat``, K2's ``permute_records``); the census records one event
  there, with its inputs' dtypes and shapes, and counts none of the ops
  inside, on either device, so the plain versions' ops on the CPU never
  pass for the arm's.  Collectives are the exception: a wrapper's
  ``reduce`` hook runs the cross-rank sum inside it, and every collective
  is counted wherever it runs;
* **row-scale and slot-scale sorts** (``sort``, ``argsort``, ``topk``,
  ``kthvalue``, sorted ``unique``), split by the arm's row threshold on
  the sorted input's size, as the reference splits them;
* **row and table gathers** (``index``, ``gather``, ``index_select``,
  ``take``): by the size of the tensor read from;
* **collectives** (every ``c10d`` op), held against the group's own
  accounting (``RowGroup.stats`` calls in the window) and the iteration's
  plan (``train.comm_stats``);
* **host syncs**, on the card only: each warning of
  ``torch.cuda.set_sync_debug_mode("warn")`` in the window is one.  On a
  CPU tensor ``.cpu()`` and ``.tolist()`` dispatch nothing, so a CPU count
  would not be whole.

Each arm's op stream (op names, dtypes, ranks; kernel events by name) has
a canonical digest (``digests.py``), pinned with the counts in
``goldens/census.json``.  The group arms run at world 2 in one pair of
spawned interpreters (a ``file://`` store, a group timeout).

Modes are per thread: an arm runs no streamed set and starts no thread
that dispatches inside its window.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import warnings
from collections import Counter
from dataclasses import dataclass, field
from typing import Optional

from dryad_tpu_torch.analysis.digests import (
    GOLDENS_PATH,
    canonical_digest,
    load_goldens,
    save_goldens,
)

SORT_OPS = frozenset({"sort", "argsort", "msort", "topk", "kthvalue",
                      "_unique", "_unique2", "unique_dim"})
GATHER_OPS = frozenset({"index", "gather", "index_select", "take",
                        "take_along_dim"})
#: the only collectives a training iteration may issue
COLLECTIVES = frozenset({"allreduce_", "reduce_scatter_", "allgather_"})
#: the sync debug mode's warning at one host sync (its one-time notice
#: that the mode is a prototype is not a sync)
SYNC_WARNING = "called a synchronizing CUDA operation"
WORLD = 2
# the small arms' data: rows, features, bins, seed
N_ROWS, N_FEATURES, N_BINS, SEED = 4096, 8, 32, 7
GROUP_TIMEOUT_S = 240.0


# ---------------------------------------------------------------------------
# the census itself


@dataclass
class Census:
    """What one window dispatched (module doc)."""

    row_threshold: int
    stream: list = field(default_factory=list)
    collectives: Counter = field(default_factory=Counter)
    row_sorts: int = 0
    slot_sorts: int = 0
    row_gathers: int = 0
    table_gathers: int = 0
    kernels: Counter = field(default_factory=Counter)
    kernel_sigs: dict = field(default_factory=dict)   # name -> set of sigs
    syncs: Optional[int] = None                        # on the card only
    group_calls: dict = field(default_factory=dict)    # stats purpose -> n

    @property
    def digest(self) -> str:
        return canonical_digest(self.stream)

    def payload(self) -> dict:
        return {
            "digest": self.digest,
            "collectives": dict(sorted(self.collectives.items())),
            "row_sorts": self.row_sorts,
            "slot_sorts": self.slot_sorts,
            "row_gathers": self.row_gathers,
            "table_gathers": self.table_gathers,
            "kernels": dict(sorted(self.kernels.items())),
            "kernel_sigs": {k: sorted(v) for k, v in
                            sorted(self.kernel_sigs.items())},
        }


def _sig(t) -> str:
    return f"{t.dtype}".replace("torch.", "") + str(tuple(t.shape))


class _Recorder:
    """The dispatch mode's state and the kernel hook of one census run:
    ``open()`` starts counting on this thread, ``close()`` stops."""

    def __init__(self, census: Census, device):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode

        self.census = census
        self.cuda = torch.device(device).type == "cuda"
        self.tid = threading.get_ident()
        self.hidden = 0
        self.is_open = False
        self._warn_ctx = None
        self._warned: list = []
        self._group = None
        self._calls0: dict = {}
        rec = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if threading.get_ident() == rec.tid:
                    rec.note(func, args, kwargs)
                return func(*args, **kwargs)

        self._mode = _Mode()

    # ---- the op hook -------------------------------------------------------
    def note(self, func, args, kwargs) -> None:
        import torch
        from torch.utils._pytree import tree_leaves

        c = self.census
        ns = func.namespace
        base = func._schema.name.split("::", 1)[-1]
        if ns == "c10d":
            c.collectives[base] += 1
        elif self.hidden:
            return
        tensors = [a for a in tree_leaves((args, kwargs))
                   if isinstance(a, torch.Tensor)]
        c.stream.append(f"{func}(" + ",".join(
            f"{str(t.dtype)[6:]}:{t.dim()}" for t in tensors) + ")")
        if ns != "aten" or not tensors:
            return
        size = tensors[0].numel()
        if base in SORT_OPS:
            if base in ("_unique", "_unique2") and not _sorted_unique(
                    func, args, kwargs):
                return
            if size >= c.row_threshold:
                c.row_sorts += 1
            else:
                c.slot_sorts += 1
        elif base in GATHER_OPS:
            if size >= c.row_threshold:
                c.row_gathers += 1
            else:
                c.table_gathers += 1

    # ---- the kernel hook (``cuda_build.boundary``) --------------------------
    def boundary(self, name: str, inputs):
        import contextlib

        if not self.is_open or threading.get_ident() != self.tid:
            return contextlib.nullcontext()
        c = self.census
        c.kernels[name] += 1
        c.kernel_sigs.setdefault(name, set()).add(
            "(" + ",".join(_sig(t) for t in inputs) + ")")
        c.stream.append(f"kernel:{name}")
        return self._hide()

    def _hide(self):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            self.hidden += 1
            try:
                yield
            finally:
                self.hidden -= 1
        return ctx()

    # ---- the window --------------------------------------------------------
    def open(self, group=None) -> None:
        import torch

        from dryad_tpu_torch.engine import cuda_build

        if self.is_open:
            return
        self._group = group
        if group is not None:
            self._calls0 = {w: st["calls"] for w, st in group.stats.items()}
        if self.cuda:
            torch.cuda.synchronize()
            self._warn_ctx = warnings.catch_warnings(record=True)
            self._warned = self._warn_ctx.__enter__()
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
        cuda_build.census_hook = self.boundary
        self.is_open = True
        self._mode.__enter__()

    def close(self) -> None:
        import torch

        from dryad_tpu_torch.engine import cuda_build

        if not self.is_open:
            return
        self._mode.__exit__(None, None, None)
        self.is_open = False
        cuda_build.census_hook = None
        c = self.census
        if self.cuda:
            torch.cuda.set_sync_debug_mode(0)
            c.syncs = sum(SYNC_WARNING in str(w.message)
                          for w in self._warned)
            self._warn_ctx.__exit__(None, None, None)
            self._warn_ctx = None
        if self._group is not None:
            c.group_calls = {
                w: st["calls"] - self._calls0.get(w, 0)
                for w, st in self._group.stats.items()
                if st["calls"] - self._calls0.get(w, 0)}


def _sorted_unique(func, args, kwargs) -> bool:
    """``_unique``/``_unique2`` take ``sorted`` as their second argument
    (default True)."""
    if "sorted" in kwargs:
        return bool(kwargs["sorted"])
    return bool(args[1]) if len(args) > 1 else True


def _quiet_registry():
    """The process registry off for a census (a disabled registry makes
    ``introspect.capture`` a plain call, as the schedule drills keep it
    out); returns the restore function."""
    from dryad_tpu_torch.obs.registry import default_registry

    reg = default_registry()
    was = reg.enabled
    reg.disable()
    return (lambda: reg.enable()) if was else (lambda: None)


def census_call(fn, *args, on, row_threshold: int, **kwargs):
    """(fn(*args, **kwargs), Census) of one call counted whole, on the
    device ``on``."""
    cen = Census(row_threshold=int(row_threshold))
    rec = _Recorder(cen, on)
    restore = _quiet_registry()
    try:
        rec.open()
        out = fn(*args, **kwargs)
    finally:
        rec.close()
        restore()
    return out, cen


def census_train(params, data, *, device, group=None,
                 row_threshold: Optional[int] = None):
    """(booster, Census) of one boosting iteration of ``train_device``
    (module doc).  ``row_threshold`` defaults to half this rank's rows."""
    import torch

    from dryad_tpu_torch.config import make_params
    from dryad_tpu_torch.engine.train import train_device

    p = make_params(params).replace(num_trees=1)
    thr = (max(2, data.num_rows // 2) if row_threshold is None
           else int(row_threshold))
    cen = Census(row_threshold=thr)
    rec = _Recorder(cen, device)

    def hook(site: str, it: int) -> None:
        if site == "dispatch" and it == 0:
            rec.open(group)
        elif site == "fetch":
            rec.close()

    restore = _quiet_registry()
    try:
        booster = train_device(p, data, device=torch.device(device),
                               group=group, chunk_hook=hook)
    finally:
        rec.close()
        restore()
    return booster, cen


# ---------------------------------------------------------------------------
# arms


def _dataset(n: int = N_ROWS, rows=None):
    from dryad_tpu_torch.dataset import Dataset
    from dryad_tpu_torch.datasets import higgs_like

    X, y = higgs_like(n, num_features=N_FEATURES, seed=SEED)
    full = Dataset(X, y, max_bins=N_BINS)
    if rows is None:
        return full
    lo, hi = rows
    return Dataset(X[lo:hi], y[lo:hi], mapper=full.mapper)


_BASE = {"objective": "binary", "max_bins": N_BINS, "learning_rate": 0.3}
_WIRED = dict(_BASE, growth="depthwise", max_depth=6, num_leaves=63)

#: name -> (doc, params, kind, expectations); kind "train", "group" (world
#: 2, spawned) or "predict"
ARMS: dict = {
    "levelwise_wired": (
        "the headline grower: depthwise on the wired layout",
        _WIRED, "train",
        {"row_sorts": 0, "wired_levels": 6}),
    "leafwise_wired": (
        "batched leaf-wise expansion on the wired layout",
        dict(_BASE, growth="leafwise", max_depth=5, num_leaves=31),
        "train", {"row_sorts": 0, "wired": True}),
    "levelwise_legacy": (
        "the legacy plan arm: K3 on the narrow levels, a sorted tile plan "
        "and K1 row mode on the rest",
        dict(_BASE, growth="depthwise", max_depth=7, num_leaves=127,
             deep_layout="legacy"),
        "train", {"legacy": True}),
    "goss_iteration": (
        "a GOSS iteration: one row-scale sort (the threshold)",
        dict(_WIRED, boosting="goss", goss_top_rate=0.3,
             goss_other_rate=0.2),
        "train", {"row_sorts": 1, "wired_levels": 6}),
    "renewal_iteration": (
        "L1 leaf renewal: one row-scale stable sort a tree",
        dict(_BASE, objective="l1", growth="leafwise", max_depth=4,
             num_leaves=15),
        "train", {"row_sorts": 1, "stable_sorts": 1}),
    "group_fused": (
        "the wired grower over a world-2 group, fused all-reduce",
        _WIRED, "group", {"row_sorts": 0, "wired_levels": 6}),
    "group_feature": (
        "the feature arm over a world-2 group: root all-reduce, a "
        "reduce-scatter and a split all-gather a level",
        dict(_WIRED, hist_reduce="feature"), "group",
        {"row_sorts": 0, "wired_levels": 6}),
    "group_leafwise_feature": (
        "the leaf-wise grower's feature arm over a world-2 group: its own "
        "plan's reduce-scatters and split all-gathers",
        dict(_BASE, growth="leafwise", max_depth=5, num_leaves=31,
             hist_reduce="feature"), "group",
        {"row_sorts": 0, "wired": True}),
    "group_goss": (
        "GOSS over a world-2 group: the radix select's four all-reduces "
        "and the top count's one replace the sort",
        dict(_WIRED, boosting="goss", goss_top_rate=0.3,
             goss_other_rate=0.2), "group",
        {"row_sorts": 0, "goss_calls": 5, "wired_levels": 6}),
    "group_renewal": (
        "L1 renewal over a world-2 group: the gathered residuals' sort",
        dict(_BASE, objective="l1", growth="leafwise", max_depth=4,
             num_leaves=15), "group",
        {"row_sorts": 1, "renew_calls": 2}),
    "sharded_predict": (
        "predict_binned_sharded over two devices, structure-of-arrays "
        "traversal: no collective",
        None, "predict", {"collective_free": True, "row_sorts": 0}),
    "packed_predict": (
        "packed node-word predict: table gathers per tree level",
        None, "predict", {"collective_free": True, "row_sorts": 0,
                          "table_gathers_per_level": 1}),
}
# the predict arms' model and rows
_PREDICT_TREES, _PREDICT_DEPTH, _PREDICT_ROWS = 3, 6, 2048


@dataclass
class ArmReport:
    name: str
    census: Census
    failures: list = field(default_factory=list)
    comm: Optional[dict] = None

    @property
    def ok(self) -> bool:
        return not self.failures


def _check(name: str, cen: Census, expect: dict, comm=None) -> list:
    """The arm's invariants; a list of failure strings."""
    bad = []
    k = cen.kernels
    if "row_sorts" in expect and cen.row_sorts != expect["row_sorts"]:
        bad.append(f"row-scale sorts {cen.row_sorts} != expected "
                   f"{expect['row_sorts']} (threshold {cen.row_threshold} "
                   "rows): only GOSS (one an iteration, in one process) and "
                   "the L1 renewal (one a tree) may sort rows")
    if "stable_sorts" in expect:
        n = sum(1 for e in cen.stream if e.startswith("aten.sort.stable"))
        if n != expect["stable_sorts"]:
            bad.append(f"stable sorts {n} != {expect['stable_sorts']}")
    levels = expect.get("wired_levels")
    if levels is not None or expect.get("wired"):
        n1, n2 = k.get("hist_tiles", 0), k.get("permute_records", 0)
        if levels is not None and (n1, n2) != (levels + 1, levels):
            bad.append(f"wired kernels K1={n1} K2={n2}: a depth-{levels} "
                       f"tree launches K1 {levels + 1} times (the root and "
                       f"each level) and K2 {levels} times")
        if n2 < 1 or n1 != n2 + 1:
            bad.append(f"wired kernels K1={n1} K2={n2}: one K1 per level "
                       "plus the root, one K2 per level")
        if k.get("hist_rows") or k.get("hist_nat"):
            bad.append(f"the wired arm ran the plan arm's kernels: {dict(k)}")
        for kname in ("hist_tiles", "permute_records"):
            for sig in cen.kernel_sigs.get(kname, ()):
                if not (sig.startswith("(uint8(") and ", 128)," in sig):
                    bad.append(f"{kname} records are not uint8 x 128 "
                               f"bytes: {sig}")
    if expect.get("legacy"):
        if not (k.get("hist_rows") and k.get("hist_nat")
                and cen.row_sorts > 0):
            bad.append(f"the legacy arm must keep its plan sorts "
                       f"({cen.row_sorts}), K1 row mode and K3 ({dict(k)})")
        if k.get("hist_tiles") or k.get("permute_records"):
            bad.append(f"the legacy arm ran the wired kernels: {dict(k)}")
    coll = cen.collectives
    if expect.get("collective_free") and coll:
        bad.append(f"collectives {dict(coll)} in a collective-free arm")
    others = set(coll) - COLLECTIVES
    if others:
        bad.append(f"undocumented collectives {sorted(others)}: the "
                   "histogram reductions and the documented GOSS, shift "
                   "and renewal collectives are the only ones")
    if comm is not None:
        total = sum(coll.values())
        calls = sum(cen.group_calls.values())
        if total != calls:
            bad.append(f"c10d ops {total} != RowGroup.stats calls {calls} "
                       f"({cen.group_calls}): a collective bypassed the "
                       "group's accounting")
        hist = (cen.group_calls.get("hist", 0)
                + cen.group_calls.get("splits", 0))
        if hist != comm["collective_calls_per_iter"]:
            bad.append(f"histogram collectives {hist} != comm_stats "
                       f"{comm['collective_calls_per_iter']} ({comm})")
        if coll.get("reduce_scatter_", 0) != \
                comm["reduce_scatter_calls_per_iter"]:
            bad.append(f"reduce-scatters {coll.get('reduce_scatter_', 0)} "
                       f"!= comm_stats "
                       f"{comm['reduce_scatter_calls_per_iter']}")
        for what in ("goss", "renew"):
            want = expect.get(f"{what}_calls")
            if want is not None and cen.group_calls.get(what, 0) != want:
                bad.append(f"{what} collectives "
                           f"{cen.group_calls.get(what, 0)} != {want}")
    per_level = expect.get("table_gathers_per_level")
    if per_level is not None:
        # each tree: its node words once a level, its leaf values once
        want = _PREDICT_TREES * (_PREDICT_DEPTH * per_level + 1)
        if cen.table_gathers != want:
            bad.append(f"table gathers {cen.table_gathers} != {want} "
                       f"({per_level} a tree level and one value lookup "
                       "a tree): the traversal's per-level lookups drifted")
    return bad


def _predict_model(device, layout: str):
    """The predict arms' model, its traversal layout fixed: "auto" would
    resolve the policy gate, whose entry for the host's card may prefer
    the other layout on either device."""
    import dryad_tpu_torch as dt

    ds = _dataset()
    p = dict(_BASE, growth="depthwise", max_depth=_PREDICT_DEPTH,
             num_leaves=63, num_trees=_PREDICT_TREES, predict_layout=layout)
    return dt.train(p, ds, device=device), ds


def run_arm(name: str, device="cpu") -> ArmReport:
    """One single-process arm (a "train" or "predict" arm)."""
    import torch

    from dryad_tpu_torch.engine import predict as pr

    _doc, params, kind, expect = ARMS[name]
    if kind == "train":
        _, cen = census_train(params, _dataset(), device=device)
    elif kind == "predict":
        booster, ds = _predict_model(
            device, "legacy" if name == "sharded_predict" else "packed")
        Xb = ds.X_binned[:_PREDICT_ROWS]
        thr = _PREDICT_ROWS // 2
        if name == "sharded_predict":
            devs = [torch.device(device)] * WORLD
            _, cen = census_call(pr.predict_binned_sharded, booster, Xb,
                                 devices=devs, on=device,
                                 row_threshold=thr)
        else:
            _, cen = census_call(pr.predict_binned, booster, Xb,
                                 device=torch.device(device), on=device,
                                 row_threshold=thr)
    else:
        raise ValueError(f"{name} is a group arm: run_group_arms")
    return ArmReport(name, cen, _check(name, cen, expect))


# ---------------------------------------------------------------------------
# the group arms: one pair of spawned interpreters runs them all


def group_worker(spec_path: str, rank: int) -> None:
    """A spawned rank: join the ``file://`` group, run every group arm of
    the spec under the census on this rank's rows, write the results."""
    import datetime

    import torch
    import torch.distributed as dist

    from dryad_tpu_torch.distributed import host_row_range
    from dryad_tpu_torch.engine.distributed import RowGroup

    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    dev = torch.device(spec["device"])
    dist.init_process_group(
        "gloo", init_method="file://" + spec["store"], rank=rank,
        world_size=WORLD,
        timeout=datetime.timedelta(seconds=float(spec["timeout_s"])))
    out = {}
    try:
        for name in spec["arms"]:
            params = ARMS[name][1]
            lo, hi = host_row_range(N_ROWS, rank, WORLD)
            data = _dataset(rows=(lo, hi))
            group = RowGroup.build(data.num_rows, device=dev)
            booster, cen = census_train(params, data, device=dev,
                                        group=group,
                                        row_threshold=N_ROWS // 2)
            out[name] = {"census": cen.payload(), "stream": cen.stream,
                         "row_threshold": cen.row_threshold,
                         "group_calls": cen.group_calls,
                         "syncs": cen.syncs, "comm": booster.comm_stats}
    finally:
        dist.destroy_process_group()
    with open(f"{spec_path}.{rank}.out", "w") as f:
        json.dump(out, f)


def _census_from(d: dict) -> Census:
    p = d["census"]
    return Census(row_threshold=d["row_threshold"], stream=d["stream"],
                  collectives=Counter(p["collectives"]),
                  row_sorts=p["row_sorts"], slot_sorts=p["slot_sorts"],
                  row_gathers=p["row_gathers"],
                  table_gathers=p["table_gathers"],
                  kernels=Counter(p["kernels"]),
                  kernel_sigs={k: set(v) for k, v in
                               p["kernel_sigs"].items()},
                  syncs=d["syncs"], group_calls=d["group_calls"])


def run_group_arms(names, device="cpu") -> list:
    """ArmReports of the group arms ``names``, from rank 0 of one spawned
    world-2 pair (rank 1's counts must agree; its rows differ)."""
    names = list(names)
    if not names:
        return []
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory(prefix="dryad_census_") as tmp:
        spec = os.path.join(tmp, "spec.json")
        with open(spec, "w") as f:
            json.dump({"store": os.path.join(tmp, "store"), "arms": names,
                       "device": str(device),
                       "timeout_s": GROUP_TIMEOUT_S}, f)
        env = dict(os.environ, PYTHONPATH=root + os.pathsep
                   + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
        code = ("import sys; from dryad_tpu_torch.analysis.census import "
                "group_worker; group_worker(sys.argv[1], int(sys.argv[2]))")
        procs = [subprocess.Popen([sys.executable, "-c", code, spec, str(r)],
                                  cwd=root, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(WORLD)]
        logs = []
        for pr in procs:
            try:
                logs.append(pr.communicate(timeout=GROUP_TIMEOUT_S + 60)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise RuntimeError("census group workers timed out")
        if any(pr.returncode for pr in procs):
            raise RuntimeError("census group worker failed:\n"
                               + "\n".join(logs)[-4000:])
        res = []
        for r in range(WORLD):
            with open(f"{spec}.{r}.out") as f:
                res.append(json.load(f))
    reports = []
    for name in names:
        cen = _census_from(res[0][name])
        comm = res[0][name]["comm"]
        bad = _check(name, cen, ARMS[name][3], comm)
        other = _census_from(res[1][name])
        if (other.collectives, other.group_calls, other.kernels) != \
                (cen.collectives, cen.group_calls, cen.kernels):
            bad.append(f"rank 1 disagrees: {dict(other.collectives)} "
                       f"{other.group_calls} {dict(other.kernels)}")
        reports.append(ArmReport(name, cen, bad, comm))
    return reports


# ---------------------------------------------------------------------------
# the runner and the goldens

_COMPARED = ("digest", "collectives", "row_sorts", "slot_sorts",
             "row_gathers", "table_gathers", "kernels", "kernel_sigs")
#: what a card census must reproduce of the CPU goldens
_CARD_COMPARED = ("kernels", "row_sorts", "collectives")


@dataclass
class AuditReport:
    arms: list = field(default_factory=list)
    drift: list = field(default_factory=list)
    notes: list = field(default_factory=list)      # card digest diffs

    @property
    def ok(self) -> bool:
        return all(a.ok for a in self.arms)

    @property
    def drift_ok(self) -> bool:
        return not self.drift

    def summary(self) -> str:
        bad = [a.name for a in self.arms if not a.ok]
        s = (f"op census: {len(self.arms)} arm(s), "
             f"{sum(len(a.failures) for a in self.arms)} invariant "
             f"failure(s), {len(self.drift)} digest drift(s)")
        return s + (f" [failed: {', '.join(bad)}]" if bad else "")


def _env() -> dict:
    import torch

    return {"torch_version": torch.__version__}


def run_census(arm_names=None, goldens_path: Optional[str] = None,
               update_goldens: bool = False, device="cpu") -> AuditReport:
    """Run the arms (default: all) and hold them against the goldens; with
    ``update_goldens`` write them instead (merging a subset, refusing on
    an invariant failure).  On the card (``device="cuda"``) the counts of
    kernels, row-scale sorts and collectives are held against the CPU
    goldens, each arm's host syncs against the card section, and digest
    differences are notes, not drift.  A whole card refresh (all arms)
    also runs the headline tree (``census_headline``) and writes the card
    section's ``headline`` entry, which ``chip_smoke.py`` phase 40 holds
    its tree against."""
    names = list(arm_names or ARMS)
    unknown = set(names) - set(ARMS)
    if unknown:
        raise ValueError(f"unknown arm(s): {sorted(unknown)}")
    report = AuditReport()
    group = [n for n in names if ARMS[n][2] == "group"]
    by_name = {r.name: r for r in run_group_arms(group, device)}
    for n in names:
        report.arms.append(by_name[n] if n in by_name else run_arm(n, device))
    goldens_path = goldens_path or GOLDENS_PATH
    stored = load_goldens(goldens_path)
    cuda = str(device).startswith("cuda")
    head = None
    if update_goldens and cuda and arm_names is None:
        _, cen, bad = census_headline(device=device)
        head = ArmReport("headline", cen, bad)
        report.arms.append(head)
    if update_goldens:
        if not report.ok:
            report.drift.append(
                "refusing to write goldens: arm invariant failures above "
                "must be fixed first (a golden must pin a sound program)")
            return report
        if cuda:
            card = stored.setdefault("card", {})
            card.update(card_stamp())
            card.setdefault("arms", {}).update(
                {a.name: {"syncs": a.census.syncs} for a in report.arms
                 if a is not head})
            if head is not None:
                card["headline"] = _headline_golden(head.census)
        else:
            stored.setdefault("arms", {}).update(
                {a.name: a.census.payload() for a in report.arms})
            stored.update(_env())
        save_goldens(stored, goldens_path)
        return report
    env = _env()
    if stored and not cuda and stored.get("torch_version") != \
            env["torch_version"]:
        report.drift.append(
            f"goldens were pinned under torch {stored.get('torch_version')}"
            f", this environment runs {env['torch_version']}: re-baseline "
            "with --update-goldens (not a code regression)")
        return report
    arms = stored.get("arms", {})
    card_arms = stored.get("card", {}).get("arms", {})
    for a in report.arms:
        got = a.census.payload()
        if a.name not in arms:
            report.drift.append(f"{a.name}: no committed golden; run "
                                "--update-goldens and commit the diff")
            continue
        for key in (_CARD_COMPARED if cuda else _COMPARED):
            if arms[a.name].get(key) != got[key]:
                msg = (f"{a.name}: {key} drifted from golden "
                       f"({arms[a.name].get(key)!r} -> {got[key]!r})")
                if cuda:
                    a.failures.append(msg + " on the card")
                else:
                    report.drift.append(
                        msg + ": if intentional, re-run with "
                        "--update-goldens and commit; if not, the program "
                        "changed under you")
        if cuda:
            if arms[a.name].get("digest") != got["digest"]:
                report.notes.append(f"{a.name}: the card's op stream "
                                    "differs from the CPU golden's")
            want = card_arms.get(a.name, {}).get("syncs")
            if want is None:
                report.drift.append(f"{a.name}: no card sync golden")
            elif want != a.census.syncs:
                a.failures.append(f"host syncs {a.census.syncs} != card "
                                  f"golden {want}")
    return report


def card_stamp() -> dict:
    """The card's name and power limit (``nvidia-smi``), and torch's
    version, beside every card number of the goldens."""
    import torch

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        smi = "unknown"
    return {"card": smi, "card_torch_version": torch.__version__}


def card_headline(path: Optional[str] = None) -> Optional[dict]:
    """The card section's headline-tree counts (``chip_smoke.py`` phase
    40 holds its tree against them), or None."""
    return load_goldens(path).get("card", {}).get("headline")


# ---------------------------------------------------------------------------
# the headline tree: one tree of the headline configuration on the card

#: Higgs-10M's widths (28 features, 256 bins) at depth 8 and 255 leaves,
#: as ``chip_smoke.py``'s phases 3-6 train it
HEADLINE_PARAMS = {"objective": "binary", "growth": "depthwise",
                   "max_depth": 8, "num_leaves": 255, "max_bins": 256,
                   "learning_rate": 0.1}
#: its rows: the first HEADLINE_ROWS of ``higgs_like(HEADLINE_ROWS +
#: HEADLINE_HOLDOUT, seed=0)``, the rows ``chip_smoke.py`` trains on
HEADLINE_ROWS, HEADLINE_HOLDOUT = 10_000_000, 1_000_000
_HEADLINE_EXPECT = {"row_sorts": 0, "wired_levels": 8,
                    "collective_free": True}


def headline_dataset():
    from dryad_tpu_torch.dataset import Dataset
    from dryad_tpu_torch.datasets import higgs_like

    X, y = higgs_like(HEADLINE_ROWS + HEADLINE_HOLDOUT, seed=0)
    return Dataset(X[:HEADLINE_ROWS], y[:HEADLINE_ROWS],
                   max_bins=HEADLINE_PARAMS["max_bins"])


def census_headline(data=None, device="cuda"):
    """(booster, Census, failures) of one headline tree on ``data`` (by
    default ``headline_dataset()``): 9 K1 and 8 K2 events on uint8
    records, no row-scale sort, no collective."""
    data = headline_dataset() if data is None else data
    booster, cen = census_train(dict(HEADLINE_PARAMS, num_trees=1), data,
                                device=device)
    return booster, cen, _check("headline", cen, _HEADLINE_EXPECT)


def _headline_golden(cen: Census) -> dict:
    return {"syncs": cen.syncs, "kernels": dict(cen.kernels),
            "row_sorts": cen.row_sorts,
            "collectives": dict(cen.collectives),
            "rows": HEADLINE_ROWS, "params": dict(HEADLINE_PARAMS)}
