#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--rows N] [--trees T] [--seed S]

Phases (any failed check exits non-zero):

1. the card's name and power limit; build the CUDA kernels from
   ``dryad_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel);
2. Higgs-shaped data, ``rows`` training rows + 1M held-out rows, from the
   seed; one capture tree records each kernel's inputs at main-path shapes;
3. K1 (histograms) on the card vs its plain version at the root and at the
   widest level (P=128): counts exact, g/h within rtol 1e-5 / atol 1e-4,
   two launches bitwise equal; K2 (row move) at a depth-4 level, bitwise;
   each with its time, the plain version's, one library call's and the
   bound;
4. training on the headline config (28 features, 256 bins, depthwise,
   max_depth 8, 255 leaves, learning rate 0.1) with the launch counts set
   to 0 just before: 9 K1 and 8 K2 launches per tree; a second run gives
   bitwise-equal trees;
5. predict of the held-out rows on the card, bitwise equal to the port's
   own CPU predict; AUC above 0.70 and rising from tree 1 to the last;
6. one tree under torch.profiler: device time by kernel and the device's
   busy share of the tree's wall time.

It prints, on lines of their own, a ``kernels`` JSON object, the card's
``name, power limit`` as nvidia-smi gives them and, last,
``{"ok": true, "device": {...}}``.  Full figures also go to
``chiprun_out/chip_smoke.json``.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
HEADLINE_ROWS = 10_000_000
HOLDOUT_ROWS = 1_000_000


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call: CUDA events around ``reps`` calls
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def capture_inputs(dt, params, ds, dev):
    """Train one tree with the kernel wrappers wrapped, keeping the inputs
    of the root histogram, the last (widest) level's histogram and the
    depth-4 row move."""
    from dryad_tpu_torch.engine import hist, leafperm

    calls = {"hist": [], "perm": []}
    real_hist, real_perm = hist.hist_tiles, leafperm.permute_records

    def hist_rec(*a, **k):
        calls["hist"].append(a)
        return real_hist(*a, **k)

    def perm_rec(*a, **k):
        calls["perm"].append(a)
        return real_perm(*a, **k)

    hist.hist_tiles, leafperm.permute_records = hist_rec, perm_rec
    try:
        dt.train(dict(params, num_trees=1), ds, device=dev)
    finally:
        hist.hist_tiles, leafperm.permute_records = real_hist, real_perm
    check(len(calls["hist"]) == params["max_depth"] + 1,
          f"capture tree made {len(calls['hist'])} histogram calls")
    check(len(calls["perm"]) == params["max_depth"],
          f"capture tree made {len(calls['perm'])} row moves")
    return calls["hist"][0], calls["hist"][-1], calls["perm"][4]


def check_hist(args, name: str, reps: int) -> dict:
    """K1 on the card vs its plain version on the captured inputs."""
    import torch

    from dryad_tpu_torch.engine import hist

    rec, src, tile_leaf, P, B, F, isz = args
    k1 = hist.hist_tiles(*args)
    k2 = hist.hist_tiles(*args)
    torch.cuda.synchronize()
    check(torch.equal(k1, k2), f"{name}: two launches differ")
    plain = hist.hist_tiles_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(k1[:, 2], plain[:, 2]), f"{name}: counts differ")
    err = (k1 - plain).abs()
    tol = 1e-4 + 1e-5 * plain.abs()
    check(bool((err <= tol).all()),
          f"{name}: g/h beyond rtol 1e-5 atol 1e-4 "
          f"(max abs err {float(err.max())})")
    ms = time_ms(lambda: hist.hist_tiles(*args), reps)
    plain_ms = time_ms(lambda: hist.hist_tiles_plain(*args), 2)
    # library yardstick: one index_add_ of the (g, h, 1) rows into flat
    # (leaf, feature, bin) cells, on precomputed cells (not used by the port)
    T, WB = hist.TILE_ROWS, hist.REC_WB
    n_in = rec.shape[0] // T
    live = src >= 0
    tiles = rec.view(n_in, T, WB)[src.clamp(0, n_in - 1)]
    g, h, valid, bins = hist.unpack_rows(tiles, F, isz)
    valid = valid & live[:, None]
    w = valid.float()
    vals = torch.stack([g * w, h * w, w], -1)[:, :, None, :].expand(
        -1, -1, F, -1).reshape(-1, 3).contiguous()
    cell = ((tile_leaf.long()[:, None, None] * F
             + torch.arange(F, device=rec.device)) * B + bins)
    cell = torch.where(valid[..., None], cell, P * F * B).reshape(-1)
    acc = torch.zeros((P * F * B + 1, 3), device=rec.device)
    library_ms = time_ms(lambda: acc.index_add_(0, cell, vals), 3)
    live_tiles = int(live.sum())
    used = 9 + F * isz
    nbytes = (live_tiles * T * used + src.numel() * 8
              + P * 3 * F * B * 4)
    ops = 3.0 * int(valid.sum()) * F
    b_ms, b_by = bound_ms(nbytes, ops)
    del tiles, vals, cell, acc
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": float(err.max()), "P": P,
            "live_tiles": live_tiles, "bytes": nbytes}


def check_perm(args, reps: int) -> dict:
    """K2 on the card vs its plain version on the captured inputs."""
    import torch

    from dryad_tpu_torch.engine import leafperm

    rec, pos, dstl, dstr, n_out = args
    k1 = leafperm.permute_records(*args)
    k2 = leafperm.permute_records(*args)
    plain = leafperm.permute_records_plain(
        rec, pos, dstl.clamp(max=(n_out - 1) * 512),
        dstr.clamp(max=(n_out - 1) * 512), n_out)
    torch.cuda.synchronize()
    check(torch.equal(k1, k2), "perm: two launches differ")
    check(torch.equal(k1, plain), "perm: kernel differs from plain version")
    ms = time_ms(lambda: leafperm.permute_records(*args), reps)
    plain_ms = time_ms(lambda: leafperm.permute_records_plain(
        rec, pos, dstl, dstr, n_out), 3)
    # library yardstick: one index_copy_ of every record to its
    # precomputed destination (sentinel rows to a dump row)
    T = leafperm.TILE_ROWS
    pl, pr = pos[:, 0, :].long(), pos[:, 1, :].long()
    dest = torch.where(pl < T, dstl.long()[:, None] + pl,
                       torch.where(pr < T, dstr.long()[:, None] + pr,
                                   n_out * T)).reshape(-1)
    out = torch.zeros((n_out * T + 1, leafperm.REC_WB), dtype=torch.uint8,
                      device=rec.device)
    library_ms = time_ms(lambda: out.index_copy_(0, dest, rec), 3)
    real_rows = int((dest < n_out * T).sum())
    nbytes = (real_rows * leafperm.REC_WB + pos.numel() * 4
              + dstl.numel() * 8 + n_out * T * leafperm.REC_WB)
    b_ms, b_by = bound_ms(nbytes, 0.0)
    del out, dest
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0,
            "real_rows": real_rows, "bytes": nbytes}


def profile_tree(params, ds, dev) -> dict:
    """One tree of the grower under torch.profiler: device time by kernel,
    and the device's busy share of the tree's wall time (measured again
    without the profiler).  The table goes to chiprun_out/profile.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import dryad_tpu_torch as dt
    from dryad_tpu_torch.engine.grower import grow_any
    from dryad_tpu_torch.engine.train import binned_to_device
    from dryad_tpu_torch.objectives import Binary

    p = dt.Params.from_dict(params)
    B = ds.mapper.total_bins
    Xb = binned_to_device(ds.X_binned, dev)
    y = torch.from_numpy(ds.y).to(dev)
    score = torch.full((ds.num_rows,), Binary.init_score(ds.y),
                       dtype=torch.float32, device=dev)
    g, h = Binary.grad_hess(score, y)
    bag = torch.ones(ds.num_rows, dtype=torch.bool, device=dev)
    fmask = torch.ones(ds.num_features, dtype=torch.bool, device=dev)

    def tree():
        grow_any(p, B, Xb, g, h, bag, fmask)
        torch.cuda.synchronize()

    tree()
    t0 = time.perf_counter()
    for _ in range(3):
        tree()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        tree()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # kernels only: op-level events carry their kernels' time again
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(dev_us(e) for e in kernels)
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == torch.autograd.DeviceType.CPU and dev_us(e) > 0]
    with open(os.path.join("chiprun_out", "profile.txt"), "w") as f:
        f.write(prof.key_averages(group_by_input_shape=True).table(
            sort_by="self_cuda_time_total", row_limit=80))
    if total_us <= 0:
        return {"tree_wall_ms": wall_ms, "device_ms": "not measured"}
    top_k = sorted(kernels, key=dev_us, reverse=True)[:10]
    top_o = sorted(ops, key=dev_us, reverse=True)[:10]
    return {"tree_wall_ms": wall_ms, "device_ms": total_us / 1e3,
            "busy_share": total_us / 1e3 / wall_ms,
            "kernels": [[e.key[:60], dev_us(e) / 1e3, e.count]
                        for e in top_k],
            "ops": [[e.key, str(e.input_shapes)[:80], dev_us(e) / 1e3,
                     e.count] for e in top_o]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=HEADLINE_ROWS)
    ap.add_argument("--trees", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import dryad_tpu_torch as dt
    from dryad_tpu_torch import datasets
    from dryad_tpu_torch.engine import cuda_build
    from dryad_tpu_torch.metrics import auc

    check(a.trees >= 2, "--trees must be >= 2 (AUC must rise)")
    dev = torch.device("cuda")
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"card: {smi}", flush=True)
    report: dict = {"card": smi, "kind": kind, "rows": a.rows,
                    "trees": a.trees, "seed": a.seed}

    # ---- 1. build ---------------------------------------------------------
    cuda_build.build_all()
    print(f"kernels built in {cuda_build.build_seconds:.2f} s", flush=True)
    report["build_seconds"] = cuda_build.build_seconds
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "ptxas.txt"), "w") as f:
        for name, log in cuda_build.build_log.items():
            f.write(f"== {name}.cu\n{log}\n")

    # ---- 2. data + capture ------------------------------------------------
    if a.rows < HEADLINE_ROWS:
        print(f"rows cut to {a.rows} from the headline {HEADLINE_ROWS}",
              flush=True)
    t0 = time.perf_counter()
    X, y = datasets.higgs_like(a.rows + HOLDOUT_ROWS, seed=a.seed)
    ds = dt.Dataset(X[:a.rows], y[:a.rows], max_bins=256)
    Xv, yv = X[a.rows:], y[a.rows:]
    del X
    report["data_seconds"] = time.perf_counter() - t0
    check(ds.num_features == 28 and ds.mapper.total_bins == 256,
          f"data shape {ds.num_features} x {ds.mapper.total_bins} bins")
    print(f"data: {a.rows} x {ds.num_features}, "
          f"{ds.mapper.total_bins} bins, {report['data_seconds']:.1f} s",
          flush=True)
    params = {"objective": "binary", "growth": "depthwise", "max_depth": 8,
              "num_leaves": 255, "max_bins": 256, "learning_rate": 0.1,
              "num_trees": a.trees}
    root_args, level_args, perm_args = capture_inputs(dt, params, ds, dev)

    # ---- 3. kernels vs plain ----------------------------------------------
    root = check_hist(root_args, "hist root", a.reps)
    print("K1 root: " + json.dumps(root), flush=True)
    level = check_hist(level_args, "hist level", a.reps)
    print("K1 level: " + json.dumps(level), flush=True)
    perm = check_perm(perm_args, a.reps)
    print("K2 depth-4 move: " + json.dumps(perm), flush=True)
    del root_args, level_args, perm_args
    torch.cuda.empty_cache()
    report.update(hist_root=root, hist_level=level, perm=perm)

    # ---- 4. the main path: train + predict --------------------------------
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_counts()
    booster = dt.train(params, ds, device=dev)
    raw_gpu = dt.predict(booster, Xv, raw_score=True, device=dev)
    launches = dict(cuda_build.counts)
    peak = torch.cuda.max_memory_allocated()
    check(launches["hist"] == 9 * a.trees,
          f"K1 launched {launches['hist']} times, want {9 * a.trees}")
    check(launches["perm"] == 8 * a.trees,
          f"K2 launched {launches['perm']} times, want {8 * a.trees}")
    ts = booster.tree_seconds
    rest = sum(ts[1:]) / len(ts[1:])
    train_rep = {"first_tree_s": ts[0], "mean_tree_s": rest,
                 "trees_per_s": 1.0 / rest, "peak_bytes": peak,
                 "launches": launches}
    print("train: " + json.dumps(train_rep), flush=True)
    report["train"] = train_rep

    again = dt.train(params, ds, device=dev)
    ra, rb = booster.tree_arrays(), again.tree_arrays()
    for k in ra:
        check(np.array_equal(ra[k], rb[k]), f"second run differs in {k!r}")
    print("determinism: second run bitwise equal", flush=True)

    # ---- 5. predict checks ------------------------------------------------
    raw_cpu = dt.predict(booster, Xv, raw_score=True, device="cpu")
    check(raw_gpu.shape == (HOLDOUT_ROWS,) and bool(np.isfinite(raw_gpu).all()),
          "predict shape or finiteness")
    check(np.array_equal(raw_gpu, raw_cpu), "card predict != CPU predict")
    auc1 = auc(yv, dt.predict(booster, Xv, num_iteration=1, device=dev))
    auc_last = auc(yv, dt.predict(booster, Xv, device=dev))
    print(f"predict: bitwise equal to CPU; AUC tree 1 {auc1:.6f}, "
          f"tree {a.trees} {auc_last:.6f}", flush=True)
    check(auc_last > auc1, "AUC did not rise")
    check(auc_last > 0.70, f"AUC {auc_last} <= 0.70")
    report["auc"] = {"tree_1": auc1, "last": auc_last}

    # ---- 6. where one tree's time goes ------------------------------------
    prof = profile_tree(params, ds, dev)
    print("profile: " + json.dumps(prof), flush=True)
    report["profile"] = prof

    kernels = [
        {"name": "hist", "route": "cuda",
         "source": "dryad_tpu_torch/csrc/hist.cu",
         "replaces": "dryad_tpu/engine/pallas_hist.py:140",
         "launches": launches["hist"], "max_abs_err": level["max_abs_err"],
         "ms": level["ms"], "plain_ms": level["plain_ms"],
         "bound_ms": level["bound_ms"], "bound_by": level["bound_by"],
         "library_ms": level["library_ms"],
         "root": {k: root[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "library_ms", "max_abs_err")}},
        {"name": "perm", "route": "cuda",
         "source": "dryad_tpu_torch/csrc/perm.cu",
         "replaces": "dryad_tpu/engine/leafperm.py:94",
         "launches": launches["perm"], "max_abs_err": 0.0,
         "ms": perm["ms"], "plain_ms": perm["plain_ms"],
         "bound_ms": perm["bound_ms"], "bound_by": perm["bound_by"],
         "library_ms": perm["library_ms"]},
    ]
    report["kernels"] = kernels
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
