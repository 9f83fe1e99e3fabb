#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--rows N] [--trees T] [--seed S] [--reps R]
                          [--eps-rows N] [--eps-trees T] [--bag-trees T]
                          [--bag-legacy-trees T]

Phases (any failed check exits non-zero):

1. the card's name and power limit; build the CUDA kernels from
   ``dryad_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel); count
   the atomic instructions in each built library (``cuobjdump -sass``):
   no shared-memory compare-and-swap in the histogram kernels;
2. Higgs-shaped data, ``rows`` training rows + 1M held-out rows, from the
   seed; one capture tree of the wired path records its kernels' inputs;
3. K1 layout mode (histograms) on the card vs its plain version at the
   root and at the widest level (P=128): bitwise equal (counts and g/h:
   both sum in the tree's fixed point), two launches bitwise equal; K2
   (row move) at a depth-4 level, bitwise; each with its time, the plain
   version's, one library call's and the bound;
4. the wired path: the headline config (28 features, 256 bins, depthwise,
   max_depth 8, 255 leaves, learning rate 0.1) with the launch counts set
   to 0 just before: 9 K1 and 8 K2 launches per tree; a second run gives
   bitwise-equal trees;
5. predict of the held-out rows on the card, bitwise equal to the port's
   own CPU predict; AUC above 0.70 and rising from tree 1 to the last;
6. one wired tree under torch.profiler: device time by kernel and the
   device's busy share of the tree's wall time;
7. wired against legacy on a tie-free fixture (50k rows, 64 bins, 4
   trees, 128 leaves, depth 8): equal trees;
8. the legacy plan arm at the headline config (``deep_layout="legacy"``):
   one capture tree; K3 (natural-order pass) at level 4 (P=16) and K1 row
   mode at level 7 (P=128) vs their plain versions, as in phase 3;
9. the legacy path: 5 K3, 4 K1 row-mode and no other launches per tree; a
   second run bitwise equal; card predict bitwise equal to CPU predict; AUC
   above 0.70 and rising; tree 1 equal to the wired run's tree 1 (no
   node differs); one tree profiled;
10. leaf-wise growth, wired (Higgs data, ``growth="leafwise"``, 255
   leaves, max_depth 8): the batched grower and the wired gate are taken;
   one capture tree holds K2 at level 4 and K1 layout mode at the widest
   level (P=128) against their plain versions, under heap-node runs; 9 K1
   and 8 K2 launches per tree and no other; a second run bitwise equal;
   card predict bitwise equal to CPU predict; AUC above 0.70 and rising;
   one tree profiled, and the selection replay's host and device time;
11. leaf-wise at the reference's default depth (``max_depth=-1``, which
   ``effective_depth_params`` maps to 12, past the wired cap of 2^D <=
   1024, so the legacy arm): K3 at P=8 and K1 row mode at P=2048 against
   their plain versions; 4 K3 and 9 K1 row-mode launches per tree and no
   other; second run, predict and AUC as in 10; peak device memory; one
   tree profiled;
12. the leaf-wise fixture (50k rows, 64 bins, 4 trees, 128 leaves, depth
   8): wired and legacy trees equal; on one tree the batched grower equals
   the sequential ``grow_tree`` on every integer array (node ids and
   ``row_leaf`` included); ``{"objective": "binary"}`` alone trains 3
   trees of 31 leaves at effective depth 9 on the wired arm;
13. the training loop on the wired path, bagged and validated (the
   headline config with ``subsample=0.8``, ``colsample=0.8``, the 1M
   held-out rows as the valid set, AUC early stopping after 5 rounds,
   ``bag_trees`` trees): one capture tree holds K1 at the masked root and
   K2 at level 0 against their plain versions, counts the root's rows
   (the bag's), and checks that level 0's move keeps every in-bag record
   once and no out-of-bag one; 9 K1 and 8 K2 launches per tree; a second
   run bitwise equal (trees, evals, best iteration); the trainer's valid
   scores bitwise equal to predict's, its last AUC within 1e-5 of the host
   AUC, above 0.70 and risen from tree 1; trees/s with and without the
   valid set, ms per device AUC at 1M rows, peak memory;
14. checkpoint/resume on the card: 10 bagged, validated trees straight; a
   run that crashes at iteration 6 after checkpoints every 3; the resumed
   run grows 4 trees (9 K1 + 8 K2 each) and equals the straight run bit
   for bit (trees, evals, best iteration, predict of the held-out rows);
   its saved model file loads and predicts bitwise;
15. leaf-wise at the default depth (legacy arm) with ``subsample=0.8``:
   on a capture tree out-of-bag rows carry K3's drop slot and stay out of
   K1 row mode's plan, and K3 at P=8 and K1 row mode at P=2048 equal their
   plain versions; then as in 11 with ``bag_legacy_trees`` trees;
16. Epsilon-shaped regression (``eps_rows`` x 2000 features + 100k held
   out, 256 bins, max_depth 6, 63 leaves), after the Higgs tensors are
   freed: K1 row mode vs its plain version at the root and the widest
   level (P=32); 7 K1 row-mode launches per tree and no other; a second
   run bitwise equal; held-out RMSE falls from tree 1 to the last and ends
   below the label's standard deviation; time per tree, peak memory, one
   tree profiled.

Each kernel's time is held beside two bounds, the bytes over the memory
rate and, for the histogram kernels, the shared-memory atomic updates (3
per live (row, feature) pair) over the atomic rate; ``bound_ms`` is the
larger.  The histogram kernels also report their
shared memory per block, blocks and features per block.

It prints, on lines of their own, a ``kernels`` JSON object, the card's
``name, power limit`` as nvidia-smi gives them and, last,
``{"ok": true, "device": {...}}``.  Full figures also go to
``chiprun_out/chip_smoke.json``.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate
# shared-memory atomic rate of an H100 SXM: 132 SMs x 32 banks (one 32-bit
# atomic slot per bank per clock) x 1.98 GHz boost clock.  One (row,
# feature) update of g, h and the count takes at least 3 slots, one 32-bit
# add each; the high-word adds the kernels also issue are not counted
# (PERF.md, "Bounds")
SMEM_ATOMIC_SLOTS_PER_S = 132 * 32 * 1.98e9
SLOTS_PER_UPDATE = 3
HEADLINE_ROWS = 10_000_000
HOLDOUT_ROWS = 1_000_000
EPS_ROWS = 400_000
EPS_HOLDOUT = 100_000
EPS_FEATURES = 2000
OUT = "chiprun_out"


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


def sass_atomics() -> dict:
    """The atomic instructions in each built library (``cuobjdump -sass``),
    by opcode.  Fails if a histogram library holds a shared-memory
    compare-and-swap (``ATOMS.CAS*``, the loop a 64-bit shared add
    compiles to): its adds must be native 32-bit ``ATOMS.ADD``."""
    import collections
    import re
    import shutil

    from dryad_tpu_torch.engine import cuda_build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    check(os.path.exists(tool), "cuobjdump not found: the SASS of the "
          "histogram kernels cannot be checked")
    out = {}
    for name in cuda_build.SOURCES:
        sass = subprocess.run([tool, "-sass", cuda_build.lib_path(name)],
                              capture_output=True, text=True,
                              check=True).stdout
        ops = collections.Counter(
            re.findall(r"\b((?:ATOMS|ATOMG|ATOM|RED)(?:\.[A-Z0-9_]+)*)",
                       sass))
        out[name] = dict(ops)
        if name in ("hist", "hist_nat"):
            check(sum(ops.values()) > 0, f"{name}: no atomics in its SASS")
            cas = [op for op in ops if op.startswith("ATOMS.CAS")]
            check(not cas, f"{name}: shared-memory compare-and-swap in its "
                  f"SASS ({cas}): a 64-bit shared add crept back in")
    return out


def sync() -> None:
    import torch

    torch.cuda.synchronize()


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


def bound_ms(nbytes: float, pairs: float) -> dict:
    """The least time for the work: the larger of the bytes over the memory
    rate and the shared-memory atomic updates (``pairs`` live (row,
    feature) pairs) over the atomic rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = pairs * SLOTS_PER_UPDATE / SMEM_ATOMIC_SLOTS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_bound_ms": t_bytes, "update_bound_ms": t_ops,
            "updates": 3 * pairs}


def capture(dt, params, ds, dev, names):
    """Train one tree with the named kernel wrappers wrapped; returns each
    wrapper's calls as (args, kwargs).  ``names`` maps a label to
    (module, attribute)."""
    calls = {k: [] for k in names}
    real = {k: getattr(m, a) for k, (m, a) in names.items()}

    def spy(k):
        def f(*a, **kw):
            calls[k].append((a, kw))
            return real[k](*a, **kw)
        return f

    for k, (m, a) in names.items():
        setattr(m, a, spy(k))
    try:
        dt.train(dict(params, num_trees=1), ds, device=dev)
    finally:
        for k, (m, a) in names.items():
            setattr(m, a, real[k])
    return calls


def compare(name: str, run, plain) -> tuple[object, float]:
    """Kernel twice (bitwise equal) vs its plain version: bitwise equal,
    counts and g/h (both are fixed-point integer sums in the tree's shift,
    rounded once).  Returns (result, max abs error)."""
    import torch

    k1 = run()
    k2 = run()
    sync()
    check(torch.equal(k1, k2), f"{name}: two launches differ")
    ref = plain()
    sync()
    err = float((k1 - ref).abs().max())
    check(torch.equal(k1[:, 2], ref[:, 2]), f"{name}: counts differ")
    check(torch.equal(k1, ref),
          f"{name}: g/h differ from the plain version (max abs err {err})")
    return k1, err


def library_ms(leaf, valid, g, h, bins, P, F, B) -> float:
    """The library yardstick: one ``index_add_`` of the live (g, h, 1) rows
    into flat (leaf, feature, bin) cells, on precomputed cells (the port
    never calls it).  Rows outside ``valid`` (out of the bag, padding) are
    left out of the call rather than sent to one dump cell, whose
    contention would time the dump and not the sums.  ``bins`` (n, F)
    int64 is overwritten with the cells."""
    import torch

    dev = bins.device
    cell = bins
    cell += (leaf.long()[:, None] * F + torch.arange(F, device=dev)) * B
    cell = cell[valid]
    vals = torch.stack([g[valid], h[valid], torch.ones_like(g[valid])],
                       -1)[:, None, :].expand(-1, F, -1).reshape(-1, 3)
    acc = torch.zeros((P * F * B, 3), device=dev)
    cell = cell.reshape(-1)
    ms = time_ms(lambda: acc.index_add_(0, cell, vals), 3)
    del cell, vals, acc
    return ms


def check_hist(args, name: str, reps: int) -> dict:
    """K1 layout mode on the card vs its plain version on captured inputs."""
    from dryad_tpu_torch.engine import hist

    from dryad_tpu_torch.engine import cuda_build

    rec, src, tile_leaf, P, B, F, isz, shift = args
    _, err = compare(name, lambda: hist.hist_tiles(*args),
                     lambda: hist.hist_tiles_plain(*args))
    shape = dict(cuda_build.launch_info.get("hist", {}))
    ms = time_ms(lambda: hist.hist_tiles(*args), reps)
    plain_ms = time_ms(lambda: hist.hist_tiles_plain(*args), 2)
    T, WB = hist.TILE_ROWS, hist.REC_WB
    n_in = rec.shape[0] // T
    live = src >= 0
    rows = rec.view(n_in, T, WB)[src.clamp(0, n_in - 1)].view(-1, WB)
    g, h, valid, bins = hist.unpack_rows(rows, F, isz)
    valid = valid & live.repeat_interleave(T)
    lib = library_ms(tile_leaf.repeat_interleave(T), valid, g, h, bins,
                     P, F, B)
    live_tiles = int(live.sum())
    nbytes = (live_tiles * T * (9 + F * isz) + src.numel() * 8
              + P * 3 * F * B * 4)
    bound = bound_ms(nbytes, float(int(valid.sum())) * F)
    del rows, g, h, valid, bins
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib, **bound,
            "max_abs_err": err, "P": P, "live_tiles": live_tiles,
            "bytes": nbytes, **shape}


def check_rows(args, name: str, reps: int) -> dict:
    """K1 row mode on the card vs its plain version on captured inputs."""
    import torch

    from dryad_tpu_torch.engine import hist

    from dryad_tpu_torch.engine import cuda_build

    recs, buf, tile_leaf, P, B, F, isz, shift = args
    _, err = compare(name, lambda: hist.hist_rows(*args),
                     lambda: hist.hist_rows_plain(*args))
    shape = dict(cuda_build.launch_info.get("hist_rows", {}))
    ms = time_ms(lambda: hist.hist_rows(*args), reps)
    plain_ms = time_ms(lambda: hist.hist_rows_plain(*args), 2)
    N = recs.shape[0]
    valid = buf < N
    n_live = int(valid.sum())
    rows = recs[buf.clamp(max=N - 1)]
    bins = hist.bin_bytes(rows.view(torch.uint8), 8, 0, F, isz)
    lib = library_ms(tile_leaf.repeat_interleave(hist.TILE_ROWS), valid,
                     rows[:, 0].view(torch.float32),
                     rows[:, 1].view(torch.float32), bins, P, F, B)
    del rows, bins
    nbytes = (n_live * (8 + F * isz) + buf.numel() * buf.element_size()
              + P * 3 * F * B * 4)
    bound = bound_ms(nbytes, float(n_live) * F)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib, **bound,
            "max_abs_err": err, "P": P, "live_rows": n_live,
            "plan_tiles": int(tile_leaf.numel()), "bytes": nbytes, **shape}


def check_nat(call, name: str, reps: int) -> dict:
    """K3 on the card vs its plain version on captured inputs."""
    import torch

    from dryad_tpu_torch.engine import cuda_build, hist_nat

    (xt, g, h, sel, shift), kw = call
    P, B, F = kw["num_cols"], kw["total_bins"], kw["num_features"]
    _, err = compare(
        name, lambda: hist_nat.build_hist_nat(xt, g, h, sel, shift, **kw),
        lambda: hist_nat.build_hist_nat_plain(xt, g, h, sel, shift, P, B, F))
    shape = dict(cuda_build.launch_info.get("nat", {}))
    ms = time_ms(lambda: hist_nat.build_hist_nat(xt, g, h, sel, shift, **kw),
                 reps)
    plain_ms = time_ms(lambda: hist_nat.build_hist_nat_plain(
        xt, g, h, sel, shift, P, B, F), 2)
    N = g.shape[0]
    keep = (sel >= 0) & (sel < P)
    n_keep = int(keep.sum())
    bins = xt[:, :N].t().contiguous().to(torch.int64) & 0xFFFF
    lib = library_ms(torch.where(keep, sel, 0), keep, g, h, bins, P, F, B)
    del bins
    isz = xt.element_size()
    nbytes = N * 4 + n_keep * (F * isz + 8) + P * 3 * F * B * 4
    bound = bound_ms(nbytes, float(n_keep) * F)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib, **bound,
            "max_abs_err": err, "P": P, "kept_rows": n_keep, "bytes": nbytes,
            **shape}


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
    sync()
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
    library = time_ms(lambda: out.index_copy_(0, dest, rec), 3)
    real_rows = int((dest < n_out * T).sum())
    nbytes = (real_rows * leafperm.REC_WB + pos.numel() * 4
              + dstl.numel() * 8 + n_out * T * leafperm.REC_WB)
    bound = bound_ms(nbytes, 0.0)
    del out, dest
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "max_abs_err": 0.0, "real_rows": real_rows, "bytes": nbytes}


def dev_us(e) -> float:
    """Self device time of a profiler event, in microseconds."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def profile_tree(params, ds, dev, fname: str) -> dict:
    """One tree of the grower (under iteration 0's bag and feature mask)
    under torch.profiler: device time by kernel, and the device's busy
    share of the tree's wall time (measured again without the profiler).
    The table goes to chiprun_out/<fname>."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import dryad_tpu_torch as dt
    from dryad_tpu_torch.config import effective_depth_params
    from dryad_tpu_torch.engine.grower import grow_any
    from dryad_tpu_torch.engine.loop_state import sample_masks
    from dryad_tpu_torch.engine.train import binned_to_device
    from dryad_tpu_torch.objectives import get_objective

    B = ds.mapper.total_bins
    p = effective_depth_params(dt.Params.from_dict(params), ds.num_features,
                               B, ds.num_rows)
    obj = get_objective(p)
    Xb = binned_to_device(ds.X_binned, dev)
    y = torch.from_numpy(ds.y).to(dev)
    score = torch.full((ds.num_rows,), obj.init_score(ds.y),
                       dtype=torch.float32, device=dev)
    g, h = obj.grad_hess(score, y)
    row_mask, feat_mask = sample_masks(p, 0, ds.num_rows, ds.num_features)
    bag = (torch.ones(ds.num_rows, dtype=torch.bool, device=dev)
           if row_mask is None else torch.from_numpy(row_mask).to(dev))
    fmask = (torch.ones(ds.num_features, dtype=torch.bool, device=dev)
             if feat_mask is None else torch.from_numpy(feat_mask).to(dev))

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

    # kernels only: op-level events carry their kernels' time again
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(dev_us(e) for e in kernels)
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == torch.autograd.DeviceType.CPU and dev_us(e) > 0]
    with open(os.path.join(OUT, fname), "w") as f:
        f.write(prof.key_averages(group_by_input_shape=True).table(
            sort_by="self_cuda_time_total", row_limit=80))
    del Xb, y, score, g, h
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


def train_counted(dt, params, ds, dev):
    """One main-path training run with every launch count set to 0 just
    before it; returns (booster, counts read just after, peak bytes)."""
    import torch

    from dryad_tpu_torch.engine import cuda_build

    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_counts()
    booster = dt.train(params, ds, device=dev)
    launches = dict(cuda_build.counts)
    return booster, launches, torch.cuda.max_memory_allocated()


def legacy_calls(n_rows: int, n_features: int, depth: int,
                 leaves: int) -> tuple[int, int]:
    """(K3, K1 row-mode) launches of one legacy tree of u8 bins: K3 for the
    narrow phase when the natural-order gate admits the matrix, K1 row mode
    for the root and every other level."""
    from dryad_tpu_torch.engine import hist_nat
    from dryad_tpu_torch.engine.levelwise import phase_plan

    nat_live = hist_nat.nat_gate_admits(n_rows, n_features, 1)
    d_switch, p_narrow, _ = phase_plan(depth, min(leaves, 2 ** depth),
                                       nat_live)
    n_nat = d_switch if nat_live and p_narrow <= hist_nat.NAT_SLOTS else 0
    return n_nat, 1 + depth - n_nat


def check_launches(launches: dict, want: dict, what: str) -> None:
    for k, n in launches.items():
        check(n == want.get(k, 0),
              f"{what}: {k} launched {n} times, want {want.get(k, 0)}")


def same_trees(a, b, what: str) -> None:
    import numpy as np

    ra, rb = a.tree_arrays(), b.tree_arrays()
    for k in ra:
        check(np.array_equal(ra[k], rb[k]),
              f"{what}: second run differs in {k!r}")


def tree_summary(booster) -> dict:
    """Time of the first tree, and the mean of the others."""
    ts = booster.tree_seconds
    rest = ts[1:] or ts
    mean = sum(rest) / len(rest)
    return {"first_tree_s": ts[0], "mean_tree_s": mean,
            "trees_per_s": 1.0 / mean}


def train_and_check(dt, params, ds, Xv, yv, dev, want: dict,
                    what: str) -> tuple:
    """A path's main-path run: launch counts (set to 0 just before it), a
    second run bitwise equal, card predict finite and bitwise equal to CPU
    predict, AUC above 0.70 and rising.  Returns (booster, report)."""
    import numpy as np

    from dryad_tpu_torch.metrics import auc

    booster, launches, peak = train_counted(dt, params, ds, dev)
    raw_gpu = dt.predict(booster, Xv, raw_score=True, device=dev)
    check_launches(launches, want, what)
    same_trees(booster, dt.train(params, ds, device=dev), what)
    check(raw_gpu.shape == (len(yv),) and bool(np.isfinite(raw_gpu).all()),
          f"{what}: predict shape or finiteness")
    check(np.array_equal(raw_gpu, dt.predict(booster, Xv, raw_score=True,
                                             device="cpu")),
          f"{what}: card predict != CPU predict")
    auc1 = auc(yv, dt.predict(booster, Xv, num_iteration=1, device=dev))
    auc_last = auc(yv, dt.predict(booster, Xv, device=dev))
    check(auc_last > auc1, f"{what}: AUC did not rise")
    check(auc_last > 0.70, f"{what}: AUC {auc_last} <= 0.70")
    rep = dict(tree_summary(booster), peak_bytes=peak, launches=launches,
               auc={"tree_1": auc1, "last": auc_last},
               effective_max_depth=booster.params.max_depth,
               splits_per_tree=float((booster.arrays["feature"] >= 0)
                                     .sum(1).mean()))
    print(f"{what} train: " + json.dumps(rep), flush=True)
    print(f"{what}: second run bitwise equal; card predict bitwise equal to "
          "CPU", flush=True)
    return booster, rep


def phase_wired(dt, a, ds, Xv, yv, dev, report) -> tuple:
    """Phases 3-6: the wired path at the headline config."""
    import torch

    from dryad_tpu_torch.engine import hist, leafperm

    params = {"objective": "binary", "growth": "depthwise", "max_depth": 8,
              "num_leaves": 255, "max_bins": 256, "learning_rate": 0.1,
              "num_trees": a.trees}
    calls = capture(dt, params, ds, dev,
                    {"hist": (hist, "hist_tiles"),
                     "perm": (leafperm, "permute_records")})
    check(len(calls["hist"]) == 9 and len(calls["perm"]) == 8,
          f"wired capture tree made {len(calls['hist'])} histogram calls "
          f"and {len(calls['perm'])} row moves")
    root = check_hist(calls["hist"][0][0], "hist root", a.reps)
    print("K1 root: " + json.dumps(root), flush=True)
    level = check_hist(calls["hist"][-1][0], "hist level", a.reps)
    print("K1 level: " + json.dumps(level), flush=True)
    perm = check_perm(calls["perm"][4][0], a.reps)
    print("K2 depth-4 move: " + json.dumps(perm), flush=True)
    del calls
    torch.cuda.empty_cache()
    report.update(hist_root=root, hist_level=level, perm=perm)

    booster, rep = train_and_check(dt, params, ds, Xv, yv, dev,
                                   {"hist": 9 * a.trees,
                                    "perm": 8 * a.trees}, "wired")
    report["train"] = rep

    prof = profile_tree(params, ds, dev, "profile.txt")
    print("wired profile: " + json.dumps(prof), flush=True)
    report["profile"] = prof
    return params, booster, rep["launches"], level


def phase_fixture(dt, dev, report) -> None:
    """Phase 7: wired against legacy on the card, tie-free fixture."""
    import numpy as np

    from dryad_tpu_torch import datasets

    X, y = datasets.higgs_like(50_000, seed=43)
    ds = dt.Dataset(X, y, max_bins=64)
    base = {"objective": "binary", "num_trees": 4, "num_leaves": 128,
            "max_bins": 64, "growth": "depthwise", "max_depth": 8}
    b_w = dt.train(base, ds, device=dev)
    b_l = dt.train(dict(base, deep_layout="legacy"), ds, device=dev)
    for k in ("feature", "threshold", "left", "right"):
        check(np.array_equal(b_w.tree_arrays()[k], b_l.tree_arrays()[k]),
              f"wired vs legacy fixture: {k!r} differs")
    dv = float(np.abs(b_w.arrays["value"] - b_l.arrays["value"]).max())
    check(dv <= 1e-5, f"wired vs legacy fixture: values differ by {dv}")
    print(f"wired vs legacy fixture: equal trees (max value diff {dv})",
          flush=True)
    report["fixture"] = {"max_value_diff": dv}


def phase_legacy(dt, a, ds, Xv, yv, dev, wired_params, wired_booster,
                 report) -> tuple:
    """Phases 8-9: the legacy plan arm at the headline config."""
    import torch

    from dryad_tpu_torch.engine import hist, hist_nat

    params = dict(wired_params, deep_layout="legacy")
    n_nat, n_rows = legacy_calls(ds.num_rows, ds.num_features, 8, 255)
    check((n_nat, n_rows) == (5, 4), "the Higgs matrix left the K3 gate")
    calls = capture(dt, params, ds, dev,
                    {"rows": (hist, "hist_rows"),
                     "nat": (hist_nat, "build_hist_nat")})
    check(len(calls["rows"]) == n_rows and len(calls["nat"]) == n_nat,
          f"legacy capture tree made {len(calls['rows'])} row-mode and "
          f"{len(calls['nat'])} natural-order calls")
    nat = check_nat(calls["nat"][4], "nat level 4", a.reps)
    print("K3 level 4: " + json.dumps(nat), flush=True)
    rows = check_rows(calls["rows"][-1][0], "hist rows level 7", a.reps)
    print("K1 rows level 7: " + json.dumps(rows), flush=True)
    del calls
    torch.cuda.empty_cache()
    report.update(nat_level=nat, rows_level=rows)

    booster, rep = train_and_check(dt, params, ds, Xv, yv, dev,
                                   {"nat": n_nat * a.trees,
                                    "hist_rows": n_rows * a.trees}, "legacy")
    w0, l0 = wired_booster.tree_arrays(), booster.tree_arrays()
    differ = int(((w0["feature"][0] != l0["feature"][0])
                  | (w0["threshold"][0] != l0["threshold"][0])).sum())
    check(differ == 0, f"legacy: {differ} tree-1 nodes differ from the wired "
          "run's tree 1")
    rep["tree1_nodes_differing_from_wired"] = differ
    prof = profile_tree(params, ds, dev, "profile_legacy.txt")
    print("legacy profile: " + json.dumps(prof), flush=True)
    rep["profile"] = prof
    report["legacy"] = rep
    return rep["launches"], nat, rows


def selection_cost(args, params, ds, dev) -> dict:
    """The leaf-wise selection replay (``leafwise_fast.select_tree``) alone
    on a captured tree's heap tables, against whole trees of the same
    config timed in the same window (alternately, 3 each, every call
    ending in a synchronisation): host wall ms of each, the replay's share
    of a tree, and its device ms and kernel launches under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import dryad_tpu_torch as dt
    from dryad_tpu_torch.config import effective_depth_params
    from dryad_tpu_torch.engine import leafwise_fast
    from dryad_tpu_torch.engine.grower import grow_any
    from dryad_tpu_torch.engine.train import binned_to_device
    from dryad_tpu_torch.objectives import get_objective

    B = ds.mapper.total_bins
    p = effective_depth_params(dt.Params.from_dict(params), ds.num_features,
                               B, ds.num_rows)
    obj = get_objective(p)
    Xb = binned_to_device(ds.X_binned, dev)
    y = torch.from_numpy(ds.y).to(dev)
    g, h = obj.grad_hess(torch.full((ds.num_rows,), obj.init_score(ds.y),
                                    dtype=torch.float32, device=dev), y)
    bag = torch.ones(ds.num_rows, dtype=torch.bool, device=dev)
    fmask = torch.ones(ds.num_features, dtype=torch.bool, device=dev)

    def wall_ms(fn):
        t0 = time.perf_counter()
        fn()
        sync()
        return (time.perf_counter() - t0) * 1e3

    def tree():
        grow_any(p, B, Xb, g, h, bag, fmask)

    def select():
        leafwise_fast.select_tree(*args)

    wall_ms(tree)
    wall_ms(select)
    trees, sels = [], []
    for _ in range(3):
        trees.append(wall_ms(tree))
        sels.append(wall_ms(select))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        select()
        sync()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    sel_us = sum(dev_us(e) for e in kernels)
    del Xb, y, g, h
    tree_ms, sel_ms = sum(trees) / 3, sum(sels) / 3
    return {"trips": int(args[0]) - 1, "host_ms": sel_ms,
            "tree_wall_ms": tree_ms, "share_of_tree_wall": sel_ms / tree_ms,
            "device_ms": sel_us / 1e3 if sel_us > 0 else "not measured",
            "kernel_launches": sum(e.count for e in kernels)}


def leafwise_capture(dt, params, ds, dev, names: dict, what: str) -> dict:
    """One capture tree of a leaf-wise configuration, with the batched
    grower and the sequential one watched: the batched grower must run
    once and the sequential one never."""
    from dryad_tpu_torch.engine import grower, leafwise_fast

    calls = capture(dt, params, ds, dev, dict(
        names, batched=(leafwise_fast, "grow_tree_leafwise_batched"),
        sequential=(grower, "grow_tree"),
        select=(leafwise_fast, "select_tree")))
    check(len(calls["batched"]) == 1 and not calls["sequential"],
          f"{what}: the batched leaf-wise grower was not the one taken")
    return calls


def phase_leafwise_wired(dt, a, ds, Xv, yv, dev, report) -> tuple:
    """Phase 10: leaf-wise growth on the wired arm at max_depth 8."""
    import torch

    from dryad_tpu_torch.config import (
        effective_depth_params,
        leafwise_fast_supported,
    )
    from dryad_tpu_torch.engine import hist, leafperm, leafwise_fast

    params = {"objective": "binary", "growth": "leafwise", "max_depth": 8,
              "num_leaves": 255, "max_bins": 256, "learning_rate": 0.1,
              "num_trees": a.trees}
    F, B, N = ds.num_features, ds.mapper.total_bins, ds.num_rows
    p = effective_depth_params(dt.Params.from_dict(params), F, B, N)
    check(p.max_depth == 8 and leafwise_fast_supported(p, F, B, N)
          and leafwise_fast.leafwise_layout_supported(p, F, B, 1),
          "leaf-wise depth 8: not the batched grower on the wired arm")
    calls = leafwise_capture(dt, params, ds, dev,
                             {"hist": (hist, "hist_tiles"),
                              "perm": (leafperm, "permute_records")},
                             "leaf-wise wired")
    check(len(calls["hist"]) == 9 and len(calls["perm"]) == 8,
          f"leaf-wise wired capture tree made {len(calls['hist'])} "
          f"histogram calls and {len(calls['perm'])} row moves")
    level = check_hist(calls["hist"][-1][0], "leaf-wise hist level 7",
                       a.reps)
    check(level["P"] == 128, f"leaf-wise widest level P={level['P']}")
    print("K1 leaf-wise level 7: " + json.dumps(level), flush=True)
    perm = check_perm(calls["perm"][4][0], a.reps)
    print("K2 leaf-wise level 4: " + json.dumps(perm), flush=True)
    select_args = calls["select"][0][0]
    del calls
    torch.cuda.empty_cache()

    _, rep = train_and_check(dt, params, ds, Xv, yv, dev,
                             {"hist": 9 * a.trees, "perm": 8 * a.trees},
                             "leaf-wise wired")
    rep["profile"] = profile_tree(params, ds, dev, "profile_leafwise.txt")
    print("leaf-wise wired profile: " + json.dumps(rep["profile"]),
          flush=True)
    rep["selection"] = selection_cost(select_args, params, ds, dev)
    print("leaf-wise selection replay: " + json.dumps(rep["selection"]),
          flush=True)
    rep.update(hist_level=level, perm=perm)
    report["leafwise_wired"] = rep
    return rep["launches"], level, perm


def phase_leafwise_default(dt, a, ds, Xv, yv, dev, report) -> tuple:
    """Phase 11: leaf-wise at the reference's default max_depth=-1."""
    import torch

    from dryad_tpu_torch.config import (
        effective_depth_params,
        leafwise_fast_supported,
    )
    from dryad_tpu_torch.engine import hist, hist_nat, leafwise_fast

    params = {"objective": "binary", "growth": "leafwise", "num_leaves": 255,
              "max_bins": 256, "learning_rate": 0.1, "num_trees": a.trees}
    F, B, N = ds.num_features, ds.mapper.total_bins, ds.num_rows
    p = effective_depth_params(dt.Params.from_dict(params), F, B, N)
    check(p.max_depth == 12 and leafwise_fast_supported(p, F, B, N)
          and not leafwise_fast.leafwise_layout_supported(p, F, B, 1),
          f"leaf-wise default: effective depth {p.max_depth}, not the "
          "batched grower's legacy arm at 12")
    check(hist_nat.nat_gate_admits(N, F, 1), "the Higgs matrix left the "
          "K3 gate")
    calls = leafwise_capture(dt, params, ds, dev,
                             {"rows": (hist, "hist_rows"),
                              "nat": (hist_nat, "build_hist_nat")},
                             "leaf-wise default")
    check(len(calls["rows"]) == 9 and len(calls["nat"]) == 4,
          f"leaf-wise default capture tree made {len(calls['rows'])} "
          f"row-mode and {len(calls['nat'])} natural-order calls")
    nat = check_nat(calls["nat"][3], "leaf-wise nat level 3", a.reps)
    check(nat["P"] == 8, f"leaf-wise K3 P={nat['P']}")
    print("K3 leaf-wise level 3: " + json.dumps(nat), flush=True)
    rows = check_rows(calls["rows"][-1][0], "leaf-wise rows level 11",
                      a.reps)
    check(rows["P"] == 2048, f"leaf-wise K1 row mode P={rows['P']}")
    print("K1 rows leaf-wise level 11: " + json.dumps(rows), flush=True)
    select_args = calls["select"][0][0]
    del calls
    torch.cuda.empty_cache()

    _, rep = train_and_check(dt, params, ds, Xv, yv, dev,
                             {"nat": 4 * a.trees, "hist_rows": 9 * a.trees},
                             "leaf-wise default")
    rep["profile"] = profile_tree(params, ds, dev,
                                  "profile_leafwise_default.txt")
    print("leaf-wise default profile: " + json.dumps(rep["profile"]),
          flush=True)
    rep["selection"] = selection_cost(select_args, params, ds, dev)
    print("leaf-wise default selection replay: "
          + json.dumps(rep["selection"]), flush=True)
    rep.update(nat_level=nat, rows_level=rows)
    report["leafwise_default"] = rep
    return rep["launches"], nat, rows


def phase_leafwise_fixture(dt, dev, report) -> None:
    """Phase 12: the leaf-wise fixture: wired vs legacy, batched vs
    sequential, and the reference's defaults."""
    import numpy as np
    import torch

    from dryad_tpu_torch import datasets
    from dryad_tpu_torch.engine import grower, leafwise_fast
    from dryad_tpu_torch.objectives import Binary

    X, y = datasets.higgs_like(50_000, seed=43)
    ds = dt.Dataset(X, y, max_bins=64)
    base = {"objective": "binary", "num_trees": 4, "num_leaves": 128,
            "max_bins": 64, "growth": "leafwise", "max_depth": 8}
    b_w = dt.train(base, ds, device=dev)
    b_l = dt.train(dict(base, deep_layout="legacy"), ds, device=dev)
    for k in ("feature", "threshold", "left", "right", "default_left"):
        check(np.array_equal(b_w.tree_arrays()[k], b_l.tree_arrays()[k]),
              f"leaf-wise fixture, wired vs legacy: {k!r} differs")
    dv = float(np.abs(b_w.arrays["value"] - b_l.arrays["value"]).max())
    check(dv <= 1e-5, f"leaf-wise fixture, wired vs legacy: values differ "
          f"by {dv}")

    p = dt.Params.from_dict(base)
    B, F = ds.mapper.total_bins, ds.num_features
    yt = torch.from_numpy(ds.y).to(dev)
    g, h = Binary().grad_hess(
        torch.full_like(yt, float(Binary().init_score(ds.y))), yt)
    args = (p, B, torch.from_numpy(ds.X_binned).to(dev), g, h,
            torch.ones(ds.num_rows, dtype=torch.bool, device=dev),
            torch.ones(F, dtype=torch.bool, device=dev))
    bat = leafwise_fast.grow_tree_leafwise_batched(*args)
    seq = grower.grow_tree(*args)
    for k in ("feature", "threshold", "left", "right", "default_left",
              "row_leaf", "max_depth"):
        check(torch.equal(bat[k], seq[k]),
              f"leaf-wise fixture, batched vs sequential: {k!r} differs")
    check(torch.equal(bat["value"], seq["value"])
          and torch.equal(bat["cover"], seq["cover"]),
          "leaf-wise fixture, batched vs sequential: values or covers "
          "differ")
    n_split = int((bat["feature"] >= 0).sum())

    b_d = dt.train({"objective": "binary", "num_trees": 3}, ds, device=dev)
    splits = (b_d.arrays["feature"] >= 0).sum(1)
    check(b_d.params.max_depth == 9 and b_d.params.growth == "leafwise"
          and leafwise_fast.leafwise_layout_supported(b_d.params, F, B, 1),
          f"reference defaults: max_depth {b_d.params.max_depth}, not the "
          "wired arm at 9")
    check(bool((splits == 30).all()), f"reference defaults: {splits} "
          "splits per tree, want 30 (31 leaves)")
    rep = {"wired_vs_legacy_max_value_diff": dv,
           "batched_vs_sequential": "bitwise equal",
           "splits_tree_1": n_split,
           "defaults": {"max_depth": b_d.params.max_depth,
                        "splits_per_tree": splits.tolist()}}
    print("leaf-wise fixture: " + json.dumps(rep), flush=True)
    report["leafwise_fixture"] = rep


BAGGED = {"objective": "binary", "growth": "depthwise", "max_depth": 8,
          "num_leaves": 255, "max_bins": 256, "learning_rate": 0.1,
          "subsample": 0.8, "colsample": 0.8, "seed": 0, "metric": "auc",
          "early_stopping_rounds": 5}


def record_hashes(rec):
    """Sorted 64-bit hashes of the records whose flag (byte 8) is set: two
    multisets of records are equal when these are."""
    import torch

    keep = rec[:, 8] == 1
    words = rec[keep].contiguous().view(torch.int64)
    mult = torch.tensor(
        [(0x9E3779B97F4A7C15 * (2 * i + 1)) % (1 << 63) | 1
         for i in range(words.shape[1])], dtype=torch.int64,
        device=rec.device)
    return torch.sort((words * mult).sum(1)).values


def check_bag_move(args, bag_rows: int) -> None:
    """Level 0's row move under a partial bag: every in-bag record is in
    the output exactly once, and no out-of-bag record is (every written
    row carries the flag)."""
    import torch

    from dryad_tpu_torch.engine import leafperm

    rec = args[0]
    check(int((rec[:, 8] == 1).sum()) == bag_rows,
          "bagged level 0: the input's flags are not the bag")
    out = leafperm.permute_records(*args)
    written = out.ne(0).any(1)
    check(bool((out[written, 8] == 1).all()),
          "bagged level 0: an out-of-bag record was moved")
    n_out = int(written.sum())
    check(n_out == bag_rows,
          f"bagged level 0: {n_out} records out, {bag_rows} in the bag")
    check(torch.equal(record_hashes(rec), record_hashes(out)),
          "bagged level 0: the moved records are not the in-bag records")


def profile_train(dt, params, ds, dv, dev, fname: str) -> dict:
    """Three iterations of the boosting loop (valid set ``dv`` or none,
    early stopping and a callback when ``dv`` is given) under
    torch.profiler, after a warm run: device time by op and kernel, and
    the device's busy share of the loop's wall time (``tree_seconds``, so
    set-up is outside it).  The table goes to chiprun_out/<fname>."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    params = dict(params, num_trees=3)
    valid = [dv] if dv is not None else None

    def run():
        return dt.train(params, ds, valid, device=dev,
                        callback=(lambda it, info: None) if dv else None)

    run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        b = run()

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU and dev_us(e) > 0]
    with open(os.path.join(OUT, fname), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=60))
    loop_ms = sum(b.tree_seconds) * 1e3
    total_us = sum(dev_us(e) for e in kernels)
    if total_us <= 0:
        return {"loop_wall_ms_3_trees": loop_ms, "device_ms": "not measured"}
    return {"loop_wall_ms_3_trees": loop_ms,
            "device_ms_incl_setup": total_us / 1e3,
            "ops": [[e.key[:50], dev_us(e) / 1e3, e.count]
                    for e in sorted(ops, key=dev_us, reverse=True)[:12]]}


def valid_path_costs(dt, booster, ds, dv, dev, reps: int) -> dict:
    """The costs the valid set adds to an iteration, alone: the new tree's
    packing and traversal over the valid rows (device ms), the device AUC
    (device ms), one eval fetch (host ms), and the host's Philox bag draw
    of one iteration at the training set's rows (host ms, paid with or
    without a valid set)."""
    import torch

    from dryad_tpu_torch.engine.loop_state import sample_masks
    from dryad_tpu_torch.engine.predict import add_tree, pack_words
    from dryad_tpu_torch.engine.train import binned_to_device
    from dryad_tpu_torch.metrics.device import make_evaluator

    t = booster.num_iterations - 1
    arr = {k: torch.from_numpy(v[t]).to(dev)
           for k, v in booster.arrays.items()}
    vXb = binned_to_device(dv.X_binned, dev)
    vs = torch.zeros(dv.num_rows, dtype=torch.float32, device=dev)
    depth = booster.params.max_depth

    def traverse():
        words = pack_words(arr["feature"], arr["threshold"], arr["left"],
                           arr["right"], arr["default_left"])
        return add_tree(words, arr["value"], vXb, vs, depth)

    traverse_ms = time_ms(traverse, reps)
    _, _, fn = make_evaluator("binary", "auc", dv, dev)
    vs = traverse()
    auc_ms = time_ms(lambda: fn(vs), reps)
    fetch = []
    for _ in range(3):
        v = fn(vs)
        sync()
        t0 = time.perf_counter()
        torch.stack([v]).cpu()
        fetch.append((time.perf_counter() - t0) * 1e3)
    p = booster.params
    draw = []
    for it in range(3):
        t0 = time.perf_counter()
        sample_masks(p, it, ds.num_rows, ds.num_features)
        draw.append((time.perf_counter() - t0) * 1e3)
    del vXb, vs
    return {"traverse_ms": traverse_ms, "auc_device_ms": auc_ms,
            "fetch_host_ms": sum(fetch) / 3,
            "bag_draw_host_ms": sum(draw) / 3}


def phase_bagged(dt, a, ds, Xv, yv, dev, report) -> tuple:
    """Phase 13: Higgs-10M bagged and validated, depthwise wired."""
    import numpy as np
    import torch

    from dryad_tpu_torch.engine import hist, leafperm
    from dryad_tpu_torch.engine import train as engine_train
    from dryad_tpu_torch.engine.loop_state import sample_masks
    from dryad_tpu_torch.metrics import auc
    from dryad_tpu_torch.metrics.device import auc_device

    params = dict(BAGGED, num_trees=a.bag_trees)
    t0 = time.perf_counter()
    dv = ds.bind(Xv, yv)
    bind_s = time.perf_counter() - t0
    calls = capture(dt, params, ds, dev,
                    {"hist": (hist, "hist_tiles"),
                     "perm": (leafperm, "permute_records")})
    check(len(calls["hist"]) == 9 and len(calls["perm"]) == 8,
          f"bagged capture tree made {len(calls['hist'])} histogram calls "
          f"and {len(calls['perm'])} row moves")
    bag_rows = int(np.count_nonzero(sample_masks(
        dt.Params.from_dict(params), 0, ds.num_rows, ds.num_features)[0]))
    root_args = calls["hist"][0][0]
    root = check_hist(root_args, "bagged hist root", a.reps)
    n_root = int(hist.hist_tiles(*root_args)[0, 2, 0].sum())
    check(root["P"] == 1 and n_root == bag_rows,
          f"bagged root: P={root['P']}, {n_root} rows counted, "
          f"{bag_rows} in the bag")
    print("K1 bagged root: " + json.dumps(root), flush=True)
    check_bag_move(calls["perm"][0][0], bag_rows)
    perm0 = check_perm(calls["perm"][0][0], a.reps)
    perm0.update(in_bag_rows=bag_rows,
                 out_of_bag_rows=ds.num_rows - bag_rows)
    print("K2 bagged level 0: " + json.dumps(perm0), flush=True)
    del calls
    torch.cuda.empty_cache()

    # the main path: bagged, validated, early stopping on the card's AUC;
    # the trainer's running valid scores are read through add_tree
    infos, vscore = [], {}
    real_add = engine_train.add_tree

    def spy_add(*args):
        vscore["last"] = real_add(*args)
        return vscore["last"]

    engine_train.add_tree = spy_add
    try:
        torch.cuda.reset_peak_memory_stats()
        from dryad_tpu_torch.engine import cuda_build

        cuda_build.reset_counts()
        booster = dt.train(params, ds, [dv], device=dev,
                           callback=lambda it, info: infos.append(info))
        launches = dict(cuda_build.counts)
        peak = torch.cuda.max_memory_allocated()
    finally:
        engine_train.add_tree = real_add
    n = booster.num_iterations
    check_launches(launches, {"hist": 9 * n, "perm": 8 * n}, "bagged")
    curve = [i["valid_auc"] for i in infos]
    check(len(curve) == n, "bagged: not every iteration was evaluated")
    again = []
    b2 = dt.train(params, ds, [dv], device=dev,
                  callback=lambda it, info: again.append(info))
    same_trees(booster, b2, "bagged")
    check(again == infos and b2.best_iteration == booster.best_iteration,
          "bagged: a second run's evals or best iteration differ")
    raw = dt.predict(booster, Xv, raw_score=True, num_iteration=n,
                     device=dev)
    check(np.array_equal(vscore["last"].cpu().numpy(), raw),
          "bagged: the trainer's valid scores differ from predict's")
    host_auc = auc(yv, raw)
    check(abs(curve[-1] - host_auc) <= 1e-5,
          f"bagged: last valid_auc {curve[-1]} vs host AUC {host_auc}")
    check(curve[-1] > curve[0] and curve[-1] > 0.70,
          f"bagged: AUC {curve[0]} -> {curve[-1]}")
    y_dev = torch.from_numpy(yv).to(dev)
    eval_ms = time_ms(lambda: auc_device(y_dev, vscore["last"]), a.reps)
    del vscore, y_dev
    plain = dict(params, early_stopping_rounds=0)
    no_valid = dt.train(plain, ds, device=dev)
    costs = valid_path_costs(dt, booster, ds, dv, dev, a.reps)
    print("bagged valid-path costs: " + json.dumps(costs), flush=True)
    prof = {"with_valid": profile_train(dt, params, ds, dv, dev,
                                        "profile_bagged_valid.txt"),
            "without_valid": profile_train(dt, plain, ds, None, dev,
                                           "profile_bagged.txt"),
            "tree": profile_tree(params, ds, dev, "profile_bagged_tree.txt")}
    print("bagged profiles: " + json.dumps(prof), flush=True)
    rep = {"with_valid": tree_summary(booster),
           "without_valid": tree_summary(no_valid),
           "valid_path": costs, "profile": prof,
           "auc_device_ms_1M": eval_ms, "peak_bytes": peak,
           "launches": launches, "trees": n,
           "best_iteration": booster.best_iteration,
           "auc": {"tree_1": curve[0], "last": curve[-1],
                   "host_last": host_auc}, "bind_seconds": bind_s,
           "hist_root": root, "perm_level0": perm0}
    print("bagged train: " + json.dumps(
        {k: v for k, v in rep.items() if k not in ("hist_root",
                                                   "perm_level0",
                                                   "profile")}),
          flush=True)
    print("bagged: second run bitwise equal; valid scores bitwise equal to "
          "predict; last valid_auc matches the host AUC", flush=True)
    report["bagged"] = rep
    return params, dv, launches, root, perm0


def phase_resume(dt, ds, dv, Xv, dev, params, report) -> dict:
    """Phase 14: checkpoint/resume on the card, the bagged config."""
    import tempfile

    import numpy as np

    from dryad_tpu_torch.checkpoint import Checkpointer
    from dryad_tpu_torch.engine import cuda_build

    class Crash(RuntimeError):
        pass

    T, crash_at = 10, 6
    params = dict(params, num_trees=T)
    straight_infos = []
    straight = dt.train(params, ds, [dv], device=dev,
                        callback=lambda it, info: straight_infos.append(info))
    check(straight.num_iterations == T, "resume: the straight run stopped "
          "early")

    def crash(it, info):
        if it == crash_at:
            raise Crash

    with tempfile.TemporaryDirectory(dir=OUT) as ckdir:
        try:
            dt.train(params, ds, [dv], device=dev, checkpoint_dir=ckdir,
                     checkpoint_every=3, callback=crash)
            fail("resume: the crash callback did not stop the run")
        except Crash:
            pass
        check(Checkpointer(ckdir).iterations() == [3, 6],
              "resume: checkpoints are not [3, 6]")
        infos = []
        t0 = time.perf_counter()
        cuda_build.reset_counts()
        resumed = dt.train(params, ds, [dv], device=dev,
                           checkpoint_dir=ckdir, checkpoint_every=3,
                           resume=True,
                           callback=lambda it, info: infos.append(info))
        launches = dict(cuda_build.counts)
        resume_s = time.perf_counter() - t0
        grown = T - crash_at
        check_launches(launches, {"hist": 9 * grown, "perm": 8 * grown},
                       "resume")
        same_trees(straight, resumed, "resume")
        check(infos == straight_infos[crash_at:]
              and resumed.best_iteration == straight.best_iteration,
              "resume: evals or best iteration differ from the straight run")
        raw = dt.predict(straight, Xv, raw_score=True, device=dev)
        check(np.array_equal(dt.predict(resumed, Xv, raw_score=True,
                                        device=dev), raw),
              "resume: predict differs from the straight run")
        path = os.path.join(ckdir, "model.dryad")
        resumed.save(path)
        loaded = dt.Booster.load(path)
        check(np.array_equal(dt.predict(loaded, Xv, raw_score=True,
                                        device=dev), raw),
              "resume: the loaded model file predicts differently")
    rep = {"trees": T, "crash_at": crash_at, "resume_seconds": resume_s,
           "launches": launches, "best_iteration": resumed.best_iteration}
    print("resume: " + json.dumps(rep), flush=True)
    print("resume: trees, evals, best iteration and predict bitwise equal "
          "to the straight run; the saved file predicts bitwise", flush=True)
    report["resume"] = rep
    return launches


def phase_bagged_legacy(dt, a, ds, Xv, yv, dev, report) -> tuple:
    """Phase 15: leaf-wise at the default depth (legacy arm), bagged."""
    import torch

    from dryad_tpu_torch.engine import hist, hist_nat
    from dryad_tpu_torch.engine.loop_state import sample_masks

    params = {"objective": "binary", "growth": "leafwise", "num_leaves": 255,
              "max_bins": 256, "learning_rate": 0.1, "subsample": 0.8,
              "seed": 0, "num_trees": a.bag_legacy_trees}
    calls = leafwise_capture(dt, params, ds, dev,
                             {"rows": (hist, "hist_rows"),
                              "nat": (hist_nat, "build_hist_nat")},
                             "bagged leaf-wise default")
    check(len(calls["rows"]) == 9 and len(calls["nat"]) == 4,
          f"bagged leaf-wise capture tree made {len(calls['rows'])} "
          f"row-mode and {len(calls['nat'])} natural-order calls")
    bag = torch.from_numpy(sample_masks(
        dt.Params.from_dict(params), 0, ds.num_rows,
        ds.num_features)[0]).to(dev)
    sel = calls["nat"][3][0][3]
    check(bool((sel[~bag] >= calls["nat"][3][1]["num_cols"]).all()),
          "bagged K3: an out-of-bag row kept a slot")
    buf = calls["rows"][-1][0][1]
    check(bool(bag[buf[buf < ds.num_rows]].all()),
          "bagged K1 row mode: an out-of-bag row is in the plan")
    nat = check_nat(calls["nat"][3], "bagged nat level 3", a.reps)
    check(nat["P"] == 8, f"bagged K3 P={nat['P']}")
    print("K3 bagged leaf-wise level 3: " + json.dumps(nat), flush=True)
    rows = check_rows(calls["rows"][-1][0], "bagged rows level 11", a.reps)
    check(rows["P"] == 2048, f"bagged K1 row mode P={rows['P']}")
    print("K1 rows bagged leaf-wise level 11: " + json.dumps(rows),
          flush=True)
    del calls
    torch.cuda.empty_cache()
    _, rep = train_and_check(dt, params, ds, Xv, yv, dev,
                             {"nat": 4 * a.bag_legacy_trees,
                              "hist_rows": 9 * a.bag_legacy_trees},
                             "bagged leaf-wise default")
    rep.update(nat_level=nat, rows_level=rows)
    report["bagged_leafwise_default"] = rep
    return rep["launches"], nat, rows



def phase_epsilon(dt, a, dev, report) -> tuple:
    """Phase 16: Epsilon-shaped regression through the legacy arm."""
    import numpy as np
    import torch

    from dryad_tpu_torch import datasets
    from dryad_tpu_torch.engine import hist
    from dryad_tpu_torch.engine.predict import predict_binned
    from dryad_tpu_torch.metrics import rmse

    t0 = time.perf_counter()
    X, y = datasets.epsilon_like(a.eps_rows + a.eps_holdout,
                                 num_features=EPS_FEATURES, seed=13)
    t_gen = time.perf_counter() - t0
    ds = dt.Dataset(X[:a.eps_rows], y[:a.eps_rows], max_bins=256)
    Xv_b = ds.mapper.transform(X[a.eps_rows:])
    yv = y[a.eps_rows:]
    del X, y
    t_data = time.perf_counter() - t0
    check(ds.num_features == EPS_FEATURES and ds.mapper.total_bins == 256,
          f"epsilon shape {ds.num_features} x {ds.mapper.total_bins} bins")
    print(f"epsilon data: {a.eps_rows} + {a.eps_holdout} x {EPS_FEATURES}, "
          f"generated in {t_gen:.1f} s, binned by {t_data:.1f} s", flush=True)
    params = {"objective": "regression", "growth": "depthwise",
              "max_depth": 6, "num_leaves": 63, "max_bins": 256,
              "num_trees": a.eps_trees}
    # 400k x 2000 u8 is 800 MB, past the natural-order gate: no K3
    n_nat, n_rows = legacy_calls(ds.num_rows, ds.num_features, 6, 63)
    calls = capture(dt, params, ds, dev, {"rows": (hist, "hist_rows")})
    check(len(calls["rows"]) == n_rows,
          f"epsilon capture tree made {len(calls['rows'])} row-mode calls")
    root = check_rows(calls["rows"][0][0], "eps rows root", a.reps)
    print("K1 rows epsilon root: " + json.dumps(root), flush=True)
    level = check_rows(calls["rows"][-1][0], "eps rows level 5", a.reps)
    print("K1 rows epsilon level 5: " + json.dumps(level), flush=True)
    if a.eps_rows == EPS_ROWS:
        check((n_nat, n_rows) == (0, 7), "the Epsilon matrix passed the K3 "
              "gate")
    del calls
    torch.cuda.empty_cache()

    booster, launches, peak = train_counted(dt, params, ds, dev)
    check_launches(launches, {"hist_rows": n_rows * a.eps_trees,
                              "nat": n_nat * a.eps_trees}, "epsilon")
    same_trees(booster, dt.train(params, ds, device=dev), "epsilon")
    r1 = rmse(yv, predict_binned(booster, Xv_b, device=dev,
                                 num_iteration=1)[:, 0])
    r_last = rmse(yv, predict_binned(booster, Xv_b, device=dev)[:, 0])
    std = float(np.std(yv))
    check(r_last < r1, f"epsilon: RMSE did not fall ({r1} -> {r_last})")
    check(r_last < std, f"epsilon: RMSE {r_last} >= label std {std}")
    rep = dict(tree_summary(booster), peak_bytes=peak, launches=launches,
               rmse={"tree_1": r1, "last": r_last, "label_std": std},
               data_seconds=t_data, gen_seconds=t_gen,
               rows_root=root, rows_level=level)
    print("epsilon train: " + json.dumps(
        {k: v for k, v in rep.items() if not k.startswith("rows_")}),
        flush=True)
    print("epsilon: second run bitwise equal", flush=True)
    prof = profile_tree(params, ds, dev, "profile_epsilon.txt")
    print("epsilon profile: " + json.dumps(prof), flush=True)
    rep["profile"] = prof
    report["epsilon"] = rep
    return launches, root, level


# the histogram kernels' launch shape and both bounds
_SHAPE_KEYS = ("smem_bytes", "blocks", "features_per_block",
               "bytes_bound_ms", "update_bound_ms")


def kernel_entry(name, source, replaces, launches, by_path, m, extra=None):
    e = {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches,
         "launches_by_path": by_path, "max_abs_err": m["max_abs_err"],
         "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
         "bound_by": m["bound_by"], "library_ms": m["library_ms"]}
    e.update({k: m[k] for k in _SHAPE_KEYS if k in m})
    if extra:
        e.update(extra)
    return e


def brief(m: dict) -> dict:
    return {k: m[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "max_abs_err", "P", *_SHAPE_KEYS)
            if k in m}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=HEADLINE_ROWS)
    ap.add_argument("--trees", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--eps-rows", type=int, default=EPS_ROWS)
    ap.add_argument("--eps-holdout", type=int, default=EPS_HOLDOUT)
    ap.add_argument("--eps-trees", type=int, default=20)
    ap.add_argument("--bag-trees", type=int, default=20)
    ap.add_argument("--bag-legacy-trees", type=int, default=5)
    a = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import dryad_tpu_torch as dt
    from dryad_tpu_torch import datasets
    from dryad_tpu_torch.engine import cuda_build

    check(min(a.trees, a.eps_trees, a.bag_trees, a.bag_legacy_trees) >= 2,
          "--trees, --eps-trees, --bag-trees and --bag-legacy-trees must "
          "be >= 2 (metrics must move)")
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"card: {smi}", flush=True)
    report: dict = {"card": smi, "kind": kind, "rows": a.rows,
                    "trees": a.trees, "seed": a.seed, "eps_rows": a.eps_rows,
                    "eps_trees": a.eps_trees}

    # ---- 1. build ---------------------------------------------------------
    cuda_build.build_all()
    print(f"kernels built in {cuda_build.build_seconds:.2f} s", flush=True)
    report["build_seconds"] = cuda_build.build_seconds
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "ptxas.txt"), "w") as f:
        for name, log in cuda_build.build_log.items():
            f.write(f"== {name}.cu\n{log}\n")
    report["sass_atomics"] = sass_atomics()
    print("SASS atomics: " + json.dumps(report["sass_atomics"]), flush=True)

    # ---- 2. Higgs data ----------------------------------------------------
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

    # ---- 3-6. the wired path ----------------------------------------------
    w_params, w_booster, w_launches, w_level = phase_wired(
        dt, a, ds, Xv, yv, dev, report)
    # ---- 7. wired vs legacy, tie-free fixture -----------------------------
    phase_fixture(dt, dev, report)
    # ---- 8-9. the legacy plan arm at the headline config ------------------
    l_launches, nat, rows = phase_legacy(dt, a, ds, Xv, yv, dev, w_params,
                                         w_booster, report)
    # ---- 10-11. leaf-wise growth at Higgs-10M, wired and default depth ---
    lw_launches, lw_level, lw_perm = phase_leafwise_wired(
        dt, a, ds, Xv, yv, dev, report)
    ld_launches, ld_nat, ld_rows = phase_leafwise_default(
        dt, a, ds, Xv, yv, dev, report)
    # ---- 12. the leaf-wise fixture ----------------------------------------
    phase_leafwise_fixture(dt, dev, report)
    # ---- 13-15. the training loop: bagged and validated, resume, bagged
    # legacy arm -----------------------------------------------------------
    bag_params, dv, b_launches, b_root, b_perm = phase_bagged(
        dt, a, ds, Xv, yv, dev, report)
    r_launches = phase_resume(dt, ds, dv, Xv, dev, bag_params, report)
    del dv
    bl_launches, bl_nat, bl_rows = phase_bagged_legacy(dt, a, ds, Xv, yv,
                                                       dev, report)
    # ---- 16. Epsilon-shaped regression, the Higgs tensors freed -----------
    del ds, Xv, yv, w_booster
    gc.collect()
    torch.cuda.empty_cache()
    e_launches, e_root, e_level = phase_epsilon(dt, a, dev, report)

    by_path = {"wired": w_launches, "legacy_higgs": l_launches,
               "leafwise_wired": lw_launches, "leafwise_default": ld_launches,
               "bagged_wired": b_launches, "resume": r_launches,
               "bagged_leafwise_default": bl_launches,
               "epsilon": e_launches}

    def launches(k):
        return sum(p[k] for p in by_path.values())

    def paths(k):
        return {n: p[k] for n, p in by_path.items()}

    root = report["hist_root"]
    perm = report["perm"]
    kernels = [
        kernel_entry("hist", "dryad_tpu_torch/csrc/hist.cu",
                     "dryad_tpu/engine/pallas_hist.py:140", launches("hist"),
                     paths("hist"), w_level,
                     {"mode": "layout", "root": brief(root),
                      "leafwise_level": brief(lw_level),
                      "bagged_root": brief(b_root)}),
        kernel_entry("hist_rows", "dryad_tpu_torch/csrc/hist.cu",
                     "dryad_tpu/engine/pallas_hist.py:140",
                     launches("hist_rows"), paths("hist_rows"), rows,
                     {"mode": "rows", "leafwise_level": brief(ld_rows),
                      "bagged_leafwise_level": brief(bl_rows),
                      "epsilon_root": brief(e_root),
                      "epsilon_level": brief(e_level)}),
        kernel_entry("perm", "dryad_tpu_torch/csrc/perm.cu",
                     "dryad_tpu/engine/leafperm.py:94", launches("perm"),
                     paths("perm"), perm,
                     {"leafwise_level": brief(lw_perm),
                      "bagged_level0": brief(b_perm)}),
        kernel_entry("nat", "dryad_tpu_torch/csrc/hist_nat.cu",
                     "dryad_tpu/engine/pallas_hist.py:719", launches("nat"),
                     paths("nat"), nat, {"leafwise_level": brief(ld_nat),
                                         "bagged_leafwise_level":
                                             brief(bl_nat)}),
    ]
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(OUT, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"chip_smoke: all phases passed in {report['seconds']:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
