"""Where the histogram kernels' time goes on the card: staging against
adds, the card's shared-atomic rate, and what a wrapper call costs the host.

    python dryad_tpu_torch/tools/hist_split.py [--root DIR] [--rows N]
        [--reps R] [--only REGEX] [--no-split] [--host] [--trees N]
        [--out FILE]

Times K1 (``csrc/hist.cu``, both modes) and K3 (``csrc/hist_nat.cu``)
through their wrappers at the shapes of PERF.md's kernel table
(``SHAPES``), on inputs made from a seed: Higgs-shaped bins (``higgs_like``
binned to 256 bins, ``rows`` rows; P=128 spreads all of them over 128
leaves), uniform bins at the Epsilon, MSLR, Covertype and Criteo widths
and fixtures, and the rows of those configurations' generators binned as
``chip_smoke.py`` bins them (the ``_data`` shapes: skewed columns put many
rows on one cell).  Each kernel is built three ways (``HIST_SPLIT``, a
switch of ``csrc/hist_accum.cuh``): as the port runs it, with every add
compiled out (staging only), and adding its first stage again in place
of each later one (adds only).  A probe (``probe_atomics.cu``, beside this
file) gives the card's shared-memory atomic rate: 32-bit adds per SM and
clock, each lane in its own bank, with the returned value used, unused,
or chained into the next add; at random words; each lane in its own bank
at a random word there; and in K1's pattern of five adds.  ``--only
REGEX`` keeps the shapes whose name it matches.

``--host`` also gives, per shape, the host's milliseconds a wrapper call
(the calls issued back to back, the clock stopped before the card is
waited on; least and median of 15 batches) and the card's
(``torch.profiler``: the device time of the call's kernels), with the
same of one ``index_add_`` on the same rows (``chip_smoke.py``'s library
yardstick).  ``--trees N`` times ``N`` rounds of the multiclass
fixture's legacy arm (``chip_smoke.py``'s phase 19: 50k Covertype-like
rows, K=3, 64 bins, depthwise depth 8, K3 and K1 row mode) five times
after a warm-up, as trees a second.

``--root DIR`` times the package found in DIR (a ``git archive`` of
another commit: its kernels built from its own sources) through the same
public wrappers; by default the checkout this file lies in.  ``--no-split``
times only the kernels as they run.  Every kernel time is CUDA events
around ``reps`` calls after one warm-up call, on the card; nothing here
runs on a CPU.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import json
import os
import re
import subprocess
import sys
import time

SPLITS = {0: "kernel", 1: "staging_only", 2: "adds_only"}
PROBE_MODES = {0: "returned", 1: "unused", 2: "chained", 3: "random_words",
               4: "own_bank_random_word", 5: "k1_pattern"}
PROBE_ITERS = 4096
_HERE = os.path.dirname(os.path.abspath(__file__))


def _time_ms(torch, fn, reps: int) -> float:
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


def _build(cuda_build, name: str, split: int, src_dir: str):
    """Start ``nvcc`` on <src_dir>/<name>.cu with ``HIST_SPLIT=split``;
    returns the library's path (under the build directory's ``split/``)
    and the process, or None for a library already built."""
    if src_dir == cuda_build.CSRC:
        base = os.path.basename(cuda_build.lib_path(name))[:-3]
    else:
        with open(os.path.join(src_dir, name + ".cu"), "rb") as f:
            base = f"{name}-{hashlib.sha256(f.read()).hexdigest()[:16]}"
    out = os.path.join(cuda_build.BUILD_DIR, "split", f"{base}-{split}.so")
    if os.path.exists(out):
        return out, None
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
         f"-DHIST_SPLIT={split}", "-o", out,
         os.path.join(src_dir, name + ".cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, proc


def _build_splits(cuda_build, splits) -> dict:
    """{split label: {"hist": CDLL, "hist_nat": CDLL, "perm": CDLL}} for
    each ``HIST_SPLIT`` value, each declared as ``cuda_build`` declares its
    own, plus the probe under "probe"."""
    jobs = {}
    for s in splits:
        for name in ("hist", "hist_nat"):
            jobs[(s, name)] = _build(cuda_build, name, s, cuda_build.CSRC)
    jobs["probe"] = _build(cuda_build, "probe_atomics", 0, _HERE)
    for key, (path, proc) in jobs.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {key}:\n{log}")
    libs = {}
    for s in splits:
        d = {"perm": cuda_build.lib("perm"),
             "hist": ctypes.CDLL(jobs[(s, "hist")][0]),
             "hist_nat": ctypes.CDLL(jobs[(s, "hist_nat")][0])}
        cuda_build._declare(d)
        libs[SPLITS[s]] = d
    probe = ctypes.CDLL(jobs["probe"][0])
    p, i = ctypes.c_void_p, ctypes.c_int
    probe.dryad_probe_atomics.argtypes = [i, i, i, p, p, p]
    probe.dryad_probe_atomics.restype = i
    libs["probe"] = probe
    return libs


def probe_atomics(torch, probe, n_sm: int) -> dict:
    """Shared 32-bit atomic adds per SM and clock, by mode (module doc)."""
    dev = torch.device("cuda")
    cycles = torch.zeros(n_sm, dtype=torch.int64, device=dev)
    sink = torch.zeros(n_sm * 1024, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {}
    for mode, name in PROBE_MODES.items():
        def run():
            rc = probe.dryad_probe_atomics(mode, PROBE_ITERS, n_sm,
                                           cycles.data_ptr(),
                                           sink.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"probe: CUDA error {rc}")
        ms = _time_ms(torch, run, 5)
        cyc = float(cycles.double().mean())
        adds = 1024.0 * PROBE_ITERS
        out[name] = {"adds_per_sm_clock": adds / cyc, "cycles": cyc,
                     "ms": ms, "adds_per_s": adds * n_sm / (ms * 1e-3)}
    return out


# (kind, source, rows, features, bins, itemsize, slots, fraction): the
# shapes of PERF.md's kernel table.  "higgs" rows at 0 rows are the tool's
# Higgs-binned draw, "uniform" uniform bins, the other sources the rows of
# chip_smoke.py's generators binned as its phases bin them.  The fraction
# is of rows valid (layout), planned (rows) or kept (nat); the rest are
# dead.
SHAPES = {
    "k1_layout_p1": ("layout", "higgs", 0, 0, 256, 1, 1, 1.0),
    "k1_layout_p128": ("layout", "higgs", 0, 0, 256, 1, 128, 1.0),
    "k1_layout_bag_root": ("layout", "higgs", 0, 0, 256, 1, 1, 0.8),
    "k1_layout_cov_root": ("layout", "uniform", 581_000, 54, 256, 1, 1, 1.0),
    "k1_layout_cov_p32": ("layout", "uniform", 581_000, 54, 256, 1, 32, 1.0),
    "k1_layout_criteo_root": ("layout", "uniform", 10_000_000, 39, 256, 1, 1,
                              1.0),
    "k1_layout_1024_p128": ("layout", "uniform", 2_000_000, 28, 1024, 2, 128,
                            1.0),
    "k1_rows_p128": ("rows", "higgs", 0, 0, 256, 1, 128, 1.0),
    "k1_rows_p2048": ("rows", "higgs", 0, 0, 256, 1, 2048, 0.5),
    "k1_rows_eps_root": ("rows", "uniform", 300_000, 2000, 256, 1, 1, 1.0),
    "k1_rows_eps_p32": ("rows", "uniform", 300_000, 2000, 256, 1, 32, 0.5),
    "k1_rows_mslr_root": ("rows", "uniform", 2_270_000, 136, 256, 1, 1, 1.0),
    "k1_rows_mslr_p512": ("rows", "uniform", 2_270_000, 136, 256, 1, 512,
                          0.3),
    "k1_rows_cov_fixture": ("rows", "uniform", 50_000, 54, 256, 1, 127, 0.5),
    "k1_rows_criteo_fixture": ("rows", "uniform", 50_000, 39, 256, 1, 32,
                               0.5),
    "k3_p8": ("nat", "higgs", 0, 0, 256, 1, 8, 0.36),
    "k3_p16": ("nat", "higgs", 0, 0, 256, 1, 16, 0.5),
    "k3_mslr_p8": ("nat", "uniform", 2_270_000, 136, 256, 1, 8, 0.48),
    "k3_cov_fixture": ("nat", "uniform", 50_000, 54, 256, 1, 16, 0.5),
    "k3_criteo_fixture": ("nat", "uniform", 50_000, 39, 256, 1, 16, 0.5),
    "k3_modes_fixture": ("nat", "uniform", 50_000, 28, 256, 1, 16, 0.5),
    # the same shapes on the rows and bin widths of chip_smoke.py's
    # phases: the fixtures at 64 bins (Covertype's one-hot indicators,
    # Criteo's sparse and Zipf-skewed columns), Covertype and MSLR at 256
    "k1_layout_cov_root_data": ("layout", "covertype", 581_000, 54, 256, 1,
                                1, 1.0),
    "k1_layout_cov_p32_data": ("layout", "covertype", 581_000, 54, 256, 1,
                               32, 1.0),
    "k1_rows_mslr_root_data": ("rows", "mslr", 0, 136, 256, 1, 1, 1.0),
    "k1_rows_mslr_p512_data": ("rows", "mslr", 0, 136, 256, 1, 512, 0.3),
    "k1_rows_cov_fixture_data": ("rows", "covertype", 50_000, 54, 64, 1, 127,
                                 1.0),
    "k1_rows_criteo_fixture_data": ("rows", "criteo", 50_000, 39, 64, 1, 32,
                                    1.0),
    "k1_rows_modes_fixture_data": ("rows", "higgs", 50_000, 28, 64, 1, 127,
                                   1.0),
    "k3_cov_fixture_data": ("nat", "covertype", 50_000, 54, 64, 1, 16, 1.0),
    "k3_criteo_fixture_data": ("nat", "criteo", 50_000, 39, 64, 1, 16, 1.0),
    "k3_modes_fixture_data": ("nat", "higgs", 50_000, 28, 64, 1, 16, 1.0),
}


def _binned(source: str, N: int, B: int, seed: int):
    """(N, F) bins of ``source``'s rows at B bins (chip_smoke.py's
    generators and seeds), as a numpy array."""
    from dryad_tpu_torch import datasets
    from dryad_tpu_torch.dataset import Dataset

    if source == "covertype":
        X, y = datasets.covertype_like(N, 54, 3 if N < 100_000 else 7,
                                       seed=43 if N < 100_000 else seed)
        return Dataset(X, y, max_bins=B).X_binned
    if source == "criteo":
        csr, y, cat = datasets.criteo_like(N, seed=43)
        return Dataset(None, y, csr=csr, categorical_features=cat,
                       max_bins=B).X_binned
    if source == "mslr":
        X, y, _ = datasets.mslr_like(9_460, (5, 234), 136, seed=seed)
        return Dataset(X, y, max_bins=B).X_binned
    X, y = datasets.higgs_like(N, seed=43)
    return Dataset(X, y, max_bins=B).X_binned


def _library(torch, leaf, valid, g, h, Xb, P: int, B: int):
    """The library yardstick of ``chip_smoke.py``'s ``library_ms``: one
    ``index_add_`` of the live (g, h, 1) rows into flat (leaf, feature,
    bin) cells, on precomputed cells; returns the call."""
    F = Xb.shape[1]
    dev = Xb.device
    cell = (Xb.long() + (leaf.long()[:, None] * F
                         + torch.arange(F, device=dev)) * B)[valid]
    vals = torch.stack([g[valid], h[valid], torch.ones_like(g[valid])],
                       -1)[:, None, :].expand(-1, F, -1).reshape(-1, 3)
    acc = torch.zeros((P * F * B, 3), device=dev)
    cell = cell.reshape(-1)
    return lambda: acc.index_add_(0, cell, vals)


def make_inputs(torch, rows: int, seed: int, dev=None) -> dict:
    """name -> a function that makes one timed call's inputs at PERF.md's
    shapes (``SHAPES``), on ``dev`` (the card unless given): (wrapper,
    args, kwargs, a function that makes the library's call on the same
    rows).  Higgs shapes take ``rows`` rows."""
    import numpy as np

    from dryad_tpu_torch import datasets
    from dryad_tpu_torch.dataset import Dataset
    from dryad_tpu_torch.engine import hist, hist_nat, leafperm, tile_plan

    dev = torch.device("cuda") if dev is None else dev
    T = hist.TILE_ROWS

    @functools.cache
    def higgs():
        X, y = datasets.higgs_like(rows, seed=seed)
        return torch.from_numpy(np.ascontiguousarray(
            Dataset(X, y, max_bins=256).X_binned)).to(dev)

    def build(name, kind, source, N, F, B, isz, P, frac):
        gen = torch.Generator(device=dev).manual_seed(seed + len(name))
        if source == "higgs" and N == 0:
            Xb = higgs()
            N, F = Xb.shape
        elif source != "uniform":
            import numpy as np

            Xb = torch.from_numpy(np.ascontiguousarray(
                _binned(source, N, B, seed))).to(dev)
            N, F = Xb.shape
        else:
            Xb = torch.randint(0, B, (N, F), generator=gen, device=dev,
                               dtype=torch.int32 if isz == 2 else torch.uint8)
        g = torch.randn(N, generator=gen, device=dev) * 0.5
        h = torch.rand(N, generator=gen, device=dev) * 0.2 + 0.05
        shift = hist.fixed_point_shift(g, h)
        on = torch.rand(N, generator=gen, device=dev) < frac
        if kind == "layout":
            rec = leafperm.make_layout_records(Xb, g, h, on)
            rec = torch.cat([rec, rec.new_zeros(((-N) % T, hist.REC_WB))])
            n_tiles = rec.shape[0] // T
            src = torch.arange(n_tiles, dtype=torch.int32, device=dev)
            tl = (torch.arange(n_tiles, device=dev) * P // n_tiles).to(
                torch.int32)
            return (hist.hist_tiles, (rec, src, tl, P, B, F, isz, shift), {},
                    lambda: _library(torch, tl.repeat_interleave(T)[:N], on,
                                     g, h, Xb, P, B))
        sel = torch.randint(0, P, (N,), generator=gen, device=dev)

        def library():
            return _library(torch, sel, on, g, h, Xb, P, B)

        if kind == "rows":
            buf, tl, _ = tile_plan.tile_plan(torch.where(on, sel, P), N, P)
            return hist.hist_rows, (tile_plan.make_records(Xb, g, h), buf,
                                    tl, P, B, F, isz, shift), {}, library
        kept = torch.where(on, sel, hist_nat.NAT_DROP).to(torch.int32)
        return (hist_nat.build_hist_nat,
                (hist_nat.natural_tiles(Xb), g, h, kept, shift),
                dict(total_bins=B, num_features=F, num_cols=P), library)

    return {name: (lambda name=name, spec=spec: build(name, *spec))
            for name, spec in SHAPES.items()}


def _host_ms(torch, fn, reps: int, batches: int = 15) -> dict:
    """The host's milliseconds a call: ``reps`` calls issued back to back,
    the clock stopped before the card is waited on; the least and the
    median over ``batches`` (a shared host's other work only adds)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out.append((time.perf_counter() - t0) * 1e3 / reps)
        torch.cuda.synchronize()
    out.sort()
    return {"min": out[0], "median": out[len(out) // 2]}


def _device_ms(torch, fn, reps: int) -> dict:
    """The card's milliseconds a call, by kernel name, and their sum."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = (getattr(ev, "device_time_total", 0)
              or getattr(ev, "cuda_time_total", 0))
        if us:
            out[ev.key[:48]] = us / reps / 1000.0
    out["total"] = sum(out.values())
    return out


def fixture_trees(torch, rounds: int) -> dict:
    """Trees a second of the multiclass fixture's legacy arm (module doc):
    one warm-up training, then five timed ones."""
    import dryad_tpu_torch as dt
    from dryad_tpu_torch import datasets

    K = 3
    X, y = datasets.covertype_like(50_000, 54, K, seed=43)
    ds = dt.Dataset(X, y, max_bins=64)
    params = {"objective": "multiclass", "num_class": K,
              "num_trees": rounds, "num_leaves": 128, "max_bins": 64,
              "growth": "depthwise", "max_depth": 8,
              "deep_layout": "legacy"}
    dev = torch.device("cuda")
    dt.train(dict(params, num_trees=1), ds, device=dev)
    torch.cuda.synchronize()
    out = []
    for _ in range(5):
        t0 = time.perf_counter()
        dt.train(params, ds, device=dev)
        torch.cuda.synchronize()
        out.append(K * rounds / (time.perf_counter() - t0))
    return {"rounds": rounds, "trees": K * rounds, "trees_per_s": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(_HERE)))
    ap.add_argument("--no-split", action="store_true")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--trees", type=int, default=0)
    ap.add_argument("--only", default="")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p) != _HERE]
    sys.path.insert(0, os.path.abspath(a.root))
    import torch

    if not torch.cuda.is_available():
        print("hist_split: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from dryad_tpu_torch.engine import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all()
    props = torch.cuda.get_device_properties(0)
    report = {"root": os.path.dirname(os.path.dirname(os.path.dirname(
                  os.path.abspath(cuda_build.__file__)))),
              "card": subprocess.run(
                  ["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"], capture_output=True,
                  text=True).stdout.strip(),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "rows": a.rows, "seed": a.seed, "reps": a.reps}
    splits = (0,) if a.no_split else tuple(SPLITS)
    libs = {} if a.no_split else _build_splits(cuda_build, splits)
    if libs:
        report["atomics"] = probe_atomics(torch, libs["probe"],
                                          props.multi_processor_count)
    calls = {k: v for k, v in make_inputs(torch, a.rows, a.seed).items()
             if re.search(a.only, k)}
    report["input_seconds"] = time.perf_counter() - t0
    key = {"hist_tiles": "hist", "hist_rows": "hist_rows",
           "build_hist_nat": "nat"}
    times = {}
    own = dict(cuda_build._libs)
    try:
        for name, make in calls.items():
            fn, args, kw, library = make()
            times[name] = {}
            for s in splits:
                cuda_build._libs.update(libs.get(SPLITS[s], own))
                times[name][SPLITS[s]] = _time_ms(
                    torch, lambda: fn(*args, **kw), a.reps)
            cuda_build._libs.update(own)
            if a.host:
                times[name]["host"] = _host_ms(
                    torch, lambda: fn(*args, **kw), a.reps)
                times[name]["device"] = _device_ms(
                    torch, lambda: fn(*args, **kw), a.reps)
                lib = library()
                times[name]["library"] = _time_ms(torch, lib, a.reps)
                times[name]["library_device"] = _device_ms(
                    torch, lib, a.reps)["total"]
                del lib
            times[name]["shape"] = dict(
                cuda_build.launch_info.get(key[fn.__name__], {}))
            print(name, json.dumps(times[name]), flush=True)
            del fn, args, kw, library
    finally:
        cuda_build._libs.update(own)
    report["ms"] = times
    if a.trees:
        report["fixture_trees"] = fixture_trees(torch, a.trees)
        print("fixture_trees", json.dumps(report["fixture_trees"]),
              flush=True)
    report["seconds"] = time.perf_counter() - t0
    text = json.dumps(report, indent=1, default=str)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
