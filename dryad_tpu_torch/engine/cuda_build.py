"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``.  The build
goes to ``dryad_tpu_torch/_build/`` (git-ignored) at first use; a library is
named after the hash of its source and flags, so an edited source is
rebuilt and an unchanged one is reused (the hash covers the shared
``csrc/*.cuh`` headers too).  All sources are compiled in parallel, one
``nvcc`` process each.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc``.

``counts`` holds one launch counter per kernel wrapper: ``hist`` (K1,
layout mode), ``hist_rows`` (K1, row mode), ``perm`` (K2) and ``nat`` (K3).
A wrapper adds one where it launches its kernel and nowhere else.
``launch_info`` keeps the shape of each histogram kernel's last launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("hist", "perm", "hist_nat")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

counts = {"hist": 0, "hist_rows": 0, "perm": 0, "nat": 0}
launch_info: dict[str, dict] = {}
build_seconds: float | None = None
build_log: dict[str, str] = {}
_libs: dict[str, ctypes.CDLL] = {}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    digest = digest.hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{digest[:16]}.so")


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every missing library in parallel, then load all of them."""
    global build_seconds
    if len(_libs) == len(SOURCES):
        return _libs
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp,
             os.path.join(CSRC, name + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for name in SOURCES:
        _libs[name] = ctypes.CDLL(lib_path(name))
    _declare(_libs)
    build_seconds = time.perf_counter() - t0
    return _libs


def _declare(libs: dict[str, ctypes.CDLL]) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = libs["hist"].dryad_hist_tiles
    # rec, src, tile_leaf, n_sel, n_used, acc, F, B, itemsize, shift, out,
    # P, info, stream
    fn.argtypes = [p, p, p, i, p, p, i, i, i, p, p, i, p, p]
    fn.restype = i
    fn = libs["hist"].dryad_hist_rows
    # recs, rec_words, n_rows, buf, src, tile_leaf, n_sel, n_used, acc,
    # F, B, itemsize, shift, out, P, info, stream
    fn.argtypes = [p, i, i, p, p, p, i, p, p, i, i, i, p, p, i, p, p]
    fn.restype = i
    fn = libs["hist_nat"].dryad_hist_nat
    # xt, itemsize, n_pad, g, h, sel, n_rows, acc, F, B, P, shift, out,
    # info, stream
    fn.argtypes = [p, i, ll, p, p, p, i, p, i, i, i, p, p, p, p]
    fn.restype = i
    fn = libs["perm"].dryad_permute_records
    # rec, pos, dstl, dstr, out, n_tiles, cap_rows, stream
    fn.argtypes = [p, p, p, p, p, i, i, p]
    fn.restype = i


def lib(name: str) -> ctypes.CDLL:
    return build_all()[name]


def launch_hist(key: str, fn, dev, *args) -> None:
    """Launch a histogram kernel through its C entry
    ``fn(*args, info, stream)``: count the launch under ``key``, raise on a
    CUDA error, and keep the launch's shape in ``launch_info[key]``
    (shared-memory bytes per block, blocks, features per block)."""
    info = (ctypes.c_int * 3)()
    stream = torch.cuda.current_stream(dev).cuda_stream
    counts[key] += 1
    check(fn(*args, ctypes.addressof(info), stream), f"{key} kernel")
    launch_info[key] = {"smem_bytes": info[0], "blocks": info[1],
                        "features_per_block": info[2]}


def check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
