"""ctypes bridge to the native host layer (``src/dryad_native.cpp``).

The counterpart of ``dryad_tpu/native/__init__.py``: the quantile sketch of
a numerical column and the dense binning of a matrix through a frozen
``BinMapper``, in C++.  The numpy path of ``data/sketch.py`` is the spec;
this is the fast path and matches it bit for bit
(``tests/test_torch_native.py``).  The reference's native tree traversal
is not copied: the port's CPU predict is ``device="cpu"`` in torch.  The
sketch's sort is numpy's (the reference's C++ ``std::sort`` ran 3.7x
slower than numpy's vectorised sort on the card's host); the C++ keeps the
dedup and the edges, one pass over the sorted values.

Build.  At first use the library is compiled with ``g++ -O3 -fPIC -shared
-std=c++17`` into ``dryad_tpu_torch/_build/`` (git-ignored), named after
the hash of its source and flags, so an edited source is rebuilt and an
unchanged one reused.  The compiler writes a temporary file that is then
renamed into place, so processes that build at once each load a whole
library.  Nothing is built or loaded at import.

When it falls back, and when it raises.  ``DRYAD_NATIVE=0`` (read at each
call) and a machine with no ``g++`` on ``PATH`` take the numpy path:
``sketch_numerical`` and ``bin_matrix`` return None.  A build that fails
while ``g++`` is present raises with the compiler's log, and so does a
library whose ABI version differs from ``_ABI_VERSION``; neither falls
back quietly.

``counts`` (``sketch``: columns sketched, ``bin``: matrices binned) says
which path ran.  ``ctypes`` releases the interpreter lock during a call,
so the sketch runs per column inside ``data/sketch.py``'s threaded
feature blocks, and ``bin_matrix`` bins blocks of rows on a thread pool;
neither changes a bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "src", "dryad_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
# must equal dryad_abi_version() in the library
_ABI_VERSION = 2
# rows binned per native call (one thread's unit), and the most threads
_BLOCK_ROWS = 65536
_MAX_THREADS = 8

counts = {"sketch": 0, "bin": 0}
build_seconds: Optional[float] = None
build_log = ""

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_i64 = ctypes.c_int64
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")


def reset_counts() -> None:
    with _lock:
        for k in counts:
            counts[k] = 0


def _count(key: str) -> None:
    with _lock:
        counts[key] += 1


def _enabled() -> bool:
    return os.environ.get("DRYAD_NATIVE", "1") != "0"


def lib_path() -> str:
    """The library's path: named after the hash of its flags and source."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"dryad_native-{digest.hexdigest()[:16]}.so")


def _build(cxx: str, out: str) -> None:
    global build_seconds, build_log
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    build_log = res.stdout
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed to build the native host layer "
                           f"({SOURCE}):\n{res.stdout}")
    os.replace(tmp, out)            # atomic: a parallel loader sees all
    build_seconds = time.perf_counter() - t0


def _declare(lib: ctypes.CDLL) -> None:
    lib.dryad_abi_version.restype = _i64
    lib.dryad_abi_version.argtypes = []
    version = lib.dryad_abi_version()
    if version != _ABI_VERSION:
        raise RuntimeError(
            f"native host layer ABI {version} != {_ABI_VERSION} expected "
            f"({lib_path()}); delete the stale library to rebuild it")
    lib.sketch_sorted.restype = _i64
    lib.sketch_sorted.argtypes = [_f32p, _i64, _i64, _f32p]
    lib.bin_matrix.restype = None
    lib.bin_matrix.argtypes = [_f32p, _i64, _i64, _f32p, _i64p, _f32p,
                               _i32p, _i64p, _u8p, _i32p, _u16p]


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, building it first if needed; None when the
    native path is off or no ``g++`` is on ``PATH``."""
    global _lib
    if not _enabled():
        return None
    if _lib is not None:
        return _lib
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    with _lock:
        if _lib is None:
            path = lib_path()
            if not os.path.exists(path):
                _build(cxx, path)
            lib = ctypes.CDLL(path)
            _declare(lib)
            _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def sketch_numerical(col: np.ndarray, max_bins: int) -> Optional[np.ndarray]:
    """Native numerical quantile sketch: ascending float32 edges, or None
    on the numpy path.  The finite values are sorted by numpy, as the
    numpy path sorts them, then deduplicated and cut in C++."""
    lib = _load()
    if lib is None:
        return None
    col = np.asarray(col, np.float32)
    finite = col[np.isfinite(col)]          # a contiguous copy
    finite.sort()
    out = np.empty(max(int(max_bins), 2), np.float32)
    k = lib.sketch_sorted(finite, finite.size, int(max_bins), out)
    _count("sketch")
    return out[:k].copy()


def _tables(mapper) -> tuple:
    """The mapper's recipes as the flat arrays ``bin_matrix`` reads."""
    feats = mapper.features
    F = len(feats)
    edge_offsets = np.zeros(F + 1, np.int64)
    cat_offsets = np.zeros(F + 1, np.int64)
    for f, fb in enumerate(feats):
        edge_offsets[f + 1] = edge_offsets[f] + fb.edges.size
        cat_offsets[f + 1] = cat_offsets[f] + fb.cat_values.size
    edges = np.empty(max(int(edge_offsets[-1]), 1), np.float32)
    catv = np.empty(max(int(cat_offsets[-1]), 1), np.float32)
    catb = np.empty(max(int(cat_offsets[-1]), 1), np.int32)
    for f, fb in enumerate(feats):
        edges[edge_offsets[f]:edge_offsets[f + 1]] = fb.edges
        catv[cat_offsets[f]:cat_offsets[f + 1]] = fb.cat_values
        catb[cat_offsets[f]:cat_offsets[f + 1]] = fb.cat_bins
    is_cat = np.ascontiguousarray(mapper.is_categorical, np.uint8)
    overflow = np.array([fb.overflow_bin for fb in feats], np.int32)
    return edges, edge_offsets, catv, catb, cat_offsets, is_cat, overflow


def bin_matrix(X: np.ndarray, mapper) -> Optional[np.ndarray]:
    """Native dense binning through a frozen (plain) ``BinMapper``: (N, F)
    bin ids of ``mapper.bin_dtype``, or None on the numpy path.  Blocks of
    ``_BLOCK_ROWS`` rows run on a thread pool."""
    lib = _load()
    if lib is None:
        return None
    X = np.ascontiguousarray(X, np.float32)
    n, F = X.shape
    if F != mapper.num_features:
        raise ValueError(f"X must be (N, {mapper.num_features}), got "
                         f"{X.shape}")
    tables = _tables(mapper)
    out = np.empty((n, F), mapper.bin_dtype)

    def block(r0: int) -> None:
        r1 = min(r0 + _BLOCK_ROWS, n)
        buf = np.empty((r1 - r0, F), np.uint16)
        lib.bin_matrix(X[r0:r1], r1 - r0, F, *tables, buf)
        out[r0:r1] = buf

    starts = range(0, n, _BLOCK_ROWS) if F else range(0)
    threads = min(_MAX_THREADS, os.cpu_count() or 1, len(starts))
    if threads <= 1:
        for r0 in starts:
            block(r0)
    else:
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(block, starts))     # re-raises a block's error
    _count("bin")
    return out
