"""The port's host C++, built and loaded with ctypes.

``ggp.cpp`` holds the greedy graph-growing partitioner behind the METIS
seam (``sparse/reorder.py``); ``mtx.cpp`` the Matrix Market reader of
``sparse/mmio.py``.  ``g++`` builds each source at first use into
``build/crp_tpu_torch/`` at the repository root, keyed by a hash of that
source and the flags, as ``kernels/_build.py`` builds the CUDA sources,
so one source's edit never moves the other's library.  Nothing builds at
import.  Where no compiler is present (or it fails), :func:`ggp_partition`
and :func:`mtx_read` return None and the caller takes the numpy twin or
scipy's reader.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import pathlib
import shutil
import subprocess

import numpy as np

logger = logging.getLogger("crp_tpu_torch")

SOURCE = pathlib.Path(__file__).resolve().parent / "ggp.cpp"
MTX_SOURCE = SOURCE.with_name("mtx.cpp")
BUILD_DIR = SOURCE.parent.parent.parent / "build" / "crp_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")


def library_path(source: pathlib.Path | None = None) -> pathlib.Path:
    """Where the library of ``source`` (default ``ggp.cpp``) and these
    flags lives once built."""
    source = source or SOURCE
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"libcrp_{source.stem}_{h.hexdigest()[:16]}.so"


def build(source: pathlib.Path | None = None) -> pathlib.Path:
    """Build the library of ``source`` (default ``ggp.cpp``) unless it is
    cached; return its path.  Raises ``RuntimeError`` where ``g++`` is
    missing or fails."""
    source = source or SOURCE
    so = library_path(source)
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: {source.name} needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(source), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)}\nexit code {proc.returncode}\n{proc.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
    return so


@functools.lru_cache(maxsize=None)
def _load():
    """The loaded library, or None where it cannot be built."""
    try:
        so = build()
    except (OSError, subprocess.SubprocessError, RuntimeError) as e:
        logger.info("native partitioner unavailable (%s); using the numpy twin", e)
        return None
    lib = ctypes.CDLL(str(so))
    lib.crp_ggp_partition.restype = ctypes.c_int
    lib.crp_ggp_partition.argtypes = [
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_double,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    return lib


def available() -> bool:
    """True where the native partitioner builds and loads."""
    return _load() is not None


def ggp_partition(rowptr, colidx, nparts, imbalance=1.05):
    """Native greedy graph-growing K-way partition
    (``crp_tpu/native/__init__.py:427-441``); returns the (nrow,) int32
    part vector, or None where no compiler is present."""
    lib = _load()
    if lib is None:
        return None
    nrow = len(rowptr) - 1
    part = np.zeros(max(nrow, 1), dtype=np.int32)
    lib.crp_ggp_partition(
        int(nrow),
        np.ascontiguousarray(rowptr, dtype=np.int64),
        np.ascontiguousarray(colidx, dtype=np.int32),
        int(nparts), float(imbalance), part,
    )
    return part[:nrow]


@functools.lru_cache(maxsize=None)
def _load_mtx():
    """The loaded Matrix Market reader, or None where it cannot be built."""
    try:
        so = build(MTX_SOURCE)
    except (OSError, subprocess.SubprocessError, RuntimeError) as e:
        logger.info("native .mtx reader unavailable (%s); using scipy's", e)
        return None
    lib = ctypes.CDLL(str(so))
    i64 = ctypes.c_int64
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.crp_mtx_stat.restype = ctypes.c_int
    lib.crp_mtx_stat.argtypes = [ctypes.c_char_p] + [ctypes.POINTER(i64)] * 3 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    lib.crp_mtx_read.restype = i64
    lib.crp_mtx_read.argtypes = [
        ctypes.c_char_p, i64, ctypes.c_int, ctypes.c_int, p_i64, p_i64,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
    ]
    return lib


def mtx_available() -> bool:
    """True where the native Matrix Market reader builds and loads."""
    return _load_mtx() is not None


def mtx_read(path):
    """Native .mtx reader (``crp_tpu/native/__init__.py:444-467``): (nrow,
    ncol, rows, cols, vals) with 0-based int64 indices and fp64 values,
    symmetric storage mirrored; None where the reader is not built or its
    stat refuses the file."""
    lib = _load_mtx()
    if lib is None:
        return None
    i64 = ctypes.c_int64
    nrow, ncol, nnz = i64(), i64(), i64()
    symm, field = ctypes.c_int(), ctypes.c_int()
    rc = lib.crp_mtx_stat(
        os.fsencode(path), ctypes.byref(nrow), ctypes.byref(ncol),
        ctypes.byref(nnz), ctypes.byref(symm), ctypes.byref(field),
    )
    if rc != 0:
        return None
    cap = nnz.value * (2 if symm.value else 1)
    rows = np.zeros(max(cap, 1), dtype=np.int64)
    cols = np.zeros(max(cap, 1), dtype=np.int64)
    vals = np.zeros(max(cap, 1), dtype=np.float64)
    n = lib.crp_mtx_read(os.fsencode(path), nnz.value, symm.value, field.value,
                         rows, cols, vals)
    if n < 0:
        return None
    return int(nrow.value), int(ncol.value), rows[:n], cols[:n], vals[:n]


def part_digest(part) -> str:
    """sha256 of a part vector as int32 bytes: the digest
    ``tests/fixtures/ggp_oracle.json`` pins for each partition."""
    return hashlib.sha256(np.ascontiguousarray(part, dtype=np.int32).tobytes()).hexdigest()
