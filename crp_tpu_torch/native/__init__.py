"""The port's host C++ (``native/ggp.cpp``), built and loaded with ctypes.

``ggp.cpp`` holds the greedy graph-growing partitioner behind the METIS
seam (``sparse/reorder.py``).  ``g++`` builds it at first use into
``build/crp_tpu_torch/`` at the repository root, keyed by a hash of the
source and the flags, as ``kernels/_build.py`` builds the CUDA sources.
Nothing builds at import.  Where no compiler is present (or it fails),
:func:`ggp_partition` returns None and the caller takes the numpy twin.
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
BUILD_DIR = SOURCE.parent.parent.parent / "build" / "crp_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")


def library_path() -> pathlib.Path:
    """Where the library of this source and these flags lives once built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libcrp_ggp_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Build the library unless it is cached; return its path.  Raises
    ``RuntimeError`` where ``g++`` is missing or fails."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native partitioner needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
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


def part_digest(part) -> str:
    """sha256 of a part vector as int32 bytes: the digest
    ``tests/fixtures/ggp_oracle.json`` pins for each partition."""
    return hashlib.sha256(np.ascontiguousarray(part, dtype=np.int32).tobytes()).hexdigest()
