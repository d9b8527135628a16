"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface: ``nvcc`` compiles them
into one shared library at first use, cached under ``build/crp_tpu_torch/``
at the repository root by a hash of the sources and flags, and ``ctypes``
loads it.  Every entry point takes its pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch; the wrappers
raise on anything but 0.  Nothing here runs at import: the CPU tests import
every module, and only a call on a CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent
SOURCES = (_PKG / "csrc" / "window_sg.cu",)
BUILD_DIR = _PKG.parent.parent / "build" / "crp_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# (name, number of pointer arguments); every entry then takes
# (G, TM, W, n) as int64 and the stream
_ENTRIES = (
    ("crp_window_sg_presplit", 5),
    ("crp_window_sg_bf16", 4),
    ("crp_window_sg_f32", 4),
    ("crp_window_sg_f64", 4),
)


def nvcc() -> str:
    """The CUDA compiler: on ``PATH``, else under ``CUDA_HOME``, else at
    the toolkit's default install location."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> pathlib.Path:
    """Build the shared library if it is not cached yet; return its path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    so = BUILD_DIR / f"libcrp_window_sg_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, once per process)."""
    lib = ctypes.CDLL(str(library_path()))
    for name, nptr in _ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = (
            [ctypes.c_void_p] * nptr + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    lib.crp_error_string.argtypes = [ctypes.c_int]
    lib.crp_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = library().crp_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
