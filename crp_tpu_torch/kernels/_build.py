"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` has a plain C interface: ``nvcc`` compiles it
into a shared library of its own at first use, cached under
``build/crp_tpu_torch/`` at the repository root by a hash of the sources,
the shared headers and the flags, and ``ctypes`` loads it.  The sources
build in parallel, one ``nvcc`` each, all started together.  Every entry
point takes its pointers, its int64 scalars and the CUDA stream, and
returns ``cudaGetLastError()`` after its launch; the wrappers raise on
anything but 0.  Nothing here runs at import: the CPU tests import every
module, and only a call on a CUDA tensor builds.
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
CSRC = _PKG / "csrc"
SOURCES = tuple(CSRC / f"{stem}.cu"
                for stem in ("window_sg", "ragged", "spill", "dd_tc"))
BUILD_DIR = _PKG.parent.parent / "build" / "crp_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# entry -> (source stem, number of pointer arguments, its int64 scalars);
# every entry then takes the stream
_ENTRIES = {
    "crp_window_sg_presplit": ("window_sg", 5, ("G", "TM", "W", "n")),
    "crp_window_sg_bf16": ("window_sg", 4, ("G", "TM", "W", "n")),
    "crp_window_sg_f32": ("window_sg", 4, ("G", "TM", "W", "n")),
    "crp_window_sg_f64": ("window_sg", 4, ("G", "TM", "W", "n")),
    "crp_ragged_presplit": ("ragged", 6, ("G", "TM", "Wc", "n")),
    "crp_ragged_bf16": ("ragged", 5, ("G", "TM", "Wc", "n")),
    "crp_ragged_f32": ("ragged", 5, ("G", "TM", "Wc", "n")),
    "crp_ragged_f64": ("ragged", 5, ("G", "TM", "Wc", "n")),
    "crp_spill_blocks": ("spill", 7, ("nblk", "TMo", "Q", "n", "mode")),
    "crp_gather_blocks": ("spill", 6, ("nblk", "TMo", "Q", "n", "mode")),
    "crp_ragged_dd_f64tc": ("dd_tc", 5, ("G", "TM", "Wc", "n")),
}


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


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the sources and the headers they share
    for src in sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_paths() -> dict:
    """Build every library that is not cached yet, one ``nvcc`` per source
    started together; return ``{stem: path}``."""
    digest = _digest()
    paths = {src.stem: BUILD_DIR / f"libcrp_{src.stem}_{digest}.so" for src in SOURCES}
    todo = [src for src in SOURCES if not paths[src.stem].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        so = paths[src.stem]
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((cmd, tmp, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for cmd, tmp, so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\nexit code {proc.returncode}\n{out}")
        else:
            os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


@functools.lru_cache(maxsize=None)
def libraries() -> dict:
    """The loaded kernel libraries, ``{stem: ctypes.CDLL}`` (built on first
    call, once per process)."""
    libs = {stem: ctypes.CDLL(str(p)) for stem, p in library_paths().items()}
    for name, (stem, nptr, scalars) in _ENTRIES.items():
        fn = getattr(libs[stem], name)
        fn.argtypes = (
            [ctypes.c_void_p] * nptr + [ctypes.c_int64] * len(scalars)
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    for lib in libs.values():
        lib.crp_error_string.argtypes = [ctypes.c_int]
        lib.crp_error_string.restype = ctypes.c_char_p
    return libs


def entry(name: str):
    """The ctypes function of entry point ``name``."""
    return getattr(libraries()[_ENTRIES[name][0]], name)


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = libraries()[_ENTRIES[name][0]].crp_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
