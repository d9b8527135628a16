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
                for stem in ("window_sg", "window", "halo", "ragged", "spill",
                             "dd_tc"))
BUILD_DIR = _PKG.parent.parent / "build" / "crp_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# entry -> (source stem, number of pointer arguments, its int64 scalars);
# every entry then takes the stream
_ENTRIES = {
    "crp_window_sg_presplit": ("window_sg", 5, ("G", "TM", "W", "n")),
    "crp_window_sg_presplit_ab": ("window_sg", 6, ("G", "TM", "W", "n")),
    "crp_window_sg_bf16": ("window_sg", 4, ("G", "TM", "W", "n")),
    "crp_window_sg_f32": ("window_sg", 4, ("G", "TM", "W", "n")),
    "crp_window_sg_f64": ("dd_tc", 4, ("G", "TM", "W", "n")),
    "crp_window_x3": ("window", 5, ("G", "TM", "W", "n")),
    "crp_window_bf16": ("window", 4, ("G", "TM", "W", "n")),
    "crp_window_f32": ("window", 4, ("G", "TM", "W", "n")),
    "crp_window_f64": ("dd_tc", 4, ("G", "TM", "W", "n")),
    "crp_halo_x3": ("halo", 5, ("G", "TM", "W", "n", "rows16")),
    "crp_halo_bf16": ("halo", 4, ("G", "TM", "W", "n", "rows16")),
    "crp_halo_f32": ("halo", 5, ("G", "TM", "W", "n", "rows16")),
    "crp_halo_f64": ("dd_tc", 4, ("G", "TM", "W", "n", "rows16")),
    "crp_halo_x3_flags": ("halo", 6, ("G", "TM", "W", "n", "rows16", "epoch", "bound_ns")),
    "crp_halo_bf16_flags": ("halo", 5, ("G", "TM", "W", "n", "rows16", "epoch", "bound_ns")),
    "crp_halo_f32_flags": ("halo", 6, ("G", "TM", "W", "n", "rows16", "epoch", "bound_ns")),
    "crp_halo_f64_flags": ("dd_tc", 5, ("G", "TM", "W", "n", "rows16", "epoch", "bound_ns")),
    "crp_halo_wait": ("halo", 2, ("n_readers", "need", "bound_ns")),
    "crp_halo_signal": ("halo", 2, ("value",)),
    "crp_halo_done": ("halo", 3, ("value", "c_bytes")),
    "crp_ragged_presplit": ("ragged", 6, ("G", "TM", "Wc", "n")),
    "crp_ragged_bf16": ("ragged", 5, ("G", "TM", "Wc", "n")),
    "crp_ragged_f32": ("ragged", 6, ("G", "TM", "Wc", "n")),
    "crp_ragged_f64": ("dd_tc", 5, ("G", "TM", "Wc", "n")),
    "crp_spill_blocks": ("spill", 9, ("n_items", "M", "n", "mode")),
    "crp_gather_blocks": ("spill", 8, ("n_items", "M", "n", "mode")),
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


def _report(name: str, symbol: str) -> dict:
    """The ``key=value`` report that the library of entry ``name`` writes
    through its ``symbol`` on the current device, as a dict of ints."""
    fn = getattr(libraries()[_ENTRIES[name][0]], symbol)
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    out = ctypes.create_string_buffer(1024)
    check(fn(out, len(out)), name)
    return {k: int(v) for k, v in (kv.split("=") for kv in out.value.decode().split())}


def x3_layout(name: str = "crp_window_sg_presplit") -> dict:
    """The rings of the wgmma body in the library of entry ``name`` as its
    ``crp_x3_layout`` reports them: the x3 ring's stages, dynamic shared
    memory, threads, block tile and, per kernel, registers, local (spill)
    bytes and resident blocks per SM.  The kernels: fp32 B by 16-byte and
    by plain copies (``b16.*``, ``b4.*``: #1 in ``window_sg``, #4
    ``crp_window_x3`` in ``window``, #7 ``crp_ragged_presplit`` with the
    ragged walk in ``ragged``), #5's on the bf16 B planes (``pair16.*``,
    ``pair2.*``, ``window_sg``), the one-pass mode on one bf16 B plane
    (``one16.*``, ``one2.*``, with its own ring: ``one.stages``,
    ``one.smem_bytes``; #2 in ``window_sg``, #4 ``crp_window_bf16`` in
    ``window``, #8 ``crp_ragged_bf16`` in ``ragged``), and #12's with B's
    rows through the chunk table (``halo``: ``crp_halo_x3``'s
    ``chunk16.*``, ``chunk4.*`` and ``crp_halo_bf16``'s one-pass
    ``chunkone16.*``, ``chunkone2.*``; with the waits across processes
    ``flag16.*``, ``flag4.*``, ``flagone16.*``, ``flagone2.*``), and
    the TF32 mode at highest (its ring: ``tf32.stages``,
    ``tf32.smem_bytes``, ``tf32.BK``; its kernels on fp32 B by 16-byte and
    by plain copies: ``tf32_16.*``, ``tf32_4.*`` for #3 in ``window_sg``,
    #4 in ``window`` and #6 ``crp_ragged_f32`` with the ragged walk in
    ``ragged``; in ``halo`` #12's ``crp_halo_f32``, ``chunktf32_16.*``,
    ``chunktf32_4.*``, and its flagged twin ``flagtf32_16.*``,
    ``flagtf32_4.*``)."""
    return _report(name, "crp_x3_layout")


def spill_layout() -> dict:
    """The spill and gather kernels (``spill.cu``) as ``crp_spill_layout``
    reports them: warps a block, columns a tile, B rows in flight a warp
    and, for each kernel (the spill's ``c4``, ``c2``, ``c1`` and the
    gather's ``g4``, ``g2``, ``g1``, by load width), registers, local
    (spill) bytes and resident blocks per SM."""
    return _report("crp_spill_blocks", "crp_spill_layout")


def dd_layout() -> dict:
    """The DMMA body of ``dd_tc.cu`` (#11, and #3, #4, #6 and #12 on fp64)
    as ``crp_dd_layout`` reports it: the ring's stages and dynamic shared
    memory, threads, the block tile (``BM``, ``BN``, ``BK``), the DMMA
    shape (``mma_m``, ``mma_n``, ``mma_k``) and, for its kernels with
    16-byte and 8-byte B copies, on the ragged walk (``b16.*``, ``b8.*``:
    #11, #6), on the windowed walk (``w16.*``, ``w8.*``: #3, #4), with B
    through the chunk table (``c16.*``, ``c8.*``: #12) and with the waits
    across processes (``f16.*``, ``f8.*``: #12's ``_flags`` entry),
    registers, local (spill) bytes and resident blocks per SM."""
    return _report("crp_ragged_dd_f64tc", "crp_dd_layout")


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = libraries()[_ENTRIES[name][0]].crp_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
