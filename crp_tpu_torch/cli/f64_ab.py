"""Time the fp64 entries of #3 and #6 on one card, this tree beside others.

    python -m crp_tpu_torch.cli.f64_ab [--baseline CSRC_DIR ...] [--rounds R] [--split]

Builds ``window_sg.cu``, ``ragged.cu`` and ``dd_tc.cu`` of this tree and
of each ``--baseline`` tree (another ``kernels/csrc``, say the parent's
unpacked with ``git archive HEAD crp_tpu_torch/kernels/csrc | tar -x -C
build/parent``), then, one matrix at a time, packs the three fp64
matrices of ``chip_smoke.py``'s fp64 path as ``kernel="auto"`` packs them
on the card (``RowParaSpmm`` at p = 1 in fp64, n = 256): the banded matrix
``banded_random_csr(217918, 53, 256)`` on the uniform pack (#3,
``crp_window_sg_f64``), cplaw ``powerlaw_community_csr(786432, 16,
1024)`` and the pwtk-class headline ``banded_random_csr(217918, 53, 2500,
seed=1234)`` on the ragged pack (#6, ``crp_ragged_f64``).  Each tree's
entry, wherever its library has it, is timed in turns over ``R`` rounds
(the order reversed every other round; ``utils.timers.median_ms``: 5 runs
of 5 launches).  With ``--split`` also copies of this tree's ``dd_tc.cu``
with its copies or its products compiled out (``dd_split``'s edits): where
the DMMA body's time goes on these packs (those copies compute nothing
meaningful and are not checked).

Every other launch's C is held within 1e-12 relative Frobenius of the
plain version, and this tree's entry bit for bit to a second launch.
Prints one JSON line per (matrix, entry, tree) with the ms of each round,
their median, the panels' GFLOP and TFLOP/s, the design bounds at the FP64
tensor cores' and the FMA units' peaks, and the card's name and power
limit; then one line per matrix with each tree's median over this
tree's.  Needs the card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..kernels import _build
from ..kernels.points import PEAK
from ._csrc_variants import build as build_copies
from ._csrc_variants import edited
from .dd_split import NO_COPIES, NO_PRODUCTS

OUT = _build.BUILD_DIR / "f64_ab"
N = 256
STEMS = ("window_sg", "ragged", "dd_tc")
# matrix -> (generator, its keyword arguments); the smoke's fp64 cases
MATRICES = {
    "fp64 banded": ("banded_random_csr", dict(n=217918, nnz_per_row=53, bandwidth=256)),
    "fp64 cplaw": ("powerlaw_community_csr",
                   dict(n=786432, avg_degree=16, comm_size=1024, seed=1234)),
    "fp64 headline": ("banded_random_csr",
                      dict(n=217918, nnz_per_row=53, bandwidth=2500, seed=1234)),
}
SPLITS = {"products_only": NO_COPIES, "copies_only": NO_PRODUCTS}


def libraries(baselines, split: bool) -> dict:
    """``{tree: [ctypes libraries]}``: this tree (``"this"``), each
    baseline (``"baseline:DIR"``) and, with ``split``, the split copies of
    this tree (``"split:VARIANT"``), one ``nvcc`` a source, all started
    together."""
    jobs = {"this": (_build.CSRC, {}, ())}
    for base in baselines:
        jobs[f"baseline:{base}"] = (pathlib.Path(base), {}, ())
    if split:
        body = (_build.CSRC / "dd_tc.cu").read_text()
        for variant, edits in SPLITS.items():
            jobs[f"split:{variant}"] = (_build.CSRC,
                                        {"dd_tc.cu": edited(body, edits, "f64_ab")}, ())
    libs = {}
    for (tree, _), path in build_copies(OUT, jobs, STEMS, "f64_ab").items():
        libs.setdefault(tree, []).append(ctypes.CDLL(str(path)))
    return libs


def entry_of(libs, name):
    """The ctypes function ``name`` from the first library that has it."""
    for lib in libs:
        if hasattr(lib, name):
            return getattr(lib, name)
    raise RuntimeError(f"f64_ab: no library of the tree has {name}")


def pack(label, dev) -> tuple:
    """(op, the kernel's positional args, the plain version's C) of
    ``label``'s fp64 ``auto`` engine at p = 1 on the card."""
    from .. import RowParaSpmm, SpmmConfig, csr_row_partition, fill_b
    from ..sparse import synth

    gen, kw = MATRICES[label]
    a = getattr(synth, gen)(**kw)
    displs = csr_row_partition(a.rowptr, 1)
    eng = RowParaSpmm(a, displs, displs, N, device=dev, dtype=np.float64,
                      config=SpmmConfig(kernel="auto", mxu_precision="highest"))
    op = eng._local_op
    arrs = tuple(x[0] for x in eng.packed)
    rB = eng.receive_buffer(eng.shard_b(np.asarray(fill_b(0, a.ncol, 0, N))))[0]
    args = op.kernel_args(arrs, rB)
    return op, args, op.plain(*args)


def runner(fn, op, args, stream):
    """A call of entry ``fn`` on the op's args, its output allocated once;
    raises on a CUDA error."""
    if op.variant == "uniform":  # #3: ws, tiles, b
        ws, panels, b = args
        G = ws.shape[0]
        ptrs = (ws, panels, b)
    else:  # #6: step_g, group_ptr, starts, panels, b
        _, group_ptr, starts, panels, b = args
        G = group_ptr.shape[0] - 1
        ptrs = (group_ptr, starts, panels, b)
    _, TM, W = panels.shape
    n = b.shape[1]
    c = torch.empty((G * TM, n), dtype=torch.float64, device=b.device)
    fn.argtypes = [ctypes.c_void_p] * (len(ptrs) + 1) + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    addrs = [t.data_ptr() for t in ptrs] + [c.data_ptr()]

    def run():
        rc = fn(*addrs, G, TM, W, n, stream)
        if rc:
            raise RuntimeError(f"f64_ab: CUDA error {rc}")
        return c

    return run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m crp_tpu_torch.cli.f64_ab")
    parser.add_argument("--baseline", action="append", default=[],
                        help="another kernels/csrc tree to time as it is")
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--split", action="store_true",
                        help="also time this tree's DMMA body without copies or products")
    args = parser.parse_args(argv)
    from ..utils.timers import median_ms

    if not torch.cuda.is_available():
        print("f64_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    libs = libraries(args.baseline, args.split)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for label in MATRICES:
        op, kargs, plain = pack(label, dev)
        name = "crp_window_sg_f64" if op.variant == "uniform" else "crp_ragged_f64"
        runs = {tree: runner(entry_of(tree_libs, name), op, kargs, stream)
                for tree, tree_libs in libs.items()}
        for tree, run in runs.items():
            if tree.startswith("split:"):
                continue
            c = run().clone()
            err = float((c - plain).norm() / plain.norm())
            if err > 1e-12:
                raise RuntimeError(f"f64_ab: {label} {name} of {tree} vs plain {err:.3e}")
            if tree == "this" and not torch.equal(c.view(torch.int64),
                                                  run().view(torch.int64)):
                raise RuntimeError(f"f64_ab: {label} {name}: two launches differ")
        times = {tree: [] for tree in runs}
        for r in range(args.rounds):
            for tree in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                times[tree].append(median_ms(runs[tree], dev, 5, 5))
        panels = kargs[-2]
        gflop = 2.0 * panels.numel() * N / 1e9
        median = {tree: statistics.median(t) for tree, t in times.items()}
        for tree, t in times.items():
            print(json.dumps(dict(
                matrix=label, entry=name, variant=op.variant, tree=tree, ms=t,
                median_ms=median[tree], gflop=gflop, tflops=gflop / median[tree],
                design_ms_fp64_tc=gflop / PEAK["fp64_tc"] * 1e12,
                design_ms_fp64=gflop / PEAK["fp64"] * 1e12, panels=list(panels.shape),
                n=N, card=card)), flush=True)
        print(json.dumps(dict(matrix=label, entry=name, over_this={
            tree: median[tree] / median["this"] for tree in runs}, card=card)), flush=True)
        del op, kargs, plain, runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
