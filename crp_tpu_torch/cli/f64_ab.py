"""Time the fp64 entries on the FP64 tensor cores, this tree beside others.

    python -m crp_tpu_torch.cli.f64_ab [--baseline CSRC_DIR ...] [--rounds R] [--split]
                                       [--p P ...]

Builds the kernel sources (``STEMS``) of this tree and of each
``--baseline`` tree (another ``kernels/csrc``, say the parent's unpacked
with ``git archive HEAD crp_tpu_torch/kernels/csrc | tar -x -C
build/parent``), then, one case at a time, packs the fp64 matrices of
``chip_smoke.py`` as the engines pack them on the card (``RowParaSpmm`` in
fp64, n = 256) and times each tree's entry on the same arrays:

  * p = 1, ``kernel="auto"``: the banded matrix ``banded_random_csr(217918,
    53, 256)`` on the uniform pack (#3, ``crp_window_sg_f64``), cplaw
    ``powerlaw_community_csr(786432, 16, 1024)`` and the pwtk-class
    headline ``banded_random_csr(217918, 53, 2500, seed=1234)`` on the
    ragged pack (#6, ``crp_ragged_f64``);
  * p = 4 on the headline: ``kernel="pallas"``, shard 0's window pack and
    receive buffer (#4, ``crp_window_f64``), and ``kernel="auto"``, the
    fused plan over all four shards (#12, ``crp_halo_f64``, B read in place
    through the chunk table, made once from the stacked B).

``--p`` picks the cases by p (both by default).  Each tree's entry,
wherever its library has it, is timed in turns over ``R`` rounds (the
order reversed every other round; ``utils.timers.median_ms``: 5 runs of 5
launches).  With ``--split`` also copies of this tree's ``dd_tc.cu`` with
its copies or its products compiled out (``dd_split``'s edits): where the
DMMA body's time goes on these packs (those copies compute nothing
meaningful and are not checked).  Beside each case, cuSPARSE fp64
(``torch.sparse_csr_tensor @ B``) on the same product: the matrix, or at
#4 shard 0's rows.  After the p = 4 cases, fp64 ``kernel="auto"`` (the
fused #12) is timed against ``kernel="dd"`` (the JAX package's rule for
fp64) at p = 4 on the headline, each exec within 1e-12 of the fp64 product
on the first 32 columns.

Every other launch's C is held within 1e-12 relative Frobenius of the
plain version, and this tree's entry bit for bit to a second launch.
Prints one JSON line per (case, entry, tree) with the ms of each round,
their median, the panels' GFLOP and TFLOP/s, the design bounds at the FP64
tensor cores' and the FMA units' peaks, and the card's name and power
limit; then one line per case with each tree's median over this tree's
and cuSPARSE's ms.  Needs the card and ``nvcc``.
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
STEMS = ("window_sg", "window", "halo", "ragged", "dd_tc")
# matrix -> (generator, its keyword arguments); the smoke's fp64 cases
MATRICES = {
    "fp64 banded": ("banded_random_csr", dict(n=217918, nnz_per_row=53, bandwidth=256)),
    "fp64 cplaw": ("powerlaw_community_csr",
                   dict(n=786432, avg_degree=16, comm_size=1024, seed=1234)),
    "fp64 headline": ("banded_random_csr",
                      dict(n=217918, nnz_per_row=53, bandwidth=2500, seed=1234)),
}
# (matrix, p, kernel) -> the entry it times; at p = 4, #4 on shard 0
CASES = {
    ("fp64 banded", 1, "auto"): "crp_window_sg_f64",
    ("fp64 cplaw", 1, "auto"): "crp_ragged_f64",
    ("fp64 headline", 1, "auto"): "crp_ragged_f64",
    ("fp64 headline", 4, "pallas"): "crp_window_f64",
    ("fp64 headline", 4, "auto"): "crp_halo_f64",
}
SPLITS = {"products_only": NO_COPIES, "copies_only": NO_PRODUCTS}
ERR_COLS = 32
TOL = 1e-12


def libraries(baselines, split: bool) -> dict:
    """``{tree: [ctypes libraries]}``: this tree (``"this"``), each
    baseline (``"baseline:DIR"``) and, with ``split``, the split copies of
    this tree's ``dd_tc.cu`` (``"split:VARIANT"``), one ``nvcc`` a source,
    all started together."""
    jobs = {"this": (_build.CSRC, {}, ())}
    for base in baselines:
        jobs[f"baseline:{base}"] = (pathlib.Path(base), {}, ())
    splits = {}
    if split:
        body = (_build.CSRC / "dd_tc.cu").read_text()
        splits = {f"split:{variant}": (_build.CSRC,
                                       {"dd_tc.cu": edited(body, edits, "f64_ab")}, ())
                  for variant, edits in SPLITS.items()}
    libs = {}
    for out, js, stems in ((OUT, jobs, STEMS), (OUT / "split", splits, ("dd_tc",))):
        if js:
            for (tree, _), path in build_copies(out, js, stems, "f64_ab").items():
                libs.setdefault(tree, []).append(ctypes.CDLL(str(path)))
    return libs


def entry_of(libs, name):
    """The ctypes function ``name`` from the first library that has it."""
    for lib in libs:
        if hasattr(lib, name):
            return getattr(lib, name)
    raise RuntimeError(f"f64_ab: no library of the tree has {name}")


def engine(a, p: int, kernel: str, dev):
    """``RowParaSpmm`` over p nnz-balanced row shards of ``a`` in fp64 at
    n = N on ``dev``, and its B shards for the analytic B."""
    from .. import RowParaSpmm, SpmmConfig, csr_row_partition, fill_b

    d = csr_row_partition(a.rowptr, p)
    eng = RowParaSpmm(a, d, d, N, device=dev, dtype=np.float64,
                      config=SpmmConfig(kernel=kernel, mxu_precision="highest"))
    return eng, eng.shard_b(np.asarray(fill_b(0, a.ncol, 0, N)))


def pack(a, p: int, kernel: str, dev) -> tuple:
    """(op, the kernel's positional args, the plain version's C, the CSR
    rows its product covers) of the case's engine: at p = 1 its one shard,
    at p = 4 with ``kernel="pallas"`` shard 0 on its receive buffer, with
    ``"auto"`` the fused plan over every shard on the stacked B."""
    eng, bs = engine(a, p, kernel, dev)
    op = eng._local_op
    if op.variant == "halo":
        args = op.kernel_args(eng.packed, bs)
        rows = (0, a.nrow)
    else:
        args = op.kernel_args(tuple(x[0] for x in eng.packed), eng.receive_buffer(bs)[0])
        rows = (int(eng.A_row_displs[0]), int(eng.A_row_displs[1]))
    return op, args, op.plain(*args), rows


def runner(fn, op, args, stream):
    """A call of entry ``fn`` on the op's args, its output allocated once;
    raises on a CUDA error."""
    extra = ()
    if op.variant == "halo":  # #12: rows, ws, panels, C; then rows16
        from ..kernels.spmm_halo import stacked_chunk_rows

        ws, _, panels, _, chunk_src, b = args[:6]
        rows, rows16 = stacked_chunk_rows(chunk_src, b)
        s_, G, TM, W = panels.shape
        ptrs, extra, shape = (rows, ws, panels), (int(rows16),), (s_, G * TM, b.shape[-1])
        G *= s_
    else:
        if op.variant in ("uniform", "window"):  # #3, #4: ws, tiles, b
            ws, panels, b = args[:3]
            G, ptrs = ws.shape[0], (ws, panels, b)
        else:  # #6: step_g, group_ptr, starts, panels, b
            _, group_ptr, starts, panels, b = args
            G, ptrs = group_ptr.shape[0] - 1, (group_ptr, starts, panels, b)
        _, TM, W = panels.shape
        shape = (G * TM, b.shape[1])
    n = b.shape[-1]
    c = torch.empty(shape, dtype=torch.float64, device=b.device)
    fn.argtypes = ([ctypes.c_void_p] * (len(ptrs) + 1) + [ctypes.c_int64] * (4 + len(extra))
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    addrs = [t.data_ptr() for t in ptrs] + [c.data_ptr()]

    def run():
        rc = fn(*addrs, G, TM, W, n, *extra, stream)
        if rc:
            raise RuntimeError(f"f64_ab: CUDA error {rc}")
        return c

    run.inputs = ptrs  # the addresses' tensors live as long as the call
    return run


def cusparse_ms(a, rows, dev, median_ms) -> float:
    """ms of ``torch.sparse_csr_tensor @ B`` in fp64 on the CSR rows
    ``rows`` of ``a`` and the analytic B (the library's time for the same
    product)."""
    from .. import fill_b

    r0, r1 = rows
    rp = a.rowptr[r0:r1 + 1] - a.rowptr[r0]
    sl = slice(int(a.rowptr[r0]), int(a.rowptr[r1]))
    s = torch.sparse_csr_tensor(torch.from_numpy(rp.astype(np.int64)),
                                torch.from_numpy(a.colidx[sl].astype(np.int64)),
                                torch.from_numpy(a.val[sl]), size=(r1 - r0, a.ncol)).to(dev)
    b = torch.from_numpy(np.asarray(fill_b(0, a.ncol, 0, N))).to(dev)
    return median_ms(lambda: s @ b, dev, 5, 5)


def dd_vs_auto(a, dev, median_ms, card) -> None:
    """C1 at p = 4: fp64 ``auto`` (the fused #12) against ``dd`` (the JAX
    package's rule for fp64), each exec's C within TOL of the fp64
    product on the first ERR_COLS columns, then each exec_device timed."""
    from .. import fill_b, rel_fro_err

    b = np.asarray(fill_b(0, a.ncol, 0, N))
    ref = a.spmm_ref(b[:, :ERR_COLS])
    got = {}
    for kernel in ("auto", "dd"):
        eng, bs = engine(a, 4, kernel, dev)
        err = rel_fro_err(ref, eng.exec(b)[:, :ERR_COLS])
        if err > TOL:
            raise RuntimeError(f"f64_ab: p = 4 {kernel} exec vs fp64 product {err:.3e}")
        got[kernel] = dict(kind=f"{eng.kernel_kind}/{eng._local_op.variant}", err=err,
                           exec_ms=median_ms(lambda: eng.exec_device(bs), dev, 3, 3))
        del eng, bs
        torch.cuda.empty_cache()
    print(json.dumps(dict(case="fp64 headline p=4 auto vs dd", **got,
                          faster=min(got, key=lambda k: got[k]["exec_ms"]), n=N,
                          card=card)), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m crp_tpu_torch.cli.f64_ab")
    parser.add_argument("--baseline", action="append", default=[],
                        help="another kernels/csrc tree to time as it is")
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--split", action="store_true",
                        help="also time this tree's DMMA body without copies or products")
    parser.add_argument("--p", type=int, action="append", choices=(1, 4),
                        help="the cases at this p (default: every case)")
    args = parser.parse_args(argv)
    from ..sparse import synth
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
    matrices = {}
    for (label, p, kernel), name in CASES.items():
        if args.p and p not in args.p:
            continue
        if label not in matrices:
            gen, kw = MATRICES[label]
            matrices = {label: getattr(synth, gen)(**kw)}  # one matrix held at a time
        a = matrices[label]
        op, kargs, plain, rows = pack(a, p, kernel, dev)
        runs = {tree: runner(entry_of(tree_libs, name), op, kargs, stream)
                for tree, tree_libs in libs.items()}
        for tree, run in runs.items():
            if tree.startswith("split:"):
                continue
            c = run().clone()
            err = float((c - plain).norm() / plain.norm())
            if err > TOL:
                raise RuntimeError(f"f64_ab: {label} p={p} {name} of {tree} vs plain "
                                   f"{err:.3e}")
            if tree == "this" and not torch.equal(c.view(torch.int64),
                                                  run().view(torch.int64)):
                raise RuntimeError(f"f64_ab: {label} p={p} {name}: two launches differ")
        times = {tree: [] for tree in runs}
        for r in range(args.rounds):
            for tree in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                times[tree].append(median_ms(runs[tree], dev, 5, 5))
        panels = next(t for t in kargs if isinstance(t, torch.Tensor) and t.dim() >= 3)
        gflop = 2.0 * panels.numel() * N / 1e9
        median = {tree: statistics.median(t) for tree, t in times.items()}
        case = f"{label} p={p} {kernel}"
        for tree, t in times.items():
            print(json.dumps(dict(
                case=case, matrix=label, p=p, entry=name, variant=op.variant, tree=tree,
                ms=t, median_ms=median[tree], gflop=gflop, tflops=gflop / median[tree],
                design_ms_fp64_tc=gflop / PEAK["fp64_tc"] * 1e12,
                design_ms_fp64=gflop / PEAK["fp64"] * 1e12, panels=list(panels.shape),
                n=N, card=card)), flush=True)
        del op, kargs, plain, runs
        torch.cuda.empty_cache()
        print(json.dumps(dict(case=case, entry=name, over_this={
            tree: median[tree] / median["this"] for tree in times},
            cusparse_rows=list(rows), cusparse_ms=cusparse_ms(a, rows, dev, median_ms),
            card=card)), flush=True)
    if not args.p or 4 in args.p:  # C1 on the p = 4 cases' matrix, the last one held
        dd_vs_auto(matrices["fp64 headline"], dev, median_ms, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
