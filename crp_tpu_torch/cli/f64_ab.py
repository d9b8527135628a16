"""Time the fp64 entries on the FP64 tensor cores, or the fp32 entries at
``highest`` (3xTF32), this tree beside others.

    python -m crp_tpu_torch.cli.f64_ab [--point fp64|highest] [--baseline CSRC_DIR ...]
                                       [--rounds R] [--split] [--p P ...]

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

``--point highest`` times at ``highest``, on the ``wgmma`` body's TF32
mode (``csrc/x3_wgmma.cuh``), #3 (``crp_window_sg_f32``, the headline in
fp32 at p = 1, ``kernel="auto"``), #4 (``crp_window_f32``, the headline's
shard 0 at p = 4, ``kernel="pallas"``), #12 (``crp_halo_f32``, the
headline's fused plan over all four shards at p = 4, ``kernel="auto"``,
B read in place through the chunk table) and #6 (``crp_ragged_f32``,
cplaw in fp32 at p = 1, ``kernel="auto"``: the ragged pack, whose spill
#9 is not timed here), each within 1e-6 relative Frobenius of its plain
version.  This tree's entries take the pack's TF32 planes (split once at
init); a tree whose entries take fp32 panels (an older parent's #12 and
#6, on the ``mma.sync`` 3xTF32 body; ``design:ring``) gets the fp32
panels they were split from, exact.  Besides the baselines it times, for
#3 and #4, ``design:ring``, a copy of this tree in the other design
(:data:`RING_EDITS`: the fp32 panels by TMA, split in the ring by three
splitter warps): C equal to this tree's bit for bit, and the comparison
of where the split is made.  With ``--split`` the copies of this tree's
body without its copies or its products are ``x3_feed_split``'s edits
and :data:`TF32_EDITS`, for all four.  ``--case`` picks the cases by
entry name (all by default).
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
from ..kernels.spmm_pallas import tf32_panels
from ._csrc_variants import build as build_copies
from ._csrc_variants import edited
from .dd_split import NO_COPIES, NO_PRODUCTS
from .x3_feed_split import EDITS as X3_EDITS

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

# --point highest: the smoke's fp32 headline, #3 at p = 1, #4 on shard 0
# and #12 over all four shards at p = 4; its cplaw, #6 at p = 1
HIGHEST_STEMS = ("window_sg", "window", "halo", "ragged")
RING_STEMS = ("window_sg", "window")  # design:ring's #3 and #4
HIGHEST_MATRICES = {
    "headline": ("banded_random_csr", dict(n=217918, nnz_per_row=53, bandwidth=2500,
                                           seed=1234, dtype=np.float32)),
    "cplaw": ("powerlaw_community_csr", dict(n=786432, avg_degree=16, comm_size=1024,
                                             seed=1234, dtype=np.float32)),
}
HIGHEST_CASES = {
    ("headline", 1, "auto"): "crp_window_sg_f32",
    ("headline", 4, "pallas"): "crp_window_f32",
    ("headline", 4, "auto"): "crp_halo_f32",
    ("cplaw", 1, "auto"): "crp_ragged_f32",
}
HIGHEST_TOL = 1e-6  # kernel vs plain, relative Frobenius (chip_smoke TOL_PLAIN_FRO)
# the TF32 consumers' products under TF32_NO_PRODUCTS; with x3_feed_split's
# producer edits (X3_NO_PANELS, X3_NO_B) the two halves
TF32_EDITS = (
    ("#pragma unroll\n            for (int h = 0; h < X3_SLICE / 16; ++h) {",
     "#ifndef TF32_NO_PRODUCTS\n#pragma unroll\n"
     "            for (int h = 0; h < X3_SLICE / 16; ++h) {"),
    ("            for (int i = 0; i < 64; ++i) acc[i] += part[i];\n            __syncwarp();\n",
     "            for (int i = 0; i < 64; ++i) acc[i] += part[i];\n#endif\n"
     "            __syncwarp();\n"),
)
HIGHEST_SPLITS = {"products_only": ("X3_NO_PANELS", "X3_NO_B"),
                  "copies_only": ("TF32_NO_PRODUCTS",)}
# The other design of the TF32 mode (ROADMAP B2 step 2's second way):
# the entries take the pack's fp32 panels, TMA lands one fp32 tile a
# stage, and three splitter warps beside the producer (384 threads) split
# it in place to the big operand bits and into the small tile beside it,
# then arrive on the stage's third mbarrier (ready), which the consumers
# wait for.  (Splitting in the consumers themselves, under the previous
# stage's products, spilled: the block has 168 registers a thread.)
_SPLIT_STAGE = """// the ring design: splitter thread sid's share of a landed stage's split
__device__ __forceinline__ void tf32_split_stage(uint8_t* st, int sid)
{
    const float4* x = reinterpret_cast<const float4*>(st);
    uint4* big = reinterpret_cast<uint4*>(st);
    uint4* small = reinterpret_cast<uint4*>(st + X3_A_TILE);
#pragma unroll 4
    for (int e = sid; e < X3_A_TILE / 16; e += 96) {
        const float4 v = x[e];
        uint4 bb, ss;
        split_tf32(v.x, bb.x, ss.x);
        split_tf32(v.y, bb.y, ss.y);
        split_tf32(v.z, bb.z, ss.z);
        split_tf32(v.w, bb.w, ss.w);
        big[e] = bb;
        small[e] = ss;
    }
    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
}

"""
_SPLITTERS = """    if constexpr (Ring::TF32) {
        if (warp > X3_CONSUMERS / 32) {  // the splitters
            for (int t = 0; t < stages; ++t) {
                const int s = t % Ring::STAGES;
                mbar_wait(full0 + 8 * s, (t / Ring::STAGES) & 1);
                tf32_split_stage(smem + s * Ring::STAGE, tid - X3_THREADS);
                mbar_arrive(ready0 + 8 * s);
            }
            return;
        }
    }
"""
_THREADS = "X3_THREADS + (MODE == WgMode::TF32X3 ? 96 : 0)"
RING_EDITS = {
    "x3_wgmma.cuh": (
        ("    static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;",
         "    static constexpr int SMEM = STAGES * STAGE + 3 * STAGES * 8 + 1024;"),
        ("template <WgMode MODE, bool B_VEC, bool CHUNKED = false, bool RAGGED = false,\n"
         "          bool FLAGS = false>\n__global__ void __launch_bounds__(X3_THREADS, 1)",
         _SPLIT_STAGE + "template <WgMode MODE, bool B_VEC, bool CHUNKED = false, "
         "bool RAGGED = false,\n          bool FLAGS = false>\n"
         f"__global__ void __launch_bounds__({_THREADS}, 1)"),
        ("    const uint32_t empty0 = full0 + Ring::STAGES * 8;\n",
         "    const uint32_t empty0 = full0 + Ring::STAGES * 8;\n"
         "    const uint32_t ready0 = empty0 + Ring::STAGES * 8;\n"),
        ("            mbar_init(empty0 + 8 * s, X3_CONSUMERS / 32);  // one per consumer warp\n",
         "            mbar_init(empty0 + 8 * s, X3_CONSUMERS / 32);  // one per consumer warp\n"
         "            if constexpr (Ring::TF32) mbar_init(ready0 + 8 * s, 96);\n"),
        ("    if (warp == X3_CONSUMERS / 32) {  // the producer",
         _SPLITTERS + "    if (warp == X3_CONSUMERS / 32) {  // the producer"),
        ("                mbar_arrive_tx(full0 + 8 * s, Ring::A_BYTES);",
         "                mbar_arrive_tx(full0 + 8 * s, Ring::TF32 ? X3_A_TILE : Ring::A_BYTES);"),
        ("                if constexpr (!Ring::ONE)\n",
         "                if constexpr (!Ring::ONE && !Ring::TF32)\n"),
        ("            __syncwarp();  // wgmma's .aligned forms need the warp converged\n"
         "            const uint8_t* st = smem + s * Ring::STAGE;\n"
         "            const uint32_t big_addr",
         "            mbar_wait(ready0 + 8 * s, (t / Ring::STAGES) & 1);\n"
         "            __syncwarp();  // wgmma's .aligned forms need the warp converged\n"
         "            const uint8_t* st = smem + s * Ring::STAGE;\n"
         "            const uint32_t big_addr"),
        ("    kernel<<<(unsigned)blocks, X3_THREADS, WgRing<MODE>::SMEM",
         f"    kernel<<<(unsigned)blocks, {_THREADS}, WgRing<MODE>::SMEM"),
    ),
    **{f"{stem}.cu": (("launch_wgmma<crp::WgMode::TF32X3>(ws, big, big + G * TM * W, b,",
                       "launch_wgmma<crp::WgMode::TF32X3>(ws, big, big, b,"),)
       for stem in RING_STEMS},
}
RING_ENTRIES = ("crp_window_sg_f32", "crp_window_f32")  # what design:ring is timed on
# the trees whose #3 and #4 take the TF32 planes: their entries pass the
# small plane G*TM*W floats past the big one; the others (an older parent's,
# design:ring) take the fp32 panels
PLANES_ENTRY = "big + G * TM * W"
# a tree whose #12 and #6 still run the mma.sync 3xTF32 body takes their
# fp32 panels (one pointer where this tree's take the two planes)
MMA_SYNC_BODY = "launch_tf32x3"


def takes_planes(src: pathlib.Path, texts: dict) -> set:
    """The fp32 ``highest`` entries of the tree at ``src`` (``texts``
    replacing its files) that take the TF32 planes."""
    def text(name):
        return texts.get(name, (src / name).read_text())

    got = set()
    if PLANES_ENTRY in text("window.cu"):
        got |= {"crp_window_sg_f32", "crp_window_f32"}
    for stem, name in (("halo", "crp_halo_f32"), ("ragged", "crp_ragged_f32")):
        if MMA_SYNC_BODY not in text(f"{stem}.cu"):
            got.add(name)
    return got


def libraries(baselines, split: bool, point: str = "fp64") -> tuple:
    """``({tree: [ctypes libraries]}, {tree: its fp32 highest entries that
    take the TF32 planes})``: this tree (``"this"``), each baseline
    (``"baseline:DIR"``), at ``highest`` the copy in the other design
    (``"design:ring"``, :data:`RING_EDITS`, built for #3 and #4 alone) and,
    with ``split``, the split copies of this tree's ``dd_tc.cu`` (fp64) or
    ``x3_wgmma.cuh`` (``highest``) (``"split:VARIANT"``), one ``nvcc`` a
    source, all started together."""
    highest = point == "highest"
    stems = HIGHEST_STEMS if highest else STEMS
    jobs = {"this": (_build.CSRC, {}, ())}
    for base in baselines:
        jobs[f"baseline:{base}"] = (pathlib.Path(base), {}, ())
    splits, ring = {}, {}
    if highest:
        ring["design:ring"] = (_build.CSRC, {
            name: edited((_build.CSRC / name).read_text(), edits, "f64_ab")
            for name, edits in RING_EDITS.items()}, ())
        if split:
            header = edited((_build.CSRC / "x3_wgmma.cuh").read_text(),
                            X3_EDITS + TF32_EDITS, "f64_ab")
            splits = {f"split:{variant}": (_build.CSRC, {"x3_wgmma.cuh": header}, macros)
                      for variant, macros in HIGHEST_SPLITS.items()}
    elif split:
        body = (_build.CSRC / "dd_tc.cu").read_text()
        splits = {f"split:{variant}": (_build.CSRC,
                                       {"dd_tc.cu": edited(body, edits, "f64_ab")}, ())
                  for variant, edits in SPLITS.items()}
    planes = {tree: takes_planes(src, texts)
              for tree, (src, texts, _) in {**jobs, **ring, **splits}.items()}
    libs = {}
    for out, js, js_stems in ((OUT, jobs, stems), (OUT / "ring", ring, RING_STEMS),
                              (OUT / "split", splits, stems if highest else ("dd_tc",))):
        if js:
            for (tree, _), path in build_copies(out, js, js_stems, "f64_ab").items():
                libs.setdefault(tree, []).append(ctypes.CDLL(str(path)))
    return libs, planes


def entry_of(libs, name):
    """The ctypes function ``name`` from the first library that has it."""
    for lib in libs:
        if hasattr(lib, name):
            return getattr(lib, name)
    raise RuntimeError(f"f64_ab: no library of the tree has {name}")


def engine(a, p: int, kernel: str, dev):
    """``RowParaSpmm`` over p nnz-balanced row shards of ``a`` in its dtype
    (fp64, or fp32 at ``highest``) at n = N on ``dev``, and its B shards
    for the analytic B."""
    from .. import RowParaSpmm, SpmmConfig, csr_row_partition, fill_b

    d = csr_row_partition(a.rowptr, p)
    eng = RowParaSpmm(a, d, d, N, device=dev, dtype=a.val.dtype,
                      config=SpmmConfig(kernel=kernel, mxu_precision="highest"))
    return eng, eng.shard_b(np.asarray(fill_b(0, a.ncol, 0, N, dtype=a.val.dtype)))


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


def planes_of(args) -> tuple:
    """The panel operand of a kernel's args as a tuple of tensors: the
    pair (#12's and #6's TF32 planes at highest), or the one tensor
    (#3's and #4's stacked planes, fp64 panels)."""
    got = next(t for t in args if isinstance(t, tuple)
               or (isinstance(t, torch.Tensor) and t.dim() >= 3))
    return got if isinstance(got, tuple) else (got,)


def runner(fn, op, args, stream, panels=None):
    """A call of entry ``fn`` on the op's args, its output allocated once;
    raises on a CUDA error.  ``panels``: passed in the place of the args'
    (the fp32 panels for a tree whose entry takes them, the args holding
    their TF32 planes)."""
    extra = ()
    given = planes_of(args) if panels is None else (panels,)
    if op.variant == "halo":  # #12: rows, ws, panels (or planes), C; then rows16
        from ..kernels.spmm_halo import stacked_chunk_rows

        ws, _, _, _, chunk_src, b = args[:6]
        rows, rows16 = stacked_chunk_rows(chunk_src, b)
        s_, G, TM, W = given[0].shape
        ptrs, extra, shape = (rows, ws, *given), (int(rows16),), (s_, G * TM, b.shape[-1])
        G *= s_
    else:
        if op.variant in ("uniform", "window"):  # #3, #4: ws, tiles (or planes), b
            ws, _, b = args[:3]
            G, ptrs = ws.shape[0], (ws, *given, b)
        else:  # #6: step_g, group_ptr, starts, panels (or planes), b
            _, group_ptr, starts, _, b = args
            G, ptrs = group_ptr.shape[0] - 1, (group_ptr, starts, *given, b)
        TM, W = given[0].shape[-2:]
        shape = (G * TM, b.shape[1])
    n = b.shape[-1]
    c = torch.empty(shape, dtype=given[0].dtype, device=b.device)
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
    """ms of ``torch.sparse_csr_tensor @ B`` in ``a``'s dtype on the CSR
    rows ``rows`` of ``a`` and the analytic B (the library's time for the
    same product)."""
    from .. import fill_b

    r0, r1 = rows
    rp = a.rowptr[r0:r1 + 1] - a.rowptr[r0]
    sl = slice(int(a.rowptr[r0]), int(a.rowptr[r1]))
    s = torch.sparse_csr_tensor(torch.from_numpy(rp.astype(np.int64)),
                                torch.from_numpy(a.colidx[sl].astype(np.int64)),
                                torch.from_numpy(a.val[sl]), size=(r1 - r0, a.ncol)).to(dev)
    b = torch.from_numpy(np.asarray(fill_b(0, a.ncol, 0, N, dtype=a.val.dtype))).to(dev)
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
    parser.add_argument("--point", choices=("fp64", "highest"), default="fp64",
                        help="the fp64 entries (default) or the fp32 ones at highest")
    parser.add_argument("--baseline", action="append", default=[],
                        help="another kernels/csrc tree to time as it is")
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--split", action="store_true",
                        help="also time this tree's body without copies or products")
    parser.add_argument("--p", type=int, action="append", choices=(1, 4),
                        help="the cases at this p (default: every case)")
    parser.add_argument("--case", action="append", default=[],
                        help="the cases of this entry (default: every case)")
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
    highest = args.point == "highest"
    cases, gens = (HIGHEST_CASES, HIGHEST_MATRICES) if highest else (CASES, MATRICES)
    tol, bits = (HIGHEST_TOL, torch.int32) if highest else (TOL, torch.int64)
    libs, planes_by_tree = libraries(args.baseline, args.split, args.point)
    stream = torch.cuda.current_stream(dev).cuda_stream
    matrices = {}
    for (label, p, kernel), name in cases.items():
        if (args.p and p not in args.p) or (args.case and name not in args.case):
            continue
        if label not in matrices:
            gen, kw = gens[label]
            matrices = {label: getattr(synth, gen)(**kw)}  # one matrix held at a time
        a = matrices[label]
        op, kargs, plain, rows = pack(a, p, kernel, dev)
        trees = {tree: tree_libs for tree, tree_libs in libs.items()
                 if tree != "design:ring" or name in RING_ENTRIES}
        # the fp32 panels, for the trees whose entry takes them (rebuilt
        # exactly from the big plane: #3's and #4's stacked planes' first)
        given = planes_of(kargs)
        fp32 = (tf32_panels(given if len(given) == 2 else given[0]) if highest
                and any(name not in planes_by_tree[tree] for tree in trees) else None)
        runs = {tree: runner(entry_of(tree_libs, name), op, kargs, stream,
                             None if name in planes_by_tree[tree] or not highest else fp32)
                for tree, tree_libs in trees.items()}
        first = None
        for tree, run in runs.items():
            if tree.startswith("split:"):
                continue
            c = run().clone()
            err = float((c - plain).norm() / plain.norm())
            if err > tol:
                raise RuntimeError(f"f64_ab: {label} p={p} {name} of {tree} vs plain "
                                   f"{err:.3e}")
            if tree == "this":
                first = c
                if not torch.equal(c.view(bits), run().view(bits)):
                    raise RuntimeError(f"f64_ab: {label} p={p} {name}: two launches differ")
            if tree == "design:ring" and not torch.equal(c.view(bits), first.view(bits)):
                raise RuntimeError(f"f64_ab: {label} p={p} {name}: the ring design's C "
                                   "differs from this tree's")
        del first, c
        times = {tree: [] for tree in runs}
        for r in range(args.rounds):
            for tree in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                times[tree].append(median_ms(runs[tree], dev, 5, 5))
        panels = planes_of(kargs)[0]
        if highest and op.variant in ("uniform", "window"):  # (2, G, TM, W): one plane
            panels = panels[0]
        gflop = 2.0 * panels.numel() * N / 1e9
        median = {tree: statistics.median(t) for tree, t in times.items()}
        case = f"{label} p={p} {kernel}"
        bounds = (dict(design_ms_tf32=3 * gflop / PEAK["tf32"] * 1e12) if highest else
                  dict(design_ms_fp64_tc=gflop / PEAK["fp64_tc"] * 1e12,
                       design_ms_fp64=gflop / PEAK["fp64"] * 1e12))
        for tree, t in times.items():
            print(json.dumps(dict(
                case=case, matrix=label, p=p, entry=name, variant=op.variant, tree=tree,
                ms=t, median_ms=median[tree], gflop=gflop, tflops=gflop / median[tree],
                **bounds, panels=list(panels.shape), n=N, card=card)), flush=True)
        del op, kargs, plain, runs, fp32, given, panels
        torch.cuda.empty_cache()
        print(json.dumps(dict(case=case, entry=name, over_this={
            tree: median[tree] / median["this"] for tree in times},
            cusparse_rows=list(rows), cusparse_ms=cusparse_ms(a, rows, dev, median_ms),
            card=card)), flush=True)
    if not highest and (not args.p or 4 in args.p):  # C1 on the p = 4 cases' matrix
        dd_vs_auto(matrices["fp64 headline"], dev, median_ms, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
