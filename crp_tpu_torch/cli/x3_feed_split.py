"""Where the time of the wgmma body goes: its products against its copies.

Kernel #1 (``crp_window_sg_presplit``, ``kernels/csrc/x3_wgmma.cuh``)
overlaps two streams of work: the copies into its shared-memory ring (TMA
for the bf16 panel tiles, the producer warp's B copies) and the products
(B's split in registers, three ``wgmma`` per k16, the IEEE adds of each
slice's partial).  Kernel #2 (``crp_window_sg_bf16``) is the same body's
one-pass mode: the hi tiles and a bf16 B plane in a deeper ring, one
``wgmma`` per k16.  The ragged #7 (``crp_ragged_presplit``) and #8
(``crp_ragged_bf16``) are the same two modes walking each group's chunks.
This tool builds variants of ``window_sg.cu`` and ``ragged.cu`` with one
or both streams compiled out and times each kernel in each variant, in
two rounds, with CUDA events: #1 and #2 on the headline's x3 pack
(pwtk-class, n = 256), #7 and #8 on cplaw's ragged x3 pack (n = 256); #2
and #8 on the pack's hi panels and B cast to bf16, as the ``default``
exec casts it:

  * ``full`` — the body as it is;
  * ``products_only`` — no copies: the consumers multiply whatever the
    ring holds;
  * ``copies_only`` — no products: the consumers only wait and release;
  * ``panels_only`` / ``b_only`` — no products, and one of the copies.

The edits are made to a copy of the sources under
``build/crp_tpu_torch/x3_feed_split/`` (never to ``kernels/csrc``); a
variant's C is meaningless, only its time counts.  Each ``--baseline``
directory (another tree's ``kernels/csrc``, such as the parent commit's
unpacked under ``build/``) is built as it is and timed in the same rounds,
so that two versions of a kernel compare within one call on one card.
One JSON line per kernel and variant, with the device's name; nothing is
written to a file.

On the card::

    python -m crp_tpu_torch.cli.x3_feed_split [--baseline CSRC_DIR ...]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys

import numpy as np
import torch

from ..kernels import _build
from ._csrc_variants import build as build_copies
from ._csrc_variants import edited

# (text of x3_wgmma.cuh, its replacement): each puts one part of the body
# under a macro; every anchor must occur exactly once
EDITS = (
    ("#pragma unroll\n            for (int h = 0; h < X3_BK / X3_SLICE; ++h) {",
     "#ifndef X3_NO_PRODUCTS\n#pragma unroll\n"
     "            for (int h = 0; h < X3_BK / X3_SLICE; ++h) {"),
    ("            }\n            __syncwarp();\n"
     "            if (lane == 0) mbar_arrive(empty0 + 8 * s);",
     "            }\n#endif\n            __syncwarp();\n"
     "            if (lane == 0) mbar_arrive(empty0 + 8 * s);"),
    ("            if (lane == 0) {\n                mbar_arrive_tx(",
     "#ifdef X3_NO_PANELS\n            if (lane == 0) mbar_arrive(full0 + 8 * s);\n"
     "            if (false) {\n#else\n            if (lane == 0) {\n#endif\n"
     "                mbar_arrive_tx("),
    ("            x3_load_b<MODE, B_VEC>(",
     "#ifdef X3_NO_B\n            mbar_arrive(full0 + 8 * s);\n            if (false)\n"
     "#endif\n            x3_load_b<MODE, B_VEC>("),
)
VARIANTS = {
    "full": (),
    "products_only": ("X3_NO_PANELS", "X3_NO_B"),
    "copies_only": ("X3_NO_PRODUCTS",),
    "panels_only": ("X3_NO_PRODUCTS", "X3_NO_B"),
    "b_only": ("X3_NO_PRODUCTS", "X3_NO_PANELS"),
}
OUT = _build.BUILD_DIR / "x3_feed_split"
# label -> (library, entry): #1 and #2 on the headline, #7 and #8 on cplaw
KERNELS = {
    "x3": ("window_sg", "crp_window_sg_presplit"),
    "one_pass": ("window_sg", "crp_window_sg_bf16"),
    "ragged_x3": ("ragged", "crp_ragged_presplit"),
    "ragged_one_pass": ("ragged", "crp_ragged_bf16"),
}
CPLAW = dict(n=786432, avg_degree=16, comm_size=1024, seed=1234)  # synth:cplaw:786432:16:1024
N = 256


def edited_header() -> str:
    """``x3_wgmma.cuh`` with the parts of its body under the macros of
    :data:`VARIANTS`; raises where an anchor is not found exactly once."""
    return edited((_build.CSRC / "x3_wgmma.cuh").read_text(), EDITS, "x3_feed_split")


def build(baselines=()) -> dict:
    """Each variant's libraries, and each baseline tree's as they are,
    built by one ``nvcc`` each, all started together: ``{(variant, stem):
    path}``."""
    header = edited_header()
    jobs = {name: (_build.CSRC, {"x3_wgmma.cuh": header}, macros)
            for name, macros in VARIANTS.items()}
    for base in baselines:
        jobs[f"baseline:{base}"] = (pathlib.Path(base), {}, ())
    return build_copies(OUT, jobs, sorted({stem for stem, _ in KERNELS.values()}),
                        "x3_feed_split")


def headline_args(dev) -> dict:
    """#1's and #2's pointer arguments and int64 scalars on the headline's
    x3 pack, n = N."""
    from ..sparse.synth import banded_random_csr, fill_b
    from .presplit_b_sweep import HEADLINE, pack_x3

    a = banded_random_csr(HEADLINE["nrow"], nnz_per_row=HEADLINE["nnz_per_row"],
                          bandwidth=HEADLINE["bandwidth"], seed=HEADLINE["seed"],
                          dtype=np.float32)
    (ws, ah, al, _), op = pack_x3(a, dev)
    G, TM, W = ah.shape
    b = torch.zeros((op.min_b_rows, N), device=dev)
    b[: a.ncol] = torch.from_numpy(fill_b(0, a.ncol, 0, N, dtype=np.float32)).to(dev)
    c = torch.empty((G * TM, N), device=dev)
    scalars = (G, TM, W, N)
    return {"x3": ((ws, ah, al, b, c), scalars),
            "one_pass": ((ws, ah, b.to(torch.bfloat16), c), scalars)}


def cplaw_args(dev) -> dict:
    """#7's and #8's pointer arguments and int64 scalars on cplaw's ragged
    x3 pack (the engine's: the gate takes the ragged pack, the chooser
    (TM, Wc)), n = N."""
    from ..kernels.dispatch import pack_local_kernel
    from ..sparse.synth import fill_b, powerlaw_community_csr

    a = powerlaw_community_csr(**CPLAW, dtype=np.float32)
    arrays, op = pack_local_kernel(
        [(a.rowptr, np.asarray(a.colidx, np.int32), a.val)], a.nrow, np.float32,
        "pallas", device=dev, mxu_precision="x3",
    )
    if op.variant != "ragged" or op.scheme != "x3":
        raise ValueError(f"x3_feed_split: cplaw takes the {op.variant!r} pack")
    b = torch.zeros((op.min_b_rows, N), device=dev)
    b[: a.ncol] = torch.from_numpy(fill_b(0, a.ncol, 0, N, dtype=np.float32)).to(dev)
    _, group_ptr, starts, ah, al, _ = op.kernel_args(tuple(x[0] for x in arrays), b)
    G, TM, Wc = group_ptr.numel() - 1, ah.shape[1], ah.shape[2]
    c = torch.empty((G * TM, N), device=dev)
    scalars = (G, TM, Wc, N)
    return {"ragged_x3": ((group_ptr, starts, ah, al, b, c), scalars),
            "ragged_one_pass": ((group_ptr, starts, ah, b.to(torch.bfloat16), c), scalars)}


def main(argv=None, rounds: int = 2) -> int:
    parser = argparse.ArgumentParser(prog="python -m crp_tpu_torch.cli.x3_feed_split")
    parser.add_argument("--baseline", action="append", default=[],
                        help="another kernels/csrc tree to time as it is")
    args = parser.parse_args(argv)
    from ..utils.timers import median_ms

    if not torch.cuda.is_available():
        print("x3_feed_split: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    libs = build(args.baseline)
    inputs = {**headline_args(dev), **cplaw_args(dev)}
    fns = {}
    for (name, stem), path in libs.items():
        lib = ctypes.CDLL(str(path))
        for kernel, (kernel_stem, entry) in KERNELS.items():
            if kernel_stem != stem:
                continue
            fn = getattr(lib, entry)
            ptrs, scalars = inputs[kernel]
            fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int64] * len(scalars)
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            fns[kernel, name] = fn
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(kernel, fn):
        ptrs, scalars = inputs[kernel]
        rc = fn(*(t.data_ptr() for t in ptrs), *scalars, stream)
        if rc:
            raise RuntimeError(f"x3_feed_split: CUDA error {rc}")

    times = {key: [] for key in fns}
    for _ in range(rounds):
        for (kernel, name), fn in fns.items():
            times[kernel, name].append(median_ms(lambda: run(kernel, fn), dev, 5, 10))
    for (kernel, name), t in times.items():
        G, TM, W, n = inputs[kernel][1]
        print(json.dumps(dict(kernel=KERNELS[kernel][1], variant=name, ms=t, G=G, TM=TM,
                              W=W, n=n, device=torch.cuda.get_device_name(dev))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
