"""Where the time of the wgmma body goes: its products against its copies.

Kernel #1 (``crp_window_sg_presplit``, ``kernels/csrc/x3_wgmma.cuh``)
overlaps two streams of work: the copies into its shared-memory ring (TMA
for the bf16 panel tiles, the producer warp's B copies) and the products
(B's split in registers, three ``wgmma`` per k16, the IEEE adds of each
slice's partial).  Kernel #2 (``crp_window_sg_bf16``) is the same body's
one-pass mode: the hi tiles and a bf16 B plane in a deeper ring, one
``wgmma`` per k16.  This tool builds variants of ``window_sg.cu`` with one
or both of them compiled out and times each, for both kernels, on the
headline's x3 pack (pwtk-class, n = 256; #2 on its hi panels and B cast to
bf16, as the ``default`` exec casts it), in two rounds, with CUDA events:

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
so that two versions of the body compare within one call on one card.  One
JSON line per kernel and variant, with the device's name; nothing is
written to a file.

On the card::

    python -m crp_tpu_torch.cli.x3_feed_split [--baseline CSRC_DIR ...]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import torch

from ..kernels import _build

# (text of x3_wgmma.cuh, its replacement): each puts one part of the body
# under a macro; every anchor must occur exactly once
EDITS = (
    ("#pragma unroll\n        for (int h = 0; h < X3_BK / X3_SLICE; ++h) {",
     "#ifndef X3_NO_PRODUCTS\n#pragma unroll\n"
     "        for (int h = 0; h < X3_BK / X3_SLICE; ++h) {"),
    ("        __syncwarp();\n        if (lane == 0) mbar_arrive(empty0 + 8 * s);",
     "#endif\n        __syncwarp();\n        if (lane == 0) mbar_arrive(empty0 + 8 * s);"),
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
KERNELS = {"x3": "crp_window_sg_presplit", "one_pass": "crp_window_sg_bf16"}


def edited_header() -> str:
    """``x3_wgmma.cuh`` with the parts of its body under the macros of
    :data:`VARIANTS`; raises where an anchor is not found exactly once."""
    text = (_build.CSRC / "x3_wgmma.cuh").read_text()
    for anchor, new in EDITS:
        if text.count(anchor) != 1:
            raise ValueError(f"x3_feed_split: anchor not found once: {anchor!r}")
        text = text.replace(anchor, new)
    return text


def build(baselines=()) -> dict:
    """Each variant's library, and each baseline tree's as it is, built by
    one ``nvcc`` each, all started together: ``{variant: path}``."""
    header = edited_header()
    shutil.rmtree(OUT, ignore_errors=True)
    jobs = {name: (_build.CSRC, header, macros) for name, macros in VARIANTS.items()}
    for base in baselines:
        jobs[f"baseline:{base}"] = (pathlib.Path(base), None, ())
    procs = {}
    for i, (name, (src, text, macros)) in enumerate(jobs.items()):
        d = OUT / f"v{i}"
        shutil.copytree(src, d)
        if text is not None:
            (d / "x3_wgmma.cuh").write_text(text)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *(f"-D{m}" for m in macros),
               "-o", str(d / "lib.so"), str(d / "window_sg.cu")]
        procs[name] = (d / "lib.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (_, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"x3_feed_split: nvcc failed for {name}:\n{out}")
    return {name: path for name, (path, _) in procs.items()}


def main(argv=None, rounds: int = 2) -> int:
    parser = argparse.ArgumentParser(prog="python -m crp_tpu_torch.cli.x3_feed_split")
    parser.add_argument("--baseline", action="append", default=[],
                        help="another kernels/csrc tree to time as it is")
    args = parser.parse_args(argv)
    from ..sparse.synth import banded_random_csr, fill_b
    from ..utils.timers import median_ms
    from .presplit_b_sweep import HEADLINE, pack_x3

    if not torch.cuda.is_available():
        print("x3_feed_split: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    libs = build(args.baseline)
    a = banded_random_csr(HEADLINE["nrow"], nnz_per_row=HEADLINE["nnz_per_row"],
                          bandwidth=HEADLINE["bandwidth"], seed=HEADLINE["seed"],
                          dtype=np.float32)
    (ws, ah, al, _), op = pack_x3(a, dev)
    G, TM, W = ah.shape
    n = 256
    b = torch.zeros((op.min_b_rows, n), device=dev)
    b[: a.ncol] = torch.from_numpy(fill_b(0, a.ncol, 0, n, dtype=np.float32)).to(dev)
    bh = b.to(torch.bfloat16)
    c = torch.empty((G * TM, n), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = {"x3": (ws, ah, al, b, c), "one_pass": (ws, ah, bh, c)}
    fns = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        for kernel, entry in KERNELS.items():
            fn = getattr(lib, entry)
            fn.argtypes = ([ctypes.c_void_p] * len(ptrs[kernel]) + [ctypes.c_int64] * 4
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            fns[kernel, name] = fn

    def run(kernel, fn):
        rc = fn(*(t.data_ptr() for t in ptrs[kernel]), G, TM, W, n, stream)
        if rc:
            raise RuntimeError(f"x3_feed_split: CUDA error {rc}")

    times = {key: [] for key in fns}
    for _ in range(rounds):
        for (kernel, name), fn in fns.items():
            times[kernel, name].append(median_ms(lambda: run(kernel, fn), dev, 5, 10))
    for (kernel, name), t in times.items():
        print(json.dumps(dict(kernel=KERNELS[kernel], variant=name, ms=t, G=G, TM=TM,
                              W=W, n=n, device=torch.cuda.get_device_name(dev))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
