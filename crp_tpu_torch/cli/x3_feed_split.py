"""Where the time of the x3 wgmma body goes: its products against its copies.

Kernel #1 (``crp_window_sg_presplit``, ``kernels/csrc/x3_wgmma.cuh``)
overlaps two streams of work: the copies into its shared-memory ring (TMA
for the bf16 panel tiles, the producer warp's B copies) and the products
(B's split in registers, three ``wgmma`` per k16, the IEEE adds of each
slice's partial).  This tool builds variants of ``window_sg.cu`` with one
or both of them compiled out and times each on the headline's x3 pack
(pwtk-class, n = 256), in two rounds, with CUDA events:

  * ``full`` — the body as it is;
  * ``products_only`` — no copies: the consumers multiply whatever the
    ring holds;
  * ``copies_only`` — no products: the consumers only wait and release;
  * ``panels_only`` / ``b_only`` — no products, and one of the copies.

The edits are made to a copy of the sources under
``build/crp_tpu_torch/x3_feed_split/`` (never to ``kernels/csrc``); a
variant's C is meaningless, only its time counts.  One JSON line per
variant, with the device's name; nothing is written to a file.

On the card::

    python -m crp_tpu_torch.cli.x3_feed_split
"""

from __future__ import annotations

import ctypes
import json
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
    ("            x3_load_b<B_PAIR, B_VEC>(",
     "#ifdef X3_NO_B\n            mbar_arrive(full0 + 8 * s);\n            if (false)\n"
     "#endif\n            x3_load_b<B_PAIR, B_VEC>("),
)
VARIANTS = {
    "full": (),
    "products_only": ("X3_NO_PANELS", "X3_NO_B"),
    "copies_only": ("X3_NO_PRODUCTS",),
    "panels_only": ("X3_NO_PRODUCTS", "X3_NO_B"),
    "b_only": ("X3_NO_PRODUCTS", "X3_NO_PANELS"),
}
OUT = _build.BUILD_DIR / "x3_feed_split"


def edited_header() -> str:
    """``x3_wgmma.cuh`` with the parts of its body under the macros of
    :data:`VARIANTS`; raises where an anchor is not found exactly once."""
    text = (_build.CSRC / "x3_wgmma.cuh").read_text()
    for anchor, new in EDITS:
        if text.count(anchor) != 1:
            raise ValueError(f"x3_feed_split: anchor not found once: {anchor!r}")
        text = text.replace(anchor, new)
    return text


def build() -> dict:
    """Each variant's library, built by one ``nvcc`` each, all started
    together: ``{variant: path}``."""
    header = edited_header()
    shutil.rmtree(OUT, ignore_errors=True)
    procs = {}
    for name, macros in VARIANTS.items():
        d = OUT / name
        shutil.copytree(_build.CSRC, d)
        (d / "x3_wgmma.cuh").write_text(header)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *(f"-D{m}" for m in macros),
               "-o", str(d / "lib.so"), str(d / "window_sg.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"x3_feed_split: nvcc failed for {name}:\n{out}")
    return {name: OUT / name / "lib.so" for name in VARIANTS}


def main(rounds: int = 2) -> int:
    from ..sparse.synth import banded_random_csr, fill_b
    from ..utils.timers import median_ms
    from .presplit_b_sweep import HEADLINE, pack_x3

    if not torch.cuda.is_available():
        print("x3_feed_split: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    libs = build()
    a = banded_random_csr(HEADLINE["nrow"], nnz_per_row=HEADLINE["nnz_per_row"],
                          bandwidth=HEADLINE["bandwidth"], seed=HEADLINE["seed"],
                          dtype=np.float32)
    (ws, ah, al, _), op = pack_x3(a, dev)
    G, TM, W = ah.shape
    n = 256
    b = torch.zeros((op.min_b_rows, n), device=dev)
    b[: a.ncol] = torch.from_numpy(fill_b(0, a.ncol, 0, n, dtype=np.float32)).to(dev)
    c = torch.empty((G * TM, n), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fns = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).crp_window_sg_presplit
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    def run(fn):
        rc = fn(ws.data_ptr(), ah.data_ptr(), al.data_ptr(), b.data_ptr(), c.data_ptr(),
                G, TM, W, n, stream)
        if rc:
            raise RuntimeError(f"x3_feed_split: CUDA error {rc}")

    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(median_ms(lambda: run(fn), dev, 5, 10))
    for name, t in times.items():
        print(json.dumps(dict(variant=name, ms=t, G=G, TM=TM, W=W, n=n,
                              device=torch.cuda.get_device_name(dev))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
