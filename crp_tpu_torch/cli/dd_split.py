"""Where the time of #11, the fp64-class kernel, goes.

Kernel #11 (``crp_ragged_dd_f64tc``, ``kernels/csrc/dd_tc.cu``) overlaps
two streams of work: its producer warpgroup's ``cp.async`` copies of each
32-deep k slice (the panel's A slice, B's rows) into its shared-memory
ring, and its consumer warpgroups' DMMA products (``mma.sync`` fp64 on
the tensor cores).  This tool builds
copies of ``dd_tc.cu`` with one stream compiled out, or with another
DMMA shape, and times each with CUDA events, in the same rounds, on the
fp64 banded pack of the smoke's fp64 path (``banded_random_csr(217918, 53,
256)``, the ``dd_mxu`` total cover at (TM, Wc) = (128, 512), n = 256):

  * ``full`` — the body as it is;
  * ``products_only`` — no copies: the consumers multiply whatever the
    ring holds;
  * ``copies_only`` — no products: the consumers only wait and release;
  * ``products_only_<shape>`` — the products alone in each DMMA shape the
    body does not use (``m8n8k4``, Ampere's, two to a 16 x 8 tile;
    ``m16n8k4``, ``m16n8k8``, ``m16n8k16``, Hopper's);
  * ``full_<shape>`` — the whole body in that shape.

The copies go under ``build/crp_tpu_torch/dd_split/``, never into
``kernels/csrc``; a variant without copies or products computes nothing
meaningful, only its time counts.  A shape that the card's ``ptxas``
refuses is printed as refused and dropped.  One JSON line per variant:
its ms in each round (every variant once a round, in alternating order),
their median, TFLOP/s of panel products at the median, and its library's
``crp_dd_layout`` (registers, spill bytes, blocks per SM), with the card's
name and power limit; then the shape whose whole body has the least
median.

On the card::

    python -m crp_tpu_torch.cli.dd_split
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys

import numpy as np
import torch

from ..kernels import _build
from ._csrc_variants import build as build_copies
from ._csrc_variants import edited

OUT = _build.BUILD_DIR / "dd_split"
DD_BAND = dict(n=217918, nnz_per_row=53, bandwidth=256)  # the smoke's fp64 banded matrix
N = 256
FP64_TC_PEAK = 67e12  # FLOP/s, H100 SXM data sheet, dense
# name -> (DD_MMA_M, DD_MMA_K)
SHAPES = {"m8n8k4": (8, 4), "m16n8k4": (16, 4), "m16n8k8": (16, 8), "m16n8k16": (16, 16)}
# (anchor in dd_tc.cu, replacement): each must occur exactly once
NO_COPIES = (
    ("cp_async<16>(a_dst, a_src, true);", ""),
    ("cp_async<B_BYTES>(b_dst, b_src, col_ok);", ""),
    ("cp_async<B_BYTES>(b_dst, b_src, ok);", ""),  # B through the chunk table (#12)
)
NO_PRODUCTS = (("compute_slice(st);", ""),)
_SHAPE_LINE = r"constexpr int DD_MMA_{} = (\d+);"


def body_shape(text: str) -> str:
    """The DMMA shape the body declares (``DD_MMA_M``, ``DD_MMA_K``)."""
    mk = tuple(int(re.search(_SHAPE_LINE.format(x), text).group(1)) for x in "MK")
    return next(name for name, shape in SHAPES.items() if shape == mk)


def shape_edits(text: str, shape: str) -> tuple:
    """The edits that set the body's DMMA shape to ``shape``."""
    return tuple((re.search(_SHAPE_LINE.format(x), text).group(0),
                  f"constexpr int DD_MMA_{x} = {v};")
                 for x, v in zip("MK", SHAPES[shape]))


def edited_sources() -> dict:
    """``dd_tc.cu`` as each variant builds it: ``{variant: text}``."""
    text = (_build.CSRC / "dd_tc.cu").read_text()
    edits = {"full": (), "products_only": NO_COPIES, "copies_only": NO_PRODUCTS}
    for shape in SHAPES:
        if shape != body_shape(text):
            edits[f"products_only_{shape}"] = NO_COPIES + shape_edits(text, shape)
            edits[f"full_{shape}"] = shape_edits(text, shape)
    return {variant: edited(text, e, "dd_split") for variant, e in edits.items()}


def build() -> tuple:
    """Every variant's ``dd_tc`` library, one ``nvcc`` each, all started
    together: ``({variant: path}, {variant: the end of nvcc's log})``.  A
    shape variant that does not build is refused; the body's own variants
    must build."""
    jobs = {variant: (_build.CSRC, {"dd_tc.cu": text}, ())
            for variant, text in edited_sources().items()}
    logs = {}
    got = build_copies(OUT, jobs, ["dd_tc"], "dd_split", refused=logs)
    refused = {variant: log.strip()[-400:] for (variant, _), log in logs.items()}
    for variant in ("full", "products_only", "copies_only"):
        if variant in refused:
            raise RuntimeError(f"dd_split: nvcc failed for {variant}:\n{refused[variant]}")
    return {variant: path for (variant, _), path in got.items()}, refused


def pack(dev) -> dict:
    """The fp64 banded matrix's dd_mxu pack on the card, its B (padded to
    the rows the kernel may read) and the launch's scalars."""
    from ..kernels.dispatch import _pack_dd_mxu
    from ..sparse.synth import banded_random_csr, fill_b

    a = banded_random_csr(DD_BAND["n"], nnz_per_row=DD_BAND["nnz_per_row"],
                          bandwidth=DD_BAND["bandwidth"])
    arrays, op = _pack_dd_mxu([(a.rowptr, a.colidx.astype(np.int32), a.val)], a.nrow, dev)
    b = torch.zeros((max(op.min_b_rows, a.ncol), N), dtype=torch.float64, device=dev)
    b[: a.ncol] = torch.from_numpy(np.asarray(fill_b(0, a.ncol, 0, N))).to(dev)
    _, group_ptr, starts, panels, b = op.kernel_args(tuple(x[0] for x in arrays), b)
    rl = op.roofline
    return dict(group_ptr=group_ptr, starts=starts, panels=panels, b=b, G=rl["G"],
                TM=rl["TM"], Wc=rl["W"], S=rl["S"])


def runner(lib, x, stream):
    """A call of ``crp_ragged_dd_f64tc`` in ``lib`` on the pack ``x``, its
    output allocated once."""
    n = x["b"].shape[1]
    c = torch.empty((x["G"] * x["TM"], n), dtype=torch.float64, device=x["b"].device)
    fn = lib.crp_ragged_dd_f64tc
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = tuple(x[k].data_ptr() for k in ("group_ptr", "starts", "panels", "b")) + (
        c.data_ptr(),)

    def run():
        rc = fn(*ptrs, x["G"], x["TM"], x["Wc"], n, stream)
        if rc:
            raise RuntimeError(f"dd_split: CUDA error {rc}")
        return c

    return run


def layout(lib) -> dict:
    """The library's ``crp_dd_layout`` report as a dict of ints."""
    fn = lib.crp_dd_layout
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    out = ctypes.create_string_buffer(1024)
    if fn(out, len(out)):
        raise RuntimeError("dd_split: crp_dd_layout failed")
    return {k: int(v) for k, v in (kv.split("=") for kv in out.value.decode().split())}


def main(argv=None, rounds: int = 6) -> int:
    argparse.ArgumentParser(prog="python -m crp_tpu_torch.cli.dd_split",
                            description=__doc__.split("\n\n")[0]).parse_args(argv)
    from ..utils.timers import median_ms

    if not torch.cuda.is_available():
        print("dd_split: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    paths, refused = build()
    for variant, why in refused.items():
        print(json.dumps(dict(variant=variant, refused=why, card=card)), flush=True)
    libs = {variant: ctypes.CDLL(str(path)) for variant, path in paths.items()}
    x = pack(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    runs = {variant: runner(lib, x, stream) for variant, lib in libs.items()}
    # the full variants must agree with the body as it is
    ref = runs["full"]().clone()
    for variant, run in runs.items():
        if variant.startswith("full_"):
            d = float((run() - ref).norm() / ref.norm())
            if d > 1e-12:
                raise RuntimeError(f"dd_split: {variant} differs from full by {d:.3e}")
    # every variant once a round, the order reversed every other round,
    # so that a drift of the card's clock reaches them all alike
    times = {variant: [] for variant in runs}
    for r in range(rounds):
        for variant in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            times[variant].append(median_ms(runs[variant], dev, 5, 10))
    flop = 2.0 * x["S"] * x["TM"] * x["Wc"] * N
    median = {variant: float(np.median(t)) for variant, t in times.items()}
    for variant, t in times.items():
        print(json.dumps(dict(variant=variant, ms=t, median_ms=median[variant],
                              tflops=flop / median[variant] / 1e9,
                              bound_ms=flop / FP64_TC_PEAK * 1e3, S=x["S"], TM=x["TM"],
                              Wc=x["Wc"], n=N, layout=layout(libs[variant]), card=card)),
              flush=True)
    # the whole body in each shape: the body's own, and full_<shape>
    whole = {body_shape((_build.CSRC / "dd_tc.cu").read_text()): median["full"]}
    whole.update({v[len("full_"):]: m for v, m in median.items() if v.startswith("full_")})
    print(json.dumps(dict(fastest_shape=min(whole, key=whole.get), median_ms=whole,
                          card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
