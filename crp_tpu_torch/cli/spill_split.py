"""Where the time of the spill (#9) and gather (#10) kernels goes.

The two kernels are one body in ``kernels/csrc/spill.cu``
(``crp_spill_blocks`` with C, ``crp_gather_blocks`` without).  This tool
times them with CUDA events on the two packs the smoke's main paths give
them, n = 256:

  * ``spill`` — cplaw's fused spill at x3 (the engine's ragged pack,
    ``powerlaw_community_csr(786432, 16, 1024)``), C the (M, n) of the
    ragged kernel's shape;
  * ``gather`` — the scrambled cplaw (``permute=True``) in the gather
    kind's pack at x3.

Each kernel is timed in the body as it is (``full``), in a copy with its
B row loads compiled out (``no_b_loads``: the slot walk, C and the output
stay), in a copy of fewer, wider warps (``wide``: 256 columns and 8 B rows
in flight a warp, 2 blocks an SM, where ``full`` has 128 and 4 in 3
blocks) and in one that reads C and writes the output through L1 and L2
as B is read (``plain_cache``, where ``full`` streams them evict-first),
all in the same rounds.  The copies are built under
``build/crp_tpu_torch/spill_split/``, never in ``kernels/csrc``; a
variant's output is meaningless, only its time counts.  One JSON line per
kernel and variant, with the card's name and power limit.

On the card::

    python -m crp_tpu_torch.cli.spill_split
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from ..kernels import _build
from ..kernels.spmm_ragged import ROW_TILE
from ._csrc_variants import build as build_copies
from ._csrc_variants import edited

OUT = _build.BUILD_DIR / "spill_split"
CPLAW = dict(n=786432, avg_degree=16, comm_size=1024, seed=1234)  # synth:cplaw:786432:16:1024
N = 256
# (anchor in spill.cu, replacement[, count]) edits per variant; each anchor
# must occur exactly that often (once by default)
EDITS = {
    "full": (),
    "no_b_loads": (
        ("                        load_vec<V, LD_NC>(brow + cc, &bv[u][j * V]);",
         "                        for (int e = 0; e < V; ++e) bv[u][j * V + e] = (float)col;"),
    ),
    "wide": (
        ("constexpr int RW_MIN_BLOCKS = 3;", "constexpr int RW_MIN_BLOCKS = 2;"),
        ("constexpr int RW_ACC = 4;", "constexpr int RW_ACC = 8;"),
        ("constexpr int RW_BATCH = 4;", "constexpr int RW_BATCH = 8;"),
    ),
    "plain_cache": (
        ("load_tile<V, LD_CS>(", "load_tile<V, LD_NC>(", 3),
        ("store_tile<V, true>(out, ", "store_tile<V, false>(out, ", 3),
    ),
}


def edited_sources() -> dict:
    """``spill.cu`` as each variant builds it: ``{variant: text}``."""
    text = (_build.CSRC / "spill.cu").read_text()
    return {variant: edited(text, edits, "spill_split") for variant, edits in EDITS.items()}


def build() -> dict:
    """Every variant's ``spill`` library, one ``nvcc`` each, all started
    together: ``{variant: path}``."""
    jobs = {variant: (_build.CSRC, {"spill.cu": text}, ())
            for variant, text in edited_sources().items()}
    return {variant: path
            for (variant, _), path in build_copies(OUT, jobs, ["spill"], "spill_split").items()}


def packs(dev) -> dict:
    """Per kernel, its inputs on the card: the row-ordered view, C (the
    spill) and B, the output rows M and the mode (x3)."""
    from ..kernels.dispatch import _pack_gather, pack_local_kernel
    from ..kernels.spmm_ragged import SPILL_MODES
    from ..sparse.synth import fill_b, powerlaw_community_csr

    out = {}
    a = powerlaw_community_csr(**CPLAW, dtype=np.float32)
    arrays, op = pack_local_kernel([(a.rowptr, np.asarray(a.colidx, np.int32), a.val)],
                                   a.nrow, np.float32, "pallas", device=dev,
                                   mxu_precision="x3")
    if op.variant != "ragged" or op.spill_impl != "pallas":
        raise ValueError(f"spill_split: cplaw takes {op.variant!r} / {op.spill_impl!r}")
    b = torch.zeros((op.min_b_rows, N), device=dev)
    b[: a.ncol] = torch.from_numpy(fill_b(0, a.ncol, 0, N, dtype=np.float32)).to(dev)
    M = op.roofline["G"] * op.roofline["TM"]
    c = torch.randn((M, N), device=dev)
    view = op.spill_args(tuple(x[0] for x in arrays), c, b)[-1]
    out["spill"] = dict(view=view, c=c, b=b, M=M, mode=SPILL_MODES["x3"])
    del arrays, op, a
    a = powerlaw_community_csr(**CPLAW, permute=True, dtype=np.float32)
    arrays, op = _pack_gather([(a.rowptr, np.asarray(a.colidx, np.int32), a.val)],
                              a.nrow, np.float32, "x3", dev)
    b = torch.from_numpy(np.asarray(fill_b(0, a.ncol, 0, N, dtype=np.float32))).to(dev)
    view = op.kernel_args(tuple(x[0] for x in arrays), b)[-1]
    out["gather"] = dict(view=view, c=None, b=b, M=op.M, mode=SPILL_MODES["x3"])
    return out


def runner(lib, kernel, x, stream):
    """A call of ``kernel``'s entry in ``lib`` on ``x``: its workspace and
    output allocated once, its counters zeroed at each call, as the
    wrapper's are at each launch."""
    has_c = kernel == "spill"
    n, M = x["b"].shape[1], x["M"]
    vcols, vvals, items, parts = x["view"]
    out = torch.empty((M, n), device=x["b"].device)
    work = torch.empty((parts.numel(), n), device=out.device)
    counters = torch.zeros(parts.numel() * -(-n // ROW_TILE), dtype=torch.int32,
                           device=out.device)
    c = (x["c"].data_ptr(),) if has_c else ()
    ptrs = (vcols.data_ptr(), vvals.data_ptr(), items.data_ptr(), parts.data_ptr(), *c,
            x["b"].data_ptr(), out.data_ptr(), work.data_ptr(), counters.data_ptr())
    ints = (items.shape[0] - 1, M, n, x["mode"])
    fn = getattr(lib, "crp_spill_blocks" if has_c else "crp_gather_blocks")
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int64] * len(ints)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run():
        counters.zero_()
        rc = fn(*ptrs, *ints, stream)
        if rc:
            raise RuntimeError(f"spill_split: {kernel}: CUDA error {rc}")
        return out

    return run


def main(argv=None, rounds: int = 2) -> int:
    argparse.ArgumentParser(prog="python -m crp_tpu_torch.cli.spill_split",
                            description=__doc__.split("\n\n")[0]).parse_args(argv)
    from ..utils.timers import median_ms

    if not torch.cuda.is_available():
        print("spill_split: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    libs = {variant: ctypes.CDLL(str(path)) for variant, path in build().items()}
    inputs = packs(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    runs = {(kernel, variant): runner(lib, kernel, x, stream)
            for variant, lib in libs.items() for kernel, x in inputs.items()}
    times = {key: [] for key in runs}
    for _ in range(rounds):
        for key, run in runs.items():
            times[key].append(median_ms(run, dev, 5, 20))
    for (kernel, variant), t in times.items():
        x = inputs[kernel]
        print(json.dumps(dict(kernel=kernel, variant=variant, ms=t,
                              slots=int(x["view"][0].numel()), M=x["M"], n=N,
                              card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
