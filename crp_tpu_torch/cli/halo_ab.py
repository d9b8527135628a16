"""Time the fused halo kernel (#12) on one card, this tree beside others.

    python -m crp_tpu_torch.cli.halo_ab [--baseline CSRC_DIR ...] [--rounds R] [--variants]

Builds ``halo.cu`` of this tree and of each ``--baseline`` tree (another
``kernels/csrc``, say the parent's unpacked with ``git archive HEAD
crp_tpu_torch/kernels/csrc | tar -x -C build/parent``), packs the
headline (``bench.py``'s banded matrix) at p = 4 with the fused plan at
``x3``, ``default`` and ``highest``, n = 256, and times, in turns over
``R`` rounds, each tree's one-card entries (``crp_halo_x3``,
``crp_halo_bf16``, ``crp_halo_f32`` on the stacked B; a baseline whose
``crp_halo_f32`` is still the ``mma.sync`` 3xTF32 body, on fp32 panels
where this tree's takes the TF32 planes, is left out at highest:
``f64_ab --point highest`` times it) and this tree's
entries with the waits across processes (``*_flags``) on the same pack,
every owner's arrive word already at the launch's epoch: the waits' cost
where nothing waits.  With ``--variants`` also copies of this tree whose
wait is edited (:data:`VARIANTS`: the acquire as a relaxed load, the
acquire at GPU scope, no load at all), their flagged entries alone: where
that cost comes from.  Each launch's C is checked bit for bit against
this tree's one-card entry.  Prints one JSON line per (entry, tree) with the
median ms of each round (``utils.timers.median_ms``: 5 runs of 20
launches) and the card's name.  Needs the card and ``nvcc``.
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

OUT = _build.BUILD_DIR / "halo_ab"
N = 256
ENTRIES = {"x3": "crp_halo_x3", "default": "crp_halo_bf16", "highest": "crp_halo_f32"}
_ACQUIRE = 'asm volatile("ld.acquire.sys.u64 %0, [%1];\\n"'
# variant -> edits of panel_tiles.cuh (anchor, replacement), each anchor once
VARIANTS = {
    "relaxed_load": ((_ACQUIRE, _ACQUIRE.replace("acquire", "relaxed")),),
    "gpu_scope": ((_ACQUIRE, _ACQUIRE.replace(".sys", ".gpu")),),
    "no_load": (("    unsigned long long v = ld_acquire_sys(word);\n    int code = 0;\n",
                 "    unsigned long long v = need;\n    int code = 0;\n"),),
}


def packs(dev) -> dict:
    """Per point: the kernel's pointer arguments (rows, ws, panels, C),
    the int64 scalars (G, TM, W, n, rows16), and for the flagged entries
    the (row pointer, arrive word) pairs of every owner at epoch 1 and the
    status word, on the headline's p = 4 fused plan."""
    from ..kernels import spmm_halo as sh
    from ..plan.partition1d import csr_row_partition
    from ..sparse.synth import banded_random_csr, fill_b
    from .presplit_b_sweep import HEADLINE

    a = banded_random_csr(HEADLINE["nrow"], nnz_per_row=HEADLINE["nnz_per_row"],
                          bandwidth=HEADLINE["bandwidth"], seed=HEADLINE["seed"],
                          dtype=np.float32)
    d = csr_row_partition(a.rowptr, 4)
    aligned = sh.align_displs(d, a.ncol)
    shards = [a.row_slice(int(d[i]), int(d[i + 1])) for i in range(4)]
    b = fill_b(0, a.ncol, 0, N, dtype=np.float32)
    words = torch.ones((4, 2), dtype=torch.int64, device=dev)  # arrive = done = 1
    status = torch.zeros(1, dtype=torch.int64, pin_memory=True)
    out = {}
    for prec in ENTRIES:
        arrays, op = sh.build_halo_plan(shards, aligned, device=dev, dtype=np.float32,
                                        precision=prec)
        bs = np.zeros((4, op.min_b_rows, N), np.float32)
        for i in range(4):
            bs[i, : aligned[i + 1] - aligned[i]] = b[aligned[i]:aligned[i + 1]]
        ws, _, panels, _, chunk_src, b_read, *_ = op.kernel_args(
            arrays, torch.from_numpy(bs).to(dev))
        planes = panels if isinstance(panels, tuple) else (panels,)
        rows, rows16 = sh.stacked_chunk_rows(chunk_src, b_read)
        arrive, _ = sh.chunk_rows(chunk_src, [w.data_ptr() for w in words], 0, 1)
        pairs = torch.stack([rows, arrive], dim=1).contiguous()
        s_, G, TM, W = planes[0].shape
        c = torch.empty((s_, G * TM, N), device=dev)
        out[prec] = dict(ptrs=(rows, ws, *planes, c), scalars=(s_ * G, TM, W, N, int(rows16)),
                         pairs=pairs, status=status, keep=(b_read, words, arrays))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m crp_tpu_torch.cli.halo_ab")
    parser.add_argument("--baseline", action="append", default=[],
                        help="another kernels/csrc tree to time as it is")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--variants", action="store_true",
                        help="also time the edited waits of VARIANTS")
    args = parser.parse_args(argv)
    from ..utils.timers import median_ms

    if not torch.cuda.is_available():
        print("halo_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    jobs = {"this": (_build.CSRC, {}, ())}
    for base in args.baseline:
        jobs[f"baseline:{base}"] = (pathlib.Path(base), {}, ())
    if args.variants:
        tiles = (_build.CSRC / "panel_tiles.cuh").read_text()
        for name, edits in VARIANTS.items():
            jobs[f"variant:{name}"] = (_build.CSRC,
                                       {"panel_tiles.cuh": edited(tiles, edits, "halo_ab")},
                                       ())
    libs = build_copies(OUT, jobs, ["halo"], "halo_ab")
    inputs = packs(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    runs = {}
    for (tree, _), path in libs.items():
        lib = ctypes.CDLL(str(path))
        mma_sync = "launch_tf32x3" in (jobs[tree][0] / "halo.cu").read_text()
        for prec, entry in ENTRIES.items():
            if prec == "highest" and mma_sync:  # fp32 panels, not this tree's planes
                continue
            got = inputs[prec]
            names = ([(entry, False)] if not tree.startswith("variant:") else []) + (
                [(f"{entry}_flags", True)] if not tree.startswith("baseline:") else [])
            for name, flagged in names:
                fn = getattr(lib, name)
                ptrs = [t.data_ptr() for t in got["ptrs"]]
                scalars = list(got["scalars"])
                if flagged:  # the pairs in the row pointers' place, the status word
                    ptrs = [got["pairs"].data_ptr(), *ptrs[1:], got["status"].data_ptr()]
                    scalars += [1, 10**10]  # epoch, bound_ns
                fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int64] * len(scalars)
                               + [ctypes.c_void_p])
                fn.restype = ctypes.c_int

                def run(fn=fn, ptrs=ptrs, scalars=scalars, name=name):
                    rc = fn(*ptrs, *scalars, stream)
                    if rc:
                        raise RuntimeError(f"halo_ab: {name}: CUDA error {rc}")

                runs[prec, name, tree] = run
    c_want = {}
    for (prec, name, tree), run in runs.items():  # every launch's C against this tree's
        c = inputs[prec]["ptrs"][-1]
        c.fill_(float("nan"))
        run()
        torch.cuda.synchronize(dev)
        if (name, tree) == (ENTRIES[prec], "this"):
            c_want[prec] = c.clone()
    for (prec, name, tree), run in runs.items():
        c = inputs[prec]["ptrs"][-1]
        c.fill_(float("nan"))
        run()
        torch.cuda.synchronize(dev)
        if not torch.equal(c.view(torch.int32), c_want[prec].view(torch.int32)):
            raise RuntimeError(f"halo_ab: {name} of {tree} differs from this tree's "
                               f"{ENTRIES[prec]}")
    if int(inputs["x3"]["status"][0]):
        raise RuntimeError("halo_ab: a wait gave up")
    times = {key: [] for key in runs}
    for _ in range(args.rounds):
        for key, run in runs.items():
            times[key].append(median_ms(run, dev, 5, 20))
    card = torch.cuda.get_device_name(dev)
    for (prec, name, tree), t in times.items():
        G, TM, W, n, _ = inputs[prec]["scalars"]
        print(json.dumps(dict(point=prec, entry=name, tree=tree, ms=t, G=G, TM=TM, W=W, n=n,
                              device=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
