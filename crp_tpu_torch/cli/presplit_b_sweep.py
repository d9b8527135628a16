"""The presplit-B comparison: three x3-pack variants on one matrix.

Counterpart of ``bench_results/scripts/r2_presplit_b_sweep.py``.  A is
packed once through the port's x3 single-shard pack (``ws`` and the bf16
``ah``/``al`` panels, the super-grouped uniform pack), and each variant
multiplies it by the analytic B (``fill_b``):

  1. ``presplit_a_x3`` — kernel #1, ``spmm_window_sg_presplit``: fp32 B,
     split in the kernel;
  2. ``presplit_ab_x3`` — kernel #5, ``spmm_window_sg_presplit_ab``: B
     split once by ``split_b_bf16``; it equals variant 1 bit for bit;
  3. ``bf16_1pass`` — kernel #2, ``spmm_window_sg_bf16``: ``ah`` times the
     hi half of B, one pass.

Each record has ``exec_ms`` (one product, B given as the variant takes it)
and ``rel_fro_err`` against an fp64 reference on the first 32 columns;
``presplit_ab_x3`` adds ``split_ms`` (``split_b_bf16`` alone),
``split_exec_ms`` (split and product, as an exec whose B is new pays them)
and ``max_abs_vs_presplit_a``.  Times are CUDA-event times on a card and
host-clock times on the CPU; every record names its device.  The records
are printed as JSON lines and returned; nothing is written to a file.

On the card, at the pwtk-class headline (n = 256)::

    python -m crp_tpu_torch.cli.presplit_b_sweep
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..kernels.dispatch import pack_local_kernel
from ..kernels.spmm_pallas import (
    spmm_window_sg_bf16, spmm_window_sg_presplit, spmm_window_sg_presplit_ab,
    split_b_bf16,
)
from ..sparse.synth import banded_random_csr, fill_b
from ..utils.norms import rel_fro_err
from ..utils.timers import median_ms

ERR_COLS = 32  # columns of C held against the fp64 reference (bench.py:163-167)
HEADLINE = dict(nrow=217918, nnz_per_row=53, bandwidth=2500, seed=1234)  # bench.py:129


def pack_x3(a, device):
    """A's x3 single-shard pack on ``device``: ``((ws, ah, al, bases),
    op)``; raises where the matrix does not take the super-grouped uniform
    pack."""
    arrays, op = pack_local_kernel(
        [(a.rowptr, np.asarray(a.colidx, np.int32), a.val)], a.nrow, np.float32,
        "pallas", device=device, mxu_precision="x3",
    )
    if getattr(op, "scheme", None) != "x3":
        raise ValueError(
            f"presplit-B sweep: the matrix takes the {op.variant!r} pack, not "
            "the super-grouped x3 pack"
        )
    return tuple(x[0] for x in arrays), op


def variants(ws, ah, al, b, min_b_rows):
    """``{name: product}`` of the three variants on one pack and the fp32
    receive buffer ``b``; each product returns (G*TM, n) fp32.  The split
    of B that variants 2 and 3 take is made here, once."""
    bh, bl = split_b_bf16(b)
    kw = dict(min_b_rows=min_b_rows)
    return {
        "presplit_a_x3": lambda: spmm_window_sg_presplit(ws, ah, al, b, **kw),
        "presplit_ab_x3": lambda: spmm_window_sg_presplit_ab(ws, ah, al, bh, bl, **kw),
        "bf16_1pass": lambda: spmm_window_sg_bf16(ws, ah, bh, **kw),
    }


def sweep(a, n: int, device, *, pack=None, timing=(5, 20)) -> list:
    """The three variants on ``a`` (a CSR matrix with ``spmm_ref``) times
    the analytic (ncol, n) fp32 B, on ``device``; ``pack`` is a
    :func:`pack_x3` result to reuse, ``timing`` (reps, inner calls).
    Prints and returns one record per variant."""
    device = torch.device(device)
    arrs, op = pack if pack is not None else pack_x3(a, device)
    ws, ah, al = arrs[:3]
    b = np.zeros((op.min_b_rows, n), np.float32)
    b[: a.ncol] = fill_b(0, a.ncol, 0, n, dtype=np.float32)
    ref = a.spmm_ref(b[: a.ncol, :ERR_COLS].astype(np.float64))
    rB = torch.from_numpy(b).to(device)
    label = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    rl = op.roofline
    print(f"# G={rl['G']} W={rl['W']} TM={rl['TM']} n={n} device={label}", flush=True)

    runs = variants(ws, ah, al, rB, op.min_b_rows)
    outs, records = {}, []
    for name, fn in runs.items():
        outs[name] = fn()
        c = outs[name][: a.nrow, :ERR_COLS].double().cpu().numpy()
        rec = dict(variant=name, device=label,
                   exec_ms=median_ms(fn, device, *timing),
                   rel_fro_err=float(rel_fro_err(ref, c)))
        if name == "presplit_ab_x3":
            rec["split_ms"] = median_ms(lambda: split_b_bf16(rB), device, *timing)
            rec["split_exec_ms"] = median_ms(
                lambda: spmm_window_sg_presplit_ab(
                    ws, ah, al, *split_b_bf16(rB), min_b_rows=op.min_b_rows),
                device, *timing)
            rec["max_abs_vs_presplit_a"] = float(
                (outs[name] - outs["presplit_a_x3"]).abs().max())
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


def main() -> int:
    if not torch.cuda.is_available():
        print("presplit_b_sweep: no CUDA device", file=sys.stderr)
        return 2
    a = banded_random_csr(HEADLINE["nrow"], nnz_per_row=HEADLINE["nnz_per_row"],
                          bandwidth=HEADLINE["bandwidth"], seed=HEADLINE["seed"],
                          dtype=np.float32)
    sweep(a, 256, "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
