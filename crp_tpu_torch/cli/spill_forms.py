"""Whether the JAX package's other plain spill forms pay on the card.

A ragged pack adds its spilled nonzeros to C by the fused spill kernel #9
(fp32) or by the ``segsum`` form, a fixed-order segment sum in plain
torch (``spmm_spill_chunked``).  The JAX package has two more XLA-level
forms of the same sum (``CRP_TPU_SPILL_IMPL``), which the port packs and
runs as ``segsum`` (``dispatch.SEGSUM_FORMS``): ``clip`` clamps the
columns into B's rows before the gather, and ``twopass`` gathers B's
unique spilled rows once into a compact temp, then sums from the temp
through each nonzero's slot in it.  This tool writes both out on the
``segsum`` pack's own arrays and times them against ``segsum`` in turns
(the order reversed every round), n = 256, on the ragged pack of the
whole matrix as one shard (p = 1, the geometry the model picks):

  * ``fp64 cplaw`` — ``powerlaw_community_csr(786432, 16, 1024)`` in fp64;
  * ``fp64 headline`` — ``banded_random_csr(217918, 53, 2500)`` in fp64;
  * ``cplaw x3`` — cplaw in fp32 at x3, with #9 on its own pack's spill.

Beside them, cuSPARSE on the spilled nonzeros alone
(``torch.sparse_csr_tensor`` of the spill @ B, in the pack's dtype) is
the yardstick.  ``clip`` and ``twopass`` must equal ``segsum`` bit for
bit.  One JSON line per case and form: its median ms over the rounds and
every round's, the spilled nnz, the unique spilled columns, the bytes the
form moves (below), the function's bound, its largest difference from
``segsum``, and the card's name and power limit.

The bytes a form moves, with no reuse through a cache: every form reads
its index arrays and values and writes C (``M`` rows); ``segsum`` and
``clip`` gather a B row a spilled nonzero; ``clip`` also writes and reads
its clamped columns; ``twopass`` reads B's unique rows once, writes them
to its temp and gathers a temp row a spilled nonzero; #9 reads its
row-ordered view, a B row a spilled nonzero and C; cuSPARSE reads its CSR
and a B row a nonzero.  ``bound_ms`` is the same for every form: the
least bytes of the function (the spill's rows, columns and values, B's
unique spilled rows, each read once, and C written once) at the card's
memory rate.

On the card::

    python -m crp_tpu_torch.cli.spill_forms [--rounds 4] [--case NAME ...]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from ..kernels.points import HBM_BYTES_PER_S
from ..kernels.spmm_segsum import spmm_segment_sum
from ..utils.timers import median_ms

N = 256
CPLAW = dict(n=786432, avg_degree=16, comm_size=1024, seed=1234)  # synth:cplaw:786432:16:1024
HEADLINE = dict(n=217918, nnz_per_row=53, bandwidth=2500, seed=1234)  # bench.py:129
# case -> (matrix, dtype, operating point, whether #9 runs there)
CASES = {
    "fp64 cplaw": ("cplaw", np.float64, "highest", False),
    "fp64 headline": ("headline", np.float64, "highest", False),
    "cplaw x3": ("cplaw", np.float32, "x3", True),
}


def make_matrix(name: str, dtype):
    from ..sparse.synth import banded_random_csr, powerlaw_community_csr

    if name == "cplaw":
        return powerlaw_community_csr(**CPLAW, dtype=dtype)
    return banded_random_csr(**HEADLINE, dtype=dtype)


def ragged_pack(a, dtype, prec, device, spill_impl: str) -> tuple:
    """``(op, arrays)``: the ragged pack of ``a`` as one shard."""
    from ..kernels.dispatch import _pack_ragged

    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    arrays, op = _pack_ragged(shard, a.nrow, dtype, prec, device, spill_impl=spill_impl)
    return op, tuple(x[0] for x in arrays)


def twopass_arrays(rows, cols, z: int) -> tuple:
    """``(inv, uniq)`` of JAX's ``twopass`` pack from a ``segsum`` pack's
    rows and columns, its ``z`` live entries first: ``uniq`` the sorted
    unique spilled columns, ``inv`` each entry's slot in it (pads 0)."""
    uniq, inv_live = torch.unique(cols[:z], sorted=True, return_inverse=True)
    inv = torch.zeros_like(cols)
    inv[:z] = inv_live.to(cols.dtype)
    return inv, uniq.to(cols.dtype)


def spill_csr(rows, cols, vals, z: int, nrow: int, ncol: int):
    """The spilled nonzeros alone as a CSR tensor of (nrow, ncol)."""
    crow = torch.searchsorted(rows[:z].long(), torch.arange(nrow + 1, device=rows.device))
    return torch.sparse_csr_tensor(crow, cols[:z].long(), vals[:z], size=(nrow, ncol))


def forms(op, arrs, rB, pallas=None) -> tuple:
    """``({form: (call, bytes)}, figures)`` on one shard's ``segsum`` pack
    (``op``, ``arrs``) and B ``rB``; ``pallas`` the (op, arrays) of the
    fused spill's pack of the same matrix, or None."""
    rows, cols, vals = op._spill_arrays(arrs)
    M = op.roofline["G"] * op.roofline["TM"]
    n, isz = rB.shape[1], rB.element_size()
    z = int((rows < M).sum())  # the live entries; the padding is at the end
    inv, uniq = twopass_arrays(rows, cols, z)
    n_uniq = int(uniq.numel())
    idx = z * (8 + vals.element_size())
    gather, c_bytes = z * n * isz, M * n * isz
    csr = spill_csr(rows, cols, vals, z, M, rB.shape[0])
    out = {
        "segsum": (lambda: spmm_segment_sum(rows, cols, vals, M, rB),
                   idx + gather + c_bytes),
        "clip": (lambda: spmm_segment_sum(rows, cols.clamp(0, rB.shape[0] - 1), vals,
                                          M, rB),
                 idx + 8 * z + gather + c_bytes),
        "twopass": (lambda: spmm_segment_sum(rows, inv, vals, M, rB.index_select(0, uniq)),
                    idx + 4 * n_uniq + 2 * n_uniq * n * isz + gather + c_bytes),
    }
    if pallas is not None:
        p_op, p_arrs = pallas
        c0 = torch.zeros((M, n), dtype=torch.float32, device=rB.device)
        args = p_op.spill_args(p_arrs, c0, rB)
        view = args[-1]
        out["pallas"] = (lambda: p_op.spill_kernel(*args),
                         sum(x.numel() * x.element_size() for x in view)
                         + z * n * 4 + 2 * M * n * 4)
    out["cusparse"] = (lambda: csr @ rB,
                       (M + 1) * 8 + idx + gather + c_bytes)
    least = idx + n_uniq * n * isz + c_bytes
    return out, dict(spilled_nnz=z, unique_cols=n_uniq, M=M, n=n,
                     bound_ms=least / HBM_BYTES_PER_S * 1e3)


def measure(case: str, a, dtype, prec, device, with_pallas: bool, n: int = N,
            rounds: int = 4, reps: int = 5, inner: int = 5, card: str = "") -> list:
    """One record a form of ``case`` (see the module's docstring)."""
    op, arrs = ragged_pack(a, dtype, prec, device, "segsum")
    if op.spill_impl != "segsum":
        raise ValueError(f"spill_forms: {case}: the pack has no spill")
    rows = max(op.min_b_rows, a.ncol)
    rB = torch.from_numpy(
        np.random.default_rng(5).standard_normal((rows, n)).astype(dtype)).to(device)
    pallas = None
    if with_pallas:
        pallas = ragged_pack(a, dtype, prec, device, "pallas")
        if pallas[0].spill_impl != "pallas":
            raise ValueError(f"spill_forms: {case}: the pallas pack took "
                             f"{pallas[0].spill_impl!r}")
    calls, figures = forms(op, arrs, rB, pallas)
    ref = calls["segsum"][0]()
    diff = {}
    for name, (call, _) in calls.items():
        got = call()
        diff[name] = float((got.double() - ref.double()).abs().max())
        if name in ("clip", "twopass") and not torch.equal(
                got.view(torch.uint8), ref.view(torch.uint8)):
            raise RuntimeError(f"spill_forms: {case}: {name} differs from segsum")
    del ref
    times = {name: [] for name in calls}
    names = list(calls)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            times[name].append(median_ms(calls[name][0], device, reps, inner))
    return [dict(case=case, form=name, ms=float(np.median(times[name])),
                 rounds=times[name], **figures, bytes=nbytes,
                 max_abs_vs_segsum=diff[name],
                 equal_segsum_bits=True if name in ("segsum", "clip", "twopass") else None,
                 dtype=np.dtype(dtype).name, point=prec, card=card)
            for name, (_, nbytes) in calls.items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m crp_tpu_torch.cli.spill_forms",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--case", action="append", choices=sorted(CASES),
                    help="a case to time (repeatable; default all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("spill_forms: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    for case in args.case or list(CASES):
        matrix, dtype, prec, with_pallas = CASES[case]
        a = make_matrix(matrix, dtype)
        for rec in measure(case, a, dtype, prec, dev, with_pallas, rounds=args.rounds,
                           card=card):
            print(json.dumps(rec), flush=True)
        del a
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
