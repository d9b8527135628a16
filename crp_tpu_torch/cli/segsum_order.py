"""The segment sum's candidates for a fixed order of adds, timed on the card.

The ``segsum`` kind, the ragged packs' chunked spill and the ``dd`` kind's
segment-sum tier sum ``vals * B[cols]`` by sorted row.  ``index_add_`` does
that with atomics, in an order that changes from launch to launch; the
port sums in a fixed order (``kernels/spmm_segsum.py``).  This tool times,
in the same rounds on the same arrays:

  * ``fixed`` — the port's sum: ``torch.segment_reduce`` in two levels
    (pieces of at most ``SEGSUM_PIECE`` slots, then each row's pieces);
  * ``one_level`` — ``torch.segment_reduce`` over whole rows: a hub row is
    one thread's serial loop;
  * ``index_put`` — ``index_put_(..., accumulate=True)``, sort-based on a
    CUDA device;
  * ``index_add`` — the sum the port had before, ``index_add_``;

each over the chunks of ``SEGSUM_BLOCK_BYTES`` the port takes, and each
with whether two launches agree bit for bit and its relative Frobenius
error against the sum in fp64 (first 32 columns).  Two cases: shard 0 of
the GAT example's graph at the cplaw class's rows in 4 row shards
(``powerlaw_community_csr(786432, 8, 98304, seed=5)`` with self-loops,
values 1, fp32, n = 256), and cplaw in fp64 (10.8M nonzeros, n = 256),
the ``dd`` tier's matrix.  One JSON line per candidate and case, with the
card's name and power limit.

On the card::

    python -m crp_tpu_torch.cli.segsum_order
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from ..examples.common import community_graph
from ..examples.gat_train import pattern_with_self_loops
from ..kernels import spmm_segsum
from ..kernels.spmm_segsum import pack_device_csr, spmm_segment_sum
from ..plan.partition1d import csr_row_partition
from ..sparse.synth import powerlaw_community_csr
from ..utils.timers import median_ms

N = 256
ERR_COLS = 32


def _chunked(rows, cols, vals, b, nrow, add):
    """``add(out, rows, products)`` over the port's chunks; (nrow, n)."""
    out = b.new_zeros((nrow + 1, b.shape[1]))
    step = max(1, spmm_segsum.SEGSUM_BLOCK_BYTES // (b.shape[1] * b.element_size()))
    for i in range(0, rows.shape[0], step):
        add(out, rows[i : i + step].long(),
            vals[i : i + step, None].to(b.dtype) * b[cols[i : i + step].long()])
    return out[:nrow]


def _one_level(rows, cols, vals, nrow, b):
    piece = spmm_segsum.SEGSUM_PIECE
    spmm_segsum.SEGSUM_PIECE = 1 << 62
    try:
        return spmm_segment_sum(rows, cols, vals, nrow, b)
    finally:
        spmm_segsum.SEGSUM_PIECE = piece


CANDIDATES = {
    "fixed": lambda r, c, v, nrow, b: spmm_segment_sum(r, c, v, nrow, b),
    "one_level": _one_level,
    "index_put": lambda r, c, v, nrow, b: _chunked(
        r, c, v, b, nrow, lambda o, i, x: o.index_put_((i,), x, accumulate=True)),
    "index_add": lambda r, c, v, nrow, b: _chunked(
        r, c, v, b, nrow, lambda o, i, x: o.index_add_(0, i, x)),
}


def cases():
    """(name, CSR matrix, B) of each case."""
    a = pattern_with_self_loops(community_graph(786432, 8))
    d = csr_row_partition(a.rowptr, 4)
    s0 = a.row_slice(int(d[0]), int(d[1]))
    rng = np.random.default_rng(8)
    yield ("gat shard 0, fp32", s0, rng.standard_normal((a.ncol, N)).astype(np.float32))
    a = powerlaw_community_csr(786432, 16, 1024, seed=1234)
    yield ("cplaw, fp64", a, rng.standard_normal((a.ncol, N)))


def main() -> int:
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    for name, a, b in cases():
        arrs = [torch.from_numpy(x).to(device) for x in pack_device_csr(
            a.rowptr, a.colidx, a.val.astype(b.dtype), a.nnz, nrow=a.nrow)]
        bt = torch.from_numpy(b).to(device)
        ref = CANDIDATES["index_add"](arrs[0], arrs[1], arrs[2].double(), a.nrow,
                                      bt[:, :ERR_COLS].double())
        runs = {k: (lambda f=f: f(*arrs, a.nrow, bt)) for k, f in CANDIDATES.items()}
        rounds = {k: [] for k in runs}
        for r in range(3):  # every candidate once a round, in alternating order
            for k in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                rounds[k].append(median_ms(runs[k], device, reps=3, inner=3))
        for k, run in runs.items():
            c1, c2 = run(), run()
            err = float((c1[:, :ERR_COLS].double() - ref).norm() / ref.norm())
            print(json.dumps({
                "case": name, "candidate": k, "nnz": int(a.nnz), "n": N,
                "dtype": str(b.dtype), "ms": float(np.median(rounds[k])),
                "rounds_ms": rounds[k],
                "repeats_bit_for_bit": bool(torch.equal(c1.view(torch.uint8),
                                                        c2.view(torch.uint8))),
                "rel_fro_err_vs_fp64": err, "card": card}), flush=True)
        del arrs, bt, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
