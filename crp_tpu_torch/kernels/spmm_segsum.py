"""Local CSR x dense SpMM by gather + segment sums (the ``segsum`` kind).

Counterpart of ``crp_tpu/kernels/spmm_jnp.py:36-65``, which is XLA-level
code in the JAX package (no Pallas kernel), so plain PyTorch is its port.
It takes any CSR, runs on every device and is exact in fp64: the fallback
at the end of every kernel chain, and what ``kernel="auto"`` resolves to on
the CPU.

The sum runs in a fixed order on every device, as XLA's segment sum does
on a TPU: the nonzeros go in chunks of bounded bytes, in order; within a
chunk each row's products are summed in pieces of at most
``SEGSUM_PIECE`` slots, one slot after another (``torch.segment_reduce``:
a thread per output element on a CUDA device), then the pieces one after
another, and a row that straddles two chunks adds its second part to its
first.  ``index_add_`` on a CUDA tensor sums with atomics, in an order
that changes from launch to launch.
"""

from __future__ import annotations

import numpy as np
import torch

SEGSUM_BLOCK_BYTES = 256 << 20  # one chunk's (nnz, n) products
SEGSUM_PIECE = 128  # the most slots one thread adds in turn (segment_sum)


def pack_device_csr(rowptr, colidx, val, nnz_pad, nrow=None, dtype=None):
    """One CSR shard as padded (row_ids, colidx, val) numpy arrays; pad
    entries carry ``row_id = nrow`` and vanish in the sum
    (``spmm_jnp.py:36-56``)."""
    nrow = (len(rowptr) - 1) if nrow is None else nrow
    nnz = int(rowptr[-1]) - int(rowptr[0])
    dtype = dtype or val.dtype
    row_ids = np.full(nnz_pad, nrow, dtype=np.int32)
    cols = np.zeros(nnz_pad, dtype=np.int32)
    vals = np.zeros(nnz_pad, dtype=dtype)
    row_ids[:nnz] = np.repeat(
        np.arange(len(rowptr) - 1, dtype=np.int32), np.diff(rowptr)
    )
    cols[:nnz] = colidx
    vals[:nnz] = val
    return row_ids, cols, vals


def segment_sum(x, offsets, phase: int = 0):
    """Fixed-order sums of the consecutive segments
    ``x[offsets[j]:offsets[j + 1]]`` along dim 0 (an empty one sums to 0).

    Two levels, so that a long segment (a hub row) is not one thread's
    serial loop: the segments are cut at every ``SEGSUM_PIECE``-th slot of
    ``x``; each piece is summed slot after slot, then each segment's pieces
    piece after piece.  ``phase``: x's first slot is slot ``phase`` of the
    run the cuts count in (a rank's part of a longer run sums as the run
    does)."""
    first = (-phase) % SEGSUM_PIECE
    cuts = torch.arange(first, max(first, x.shape[0]), SEGSUM_PIECE,
                        dtype=offsets.dtype, device=offsets.device)
    bounds = torch.sort(torch.cat([offsets, cuts.clamp(offsets[:1], offsets[-1:])])).values
    pieces = torch.segment_reduce(x, "sum", offsets=bounds, unsafe=True)
    return torch.segment_reduce(pieces, "sum", offsets=torch.searchsorted(bounds, offsets),
                                unsafe=True)


def spmm_segment_sum(row_ids, colidx, val, nrow: int, b):
    """``C[m, n] = sum_nnz val * B[col]`` summed by row in a fixed order;
    ``row_ids`` are sorted and rows ``>= nrow`` (the padding) are dropped.
    One host read of the chunks' first and last rows per call."""
    n = b.shape[1]
    out = b.new_zeros((nrow, n))
    nnz = row_ids.shape[0]
    if nnz == 0 or nrow == 0:
        return out
    step = max(1, SEGSUM_BLOCK_BYTES // max(1, n * b.element_size()))
    starts = range(0, nnz, step)
    ends = [min(s + step, nnz) - 1 for s in starts]
    bounds = row_ids[torch.tensor([list(starts), ends], device=row_ids.device)]
    for s, lo, hi in zip(starts, *bounds.tolist()):
        if lo >= nrow:  # the padding, at the end
            break
        hi = min(hi, nrow - 1)
        rows = row_ids[s : s + step]
        offsets = torch.searchsorted(
            rows, torch.arange(lo, hi + 2, dtype=rows.dtype, device=rows.device))
        contrib = val[s : s + step, None].to(b.dtype) * b.index_select(
            0, colidx[s : s + step].long())
        out[lo : hi + 1] += segment_sum(contrib, offsets)
    return out
