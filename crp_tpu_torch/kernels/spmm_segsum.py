"""Local CSR x dense SpMM by gather + ``index_add_`` (the ``segsum`` kind).

Counterpart of ``crp_tpu/kernels/spmm_jnp.py:36-65``, which is XLA-level
code in the JAX package (no Pallas kernel), so plain PyTorch is its port.
It takes any CSR, runs on every device and is exact in fp64: the fallback
at the end of every kernel chain, and what ``kernel="auto"`` resolves to on
the CPU.
"""

from __future__ import annotations

import numpy as np


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


def spmm_segment_sum(row_ids, colidx, val, nrow: int, b):
    """``C[m, n] = sum_nnz val * B[col]`` summed by row; rows ``>= nrow``
    (the padding) are dropped."""
    contrib = val[:, None].to(b.dtype) * b.index_select(0, colidx.long())
    out = b.new_zeros((nrow + 1, b.shape[1]))
    out.index_add_(0, row_ids.long(), contrib)
    return out[:nrow]
