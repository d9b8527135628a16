"""Local CSR x dense SpMM by an ELL slot scan (the ``ell`` kind).

Counterpart of ``crp_tpu/kernels/spmm_ell.py``, which is XLA-level code in
the JAX package (no Pallas kernel), so plain PyTorch is its port.  The CSR
shard is padded row-wise to L slots at pack time; the op walks the slots,
each step gathering one (m, n) block of B rows and adding its products into
C.  Peak memory stays O(m * n): the (m, L, n) gather of all slots at once
would be 24 GB at the pwtk-class shape in fp64 (L = 53, n = 256).
"""

from __future__ import annotations

import numpy as np
import torch


def pack_ell(
    rowptr: np.ndarray,
    colidx: np.ndarray,
    val: np.ndarray,
    nrow_pad: int,
    L: int | None = None,
    col_pad: int = 0,
    dtype=None,
) -> tuple[np.ndarray, np.ndarray]:
    """CSR -> padded ELL (cols, vals), shapes (nrow_pad, L)
    (``spmm_ell.py:22-50``).  Padding slots carry ``col = col_pad`` and
    ``val = 0``."""
    nrow = len(rowptr) - 1
    counts = np.diff(rowptr) if nrow else np.zeros(0, dtype=np.int64)
    max_row = int(counts.max()) if nrow else 0
    L = max_row if L is None else L
    if L < max_row:
        raise ValueError(f"ELL slots L={L} < max nnz/row {max_row}")
    L = max(L, 1)
    dtype = dtype or val.dtype
    cols = np.full((nrow_pad, L), col_pad, dtype=np.int32)
    vals = np.zeros((nrow_pad, L), dtype=dtype)
    # slot index of each nnz within its row
    slot = np.arange(len(colidx)) - np.repeat(rowptr[:-1], counts)
    rows = np.repeat(np.arange(nrow), counts)
    cols[rows, slot] = colidx
    vals[rows, slot] = val
    return cols, vals


def spmm_ell(cols: torch.Tensor, vals: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``C[m, n] = sum_l vals[:, l, None] * B[cols[:, l]]``, one slot at a
    time in the dtype of ``b`` (``spmm_ell.py:53-65``)."""
    c = torch.zeros((cols.shape[0], b.shape[1]), dtype=b.dtype, device=b.device)
    for slot in range(cols.shape[1]):
        c += vals[:, slot, None].to(b.dtype) * b.index_select(0, cols[:, slot].long())
    return c
