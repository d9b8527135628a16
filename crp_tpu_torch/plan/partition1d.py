"""1D nnz-balanced row partitioning and exact comm-volume counting
(``crp_tpu/plan/partition1d.py``, numpy only).

The semantics of the reference planner ``src/spmat_part.c``: the
nnz-balanced binary search with its early stop on an exact match (the
boundaries must be byte-identical to the reference's, empty rows included),
and the exact SpMV communication volume per row block.
"""

from __future__ import annotations

import numpy as np


def _nnz_quota_lower_bound(rowptr: np.ndarray, nrow: int, target: int) -> int:
    """First st with rowptr[st] >= target, except that the search stops
    at whatever mid first hits equality (``src/spmat_part.c:12-35``)."""
    st, end = 0, nrow
    while st < end:
        mid = (st + end) // 2
        v = rowptr[mid]
        if v == target:
            return mid
        if v < target:
            st = mid + 1
        else:
            end = mid
    return st


def csr_row_partition(rowptr: np.ndarray, nblk: int) -> np.ndarray:
    """nnz-balanced row blocks: ``rblk_ptr`` of shape (nblk+1,)."""
    rowptr = np.asarray(rowptr)
    nrow = rowptr.shape[0] - 1
    nnz = int(rowptr[nrow])
    out = np.empty(nblk + 1, dtype=np.int64)
    out[0] = 0
    for i in range(nblk):
        target = nnz if i == nblk - 1 else (nnz // nblk) * (i + 1)
        out[i + 1] = _nnz_quota_lower_bound(rowptr, nrow, target)
    return out


def csr_row_part_comm_size(ncol: int, rowptr: np.ndarray, colidx: np.ndarray,
                           rblk_ptr: np.ndarray,
                           x_displs: np.ndarray) -> tuple[np.ndarray, int]:
    """Per row block i: the distinct columns its rows touch minus those it
    owns (``[x_displs[i], x_displs[i+1])``, ``src/spmat_part.c:38-64``);
    returns (comm_sizes, total)."""
    rowptr = np.asarray(rowptr)
    colidx = np.asarray(colidx)
    rblk_ptr = np.asarray(rblk_ptr, dtype=np.int64)
    x_displs = np.asarray(x_displs, dtype=np.int64)
    nblk = rblk_ptr.shape[0] - 1
    nnz_bounds = rowptr[rblk_ptr].astype(np.int64)
    counts = np.diff(nnz_bounds)
    blk_ids = np.repeat(np.arange(nblk, dtype=np.int64), counts)
    keys = blk_ids * np.int64(ncol) + colidx[nnz_bounds[0]:nnz_bounds[-1]].astype(np.int64)
    uniq = np.unique(keys)
    ub = uniq // ncol
    uc = uniq - ub * ncol
    comm_sizes = np.bincount(ub, minlength=nblk).astype(np.int64)
    owned = (uc >= x_displs[ub]) & (uc < x_displs[ub + 1])
    comm_sizes -= np.bincount(ub[owned], minlength=nblk).astype(np.int64)
    return comm_sizes, int(comm_sizes.sum())


def prime_factorization(n: int) -> list[int]:
    """Prime factors of n, ascending."""
    fac = []
    c = 2
    while n > 1:
        if n % c == 0:
            fac.append(c)
            n //= c
        else:
            c += 1
    return fac
