"""Host-side CSR container (``crp_tpu/sparse/csr.py``, numpy only).

Column indices within each row are sorted ascending, the reference's
invariant (``examples/mmio_utils.c:182-185``).  ``from_coo`` is the numpy
path of the original, which gives the same arrays as its native one.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRMatrix:
    nrow: int
    ncol: int
    rowptr: np.ndarray  # (nrow+1,) int
    colidx: np.ndarray  # (nnz,) int
    val: np.ndarray     # (nnz,) float

    def __post_init__(self) -> None:
        self.rowptr = np.ascontiguousarray(self.rowptr)
        self.colidx = np.ascontiguousarray(self.colidx)
        self.val = np.ascontiguousarray(self.val)
        assert self.rowptr.shape == (self.nrow + 1,)
        assert self.colidx.shape[0] == self.rowptr[-1]
        assert self.val.shape == self.colidx.shape

    @property
    def nnz(self) -> int:
        return int(self.rowptr[-1])

    @classmethod
    def from_coo(cls, nrow: int, ncol: int, row: np.ndarray, col: np.ndarray,
                 val: np.ndarray, dtype=np.float64) -> "CSRMatrix":
        """COO -> CSR with per-row column-sorted nonzeros; duplicates are
        kept (``examples/mmio_utils.c:148-190``)."""
        row = np.asarray(row, dtype=np.int64)
        col = np.asarray(col, dtype=np.int64)
        val = np.asarray(val, dtype=dtype)
        order = np.lexsort((col, row))
        row, col, val = row[order], col[order], val[order]
        rowptr = np.zeros(nrow + 1, dtype=np.int64)
        np.add.at(rowptr, row + 1, 1)
        np.cumsum(rowptr, out=rowptr)
        return cls(nrow, ncol, rowptr, col.astype(np.int32), val)

    @classmethod
    def from_scipy(cls, mat, dtype=np.float64) -> "CSRMatrix":
        csr = mat.tocsr()
        csr.sort_indices()
        return cls(csr.shape[0], csr.shape[1], csr.indptr.astype(np.int64),
                   csr.indices.astype(np.int32), csr.data.astype(dtype))

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix((self.val, self.colidx, self.rowptr),
                             shape=(self.nrow, self.ncol))

    def row_slice(self, srow: int, erow: int) -> "CSRMatrix":
        """Rows [srow, erow) as a standalone CSR block (rowptr rebased to 0)."""
        s, e = int(self.rowptr[srow]), int(self.rowptr[erow])
        return CSRMatrix(
            erow - srow, self.ncol,
            self.rowptr[srow : erow + 1] - self.rowptr[srow],
            self.colidx[s:e].copy(), self.val[s:e].copy(),
        )

    def localize(self) -> tuple["CSRMatrix", int, int]:
        """Shrink the column window to [min colidx, max colidx]: (shifted
        matrix, window start, window size), as ``rp_spmm_init`` localizes
        A (``src/rowpara_spmm.c:46-77``)."""
        if self.nnz == 0:
            return CSRMatrix(self.nrow, 0, self.rowptr.copy(),
                             self.colidx.copy(), self.val.copy()), 0, 0
        srow = int(self.colidx.min())
        w = int(self.colidx.max()) - srow + 1
        return (CSRMatrix(self.nrow, w, self.rowptr.copy(),
                          (self.colidx - srow).astype(self.colidx.dtype), self.val.copy()),
                srow, w)

    def transpose(self) -> "CSRMatrix":
        """A^T as CSR, counting sort by column (stable: columns stay sorted
        within each transposed row)."""
        rows = np.repeat(np.arange(self.nrow, dtype=np.int64), np.diff(self.rowptr))
        order = np.argsort(self.colidx, kind="stable")
        t_rowptr = np.zeros(self.ncol + 1, dtype=np.int64)
        np.cumsum(np.bincount(self.colidx, minlength=self.ncol), out=t_rowptr[1:])
        return CSRMatrix(self.ncol, self.nrow, t_rowptr,
                         rows[order].astype(self.colidx.dtype), self.val[order])

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.nrow, self.ncol), dtype=self.val.dtype)
        row = np.repeat(np.arange(self.nrow), np.diff(self.rowptr))
        np.add.at(out, (row, self.colidx), self.val)
        return out

    def spmm_ref(self, b: np.ndarray) -> np.ndarray:
        """Host fp64 reference C := A @ B (``examples/test_utils.c:156-179``)."""
        return self.to_scipy().astype(np.float64) @ np.asarray(b, dtype=np.float64)

    def bandwidth(self) -> int:
        """Max |col - row| over the nonzeros."""
        if self.nnz == 0:
            return 0
        row = np.repeat(np.arange(self.nrow), np.diff(self.rowptr))
        return int(np.abs(self.colidx - row).max())

    def row_col_ranges_v1(self) -> np.ndarray:
        """(nrow, 2) per-row [min, max] colidx as the v1 engine assembles
        ``A_cidx_se_glb`` (``deprecated/src/crpspmm.c:111-117``): row i
        reads ``colidx[rowptr[i]]`` and ``colidx[rowptr[i+1]-1]`` even when
        EMPTY, pulling its neighbours' columns; the bandwidth planner's
        costs and the coarse exchange windows depend on this quirk.  Reads
        the reference leaves out of bounds (leading or trailing empty
        rows) are clipped in range."""
        out = np.empty((self.nrow, 2), dtype=np.int64)
        nnz = self.nnz
        if nnz == 0:
            out[:, 0] = self.ncol
            out[:, 1] = -1
            return out
        out[:, 0] = self.colidx[np.minimum(self.rowptr[:-1], nnz - 1)]
        out[:, 1] = self.colidx[np.maximum(self.rowptr[1:] - 1, 0)]
        return out

    def row_col_ranges(self) -> np.ndarray:
        """(nrow, 2) per-row [min colidx, max colidx]; an empty row gets
        the empty range [ncol, -1], which min / max reductions ignore."""
        ranges = np.empty((self.nrow, 2), dtype=np.int64)
        ranges[:, 0] = self.ncol
        ranges[:, 1] = -1
        nonempty = np.diff(self.rowptr) > 0
        # colidx sorted per row: the first nonzero is the min, the last the max
        ranges[nonempty, 0] = self.colidx[self.rowptr[:-1][nonempty]]
        ranges[nonempty, 1] = self.colidx[self.rowptr[1:][nonempty] - 1]
        return ranges
