"""Matrix Market reader (``crp_tpu/sparse/mmio.py``, scipy's reader only).

scipy expands symmetric storage as the reference's mmio helpers do
(``examples/mmio_utils.c:11-125``); the result is column-sorted CSR.
"""

from __future__ import annotations

import logging

import numpy as np

from .csr import CSRMatrix

logger = logging.getLogger("crp_tpu_torch")


def mm_read_sparse(fname: str, need_symm: bool = False, dtype=np.float64) -> CSRMatrix:
    """Read a sparse .mtx file into column-sorted CSR; ``need_symm``
    refuses a matrix not stored symmetric."""
    with open(fname, "rb") as f:
        header = f.readline().decode("latin1").lower()
    if need_symm and "symmetric" not in header:
        raise ValueError(f"{fname}: matrix is not symmetric")
    import scipy.io

    coo = scipy.io.mmread(fname).tocoo()
    return CSRMatrix.from_coo(coo.shape[0], coo.shape[1], coo.row, coo.col,
                              coo.data, dtype=dtype)


def read_mtx_csr(fname: str, need_symm: bool = False, glb_n: int = 0,
                 dtype=np.float64, quiet: bool = False) -> CSRMatrix:
    """Read and report size, nnz and bandwidth, like the reference's
    ``read_mtx_csr`` (``examples/test_utils.c:21-55``)."""
    a = mm_read_sparse(fname, need_symm=need_symm, dtype=dtype)
    if not quiet:
        logger.info(
            "Read %s: %d x %d, nnz = %d (%.1f per row), bandwidth = %d",
            fname, a.nrow, a.ncol, a.nnz, a.nnz / max(a.nrow, 1), a.bandwidth(),
        )
    return a
