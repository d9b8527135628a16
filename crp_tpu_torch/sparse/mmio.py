"""Matrix Market I/O (``crp_tpu/sparse/mmio.py``).

The reader is scipy's.  ``backend="native"`` takes the C++ reader of
``native/mtx.cpp`` instead, the JAX package's first choice
(``mmio.py:34-46``); it gives the same arrays bit for bit but is not the
default, because it is the slower of the two: 9.56 s against scipy's
2.86 s on the 387 MB headline file (``chip_smoke.py``, NVIDIA H100 80GB
HBM3 host, 700.00 W).  Both expand symmetric storage as the reference's
mmio helpers do (``examples/mmio_utils.c:11-125``); the result is
column-sorted CSR, which carries the reader that ran as ``backend``.
"""

from __future__ import annotations

import logging

import numpy as np

from .csr import CSRMatrix

logger = logging.getLogger("crp_tpu_torch")


def mm_read_sparse(fname: str, need_symm: bool = False, dtype=np.float64,
                   backend: str = "scipy") -> CSRMatrix:
    """Read a sparse .mtx file into column-sorted CSR; ``need_symm``
    refuses a matrix not stored symmetric.  ``backend="native"`` reads with
    ``native/mtx.cpp`` and raises ``ValueError`` where it is not built or
    its stat refuses the header (complex, hermitian, skew, array)."""
    with open(fname, "rb") as f:
        header = f.readline().decode("latin1").lower()
    if need_symm and "symmetric" not in header:
        raise ValueError(f"{fname}: matrix is not symmetric")
    if backend == "native":
        from .. import native

        res = native.mtx_read(fname)
        if res is None:
            raise ValueError(f"{fname}: the native reader is not built or refuses "
                             f"the header {header.strip()!r}")
        nrow, ncol, rows, cols, vals = res
    elif backend == "scipy":
        import scipy.io

        coo = scipy.io.mmread(fname).tocoo()
        nrow, ncol, rows, cols, vals = *coo.shape, coo.row, coo.col, coo.data
    else:
        raise ValueError(f"unknown .mtx backend {backend!r}")
    a = CSRMatrix.from_coo(nrow, ncol, rows, cols, vals, dtype=dtype)
    a.backend = backend
    return a


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


def write_mtx(fname: str, a: CSRMatrix) -> None:
    """Write ``a`` as a general coordinate .mtx file with scipy's writer
    (``crp_tpu/sparse/mmio.py:64-67``)."""
    import scipy.io

    scipy.io.mmwrite(fname, a.to_scipy())
