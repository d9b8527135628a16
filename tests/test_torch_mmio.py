"""The port's Matrix Market I/O (``crp_tpu_torch/sparse/mmio.py`` and
``native/mtx.cpp``) against the JAX package's (``crp_tpu/sparse/mmio.py``
with its native reader) and against scipy's reader: the CSR arrays equal
bit for bit (no tolerance) for general real, integer, pattern symmetric
and real symmetric files with comment lines; scipy's reader is the
default, ``backend="native"`` refuses the headers the native stat refuses;
``write_mtx`` round-trips; the reader names its backend.
"""

import numpy as np
import pytest
import scipy.io

from crp_tpu.sparse import mmio as jmmio
from crp_tpu.sparse.csr import CSRMatrix as JaxCSR

from crp_tpu_torch import native
from crp_tpu_torch.sparse import mmio
from crp_tpu_torch.sparse.csr import CSRMatrix
from crp_tpu_torch.sparse.synth import banded_random_csr, powerlaw_community_csr

FILES = {
    "real_general": (
        "%%MatrixMarket matrix coordinate real general\n% comment\n%\n"
        "4 5 6\n1 1 1.5\n1 5 -2.25e-3\n2 3 3.0\n4 1 0.1\n4 4 1e10\n3 2 -7\n"),
    "integer_general": (
        "%%MatrixMarket matrix coordinate integer general\n% ints\n"
        "3 3 4\n1 2 7\n2 2 -3\n3 1 12\n3 3 1\n"),
    "pattern_symmetric": (
        "%%MatrixMarket matrix coordinate pattern symmetric\n% comment line\n"
        "3 3 3\n1 1\n2 1\n3 2\n"),
    "real_symmetric": (
        "%%MatrixMarket matrix coordinate real symmetric\n% a\n% b\n"
        "4 4 5\n1 1 2.0\n2 1 0.3333333333333333\n3 3 -1.25\n4 2 6.02e23\n4 4 1\n"),
}
REFUSED = {
    "complex": ("%%MatrixMarket matrix coordinate complex general\n"
                "2 2 1\n1 1 1.0 2.0\n"),
    "hermitian": ("%%MatrixMarket matrix coordinate complex hermitian\n"
                  "2 2 1\n2 1 1.0 2.0\n"),
    "skew": ("%%MatrixMarket matrix coordinate real skew-symmetric\n"
             "3 3 2\n2 1 1.5\n3 2 -2.0\n"),
    "array": "%%MatrixMarket matrix array real general\n2 2\n1.0\n2.0\n3.0\n4.0\n",
}


def _same(x, y):
    assert (x.nrow, x.ncol) == (y.nrow, y.ncol)
    for f in ("rowptr", "colidx", "val"):
        a, b = getattr(x, f), getattr(y, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _scipy_csr(path):
    coo = scipy.io.mmread(path).tocoo()
    a = CSRMatrix.from_coo(coo.shape[0], coo.shape[1], coo.row, coo.col, coo.data)
    default = mmio.mm_read_sparse(path)
    assert default.backend == "scipy"
    _same(default, a)
    return a


@pytest.mark.parametrize("name", sorted(FILES))
def test_native_reader_equals_jax_and_scipy(name, tmp_path):
    path = tmp_path / f"{name}.mtx"
    path.write_text(FILES[name])
    a = mmio.mm_read_sparse(str(path), backend="native")
    assert a.backend == "native"
    _same(a, jmmio.mm_read_sparse(str(path)))
    _same(a, _scipy_csr(str(path)))


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_headers_native(name, tmp_path):
    path = tmp_path / f"{name}.mtx"
    path.write_text(REFUSED[name])
    assert native.mtx_read(str(path)) is None
    with pytest.raises(ValueError, match="refuses the header"):
        mmio.mm_read_sparse(str(path), backend="native")
    if name == "skew":  # the one refused file scipy reads into a real CSR
        a = mmio.mm_read_sparse(str(path))
        assert a.backend == "scipy"
        _same(a, jmmio.mm_read_sparse(str(path)))
        assert a.to_dense()[0, 1] == -1.5


@pytest.mark.parametrize("make", [
    lambda: banded_random_csr(60, nnz_per_row=4, bandwidth=6, seed=63),
    lambda: powerlaw_community_csr(3000, avg_degree=9, comm_size=200, seed=4),
])
def test_write_mtx_round_trip(make, tmp_path):
    """``write_mtx`` writes the file JAX's writes, byte for byte, and both
    readers give the matrix back bit for bit."""
    a = make()
    t_path, j_path = tmp_path / "t.mtx", tmp_path / "j.mtx"
    mmio.write_mtx(str(t_path), a)
    jmmio.write_mtx(str(j_path), JaxCSR(a.nrow, a.ncol, a.rowptr, a.colidx, a.val))
    assert t_path.read_bytes() == j_path.read_bytes()
    b = mmio.mm_read_sparse(str(t_path), backend="native")
    assert b.backend == "native"
    _same(b, a)
    _same(_scipy_csr(str(t_path)), a)


def test_need_symm_and_backend_name(tmp_path):
    path = tmp_path / "g.mtx"
    path.write_text(FILES["real_general"])
    with pytest.raises(ValueError, match="not symmetric"):
        mmio.mm_read_sparse(str(path), need_symm=True)
    assert mmio.mm_read_sparse(str(path)).backend == "scipy" and native.mtx_available()
    with pytest.raises(ValueError, match="unknown"):
        mmio.mm_read_sparse(str(path), backend="fast")
    assert native.library_path(native.MTX_SOURCE) != native.library_path()
    assert native.library_path(native.MTX_SOURCE).exists()
