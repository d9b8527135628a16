"""The slice as a whole: the port's RowParaSpmm on the CPU against the JAX
RowParaSpmm on a one-device CPU mesh, on the same matrix and B."""

import numpy as np
import pytest
import torch

from crp_tpu.config import SpmmConfig
from crp_tpu.engine.rowpara import RowParaSpmm as JaxRowPara
from crp_tpu.plan.partition1d import csr_row_partition
from crp_tpu.shard.layout import make_mesh_1d
from crp_tpu.sparse.csr import CSRMatrix
from crp_tpu.sparse.synth import banded_random_csr, fill_b, powerlaw_random_csr
from crp_tpu.utils.norms import rel_fro_err

from crp_tpu_torch.engine.rowpara import RowParaSpmm

TOL_REF = {"x3": 1e-5, "default": 5e-3, "highest": 1e-6}


def _pair(a, n, config, dtype):
    displs = csr_row_partition(a.rowptr, 1)
    j = JaxRowPara(a, displs, displs, n, mesh=make_mesh_1d(1), config=config,
                   dtype=dtype)
    t = RowParaSpmm(a, displs, displs, n, device="cpu", config=config, dtype=dtype)
    return j, t


def _assert_same_decisions(j, t):
    assert t.kernel_kind == j.kernel_kind
    assert t._rb_rows == j._rb_rows
    assert t._identity_exchange == j._identity_exchange
    assert t.max_k == j.max_k
    assert t.rB_recv_size == j.rB_recv_size


@pytest.mark.parametrize("n", [48, 256])
@pytest.mark.parametrize("prec", ["x3", "default", "highest"])
def test_pallas_fp32_matches_jax(prec, n):
    a = banded_random_csr(2000, nnz_per_row=7, bandwidth=80, seed=5,
                          dtype=np.float32)
    b = fill_b(0, a.ncol, 0, n, dtype=np.float32)
    j, t = _pair(a, n, SpmmConfig(kernel="pallas", mxu_precision=prec), np.float32)
    _assert_same_decisions(j, t)
    assert t.kernel_kind == "pallas" and t._identity_exchange
    cj, ct = j.exec(b), t.exec(b)
    assert ct.shape == cj.shape == (a.nrow, n) and ct.dtype == np.float32
    assert rel_fro_err(cj.astype(np.float64), ct) <= 1e-6
    assert rel_fro_err(a.spmm_ref(b.astype(np.float64)), ct) <= TOL_REF[prec]


@pytest.mark.parametrize("kernel", ["segsum", "pallas", "auto"])
def test_fp64_matches_jax(kernel):
    a = banded_random_csr(1800, nnz_per_row=9, bandwidth=60, seed=6)
    b = fill_b(0, a.ncol, 0, 40)
    j, t = _pair(a, 40, SpmmConfig(kernel=kernel), np.float64)
    _assert_same_decisions(j, t)
    cj, ct = j.exec(b), t.exec(b)
    assert ct.dtype == np.float64
    assert rel_fro_err(cj, ct) <= 1e-12
    assert rel_fro_err(a.spmm_ref(b), ct) <= 1e-12


def _with_unreferenced_columns(extra=300):
    """Square banded A plus ``extra`` columns no row references: the p = 1
    exchange is then a compacting copy, not the identity."""
    a = banded_random_csr(1500, nnz_per_row=7, bandwidth=50, seed=8,
                          dtype=np.float32)
    return CSRMatrix(a.nrow, a.ncol + extra, a.rowptr, a.colidx, a.val)


@pytest.mark.parametrize("kernel,prec", [("pallas", "x3"), ("segsum", "highest")])
@pytest.mark.parametrize("reidx", [1, 0])
def test_non_identity_exchange_matches_jax(kernel, prec, reidx):
    a = _with_unreferenced_columns()
    b = fill_b(0, a.ncol, 0, 24, dtype=np.float32)
    cfg = SpmmConfig(kernel=kernel, mxu_precision=prec, rb_reidx=reidx)
    j, t = _pair(a, 24, cfg, np.float32)
    _assert_same_decisions(j, t)
    assert not t._identity_exchange
    cj, ct = j.exec(b), t.exec(b)
    assert rel_fro_err(cj.astype(np.float64), ct) <= 1e-6
    assert rel_fro_err(a.spmm_ref(b.astype(np.float64)), ct) <= TOL_REF[prec]
    c_timed = t.unshard_c(t.exec_timed(t.shard_b(b)))
    np.testing.assert_array_equal(c_timed, ct)
    assert {"a2a", "spmm"} <= set(t.timer.t)


def _band_with_far_entries(nrow=20000):
    """Narrow band plus one far column every 256 rows: group windows span
    over 16384 rows, which the uniform pack refuses."""
    a = banded_random_csr(nrow, nnz_per_row=5, bandwidth=50, seed=3,
                          dtype=np.float32)
    rows = np.repeat(np.arange(nrow), np.diff(a.rowptr))
    far = np.arange(0, nrow, 256)
    key = np.unique(np.r_[rows * nrow + a.colidx, far * nrow + (far + 17000) % nrow])
    vals = np.random.default_rng(3).standard_normal(key.size)
    return CSRMatrix.from_coo(nrow, nrow, key // nrow, key % nrow, vals,
                              dtype=np.float32)


def test_wide_windows_take_the_ragged_pack():
    """Windows over 16384 rows: JAX and the port both pack this matrix for
    the ragged kernels (kind "pallas", variant "ragged"), the same arrays."""
    from crp_tpu.kernels.dispatch import pack_with_fallback as jax_pack

    a = _band_with_far_entries()
    cfg = SpmmConfig(kernel="pallas", mxu_precision="highest")
    j_arrays, fn, kind = jax_pack([(a.rowptr, a.colidx, a.val)], a.nrow,
                                  np.float32, "pallas", mxu_precision="highest")
    assert (kind, fn.variant) == ("pallas", "ragged")
    displs = csr_row_partition(a.rowptr, 1)
    t = RowParaSpmm(a, displs, displs, 8, device="cpu", config=cfg,
                    dtype=np.float32)
    assert (t.kernel_kind, t._local_op.variant) == (kind, fn.variant)
    assert t._local_op.min_b_rows == fn.min_b_rows
    for x, y in zip(t.packed, j_arrays):
        np.testing.assert_array_equal(x.numpy(), y)
    b = fill_b(0, a.ncol, 0, 8, dtype=np.float32)
    assert rel_fro_err(a.spmm_ref(b.astype(np.float64)), t.exec(b)) <= 1e-6


@pytest.mark.parametrize("prec,dtype,tol", [
    ("x3", np.float32, 1e-6), ("default", np.float32, 1e-6),
    ("highest", np.float32, 1e-6), ("highest", np.float64, 1e-12),
])
def test_ragged_matches_jax(prec, dtype, tol):
    """The ragged kind on a power-law matrix: the same decisions as the
    JAX engine, and the same product (JAX runs its Pallas kernels in
    interpret mode)."""
    a = powerlaw_random_csr(2500, avg_degree=13, seed=4, dtype=dtype)
    b = fill_b(0, a.ncol, 0, 24, dtype=dtype)
    j, t = _pair(a, 24, SpmmConfig(kernel="ragged", mxu_precision=prec), dtype)
    _assert_same_decisions(j, t)
    assert t._local_op.variant == j._local_fn.variant == "ragged"
    assert t._local_op.roofline == j._local_fn.roofline
    cj, ct = j.exec(b), t.exec(b)
    assert ct.shape == (a.nrow, 24) and ct.dtype == dtype
    assert rel_fro_err(cj.astype(np.float64), ct) <= tol
    ref_tol = TOL_REF[prec] if dtype == np.float32 else 1e-12
    assert rel_fro_err(a.spmm_ref(b.astype(np.float64)), ct) <= ref_tol


@pytest.mark.parametrize("change,match", [
    (dict(overlap=1), "Queue A #8"),
    (dict(kernel="pallas_halo"), "Queue A #10"),
    (dict(kernel="dd", overlap=1), "incompatible with overlap"),
    (dict(kernel="dd_mxu", bc_layout=1), "BC_layout"),
    (dict(bc_layout=1), "Queue A #3"),
])
def test_unported_options_raise(change, match):
    """Unported options raise NotImplementedError naming their ROADMAP
    item; the dd kinds, now ported, keep the JAX engine's ValueError
    refusals of overlap and bc_layout (``rowpara.py:125-135``)."""
    a = banded_random_csr(300, nnz_per_row=5, bandwidth=20, seed=1)
    displs = csr_row_partition(a.rowptr, 1)
    exc = ValueError if change.get("kernel", "").startswith("dd") else NotImplementedError
    with pytest.raises(exc, match=match):
        RowParaSpmm(a, displs, displs, 8, device="cpu", config=SpmmConfig(**change))


def test_multi_shard_raises():
    a = banded_random_csr(300, nnz_per_row=5, bandwidth=20, seed=1)
    displs = csr_row_partition(a.rowptr, 2)
    with pytest.raises(NotImplementedError, match="p = 2"):
        RowParaSpmm(a, displs, displs, 8, device="cpu")


def test_pack_memo_reuses_and_evicts():
    a = banded_random_csr(1200, nnz_per_row=6, bandwidth=40, seed=2,
                          dtype=np.float32)
    displs = csr_row_partition(a.rowptr, 1)
    mk = lambda prec: RowParaSpmm(  # noqa: E731
        a, displs, displs, 16, device="cpu",
        config=SpmmConfig(kernel="pallas", mxu_precision=prec), dtype=np.float32)
    e1, e2 = mk("x3"), mk("x3")
    assert all(x.data_ptr() == y.data_ptr() for x, y in zip(e1.packed, e2.packed))
    assert "pack" not in e2._t_build.t  # served from the memo
    e3 = mk("highest")
    assert len(a._torch_pack_cache) == 1 and e3.packed[1].dtype == torch.float32
    assert isinstance(e1, torch.nn.Module)
    assert [n for n, _ in e1.named_buffers()] == ["packed_0", "packed_1",
                                                  "packed_2", "packed_3"]


def test_stats_and_breakdown():
    a = banded_random_csr(800, nnz_per_row=5, bandwidth=30, seed=3,
                          dtype=np.float32)
    displs = csr_row_partition(a.rowptr, 1)
    t = RowParaSpmm(a, displs, displs, 8, device="cpu",
                    config=SpmmConfig(kernel="pallas", mxu_precision="x3"),
                    dtype=np.float32)
    assert set(t.init_breakdown) == {"plan", "pack", "upload"}
    b = fill_b(0, a.ncol, 0, 8, dtype=np.float32)
    t.exec(b)
    t.exec_timed(t.shard_b(b))
    table = t.print_stat()
    assert "rp_spmm_init() time" in table and "Total exec()" in table
    assert t.timer.n_exec == 2
    t.clear_stat()
    assert t.timer.n_exec == 0
