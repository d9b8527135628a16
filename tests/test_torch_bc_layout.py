"""``RowParaSpmm(bc_layout=1)``, the reference's col-major B/C view
(``src/rowpara_spmm.c:225-264,400-407``), against JAX's on the CPU mesh:
B arrives as (n, k), C returns as (n, m).  C within 1e-12 of JAX's in fp64
and 1e-6 in fp32 (the same products, another order), equal bit for bit to
the row-major engine's C transposed; ``auto``'s step down from the fused
kernel; the refusals (the dd kinds, an explicit ``pallas_halo``, the 2D
and any-layout engines) raise JAX's ``ValueError``."""

import numpy as np
import pytest

from crp_tpu.config import SpmmConfig as JaxConfig
from crp_tpu.engine.rowpara import RowParaSpmm as JaxRowPara
from crp_tpu.shard.layout import make_mesh_1d

from crp_tpu_torch import CrpSpmm, Para2dSpmm, RowParaSpmm, SpmmConfig
from crp_tpu_torch.engine import rowpara as trp
from crp_tpu_torch.plan.partition1d import csr_row_partition
from crp_tpu_torch.shard.redist import BlockDist
from crp_tpu_torch.sparse.csr import CSRMatrix
from crp_tpu_torch.sparse.synth import banded_random_csr, fill_b
from crp_tpu_torch.utils.blocks import uniform_displs
from crp_tpu_torch.utils.norms import rel_fro_err
from tests.test_torch_para2d import force_plan

TOL = {np.float64: 1e-12, np.float32: 1e-6}


@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("kernel,dtype,prec", [
    ("auto", np.float64, "highest"), ("pallas", np.float32, "x3"),
    ("pallas", np.float64, "highest"),
])
def test_bc_layout_matches_jax(devices8, p, kernel, dtype, prec):
    a = banded_random_csr(700, nnz_per_row=7, bandwidth=45, seed=77, dtype=dtype)
    # unreferenced trailing columns: the p = 1 exchange is not the identity
    a = CSRMatrix(a.nrow, a.ncol + 40, a.rowptr, a.colidx, a.val)
    n = 24
    d = csr_row_partition(a.rowptr, p)
    bd = uniform_displs(a.ncol, p)
    cfg = dict(kernel=kernel, mxu_precision=prec, bc_layout=1)
    j = JaxRowPara(a, d, bd, n, mesh=make_mesh_1d(p, devices=devices8[:p]),
                   config=JaxConfig(**cfg), dtype=dtype)
    t = RowParaSpmm(a, d, bd, n, device="cpu", config=SpmmConfig(**cfg), dtype=dtype)
    assert t.kernel_kind == j.kernel_kind and t.max_k == j.max_k
    b = fill_b(0, a.ncol, 0, n, dtype=dtype)
    bt = np.ascontiguousarray(b.T)                      # (n, k) in
    cj, ct = j.exec(bt), t.exec(bt)
    assert ct.shape == cj.shape == (n, a.nrow) and ct.dtype == dtype
    assert rel_fro_err(cj.astype(np.float64), ct) <= TOL[dtype]
    assert rel_fro_err(a.spmm_ref(b.astype(np.float64)).T, ct) <= (
        1e-5 if prec == "x3" else TOL[dtype])
    row = RowParaSpmm(a, d, bd, n, device="cpu", dtype=dtype,
                      config=SpmmConfig(kernel=kernel, mxu_precision=prec))
    np.testing.assert_array_equal(ct, row.exec(b).T)    # (n, m) out
    bs = t.shard_b(bt)
    np.testing.assert_array_equal(bs.numpy(), row.shard_b(b).numpy())


def test_auto_steps_down_from_the_fused_kernel(devices8, monkeypatch):
    """Where ``auto`` resolves to ``pallas_halo`` (on the card, forced here
    on both sides), ``bc_layout=1`` takes ``pallas`` instead."""
    import crp_tpu.kernels.dispatch as jd

    monkeypatch.setattr(jd, "resolve_auto_kernel", lambda *a, **k: "pallas_halo")
    monkeypatch.setattr(trp, "resolve_auto_kernel", lambda *a, **k: "pallas_halo")
    a = banded_random_csr(600, nnz_per_row=7, bandwidth=40, seed=78)
    d = csr_row_partition(a.rowptr, 2)
    cfg = dict(bc_layout=1)
    j = JaxRowPara(a, d, d, 8, mesh=make_mesh_1d(2, devices=devices8[:2]),
                   config=JaxConfig(**cfg))
    t = RowParaSpmm(a, d, d, 8, device="cpu", config=SpmmConfig(**cfg))
    assert t.kernel_kind == j.kernel_kind == "pallas" and not t.is_halo
    bt = np.ascontiguousarray(fill_b(0, a.ncol, 0, 8).T)
    assert rel_fro_err(j.exec(bt), t.exec(bt)) <= 1e-12


@pytest.mark.parametrize("kernel", ["dd", "dd_mxu", "pallas_halo"])
def test_rowpara_refusals_are_jax(devices8, kernel):
    a = banded_random_csr(300, nnz_per_row=5, bandwidth=20, seed=3)
    d = csr_row_partition(a.rowptr, 2)
    cfg = dict(bc_layout=1, kernel=kernel)
    with pytest.raises(ValueError, match="BC_layout") as ej:
        JaxRowPara(a, d, d, 8, mesh=make_mesh_1d(2, devices=devices8[:2]),
                   config=JaxConfig(**cfg))
    with pytest.raises(ValueError, match="BC_layout") as et:
        RowParaSpmm(a, d, d, 8, device="cpu", config=SpmmConfig(**cfg))
    assert type(et.value) is type(ej.value)


def test_other_engines_refuse():
    a = banded_random_csr(300, nnz_per_row=5, bandwidth=20, seed=3)
    cfg = SpmmConfig(bc_layout=1)
    with pytest.raises(ValueError, match="BC_layout"):
        Para2dSpmm(a, force_plan(a, 8, 2, 2), device="cpu", config=cfg)
    ub = BlockDist.from_row_slabs(uniform_displs(a.ncol, 4), 8)
    uc = BlockDist.from_row_slabs(uniform_displs(a.nrow, 4), 8)
    with pytest.raises(ValueError, match="BC_layout"):
        CrpSpmm(a, 8, ub, uc, nproc=4, device="cpu", config=cfg)
