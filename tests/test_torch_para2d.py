"""The port's Para2dSpmm on the CPU against the JAX Para2dSpmm on the
8-device CPU mesh: the grids of ``tests/test_para2d.py`` and the planner's
own, the same C, ``rA_cost`` and ``print_stat`` comm lines."""

import numpy as np
import pytest

from crp_tpu.config import SpmmConfig as JaxConfig
from crp_tpu.engine.para2d import Para2dSpmm as JaxPara2d
from crp_tpu.plan.planner2d import plan_from_csr as jax_plan_from_csr
from crp_tpu.shard.layout import make_mesh_2d

from crp_tpu_torch import Para2dSpmm
from crp_tpu_torch.config import SpmmConfig
from crp_tpu_torch.plan.partition1d import csr_row_partition
from crp_tpu_torch.plan.planner2d import Plan2D, plan_from_csr
from crp_tpu_torch.sparse.synth import banded_random_csr, fill_b, powerlaw_random_csr
from crp_tpu_torch.utils.blocks import uniform_displs
from crp_tpu_torch.utils.norms import rel_fro_err


def force_plan(a, n, pm, pn):
    """A plan with a forced ``pm x pn`` grid (``tests/test_para2d.py:19``)."""
    nproc = pm * pn
    rb = csr_row_partition(a.rowptr, nproc)
    AC = rb[::pn].copy()
    return Plan2D(
        nproc=nproc, m=a.nrow, n=n, k=a.ncol, pm=pm, pn=pn, comm_cost=0,
        A0_rowptr=rb.copy(),
        B_rowptr=AC if a.nrow == a.ncol else uniform_displs(a.ncol, pm),
        AC_rowptr=AC, BC_colptr=uniform_displs(n, pn),
    )


def _comm_lines(table: str) -> list:
    return [ln for ln in table.splitlines()
            if ln.startswith(("Total comm size", "Total SpMM comm size",
                              "Physical exchanged rows"))]


def _pair(a, plan, devices, config_kw, dtype=None):
    mesh = make_mesh_2d(plan.pm, plan.pn, devices=devices)
    j = JaxPara2d(a, plan, mesh=mesh, config=JaxConfig(**config_kw), dtype=dtype)
    t = Para2dSpmm(a, plan, device="cpu", config=SpmmConfig(**config_kw), dtype=dtype)
    return j, t


def _assert_same(j, t, b, tol):
    assert t.kernel_kind == j.kernel_kind
    assert (t.rA_cost, t.rB_recv_size) == (j.rA_cost, j.rB_recv_size)
    cj, ct = j.exec(b), t.exec(b)
    assert ct.shape == cj.shape and ct.dtype == cj.dtype
    assert rel_fro_err(cj.astype(np.float64), ct) <= tol
    assert _comm_lines(t.print_stat()) == _comm_lines(j.print_stat())
    return ct


@pytest.mark.parametrize("rb_p2p", [0, 1], ids=["a2a", "ring"])
@pytest.mark.parametrize("pm,pn", [(8, 1), (4, 2), (2, 4), (1, 8), (2, 2), (3, 2)])
def test_para2d_grids_match_jax(devices8, pm, pn, rb_p2p):
    a = banded_random_csr(400, nnz_per_row=7, bandwidth=35, seed=30)
    n = 20
    plan = force_plan(a, n, pm, pn)
    j, t = _pair(a, plan, devices8, dict(rb_p2p=rb_p2p))
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    c = _assert_same(j, t, b, 1e-12)
    assert rel_fro_err(a.spmm_ref(b), c) <= 1e-12
    assert t.kernel_kind == "segsum" and t.packed[0].shape[0] == pm


def test_planner_grid_matches_jax(devices8):
    """The planner's own grid (the flagship path): both planners agree
    field by field, and the engines on that grid agree."""
    a = powerlaw_random_csr(600, avg_degree=12, seed=31)
    n = 64
    plan = plan_from_csr(a, n, 8)
    jplan = jax_plan_from_csr(a, n, 8)
    assert (plan.pm, plan.pn, plan.comm_cost, plan.rA_cost, plan.rB_cost) == (
        jplan.pm, jplan.pn, jplan.comm_cost, jplan.rA_cost, jplan.rB_cost)
    for f in ("A0_rowptr", "B_rowptr", "AC_rowptr", "BC_colptr"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(jplan, f))
    j, t = _pair(a, plan, devices8, {})
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    c = _assert_same(j, t, b, 1e-12)
    assert rel_fro_err(a.spmm_ref(b), c) <= 1e-12


@pytest.mark.parametrize("prec", ["x3", "highest"])
def test_planner_grid_pallas_fp32_matches_jax(devices8, prec):
    """``kernel="pallas"`` in fp32 on the planner's grid: multi-shard
    windowed packs (kernel #4) in both packages, C to 1e-6."""
    a = banded_random_csr(1600, nnz_per_row=9, bandwidth=120, seed=32, dtype=np.float32)
    n = 48
    plan = plan_from_csr(a, n, 4)
    j, t = _pair(a, plan, devices8, dict(kernel="pallas", mxu_precision=prec),
                 dtype=np.float32)
    assert t._local_op.variant == ("window" if plan.pm > 1 else "uniform")
    b = np.asarray(fill_b(0, a.ncol, 0, n, dtype=np.float32))
    c = _assert_same(j, t, b, 1e-6)
    assert rel_fro_err(a.spmm_ref(b.astype(np.float64)), c) <= (
        1e-5 if prec == "x3" else 1e-6)


@pytest.mark.parametrize("n", [13, 20])
def test_dd_mxu_on_a_2x1_grid_matches_jax(devices8, n):
    """``dd_mxu`` on a 2 x 1 grid: both packages' fp64 class, C to 1e-12
    (JAX's Ozaki slices in interpret mode, the port's fp64 panels)."""
    a = banded_random_csr(400, nnz_per_row=7, bandwidth=40, seed=37)
    plan = force_plan(a, n, 2, 1)
    j, t = _pair(a, plan, devices8, dict(kernel="dd_mxu"))
    assert t._local_op.variant == "dd_mxu"
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    c = _assert_same(j, t, b, 1e-12)
    assert c.dtype == np.float64 and rel_fro_err(a.spmm_ref(b), c) <= 1e-12


@pytest.mark.parametrize("change,exc,match", [
    (dict(kernel="pallas_halo", overlap=1), ValueError, "fuses exchange"),
    (dict(bc_layout=1), ValueError, "RowParaSpmm feature"),
], ids=["change1-ValueError-fuses exchange", "change2-ValueError-RowParaSpmm feature"])
def test_para2d_unported_options_raise(change, exc, match):
    a = banded_random_csr(300, nnz_per_row=5, bandwidth=20, seed=1)
    with pytest.raises(exc, match=match):
        Para2dSpmm(a, force_plan(a, 8, 2, 2), device="cpu",
                   config=SpmmConfig(**change))


def test_para2d_default_device_is_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    a = banded_random_csr(300, nnz_per_row=5, bandwidth=20, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Para2dSpmm(a, force_plan(a, 8, 2, 2))
