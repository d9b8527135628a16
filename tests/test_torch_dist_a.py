"""Distributed A (``crp_tpu_torch/shard/dist_a.py``) against
``crp_tpu.shard.dist_a`` on the CPU mesh: the six tests of
``tests/test_dist_a.py``.  Metadata and assembled panels equal JAX's bit
for bit; the audit counters (``nelem_A_rd``, ``nelem_A_agv``,
``nelem_B_a2av``, ``rA_cost``) equal; C within 1e-12 of the JAX engines in
fp64 and bit for bit the port's own engines on the host-global A."""

import numpy as np
import pytest
import torch

from crp_tpu.engine.crp import CrpSpmm as JaxCrp
from crp_tpu.engine.para2d import Para2dSpmm as JaxPara2d
from crp_tpu.shard.dist_a import DistCSR as JaxDistCSR
from crp_tpu.shard.dist_a import ingest_dist_a as jax_ingest
from crp_tpu.shard.dist_a import replicate_a0 as jax_replicate
from crp_tpu.shard.layout import make_mesh_2d
from crp_tpu.shard.redist import BlockDist as JaxBlockDist

from crp_tpu_torch import CrpSpmm, Para2dSpmm
from crp_tpu_torch.plan.bandwidth import calc_bandwidth_part2d
from crp_tpu_torch.plan.planner2d import plan_from_csr
from crp_tpu_torch.shard.dist_a import DistCSR, ingest_dist_a, replicate_a0
from crp_tpu_torch.shard.redist import BlockDist
from crp_tpu_torch.sparse.synth import banded_random_csr, fill_b, powerlaw_random_csr
from crp_tpu_torch.utils.blocks import uniform_displs
from crp_tpu_torch.utils.norms import rel_fro_err
from tests.test_torch_para2d import force_plan

CPU = torch.device("cpu")


def _same_panels(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.nrow, g.ncol) == (w.nrow, w.ncol)
        for f in ("rowptr", "colidx", "val"):
            x, y = getattr(g, f), np.asarray(getattr(w, f))
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y)


def test_dist_csr_metadata_matches_global_and_jax():
    a = banded_random_csr(500, nnz_per_row=20, bandwidth=30, seed=50)
    displs = uniform_displs(a.nrow, 8)
    d, j = DistCSR.from_global(a, displs), JaxDistCSR.from_global(a, displs)
    np.testing.assert_array_equal(d.global_rowptr(), a.rowptr)
    np.testing.assert_array_equal(d.row_col_ranges(), a.row_col_ranges())
    for f in ("global_rowptr", "row_col_ranges", "row_col_ranges_v1"):
        np.testing.assert_array_equal(getattr(d, f)(), getattr(j, f)())
    assert d.nnz == j.nnz == a.nnz and (d.nrow, d.ncol, d.p) == (j.nrow, j.ncol, j.p)


def test_dist_csr_device_resident_blocks():
    """colidx / val handed over as tensors on a device: the metadata comes
    back from two entries a row, and equals JAX's."""
    a = banded_random_csr(300, nnz_per_row=10, bandwidth=20, seed=51)
    d = DistCSR.from_global(a, uniform_displs(a.nrow, 4), device="cpu")
    assert all(isinstance(c, torch.Tensor) for c in d.colidxs + d.vals)
    j = JaxDistCSR.from_global(a, uniform_displs(a.nrow, 4))
    np.testing.assert_array_equal(d.row_col_ranges(), a.row_col_ranges())
    np.testing.assert_array_equal(d.row_col_ranges_v1(), j.row_col_ranges_v1())


def test_ingest_dist_a_assembles_panels(devices8):
    """rd_Ai / rd_Av and the gather along pn give JAX's panel CSRs bit for
    bit, with its counters."""
    a = banded_random_csr(400, nnz_per_row=25, bandwidth=30, seed=52)
    p = 8
    bp = calc_bandwidth_part2d(p, a.nrow, 16, a.ncol, a.rowptr, a.row_col_ranges_v1())
    for grid in ((bp.np_row, bp.np_col), (2, 4)):
        pm, pn = grid
        idx = bp.m_split_idx if grid == (bp.np_row, bp.np_col) else uniform_displs(a.nrow, pm)
        mesh = make_mesh_2d(pm, pn, devices=devices8)
        displs = uniform_displs(a.nrow, p)
        got = ingest_dist_a(DistCSR.from_global(a, displs, device="cpu"), idx, pm, pn, CPU)
        want = jax_ingest(JaxDistCSR.from_global(a, displs), idx, pm, pn, mesh)
        _same_panels(got[0], want[0])
        assert got[1:] == want[1:] and got[1] == a.nnz
        assert got[2] == (0 if pn == 1 else a.nnz * pn)


@pytest.mark.parametrize("maker", [
    lambda: banded_random_csr(400, nnz_per_row=40, bandwidth=30, seed=53),
    lambda: powerlaw_random_csr(500, avg_degree=4, seed=54),
], ids=["banded", "powerlaw"])
def test_crp_dist_a_end_to_end(devices8, maker):
    """CrpSpmm with A as 8 blocks on uneven user row ranges: C within
    1e-12 of JAX's engine on the same blocks, equal bit for bit to the
    port's engine on the global A; the counters equal JAX's."""
    a = maker()
    n, p = 16, 8
    bp = calc_bandwidth_part2d(p, a.nrow, n, a.ncol, a.rowptr, a.row_col_ranges_v1())
    mesh = make_mesh_2d(bp.np_row, bp.np_col, devices=devices8)
    grids = ((uniform_displs(a.ncol, p), uniform_displs(n, 1)),
             (uniform_displs(a.nrow, 1), uniform_displs(n, p)))
    ub, uc = (BlockDist.from_grid(*g) for g in grids)
    jub, juc = (JaxBlockDist.from_grid(*g) for g in grids)
    cuts = np.linspace(0, a.nrow, p + 1).astype(np.int64)
    cuts[1:-1] += np.array([7, -11, 3, 19, -5, 2, -9], dtype=np.int64)[: p - 1]
    t_d = CrpSpmm(DistCSR.from_global(a, cuts, device="cpu"), n, ub, uc, nproc=p,
                  device="cpu")
    t_g = CrpSpmm(a, n, ub, uc, nproc=p, device="cpu")
    j_d = JaxCrp(JaxDistCSR.from_global(a, cuts), n, jub, juc, nproc=p, mesh=mesh)
    b = fill_b(0, a.ncol, 0, n)
    c = t_d.exec(b)
    np.testing.assert_array_equal(c, t_g.exec(b))
    assert rel_fro_err(j_d.exec(b), c) <= 1e-12
    assert rel_fro_err(a.spmm_ref(b), c) <= 1e-12
    for f in ("nelem_A_rd", "nelem_A_agv", "nelem_B_rd", "nelem_B_a2av",
              "nelem_B_a2av_min"):
        assert getattr(t_d, f) == getattr(j_d, f) == getattr(t_g, f), f
    assert t_d.nelem_A_rd == a.nnz


def test_para2d_from_dist_a(devices8):
    """v2 path: A0-layout blocks gathered along pn; C within 1e-12 of JAX's
    ``from_dist_a`` and bit for bit the port's engine on the global A;
    ``rA_cost`` and ``rB_recv_size`` equal."""
    a = banded_random_csr(600, nnz_per_row=30, bandwidth=40, seed=55)
    n = 24
    plan = plan_from_csr(a, n, 8)
    for plan_ in (plan, force_plan(a, n, 4, 2)):
        mesh = make_mesh_2d(plan_.pm, plan_.pn, devices=devices8)
        t_d = Para2dSpmm.from_dist_a(DistCSR.from_global(a, plan_.A0_rowptr, device="cpu"),
                                     plan_, device="cpu")
        t_g = Para2dSpmm(a, plan_, device="cpu")
        j_d = JaxPara2d.from_dist_a(JaxDistCSR.from_global(a, plan_.A0_rowptr), plan_,
                                    mesh=mesh)
        b = fill_b(0, a.ncol, 0, n)
        c = t_d.exec(b)
        np.testing.assert_array_equal(c, t_g.exec(b))
        assert rel_fro_err(j_d.exec(b), c) <= 1e-12
        assert (t_d.rA_cost, t_d.rB_recv_size) == (j_d.rA_cost, j_d.rB_recv_size)
        assert (t_d.rA_cost, t_d.rB_recv_size) == (t_g.rA_cost, t_g.rB_recv_size)
        assert isinstance(t_d, torch.nn.Module) and t_d.kernel_kind == t_g.kernel_kind


def test_replicate_a0_panels_exact(devices8):
    a = banded_random_csr(512, nnz_per_row=12, bandwidth=25, seed=56)
    plan = plan_from_csr(a, 256, 8)
    for plan_ in (plan, force_plan(a, 256, 2, 4)):
        mesh = make_mesh_2d(plan_.pm, plan_.pn, devices=devices8)
        got = replicate_a0(DistCSR.from_global(a, plan_.A0_rowptr, device="cpu"),
                           plan_.A0_rowptr, plan_.pm, plan_.pn, CPU)
        want = jax_replicate(JaxDistCSR.from_global(a, plan_.A0_rowptr), plan_.A0_rowptr,
                             plan_.pm, plan_.pn, mesh)
        _same_panels(got, want)
        for i in range(plan_.pm):
            ref = a.row_slice(int(plan_.AC_rowptr[i]), int(plan_.AC_rowptr[i + 1]))
            np.testing.assert_array_equal(got[i].colidx, ref.colidx)
            np.testing.assert_array_equal(got[i].val, ref.val)
