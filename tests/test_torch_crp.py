"""The any-layout engine, ``CrpSpmm`` (``crp_tpu_torch/engine/crp.py``),
against ``crp_tpu.engine.crp.CrpSpmm`` on the 8-device CPU mesh: the 17
tests of ``tests/test_crp_engine.py`` (the reference driver
``deprecated/examples/test_crpspmm.c``: B and C in user 2D blocks,
analytic B).  Each holds the port to JAX's grid, kernel kind and
fallback, every communicated-element counter (the ``print_stat`` rows
included) and C: within 1e-12 of JAX's in fp64, 1e-6 in fp32 (the same
products summed in another order), and each within its class of the fp64
reference (1e-12, or 1e-5 for fp32)."""

import numpy as np
import pytest

from crp_tpu.config import SpmmConfig as JaxConfig
from crp_tpu.engine.crp import CrpSpmm as JaxCrp
from crp_tpu.plan.bandwidth import calc_bandwidth_part2d as jax_plan
from crp_tpu.shard.layout import make_mesh_2d
from crp_tpu.shard.redist import BlockDist as JaxBlockDist

from crp_tpu_torch import CrpSpmm, SpmmConfig
from crp_tpu_torch.kernels import dispatch as td
from crp_tpu_torch.sparse.csr import CSRMatrix
from crp_tpu_torch.sparse.synth import banded_random_csr, fill_b, powerlaw_random_csr
from crp_tpu_torch.utils.blocks import uniform_displs
from crp_tpu_torch.utils.norms import rel_fro_err

TOL_JAX = {np.float64: 1e-12, np.float32: 1e-6}
TOL_REF = {np.float64: 1e-12, np.float32: 1e-5}
COUNTERS = ("nelem_A_rd", "nelem_A_agv", "nelem_B_rd", "nelem_B_a2av", "nelem_B_a2av_min")


def grid(m, n, pr, pc):
    return uniform_displs(m, pr), uniform_displs(n, pc)


def _elements(table: str) -> list:
    return table.split("Communicated Matrix Elements")[1].splitlines()


def pair(a, n, p, devices8, cfg=None, ub=None, uc=None, dtype=None, force=None):
    """The JAX engine and the port's on the same matrix, layouts and
    config; ``force`` a (pm, pn) grid given to both as the plan."""
    ub = ub if ub is not None else grid(a.ncol, n, p, 1)
    uc = uc if uc is not None else grid(a.nrow, n, 1, p)
    cfg = cfg or {}
    bp = jax_plan(p, a.nrow, n, a.ncol, a.rowptr, a.row_col_ranges_v1())
    kw = {}
    if force is not None:
        bp.np_row, bp.np_col = force
        kw = dict(bplan=bp)
    mesh = make_mesh_2d(bp.np_row, bp.np_col, devices=devices8)
    j = JaxCrp(a, n, JaxBlockDist(_blocks(ub)), JaxBlockDist(_blocks(uc)), nproc=p,
               mesh=mesh, config=JaxConfig(**cfg), dtype=dtype, **kw)
    t = CrpSpmm(a, n, _bd(ub), _bd(uc), nproc=p, device="cpu", config=SpmmConfig(**cfg),
                dtype=dtype, **kw)
    return j, t


def _blocks(layout):
    if isinstance(layout, tuple):
        rd, cd = layout
        return np.array([[rd[i], cd[k], rd[i + 1] - rd[i], cd[k + 1] - cd[k]]
                         for i in range(len(rd) - 1) for k in range(len(cd) - 1)])
    return layout


def _bd(layout):
    from crp_tpu_torch.shard.redist import BlockDist

    return BlockDist(_blocks(layout))


def same(j, t, a, n, dtype=np.float64, reps=1):
    """Equal decisions and counters; C against JAX's and the reference."""
    assert (t.pm, t.pn) == (j.pm, j.pn)
    assert (t.kernel_kind, t.is_halo, t.overlap, t.fine) == (
        j.kernel_kind, j.is_halo, j.overlap, j.fine)
    for f in COUNTERS:
        assert getattr(t, f) == getattr(j, f), f
    b = fill_b(0, a.ncol, 0, n, dtype=dtype)
    cj = j.exec(b)
    for _ in range(reps):
        ct = t.exec(b)
        assert ct.shape == cj.shape and ct.dtype == cj.dtype
        assert rel_fro_err(cj.astype(np.float64), ct) <= TOL_JAX[dtype]
        assert rel_fro_err(a.spmm_ref(b.astype(np.float64)), ct) <= TOL_REF[dtype]
    assert _elements(t.print_stat()) == _elements(j.print_stat())
    return ct


@pytest.mark.parametrize("p", [2, 4, 8])
def test_crp_banded(devices8, p):
    a = banded_random_csr(400, nnz_per_row=40, bandwidth=30, seed=40)
    same(*pair(a, 12, p, devices8), a, 12)


def test_crp_powerlaw_splits_n(devices8):
    a = powerlaw_random_csr(500, avg_degree=4, seed=41)
    j, t = pair(a, 16, 8, devices8)
    assert t.pn > 1
    same(j, t, a, 16)


def test_crp_finegrain_mode(devices8):
    """The exact referenced rows travel: Alltoallv B equals the necessary
    volume (``crpspmm.c:339-396``)."""
    a = banded_random_csr(400, nnz_per_row=30, bandwidth=40, seed=42)
    j, t = pair(a, 8, 8, devices8, dict(a2a_b_finegrain=1))
    same(j, t, a, 8)
    if t.pm > 1:
        assert t.nelem_B_a2av == t.nelem_B_a2av_min


def test_crp_coarse_upper_bounds_necessary(devices8):
    a = banded_random_csr(400, nnz_per_row=30, bandwidth=40, seed=42)
    j, t = pair(a, 8, 8, devices8)
    same(j, t, a, 8)
    assert t.pm > 1 and t.nelem_B_a2av >= t.nelem_B_a2av_min
    assert t.nelem_B_rd == a.ncol * 8


def test_crp_arbitrary_user_layouts(devices8):
    """B as column slabs, C wanted as 4 x 2 grid blocks."""
    a = banded_random_csr(300, nnz_per_row=25, bandwidth=25, seed=43)
    n = 10
    same(*pair(a, n, 8, devices8, ub=grid(a.ncol, n, 1, 8), uc=grid(a.nrow, n, 4, 2)),
         a, n)


def test_crp_gather_all_to_root(devices8):
    """C gathered on owner 0 (the README validation path)."""
    a = banded_random_csr(200, nnz_per_row=20, bandwidth=15, seed=44)
    n = 6
    root = np.zeros((8, 4), np.int64)
    root[0] = [0, 0, a.nrow, n]
    j, t = pair(a, n, 8, devices8, uc=root)
    same(j, t, a, n)
    assert "Alltoallv B necessary" in t.print_stat()


def test_crp_pallas_kernel_nonmultiple_tm(devices8):
    """``pallas`` returns G*TM >= max_m rows, trimmed to rd_C's max_m."""
    a = banded_random_csr(400, nnz_per_row=30, bandwidth=30, seed=47)
    j, t = pair(a, 8, 4, devices8, dict(kernel="pallas"))
    assert t.max_m % 256 != 0 and t.max_m == j.max_m
    same(j, t, a, 8)


@pytest.mark.parametrize("p2p", [0, 1], ids=["a2a", "ring"])
def test_crp_rb_p2p_modes_agree(devices8, p2p):
    a = banded_random_csr(400, nnz_per_row=30, bandwidth=40, seed=48)
    j, t = pair(a, 8, 8, devices8, dict(rb_p2p=p2p))
    c = same(j, t, a, 8)
    other = CrpSpmm(a, 8, _bd(grid(a.ncol, 8, 8, 1)), _bd(grid(a.nrow, 8, 1, 8)), nproc=8,
                    device="cpu", config=SpmmConfig(rb_p2p=1 - p2p))
    np.testing.assert_array_equal(other.exec(fill_b(0, a.ncol, 0, 8)), c)


def test_crp_overlap_schedule(devices8):
    """``overlap=1``: the ring beside each panel's self part; two execs
    equal bit for bit."""
    a = banded_random_csr(400, nnz_per_row=30, bandwidth=40, seed=49)
    j, t = pair(a, 8, 8, devices8, dict(overlap=1))
    c = same(j, t, a, 8, reps=2)
    assert t.overlap and t.kernel_kind == j.kernel_kind == t.ring.self_kind
    np.testing.assert_array_equal(c, t.exec(fill_b(0, a.ncol, 0, 8)))
    assert "a2a_B" not in t.timer.t


def test_crp_dd_kernel(devices8):
    """``kernel="dd"``: fp64 class through both redistributions (the port
    moves fp64 once, JAX hi / lo halves twice; the counters are equal)."""
    a = banded_random_csr(300, nnz_per_row=20, bandwidth=30, seed=50)
    j, t = pair(a, 8, 4, devices8, dict(kernel="dd"))
    assert t.is_dd and t.kernel_kind == "dd" and t.rd_B.dtype == np.float64
    same(j, t, a, 8)


def test_crp_staged_phase_accounting(devices8):
    """``exec`` fences the exchange and the SpMM apart (``a2a_B``,
    ``spmm``), and the stat table has JAX's rows."""
    a = banded_random_csr(400, nnz_per_row=30, bandwidth=40, seed=51)
    j, t = pair(a, 8, 8, devices8)
    same(j, t, a, 8)
    assert t.pm > 1
    for k in ("rd_B", "a2a_B", "spmm", "rd_C", "exec_nr", "exec"):
        assert len(t.timer.samples[k]) == 1, k
    rows = lambda s: [ln[:31] for ln in s.splitlines()[1:]]  # noqa: E731
    assert rows(t.print_stat()) == rows(j.print_stat())
    t.clear_stat()
    assert t.timer.n_exec == 0


def test_crp_overlap_pallas_kernel(devices8):
    """``overlap=1`` with ``pallas``: the self kernel's window reach past
    rd_B's slab height is padded in the exec."""
    a = banded_random_csr(800, nnz_per_row=30, bandwidth=40, seed=52)
    j, t = pair(a, 8, 8, devices8, dict(overlap=1, kernel="pallas"))
    assert t._b_pad == j._ring_pad
    same(j, t, a, 8)


@pytest.mark.parametrize("p,force", [(4, None), (6, (3, 2))], ids=["p4", "p6-3x2"])
def test_crp_pallas_halo(devices8, p, force):
    """The fused halo kernel in the any-layout engine, on the planner's
    grid and a forced 3 x 2; two execs."""
    a = banded_random_csr(3000, nnz_per_row=9, bandwidth=150, seed=47)
    n = 48
    layout = (uniform_displs(a.ncol, p), np.array([0, n]))
    c_layout = (uniform_displs(a.nrow, p), np.array([0, n]))
    j, t = pair(a, n, p, devices8, dict(kernel="pallas_halo"), ub=layout, uc=c_layout,
                force=force)
    assert t.is_halo and t.kernel_kind == "pallas_halo"
    same(j, t, a, n, reps=2)


def test_crp_halo_rejects_finegrain():
    a = banded_random_csr(500, nnz_per_row=5, bandwidth=40, seed=48)
    ub = _bd((uniform_displs(a.ncol, 4), np.array([0, 8])))
    uc = _bd((uniform_displs(a.nrow, 4), np.array([0, 8])))
    with pytest.raises(ValueError, match="FINEGRAIN"):
        CrpSpmm(a, 8, ub, uc, nproc=4, device="cpu",
                config=SpmmConfig(kernel="pallas_halo", a2a_b_finegrain=1))


def test_crp_halo_falls_back_on_unsupported(devices8):
    """The halo plan refuses this power-law matrix in both packages; the
    engine lands on the unfused ``pallas`` path."""
    a = powerlaw_random_csr(20000, avg_degree=4, seed=49)
    n = 8
    layout = (uniform_displs(a.ncol, 4), np.array([0, n]))
    c_layout = (uniform_displs(a.nrow, 4), np.array([0, n]))
    j, t = pair(a, n, 4, devices8, dict(kernel="pallas_halo"), ub=layout, uc=c_layout)
    assert not t.is_halo and not j.is_halo
    same(j, t, a, n)


def test_crp_gather_and_ragged_kernels(devices8, monkeypatch):
    """``gather`` and ``ragged`` (a forced geometry and spill; JAX by its
    environment knobs, the port by the pack's arguments) under the whole
    redistribution chain, fp32."""
    a = powerlaw_random_csr(900, avg_degree=12, seed=44, dtype=np.float32)
    n = 16
    kw = dict(ub=grid(a.ncol, n, 4, 1), uc=grid(a.nrow, n, 1, 4), dtype=np.float32)
    j, t = pair(a, n, 4, devices8, dict(kernel="gather"), **kw)
    assert t._local_op.variant == j._local_fn.variant == "gather"
    same(j, t, a, n, np.float32)

    monkeypatch.setenv("CRP_TPU_SPILL_IMPL", "pallas")
    monkeypatch.setenv("CRP_TPU_RAGGED_TM", "128")
    monkeypatch.setenv("CRP_TPU_RAGGED_WC", "256")
    monkeypatch.setenv("CRP_TPU_RAGGED_MIN_NNZ", "200")  # force a spill
    orig = td._pack_ragged
    monkeypatch.setattr(td, "_pack_ragged", lambda *args, **k: orig(
        *args, **{**k, "geometry": (128, 256), "min_chunk_nnz": 200}))
    j, t = pair(a, n, 4, devices8, dict(kernel="ragged"), **kw)
    assert t._local_op.variant == j._local_fn.variant == "ragged"
    assert t._local_op.roofline["spill_nnz"] == j._local_fn.roofline["spill_nnz"] > 0
    same(j, t, a, n, np.float32)


def test_crp_fallback_lands_on_gather(devices8, monkeypatch):
    """The TPU's fallback chain (JAX's ``CRP_TPU_FALLBACK``, the port's
    chain patched to the same list) on a scattered matrix both covers
    refuse: both land on ``gather``."""
    monkeypatch.setenv("CRP_TPU_FALLBACK", "gather,segsum")
    monkeypatch.setattr(td, "sparsity_fallback_chain",
                        lambda *args, **kw: ["gather", "segsum"])
    rng = np.random.default_rng(63)
    nr, k = 512, 20000
    rows = np.arange(nr, dtype=np.int64).repeat(4)
    cols = rng.integers(0, k, size=4 * nr)
    a = CSRMatrix.from_coo(nr, k, rows, cols, np.ones(len(rows)))
    n = 16
    j, t = pair(a, n, 4, devices8, dict(kernel="pallas"), ub=grid(a.ncol, n, 4, 1),
                uc=grid(a.nrow, n, 1, 4), dtype=np.float32)
    assert t.kernel_kind == j.kernel_kind == "gather"
    same(j, t, a, n, np.float32)


def test_crp_default_device_is_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    a = banded_random_csr(300, nnz_per_row=5, bandwidth=20, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CrpSpmm(a, 8, _bd(grid(a.ncol, 8, 4, 1)), _bd(grid(a.nrow, 8, 1, 4)), nproc=4)
