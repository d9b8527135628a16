"""The overlapped ring (``crp_tpu_torch/comm/ring.py``, ``overlap=1``)
against ``crp_tpu.comm.ring`` and the JAX engines on the 8-device CPU
mesh.  ``build_ring_spmm``'s host arrays (the per-shift rows, slots and
values with JAX's pads, the segsum self part's pack) equal JAX's bit for
bit; ``ring_spmm`` and ``RowParaSpmm`` / ``Para2dSpmm`` at ``overlap=1``
give C within 1e-12 of the JAX engines in fp64 and within 1e-6 in fp32
(the same products summed in another order), with the same kernel kind
and physical rows.  The ``pallas`` self part runs the port's plain
versions on the CPU and JAX's Pallas kernels in interpret mode."""

import numpy as np
import pytest
import torch

from crp_tpu.comm.exchange import build_b_exchange as jax_xplan
from crp_tpu.comm.ring import build_ring_spmm as jax_build
from crp_tpu.config import SpmmConfig as JaxConfig
from crp_tpu.engine.para2d import Para2dSpmm as JaxPara2d
from crp_tpu.engine.rowpara import RowParaSpmm as JaxRowPara
from crp_tpu.shard.layout import make_mesh_1d, make_mesh_2d

from crp_tpu_torch import Para2dSpmm, RowParaSpmm, SpmmConfig
from crp_tpu_torch.comm.exchange import build_b_exchange
from crp_tpu_torch.comm.ring import build_ring_spmm, ring_send_tables, ring_spmm
from crp_tpu_torch.plan.partition1d import csr_row_partition
from crp_tpu_torch.sparse.synth import banded_random_csr, fill_b, powerlaw_random_csr
from crp_tpu_torch.utils.norms import rel_fro_err
from tests.test_torch_para2d import force_plan

CPU = torch.device("cpu")
TOL = {np.float64: 1e-12, np.float32: 1e-6}


def _shards(a, p):
    d = csr_row_partition(a.rowptr, p)
    bd = d.copy()
    bd[-1] = a.ncol
    return d, bd, [a.row_slice(int(d[i]), int(d[i + 1])) for i in range(p)]


@pytest.mark.parametrize("kind,dtype", [("segsum", np.float64), ("pallas", np.float32)])
@pytest.mark.parametrize("p", [2, 3, 4])
def test_build_ring_spmm_matches_jax(kind, dtype, p):
    a = banded_random_csr(600, nnz_per_row=9, bandwidth=70, seed=60 + p, dtype=dtype)
    _, bd, shards = _shards(a, p)
    cols = [s.colidx for s in shards]
    max_m = max(s.nrow for s in shards) + 5
    j = jax_build(shards, jax_xplan(cols, bd), bd, max_m, dtype, kind,
                  mxu_precision="x3")
    t = build_ring_spmm(shards, build_b_exchange(cols, bd), bd, max_m, dtype, kind,
                        device=CPU, mxu_precision="x3")
    assert (t.p, t.S, t.R, t.max_m, t.self_kind, t.min_b_rows) == (
        j.p, j.S, j.R, j.max_m, j.self_kind, j.min_b_rows)
    for f in ("step_rows", "step_cols", "step_vals"):
        x, y = getattr(t, f), getattr(j, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    if kind == "segsum":
        for x, y in zip(t.self_arrays, j.self_arrays):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    # the exec's tables: JAX's real entries, pads dropped
    for k, (cols_t, vals_t, hit) in enumerate(t.shifts):
        real = j.step_rows[:, k] < j.max_m
        rows = (j.step_rows[:, k] + np.arange(p)[:, None] * j.max_m)[real]
        np.testing.assert_array_equal(hit.numpy()[t.shift_rows[k]], rows)
        np.testing.assert_array_equal(hit.numpy(), np.unique(rows))
        np.testing.assert_array_equal(
            cols_t.numpy(), (j.step_cols[:, k] + np.arange(p)[:, None] * j.S)[real])
        np.testing.assert_array_equal(vals_t.numpy(), j.step_vals[:, k][real])


def _jax_rowpara(a, p, n, cfg, dtype, devices8):
    d = csr_row_partition(a.rowptr, p)
    return d, JaxRowPara(a, d, d, n, mesh=make_mesh_1d(p, devices=devices8),
                         config=JaxConfig(**cfg), dtype=dtype)


# case -> (matrix, config, dtype, the self part's kind)
CASES = {
    "segsum-fp64": (lambda: banded_random_csr(450, nnz_per_row=7, bandwidth=60, seed=28),
                    dict(overlap=1), np.float64, "segsum"),
    "pallas-fp64": (lambda: banded_random_csr(450, nnz_per_row=7, bandwidth=60, seed=28),
                    dict(overlap=1, kernel="pallas"), np.float64, "pallas"),
    "pallas-x3": (lambda: banded_random_csr(900, nnz_per_row=9, bandwidth=80, seed=29,
                                            dtype=np.float32),
                  dict(overlap=1, kernel="pallas", mxu_precision="x3"), np.float32, "pallas"),
    "plaw-fp64": (lambda: powerlaw_random_csr(500, avg_degree=9, seed=29),
                  dict(overlap=1), np.float64, "segsum"),
}


@pytest.mark.parametrize("p", [3, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rowpara_overlap_matches_jax(devices8, case, p):
    gen, cfg, dtype, self_kind = CASES[case]
    a = gen()
    n = 16
    d, j = _jax_rowpara(a, p, n, cfg, dtype, devices8)
    t = RowParaSpmm(a, d, d, n, device="cpu", config=SpmmConfig(**cfg), dtype=dtype)
    assert t.overlap and t.kernel_kind == j.kernel_kind
    assert t.ring.self_kind == j.ring.self_kind == self_kind
    assert t.max_k == j.max_k and t.physical_rows == j.xplan.physical_rows_ring
    assert t.rB_recv_size == j.rB_recv_size
    b = fill_b(0, a.ncol, 0, n, dtype=dtype)
    cj, ct = j.exec(b), t.exec(b)
    assert ct.shape == cj.shape and ct.dtype == cj.dtype
    assert rel_fro_err(cj.astype(np.float64), ct) <= TOL[dtype]
    # the table's physical rows are the ring's; an overlapped exec is one phase
    assert f"= {j.xplan.physical_rows_ring}" in t.print_stat()
    c_timed = t.unshard_c(t.exec_timed(t.shard_b(b)))
    np.testing.assert_array_equal(c_timed, ct)
    assert "a2a" not in t.timer.t and "exec" in t.timer.t


@pytest.mark.parametrize("p", [2, 4])
def test_self_part_falls_back_to_segsum(devices8, monkeypatch, p):
    """Where the self part's kind refuses the sparsity (forced here, on both
    sides, for the ``pallas`` kind), both packages pack it ``segsum``
    (``ring.py:115-121``) and agree on C in fp32."""
    from crp_tpu.kernels import dispatch as jd
    from crp_tpu.kernels.spmm_pallas import UnsupportedSparsity as JaxRefusal

    from crp_tpu_torch.kernels import dispatch as td
    from crp_tpu_torch.kernels.spmm_pallas import UnsupportedSparsity

    for mod, exc in ((jd, JaxRefusal), (td, UnsupportedSparsity)):
        def refuse(shards, max_m, dtype, kind="segsum", *args, _orig=mod.pack_local_kernel,
                   _exc=exc, **kw):
            if kind == "pallas":
                raise _exc("refused for the test")
            return _orig(shards, max_m, dtype, kind, *args, **kw)
        monkeypatch.setattr(mod, "pack_local_kernel", refuse)
    a = banded_random_csr(900, nnz_per_row=9, bandwidth=80, seed=29, dtype=np.float32)
    cfg = dict(overlap=1, kernel="pallas", mxu_precision="x3")
    d, j = _jax_rowpara(a, p, 16, cfg, np.float32, devices8)
    t = RowParaSpmm(a, d, d, 16, device="cpu", config=SpmmConfig(**cfg), dtype=np.float32)
    assert t.ring.self_kind == j.ring.self_kind == "segsum"
    assert t.kernel_kind == j.kernel_kind == "pallas"
    b = fill_b(0, a.ncol, 0, 16, dtype=np.float32)
    assert rel_fro_err(j.exec(b).astype(np.float64), t.exec(b)) <= TOL[np.float32]


def test_ring_spmm_on_stacked_shards(devices8):
    """``ring_spmm`` called directly on the stacked B shards: C equals the
    JAX engine's to 1e-12, and two calls equal bit for bit."""
    a = banded_random_csr(700, nnz_per_row=11, bandwidth=90, seed=31)
    p, n = 4, 12
    d, bd, shards = _shards(a, p)
    _, j = _jax_rowpara(a, p, n, dict(overlap=1), np.float64, devices8)
    max_m = max(s.nrow for s in shards)
    xplan = build_b_exchange([s.colidx for s in shards], bd)
    pack = build_ring_spmm(shards, xplan, bd, max_m, np.float64, device=CPU)
    max_k = max(int(np.diff(bd).max()), pack.min_b_rows)
    b = fill_b(0, a.ncol, 0, n)
    bs = np.zeros((p, max_k, n))
    for i in range(p):
        bs[i, : bd[i + 1] - bd[i]] = b[bd[i]:bd[i + 1]]
    sends = ring_send_tables(xplan, max_k, CPU)
    c1 = ring_spmm(torch.from_numpy(bs), pack, sends)
    c2 = ring_spmm(torch.from_numpy(bs), pack, sends)
    assert c1.shape == (p, max_m, n) and torch.equal(c1, c2)
    got = np.concatenate([c1[i, : d[i + 1] - d[i]].numpy() for i in range(p)])
    assert rel_fro_err(j.exec(b), got) <= 1e-12


@pytest.mark.parametrize("pm,pn", [(4, 2), (3, 2), (2, 4)])
@pytest.mark.parametrize("kernel,dtype", [("segsum", np.float64), ("pallas", np.float32)])
def test_para2d_overlap_matches_jax(devices8, pm, pn, kernel, dtype):
    a = banded_random_csr(400, nnz_per_row=7, bandwidth=45, seed=33, dtype=dtype)
    n = 20
    plan = force_plan(a, n, pm, pn)
    cfg = dict(overlap=1, kernel=kernel, mxu_precision="x3")
    j = JaxPara2d(a, plan, mesh=make_mesh_2d(pm, pn, devices=devices8),
                  config=JaxConfig(**cfg), dtype=dtype)
    t = Para2dSpmm(a, plan, device="cpu", config=SpmmConfig(**cfg), dtype=dtype)
    assert t.kernel_kind == j.kernel_kind and t.ring.self_kind == j.ring.self_kind
    assert (t.rA_cost, t.rB_recv_size) == (j.rA_cost, j.rB_recv_size)
    assert t.physical_rows == j.xplan.physical_rows_ring * pn
    b = fill_b(0, a.ncol, 0, n, dtype=dtype)
    cj, ct = j.exec(b), t.exec(b)
    assert ct.shape == cj.shape and ct.dtype == cj.dtype
    assert rel_fro_err(cj.astype(np.float64), ct) <= TOL[dtype]
    phys = [ln for ln in t.print_stat().splitlines() if ln.startswith("Physical")]
    assert phys == [ln for ln in j.print_stat().splitlines() if ln.startswith("Physical")]


@pytest.mark.parametrize("engine", ["rowpara", "para2d"])
@pytest.mark.parametrize("change,match", [
    (dict(kernel="pallas_halo", overlap=1), "fuses exchange"),
    (dict(kernel="dd", overlap=1), "incompatible with overlap"),
    (dict(kernel="dd_mxu", overlap=1), "incompatible with overlap"),
])
def test_overlap_refusals_are_jax(engine, change, match):
    a = banded_random_csr(300, nnz_per_row=5, bandwidth=20, seed=1)
    with pytest.raises(ValueError, match=match):
        if engine == "rowpara":
            d = csr_row_partition(a.rowptr, 2)
            RowParaSpmm(a, d, d, 8, device="cpu", config=SpmmConfig(**change))
        else:
            Para2dSpmm(a, force_plan(a, 8, 2, 2), device="cpu",
                       config=SpmmConfig(**change))


def test_auto_under_overlap_drops_the_halo():
    from crp_tpu_torch.kernels.dispatch import resolve_auto_kernel

    cuda = torch.device("cuda", 0)
    assert resolve_auto_kernel(cuda, 4, overlap=True) == "pallas"
    assert resolve_auto_kernel(cuda, 4) == "pallas_halo"
    assert resolve_auto_kernel("cpu", 4, overlap=True) == "segsum"
