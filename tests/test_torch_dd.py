"""The port's fp64 class (``dd``, ``dd_mxu``) and ``ell`` kinds against the
JAX package on the CPU: the ELL op, the dd_mxu total cover and its
refusals, JAX's slice planes rebuilt into fp64 panels, the plain dd_mxu op
against the Pallas kernel in interpret mode, the dd tiers and the engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crp_tpu.config import SpmmConfig
from crp_tpu.engine.rowpara import RowParaSpmm as JaxRowPara
from crp_tpu.kernels import dispatch as jd
from crp_tpu.kernels import spmm_ell as je
from crp_tpu.kernels.spmm_dd import pack_b_dd, unpack_c_dd
from crp_tpu.kernels.spmm_dd_mxu import pack_ragged_dd, spmm_ragged_dd
from crp_tpu.kernels.spmm_pallas import UnsupportedSparsity as JaxUnsupported
from crp_tpu.plan.partition1d import csr_row_partition
from crp_tpu.shard.layout import make_mesh_1d
from crp_tpu.sparse.synth import (
    banded_random_csr, fill_b, powerlaw_community_csr, powerlaw_random_csr,
)
from crp_tpu.utils.norms import rel_fro_err

from crp_tpu_torch.engine.rowpara import RowParaSpmm
from crp_tpu_torch.kernels import dispatch as td
from crp_tpu_torch.kernels import spmm_dd_mxu as tdm
from crp_tpu_torch.kernels import spmm_ell as te
from crp_tpu_torch.kernels.spmm_pallas import UnsupportedSparsity

CPU = torch.device("cpu")
# the two matrices of tests/test_dd_mxu.py:84-105
DD_MATS = {
    "banded": lambda: banded_random_csr(1500, nnz_per_row=7, bandwidth=120, seed=7),
    "cplaw": lambda: powerlaw_community_csr(1536, avg_degree=9, comm_size=256, seed=3),
}


def _shard(a):
    return [(a.rowptr, a.colidx.astype(np.int32), a.val)]


@pytest.fixture
def no_knobs(monkeypatch):
    for k in ("CRP_TPU_RAGGED_WC", "CRP_TPU_RAGGED_TM", "CRP_TPU_RAGGED_PANEL_GB",
              "CRP_TPU_DD_NO_MXU", "CRP_TPU_DD_SEGSUM_MAX_NNZ", "CRP_TPU_FALLBACK"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


# ---------------------------------------------------------------------- ell


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-6)])
def test_ell_matches_jax(dtype, tol):
    """The ``ell`` kind: the same (cols, vals) pack as JAX's, and the slot
    scan within 1e-12 of ``spmm_ell`` in fp64 (1e-6 in fp32)."""
    a = powerlaw_random_csr(700, avg_degree=9, seed=5, dtype=dtype)
    j_arrays, j_fn = jd.pack_local_kernel(_shard(a), a.nrow + 50, dtype, "ell")
    t_arrays, op = td.pack_local_kernel(_shard(a), a.nrow + 50, dtype, "ell",
                                        device="cpu")
    for t, j in zip(t_arrays, j_arrays):
        assert t.numpy().dtype == j.dtype
        np.testing.assert_array_equal(t.numpy(), j)
    b = fill_b(0, a.ncol, 0, 24, dtype=dtype)
    want = np.asarray(je.spmm_ell(jnp.asarray(j_arrays[0][0]), jnp.asarray(j_arrays[1][0]),
                                  jnp.asarray(b)))
    got = op(tuple(x[0] for x in t_arrays), torch.from_numpy(b)).numpy()
    assert got.dtype == dtype and got.shape == (a.nrow + 50, 24)
    assert rel_fro_err(want.astype(np.float64), got) <= tol
    assert rel_fro_err(a.spmm_ref(b.astype(np.float64)), got[: a.nrow]) <= tol
    cols, vals = te.pack_ell(a.rowptr, a.colidx, a.val, a.nrow, col_pad=3)
    np.testing.assert_array_equal(cols, je.pack_ell(a.rowptr, a.colidx, a.val, a.nrow,
                                                    col_pad=3)[0])
    with pytest.raises(ValueError, match="slots"):
        te.pack_ell(a.rowptr, a.colidx, a.val, a.nrow, L=1)


# ------------------------------------------------------------------ dd_mxu


@pytest.mark.parametrize("gen", sorted(DD_MATS))
def test_dd_mxu_cover_matches_jax(no_knobs, gen):
    """The port's dd_mxu pack on the CPU has the cover arrays (step_g,
    step_first, starts) of JAX's ``_pack_dd_mxu`` off the TPU, bit for bit,
    at the same clamped geometry (Wc = 256), and its roofline's shape."""
    a = DD_MATS[gen]()
    (j_g, j_first, j_starts, _, _), j_fn = jd._pack_dd_mxu(_shard(a), a.nrow + 200)
    t_arrays, op = td._pack_dd_mxu(_shard(a), a.nrow + 200, CPU)
    for t, j in zip(t_arrays[:3], (j_g, j_first, j_starts)):
        assert t.numpy().dtype == j.dtype
        np.testing.assert_array_equal(t.numpy(), j)
    assert op.variant == j_fn.variant == "dd_mxu"
    assert op.min_b_rows == j_fn.min_b_rows
    for key in ("G", "TM", "W", "S", "b_rows_read", "c_rows", "b_itemsize",
                "spill_nnz", "mxu_frac"):
        assert op.roofline[key] == j_fn.roofline[key], key
    assert t_arrays[3].dtype == torch.float64 and t_arrays[3].shape[1:] == (
        op.roofline["S"], 128, 256)


def test_dd_mxu_geometry_matches_jax(no_knobs):
    """Wc of the dd_mxu pack: 512 as on the TPU, 256 on the CPU (the JAX
    interpret clamp), never over 1024 (after ``tests/test_dd_mxu.py:159``)."""
    a = banded_random_csr(256, nnz_per_row=5, bandwidth=30, seed=3)
    no_knobs.setattr(jax, "default_backend", lambda: "tpu")
    assert jd._pack_dd_mxu(_shard(a), 256)[1].roofline["W"] == \
        tdm.dd_mxu_geometry(small=False)[1] == 512
    no_knobs.setenv("CRP_TPU_RAGGED_WC", "2048")
    assert jd._pack_dd_mxu(_shard(a), 256)[1].roofline["W"] == 1024
    no_knobs.setattr(tdm, "ragged_params", lambda: (128, 2048))
    assert tdm.dd_mxu_geometry(small=False) == (128, 1024)
    assert tdm.dd_mxu_geometry(small=True) == (128, 256)


@pytest.mark.parametrize("gen", sorted(DD_MATS))
def test_dd_mxu_refusals_match_jax(gen):
    """Under a panel cap, the port's dd_mxu pack refuses where JAX's
    ``pack_ragged_dd`` does: a cap that forces a spill, and one that the
    fp64 panels fit but the JAX slice planes do not."""
    a = DD_MATS[gen]()
    TM, Wc = 128, 256
    G = -(-a.nrow // TM)
    S = len(tdm.ragged_dd_cover(a.rowptr, a.colidx, TM, Wc, G)[0])
    panel = S * TM * Wc
    for cap, refused in ((panel * 18, False), (panel * 17, True),
                         (panel * 16 - 2, True), (panel * 4, True)):
        try:
            pack_ragged_dd(a.rowptr, a.colidx, a.val, a.ncol, TM=TM, Wc=Wc,
                           max_panel_bytes=cap)
            jax_refused = False
        except JaxUnsupported:
            jax_refused = True
        try:
            td._pack_dd_mxu(_shard(a), a.nrow, CPU, max_panel_bytes=cap)
            port_refused = False
        except UnsupportedSparsity:
            port_refused = True
        assert (port_refused, jax_refused) == (refused, refused), cap


@pytest.mark.parametrize("gen", sorted(DD_MATS))
def test_jax_slice_planes_rebuild_the_panels(no_knobs, gen):
    """``local_op_from_jax_pack(variant="dd_mxu")`` rebuilds JAX's 7 slice
    planes into fp64 panels within 2**-49 of each row's scale of the port's
    own panels (the slices keep 49 bits), with the same step arrays."""
    a = DD_MATS[gen]()
    j_arrays, j_fn = jd._pack_dd_mxu(_shard(a), a.nrow)
    t_arrays, op = td._pack_dd_mxu(_shard(a), a.nrow, CPU)
    arrays = [np.asarray(x) for x in j_arrays]
    arrays[4] = arrays[4].view(np.uint16)  # bf16 bits
    c_arrays, c_op = td.local_op_from_jax_pack(arrays, j_fn.min_b_rows, device="cpu",
                                               roofline=j_fn.roofline,
                                               variant="dd_mxu")
    assert c_op.variant == "dd_mxu" and c_op.roofline["passes"] == 1
    for i in (0, 1, 2, 4):
        np.testing.assert_array_equal(c_arrays[i].numpy(), t_arrays[i].numpy())
    mu = arrays[3].astype(np.float64)[..., None]
    err = np.abs(c_arrays[3].numpy() - t_arrays[3].numpy())
    assert float((err / mu).max()) <= 2.0 ** -49
    b = np.random.default_rng(0).standard_normal((op.min_b_rows, 40))
    got = c_op(tuple(x[0] for x in c_arrays), torch.from_numpy(b)).numpy()
    assert rel_fro_err(a.spmm_ref(b[: a.ncol]), got[: a.nrow]) <= 1e-13


@pytest.mark.parametrize("gen", sorted(DD_MATS))
def test_dd_mxu_plain_matches_pallas_and_ref(no_knobs, gen):
    """The port's dd_mxu op (its plain version on the CPU) within 1e-13 of
    JAX's ``spmm_ragged_dd`` in interpret mode and of ``spmm_ref``
    (``tests/test_dd_mxu.py:84-105``)."""
    a = DD_MATS[gen]()
    t_arrays, op = td._pack_dd_mxu(_shard(a), a.nrow, CPU)
    b = np.random.default_rng(0).standard_normal((a.ncol, 40))
    rb = np.pad(b, ((0, max(0, op.min_b_rows - a.ncol)), (0, 0)))
    got = op(tuple(x[0] for x in t_arrays), torch.from_numpy(rb)).numpy()[: a.nrow]
    rw, mu, slices = pack_ragged_dd(a.rowptr, a.colidx, a.val, a.ncol, TM=128, Wc=256)
    c_packed = spmm_ragged_dd(
        rw.step_g, rw.step_first, rw.starts, mu, slices,
        jnp.asarray(np.asarray(pack_b_dd(rb), np.float32)),
        G=rw.G, TM=rw.TM, Wc=rw.Wc, TN=128, interpret=True,
    )
    want = unpack_c_dd(np.asarray(c_packed))[: a.nrow]
    assert rel_fro_err(want, got) <= 1e-13
    assert rel_fro_err(a.spmm_ref(b), got) <= 1e-13


# ---------------------------------------------------------------------- dd


def _hub_matrix():
    """Power-law rows with one hub row over 128 nonzeros: JAX's segmented
    scan tier."""
    a = powerlaw_random_csr(900, avg_degree=9, seed=8)
    assert int(np.diff(a.rowptr).max()) > 128
    return a


@pytest.mark.parametrize("gen,tier", [
    (lambda: banded_random_csr(800, nnz_per_row=9, bandwidth=40, seed=9), "ell"),
    (_hub_matrix, "segsum"),
])
def test_dd_tier_matches_jax(no_knobs, gen, tier):
    """kind="dd" on the CPU takes the non-MXU tier JAX takes off the TPU:
    ELL for at most 128 nonzeros per row, the segment sum above; both
    within 1e-12 of JAX's double-float result and of ``spmm_ref``."""
    a = gen()
    j_arrays, j_fn = jd.pack_local_kernel(_shard(a), a.nrow, np.float64, "dd")
    t_arrays, op = td.pack_local_kernel(_shard(a), a.nrow, np.float64, "dd",
                                        device="cpu")
    assert op.variant == tier == ("ell" if len(j_arrays) == 3 else "segsum")
    b = np.random.default_rng(2).standard_normal((a.ncol, 16))
    got = op(tuple(x[0] for x in t_arrays), torch.from_numpy(b)).numpy()
    want = unpack_c_dd(np.asarray(j_fn(tuple(jnp.asarray(x[0]) for x in j_arrays),
                                       jnp.asarray(pack_b_dd(b)))))
    assert got.dtype == np.float64
    assert rel_fro_err(want, got) <= 1e-12
    assert rel_fro_err(a.spmm_ref(b), got) <= 1e-12
    with pytest.raises(ValueError, match="fp64"):
        op(tuple(x[0] for x in t_arrays), torch.from_numpy(b.astype(np.float32)))


def test_dd_segsum_has_no_nnz_cap(no_knobs):
    """A shard over 4M nonzeros with a row past 128: JAX refuses its
    segmented scan (``CRP_TPU_DD_SEGSUM_MAX_NNZ``); the port, which chunks
    its sum and compiles nothing, packs it (a documented difference)."""
    nrow, per = 30000, 140
    rowptr = np.arange(nrow + 1, dtype=np.int64) * per
    cols = np.random.default_rng(0).integers(0, nrow, nrow * per).astype(np.int32)
    shard = [(rowptr, cols, np.ones(nrow * per))]
    with pytest.raises(JaxUnsupported, match="CRP_TPU_DD_SEGSUM_MAX_NNZ"):
        jd.pack_local_kernel(shard, nrow, np.float64, "dd")
    arrays, op = td.pack_local_kernel(shard, nrow, np.float64, "dd", device="cpu")
    assert op.variant == "segsum" and arrays[0].shape == (1, nrow * per)
    assert arrays[2].dtype == torch.float64


@pytest.mark.parametrize("kernel,variant", [("dd", "ell"), ("dd_mxu", "dd_mxu")])
def test_rowpara_dd_matches_jax(no_knobs, kernel, variant):
    """``RowParaSpmm(kernel="dd" / "dd_mxu")`` on the CPU (after
    ``tests/test_dd_mxu.py:108-130``): the JAX engine's kind, fp64 C from
    an fp32 engine dtype, within 1e-12 of JAX's result and of
    ``spmm_ref``; ``dd`` takes the non-MXU tier here."""
    a = banded_random_csr(3000, nnz_per_row=9, bandwidth=150, seed=7)
    displs = csr_row_partition(a.rowptr, 1)
    cfg = SpmmConfig(kernel=kernel)
    j = JaxRowPara(a, displs, displs, 24, mesh=make_mesh_1d(1), config=cfg)
    t = RowParaSpmm(a, displs, displs, 24, device="cpu", config=cfg, dtype=np.float32)
    assert t.kernel_kind == j.kernel_kind == kernel and t.is_dd and j.is_dd
    assert t._local_op.variant == variant
    b = np.random.default_rng(0).standard_normal((a.ncol, 24))
    ct = t.exec(b)
    assert ct.dtype == np.float64
    assert rel_fro_err(j.exec(b), ct) <= 1e-12
    assert rel_fro_err(a.spmm_ref(b), ct) <= 1e-12
