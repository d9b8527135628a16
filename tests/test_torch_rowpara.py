"""The slice as a whole: the port's RowParaSpmm on the CPU against the JAX
RowParaSpmm on a one-device CPU mesh, on the same matrix and B."""

import functools
import os

import numpy as np
import pytest
import torch

from crp_tpu.config import SpmmConfig
from crp_tpu.engine.rowpara import RowParaSpmm as JaxRowPara
from crp_tpu.plan.partition1d import csr_row_partition
from crp_tpu.shard.layout import make_mesh_1d
from crp_tpu.sparse.csr import CSRMatrix
from crp_tpu.sparse.synth import (
    banded_random_csr, fill_b, powerlaw_community_csr, powerlaw_random_csr,
)
from crp_tpu.utils.norms import rel_fro_err

from crp_tpu_torch.engine.rowpara import RowParaSpmm
from crp_tpu_torch.kernels import dispatch as td
from crp_tpu_torch.kernels.spmm_pallas import tf32_panels

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
    packed = t.packed  # at highest the TF32 planes, from whose big plane JAX's panels come back
    packed = (*packed[:3], tf32_panels(packed[3:5]), *packed[5:])
    for x, y in zip(packed, j_arrays):
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
    planes = prec == "highest" and dtype == np.float32  # twice the fp32 panels' bytes
    rl = j._local_fn.roofline
    assert t._local_op.roofline == dict(rl, a_bytes=rl["a_bytes"] * (2 if planes else 1))
    cj, ct = j.exec(b), t.exec(b)
    assert ct.shape == (a.nrow, 24) and ct.dtype == dtype
    assert rel_fro_err(cj.astype(np.float64), ct) <= tol
    ref_tol = TOL_REF[prec] if dtype == np.float32 else 1e-12
    assert rel_fro_err(a.spmm_ref(b.astype(np.float64)), ct) <= ref_tol


@pytest.mark.parametrize("change,match", [
    (dict(kernel="pallas_halo", overlap=1), "fuses exchange"),
    (dict(kernel="dd", overlap=1), "incompatible with overlap"),
    (dict(kernel="dd_mxu", bc_layout=1), "BC_layout"),
], ids=["change1-fuses exchange", "change2-incompatible with overlap",
        "change3-BC_layout"])
def test_unported_options_raise(change, match):
    """The dd kinds and ``pallas_halo`` keep the JAX engine's ValueError
    refusals of overlap and bc_layout (``rowpara.py:115-135``); overlap
    and bc_layout themselves are ported (``test_torch_ring.py``,
    ``test_torch_bc_layout.py``)."""
    a = banded_random_csr(300, nnz_per_row=5, bandwidth=20, seed=1)
    displs = csr_row_partition(a.rowptr, 1)
    exc = ValueError
    with pytest.raises(exc, match=match):
        RowParaSpmm(a, displs, displs, 8, device="cpu", config=SpmmConfig(**change))


def test_multi_shard_raises(devices8):
    """p = 2 no longer raises: the port's engine equals the JAX engine on
    two mesh devices (C to 1e-12 in fp64, the same comm volumes)."""
    a = banded_random_csr(300, nnz_per_row=5, bandwidth=20, seed=1)
    displs = csr_row_partition(a.rowptr, 2)
    b = fill_b(0, a.ncol, 0, 8)
    j = JaxRowPara(a, displs, displs, 8, mesh=make_mesh_1d(2, devices=devices8))
    t = RowParaSpmm(a, displs, displs, 8, device="cpu")
    assert (t.kernel_kind, t.rB_recv_size, t.physical_rows) == (
        j.kernel_kind, j.rB_recv_size, j.xplan.physical_rows_ring)
    assert rel_fro_err(j.exec(b), t.exec(b)) <= 1e-12


def _scrambled(dtype=np.float32):
    """A power-law graph with its ids scrambled: the ragged cover of every
    shard's compacted columns keeps under 30% of the nonzeros."""
    return powerlaw_community_csr(30000, 4, 1024, seed=3, permute=True, dtype=dtype)


# kernel -> (matrix, config, dtype, the local op's variant, C tolerance
# against the JAX engine: the same products summed in another order)
MULTI = {
    "segsum": (lambda: banded_random_csr(2400, 7, 60, seed=21),
               dict(kernel="segsum"), np.float64, "segsum", 1e-12),
    "window": (lambda: banded_random_csr(2400, 7, 60, seed=22, dtype=np.float32),
               dict(kernel="pallas", mxu_precision="x3"), np.float32, "window", 1e-6),
    "ragged": (lambda: powerlaw_community_csr(60000, 12, 1024, seed=23, dtype=np.float32),
               dict(kernel="pallas", mxu_precision="x3"), np.float32, "ragged", 1e-6),
    "gather": (_scrambled, dict(kernel="ragged", mxu_precision="highest"),
               np.float32, "gather", 1e-6),
    "ell": (lambda: banded_random_csr(2400, 7, 60, seed=24, dtype=np.float32),
            dict(kernel="ell"), np.float32, "ell", 1e-6),
    "dd": (lambda: banded_random_csr(2400, 7, 60, seed=25),
           dict(kernel="dd"), np.float64, "ell", 1e-12),
}


@functools.lru_cache(maxsize=None)
def _jax_multi(kernel, p):
    """The JAX engine's decisions and C on p mesh devices, with the TPU's
    fallback chain for the gather case (``CRP_TPU_FALLBACK``); B is the
    reference's analytic fill."""
    import jax

    gen, cfg, dtype, _, _ = MULTI[kernel]
    a = gen()
    displs = csr_row_partition(a.rowptr, p)
    mesh = make_mesh_1d(p, devices=jax.devices()[:p])
    old = os.environ.get("CRP_TPU_FALLBACK")
    if kernel == "gather":
        os.environ["CRP_TPU_FALLBACK"] = "gather,segsum"
    try:
        j = JaxRowPara(a, displs, displs, 24, mesh=mesh, config=SpmmConfig(**cfg),
                       dtype=dtype)
    finally:
        os.environ.pop("CRP_TPU_FALLBACK", None)
        if old is not None:
            os.environ["CRP_TPU_FALLBACK"] = old
    b = fill_b(0, a.ncol, 0, 24, dtype=dtype)
    return a, displs, b, j.exec(b), dict(
        kind=j.kernel_kind, variant=getattr(j._local_fn, "variant", None),
        recv=j.rB_recv_size, a2a=j.xplan.physical_rows,
        ring=j.xplan.physical_rows_ring,
    )


@pytest.mark.parametrize("rb_p2p", [0, 1], ids=["a2a", "ring"])
@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("kernel", sorted(MULTI))
def test_multi_shard_matches_jax(devices8, monkeypatch, kernel, p, rb_p2p):
    """RowParaSpmm at p > 1 against the JAX engine on the CPU mesh: the same
    kind, the same received rows and physical rows, and the same C.  The
    gather case walks the TPU's chain on both sides (JAX's
    ``CRP_TPU_FALLBACK``; the port's chain, patched to that list)."""
    _, cfg, dtype, variant, tol = MULTI[kernel]
    a, displs, b, cj, jx = _jax_multi(kernel, p)
    if kernel == "gather":
        monkeypatch.setattr(td, "sparsity_fallback_chain",
                            lambda *args, **kw: ["gather", "segsum"])
    t = RowParaSpmm(a, displs, displs, 24, device="cpu", dtype=dtype,
                    config=SpmmConfig(rb_p2p=rb_p2p, **cfg))
    assert t.kernel_kind == jx["kind"] and not t._identity_exchange
    assert t._local_op.variant == variant
    if jx["variant"] is not None:  # the JAX uniform and plain ops carry none
        assert jx["variant"] == variant
    if kernel == "ragged":
        assert t._local_op.roofline["spill_nnz"] > 0
    assert t.rB_recv_size == jx["recv"]
    assert t.physical_rows == jx["ring" if rb_p2p else "a2a"]
    ct = t.exec(b)
    assert ct.shape == cj.shape and ct.dtype == cj.dtype
    assert rel_fro_err(cj.astype(np.float64), ct) <= tol
    c_timed = t.unshard_c(t.exec_timed(t.shard_b(b)))
    np.testing.assert_array_equal(c_timed, ct)
    assert {"a2a", "spmm"} <= set(t.timer.t)


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


def test_default_device_is_the_card():
    """The engines run on the card unless the caller asks for the CPU; with
    no card the default raises rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    a = banded_random_csr(300, nnz_per_row=5, bandwidth=20, seed=1)
    displs = csr_row_partition(a.rowptr, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RowParaSpmm(a, displs, displs, 8)


@pytest.mark.parametrize("extra", [0, 300])
def test_receive_buffer_is_what_the_kernel_reads(extra):
    """``receive_buffer``: B's shards themselves under the identity
    exchange, else the referenced rows compacted in ``rowmap`` order; the
    local ops on it give the engine's C."""
    a = _with_unreferenced_columns(extra)
    b = fill_b(0, a.ncol, 0, 24, dtype=np.float32)
    displs = csr_row_partition(a.rowptr, 1)
    t = RowParaSpmm(a, displs, displs, 24, device="cpu",
                    config=SpmmConfig(kernel="pallas", mxu_precision="x3"),
                    dtype=np.float32)
    bs = t.shard_b(b)
    rb = t.receive_buffer(bs)
    assert t._identity_exchange == (extra == 0) and (rb is bs) == (extra == 0)
    rows = np.asarray(t.xplan.rowmap[0])
    np.testing.assert_array_equal(rb[0, : rows.size].numpy(), b[rows])
    np.testing.assert_array_equal(t._spmm(rb).numpy(), t(bs).numpy())
