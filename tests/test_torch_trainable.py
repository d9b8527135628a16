"""The port's ValueParameterizedSpmm (``crp_tpu_torch/engine/trainable.py``)
on the CPU against the JAX package's under ``jax.grad`` on the 8-device CPU
mesh: C, dB, dvals, the standalone SDDMM and its gradients, within 1e-5
(relative Frobenius) of each other; ``auto`` and the refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crp_tpu.config import SpmmConfig as JaxConfig
from crp_tpu.engine.trainable import ValueParameterizedSpmm as JaxVps
from crp_tpu.plan.partition1d import csr_row_partition
from crp_tpu.shard.layout import make_mesh_1d, shard_dense_rows
from crp_tpu.sparse.synth import banded_random_csr, fill_b, powerlaw_random_csr
from crp_tpu.utils.norms import rel_fro_err

from crp_tpu_torch.config import SpmmConfig
from crp_tpu_torch.engine.trainable import ValueParameterizedSpmm

TOL = 1e-5  # port against JAX, fp32, relative Frobenius


def _pair(mk, p, devices8, n=8):
    if mk == "banded":
        a = banded_random_csr(400, nnz_per_row=9, bandwidth=40, seed=30)
    else:
        a = powerlaw_random_csr(400, avg_degree=8, seed=31)
    displs = csr_row_partition(a.rowptr, p)
    j = JaxVps(a, displs, displs, n, mesh=make_mesh_1d(p, devices=devices8),
               dtype=np.float32)
    t = ValueParameterizedSpmm(a, displs, displs, n, device="cpu")
    return a, j, t


def _err(want, got):
    return rel_fro_err(np.asarray(want, np.float64).reshape(1, -1),
                       np.asarray(got).reshape(1, -1))


@pytest.mark.parametrize("mk,p", [("banded", 4), ("plaw", 4), ("plaw", 2), ("banded", 1)])
def test_c_db_and_dvals_match_jax(mk, p, devices8):
    n = 8
    a, j, t = _pair(mk, p, devices8, n)
    b = np.asarray(fill_b(0, a.ncol, 0, n, dtype=np.float32))
    rng = np.random.default_rng(32)
    v = rng.standard_normal(a.nnz).astype(np.float32)
    w = rng.standard_normal((a.nrow, n)).astype(np.float32)

    bj = j.shard_b(b)
    cj = j.op(bj, jnp.asarray(v))
    wj = jnp.asarray(shard_dense_rows(w, j.fwd.A_row_displs, pad_rows=int(cj.shape[1])))
    gbj, gvj = jax.grad(lambda x, vv: jnp.sum(j.op(x, vv) * wj), argnums=(0, 1))(
        bj, jnp.asarray(v))

    bt = t.shard_b(b).requires_grad_(True)
    vt = torch.from_numpy(v).requires_grad_(True)
    ct = t(bt, vt)
    wt = torch.from_numpy(shard_dense_rows(w, t.fwd.A_row_displs, pad_rows=ct.shape[1]))
    (ct * wt).sum().backward()

    assert _err(j.unshard_c(cj), t.unshard_c(ct)) <= TOL
    assert _err(j.unshard_db(gbj), t.unshard_db(bt.grad)) <= TOL
    assert vt.grad.shape == (a.nnz,)
    assert _err(gvj, vt.grad.numpy()) <= TOL
    rows = np.repeat(np.arange(a.nrow), np.diff(a.rowptr))
    dv = np.sum(w.astype(np.float64)[rows] * b.astype(np.float64)[a.colidx], axis=1)
    assert _err(dv, vt.grad.numpy()) <= TOL


@pytest.mark.parametrize("mk,p", [("plaw", 4), ("banded", 1)])
def test_sddmm_and_its_gradients_match_jax(mk, p, devices8):
    """``sddmm(X, Y)`` and, for L = sum(g * sddmm(X, Y)), dX and dY: the
    port's backward runs the engines (dX = A(g) Y, dY = A(g)^T X), JAX
    differentiates its gathers."""
    n = 5
    a, j, t = _pair(mk, p, devices8, n)
    rng = np.random.default_rng(33)
    x = rng.standard_normal((a.nrow, n)).astype(np.float32)
    y = rng.standard_normal((a.ncol, n)).astype(np.float32)
    g = rng.standard_normal(a.nnz).astype(np.float32)
    m_pad = int(j.fwd.max_m)
    xj = jnp.asarray(shard_dense_rows(x, j.fwd.A_row_displs, pad_rows=m_pad))
    yj = j.shard_b(y)
    sj = j.sddmm(xj, yj)
    gxj, gyj = jax.grad(lambda xx, yy: jnp.sum(j.sddmm(xx, yy) * jnp.asarray(g)),
                        argnums=(0, 1))(xj, yj)

    xt = torch.from_numpy(shard_dense_rows(x, t.fwd.A_row_displs,
                                           pad_rows=t.fwd.max_m)).requires_grad_(True)
    yt = t.shard_b(y).requires_grad_(True)
    st = t.sddmm(xt, yt)
    (st * torch.from_numpy(g)).sum().backward()

    rows = np.repeat(np.arange(a.nrow), np.diff(a.rowptr))
    ref = np.sum(x.astype(np.float64)[rows] * y.astype(np.float64)[a.colidx], axis=1)
    assert st.shape == (a.nnz,)
    assert _err(sj, st.detach().numpy()) <= TOL and _err(ref, st.detach().numpy()) <= TOL
    assert xt.grad.shape == xt.shape and yt.grad.shape == yt.shape
    assert _err(np.asarray(gxj)[:, : xt.shape[1]], xt.grad.numpy()) <= TOL
    assert _err(np.asarray(gyj)[:, : yt.shape[1]], yt.grad.numpy()) <= TOL


def test_gradcheck_fp64():
    a = powerlaw_random_csr(100, avg_degree=5, seed=34)
    displs = csr_row_partition(a.rowptr, 3)
    t = ValueParameterizedSpmm(a, displs, displs, 3, device="cpu", dtype=np.float64)
    gen = torch.Generator().manual_seed(35)
    bs = torch.randn(3, t.fwd.max_k, 3, dtype=torch.float64, generator=gen,
                     requires_grad=True)
    xs = torch.randn(3, t.fwd.max_m, 3, dtype=torch.float64, generator=gen,
                     requires_grad=True)
    vals = torch.randn(a.nnz, dtype=torch.float64, generator=gen, requires_grad=True)
    assert torch.autograd.gradcheck(t, (bs, vals))
    assert torch.autograd.gradcheck(t.sddmm, (xs, bs))


def test_auto_resolves_to_segsum():
    a = banded_random_csr(200, nnz_per_row=5, bandwidth=20, seed=36)
    displs = csr_row_partition(a.rowptr, 2)
    t = ValueParameterizedSpmm(a, displs, displs, 8, device="cpu",
                               config=SpmmConfig(kernel="auto"))
    assert t.fwd.kernel_kind == t.bwd.kernel_kind == "segsum"


@pytest.mark.parametrize("cfg", [dict(kernel="pallas"), dict(kernel="gather"),
                                 dict(kernel="dd"), dict(kernel="pallas_halo"),
                                 dict(kernel="segsum", overlap=1),
                                 dict(kernel="segsum", bc_layout=1)])
def test_refusals(cfg, devices8):
    a = banded_random_csr(200, nnz_per_row=5, bandwidth=20, seed=37)
    displs = csr_row_partition(a.rowptr, 2)
    with pytest.raises(ValueError):
        JaxVps(a, displs, displs, 8, mesh=make_mesh_1d(2, devices=devices8),
               config=JaxConfig(**cfg))
    with pytest.raises(ValueError):
        ValueParameterizedSpmm(a, displs, displs, 8, device="cpu",
                               config=SpmmConfig(**cfg))
