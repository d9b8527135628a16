"""The port's DifferentiableSpmm (``crp_tpu_torch/engine/autodiff.py``) on
the CPU against the JAX package's on the 8-device CPU mesh: C and dB on the
same matrices and inputs, within 1e-5 (relative Frobenius) of each other;
the backward against finite differences in fp64; ``auto`` and the
refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crp_tpu.config import SpmmConfig as JaxConfig
from crp_tpu.engine.autodiff import DifferentiableSpmm as JaxDiff
from crp_tpu.plan.partition1d import csr_row_partition
from crp_tpu.shard.layout import make_mesh_1d, shard_dense_rows
from crp_tpu.sparse.synth import banded_random_csr, fill_b, powerlaw_random_csr
from crp_tpu.utils.norms import rel_fro_err

from crp_tpu_torch.config import SpmmConfig
from crp_tpu_torch.engine import autodiff
from crp_tpu_torch.engine.autodiff import DifferentiableSpmm, transposed
from crp_tpu_torch.kernels.dispatch import resolve_auto_kernel

TOL = 1e-5  # port against JAX, fp32, relative Frobenius


def _matrix(mk):
    """The matrices of ``tests/test_autodiff.py:33-63``."""
    if mk == "banded":
        return banded_random_csr(500, nnz_per_row=9, bandwidth=40, seed=20)
    return powerlaw_random_csr(500, avg_degree=8, seed=21)


def _c_and_db_torch(ds, b, w):
    bs = ds.shard_b(b).requires_grad_(True)
    cs = ds(bs)
    ws = torch.from_numpy(shard_dense_rows(w, ds.fwd.A_row_displs, pad_rows=cs.shape[1]))
    (cs * ws).sum().backward()
    return ds.unshard_c(cs), ds.unshard_db(bs.grad)


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("mk", ["banded", "plaw"])
def test_c_and_db_match_jax(mk, p, devices8):
    a = _matrix(mk)
    n = 8
    displs = csr_row_partition(a.rowptr, p)
    j = JaxDiff(a, displs, displs, n, mesh=make_mesh_1d(p, devices=devices8),
                config=JaxConfig(kernel="segsum"), dtype=np.float32)
    t = DifferentiableSpmm(a, displs, displs, n, device="cpu",
                           config=SpmmConfig(kernel="segsum"))
    b = np.asarray(fill_b(0, a.ncol, 0, n, dtype=np.float32))
    w = np.random.default_rng(22).standard_normal((a.nrow, n)).astype(np.float32)

    bs = j.shard_b(b)
    cj = j.op(bs)
    wj = jnp.asarray(shard_dense_rows(w, j.fwd.A_row_displs, pad_rows=int(cj.shape[1])))
    dbj = j.unshard_db(jax.grad(lambda x: jnp.sum(j.op(x) * wj))(bs))
    ct, dbt = _c_and_db_torch(t, b, w)

    assert ct.shape == (a.nrow, n) and dbt.shape == dbj.shape == (a.ncol, n)
    assert rel_fro_err(j.unshard_c(cj).astype(np.float64), ct) <= TOL
    assert rel_fro_err(dbj.astype(np.float64), dbt) <= TOL
    dense = a.to_dense().astype(np.float64)
    assert rel_fro_err(dense @ b, ct) <= TOL
    assert rel_fro_err(dense.T @ w, dbt) <= TOL


def test_pallas_kind_matches_jax_segsum(devices8):
    """One small ``pallas`` case: the windowed pack's plain version, forward
    and backward, against JAX's segsum op (p = 2)."""
    a = banded_random_csr(300, nnz_per_row=7, bandwidth=30, seed=23)
    n, p = 8, 2
    displs = csr_row_partition(a.rowptr, p)
    j = JaxDiff(a, displs, displs, n, mesh=make_mesh_1d(p, devices=devices8),
                config=JaxConfig(kernel="segsum"), dtype=np.float32)
    t = DifferentiableSpmm(a, displs, displs, n, device="cpu",
                           config=SpmmConfig(kernel="pallas"))
    assert t.fwd.kernel_kind == t.bwd.kernel_kind == "pallas"
    b = np.asarray(fill_b(0, a.ncol, 0, n, dtype=np.float32))
    w = np.random.default_rng(24).standard_normal((a.nrow, n)).astype(np.float32)
    bs = j.shard_b(b)
    cj = j.op(bs)
    wj = jnp.asarray(shard_dense_rows(w, j.fwd.A_row_displs, pad_rows=int(cj.shape[1])))
    dbj = j.unshard_db(jax.grad(lambda x: jnp.sum(j.op(x) * wj))(bs))
    ct, dbt = _c_and_db_torch(t, b, w)
    assert rel_fro_err(j.unshard_c(cj).astype(np.float64), ct) <= TOL
    assert rel_fro_err(dbj.astype(np.float64), dbt) <= TOL


@pytest.mark.parametrize("p", [1, 3])
def test_gradcheck_fp64(p):
    a = powerlaw_random_csr(120, avg_degree=5, seed=25)
    displs = csr_row_partition(a.rowptr, p)
    ds = DifferentiableSpmm(a, displs, displs, 3, device="cpu",
                            config=SpmmConfig(kernel="segsum"), dtype=np.float64)
    bs = torch.randn(p, ds.fwd.max_k, 3, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(26), requires_grad=True)
    assert torch.autograd.gradcheck(ds, (bs,))


def test_auto_resolves_to_pallas_without_halo(monkeypatch):
    """``auto`` on a CUDA device object (logic only, the engines stubbed):
    the op's engines take ``pallas`` at every p, never ``pallas_halo``;
    the CPU takes ``segsum``."""
    cuda = torch.device("cuda", 0)
    assert resolve_auto_kernel(cuda, 4, allow_halo=False) == "pallas"
    assert resolve_auto_kernel(cuda, 4) == "pallas_halo"
    assert resolve_auto_kernel(cuda, 1, allow_halo=False) == "pallas"
    assert resolve_auto_kernel("cpu", 4, allow_halo=False) == "segsum"

    seen = []

    class Engine(torch.nn.Module):
        def __init__(self, a, A_row_displs, B_row_displs, glb_n, *, device, config,
                     dtype, mesh):
            super().__init__()
            assert mesh is None
            seen.append((torch.device(device), config.kernel))
            self.A_row_displs, self.B_row_displs = A_row_displs, B_row_displs

    monkeypatch.setattr(autodiff, "RowParaSpmm", Engine)
    monkeypatch.setattr(autodiff, "engine_device", torch.device)
    a = banded_random_csr(200, nnz_per_row=5, bandwidth=20, seed=27)
    for p in (1, 4):
        displs = csr_row_partition(a.rowptr, p)
        DifferentiableSpmm(a, displs, displs, 8, device=cuda,
                           config=SpmmConfig(kernel="auto"))
    assert seen == [(cuda, "pallas")] * 4


@pytest.mark.parametrize("kernel,bc", [("dd", 0), ("dd_mxu", 0), ("pallas_halo", 0),
                                       ("segsum", 1)])
def test_refusals(kernel, bc):
    a = banded_random_csr(200, nnz_per_row=5, bandwidth=20, seed=24)
    displs = csr_row_partition(a.rowptr, 2)
    with pytest.raises(ValueError):
        DifferentiableSpmm(a, displs, displs, 8, device="cpu",
                           config=SpmmConfig(kernel=kernel, bc_layout=bc))


def test_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    a = banded_random_csr(100, nnz_per_row=5, bandwidth=20, seed=28)
    displs = csr_row_partition(a.rowptr, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DifferentiableSpmm(a, displs, displs, 8, config=SpmmConfig(kernel="auto"))


def test_ops_share_one_transpose_and_its_pack():
    """Two widths over one matrix: one memoized ``A^T``, whose pack the
    second op's backward engine takes from the memo (no pack phase)."""
    a = powerlaw_random_csr(300, avg_degree=6, seed=29)
    displs = csr_row_partition(a.rowptr, 2)
    ops = [DifferentiableSpmm(a, displs, displs, n, device="cpu",
                              config=SpmmConfig(kernel="pallas")) for n in (8, 32)]
    assert transposed(a) is transposed(a)
    assert "pack" not in ops[1].bwd._t_build.t
    assert all(x is y for x, y in zip(ops[0].bwd.packed, ops[1].bwd.packed))
    at = transposed(a)
    assert np.array_equal(at.to_dense(), a.to_dense().T)
