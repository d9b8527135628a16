"""The port on a CUDA card: each kernel against its plain version, and the
engine on the card against the engine on the CPU.

Every case skips without a CUDA device: the kernels have no CPU mode.
This file imports no jax, which the GPU machine does not have; run it
there without the repository's conftest (which re-execs onto a JAX CPU
mesh):

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from crp_tpu.config import SpmmConfig
from crp_tpu.plan.partition1d import csr_row_partition
from crp_tpu.sparse.csr import CSRMatrix
from crp_tpu.sparse.synth import (
    banded_random_csr, fill_b, powerlaw_community_csr, powerlaw_random_csr,
)
from crp_tpu.utils.norms import rel_fro_err

from crp_tpu_torch.engine.rowpara import RowParaSpmm
from crp_tpu_torch.kernels import spmm_dd_mxu, spmm_ragged
from crp_tpu_torch.kernels.dispatch import (
    _pack_dd_mxu, _pack_gather, _pack_ragged, pack_local_kernel,
)

# (mxu_precision, dtype, bound vs the fp64 reference)
POINTS = [
    ("x3", np.float32, 1e-5),
    ("default", np.float32, 5e-3),
    ("highest", np.float32, 1e-6),
    ("highest", np.float64, 1e-12),
]
# kernel vs plain, max|k - p| / max|p|: the same exact products summed in
# another order (small packs; chip_smoke.py holds the headline shape)
TOL_PLAIN = {np.float32: 1e-6, np.float64: 1e-12}
# ragged kernel vs plain, relative Frobenius: a power-law hub row sums
# thousands of rounded fp32 products, whose reordering moves the largest
# elements by up to 1.2e-6 of max|p| (measured, H100), so the elementwise
# maximum is no bound there; the Frobenius error stays near 3e-7
TOL_PLAIN_FRO = {np.float32: 1e-6, np.float64: 1e-12}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _b(a, rows, n, dtype):
    b = np.zeros((rows, n), dtype)
    b[: a.ncol] = fill_b(0, a.ncol, 0, n, dtype=dtype)
    return b


@pytest.mark.parametrize("n", [16, 48, 100, 256])
@pytest.mark.parametrize("prec,dtype,tol_ref", POINTS)
def test_kernel_matches_plain(cuda_device, prec, dtype, tol_ref, n):
    a = banded_random_csr(3000, nnz_per_row=7, bandwidth=80, seed=91, dtype=dtype)
    arrays, op = pack_local_kernel([(a.rowptr, a.colidx.astype(np.int32), a.val)],
                                   a.nrow + 300, dtype, "pallas",
                                   device=cuda_device, mxu_precision=prec)
    rB = torch.from_numpy(_b(a, op.min_b_rows, n, dtype)).to(cuda_device)
    args = op.kernel_args(tuple(x[0] for x in arrays), rB)
    before = op.kernel.launches
    k = op.kernel(*args, min_b_rows=op.min_b_rows)
    assert op.kernel.launches == before + 1
    p = op.plain(*args)
    assert float((k - p).abs().max() / p.abs().max()) <= TOL_PLAIN[dtype]
    assert not torch.any(k[a.nrow:])  # pad groups come out zero
    ref = a.spmm_ref(fill_b(0, a.ncol, 0, n, dtype=np.float64))
    assert rel_fro_err(ref, k[: a.nrow].double().cpu().numpy()) <= tol_ref


def test_kernel_refuses_short_b(cuda_device):
    a = banded_random_csr(1000, nnz_per_row=5, bandwidth=40, seed=1,
                          dtype=np.float32)
    arrays, op = pack_local_kernel([(a.rowptr, a.colidx.astype(np.int32), a.val)],
                                   a.nrow, np.float32, "pallas",
                                   device=cuda_device, mxu_precision="x3")
    rB = torch.zeros((op.min_b_rows - 1, 8), device=cuda_device)
    with pytest.raises(ValueError, match="min_b_rows"):
        op(tuple(x[0] for x in arrays), rB)


@pytest.mark.parametrize("prec", ["x3", "default", "highest"])
def test_engine_on_card_matches_engine_on_cpu(cuda_device, prec):
    a = banded_random_csr(2000, nnz_per_row=7, bandwidth=80, seed=5,
                          dtype=np.float32)
    displs = csr_row_partition(a.rowptr, 1)
    b = fill_b(0, a.ncol, 0, 48, dtype=np.float32)
    cfg = SpmmConfig(kernel="auto", mxu_precision=prec)
    gpu = RowParaSpmm(a, displs, displs, 48, device=cuda_device, config=cfg,
                      dtype=np.float32)
    a.__dict__.pop("_torch_pack_cache", None)
    cpu = RowParaSpmm(a, displs, displs, 48, device="cpu",
                      config=SpmmConfig(kernel="pallas", mxu_precision=prec),
                      dtype=np.float32)
    assert gpu.kernel_kind == cpu.kernel_kind == "pallas"
    kernel = gpu._local_op.kernel
    before = kernel.launches
    c_gpu = gpu.exec(b)
    assert kernel.launches == before + 1
    assert rel_fro_err(cpu.exec(b).astype(np.float64), c_gpu) <= 1e-6


@pytest.mark.parametrize("TM", [128, 256, 512])
@pytest.mark.parametrize("Wc", [128, 256, 512])
@pytest.mark.parametrize("prec,dtype,tol_ref", POINTS)
def test_ragged_kernel_matches_plain(cuda_device, prec, dtype, tol_ref, TM, Wc):
    a = powerlaw_random_csr(3000, avg_degree=12, seed=3, dtype=dtype)
    # max_m past nrow: pad groups own dummy chunks and come out zero
    arrays, op = _pack_ragged([(a.rowptr, a.colidx.astype(np.int32), a.val)],
                              a.nrow + 600, dtype, prec, cuda_device,
                              geometry=(TM, Wc), min_chunk_nnz=12)
    arrs = tuple(x[0] for x in arrays)
    for n in (16, 48, 100, 256):
        rB = torch.from_numpy(_b(a, op.min_b_rows, n, dtype)).to(cuda_device)
        args = op.kernel_args(arrs, rB)
        before = op.kernel.launches
        k = op.kernel(*args, min_b_rows=op.min_b_rows)
        assert op.kernel.launches == before + 1
        p = op.plain(*args)
        assert k.shape == p.shape == (op.roofline["G"] * TM, n)
        assert float((k - p).double().norm() / p.double().norm()) <= TOL_PLAIN_FRO[dtype]
        assert not torch.any(k[a.nrow:])  # pad groups come out zero
        c = op(arrs, rB)  # with the spill: the whole product
        ref = a.spmm_ref(fill_b(0, a.ncol, 0, n, dtype=np.float64))
        assert rel_fro_err(ref, c[: a.nrow].double().cpu().numpy()) <= tol_ref


def _spill_case(rng, M, TMo, Q, z, ncol):
    """Spilled nonzeros in blocks 0-2 of an M-row output (the rest dummy),
    sorted by block, with more than Q in some block (multi-step)."""
    rows = np.sort(rng.integers(0, min(M, 3 * TMo), z)).astype(np.int32)
    cols = rng.integers(1, ncol, z).astype(np.int32)
    vals = rng.standard_normal(z).astype(np.float32)
    counts = np.bincount(rows // TMo, minlength=M // TMo)
    ns = int(np.maximum(-(-counts // Q), 1).sum())
    return spmm_ragged.pack_spill_blocks((rows, cols, vals), ns + 2, M,
                                         np.float32, TMo=TMo, Q=Q)


@pytest.mark.parametrize("TMo", [128, 256, 512])
@pytest.mark.parametrize("prec", ["highest", "x3", "default"])
def test_spill_kernel_matches_plain(cuda_device, prec, TMo):
    rng = np.random.default_rng(TMo)
    M, Q, ncol = 4 * 512, 128, 700
    rel, cols, vals, first, blk = _spill_case(rng, M, TMo, Q, 1500, ncol)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)  # noqa: E731
    blk_ptr = spmm_ragged.first_ptr(first)
    for n in (16, 48, 100, 256):
        b = rng.standard_normal((ncol, n)).astype(np.float32)
        b[0] = np.nan  # pad slots point at column 0: they must be skipped
        c = t(rng.standard_normal((M, n)).astype(np.float32))
        args = (c, t(rel), t(cols), t(vals), t(blk), t(blk_ptr), t(b), prec)
        before = spmm_ragged.spmm_spill.launches
        k = spmm_ragged.spmm_spill(*args)
        assert spmm_ragged.spmm_spill.launches == before + 1
        p = spmm_ragged.spmm_spill_plain(*args)
        assert bool(torch.isfinite(k).all())
        assert float((k - p).double().norm() / p.double().norm()) <= 1e-6
        assert torch.equal(k[3 * TMo:], c[3 * TMo:])  # dummy blocks pass C through


@pytest.mark.parametrize("prec", ["x3", "default", "highest"])
def test_ragged_engine_on_card_matches_engine_on_cpu(cuda_device, prec):
    """Both engines take the ragged pack; the card's adds the spill in the
    fused kernel, rounded per operating point (x3: bf16 hi + lo of each
    product, default: bf16), the CPU's in exact fp32, so the two agree to
    the operating point's class, and the card's exec equals the plain
    versions on its own pack."""
    a = powerlaw_community_csr(65536, 16, 1024, seed=7, dtype=np.float32)
    displs = csr_row_partition(a.rowptr, 1)
    b = fill_b(0, a.ncol, 0, 48, dtype=np.float32)
    gpu = RowParaSpmm(a, displs, displs, 48, device=cuda_device,
                      config=SpmmConfig(kernel="auto", mxu_precision=prec),
                      dtype=np.float32)
    a.__dict__.pop("_torch_pack_cache", None)
    cpu = RowParaSpmm(a, displs, displs, 48, device="cpu",
                      config=SpmmConfig(kernel="pallas", mxu_precision=prec),
                      dtype=np.float32)
    op = gpu._local_op
    assert gpu.kernel_kind == cpu.kernel_kind == "pallas"
    assert op.variant == cpu._local_op.variant == "ragged"
    assert op.roofline["spill_impl"] == "pallas"
    before = (op.kernel.launches, op.spill_kernel.launches)
    c_gpu = gpu.exec(b)
    assert (op.kernel.launches, op.spill_kernel.launches) == (before[0] + 1, before[1] + 1)
    ref = a.spmm_ref(b.astype(np.float64))
    tol_ref = {"x3": 1e-5, "default": 5e-3, "highest": 1e-6}[prec]
    assert rel_fro_err(ref, c_gpu) <= tol_ref
    assert rel_fro_err(ref, cpu.exec(b)) <= tol_ref
    arrs = tuple(x[0] for x in gpu.packed)
    rB = gpu.shard_b(b)[0]
    plain = op.spill_plain(*op.spill_args(arrs, op.plain(*op.kernel_args(arrs, rB)), rB))
    assert rel_fro_err(gpu.unshard_c(plain[None]).astype(np.float64), c_gpu) <= 1e-6


def _without_column_0(a):
    """``a`` without its column-0 entries: a NaN in B row 0 then reaches
    the product only through a pad slot (whose column is 0)."""
    rows = np.repeat(np.arange(a.nrow), np.diff(a.rowptr))
    keep = a.colidx != 0
    return CSRMatrix.from_coo(a.nrow, a.ncol, rows[keep], a.colidx[keep],
                              a.val[keep], dtype=a.val.dtype)


@pytest.mark.parametrize("prec", ["highest", "x3", "default"])
def test_gather_kernel_matches_plain(cuda_device, prec):
    """Scrambled power-law pack with trailing blocks that hold no nonzero:
    pad slots are skipped (B row 0 is NaN), empty blocks come out zero, and
    the kernel agrees with its plain version to 1e-6 relative Frobenius
    (the same rounded products summed in another order)."""
    a = _without_column_0(powerlaw_community_csr(20000, 16, 1024, seed=13,
                                                 permute=True, dtype=np.float32))
    arrays, op = _pack_gather([(a.rowptr, a.colidx.astype(np.int32), a.val)],
                              a.nrow + 700, np.float32, prec, cuda_device)
    arrs = tuple(x[0] for x in arrays)
    rng = np.random.default_rng(5)
    for n in (16, 48, 100, 256):
        b = rng.standard_normal((a.ncol, n)).astype(np.float32)
        b[0] = np.nan
        args = op.kernel_args(arrs, torch.from_numpy(b).to(cuda_device))
        before = spmm_ragged.spmm_gather.launches
        k = op.kernel(*args)
        assert spmm_ragged.spmm_gather.launches == before + 1
        p = op.plain(*args)
        assert k.shape == p.shape == (op.M, n) and bool(torch.isfinite(k).all())
        assert float((k - p).double().norm() / p.double().norm()) <= 1e-6
        assert not torch.any(k[a.nrow:])  # blocks with no nonzero are zero


@pytest.mark.parametrize("prec", ["x3", "default", "highest"])
def test_scrambled_auto_lands_on_gather(cuda_device, prec):
    """The scrambled graph through kernel="auto" on the card: the ragged
    cover refuses, the walk lands on gather, its kernel launches, and the
    product is within the point's class of the fp64 reference."""
    a = powerlaw_community_csr(65536, 16, 1024, seed=7, permute=True,
                               dtype=np.float32)
    displs = csr_row_partition(a.rowptr, 1)
    b = fill_b(0, a.ncol, 0, 48, dtype=np.float32)
    eng = RowParaSpmm(a, displs, displs, 48, device=cuda_device,
                      config=SpmmConfig(kernel="auto", mxu_precision=prec),
                      dtype=np.float32)
    assert eng.kernel_kind == eng._local_op.variant == "gather"
    before = spmm_ragged.spmm_gather.launches
    c = eng.exec(b)
    assert spmm_ragged.spmm_gather.launches == before + 1
    tol_ref = {"x3": 1e-5, "default": 5e-3, "highest": 1e-6}[prec]
    assert rel_fro_err(a.spmm_ref(b.astype(np.float64)), c) <= tol_ref


DD_MATS = {
    "banded": lambda: banded_random_csr(5000, nnz_per_row=9, bandwidth=300, seed=93),
    "cplaw": lambda: powerlaw_community_csr(9000, 9, 256, seed=94),
}


@pytest.mark.parametrize("pack_on", ["cuda", "cpu"])  # Wc = 512 / 256
@pytest.mark.parametrize("gen", sorted(DD_MATS))
def test_dd_kernel_matches_plain(cuda_device, gen, pack_on):
    """The FP64 tensor-core kernel on dd_mxu total covers with pad groups:
    within 1e-12 relative Frobenius of its plain version (cuBLAS fp64 over
    the gathered windows), pad rows zero, the n edge masked."""
    a = DD_MATS[gen]()
    arrays, op = _pack_dd_mxu([(a.rowptr, a.colidx.astype(np.int32), a.val)],
                              a.nrow + 300, torch.device(pack_on))
    assert op.roofline["W"] == (512 if pack_on == "cuda" else 256)
    arrs = tuple(x[0].to(cuda_device) for x in arrays)
    for n in (16, 48, 100, 256):
        rB = torch.from_numpy(_b(a, op.min_b_rows, n, np.float64)).to(cuda_device)
        args = op.kernel_args(arrs, rB)
        before = spmm_dd_mxu.spmm_ragged_dd.launches
        k = op.kernel(*args, min_b_rows=op.min_b_rows)
        assert spmm_dd_mxu.spmm_ragged_dd.launches == before + 1
        p = op.plain(*args)
        assert k.dtype == torch.float64 and k.shape == p.shape
        assert float((k - p).norm() / p.norm()) <= 1e-12
        assert not torch.any(k[a.nrow:])  # pad groups come out zero
        ref = a.spmm_ref(fill_b(0, a.ncol, 0, n))
        assert rel_fro_err(ref, k[: a.nrow].cpu().numpy()) <= 1e-12


@pytest.mark.parametrize("kernel", ["dd", "dd_mxu"])
def test_dd_engine_on_card(cuda_device, kernel):
    """kernel="dd" takes the FP64 tensor cores on the card (the CPU takes
    the non-MXU tier); both kinds land at the reference's 1e-12 from an
    fp32 engine dtype (the dd kinds compute in fp64 regardless)."""
    a = banded_random_csr(3000, nnz_per_row=9, bandwidth=150, seed=7)
    displs = csr_row_partition(a.rowptr, 1)
    eng = RowParaSpmm(a, displs, displs, 24, device=cuda_device,
                      config=SpmmConfig(kernel=kernel), dtype=np.float32)
    assert eng.kernel_kind == kernel and eng._local_op.variant == "dd_mxu"
    b = np.random.default_rng(0).standard_normal((a.ncol, 24))
    before = spmm_dd_mxu.spmm_ragged_dd.launches
    c = eng.exec(b)
    assert spmm_dd_mxu.spmm_ragged_dd.launches == before + 1
    assert c.dtype == np.float64 and rel_fro_err(a.spmm_ref(b), c) <= 1e-12
