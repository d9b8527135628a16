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
from crp_tpu.sparse.synth import banded_random_csr, fill_b
from crp_tpu.utils.norms import rel_fro_err

from crp_tpu_torch.engine.rowpara import RowParaSpmm
from crp_tpu_torch.kernels.dispatch import pack_local_kernel

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
