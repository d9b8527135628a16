"""The windowed kernels' plain PyTorch versions against the JAX Pallas
kernels (interpret mode on the CPU) on one shared pack, and against the
fp64 host reference.  The CUDA kernels are checked against these plain
versions in ``test_torch_cuda.py``."""

import functools

import numpy as np
import pytest
import torch

from crp_tpu.kernels.dispatch import pack_local_kernel as jax_pack
from crp_tpu.sparse.synth import banded_random_csr, fill_b
from crp_tpu.utils.norms import rel_fro_err

from crp_tpu_torch.kernels import spmm_pallas as tsp
from crp_tpu_torch.kernels.dispatch import local_op_from_jax_pack

# (mxu_precision, dtype, bound vs the fp64 reference): the JAX records'
# accuracy classes
POINTS = [
    ("x3", np.float32, 1e-5),
    ("default", np.float32, 5e-3),
    ("highest", np.float32, 1e-6),
    ("highest", np.float64, 1e-12),
]
NS = [16, 48, 100, 256]
# between the packages: the same exact products summed in another order
TOL_PACKAGES = {np.float32: 1e-6, np.float64: 1e-12}


@functools.lru_cache(maxsize=None)
def _case(prec, dtype):
    """One banded matrix with pad groups (max_m past nrow), its JAX pack
    and the port's tensors and op built from that same pack."""
    a = banded_random_csr(3000, nnz_per_row=7, bandwidth=80, seed=91, dtype=dtype)
    arrays, fn = jax_pack([(a.rowptr, a.colidx.astype(np.int32), a.val)],
                          a.nrow + 300, dtype, "pallas", mxu_precision=prec)
    assert len(arrays) in (3, 4), "expected the super-grouped pack"
    as_np = [np.asarray(x) for x in arrays]
    as_np = [x.view(np.uint16) if x.dtype.name == "bfloat16" else x for x in as_np]
    tensors, op = local_op_from_jax_pack(as_np, fn.min_b_rows, roofline=fn.roofline)
    return a, arrays, fn, tensors, op


def _b(a, rows, n, dtype):
    b = np.zeros((rows, n), dtype)
    b[: a.ncol] = fill_b(0, a.ncol, 0, n, dtype=dtype)
    return b


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("prec,dtype,tol_ref", POINTS)
def test_plain_matches_jax_interpret(prec, dtype, tol_ref, n):
    a, arrays, fn, tensors, op = _case(prec, dtype)
    b = _b(a, fn.min_b_rows, n, dtype)
    c_jax = np.asarray(fn(tuple(x[0] for x in arrays), b))
    c_port = op(tuple(t[0] for t in tensors), torch.from_numpy(b)).numpy()
    assert c_port.dtype == c_jax.dtype and c_port.shape == c_jax.shape
    assert rel_fro_err(c_jax.astype(np.float64), c_port) <= TOL_PACKAGES[dtype]
    ref = a.spmm_ref(b[: a.ncol].astype(np.float64))
    assert rel_fro_err(ref, c_port[: a.nrow]) <= tol_ref
    # pad groups past the shard's rows come out zero
    assert not np.any(c_port[a.nrow:])


@pytest.mark.parametrize("prec,dtype,tol_ref", POINTS)
def test_wrapper_runs_plain_on_cpu_without_launching(prec, dtype, tol_ref):
    a, arrays, fn, tensors, op = _case(prec, dtype)
    rB = torch.from_numpy(_b(a, fn.min_b_rows, 48, dtype))
    args = op.kernel_args(tuple(t[0] for t in tensors), rB)
    before = op.kernel.launches
    got = op.kernel(*args, min_b_rows=op.min_b_rows)
    assert op.kernel.launches == before
    assert torch.equal(got, op.plain(*args))


@pytest.mark.parametrize("tf32", [True, False])
@pytest.mark.parametrize("prec,dtype,tol_ref", POINTS)
def test_plain_runs_without_tf32_and_restores_it(monkeypatch, prec, dtype, tol_ref, tf32):
    a, arrays, fn, tensors, op = _case(prec, dtype)
    rB = torch.from_numpy(_b(a, fn.min_b_rows, 16, dtype))
    args = op.kernel_args(tuple(t[0] for t in tensors), rB)
    seen = []
    bmm = torch.bmm

    def recording_bmm(*xs):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return bmm(*xs)

    monkeypatch.setattr(torch, "bmm", recording_bmm)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", tf32)
    op.plain(*args)
    assert seen and not any(seen)
    assert torch.backends.cuda.matmul.allow_tf32 is tf32


def test_wrapper_raises_off_cpu_and_cuda():
    ws = torch.zeros(1, dtype=torch.int32, device="meta")
    tiles = torch.zeros((1, 256, 128), device="meta")
    b = torch.zeros((128, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsp.spmm_window_sg(ws, tiles, b, min_b_rows=128)
    with pytest.raises(ValueError, match="several devices"):
        tsp.spmm_window_sg(ws, tiles, torch.zeros((128, 4)), min_b_rows=128)


def test_local_op_from_jax_pack_schemes():
    for prec, dtype, scheme in (("x3", np.float32, "x3"),
                                ("default", np.float32, "bf16"),
                                ("highest", np.float64, "full")):
        _, arrays, fn, tensors, op = _case(prec, dtype)
        assert op.scheme == scheme and op.min_b_rows == fn.min_b_rows
        assert len(tensors) == len(arrays)
        assert op.kernel is {"x3": tsp.spmm_window_sg_presplit,
                             "bf16": tsp.spmm_window_sg_bf16,
                             "full": tsp.spmm_window_sg}[scheme]
