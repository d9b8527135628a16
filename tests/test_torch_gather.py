"""The port's ``gather`` kind against the JAX package on the CPU: the host
layout bit for bit, the op against ``spmm_gather_chunked`` in interpret
mode on its own pack and on a JAX pack, the engine within class, and the
fallback walk that reaches it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crp_tpu.config import SpmmConfig
from crp_tpu.engine.rowpara import RowParaSpmm as JaxRowPara
from crp_tpu.kernels import dispatch as jd
from crp_tpu.kernels import spmm_ragged as js
from crp_tpu.plan.partition1d import csr_row_partition
from crp_tpu.shard.layout import make_mesh_1d
from crp_tpu.sparse.csr import CSRMatrix
from crp_tpu.sparse.synth import (
    banded_random_csr, fill_b, powerlaw_community_csr, powerlaw_random_csr,
)
from crp_tpu.utils.norms import rel_fro_err

from crp_tpu_torch.engine.rowpara import RowParaSpmm
from crp_tpu_torch.kernels import dispatch as td
from crp_tpu_torch.kernels import spmm_ragged as ts

CPU = torch.device("cpu")
TOL_REF = {"x3": 1e-5, "default": 5e-3, "highest": 1e-6}


@pytest.fixture
def no_knobs(monkeypatch):
    for k in ("CRP_TPU_SPILL_TMO", "CRP_TPU_SPILL_Q", "CRP_TPU_GATHER_GB",
              "CRP_TPU_FALLBACK"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _fuzz_csr(seed):
    """The shapes of ``tests/test_ragged.py:418-474``: a random CSR with
    duplicate entries, TMo = Q = 128."""
    rng = np.random.default_rng(seed)
    nrow = int(rng.integers(1, 1200))
    z = int(rng.integers(1, 5000))
    rows = np.sort(rng.integers(0, nrow, z)).astype(np.int64)
    cols = rng.integers(0, 3000, z).astype(np.int32)
    vals = rng.standard_normal(z)
    return CSRMatrix.from_coo(nrow, 3000, rows, cols, vals, dtype=np.float32)


@pytest.mark.parametrize("seed", range(6))
def test_gather_layout_and_pack_match_jax(seed):
    """gather_step_layout and pack_gather_blocks bit-equal to JAX's, one
    shard and a layout shared by two."""
    a = _fuzz_csr(seed)
    TMo = Q = 128
    M = -(-a.nrow // TMo) * TMo
    idx = np.minimum(np.arange(M // TMo + 1) * TMo, a.nrow)
    counts = [np.diff(a.rowptr[idx]).astype(np.int64)]
    counts.append(np.random.default_rng(seed).integers(0, 400, M // TMo))
    for cl in (counts[:1], counts):
        got, want = ts.gather_step_layout(cl, Q), js.gather_step_layout(cl, Q)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        got = ts.pack_gather_blocks(a.rowptr, a.colidx, a.val, want, M, TMo=TMo, Q=Q)
        for g, w in zip(got, js.pack_gather_blocks(a.rowptr, a.colidx, a.val,
                                                   want, M, TMo=TMo, Q=Q)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _jax_arrays(arrays):
    return [np.asarray(x) for x in arrays]


@pytest.mark.parametrize("prec", ["x3", "default", "highest"])
def test_gather_op_matches_jax_interpret(no_knobs, prec):
    """The port's gather op, on its own pack and on the JAX pack carried
    over by ``local_op_from_jax_pack``, within 1e-6 relative Frobenius of
    ``spmm_gather_chunked(interpret=True)`` (the same rounded products
    summed in another order); the packs are the same arrays."""
    a = powerlaw_random_csr(1500, avg_degree=13, seed=4, dtype=np.float32)
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    max_m = a.nrow + 600  # trailing blocks with no nonzero
    j_arrays, j_fn = jd.pack_local_kernel(shard, max_m, np.float32, "gather",
                                          mxu_precision=prec)
    t_arrays, op = td.pack_local_kernel(shard, max_m, np.float32, "gather",
                                        device="cpu", mxu_precision=prec)
    assert op.variant == j_fn.variant == "gather" and op.roofline == j_fn.roofline
    assert op.min_b_rows == j_fn.min_b_rows == 1
    for t, j in zip(t_arrays, j_arrays):
        np.testing.assert_array_equal(t.numpy(), j)
    c_tensors, c_op = td.local_op_from_jax_pack(_jax_arrays(j_arrays), j_fn.min_b_rows,
                                                device="cpu", roofline=j_fn.roofline,
                                                variant="gather")
    assert (c_op.M, c_op.mxu_precision) == (op.M, prec)
    for x, y in zip(c_tensors, t_arrays):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    b = np.random.default_rng(1).standard_normal((a.ncol, 40)).astype(np.float32)
    want = np.asarray(j_fn(tuple(jnp.asarray(x[0]) for x in j_arrays), jnp.asarray(b)))
    for arrays, the_op in ((t_arrays, op), (c_tensors, c_op)):
        got = the_op(tuple(x[0] for x in arrays), torch.from_numpy(b)).numpy()
        assert got.shape == want.shape == (op.M, 40)
        assert rel_fro_err(want.astype(np.float64), got) <= 1e-6
        assert not np.any(got[a.nrow:])


def _pair(a, n, config, dtype):
    displs = csr_row_partition(a.rowptr, 1)
    j = JaxRowPara(a, displs, displs, n, mesh=make_mesh_1d(1), config=config,
                   dtype=dtype)
    t = RowParaSpmm(a, displs, displs, n, device="cpu", config=config, dtype=dtype)
    return j, t


@pytest.mark.parametrize("prec", ["x3", "default", "highest"])
def test_rowpara_gather_within_class(no_knobs, prec):
    """``RowParaSpmm(kernel="gather")`` (after ``tests/test_ragged.py:373``):
    the JAX engine's decisions, its product to 1e-6, and the point's class
    against the fp64 reference."""
    a = powerlaw_random_csr(2500, avg_degree=13, seed=4, dtype=np.float32)
    b = np.random.default_rng(3).standard_normal((a.ncol, 24)).astype(np.float32)
    j, t = _pair(a, 24, SpmmConfig(kernel="gather", mxu_precision=prec), np.float32)
    assert t.kernel_kind == j.kernel_kind == "gather"
    assert t._local_op.variant == j._local_fn.variant == "gather"
    assert (t._rb_rows, t.max_k) == (j._rb_rows, j.max_k)
    cj, ct = j.exec(b), t.exec(b)
    assert ct.shape == (a.nrow, 24) and ct.dtype == np.float32
    assert rel_fro_err(cj.astype(np.float64), ct) <= 1e-6
    assert rel_fro_err(a.spmm_ref(b.astype(np.float64)), ct) <= TOL_REF[prec]


def test_gather_rejects_fp64(no_knobs):
    """fp64 keeps its accuracy contract (after ``tests/test_ragged.py:393``):
    gather is fp32-only and the engine walks to segsum, exact to 1e-12."""
    a = banded_random_csr(600, nnz_per_row=5, bandwidth=40, seed=9)
    with pytest.raises(td.UnsupportedSparsity, match="fp32-only"):
        td.pack_local_kernel([(a.rowptr, a.colidx, a.val)], a.nrow, np.float64,
                             "gather", device="cpu")
    j, t = _pair(a, 8, SpmmConfig(kernel="gather"), np.float64)
    assert t.kernel_kind == j.kernel_kind == "segsum"
    b = np.random.default_rng(1).standard_normal((a.ncol, 8))
    assert rel_fro_err(a.spmm_ref(b), t.exec(b)) <= 1e-12


def _pure_scatter():
    """``tests/test_auto_kernel.py:64-79``'s matrix: 4 random columns in
    each of 256 rows over 20000, which both covers refuse."""
    rng = np.random.default_rng(61)
    nr, k = 256, 20000
    rows = np.arange(nr, dtype=np.int64).repeat(4)
    cols = rng.integers(0, k, size=4 * nr)
    return CSRMatrix.from_coo(nr, k, rows, cols, np.ones(len(rows)), dtype=np.float32)


@pytest.mark.parametrize("gen", ["pure_scatter", "scrambled_cplaw"])
def test_fallback_lands_on_gather(no_knobs, gen):
    """The TPU chain forced onto the CPU, as ``CRP_TPU_FALLBACK`` does in
    ``tests/test_auto_kernel.py:64-79``: with ``fallback=["gather",
    "segsum"]`` a matrix the ragged cover refuses lands on gather in both
    packages, with the same arrays, exact in fp32 to the class bound."""
    a = (_pure_scatter() if gen == "pure_scatter"
         else powerlaw_community_csr(20000, 4, 1024, seed=3, permute=True,
                                     dtype=np.float32))
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    no_knobs.setenv("CRP_TPU_FALLBACK", "gather,segsum")
    j_arrays, j_fn, j_kind = jd.pack_with_fallback(shard, a.nrow, np.float32,
                                                   "pallas", mxu_precision="x3")
    t_arrays, op, kind = td.pack_with_fallback(shard, a.nrow, np.float32, "pallas",
                                               device="cpu", mxu_precision="x3",
                                               fallback=["gather", "segsum"])
    assert kind == j_kind == "gather" and op.variant == j_fn.variant
    for t, j in zip(t_arrays, j_arrays):
        np.testing.assert_array_equal(t.numpy(), j)
    b = np.asarray(fill_b(0, a.ncol, 0, 8), dtype=np.float32)
    c = op(tuple(x[0] for x in t_arrays), torch.from_numpy(b)).numpy()[: a.nrow]
    assert rel_fro_err(a.spmm_ref(b.astype(np.float64)), c) <= 1e-5
    # without the override the CPU chain is segsum's alone, as JAX's off the TPU
    no_knobs.delenv("CRP_TPU_FALLBACK")
    assert td.pack_with_fallback(shard, a.nrow, np.float32, "pallas", device="cpu")[2] \
        == jd.pack_with_fallback(shard, a.nrow, np.float32, "pallas")[2] == "segsum"
