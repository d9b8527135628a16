"""Kernel choice and the sparsity-fallback walk of the port, against the JAX
package's decisions, and the segsum kind against its JAX counterpart."""

import logging

import numpy as np
import pytest
import torch

from crp_tpu.kernels import dispatch as jd
from crp_tpu.kernels.spmm_jnp import DeviceCSR, spmm_segment_sum as jax_segsum
from crp_tpu.sparse.synth import banded_random_csr, fill_b, powerlaw_random_csr

from crp_tpu_torch.kernels import dispatch as td
from crp_tpu_torch.kernels.spmm_pallas import UnsupportedSparsity
from crp_tpu_torch.kernels.spmm_segsum import pack_device_csr, spmm_segment_sum


def test_resolve_auto_kernel():
    # the JAX package picks segsum off the TPU (the CPU here)
    assert jd.resolve_auto_kernel(np.float32, 1) == "segsum"
    assert td.resolve_auto_kernel("cpu") == "segsum"
    assert td.resolve_auto_kernel(torch.device("cuda", 0)) == "pallas"


@pytest.mark.parametrize("kind", ["pallas", "gather", "segsum"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fallback_chain_matches_jax_off_accelerator(monkeypatch, kind, dtype):
    monkeypatch.delenv("CRP_TPU_FALLBACK", raising=False)
    assert td.sparsity_fallback_chain(kind, dtype, "cpu") == \
        jd.sparsity_fallback_chain(kind, dtype)
    assert td.sparsity_fallback_chain(kind, dtype, "cpu", is_dd=True) == ["dd"]


@pytest.mark.parametrize("kind", ["pallas", "gather", "segsum"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fallback_chain_on_cuda_mirrors_the_tpu_order(monkeypatch, kind, dtype):
    """On CUDA the chain is the JAX package's on a TPU (the order its
    CPU tests pin through CRP_TPU_FALLBACK) without the unported
    ``gather``, so no step of the walk is certain to fail."""
    import jax

    monkeypatch.delenv("CRP_TPU_FALLBACK", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    got = td.sparsity_fallback_chain(kind, dtype, "cuda")
    assert "gather" not in got
    assert got == [k for k in jd.sparsity_fallback_chain(kind, dtype) if k != "gather"]
    assert td.sparsity_fallback_chain(kind, dtype, "cuda", is_dd=True) == ["dd"]


@pytest.mark.parametrize("kind", ["ragged", "gather", "pallas_halo"])
def test_cuda_walk_goes_straight_to_segsum(monkeypatch, caplog, kind):
    """An unported kind on CUDA tries segsum next: one attempt, one
    warning (the packing itself runs on the CPU here)."""
    tried = []
    pack = td.pack_local_kernel

    def recording_pack(shards, max_m, dtype, kind, *, device, mxu_precision):
        tried.append((kind, torch.device(device).type))
        return pack(shards, max_m, dtype, kind, device="cpu",
                    mxu_precision=mxu_precision)

    monkeypatch.setattr(td, "pack_local_kernel", recording_pack)
    a = banded_random_csr(500, nnz_per_row=5, bandwidth=20, seed=1, dtype=np.float32)
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    with caplog.at_level(logging.WARNING, logger="crp_tpu_torch"):
        _, op, got = td.pack_with_fallback(shard, a.nrow, np.float32, kind,
                                           device=torch.device("cuda", 0))
    assert got == "segsum" and isinstance(op, td.SegsumOp)
    assert tried == [(kind, "cuda"), ("segsum", "cuda")]
    assert caplog.text.count("falling back to") == 1


@pytest.mark.parametrize("kind", ["ell", "ragged", "gather", "dd", "dd_mxu", "pallas_halo"])
def test_unported_kinds_refuse_and_walk_to_segsum(caplog, kind):
    a = banded_random_csr(500, nnz_per_row=5, bandwidth=20, seed=1, dtype=np.float32)
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    with pytest.raises(UnsupportedSparsity, match="not yet ported"):
        td.pack_local_kernel(shard, a.nrow, np.float32, kind, device="cpu")
    with caplog.at_level(logging.WARNING, logger="crp_tpu_torch"):
        _, op, got = td.pack_with_fallback(shard, a.nrow, np.float32, kind, device="cpu")
    assert got == "segsum" and isinstance(op, td.SegsumOp)
    assert "falling back to segsum" in caplog.text


def test_dd_class_keeps_its_contract():
    a = banded_random_csr(300, nnz_per_row=5, bandwidth=20, seed=1)
    with pytest.raises(UnsupportedSparsity, match="not yet ported"):
        td.pack_with_fallback([(a.rowptr, a.colidx, a.val)], a.nrow, np.float64,
                              "dd", device="cpu", is_dd=True)


def test_unknown_kind_raises():
    a = banded_random_csr(300, nnz_per_row=5, bandwidth=20, seed=1)
    with pytest.raises(ValueError, match="unknown"):
        td.pack_local_kernel([(a.rowptr, a.colidx, a.val)], a.nrow, np.float64,
                             "nope", device="cpu")


def test_multi_shard_pallas_refuses():
    a = banded_random_csr(600, nnz_per_row=5, bandwidth=20, seed=1, dtype=np.float32)
    s1, s2 = a.row_slice(0, 300), a.row_slice(300, 600)
    shards = [(s.rowptr, s.colidx.astype(np.int32), s.val) for s in (s1, s2)]
    with pytest.raises(UnsupportedSparsity, match="Queue B #4"):
        td.pack_local_kernel(shards, 300, np.float32, "pallas", device="cpu")


@pytest.mark.parametrize("gen,kw", [
    (banded_random_csr, dict(nnz_per_row=7, bandwidth=30)),
    (powerlaw_random_csr, dict(avg_degree=9)),
])
@pytest.mark.parametrize("pad", [0, 41])
def test_segment_sum_matches_jax(gen, kw, pad):
    a = gen(300, seed=17, **kw)
    b = fill_b(0, a.ncol, 0, 40)
    r, c, v = pack_device_csr(a.rowptr, a.colidx, a.val, a.nnz + pad, nrow=320)
    got = spmm_segment_sum(torch.from_numpy(r), torch.from_numpy(c),
                           torch.from_numpy(v), 320, torch.from_numpy(b)).numpy()
    want = np.asarray(jax_segsum(DeviceCSR(r, c, v, 320), b))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[: a.nrow], a.to_dense() @ b, rtol=1e-12, atol=1e-9)
    assert not np.any(got[a.nrow:])


def test_segsum_pack_matches_jax_arrays():
    a = banded_random_csr(400, nnz_per_row=6, bandwidth=25, seed=2)
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    j_arrays, _ = jd.pack_local_kernel(shard, 450, np.float64, "segsum")
    t_arrays, op = td.pack_local_kernel(shard, 450, np.float64, "segsum", device="cpu")
    for t, j in zip(t_arrays, j_arrays):
        np.testing.assert_array_equal(t.numpy(), j)
    assert op.nrow == 450 and op.min_b_rows == 1
