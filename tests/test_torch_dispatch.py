"""Kernel choice and the sparsity-fallback walk of the port, against the JAX
package's decisions, and the segsum kind against its JAX counterpart."""

import logging

import numpy as np
import pytest
import torch

from crp_tpu.kernels import dispatch as jd
from crp_tpu.kernels.spmm_jnp import DeviceCSR, spmm_segment_sum as jax_segsum
from crp_tpu.sparse.synth import (
    banded_random_csr, fill_b, powerlaw_community_csr, powerlaw_random_csr,
)

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
    CPU tests pin through CRP_TPU_FALLBACK): ``gather`` before ``segsum``
    for fp32, unless gather itself refused."""
    import jax

    monkeypatch.delenv("CRP_TPU_FALLBACK", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    got = td.sparsity_fallback_chain(kind, dtype, "cuda")
    assert got == jd.sparsity_fallback_chain(kind, dtype)
    assert ("gather" in got) == (dtype == np.float32 and kind != "gather")
    assert td.sparsity_fallback_chain(kind, dtype, "cuda", is_dd=True) == ["dd"]


def _recording_pack(monkeypatch):
    """Make ``pack_with_fallback`` record each (kind, device) it tries and
    pack on the CPU whatever the device."""
    tried = []
    pack = td.pack_local_kernel

    def recording_pack(shards, max_m, dtype, kind, *, device, mxu_precision,
                       **kw):
        tried.append((kind, torch.device(device).type))
        return pack(shards, max_m, dtype, kind, device="cpu",
                    mxu_precision=mxu_precision, **kw)

    monkeypatch.setattr(td, "pack_local_kernel", recording_pack)
    return tried


@pytest.mark.parametrize("kind", ["gather", "pallas_halo"])
def test_cuda_walk_goes_straight_to_segsum(monkeypatch, caplog, kind):
    """fp64 data on CUDA: ``gather`` (fp32-only) and the unported
    ``pallas_halo`` refuse, and the fp64 chain tries segsum next: one
    attempt, one warning (the packing itself runs on the CPU here)."""
    tried = _recording_pack(monkeypatch)
    a = banded_random_csr(500, nnz_per_row=5, bandwidth=20, seed=1)
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    with caplog.at_level(logging.WARNING, logger="crp_tpu_torch"):
        _, op, got = td.pack_with_fallback(shard, a.nrow, np.float64, kind,
                                           device=torch.device("cuda", 0))
    assert got == "segsum" and isinstance(op, td.SegsumOp)
    assert tried == [(kind, "cuda"), ("segsum", "cuda")]
    assert caplog.text.count("falling back to") == 1


def test_cuda_walk_lands_on_gather(monkeypatch, caplog):
    """A scrambled power-law graph on CUDA, fp32: the ragged cover refuses
    and the walk's next step, gather, packs."""
    tried = _recording_pack(monkeypatch)
    a = powerlaw_community_csr(20000, 4, 1024, seed=3, permute=True,
                               dtype=np.float32)
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    with caplog.at_level(logging.WARNING, logger="crp_tpu_torch"):
        _, op, got = td.pack_with_fallback(shard, a.nrow, np.float32, "pallas",
                                           device=torch.device("cuda", 0),
                                           mxu_precision="x3")
    assert got == op.variant == "gather" and isinstance(op, td.GatherOp)
    assert tried == [("pallas", "cuda"), ("gather", "cuda")]
    assert "30%" in caplog.text


# what each kind of the JAX package packs to here (fp32 data, on the CPU)
LANDS = {
    "ell": ("ell", "EllOp", "ell"),
    "gather": ("gather", "GatherOp", "gather"),
    "dd": ("dd", "DDOp", "ell"),  # the CPU takes the non-MXU tier
    "dd_mxu": ("dd_mxu", "RaggedOp", "dd_mxu"),
    "pallas_halo": ("segsum", "SegsumOp", "segsum"),
}


@pytest.mark.parametrize("kind", ["ell", "gather", "dd", "dd_mxu", "pallas_halo"])
def test_unported_kinds_refuse_and_walk_to_segsum(caplog, kind):
    """Only ``pallas_halo`` is still unported: it refuses and the walk
    ends at segsum.  The kinds ported since pack on their first attempt."""
    a = banded_random_csr(500, nnz_per_row=5, bandwidth=20, seed=1, dtype=np.float32)
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    if kind == "pallas_halo":
        with pytest.raises(UnsupportedSparsity, match="not yet ported"):
            td.pack_local_kernel(shard, a.nrow, np.float32, kind, device="cpu")
    with caplog.at_level(logging.WARNING, logger="crp_tpu_torch"):
        _, op, got = td.pack_with_fallback(shard, a.nrow, np.float32, kind, device="cpu")
    want, op_type, variant = LANDS[kind]
    assert got == want and type(op).__name__ == op_type
    assert getattr(op, "variant", None) == variant
    assert ("falling back to segsum" in caplog.text) == (kind == "pallas_halo")


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_ragged_kind_packs_without_a_fallback(monkeypatch, caplog, device):
    """The ragged kind is ported: on either device the walk makes one
    attempt, which packs (the packing itself runs on the CPU here)."""
    tried = []
    pack = td.pack_local_kernel

    def recording_pack(shards, max_m, dtype, kind, *, device, mxu_precision):
        tried.append((kind, torch.device(device).type))
        return pack(shards, max_m, dtype, kind, device="cpu",
                    mxu_precision=mxu_precision)

    monkeypatch.setattr(td, "pack_local_kernel", recording_pack)
    a = powerlaw_random_csr(600, avg_degree=9, seed=1, dtype=np.float32)
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    with caplog.at_level(logging.WARNING, logger="crp_tpu_torch"):
        _, op, got = td.pack_with_fallback(shard, a.nrow, np.float32, "ragged",
                                           device=torch.device(device))
    assert got == "ragged" and isinstance(op, td.RaggedOp)
    assert tried == [("ragged", device)]
    assert "falling back" not in caplog.text


@pytest.mark.parametrize("prec", ["x3", "highest"])
def test_ragged_kind_matches_jax_decision(prec):
    a = powerlaw_random_csr(900, avg_degree=9, seed=2, dtype=np.float32)
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    _, fn, kind = jd.pack_with_fallback(shard, a.nrow, np.float32, "ragged",
                                        mxu_precision=prec)
    _, op, got = td.pack_with_fallback(shard, a.nrow, np.float32, "ragged",
                                       device="cpu", mxu_precision=prec)
    assert (got, op.variant) == (kind, fn.variant) == ("ragged", "ragged")
    assert op.min_b_rows == fn.min_b_rows and op.roofline == fn.roofline


def test_dd_class_keeps_its_contract():
    """dd-class requests never leave the dd kinds: the chain is ["dd"]
    whatever ``fallback`` says (as ``CRP_TPU_FALLBACK`` is ignored), and a
    refused dd_mxu pack lands on dd's non-MXU tier, exact to 1e-12."""
    a = banded_random_csr(300, nnz_per_row=5, bandwidth=20, seed=1)
    shard = [(a.rowptr, a.colidx, a.val)]
    assert td.sparsity_fallback_chain("dd_mxu", np.float64, "cuda", is_dd=True,
                                      fallback=["segsum"]) == ["dd"]
    assert td.sparsity_fallback_chain("pallas", np.float32, "cpu",
                                      fallback=["gather", "segsum"]) == ["gather", "segsum"]
    # a cover over no nonzero refuses, as any dd_mxu refusal would
    empty = [(np.zeros(301, np.int64), np.zeros(0, np.int32), np.zeros(0))]
    with pytest.raises(UnsupportedSparsity, match="empty"):
        td.pack_local_kernel(empty, 300, np.float64, "dd_mxu", device="cpu")
    _, op, got = td.pack_with_fallback(shard, a.nrow, np.float64, "dd", device="cpu",
                                       is_dd=True, fallback=["segsum"])
    assert got == "dd" and op.variant == "ell"
    b = fill_b(0, a.ncol, 0, 16)
    arrs = td.pack_local_kernel(shard, a.nrow, np.float64, "dd", device="cpu")[0]
    c = op(tuple(x[0] for x in arrs), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(c, a.spmm_ref(b), rtol=1e-12, atol=1e-12)


def test_dd_skip_mxu_avoids_a_second_cover(monkeypatch):
    """After a refused dd_mxu pack the dd retry goes straight to the
    non-MXU tier (after ``tests/test_dd_mxu.py:175``); without the flag,
    kind="dd" tries the FP64 tensor-core tier first on CUDA, and never on
    the CPU."""
    calls = []

    def refuse(shards, max_m, device):
        calls.append(torch.device(device).type)
        raise UnsupportedSparsity("forced")

    pack_dd = td._pack_dd
    monkeypatch.setattr(td, "_pack_dd_mxu", refuse)
    monkeypatch.setattr(td, "_pack_dd", lambda shards, max_m, device:
                        pack_dd(shards, max_m, torch.device("cpu")))
    a = banded_random_csr(64, nnz_per_row=3, bandwidth=8, seed=0)
    shard = [(a.rowptr, a.colidx, a.val)]
    cuda = torch.device("cuda", 0)
    _, op, got = td.pack_with_fallback(shard, 64, np.float64, "dd_mxu", device=cuda,
                                       is_dd=True)
    assert got == "dd" and op.variant == "ell" and calls == ["cuda"]
    td.pack_local_kernel(shard, 64, np.float64, "dd", device=cuda)
    assert calls == ["cuda", "cuda"]
    td.pack_local_kernel(shard, 64, np.float64, "dd", device="cpu")
    assert calls == ["cuda", "cuda"]


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
