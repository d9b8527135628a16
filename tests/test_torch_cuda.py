"""The port on a CUDA card: each kernel against its plain version, and the
engine on the card against the engine on the CPU.

Every case skips without a CUDA device: the kernels have no CPU mode.
This file imports only the port, none of jax or crp_tpu; run it on the
GPU machine without the repository's conftest (which re-execs onto a JAX
CPU mesh):

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from crp_tpu_torch.comm.exchange import build_b_exchange, exchange_b, exchange_tables
from crp_tpu_torch.config import SpmmConfig
from crp_tpu_torch.engine.rowpara import RowParaSpmm
from crp_tpu_torch.kernels import (
    device_pack, spmm_dd_mxu, spmm_halo, spmm_pallas, spmm_ragged,
)
from crp_tpu_torch.kernels.dispatch import (
    _pack_dd_mxu, _pack_gather, _pack_ragged, _pack_window, pack_local_kernel,
)
from crp_tpu_torch.plan.partition1d import csr_row_partition
from crp_tpu_torch.sparse.csr import CSRMatrix
from crp_tpu_torch.sparse.synth import (
    banded_random_csr, fill_b, powerlaw_community_csr, powerlaw_random_csr,
)
from crp_tpu_torch.utils.norms import rel_fro_err

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


def _x3_pack(cuda_device):
    """The x3 pack of a banded matrix with pad groups (max_m past nrow)."""
    a = banded_random_csr(3000, nnz_per_row=7, bandwidth=80, seed=91, dtype=np.float32)
    arrays, op = pack_local_kernel([(a.rowptr, a.colidx.astype(np.int32), a.val)],
                                   a.nrow + 300, np.float32, "pallas",
                                   device=cuda_device, mxu_precision="x3")
    assert op.scheme == "x3"
    return a, tuple(x[0] for x in arrays[:3]), op


@pytest.mark.parametrize("n", [16, 37, 48, 100, 256])
def test_presplit_ab_kernel_matches_plain_and_presplit(cuda_device, n):
    """Kernel #5 on B pre-split by ``split_b_bf16``, odd n included: within
    TOL_PLAIN of its plain version, and #1's C on the B that was split bit
    for bit (the same RNE split, products and sums); pad rows zero; the
    card's split is the CPU's."""
    a, (ws, ah, al), op = _x3_pack(cuda_device)
    rng = np.random.default_rng(n)
    b = _b(a, op.min_b_rows, n, np.float32) * rng.standard_normal(
        (op.min_b_rows, n)).astype(np.float32)
    rB = torch.from_numpy(b).to(cuda_device)
    bh, bl = spmm_pallas.split_b_bf16(rB)
    ch, cl = spmm_pallas.split_b_bf16(rB.cpu())
    assert torch.equal(bh.cpu(), ch) and torch.equal(bl.cpu(), cl)
    before = spmm_pallas.spmm_window_sg_presplit_ab.launches
    k = spmm_pallas.spmm_window_sg_presplit_ab(ws, ah, al, bh, bl, min_b_rows=op.min_b_rows)
    assert spmm_pallas.spmm_window_sg_presplit_ab.launches == before + 1
    p = spmm_pallas.spmm_window_sg_presplit_ab_plain(ws, ah, al, bh, bl)
    assert k.shape == p.shape == (op.roofline["G"] * 256, n)
    assert float((k - p).abs().max() / p.abs().max()) <= TOL_PLAIN[np.float32]
    c1 = spmm_pallas.spmm_window_sg_presplit(ws, ah, al, rB, min_b_rows=op.min_b_rows)
    assert torch.equal(k, c1)
    assert not torch.any(k[a.nrow:])


def test_presplit_ab_kernel_refuses_wrong_b(cuda_device):
    """fp32 halves, a lo half of another shape and a short B are refused
    before any launch."""
    a, (ws, ah, al), op = _x3_pack(cuda_device)
    rB = torch.from_numpy(_b(a, op.min_b_rows, 16, np.float32)).to(cuda_device)
    bh, bl = spmm_pallas.split_b_bf16(rB)
    kernel = spmm_pallas.spmm_window_sg_presplit_ab
    before = kernel.launches
    with pytest.raises(ValueError, match="bf16"):
        kernel(ws, ah, al, rB, bl, min_b_rows=op.min_b_rows)
    with pytest.raises(ValueError, match="bf16"):
        kernel(ws, ah, al, bh, rB, min_b_rows=op.min_b_rows)
    with pytest.raises(ValueError, match="bl must be"):
        kernel(ws, ah, al, bh, bl[:-128], min_b_rows=op.min_b_rows)
    with pytest.raises(ValueError, match="min_b_rows"):
        kernel(ws, ah, al, bh[:-1], bl[:-1], min_b_rows=op.min_b_rows)
    assert kernel.launches == before


def test_presplit_b_sweep_on_card(cuda_device):
    """The presplit-B comparison on a small matrix: the three variants
    launch their kernels, #5 equals #1, each lands in its class."""
    from crp_tpu_torch.cli.presplit_b_sweep import sweep

    a = banded_random_csr(6000, nnz_per_row=9, bandwidth=300, seed=5, dtype=np.float32)
    kernels = (spmm_pallas.spmm_window_sg_presplit, spmm_pallas.spmm_window_sg_presplit_ab,
               spmm_pallas.spmm_window_sg_bf16)
    before = [k.launches for k in kernels]
    recs = {r["variant"]: r for r in sweep(a, 48, cuda_device, timing=(1, 2))}
    assert all(k.launches > b for k, b in zip(kernels, before))
    assert recs["presplit_ab_x3"]["max_abs_vs_presplit_a"] == 0.0
    assert recs["presplit_ab_x3"]["rel_fro_err"] <= 1e-5
    assert recs["presplit_a_x3"]["rel_fro_err"] <= 1e-5
    assert recs["bf16_1pass"]["rel_fro_err"] <= 5e-3
    assert all(r["device"] == torch.cuda.get_device_name(cuda_device) for r in recs.values())


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


def _bits_equal(x, y):
    """Equal bit for bit: compared as integers of the elements' width."""
    as_int = {4: torch.int32, 8: torch.int64}[x.element_size()]
    return x.shape == y.shape and torch.equal(x.view(as_int), y.view(as_int))


def _spill_b(rng, rows, n, off, dev):
    """A random B with row 0 NaN (pad slots carry column 0: they must be
    skipped), starting ``off`` elements into a NaN-framed buffer (an odd
    ``off`` takes it off 16 bytes: the narrower loads)."""
    b = rng.standard_normal((rows, n)).astype(np.float32)
    b[0] = np.nan
    return _nan_framed(torch.from_numpy(b).to(dev), off)


# the spill and gather kernels' widths: odd n and n = 100 take narrower
# loads; n = 512 walks two column tiles in every item
SPILL_N = [16, 37, 48, 100, 256, 512]


@pytest.mark.parametrize("TMo", [128, 256, 512])
@pytest.mark.parametrize("prec", ["highest", "x3", "default"])
def test_spill_kernel_matches_plain(cuda_device, prec, TMo):
    """The spill kernel on a hand pack (dummy blocks, multi-step blocks)
    through its row-ordered view, one item a row (L = 256) or a row in
    several (L = 16): equal bit for bit to the emulation of its order and
    to a second launch, within 1e-6 of the plain version (``index_add_``,
    another order), dummy blocks C bit for bit, B row 0 NaN never read, at
    every width and on an unaligned B."""
    rng = np.random.default_rng(TMo)
    M, Q, ncol = 4 * 512, 128, 700
    rel, cols, vals, _, blk = _spill_case(rng, M, TMo, Q, 1500, ncol)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)  # noqa: E731
    for L in (256, 16):
        view = spmm_ragged.spill_row_view(t(rel), t(cols), t(vals), t(blk), M, TMo, L=L)
        for n in SPILL_N:
            for off in ((0, 1) if n in (48, 256) else (0,)):
                b = _spill_b(rng, ncol, n, off, cuda_device)
                c = t(rng.standard_normal((M, n)).astype(np.float32))
                args = (c, t(rel), t(cols), t(vals), t(blk), TMo, b, prec, view)
                before = spmm_ragged.spmm_spill.launches
                k = spmm_ragged.spmm_spill(*args)
                assert spmm_ragged.spmm_spill.launches == before + 1
                assert _bits_equal(k, spmm_ragged.spmm_spill(*args))
                assert _bits_equal(k, spmm_ragged.spill_rows_ordered(c, view, b, M, prec))
                p = spmm_ragged.spmm_spill_plain(*args)
                assert bool(torch.isfinite(k).all())
                assert float((k - p).double().norm() / p.double().norm()) <= 1e-6
                assert _bits_equal(k[3 * TMo:], c[3 * TMo:])  # dummy blocks: C


def test_spill_rows_kernel_on_a_stacked_view(cuda_device):
    """Two shards' views stacked, a hub row of several items in the last
    block of the first shard right before its pad items: each shard's
    launch equals the emulation of its order bit for bit, spill and
    gather."""
    rng = np.random.default_rng(3)
    TMo, Q, ncol, M = 128, 128, 500, 4 * 128
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)  # noqa: E731
    views, packs = [], []
    for z, hub in ((300, 200), (60, 0)):
        rows = np.sort(np.r_[rng.integers(0, M, z), np.full(hub, M - 1)]).astype(np.int32)
        cols = rng.integers(1, ncol, rows.size).astype(np.int32)
        vals = rng.standard_normal(rows.size).astype(np.float32)
        counts = np.bincount(rows // TMo, minlength=M // TMo)
        ns = int(np.maximum(-(-counts // Q), 1).sum())
        rel, pc, pv, _, blk = spmm_ragged.pack_spill_blocks(
            (rows, cols, vals), ns, M, np.float32, TMo=TMo, Q=Q)
        packs.append(tuple(t(x) for x in (rel, pc, pv, blk)))
        views.append(spmm_ragged.spill_row_view(*packs[-1], M, TMo, L=16))
    stacked = spmm_ragged.stack_row_views(views)
    assert stacked[2].shape[1] > views[1][2].shape[0]  # shard 1 is padded
    for prec in ("highest", "x3", "default"):
        for i, (rel, cols, vals, blk) in enumerate(packs):
            view = tuple(x[i] for x in stacked)
            for n in (37, 256):
                b = _spill_b(rng, ncol, n, 0, cuda_device)
                c = t(rng.standard_normal((M, n)).astype(np.float32))
                k = spmm_ragged.spmm_spill(c, rel, cols, vals, blk, TMo, b, prec, view)
                assert _bits_equal(k, spmm_ragged.spill_rows_ordered(c, view, b, M, prec))
                g = spmm_ragged.spmm_gather(rel, cols, vals, blk, TMo, b, M, prec, view)
                assert _bits_equal(g, spmm_ragged.spill_rows_ordered(None, view, b, M,
                                                                     prec))


def test_spill_wrappers_raise_on_a_bad_view(cuda_device):
    """On the card the spill and gather wrappers need the view: without it,
    or with a wrong one (items cut short, more slots than its pack), they
    raise (never the plain version)."""
    rng = np.random.default_rng(1)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)  # noqa: E731
    M = 4 * 512
    rel, cols, vals, _, blk = _spill_case(rng, M, 512, 128, 300, 700)
    pack = (t(rel), t(cols), t(vals), t(blk), 512)
    view = spmm_ragged.spill_row_view(*pack[:4], M, 512)
    big = torch.zeros(rel.size + 1, dtype=torch.int32, device=cuda_device)
    b = t(rng.standard_normal((700, 32)).astype(np.float32))
    c = t(rng.standard_normal((M, 32)).astype(np.float32))
    before = (spmm_ragged.spmm_spill.launches, spmm_ragged.spmm_gather.launches)
    with pytest.raises(ValueError, match="view"):
        spmm_ragged.spmm_spill(c, *pack, b, "x3")
    with pytest.raises(ValueError, match="view"):
        spmm_ragged.spmm_gather(*pack, b, M, "x3")
    with pytest.raises(ValueError, match="items"):
        spmm_ragged.spmm_spill(c, *pack, b, "x3", (*view[:2], view[2][:, :3].contiguous(),
                                                  view[3]))
    with pytest.raises(ValueError, match="items for"):  # the sentinel alone
        spmm_ragged.spmm_gather(*pack, b, M, "x3", (*view[:2], view[2][-1:].contiguous(),
                                                     view[3]))
    with pytest.raises(ValueError, match="slots"):
        spmm_ragged.spmm_gather(*pack, b, M, "x3", (big, big.float(), *view[2:]))
    assert (spmm_ragged.spmm_spill.launches, spmm_ragged.spmm_gather.launches) == before


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
    pad slots are skipped (B row 0 is NaN), empty blocks come out zero, the
    kernel equals the emulation of its order and a second launch bit for
    bit, and agrees with its plain version to 1e-6 relative Frobenius (the
    same rounded products summed in another order), at every width and on
    an unaligned B."""
    a = _without_column_0(powerlaw_community_csr(20000, 16, 1024, seed=13,
                                                 permute=True, dtype=np.float32))
    arrays, op = _pack_gather([(a.rowptr, a.colidx.astype(np.int32), a.val)],
                              a.nrow + 700, np.float32, prec, cuda_device)
    arrs = tuple(x[0] for x in arrays)
    rng = np.random.default_rng(5)
    for n in SPILL_N:
        for off in ((0, 1) if n in (48, 256) else (0,)):
            args = op.kernel_args(arrs, _spill_b(rng, a.ncol, n, off, cuda_device))
            before = spmm_ragged.spmm_gather.launches
            k = op.kernel(*args)
            assert spmm_ragged.spmm_gather.launches == before + 1
            assert _bits_equal(k, op.kernel(*args))
            assert _bits_equal(k, spmm_ragged.spill_rows_ordered(None, args[-1], args[5],
                                                                 op.M, prec))
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


def _dd_pack(a, Wc, G, dev):
    """The dd_mxu total cover of ``a`` over G groups as the kernel's args
    without B, (step_g, group_ptr, starts, panels), and the rows B must
    have: at Wc = 512 the card's pack, at 256 the CPU's moved to the card,
    at 1024 (the geometry's clamp) from ``ragged_dd_cover`` and
    ``ragged_fill`` directly."""
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    if Wc in (256, 512):
        arrays, op = _pack_dd_mxu(shard, G * 128, dev if Wc == 512 else torch.device("cpu"))
        assert (op.roofline["TM"], op.roofline["W"], op.roofline["G"]) == (128, Wc, G)
        arrs = tuple(x[0].to(dev) for x in arrays)
        return op.kernel_args(arrs, None)[:4], op.min_b_rows
    G_a = -(-a.nrow // 128)
    starts, group_ptr = spmm_dd_mxu.ragged_dd_cover(a.rowptr, a.colidx, 128, Wc, G_a)
    panels, _, spill = device_pack.ragged_fill(a.rowptr, a.colidx.astype(np.int32), a.val,
                                               128, Wc, starts, group_ptr, "f64", dev)
    assert len(spill[0]) == 0
    # the pad groups past the matrix's rows, one zero dummy chunk each
    starts = np.concatenate([starts, np.zeros(G - G_a, np.int32)])
    group_ptr = np.concatenate([group_ptr, group_ptr[-1] + np.arange(1, G - G_a + 1)])
    panels = torch.cat([panels, panels.new_zeros((G - G_a, 128, Wc))])
    step_g = np.repeat(np.arange(G, dtype=np.int32), np.diff(group_ptr))
    args = tuple(torch.from_numpy(np.asarray(x, np.int32)).to(dev)
                 for x in (step_g, group_ptr, starts)) + (panels,)
    return args, int(np.max(starts)) + Wc


@pytest.mark.parametrize("Wc", [256, 512, 1024])
@pytest.mark.parametrize("gen", sorted(DD_MATS))
def test_dd_kernel_matches_plain(cuda_device, gen, Wc):
    """The FP64 tensor-core kernel (#11) on dd_mxu total covers with pad
    groups, at each Wc the packs take: within 1e-12 relative Frobenius of
    its plain version (cuBLAS fp64 over the gathered windows) and of the
    reference, equal bit for bit to a second launch (its sum order is
    fixed), pad rows zero, the n edge masked; odd n, and a B off 16 bytes
    (NaN around it: a read outside B shows), take the 8-byte B copies."""
    a = DD_MATS[gen]()
    G = -(-(a.nrow + 300) // 128)
    (step_g, group_ptr, starts, panels), min_b_rows = _dd_pack(a, Wc, G, cuda_device)
    assert panels.shape[1:] == (128, Wc) and torch.unique(step_g).numel() == G
    for n in (16, 37, 48, 100, 256, 512):
        ref = a.spmm_ref(fill_b(0, a.ncol, 0, n))
        for off in (0, 1):
            rB = _nan_framed(
                torch.from_numpy(_b(a, max(min_b_rows, a.ncol), n, np.float64)).to(cuda_device),
                off)
            args = (step_g, group_ptr, starts, panels, rB)
            before = spmm_dd_mxu.spmm_ragged_dd.launches
            k = spmm_dd_mxu.spmm_ragged_dd(*args, min_b_rows=min_b_rows)
            k2 = spmm_dd_mxu.spmm_ragged_dd(*args, min_b_rows=min_b_rows)
            assert spmm_dd_mxu.spmm_ragged_dd.launches == before + 2
            p = spmm_ragged.spmm_ragged_plain(*args)
            assert k.dtype == torch.float64 and k.shape == p.shape == (G * 128, n)
            assert _bits_equal(k, k2), (n, off)
            assert float((k - p).norm() / p.norm()) <= 1e-12, (n, off)
            assert not torch.any(k[a.nrow:])  # pad groups come out zero
            assert rel_fro_err(ref, k[: a.nrow].cpu().numpy()) <= 1e-12, (n, off)


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


def _gapped(gen):
    """``DD_MATS[gen]`` with rows 300-1499 emptied: the row groups within
    them (at TM = 128 and at 512) own only a zero dummy chunk in a ragged
    pack."""
    a = DD_MATS[gen]()
    rows = np.repeat(np.arange(a.nrow), np.diff(a.rowptr))
    keep = (rows < 300) | (rows >= 1500)
    return CSRMatrix.from_coo(a.nrow, a.ncol, rows[keep], a.colidx[keep], a.val[keep],
                              dtype=np.float64)


def _chunkless(step_g, group_ptr, starts, panels):
    """The ragged args with every zero chunk (the dummy chunks of empty and
    pad groups) dropped: those groups then own no chunk at all."""
    keep = panels.abs().amax(dim=(1, 2)) > 0
    counts = torch.bincount(step_g[keep].long(), minlength=group_ptr.numel() - 1)
    ptr = torch.zeros_like(group_ptr)
    ptr[1:] = torch.cumsum(counts, 0).to(group_ptr.dtype)
    return (step_g[keep].contiguous(), ptr, starts[keep].contiguous(),
            panels[keep].contiguous())


def _f64_checks(kernel, args, ref, nrow, min_b_rows, n):
    """One fp64 kernel launch and a second one: equal bit for bit, within
    1e-12 relative Frobenius of the plain version and of the reference,
    pad rows zero; returns C."""
    k = kernel(*args, min_b_rows=min_b_rows)
    k2 = kernel(*args, min_b_rows=min_b_rows)
    plain = {spmm_ragged.spmm_ragged: spmm_ragged.spmm_ragged_plain,
             spmm_pallas.spmm_window_sg: spmm_pallas.spmm_window_sg_plain}[kernel]
    p = plain(*args)
    assert k.dtype == torch.float64 and k.shape == p.shape and k.shape[1] == n
    assert _bits_equal(k, k2)
    assert float((k - p).norm() / p.norm()) <= 1e-12
    assert not torch.any(k[nrow:])  # pad groups come out zero
    assert rel_fro_err(ref, k[:nrow].cpu().numpy()) <= 1e-12
    return k


@pytest.mark.parametrize("chunkless", [False, True])
@pytest.mark.parametrize("geometry", [(128, 512), (256, 256), (512, 128)])
@pytest.mark.parametrize("gen", sorted(DD_MATS))
def test_f64_ragged_kernel_on_dmma(cuda_device, gen, geometry, chunkless):
    """#6 on fp64 (``crp_ragged_f64``: #11's DMMA body, its ragged walk) on
    total ragged covers of a matrix with empty row groups, pad groups past
    its rows, and (``chunkless``) those groups' zero dummy chunks dropped so
    that they own no chunk: within 1e-12 of its plain version and of the
    reference, a second launch equal bit for bit, empty and pad rows zero,
    over n from 16 to 512 with B NaN-framed (a read outside B shows) and
    off 16 bytes (the 8-byte B copies)."""
    a = _gapped(gen)
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    arrays, op = _pack_ragged(shard, a.nrow + 700, np.float64, "highest", cuda_device,
                              geometry=geometry, min_chunk_nnz=1)
    assert op.spill_impl == "none" and op.scheme == "full"
    step_g, group_ptr, starts, panels, _ = op.kernel_args(tuple(x[0] for x in arrays), None)
    if chunkless:
        step_g, group_ptr, starts, panels = _chunkless(step_g, group_ptr, starts, panels)
        counts = (group_ptr[1:] - group_ptr[:-1]).cpu()
        assert int((counts == 0).sum()) >= 2  # an empty group and a pad group
    for n in (16, 37, 48, 100, 256, 512):
        ref = a.spmm_ref(fill_b(0, a.ncol, 0, n))
        for off in (0, 1):
            rB = _nan_framed(torch.from_numpy(
                _b(a, max(op.min_b_rows, a.ncol), n, np.float64)).to(cuda_device), off)
            before = spmm_ragged.spmm_ragged.launches
            k = _f64_checks(spmm_ragged.spmm_ragged, (step_g, group_ptr, starts, panels, rB),
                            ref, a.nrow, op.min_b_rows, n)
            assert spmm_ragged.spmm_ragged.launches == before + 2
            assert not torch.any(k[300:1500])  # the empty rows


@pytest.mark.parametrize("Wc", [256, 512, 1024])
@pytest.mark.parametrize("gen", sorted(DD_MATS))
def test_f64_ragged_equals_dd_kernel(cuda_device, gen, Wc):
    """#6 on fp64 and #11 are one DMMA body with one walk: on the dd_mxu
    total covers (pad groups included) they give the same bits, at odd
    and even n, B on and off 16 bytes."""
    a = DD_MATS[gen]()
    G = -(-(a.nrow + 300) // 128)
    (step_g, group_ptr, starts, panels), min_b_rows = _dd_pack(a, Wc, G, cuda_device)
    for n in (37, 256):
        for off in (0, 1):
            rB = _nan_framed(torch.from_numpy(
                _b(a, max(min_b_rows, a.ncol), n, np.float64)).to(cuda_device), off)
            args = (step_g, group_ptr, starts, panels, rB)
            k6 = spmm_ragged.spmm_ragged(*args, min_b_rows=min_b_rows)
            k11 = spmm_dd_mxu.spmm_ragged_dd(*args, min_b_rows=min_b_rows)
            assert _bits_equal(k6, k11), (n, off)


def _f64_uniform(cuda_device):
    """A banded fp64 matrix's single-shard uniform pack with pad groups
    (#3 on fp64): the matrix, the op and (ws, tiles)."""
    a = banded_random_csr(3000, nnz_per_row=7, bandwidth=80, seed=91)
    arrays, op = pack_local_kernel([(a.rowptr, a.colidx.astype(np.int32), a.val)],
                                   a.nrow + 300, np.float64, "pallas", device=cuda_device,
                                   mxu_precision="highest")
    assert op.variant == "uniform" and op.scheme == "full"
    ws, tiles, _ = (x[0] for x in arrays)
    return a, op, ws, tiles


def test_f64_window_kernel_on_dmma(cuda_device):
    """#3 on fp64 (``crp_window_sg_f64``: #11's DMMA body, its windowed
    walk) on a uniform pack with pad groups: within 1e-12 of its plain
    version and of the reference, a second launch equal bit for bit, pad
    rows zero, over n from 16 to 512 with B NaN-framed and off 16 bytes;
    and equal bit for bit to #6 on fp64 on the same panels written as a
    ragged pack (one chunk a group: group_ptr = arange(G + 1), starts =
    ws)."""
    a, op, ws, tiles = _f64_uniform(cuda_device)
    G = ws.shape[0]
    assert tiles.shape[0] == G and G * tiles.shape[1] > a.nrow
    seq = torch.arange(G + 1, dtype=torch.int32, device=cuda_device)
    ragged = (seq[:-1].contiguous(), seq, ws, tiles)
    for n in (16, 37, 48, 100, 256, 512):
        ref = a.spmm_ref(fill_b(0, a.ncol, 0, n))
        for off in (0, 1):
            rB = _nan_framed(torch.from_numpy(
                _b(a, max(op.min_b_rows, a.ncol), n, np.float64)).to(cuda_device), off)
            before = spmm_pallas.spmm_window_sg.launches
            k3 = _f64_checks(spmm_pallas.spmm_window_sg, (ws, tiles, rB), ref, a.nrow,
                             op.min_b_rows, n)
            assert spmm_pallas.spmm_window_sg.launches == before + 2
            k6 = spmm_ragged.spmm_ragged(*ragged, rB, min_b_rows=op.min_b_rows)
            assert _bits_equal(k3, k6), (n, off)


def test_f64_entries_refuse_what_the_body_cannot_take(cuda_device):
    """The DMMA body takes TM % 128, W % 32 and panels on 16 bytes: the
    wrappers raise on TM = 64, W = 48 and panels off 16 bytes (no fallback
    to another body or to the plain version), and the entries themselves
    return an error (and the ragged one on a null group_ptr)."""
    from crp_tpu_torch.kernels import _build

    dev = cuda_device
    b = torch.zeros((4096, 16), dtype=torch.float64, device=dev)
    for G, TM, W in ((2, 64, 128), (2, 128, 48)):
        tiles = torch.zeros((G, TM, W), dtype=torch.float64, device=dev)
        ws = torch.zeros(G, dtype=torch.int32, device=dev)
        seq = torch.arange(G + 1, dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="TM % 128"):
            spmm_pallas.spmm_window_sg(ws, tiles, b, min_b_rows=W)
        with pytest.raises(ValueError, match="TM % 128"):
            spmm_ragged.spmm_ragged(seq[:-1], seq, ws, tiles, b, min_b_rows=W)
        c = torch.empty((G * TM, 16), dtype=torch.float64, device=dev)
        assert _build.entry("crp_window_sg_f64")(
            ws.data_ptr(), tiles.data_ptr(), b.data_ptr(), c.data_ptr(), G, TM, W, 16,
            None) != 0
        assert _build.entry("crp_ragged_f64")(
            seq.data_ptr(), ws.data_ptr(), tiles.data_ptr(), b.data_ptr(), c.data_ptr(), G,
            TM, W, 16, None) != 0
    G, TM, W = 2, 128, 128
    tiles = _nan_framed(torch.zeros((G, TM, W), dtype=torch.float64, device=dev), 1)
    ws = torch.zeros(G, dtype=torch.int32, device=dev)
    seq = torch.arange(G + 1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16 bytes"):
        spmm_pallas.spmm_window_sg(ws, tiles, b, min_b_rows=W)
    with pytest.raises(ValueError, match="16 bytes"):
        spmm_ragged.spmm_ragged(seq[:-1], seq, ws, tiles, b, min_b_rows=W)
    c = torch.empty((G * TM, 16), dtype=torch.float64, device=dev)
    assert _build.entry("crp_window_sg_f64")(
        ws.data_ptr(), tiles.data_ptr(), b.data_ptr(), c.data_ptr(), G, TM, W, 16, None) != 0
    aligned = torch.zeros((G, TM, W), dtype=torch.float64, device=dev)
    assert _build.entry("crp_ragged_f64")(
        None, ws.data_ptr(), aligned.data_ptr(), b.data_ptr(), c.data_ptr(), G, TM, W, 16,
        None) != 0
    torch.cuda.synchronize(dev)  # no launch was made: nothing is left to fail


# --------------------------------- #4 and #12 on fp64: the DMMA body too

def _f64_halo_case(dev, n, off=0, seed=93):
    """A 4-shard fp64 halo plan whose last windows run past the matrix
    (dead chunks) and its stacked B, NaN-framed ``off`` elements in (an odd
    ``off`` takes every chunk's rows off 16 bytes: 8-byte B copies)."""
    a = banded_random_csr(5000, nnz_per_row=7, bandwidth=300, seed=seed)
    d = csr_row_partition(a.rowptr, 4)
    aligned = spmm_halo.align_displs(d, a.ncol)
    shards = [a.row_slice(int(d[i]), int(d[i + 1])) for i in range(4)]
    arrays, op = spmm_halo.build_halo_plan(shards, aligned, device=dev, dtype=np.float64)
    b = fill_b(0, a.ncol, 0, n)
    bs = np.zeros((4, op.min_b_rows, n))
    for i in range(4):
        bs[i, : aligned[i + 1] - aligned[i]] = b[aligned[i]:aligned[i + 1]]
    return a, d, arrays, op, _nan_framed(torch.from_numpy(bs).to(dev), off)


@pytest.mark.parametrize("n", [16, 37, 100, 256])
def test_f64_window_multishard_equals_window_sg(cuda_device, n):
    """#4 on fp64 (``crp_window_f64``) on a 4-shard pack (pad groups, an
    empty shard) launches the DMMA body's windowed walk, the instantiation
    of #3's fp64 entry: on the same arrays its C equals
    ``spmm_window_sg``'s bit for bit and a second launch's, within 1e-12
    of the plain version, pad rows zero; odd n and a B off 16 bytes take
    the 8-byte B copies."""
    a = banded_random_csr(6000, nnz_per_row=7, bandwidth=80, seed=92)
    shards, max_m = _window_shards(a, 4)
    arrays, op = _pack_window(shards, max_m + 300, np.float64, "highest", cuda_device)
    assert op.variant == "window" and arrays[1].dtype == torch.float64
    for off in (0, 1):
        rB = _nan_framed(torch.from_numpy(_b(a, op.min_b_rows, n, np.float64)).to(
            cuda_device), off)
        for i in range(4):
            ws, tiles = (x[i] for x in arrays)
            before = spmm_pallas.spmm_window.launches
            k4 = spmm_pallas.spmm_window(ws, tiles, rB, "highest", min_b_rows=op.min_b_rows)
            again = spmm_pallas.spmm_window(ws, tiles, rB, "highest",
                                            min_b_rows=op.min_b_rows)
            assert spmm_pallas.spmm_window.launches == before + 2
            k3 = spmm_pallas.spmm_window_sg(ws, tiles, rB, min_b_rows=op.min_b_rows)
            assert _bits_equal(k4, k3) and _bits_equal(k4, again), (n, off, i)
            p = spmm_pallas.spmm_window_plain(ws, tiles, rB, "highest")
            assert float((k4 - p).norm()) <= 1e-12 * max(float(p.norm()), 1e-300)
            nrow = len(shards[i][0]) - 1 if len(shards[i][1]) else 0
            assert not torch.any(k4[nrow:])


@pytest.mark.parametrize("n", [16, 37, 100, 256])
def test_f64_halo_equals_window_per_shard(cuda_device, n):
    """#12 on fp64 (``crp_halo_f64``: the DMMA body's windowed walk with B
    through the chunk table) over 4 shards in one launch: each shard's C
    equal bit for bit to #4 on fp64 on the plain version's window buffers
    (one accumulator chain a C element, k upward, in both) and to a second
    launch; within 1e-12 of the plain version; rows past each shard's own
    zero; dead chunks (past the matrix) read as zeros, and B off 16 bytes
    (``rows16`` false: 8-byte copies) gives the same bits."""
    a, d, arrays, op, bs = _f64_halo_case(cuda_device, n)
    dead = int((arrays[-1][:, 0] < 0).sum())
    assert dead > 0
    got = {}
    for off in (0, 1):
        if off:
            bs = _nan_framed(bs.contiguous(), off)
        args = op.kernel_args(arrays, bs)
        assert spmm_halo.stacked_chunk_rows(args[4], args[5])[1] == (off == 0)
        before = spmm_halo.spmm_halo.launches
        k = op.kernel(*args, min_b_rows=op.min_b_rows)
        again = op.kernel(*args, min_b_rows=op.min_b_rows)
        assert spmm_halo.spmm_halo.launches == before + 2 and _bits_equal(k, again)
        p = op.plain(*args)
        assert float((k - p).norm()) <= 1e-12 * float(p.norm())
        buf = spmm_halo.halo_buffers(args[3], args[5], op.buf_rows)
        for i in range(4):
            c4 = spmm_pallas.spmm_window(args[1][i], args[2][i], buf[i], "highest",
                                         min_b_rows=op.buf_rows)
            assert _bits_equal(c4, k[i]), (n, off, i)
            assert not torch.any(k[i, d[i + 1] - d[i]:])
        got[off] = k
    assert _bits_equal(got[0], got[1])


def test_f64_multishard_entries_refuse_what_the_body_cannot_take(cuda_device):
    """#4's and #12's fp64 entries take what the DMMA body takes: the
    wrappers raise on TM = 64, W = 48 and panels off 16 bytes (no fallback
    to another body or the plain version), and the entries return an error
    there, and under the flags on a pairs' table off 16 bytes."""
    from crp_tpu_torch.kernels import _build

    dev = cuda_device
    _, _, arrays, op, bs = _f64_halo_case(dev, 16)
    ws, ws_rel, panels, push, chunk_src = arrays
    for TM, W in ((64, 128), (128, 48)):
        tiles = torch.zeros((2, TM, W), dtype=torch.float64, device=dev)
        w2 = torch.zeros(2, dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="TM % 128"):
            spmm_pallas.spmm_window(w2, tiles, bs[0], "highest", min_b_rows=W)
        bad = torch.zeros((4, 2, TM, W), dtype=torch.float64, device=dev)
        with pytest.raises(ValueError, match="TM % 128"):
            spmm_halo.spmm_halo(ws[:, :2].contiguous(), ws_rel[:, :2].contiguous(), bad,
                                push, chunk_src, bs, "highest", op.buf_rows,
                                min_b_rows=op.min_b_rows)
        c = torch.empty((2 * TM, 16), dtype=torch.float64, device=dev)
        assert _build.entry("crp_window_f64")(
            w2.data_ptr(), tiles.data_ptr(), bs.data_ptr(), c.data_ptr(), 2, TM, W, 16,
            None) != 0
        assert _build.entry("crp_halo_f64")(
            bs.data_ptr(), w2.data_ptr(), tiles.data_ptr(), c.data_ptr(), 2, TM, W, 16, 1,
            None) != 0
    off = _nan_framed(panels.contiguous(), 1)
    with pytest.raises(ValueError, match="16 bytes"):
        spmm_pallas.spmm_window(ws[0], off[0], bs[0], "highest", min_b_rows=op.min_b_rows)
    with pytest.raises(ValueError, match="16 bytes"):
        spmm_halo.spmm_halo(ws, ws_rel, off, push, chunk_src, bs, "highest", op.buf_rows,
                            min_b_rows=op.min_b_rows)
    G, TM, W = panels.shape[0] * panels.shape[1], op.TM, op.W
    c = torch.empty((G * TM, 16), dtype=torch.float64, device=dev)
    rows, _ = spmm_halo.stacked_chunk_rows(chunk_src, bs)
    assert _build.entry("crp_window_f64")(
        ws[0].data_ptr(), off[0].data_ptr(), bs.data_ptr(), c.data_ptr(), panels.shape[1],
        TM, W, 16, None) != 0
    assert _build.entry("crp_halo_f64")(
        rows.data_ptr(), ws.data_ptr(), off.data_ptr(), c.data_ptr(), G, TM, W, 16, 1,
        None) != 0
    pairs = torch.zeros(2 * rows.numel() + 1, dtype=torch.int64, device=dev)
    status = torch.zeros(1, dtype=torch.int64, pin_memory=True)
    assert _build.entry("crp_halo_f64_flags")(
        pairs[1:].data_ptr(), ws.data_ptr(), panels.data_ptr(), c.data_ptr(),
        status.data_ptr(), G, TM, W, 16, 1, 1, 10**9, None) != 0
    torch.cuda.synchronize(dev)  # no launch was made: nothing is left to fail


def _anti_banded(nrow, dtype, seed=7):
    """Band along the anti-diagonal: window starts fall group by group, so
    the shard has no super-group plan."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(nrow), 5)
    cols = np.clip(nrow - 1 - rows + rng.integers(-30, 31, rows.size), 0, nrow - 1)
    key = np.unique(rows * nrow + cols)
    return CSRMatrix.from_coo(nrow, nrow, key // nrow, key % nrow,
                              rng.standard_normal(key.size), dtype=dtype)


def _window_shards(a, p):
    """``a`` cut into p nnz-balanced row shards, the middle one emptied."""
    d = csr_row_partition(a.rowptr, p)
    shards = []
    for i in range(p):
        s = a.row_slice(int(d[i]), int(d[i + 1]))
        if p > 2 and i == p // 2:
            shards.append((np.zeros(s.nrow + 1, np.int64), np.zeros(0, np.int32),
                           np.zeros(0, s.val.dtype)))
        else:
            shards.append((s.rowptr, s.colidx.astype(np.int32), s.val))
    return shards, int(np.diff(d).max())


@pytest.mark.parametrize("prec,dtype,tol_ref", POINTS)
@pytest.mark.parametrize("case", ["4 shards", "non-monotone"])
def test_window_kernel_matches_plain(cuda_device, prec, dtype, tol_ref, case):
    """Kernel #4 on a multi-shard pack (pad groups, an empty shard) and on a
    single-shard pack with no super-group plan, at every point and odd n:
    within TOL_PLAIN of its plain version (the same exact products summed
    in another order), pad rows and the empty shard zero."""
    if case == "4 shards":
        a = banded_random_csr(6000, nnz_per_row=7, bandwidth=80, seed=91, dtype=dtype)
        shards, max_m = _window_shards(a, 4)
    else:
        a = _anti_banded(3000, dtype)
        shards, max_m = _window_shards(a, 1)
    arrays, op = _pack_window(shards, max_m + 300, dtype, prec, cuda_device)
    assert op.variant == "window" and op.kernel is spmm_pallas.spmm_window
    for n in (16, 100, 256):
        rB = torch.from_numpy(_b(a, op.min_b_rows, n, dtype)).to(cuda_device)
        for i in range(len(shards)):
            args = op.kernel_args(tuple(x[i] for x in arrays), rB)
            before = spmm_pallas.spmm_window.launches
            k = op.kernel(*args, min_b_rows=op.min_b_rows)
            assert spmm_pallas.spmm_window.launches == before + 1
            p = op.plain(*args)
            assert k.dtype == p.dtype and k.shape == p.shape
            assert bool(torch.isfinite(k).all())
            scale = max(float(p.abs().max()), 1e-30)
            assert float((k - p).abs().max()) / scale <= TOL_PLAIN[dtype]
            nrow = len(shards[i][0]) - 1 if len(shards[i][1]) else 0
            assert not torch.any(k[nrow:])  # pad groups, empty shard: zero


def test_exchange_p4_matches_host_gather(cuda_device):
    """The p = 4 a2a exchange on the card: every receive-buffer row a
    shard's A references holds that global B row (a host numpy gather)."""
    a = powerlaw_community_csr(20000, 16, 1024, seed=3)
    p, n = 4, 40
    d = csr_row_partition(a.rowptr, p)
    bd = d.copy()
    bd[-1] = a.ncol
    cols = [a.colidx[a.rowptr[d[i]]:a.rowptr[d[i + 1]]] for i in range(p)]
    plan = build_b_exchange(cols, bd)
    max_k = int(np.diff(bd).max())
    rb_rows = plan.rB_nrow_max + 128  # a real row past the plan's
    b = np.random.default_rng(0).standard_normal((a.ncol, n))
    bs = np.zeros((p, max_k, n))
    for i in range(p):
        bs[i, : bd[i + 1] - bd[i]] = b[bd[i]:bd[i + 1]]
    t = exchange_tables(plan, max_k, rb_rows, cuda_device)
    rB = exchange_b(torch.from_numpy(bs).to(cuda_device), t).cpu().numpy()
    for i in range(p):
        rows = plan.rowmap[i]
        np.testing.assert_array_equal(rB[i, : len(rows)], b[rows])
        assert not np.any(rB[i, len(rows):])


def _card_and_cpu(a, p, n, cfg, cuda_device, dtype=np.float32, cpu_cfg=None):
    """The same engine over p nnz-balanced shards on the card and on the
    CPU, and C of each."""
    d = csr_row_partition(a.rowptr, p)
    b = fill_b(0, a.ncol, 0, n, dtype=dtype)
    gpu = RowParaSpmm(a, d, d, n, device=cuda_device, config=SpmmConfig(**cfg),
                      dtype=dtype)
    a.__dict__.pop("_torch_pack_cache", None)
    cpu = RowParaSpmm(a, d, d, n, device="cpu", config=SpmmConfig(**(cpu_cfg or cfg)),
                      dtype=dtype)
    return gpu, cpu, b


def _each_shard_matches_plain(op, packed, rBs, tol, nrows):
    """The op's kernel against its plain version on every shard of a
    multi-shard pack (relative Frobenius within ``tol``), rows past each
    shard's own zero, one launch each."""
    for i, rB in enumerate(rBs):
        arrs = tuple(x[i] for x in packed)
        args = op.kernel_args(arrs, rB)
        before = op.kernel.launches
        k = (op.kernel(*args) if op.variant == "gather"
             else op.kernel(*args, min_b_rows=op.min_b_rows))
        assert op.kernel.launches == before + 1
        p = op.plain(*args)
        assert k.shape == p.shape and bool(torch.isfinite(k).all())
        scale = max(float(p.double().norm()), 1e-300)
        assert float((k - p).double().norm()) / scale <= tol
        assert not torch.any(k[nrows[i]:])


@pytest.mark.parametrize("n", [16, 100, 256])
@pytest.mark.parametrize("prec,dtype,tol_ref", POINTS)
def test_halo_kernel_matches_plain(cuda_device, prec, dtype, tol_ref, n):
    """The fused halo kernel over 4 shards in one launch (each reading its
    windows from the owners' rows) against its plain version (the pushes
    into window buffers, then the windowed product): within TOL_PLAIN,
    rows past each shard's own zero, and the product in the point's
    class."""
    a = banded_random_csr(6000, nnz_per_row=7, bandwidth=300, seed=97, dtype=dtype)
    d = csr_row_partition(a.rowptr, 4)
    aligned = spmm_halo.align_displs(d, a.ncol)
    shards = [a.row_slice(int(d[i]), int(d[i + 1])) for i in range(4)]
    arrays, op = spmm_halo.build_halo_plan(shards, aligned, device=cuda_device,
                                           dtype=dtype, precision=prec)
    b = fill_b(0, a.ncol, 0, n, dtype=dtype)
    bs = np.zeros((4, op.min_b_rows, n), dtype)
    for i in range(4):
        bs[i, : aligned[i + 1] - aligned[i]] = b[aligned[i]:aligned[i + 1]]
    args = op.kernel_args(arrays, torch.from_numpy(bs).to(cuda_device))
    before = spmm_halo.spmm_halo.launches
    k = op.kernel(*args, min_b_rows=op.min_b_rows)
    assert spmm_halo.spmm_halo.launches == before + 1
    p = op.plain(*args)
    assert k.dtype == p.dtype and k.shape == p.shape == (4, op.G * op.TM, n)
    assert bool(torch.isfinite(k).all())
    assert float((k - p).abs().max()) / float(p.abs().max()) <= TOL_PLAIN[dtype]
    kc = k.cpu().numpy()
    for i in range(4):
        assert not np.any(kc[i, d[i + 1] - d[i]:])
    got = np.concatenate([kc[i, : d[i + 1] - d[i]] for i in range(4)])
    assert rel_fro_err(a.spmm_ref(b.astype(np.float64)), got) <= tol_ref


@pytest.mark.parametrize("prec", ["x3", "default", "highest"])
def test_halo_engine_on_card_matches_engine_on_cpu(cuda_device, prec):
    """``auto`` at p = 4 on the card resolves to the fused kernel, which
    launches once per exec and agrees with the CPU engine's plain version."""
    a = banded_random_csr(8000, nnz_per_row=7, bandwidth=200, seed=98,
                          dtype=np.float32)
    gpu, cpu, b = _card_and_cpu(a, 4, 48, dict(kernel="auto", mxu_precision=prec),
                                cuda_device,
                                cpu_cfg=dict(kernel="pallas_halo", mxu_precision=prec))
    assert gpu.kernel_kind == cpu.kernel_kind == "pallas_halo"
    before = spmm_halo.spmm_halo.launches
    c_gpu = gpu.exec(b)
    assert spmm_halo.spmm_halo.launches == before + 1
    assert gpu.physical_rows == cpu.physical_rows and gpu.rB_recv_size == cpu.rB_recv_size
    assert rel_fro_err(cpu.exec(b).astype(np.float64), c_gpu) <= 1e-6


def _ragged_shards(a, p):
    """``a`` in p nnz-balanced row shards with global columns, the second
    emptied; their row counts (0 for the empty one)."""
    d = csr_row_partition(a.rowptr, p)
    shards, nrows = [], []
    for i in range(p):
        s = a.row_slice(int(d[i]), int(d[i + 1]))
        if i == 1:
            shards.append((np.zeros(s.nrow + 1, np.int64), np.zeros(0, np.int32),
                           np.zeros(0, s.val.dtype)))
            nrows.append(0)
        else:
            shards.append((s.rowptr, s.colidx.astype(np.int32), s.val))
            nrows.append(s.nrow)
    return shards, nrows, int(np.diff(d).max())


@pytest.mark.parametrize("prec,dtype,tol_ref", POINTS)
def test_multi_shard_ragged_matches_plain(cuda_device, prec, dtype, tol_ref):
    """A 4-shard ragged pack with a spill and an empty shard: on every
    shard the ragged kernel against its plain version (each shard's own
    step range), the fused spill kernel (fp32) against its plain version,
    and the whole product in the point's class."""
    a = powerlaw_community_csr(24000, 16, 1024, seed=99, dtype=dtype)
    shards, nrows, max_m = _ragged_shards(a, 4)
    arrays, op = _pack_ragged(shards, max_m + 300, dtype, prec, cuda_device,
                              geometry=(256, 256), min_chunk_nnz=60,
                              spill_impl="pallas")
    assert op.variant == "ragged" and op.roofline["spill_nnz"] > 0
    b = fill_b(0, a.ncol, 0, 100, dtype=dtype)
    rB = torch.from_numpy(_b(a, max(op.min_b_rows, a.ncol), 100, dtype)).to(cuda_device)
    _each_shard_matches_plain(op, arrays, [rB] * 4, TOL_PLAIN_FRO[dtype], nrows)
    ref = a.spmm_ref(b.astype(np.float64))
    d = csr_row_partition(a.rowptr, 4)
    for i in range(4):
        arrs = tuple(x[i] for x in arrays)
        if op.spill_impl == "pallas":  # fp32; fp64 spills through index_add_
            c_plain = op.plain(*op.kernel_args(arrs, rB))
            s_args = op.spill_args(arrs, c_plain, rB)
            k = op.spill_kernel(*s_args)
            p = op.spill_plain(*s_args)
            assert float((k - p).double().norm()
                         / max(float(p.double().norm()), 1e-300)) <= 1e-6
        c = op(arrs, rB)[: nrows[i]].double().cpu().numpy()
        if nrows[i]:
            assert rel_fro_err(ref[d[i]:d[i + 1]], c) <= tol_ref


@pytest.mark.parametrize("prec,dtype,tol_ref", POINTS)
def test_multi_shard_ragged_engine_on_card(cuda_device, prec, dtype, tol_ref):
    """cplaw-class graph at p = 4, kernel="pallas": the card's engine takes
    the multi-shard ragged pack, launches the ragged kernel once per shard
    (and the fused spill, fp32), and agrees with the CPU engine to the
    point's class (the card rounds the spill per point, the CPU adds it in
    exact fp32)."""
    a = powerlaw_community_csr(65536, 16, 1024, seed=7, dtype=dtype)
    gpu, cpu, b = _card_and_cpu(a, 4, 48, dict(kernel="pallas", mxu_precision=prec,
                                               rb_p2p=1), cuda_device, dtype=dtype)
    op = gpu._local_op
    assert op.variant == cpu._local_op.variant == "ragged"
    fused = op.spill_impl == "pallas"
    assert fused == (dtype == np.float32)
    before = (op.kernel.launches, op.spill_kernel.launches)
    c_gpu = gpu.exec(b)
    assert (op.kernel.launches - before[0],
            op.spill_kernel.launches - before[1]) == (4, 4 if fused else 0)
    ref = a.spmm_ref(b.astype(np.float64))
    assert rel_fro_err(ref, c_gpu) <= tol_ref
    assert rel_fro_err(cpu.exec(b).astype(np.float64), c_gpu) <= tol_ref


@pytest.mark.parametrize("p", [2, 4])
def test_multi_shard_dd_mxu(cuda_device, p):
    """dd_mxu over p shards: the FP64 tensor-core kernel against its plain
    version on every shard, and the card's engine against the CPU engine
    and the reference at 1e-12."""
    a = banded_random_csr(6000, nnz_per_row=9, bandwidth=300, seed=100)
    shards, nrows, max_m = _ragged_shards(a, p)
    arrays, op = _pack_dd_mxu(shards, max_m + 300, cuda_device)
    rB = torch.from_numpy(_b(a, max(op.min_b_rows, a.ncol), 48, np.float64)).to(cuda_device)
    _each_shard_matches_plain(op, arrays, [rB] * p, 1e-12, nrows)
    gpu, cpu, b = _card_and_cpu(a, p, 48, dict(kernel="dd_mxu"), cuda_device,
                                dtype=np.float64)
    assert gpu._local_op.variant == cpu._local_op.variant == "dd_mxu"
    before = spmm_dd_mxu.spmm_ragged_dd.launches
    c_gpu = gpu.exec(b)
    assert spmm_dd_mxu.spmm_ragged_dd.launches == before + p
    assert rel_fro_err(a.spmm_ref(b), c_gpu) <= 1e-12
    assert rel_fro_err(cpu.exec(b), c_gpu) <= 1e-12


def test_multi_shard_gather(cuda_device):
    """The gather kind over 4 shards (one empty): its kernel against its
    plain version on every shard, and the card's engine against the CPU
    engine."""
    a = powerlaw_community_csr(20000, 16, 1024, seed=13, permute=True,
                               dtype=np.float32)
    shards, nrows, max_m = _ragged_shards(a, 4)
    arrays, op = _pack_gather(shards, max_m + 300, np.float32, "x3", cuda_device)
    rB = torch.from_numpy(_b(a, a.ncol, 64, np.float32)).to(cuda_device)
    _each_shard_matches_plain(op, arrays, [rB] * 4, 1e-6, nrows)
    gpu, cpu, b = _card_and_cpu(a, 4, 48, dict(kernel="gather", mxu_precision="x3"),
                                cuda_device)
    assert gpu.kernel_kind == cpu.kernel_kind == "gather"
    before = spmm_ragged.spmm_gather.launches
    c_gpu = gpu.exec(b)
    assert spmm_ragged.spmm_gather.launches == before + 4
    assert rel_fro_err(a.spmm_ref(b.astype(np.float64)), c_gpu) <= 1e-5
    assert rel_fro_err(cpu.exec(b).astype(np.float64), c_gpu) <= 1e-5


# ------------------- #4 and #12 at highest: 3xTF32 (#4, #3 on wgmma's TF32 mode)


def _nan_framed(x, before, after=1000):
    """``x`` as a contiguous view into a larger tensor whose other elements
    are NaN, starting ``before`` elements in: a read outside ``x`` shows as
    NaN in C, and an odd ``before`` takes B's first row off 16 bytes."""
    flat = torch.full((before + x.numel() + after,), float("nan"), dtype=x.dtype,
                      device=x.device)
    flat[before: before + x.numel()] = x.reshape(-1)
    return flat[before: before + x.numel()].view(x.shape)


def _panels(rng, shape):
    """Random fp32 panels with about 12 nonzeros a row, as the packs' rows
    hold a few nonzeros each: sums as long as the matrices' (dense random
    rows of 1024 would put fp32's own rounding of the plain version near
    TOL_PLAIN)."""
    keep = rng.random(shape) < 12 / shape[-1]
    return (rng.standard_normal(shape) * keep).astype(np.float32)


def _planes(tiles):
    """fp32 (G, TM, W) panels -> the TF32 planes ``(2, G, TM, W)`` that #3
    and #4 take at highest (split on the tensors' device, as the packs
    split them)."""
    return device_pack.tf32_planes(tiles[None])[0]


def _pair(tiles):
    """fp32 panels -> the TF32 planes ``(big, small)``, two tensors of the
    panels' shape, as #12 and #6 take them at highest (split on the
    tensors' device, as the packs split them)."""
    return device_pack.tf32_pair(tiles)


def _held_to_plain(k, p, launches_before, launches_now, zero_rows):
    assert launches_now == launches_before + 1
    assert k.shape == p.shape and k.dtype == p.dtype == torch.float32
    assert bool(torch.isfinite(k).all())
    assert float((k - p).abs().max()) / float(p.abs().max()) <= TOL_PLAIN[np.float32]
    assert not torch.any(k[zero_rows])


# name -> (G, TM, W, n, B offset in elements): odd n takes the 4-byte B
# copies; one 32-row slice is shorter than the ring; 32 slices run the
# ring round many times; an unaligned B takes the 4-byte copies at n % 4 == 0
TF32X3_WINDOW = {
    "odd n": (5, 256, 256, 37, 0),
    "one slice": (3, 128, 32, 64, 0),
    "past the ring": (4, 256, 1024, 100, 0),
    "unaligned B": (3, 128, 160, 64, 1),
}


# the 3xTF32 windowed kernels on a uniform pack: #4 and #3 (super-grouped)
# at highest, each beside its plain version; both take the TF32 planes
TF32X3_UNIFORM = {
    "window": (lambda ws, t, b, **kw: spmm_pallas.spmm_window(ws, t, b, "highest", **kw),
               lambda ws, t, b: spmm_pallas.spmm_window_plain(ws, t, b, "highest"),
               spmm_pallas.spmm_window),
    "window_sg": (spmm_pallas.spmm_window_sg, spmm_pallas.spmm_window_sg_plain,
                  spmm_pallas.spmm_window_sg),
}


@pytest.mark.parametrize("kernel", sorted(TF32X3_UNIFORM))
@pytest.mark.parametrize("case", sorted(TF32X3_WINDOW))
def test_window_highest_tf32x3_matches_plain(cuda_device, case, kernel):
    """#4 and #3 at highest on hand-built uniform packs (random panels, the
    last group a zero pad group, B framed by NaN; the kernels on their TF32
    planes): within TOL_PLAIN of the fp32 plain version, pad rows zero,
    one launch."""
    run, plain, counted = TF32X3_UNIFORM[kernel]
    G, TM, W, n, off = TF32X3_WINDOW[case]
    rng = np.random.default_rng(W + n)
    ws = rng.integers(0, 300, G).astype(np.int32)
    tiles = _panels(rng, (G, TM, W))
    tiles[-1] = 0
    rows = int(ws.max()) + W
    dev = cuda_device
    b = _nan_framed(torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32))
                    .to(dev), off)
    ws_t, tiles_t = torch.from_numpy(ws).to(dev), torch.from_numpy(tiles).to(dev)
    before = counted.launches
    k = run(ws_t, _planes(tiles_t), b, min_b_rows=rows)
    _held_to_plain(k, plain(ws_t, tiles_t, b), before, counted.launches,
                   slice((G - 1) * TM, None))


def _halo_hand_pack(rng, W, n, displs=(0, 256, 640, 768, 1152)):
    """A halo pack by hand, by default of 4 shards: uneven 128-aligned
    ownership ``displs`` (256, 384, 128 and 384 rows of a 1152-row B, so
    the chunk table is no identity; (owner, row) pairs), 3 groups of 128 rows a shard at
    128-aligned window starts, the last groups' running past the matrix
    (dead chunks, -1) where W > 128, and the last shard's first window
    wholly past it.  Shard 1's last group is a zero pad group.  Returns the
    wrapper's arguments; B's pad rows are NaN (never read)."""
    displs = np.asarray(displs)
    p, G, TM = len(displs) - 1, 3, 128
    k_glb, max_k = int(displs[-1]), int(np.diff(displs).max())
    ws = rng.integers(0, k_glb // 128, (p, G)) * 128
    ws[:, -1] = k_glb - 128  # the last 128 rows, then dead chunks when W > 128
    ws[p - 1, 0] = k_glb
    rows = np.arange(-(-(int(ws.max()) + W) // 128)) * 128
    j = np.minimum(np.searchsorted(displs, rows, side="right") - 1, p - 1)
    chunk_src = np.stack([np.where(rows < k_glb, j, -1),
                          np.where(rows < k_glb, rows - displs[j], 0)], axis=1)
    lo = ws.min(axis=1)
    ws_rel = ws - lo[:, None]
    buf_rows = -(-(int(ws_rel.max()) + W) // 128) * 128
    push = []
    for i in range(p):  # every live chunk of shard i's buffer, from its owner
        for r in range(int(lo[i]), min(int(lo[i]) + buf_rows, k_glb), 128):
            o = int(np.searchsorted(displs, r, side="right") - 1)
            push.append((o, r - displs[o], i, r - lo[i]))
    panels = _panels(rng, (p, G, TM, W))
    panels[1, -1] = 0
    b = rng.standard_normal((k_glb, n)).astype(np.float32)
    bs = np.full((p, max_k, n), np.nan, np.float32)
    for i in range(p):
        bs[i, : displs[i + 1] - displs[i]] = b[displs[i]:displs[i + 1]]
    assert (chunk_src[:, 0] == -1).any()
    return ws, ws_rel, panels, np.array(push), chunk_src, bs, buf_rows, max_k


# name -> (W, n, B offset in elements)
TF32X3_HALO = {
    "n=16": (160, 16, 0),
    "odd n": (256, 37, 0),
    "one slice": (32, 64, 0),
    "past the ring": (640, 100, 0),
    "n=256": (512, 256, 0),
    "unaligned B": (384, 64, 1),
    "unaligned B, n=100": (256, 100, 1),
}


@pytest.mark.parametrize("case", sorted(TF32X3_HALO))
def test_halo_highest_tf32x3_matches_plain(cuda_device, case):
    """#12 at highest (the wgmma body's TF32 mode with the chunk lookup, on
    the TF32 planes) on hand-built packs: 32-row slices crossing 128-row
    ownership chunks (uneven owners), dead chunks read as zeros (B framed
    by NaN), n in {16, 37, 64, 100, 256}, B off 16 bytes, one slice, many
    trips round the ring: within TOL_PLAIN of the plain version (pushes,
    then the fp32 windowed product), pad rows zero, one launch; a window
    wholly past the matrix gives zeros.  A second launch, #4 run shard by
    shard on the same planes with the plain version's window buffers, and
    the flagged entry (each owner's shard its own allocation, every owner
    arrived) all equal it bit for bit."""
    W, n, off = TF32X3_HALO[case]
    ws, ws_rel, panels, push, chunk_src, bs, buf_rows, max_k = _halo_hand_pack(
        np.random.default_rng(W + n), W, n)
    dev = cuda_device

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)

    big, small = _pair(torch.from_numpy(panels).to(dev))
    b = _nan_framed(torch.from_numpy(bs).to(dev), off)
    args = (put(ws), put(ws_rel), (big, small), put(push), put(chunk_src), b, "highest",
            buf_rows)
    before = spmm_halo.spmm_halo.launches
    k = spmm_halo.spmm_halo(*args, min_b_rows=max_k)
    p = spmm_halo.spmm_halo_plain(*args)
    _held_to_plain(k[1], p[1], before, spmm_halo.spmm_halo.launches,
                   slice(2 * 128, None))
    for i in (0, 2, 3):
        assert float((k[i] - p[i]).abs().max()) <= TOL_PLAIN[np.float32] * float(
            p.abs().max())
    assert not torch.any(k[3, :128]) and not torch.any(p[3, :128])
    again = spmm_halo.spmm_halo(*args, min_b_rows=max_k)
    assert torch.equal(k.view(torch.int32), again.view(torch.int32))
    buf = spmm_halo.halo_buffers(args[3], b, buf_rows)
    for i in range(k.shape[0]):
        c4 = spmm_pallas.spmm_window(args[1][i], torch.stack((big[i], small[i])), buf[i],
                                     "highest", min_b_rows=buf_rows)
        assert torch.equal(k[i].view(torch.int32), c4.view(torch.int32))
    owners = [torch.from_numpy(bs[i]).to(dev) for i in range(bs.shape[0])]
    peers = _LocalOwners(owners, args[4], 1, 30.0)
    flagged = spmm_halo.spmm_halo(*args[:5], peers.buf, *args[6:], min_b_rows=max_k,
                                  peers=peers)
    assert torch.equal(flagged.view(torch.int32), k.view(torch.int32))
    torch.cuda.synchronize()
    peers.check()


@pytest.mark.parametrize("kernel", ["halo", "ragged"])
def test_halo_and_ragged_highest_keep_nan_and_inf(cuda_device, kernel):
    """#12 and #6 at highest with NaN (CUDA's canonical 0x7fffffff, a quiet
    0x7fc00000, a negative payload) and +-inf in the panels and in B: C is
    NaN wherever the plain version is NaN, not finite wherever it is inf,
    and within TOL_PLAIN of it elsewhere (the planes split on the card, as
    the packs are)."""
    rng = np.random.default_rng(9)
    dev = cuda_device
    tiles = torch.from_numpy(_panels(rng, (2, 128, 64))).to(dev)
    b = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32)).to(dev)
    ti, bi = tiles.view(torch.int32), b.view(torch.int32)
    ti[0, 3, 5], ti[0, 7, 9], ti[1, 11, 2] = 0x7FFFFFFF, 0x7FC00000, -1
    tiles[1, 20, 30], tiles[1, 21, 31] = float("inf"), -float("inf")
    bi[40, 7], bi[41, 8] = 0x7FFFFFFF, -1
    b[170, 9] = float("inf")
    pair = _pair(tiles)
    if kernel == "halo":  # one shard owning all of B, windows at rows 0 and 128
        ws = torch.tensor([[0, 128]], dtype=torch.int32, device=dev)
        chunk_src = torch.tensor([[0, 0], [0, 128]], dtype=torch.int32, device=dev)
        push = torch.tensor([[0, 0, 0, 0], [0, 128, 0, 128]], dtype=torch.int32, device=dev)
        args = (ws, ws, tuple(t[None] for t in pair), push, chunk_src, b[None],
                "highest", 256)
        k = spmm_halo.spmm_halo(*args, min_b_rows=256)[0]
        p = spmm_halo.spmm_halo_plain(*args)[0]
    else:  # one group walking both chunks, over B rows 0 and 128
        step_g = torch.tensor([0, 0], dtype=torch.int32, device=dev)
        group_ptr = torch.tensor([0, 2], dtype=torch.int32, device=dev)
        starts = torch.tensor([0, 128], dtype=torch.int32, device=dev)
        k = spmm_ragged.spmm_ragged(step_g, group_ptr, starts, pair, b, min_b_rows=256)
        p = spmm_ragged.spmm_ragged_plain(step_g, group_ptr, starts, pair, b)
    assert bool(torch.isnan(k[torch.isnan(p)]).all())
    assert not bool(torch.isfinite(k[torch.isinf(p)]).any())
    fin = torch.isfinite(p)
    assert bool(torch.isfinite(k[fin]).all())
    assert float((k - p)[fin].abs().max()) <= TOL_PLAIN[np.float32] * float(p[fin].abs().max())


def test_highest_wrappers_launch_the_kernel_or_raise(cuda_device, monkeypatch):
    """On CUDA tensors #4, #12 and #6 at highest launch their kernel and
    never their plain versions; a launch the kernel refuses (#4's TF32
    planes off 16 bytes) raises, and fp32 panels that are not the planes,
    and #12's and #6's planes off 16 bytes, are refused before any launch,
    with nothing to fall back to."""
    def no_plain(*args, **kw):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(spmm_pallas, "spmm_window_plain", no_plain)
    monkeypatch.setattr(spmm_halo, "spmm_halo_plain", no_plain)
    monkeypatch.setattr(spmm_ragged, "spmm_ragged_plain", no_plain)
    rng = np.random.default_rng(5)
    dev = cuda_device
    ws = torch.zeros(2, dtype=torch.int32, device=dev)
    tiles = _planes(torch.from_numpy(_panels(rng, (2, 128, 64))).to(dev))
    b = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32)).to(dev)
    before = spmm_pallas.spmm_window.launches
    spmm_pallas.spmm_window(ws, tiles, b, "highest", min_b_rows=64)
    assert spmm_pallas.spmm_window.launches == before + 1
    off = torch.empty(tiles.numel() + 1, device=dev)[1:].view(tiles.shape)
    off.copy_(tiles)
    with pytest.raises(RuntimeError, match="crp_window_f32"):
        spmm_pallas.spmm_window(ws, off, b, "highest", min_b_rows=64)
    with pytest.raises(ValueError, match="TF32 planes"):
        spmm_pallas.spmm_window(ws, tiles[0], b, "highest", min_b_rows=64)
    assert spmm_pallas.spmm_window.launches == before + 1
    hws, ws_rel, panels, push, chunk_src, bs, buf_rows, max_k = _halo_hand_pack(
        rng, 128, 16)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)

    halo = (put(hws), put(ws_rel), _pair(torch.from_numpy(panels).to(dev)), put(push),
            put(chunk_src), torch.from_numpy(bs).to(dev), "highest", buf_rows)
    before = spmm_halo.spmm_halo.launches
    spmm_halo.spmm_halo(*halo, min_b_rows=max_k)
    assert spmm_halo.spmm_halo.launches == before + 1
    with pytest.raises(ValueError, match="no kernel"):
        spmm_halo.spmm_halo(*halo[:2], halo[2][0], *halo[3:], min_b_rows=max_k)
    with pytest.raises(ValueError, match="must start on 16 bytes"):
        spmm_halo.spmm_halo(*halo[:2], (_nan_framed(halo[2][0], 1), halo[2][1]),
                            *halo[3:], min_b_rows=max_k)
    assert spmm_halo.spmm_halo.launches == before + 1
    pair = _pair(torch.from_numpy(_panels(rng, (2, 128, 64))).to(dev))
    step_g = torch.zeros(2, dtype=torch.int32, device=dev)
    group_ptr = torch.tensor([0, 2], dtype=torch.int32, device=dev)
    starts = torch.zeros(2, dtype=torch.int32, device=dev)
    before = spmm_ragged.spmm_ragged.launches
    spmm_ragged.spmm_ragged(step_g, group_ptr, starts, pair, b, min_b_rows=64)
    assert spmm_ragged.spmm_ragged.launches == before + 1
    with pytest.raises(ValueError, match="TF32"):
        spmm_ragged.spmm_ragged(step_g, group_ptr, starts, pair[0], b, min_b_rows=64)
    with pytest.raises(ValueError, match="big must start on 16 bytes"):
        spmm_ragged.spmm_ragged(step_g, group_ptr, starts,
                                (_nan_framed(pair[0], 1), pair[1]), b, min_b_rows=64)
    assert spmm_ragged.spmm_ragged.launches == before + 1


@pytest.mark.parametrize("kernel", sorted(TF32X3_UNIFORM))
def test_highest_tf32x3_keeps_nan_and_inf(cuda_device, kernel):
    """#4 and #3 at highest with NaN (CUDA's canonical 0x7fffffff, a quiet
    0x7fc00000, a negative payload) and +-inf in the panels and in B: C is
    NaN wherever the plain version is NaN, not finite wherever it is inf
    (an inf's remainder in the split is NaN, as in the x3 kernels'), and
    within TOL_PLAIN of it elsewhere."""
    rng = np.random.default_rng(8)
    dev = cuda_device
    tiles = torch.from_numpy(_panels(rng, (2, 128, 64))).to(dev)
    b = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32)).to(dev)
    ti, bi = tiles.view(torch.int32), b.view(torch.int32)
    ti[0, 3, 5], ti[0, 7, 9], ti[1, 11, 2] = 0x7FFFFFFF, 0x7FC00000, -1
    tiles[1, 20, 30], tiles[1, 21, 31] = float("inf"), -float("inf")
    bi[40, 7], bi[41, 8] = 0x7FFFFFFF, -1
    b[42, 9] = float("inf")
    ws = torch.zeros(2, dtype=torch.int32, device=dev)
    run, plain, _ = TF32X3_UNIFORM[kernel]
    k = run(ws, _planes(tiles), b, min_b_rows=64)  # split on the card, as the packs are
    p = plain(ws, tiles, b)
    assert bool(torch.isnan(k[torch.isnan(p)]).all())
    assert not bool(torch.isfinite(k[torch.isinf(p)]).any())
    fin = torch.isfinite(p)
    assert bool(torch.isfinite(k[fin]).all())
    assert float((k - p)[fin].abs().max()) <= TOL_PLAIN[np.float32] * float(p[fin].abs().max())


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("n", [16, 37, 100, 256])
def test_window_highest_wgmma_is_one_instantiation(cuda_device, n, off):
    """#3 and #4 at highest on the wgmma body's TF32 mode: on one uniform
    pack's TF32 planes (two pad groups, a window 5 slices deep, B off 16
    bytes where ``off``) each is within TOL_PLAIN of the fp32 plain version
    with its pad rows zero, a second launch equals the first bit for bit,
    and #4's C equals #3's bit for bit (one instantiation)."""
    G, TM, W = 6, 256, 160
    rng = np.random.default_rng(n + off)
    ws = rng.integers(0, 200, G).astype(np.int32)
    tiles = _panels(rng, (G, TM, W))
    tiles[-2:] = 0
    rows = int(ws.max()) + W
    dev = cuda_device
    b = _nan_framed(torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32))
                    .to(dev), off)
    ws_t, tiles_t = torch.from_numpy(ws).to(dev), torch.from_numpy(tiles).to(dev)
    planes = _planes(tiles_t)
    before = spmm_pallas.spmm_window_sg.launches
    k3 = spmm_pallas.spmm_window_sg(ws_t, planes, b, min_b_rows=rows)
    _held_to_plain(k3, spmm_pallas.spmm_window_sg_plain(ws_t, tiles_t, b), before,
                   spmm_pallas.spmm_window_sg.launches, slice((G - 2) * TM, None))
    again = spmm_pallas.spmm_window_sg(ws_t, planes, b, min_b_rows=rows)
    assert torch.equal(k3.view(torch.int32), again.view(torch.int32))
    k4 = spmm_pallas.spmm_window(ws_t, planes, b, "highest", min_b_rows=rows)
    assert torch.equal(k3.view(torch.int32), k4.view(torch.int32))


# ----------------------------------------- #1 and #5 on the wgmma body

# name -> (G, TM, W, n, B offset in elements): W = 352 and 160 end on half
# a 64-row stage; odd n and an unaligned B take the plain B copies; W = 32
# is one slice; W = 1024 runs the 3-stage ring round many times
X3_WGMMA = {
    "n=16": (3, 256, 352, 16, 0),
    "odd n": (3, 256, 352, 37, 0),
    "n=256": (4, 128, 1024, 256, 0),
    "unaligned B": (3, 128, 160, 64, 1),
    "one slice": (2, 128, 32, 48, 0),
}


def _x3_hand_pack(case, dev):
    """A uniform x3 pack by hand: random sparse panels split to bf16 hi/lo
    in RNE (the pack's split), random window starts, the last group a zero
    pad group, B framed by NaN (a read outside it shows in C)."""
    G, TM, W, n, off = X3_WGMMA[case]
    rng = np.random.default_rng(W + n)
    ws = torch.from_numpy(rng.integers(0, 300, G).astype(np.int32)).to(dev)
    tiles = _panels(rng, (G, TM, W))
    tiles[-1] = 0
    ah, al = spmm_pallas.split_b_bf16(torch.from_numpy(tiles).to(dev).view(G * TM, W))
    rows = int(ws.max()) + W
    b = _nan_framed(torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32))
                    .to(dev), off)
    return ws, ah.view(G, TM, W), al.view(G, TM, W), b, rows, tiles


@pytest.mark.parametrize("case", sorted(X3_WGMMA))
def test_x3_wgmma_matches_plain_and_pair(cuda_device, case):
    """#1 on hand-built packs (n in {16, 37, 48, 64, 256}, W off the
    64-row stage, an unaligned B, one slice, many trips round the ring):
    within TOL_PLAIN of its plain version, pad rows zero, one launch; #5
    on ``split_b_bf16`` of the same B (framed and off 16 bytes where B
    is) equal to #1's C bit for bit."""
    ws, ah, al, b, rows, _ = _x3_hand_pack(case, cuda_device)
    G, TM, _, _, off = X3_WGMMA[case]
    kernel = spmm_pallas.spmm_window_sg_presplit
    before = kernel.launches
    k = kernel(ws, ah, al, b, min_b_rows=rows)
    _held_to_plain(k, spmm_pallas.spmm_window_sg_presplit_plain(ws, ah, al, b), before,
                   kernel.launches, slice((G - 1) * TM, None))
    bh, bl = (_nan_framed(t, off) for t in spmm_pallas.split_b_bf16(b))
    before = spmm_pallas.spmm_window_sg_presplit_ab.launches
    c5 = spmm_pallas.spmm_window_sg_presplit_ab(ws, ah, al, bh, bl, min_b_rows=rows)
    assert spmm_pallas.spmm_window_sg_presplit_ab.launches == before + 1
    assert torch.equal(c5, k)


def test_window_sg_wrappers_launch_the_kernel_or_raise(cuda_device, monkeypatch):
    """On CUDA tensors #1, #5 and #3 launch their kernels and never their
    plain versions; panels off 16 bytes (the TMA and 16-byte copies' rule)
    are refused before any launch, with nothing to fall back to."""
    def no_plain(*args, **kw):
        raise AssertionError("the plain version ran on CUDA tensors")

    for name in ("spmm_window_sg_presplit_plain", "spmm_window_sg_presplit_ab_plain",
                 "spmm_window_sg_plain"):
        monkeypatch.setattr(spmm_pallas, name, no_plain)
    ws, ah, al, b, rows, tiles = _x3_hand_pack("one slice", cuda_device)
    bh, bl = spmm_pallas.split_b_bf16(b)
    tiles = _planes(torch.from_numpy(tiles).to(cuda_device))  # #3 at highest: the planes
    kernels = (spmm_pallas.spmm_window_sg_presplit, spmm_pallas.spmm_window_sg_presplit_ab,
               spmm_pallas.spmm_window_sg)
    before = [k.launches for k in kernels]
    spmm_pallas.spmm_window_sg_presplit(ws, ah, al, b, min_b_rows=rows)
    spmm_pallas.spmm_window_sg_presplit_ab(ws, ah, al, bh, bl, min_b_rows=rows)
    spmm_pallas.spmm_window_sg(ws, tiles, b, min_b_rows=rows)
    assert [k.launches for k in kernels] == [x + 1 for x in before]
    off_h, off_l, off_t = (_nan_framed(t, 1) for t in (ah, al, tiles))
    with pytest.raises(ValueError, match="ah must start on 16 bytes"):
        spmm_pallas.spmm_window_sg_presplit(ws, off_h, al, b, min_b_rows=rows)
    with pytest.raises(ValueError, match="al must start on 16 bytes"):
        spmm_pallas.spmm_window_sg_presplit_ab(ws, ah, off_l, bh, bl, min_b_rows=rows)
    with pytest.raises(ValueError, match="tiles must start on 16 bytes"):
        spmm_pallas.spmm_window_sg(ws, off_t, b, min_b_rows=rows)
    assert [k.launches for k in kernels] == [x + 1 for x in before]


# ------------------------------ #4 and #12 at x3 on the wgmma body


def _split_pair(tiles, dev):
    """fp32 panels -> their bf16 (ah, al), the packs' RNE split."""
    t = torch.from_numpy(tiles).to(dev)
    ah, al = spmm_pallas.split_b_bf16(t.reshape(-1, t.shape[-1]))
    return ah.view(t.shape), al.view(t.shape)


@pytest.mark.parametrize("p", [2, 3, 4, 7])
@pytest.mark.parametrize("case", sorted(X3_WGMMA))
def test_window_x3_wgmma_matches_plain_and_1(cuda_device, case, p):
    """#4 at x3 (``crp_window_x3``) on hand-built p-shard pair packs (n in
    {16, 37, 48, 64, 256}, W off the 64-row stage, an unaligned B, one
    slice, many trips round the ring; the last group of every shard a pad
    group, the middle shard empty for p > 2): within TOL_PLAIN of its plain
    version, pad rows and the empty shard zero, one launch a shard; C equal
    bit for bit to #1's (``crp_window_sg_presplit``) on the same arrays."""
    G, TM, W, n, off = X3_WGMMA[case]
    rng = np.random.default_rng(W + n + p)
    dev = cuda_device
    ws = torch.from_numpy(rng.integers(0, 300, (p, G)).astype(np.int32)).to(dev)
    tiles = _panels(rng, (p, G, TM, W))
    tiles[:, -1] = 0
    if p > 2:
        tiles[p // 2] = 0
    ah, al = _split_pair(tiles, dev)
    rows = int(ws.max()) + W
    b = _nan_framed(torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32))
                    .to(dev), off)
    kernel = spmm_pallas.spmm_window
    for i in range(p):
        before = kernel.launches
        k = kernel(ws[i], (ah[i], al[i]), b, "x3", min_b_rows=rows)
        plain = spmm_pallas.spmm_window_plain(ws[i], (ah[i], al[i]), b, "x3")
        if p > 2 and i == p // 2:
            assert kernel.launches == before + 1 and not torch.any(k)
        else:
            _held_to_plain(k, plain, before, kernel.launches, slice((G - 1) * TM, None))
        c1 = spmm_pallas.spmm_window_sg_presplit(ws[i], ah[i], al[i], b, min_b_rows=rows)
        assert torch.equal(k.view(torch.int32), c1.view(torch.int32))


# name -> (W, n, B offset in elements): W = 352 and 160 end on half a
# 64-row stage; odd n and an unaligned B take the plain B copies
X3_HALO = {
    "n=16": (256, 16, 0),
    "odd n": (352, 37, 0),
    "n=256": (640, 256, 0),
    "unaligned B": (160, 64, 1),
    "one slice": (32, 48, 0),
}


def _displs(p, rng):
    """Uneven 128-aligned ownership of p shards (the 4-shard default of
    ``_halo_hand_pack`` for p = 4)."""
    if p == 4:
        return (0, 256, 640, 768, 1152)
    return tuple(np.concatenate([[0], np.cumsum(rng.integers(1, 4, p) * 128)]))


@pytest.mark.parametrize("p", [2, 3, 4, 7])
@pytest.mark.parametrize("case", sorted(X3_HALO))
def test_halo_x3_wgmma_matches_plain_and_window(cuda_device, case, p):
    """#12 at x3 (``crp_halo_x3``) on hand-built p-shard pair packs: stages
    read through the chunk table across uneven owners, dead chunks (-1)
    read as zeros (B framed by NaN), odd n, an unaligned B, one slice:
    within TOL_PLAIN of the plain version, pad rows and a window wholly past
    the matrix zero, one launch; and C equal bit for bit to #4 run shard by
    shard on the same pair with ``ws_rel`` and the plain version's window
    buffers (``halo_buffers``): the same products in the same order."""
    W, n, off = X3_HALO[case]
    rng = np.random.default_rng(W + n + p)
    ws, ws_rel, panels, push, chunk_src, bs, buf_rows, max_k = _halo_hand_pack(
        rng, W, n, _displs(p, rng))
    dev = cuda_device

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)

    pair = _split_pair(panels, dev)
    b = _nan_framed(torch.from_numpy(bs).to(dev), off)
    args = (put(ws), put(ws_rel), pair, put(push), put(chunk_src), b, "x3", buf_rows)
    before = spmm_halo.spmm_halo.launches
    k = spmm_halo.spmm_halo(*args, min_b_rows=max_k)
    plain = spmm_halo.spmm_halo_plain(*args)
    _held_to_plain(k[1], plain[1], before, spmm_halo.spmm_halo.launches,
                   slice(2 * 128, None))
    scale = float(plain.abs().max())
    assert float((k - plain).abs().max()) <= TOL_PLAIN[np.float32] * scale
    assert not torch.any(k[p - 1, :128]) and not torch.any(plain[p - 1, :128])
    buf = spmm_halo.halo_buffers(args[3], b, buf_rows)
    for i in range(p):
        c4 = spmm_pallas.spmm_window(args[1][i], (pair[0][i], pair[1][i]), buf[i], "x3",
                                     min_b_rows=buf_rows)
        assert torch.equal(k[i].view(torch.int32), c4.view(torch.int32))


def test_x3_multi_shard_wrappers_launch_the_kernel_or_raise(cuda_device, monkeypatch):
    """On CUDA tensors #4 and #12 at x3 launch their wgmma kernels and never
    their plain versions; fp32 panels at x3 (no kernel: the packs hold the
    pair) and a pair off 16 bytes (TMA) are refused before any launch,
    with nothing to fall back to."""
    def no_plain(*args, **kw):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(spmm_pallas, "spmm_window_plain", no_plain)
    monkeypatch.setattr(spmm_halo, "spmm_halo_plain", no_plain)
    rng = np.random.default_rng(6)
    dev = cuda_device
    ws = torch.zeros(2, dtype=torch.int32, device=dev)
    tiles = _panels(rng, (2, 128, 64))
    ah, al = _split_pair(tiles, dev)
    b = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32)).to(dev)
    before = spmm_pallas.spmm_window.launches
    spmm_pallas.spmm_window(ws, (ah, al), b, "x3", min_b_rows=64)
    assert spmm_pallas.spmm_window.launches == before + 1
    with pytest.raises(ValueError, match="no kernel for torch.float32 panels at 'x3'"):
        spmm_pallas.spmm_window(ws, torch.from_numpy(tiles).to(dev), b, "x3",
                                min_b_rows=64)
    with pytest.raises(ValueError, match="ah must start on 16 bytes"):
        spmm_pallas.spmm_window(ws, (_nan_framed(ah, 1), al), b, "x3", min_b_rows=64)
    assert spmm_pallas.spmm_window.launches == before + 1
    hws, ws_rel, panels, push, chunk_src, bs, buf_rows, max_k = _halo_hand_pack(
        rng, 128, 16)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)

    pair = _split_pair(panels, dev)
    args = (put(hws), put(ws_rel), pair, put(push), put(chunk_src),
            torch.from_numpy(bs).to(dev), "x3", buf_rows)
    before = spmm_halo.spmm_halo.launches
    spmm_halo.spmm_halo(*args, min_b_rows=max_k)
    assert spmm_halo.spmm_halo.launches == before + 1
    fp32 = args[:2] + (torch.from_numpy(panels).to(dev),) + args[3:]
    with pytest.raises(ValueError, match="no kernel for torch.float32 panels at 'x3'"):
        spmm_halo.spmm_halo(*fp32, min_b_rows=max_k)
    off = args[:2] + ((pair[0], _nan_framed(pair[1], 1)),) + args[3:]
    with pytest.raises(ValueError, match="al must start on 16 bytes"):
        spmm_halo.spmm_halo(*off, min_b_rows=max_k)
    assert spmm_halo.spmm_halo.launches == before + 1


# ------------------ #6 at highest on the wgmma body's TF32 mode


def _dummy_groups(op, arrs):
    """Groups of a ragged shard's pack whose one chunk is a zero panel: the
    dummy chunks (every nonzero spilled, or a pad group)."""
    gp = arrs[-1].cpu().numpy() if op.spill_impl != "pallas" else arrs[-2].cpu().numpy()
    panels = spmm_pallas.tf32_panels(arrs[3:5]) if op.scheme == "tf32" else arrs[3]
    panels = panels.float().abs().sum(dim=(1, 2)).cpu().numpy()
    return [g for g in range(len(gp) - 1)
            if gp[g + 1] - gp[g] == 1 and panels[gp[g]] == 0]


def _two_shard_ragged(TM, Wc, prec, dev):
    """Two shards of a community power-law graph packed ragged at ``prec``
    on ``dev``: hub groups of many chunks, groups whose nonzeros all
    spilled (dummy chunks), the shorter shard's trailing no-op steps, pad
    groups.  Returns (a, the shards' row counts, arrays, op)."""
    a = powerlaw_community_csr(20000, 16, 1024, seed=5, dtype=np.float32)
    rows = np.repeat(np.arange(a.nrow), np.diff(a.rowptr))
    keep = (rows < 3000) | (rows >= 3000 + 4 * TM)  # whole empty groups
    a = CSRMatrix.from_coo(a.nrow, a.ncol, rows[keep], a.colidx[keep], a.val[keep],
                           dtype=np.float32)
    cut = 6000
    shards = [(s.rowptr, s.colidx.astype(np.int32), s.val)
              for s in (a.row_slice(0, cut), a.row_slice(cut, a.nrow))]
    arrays, op = _pack_ragged(shards, a.nrow - cut + 700, np.float32, prec, dev,
                              geometry=(TM, Wc), min_chunk_nnz=40, spill_impl="segsum")
    gp = arrays[-1].cpu().numpy()
    assert np.diff(gp, axis=1).max() > 1 and gp[0, -1] < arrays[0].shape[1]
    return a, (cut, a.nrow - cut), arrays, op


@pytest.mark.parametrize("TM", [128, 256, 512])
@pytest.mark.parametrize("Wc", [128, 256, 512])
def test_ragged_highest_tf32x3_matches_plain(cuda_device, TM, Wc):
    """#6 at highest (``crp_ragged_f32``: the wgmma body's TF32 mode with the
    ragged walk, on the pack's TF32 planes) on two-shard packs over every
    geometry the chooser can return: hub groups of many chunks, groups
    whose nonzeros all spilled (dummy chunks), the shorter shard's
    trailing no-op steps, pad groups; n in {16, 37, 100, 256} and at n =
    100 a B framed by NaN and off 16 bytes (odd n and that B take the plain
    B copies): within TOL_PLAIN_FRO of the fp32 plain version, one launch a
    shard, the dummy groups' and pad rows zero, a second launch equal bit
    for bit."""
    a, nrows, arrays, op = _two_shard_ragged(TM, Wc, "highest", cuda_device)
    assert op.scheme == "tf32" and arrays[3].dtype == arrays[4].dtype == torch.float32
    kernel = spmm_ragged.spmm_ragged
    rows = max(op.min_b_rows, a.ncol)
    for n, off in ((16, 0), (37, 0), (100, 0), (100, 1), (256, 0)):
        rB = torch.from_numpy(_b(a, rows, n, np.float32)).to(cuda_device)
        if off:
            rB = _nan_framed(rB, off)
        for i, nrow in enumerate(nrows):
            arrs = tuple(x[i] for x in arrays)
            args = op.kernel_args(arrs, rB)
            before = kernel.launches
            k = kernel(*args, min_b_rows=op.min_b_rows)
            assert kernel.launches == before + 1
            p = op.plain(*args)
            assert k.shape == p.shape and bool(torch.isfinite(k).all())
            assert float((k - p).double().norm() / p.double().norm()) <= TOL_PLAIN_FRO[np.float32]
            assert not torch.any(k[nrow:])  # pad groups
            dummies = _dummy_groups(op, arrs)
            assert dummies
            for g in dummies:
                assert not torch.any(k[g * TM:(g + 1) * TM])
            again = kernel(*args, min_b_rows=op.min_b_rows)
            assert torch.equal(k.view(torch.int32), again.view(torch.int32))
    big, small = args[3]
    with pytest.raises(ValueError, match="big must start on 16 bytes"):
        kernel(*args[:3], (_nan_framed(big, 1), small), args[4], min_b_rows=op.min_b_rows)


def test_wgmma_entries_launch_from_a_thread_with_no_context(cuda_device):
    """The ``wgmma`` body's entries make their TMA tensor maps with
    ``cuTensorMapEncodeTiled``, which needs a context current on the calling thread: from
    a fresh thread that has made no CUDA call (as autograd's device thread
    in a backward), #6 at highest and #7 at x3 launch and equal their
    launch from this thread bit for bit."""
    import threading

    G, TM, W, n, off = TF32X3_WINDOW["odd n"]
    rng = np.random.default_rng(11)
    dev = cuda_device
    ws = torch.from_numpy(rng.integers(0, 300, G).astype(np.int32)).to(dev)
    tiles = torch.from_numpy(_panels(rng, (G, TM, W))).to(dev)
    b = torch.from_numpy(rng.standard_normal((300 + W, n)).astype(np.float32)).to(dev)
    step_g = torch.arange(G, dtype=torch.int32, device=dev)
    group_ptr = torch.arange(G + 1, dtype=torch.int32, device=dev)
    ah, al = spmm_pallas.split_b_bf16(tiles.view(G * TM, W))
    runs = {
        "#6": lambda: spmm_ragged.spmm_ragged(step_g, group_ptr, ws, _pair(tiles), b,
                                              min_b_rows=300 + W),
        "#7": lambda: spmm_ragged.spmm_ragged_presplit(
            step_g, group_ptr, ws, ah.view(G, TM, W), al.view(G, TM, W), b,
            min_b_rows=300 + W),
    }
    for name, run in runs.items():
        here = run()
        got = {}

        def in_thread():
            try:
                got["c"] = run()
                torch.cuda.synchronize()
            except Exception as exc:  # carried back to the test's thread
                got["error"] = exc

        worker = threading.Thread(target=in_thread)
        worker.start()
        worker.join()
        assert "error" not in got, (name, got.get("error"))
        assert torch.equal(got["c"].view(torch.int32), here.view(torch.int32)), name


@pytest.mark.parametrize("case", sorted(TF32X3_WINDOW))
def test_ragged_highest_one_chunk_a_group_equals_window_highest(cuda_device, case):
    """#6 at highest on a ragged pack with exactly one chunk a group
    (group_ptr = 0 .. G, starts = ws) over #3's hand-built TF32 planes (odd
    n, one slice, many trips round the ring, an unaligned B): equal bit for
    bit to #3 ``crp_window_sg_f32``, the same body in the same order (the
    walk changes nothing), one launch."""
    G, TM, W, n, off = TF32X3_WINDOW[case]
    rng = np.random.default_rng(W + n)
    ws = rng.integers(0, 300, G).astype(np.int32)
    tiles = _panels(rng, (G, TM, W))
    tiles[-1] = 0
    rows = int(ws.max()) + W
    dev = cuda_device
    b = _nan_framed(torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32))
                    .to(dev), off)
    ws_t = torch.from_numpy(ws).to(dev)
    planes = _planes(torch.from_numpy(tiles).to(dev))
    step_g = torch.arange(G, dtype=torch.int32, device=dev)
    group_ptr = torch.arange(G + 1, dtype=torch.int32, device=dev)
    kernel = spmm_ragged.spmm_ragged
    before = kernel.launches
    c6 = kernel(step_g, group_ptr, ws_t, (planes[0], planes[1]), b, min_b_rows=rows)
    assert kernel.launches == before + 1
    c3 = spmm_pallas.spmm_window_sg(ws_t, planes, b, min_b_rows=rows)
    assert bool(torch.isfinite(c6).all())
    assert torch.equal(c6.view(torch.int32), c3.view(torch.int32))


# ------------- #7 (x3) and #8 (default) on the wgmma body, walking chunks


@pytest.mark.parametrize("TM", [128, 256, 512])
@pytest.mark.parametrize("Wc", [128, 256, 512])
def test_ragged_wgmma_matches_plain(cuda_device, TM, Wc):
    """#7 (``crp_ragged_presplit``) and #8 (``crp_ragged_bf16``) on the
    wgmma body over every geometry the chooser can return, on the
    two-shard x3 pack (#8 on its hi panels and B in bf16): hub groups,
    dummy chunks, the shorter shard's trailing no-op steps, pad groups; n
    in {16, 37, 100, 256} and at n = 100 a B framed by NaN and off 16
    bytes (odd n and that B take the plain B copies): each within
    TOL_PLAIN_FRO of its plain version, one launch a shard, the dummy
    groups' and pad rows zero; #8 equal bit for bit to #7 on (ah, 0, B in
    bf16 as fp32), whose extra products are exact zeros."""
    a, nrows, arrays, op = _two_shard_ragged(TM, Wc, "x3", cuda_device)
    assert op.scheme == "x3"
    k7, k8 = spmm_ragged.spmm_ragged_presplit, spmm_ragged.spmm_ragged_bf16
    rows = max(op.min_b_rows, a.ncol)
    for n, off in ((16, 0), (37, 0), (100, 0), (100, 1), (256, 0)):
        b = torch.from_numpy(_b(a, rows, n, np.float32)).to(cuda_device)
        bh = b.to(torch.bfloat16)
        if off:
            b, bh = _nan_framed(b, off), _nan_framed(bh, off)
        for i, nrow in enumerate(nrows):
            arrs = tuple(x[i] for x in arrays)
            step_g, group_ptr, starts, ah, al, _ = op.kernel_args(arrs, b)
            dummies = _dummy_groups(op, arrs)
            assert dummies
            for kernel, plain, args in (
                (k7, spmm_ragged.spmm_ragged_presplit_plain,
                 (step_g, group_ptr, starts, ah, al, b)),
                (k8, spmm_ragged.spmm_ragged_bf16_plain, (step_g, group_ptr, starts, ah, bh)),
            ):
                before = kernel.launches
                k = kernel(*args, min_b_rows=rows)
                assert kernel.launches == before + 1
                p = plain(*args)
                assert k.shape == p.shape and bool(torch.isfinite(k).all())
                rel_fro = float((k - p).double().norm() / p.double().norm())
                assert rel_fro <= TOL_PLAIN_FRO[np.float32], (kernel.__name__, n, off)
                assert not torch.any(k[nrow:])  # pad groups
                for g in dummies:
                    assert not torch.any(k[g * TM:(g + 1) * TM])
            c8 = k8(step_g, group_ptr, starts, ah, bh, min_b_rows=rows)
            c7 = k7(step_g, group_ptr, starts, ah, torch.zeros_like(ah), bh.float(),
                    min_b_rows=rows)
            assert torch.equal(c8.view(torch.int32), c7.view(torch.int32)), \
                float((c8 - c7).abs().max())


@pytest.mark.parametrize("case", sorted(X3_WGMMA))
def test_ragged_x3_one_chunk_a_group_equals_window_x3(cuda_device, case):
    """#7 on a ragged pack with exactly one chunk a group (group_ptr = 0 ..
    G, starts = ws) over #4's hand-built x3 arrays (n in {16, 37, 48, 64,
    256}, W off the 64-row stage, an unaligned B, one slice, many trips
    round the ring): equal bit for bit to #4 ``crp_window_x3``, the same
    body in the same order, one launch."""
    ws, ah, al, b, rows, _ = _x3_hand_pack(case, cuda_device)
    G = ws.shape[0]
    step_g = torch.arange(G, dtype=torch.int32, device=cuda_device)
    group_ptr = torch.arange(G + 1, dtype=torch.int32, device=cuda_device)
    kernel = spmm_ragged.spmm_ragged_presplit
    before = kernel.launches
    c7 = kernel(step_g, group_ptr, ws, ah, al, b, min_b_rows=rows)
    assert kernel.launches == before + 1
    c4 = spmm_pallas.spmm_window(ws, (ah, al), b, "x3", min_b_rows=rows)
    assert bool(torch.isfinite(c7).all())
    assert torch.equal(c7.view(torch.int32), c4.view(torch.int32))


def test_ragged_wgmma_wrappers_launch_the_kernel_or_raise(cuda_device, monkeypatch):
    """On CUDA tensors #7 and #8 launch their kernels and never their plain
    versions; panels off 16 bytes (TMA) are refused before any launch."""
    def no_plain(*args, **kw):
        raise AssertionError("the plain version ran on CUDA tensors")

    for name in ("spmm_ragged_presplit_plain", "spmm_ragged_bf16_plain"):
        monkeypatch.setattr(spmm_ragged, name, no_plain)
    ws, ah, al, b, rows, _ = _x3_hand_pack("one slice", cuda_device)
    G = ws.shape[0]
    step_g = torch.arange(G, dtype=torch.int32, device=cuda_device)
    group_ptr = torch.arange(G + 1, dtype=torch.int32, device=cuda_device)
    bh = b.to(torch.bfloat16)
    k7, k8 = spmm_ragged.spmm_ragged_presplit, spmm_ragged.spmm_ragged_bf16
    before = (k7.launches, k8.launches)
    k7(step_g, group_ptr, ws, ah, al, b, min_b_rows=rows)
    k8(step_g, group_ptr, ws, ah, bh, min_b_rows=rows)
    assert (k7.launches, k8.launches) == (before[0] + 1, before[1] + 1)
    off_h, off_l = (_nan_framed(t, 1) for t in (ah, al))
    with pytest.raises(ValueError, match="ah must start on 16 bytes"):
        k7(step_g, group_ptr, ws, off_h, al, b, min_b_rows=rows)
    with pytest.raises(ValueError, match="al must start on 16 bytes"):
        k7(step_g, group_ptr, ws, ah, off_l, b, min_b_rows=rows)
    with pytest.raises(ValueError, match="ah must start on 16 bytes"):
        k8(step_g, group_ptr, ws, off_h, bh, min_b_rows=rows)
    assert (k7.launches, k8.launches) == (before[0] + 1, before[1] + 1)


# ------------------------------ #2 as the wgmma body's one-pass mode

# name -> (G, TM, W, n, B offset in elements): odd n and an unaligned B
# take the plain B copies; W = 352 ends on half a 64-row stage; W = 32 is
# one slice; W = 2048 runs the 6-stage ring round many times
ONE_PASS = {
    "n=16": (3, 256, 352, 16, 0),
    "odd n": (3, 256, 352, 37, 0),
    "n=100": (4, 128, 2048, 100, 0),
    "n=256": (4, 128, 1024, 256, 0),
    "unaligned B": (3, 128, 160, 64, 1),
    "one slice": (2, 128, 32, 48, 0),
}


def _one_pass_pack(case, dev):
    """A uniform default pack by hand: random sparse panels rounded to bf16
    (RNE), random window starts, the last group a zero pad group, a bf16 B
    framed by NaN (a read outside it shows in C)."""
    G, TM, W, n, off = ONE_PASS[case]
    rng = np.random.default_rng(W + n + 1)
    ws = torch.from_numpy(rng.integers(0, 300, G).astype(np.int32)).to(dev)
    tiles = _panels(rng, (G, TM, W))
    tiles[-1] = 0
    ah = torch.from_numpy(tiles).to(dev).to(torch.bfloat16)
    rows = int(ws.max()) + W
    bh = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32)).to(dev)
    return ws, ah, _nan_framed(bh.to(torch.bfloat16), off), rows


@pytest.mark.parametrize("case", sorted(ONE_PASS))
def test_one_pass_wgmma_matches_plain_and_x3(cuda_device, case):
    """#2 on hand-built packs (n in {16, 37, 48, 64, 100, 256}, W off the
    64-row stage, an unaligned B, one slice, many trips round the ring):
    within TOL_PLAIN of its plain version, pad rows zero, one launch; and
    #1 on (ah, 0, bh as fp32), whose B splits to hi = bh and lo = 0 so
    that its extra products are exact zeros, gives the same C bit for
    bit."""
    ws, ah, bh, rows = _one_pass_pack(case, cuda_device)
    G, TM = ONE_PASS[case][:2]
    kernel = spmm_pallas.spmm_window_sg_bf16
    before = kernel.launches
    k = kernel(ws, ah, bh, min_b_rows=rows)
    _held_to_plain(k, spmm_pallas.spmm_window_sg_bf16_plain(ws, ah, bh), before,
                   kernel.launches, slice((G - 1) * TM, None))
    c1 = spmm_pallas.spmm_window_sg_presplit(ws, ah, torch.zeros_like(ah), bh.float(),
                                             min_b_rows=rows)
    assert torch.equal(k.view(torch.int32), c1.view(torch.int32)), \
        float((k - c1).abs().max())


def test_one_pass_wrapper_launches_the_kernel_or_raises(cuda_device, monkeypatch):
    """On CUDA tensors #2 launches its kernel and never its plain version;
    hi panels off 16 bytes (TMA) are refused before any launch."""
    def no_plain(*args, **kw):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(spmm_pallas, "spmm_window_sg_bf16_plain", no_plain)
    ws, ah, bh, rows = _one_pass_pack("one slice", cuda_device)
    kernel = spmm_pallas.spmm_window_sg_bf16
    before = kernel.launches
    kernel(ws, ah, bh, min_b_rows=rows)
    assert kernel.launches == before + 1
    with pytest.raises(ValueError, match="ah must start on 16 bytes"):
        kernel(ws, _nan_framed(ah, 1), bh, min_b_rows=rows)
    assert kernel.launches == before + 1


# ---------------- #4 and #12 at default on the one-pass wgmma body

# name -> (G, TM, W, n, B offset in elements): odd n and an unaligned B
# take the plain 2-byte B copies; W = 352 and 160 end on half a 64-row
# stage; W = 32 is one slice; W = 2048 runs the 6-stage ring round many
# times; n = 512 is four n tiles
ONE_PASS_MULTI = {
    "n=16": (3, 256, 352, 16, 0),
    "odd n": (3, 256, 352, 37, 0),
    "n=100": (4, 128, 2048, 100, 0),
    "n=256": (4, 128, 1024, 256, 0),
    "n=512": (2, 128, 640, 512, 0),
    "unaligned B": (3, 128, 160, 64, 1),
    "one slice": (2, 128, 32, 48, 0),
}


def _bits_of(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("case", sorted(ONE_PASS_MULTI))
def test_window_default_wgmma_matches_plain_and_2(cuda_device, case, p):
    """#4 at default (``crp_window_bf16``) on hand-built p-shard packs of
    the bf16 hi plane and a bf16 B framed by NaN (the last group of every
    shard a pad group, the middle shard empty for p > 2): within TOL_PLAIN
    of its plain version, pad rows and the empty shard zero, one launch a
    shard; C equal bit for bit to #2's (``crp_window_sg_bf16``) on the same
    arrays, the same body, and to a second launch."""
    G, TM, W, n, off = ONE_PASS_MULTI[case]
    rng = np.random.default_rng(W + n + p + 2)
    dev = cuda_device
    ws = torch.from_numpy(rng.integers(0, 300, (p, G)).astype(np.int32)).to(dev)
    tiles = _panels(rng, (p, G, TM, W))
    tiles[:, -1] = 0
    if p > 2:
        tiles[p // 2] = 0
    ah = torch.from_numpy(tiles).to(dev).to(torch.bfloat16)
    rows = int(ws.max()) + W
    b = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32)).to(dev)
    bh = _nan_framed(b.to(torch.bfloat16), off)
    kernel = spmm_pallas.spmm_window
    for i in range(p):
        before = kernel.launches
        k = kernel(ws[i], ah[i], bh, "default", min_b_rows=rows)
        plain = spmm_pallas.spmm_window_plain(ws[i], ah[i], bh, "default")
        if p > 2 and i == p // 2:
            assert kernel.launches == before + 1 and not torch.any(k)
        else:
            _held_to_plain(k, plain, before, kernel.launches, slice((G - 1) * TM, None))
        c2 = spmm_pallas.spmm_window_sg_bf16(ws[i], ah[i], bh, min_b_rows=rows)
        assert torch.equal(_bits_of(k), _bits_of(c2)), float((k - c2).abs().max())
        again = kernel(ws[i], ah[i], bh, "default", min_b_rows=rows)
        assert torch.equal(_bits_of(again), _bits_of(k))


# name -> (W, n, B offset in elements): W = 352 and 160 end on half a
# 64-row stage; odd n and an unaligned B take the plain B copies
ONE_PASS_HALO = {
    "n=16": (256, 16, 0),
    "odd n": (352, 37, 0),
    "n=100": (640, 100, 0),
    "n=256": (640, 256, 0),
    "n=512": (256, 512, 0),
    "unaligned B": (160, 64, 1),
    "one slice": (32, 48, 0),
}


@pytest.mark.parametrize("p", [2, 3, 4, 7])
@pytest.mark.parametrize("case", sorted(ONE_PASS_HALO))
def test_halo_default_wgmma_matches_plain_and_window(cuda_device, case, p):
    """#12 at default (``crp_halo_bf16``) on hand-built p-shard packs of the
    bf16 hi plane: stages read through the chunk table across uneven
    owners, dead chunks (-1) read as zeros (B framed by NaN), odd n, n =
    512, an unaligned B, one slice: within TOL_PLAIN of the plain version,
    pad rows and a window wholly past the matrix zero, one launch; C equal
    bit for bit to #4 run shard by shard on the same plane with ``ws_rel``
    and the plain version's window buffers, and to a second launch."""
    W, n, off = ONE_PASS_HALO[case]
    rng = np.random.default_rng(W + n + p + 2)
    ws, ws_rel, panels, push, chunk_src, bs, buf_rows, max_k = _halo_hand_pack(
        rng, W, n, _displs(p, rng))
    dev = cuda_device

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)

    ah = torch.from_numpy(panels).to(dev).to(torch.bfloat16)
    b = _nan_framed(torch.from_numpy(bs).to(dev).to(torch.bfloat16), off)
    args = (put(ws), put(ws_rel), ah, put(push), put(chunk_src), b, "default", buf_rows)
    before = spmm_halo.spmm_halo.launches
    k = spmm_halo.spmm_halo(*args, min_b_rows=max_k)
    plain = spmm_halo.spmm_halo_plain(*args)
    _held_to_plain(k[1], plain[1], before, spmm_halo.spmm_halo.launches,
                   slice(2 * 128, None))
    scale = float(plain.abs().max())
    assert float((k - plain).abs().max()) <= TOL_PLAIN[np.float32] * scale
    assert not torch.any(k[p - 1, :128]) and not torch.any(plain[p - 1, :128])
    buf = spmm_halo.halo_buffers(args[3], b, buf_rows)
    for i in range(p):
        c4 = spmm_pallas.spmm_window(args[1][i], ah[i], buf[i], "default",
                                     min_b_rows=buf_rows)
        assert torch.equal(_bits_of(k[i]), _bits_of(c4))
    again = spmm_halo.spmm_halo(*args, min_b_rows=max_k)
    assert torch.equal(_bits_of(again), _bits_of(k))


def test_default_multi_shard_wrappers_launch_the_kernel_or_raise(cuda_device,
                                                                 monkeypatch):
    """On CUDA tensors #4 and #12 at default launch their one-pass kernels
    and never their plain versions; fp32 panels at default (no kernel: the
    packs hold the hi plane), an fp32 B beside the plane and a plane off 16
    bytes (TMA) are refused before any launch, with nothing to fall back
    to."""
    def no_plain(*args, **kw):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(spmm_pallas, "spmm_window_plain", no_plain)
    monkeypatch.setattr(spmm_halo, "spmm_halo_plain", no_plain)
    rng = np.random.default_rng(7)
    dev = cuda_device
    ws = torch.zeros(2, dtype=torch.int32, device=dev)
    tiles = torch.from_numpy(_panels(rng, (2, 128, 64))).to(dev)
    ah = tiles.to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32)).to(dev)
    bh = b.to(torch.bfloat16)
    before = spmm_pallas.spmm_window.launches
    spmm_pallas.spmm_window(ws, ah, bh, "default", min_b_rows=64)
    assert spmm_pallas.spmm_window.launches == before + 1
    with pytest.raises(ValueError, match="no kernel for torch.float32 panels at 'default'"):
        spmm_pallas.spmm_window(ws, tiles, b, "default", min_b_rows=64)
    with pytest.raises(ValueError, match="B must be a contiguous 2-D torch.bfloat16"):
        spmm_pallas.spmm_window(ws, ah, b, "default", min_b_rows=64)
    with pytest.raises(ValueError, match="ah must start on 16 bytes"):
        spmm_pallas.spmm_window(ws, _nan_framed(ah, 1), bh, "default", min_b_rows=64)
    assert spmm_pallas.spmm_window.launches == before + 1
    hws, ws_rel, panels, push, chunk_src, bs, buf_rows, max_k = _halo_hand_pack(
        rng, 128, 16)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)

    hah = torch.from_numpy(panels).to(dev).to(torch.bfloat16)
    args = (put(hws), put(ws_rel), hah, put(push), put(chunk_src),
            torch.from_numpy(bs).to(dev).to(torch.bfloat16), "default", buf_rows)
    before = spmm_halo.spmm_halo.launches
    spmm_halo.spmm_halo(*args, min_b_rows=max_k)
    assert spmm_halo.spmm_halo.launches == before + 1
    fp32 = args[:2] + (torch.from_numpy(panels).to(dev),) + args[3:5] + (
        torch.from_numpy(bs).to(dev),) + args[6:]
    with pytest.raises(ValueError, match="no kernel for torch.float32 panels at 'default'"):
        spmm_halo.spmm_halo(*fp32, min_b_rows=max_k)
    off = args[:2] + (_nan_framed(hah, 1),) + args[3:]
    with pytest.raises(ValueError, match="ah must start on 16 bytes"):
        spmm_halo.spmm_halo(*off, min_b_rows=max_k)
    assert spmm_halo.spmm_halo.launches == before + 1


@pytest.mark.parametrize("prec", ["x3", "default"])
def test_p4_init_peaks_within_its_panels(cuda_device, prec):
    """A p = 4 engine on a banded matrix whose bf16 panels are 1.4-2.7 GB:
    its init's peak device memory stays within 1.2 x what it holds after
    (the panels densified slab by slab: no whole fp32 tensor beside them)."""
    a = banded_random_csr(120000, nnz_per_row=53, bandwidth=2500, seed=8,
                          dtype=np.float32)
    d = csr_row_partition(a.rowptr, 4)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    eng = RowParaSpmm(a, d, d, 64, device=cuda_device, dtype=np.float32,
                      config=SpmmConfig(kernel="pallas", mxu_precision=prec))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda_device) - base
    # an earlier test's objects collected during the init lower what the
    # allocator reports as held, never the pack's own bytes
    held = max(torch.cuda.memory_allocated(cuda_device) - base,
               sum(t.numel() * t.element_size() for t in eng.packed))
    assert eng._local_op.variant == "window"
    assert held > 1e9 and peak <= 1.2 * held, (peak, held)


# ------------------------ the fixed-order segment sums; training on the card


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_segment_sums_repeat_bit_for_bit(cuda_device, dtype, monkeypatch):
    """The ``segsum`` kind, the chunked spill (1 MB chunks: rows straddle
    them) and, in fp64, the ``dd`` kind's segment-sum tier on a power-law
    matrix with hub rows: two launches equal bit for bit, within the
    dtype's class of the fp64 product."""
    from crp_tpu_torch.kernels import spmm_segsum
    from crp_tpu_torch.kernels.spmm_dd import spmm_segsum_dd

    a = powerlaw_community_csr(30000, 16, 1024, seed=50, dtype=dtype)
    arrs = [torch.from_numpy(x).to(cuda_device) for x in spmm_segsum.pack_device_csr(
        a.rowptr, a.colidx, a.val, a.nnz + 9, nrow=a.nrow)]
    b = np.random.default_rng(51).standard_normal((a.ncol, 64)).astype(dtype)
    bt = torch.from_numpy(b).to(cuda_device)
    ref = a.spmm_ref(b.astype(np.float64))
    tol = 1e-12 if dtype == np.float64 else 1e-6
    runs = [lambda: spmm_segsum.spmm_segment_sum(*arrs, a.nrow, bt)]
    runs.append(lambda: spmm_ragged.spmm_spill_chunked(*arrs, bt, a.nrow))
    if dtype == np.float64:
        runs.append(lambda: spmm_segsum_dd(*arrs, bt, a.nrow))
    for i, run in enumerate(runs):
        if i:
            monkeypatch.setattr(spmm_segsum, "SEGSUM_BLOCK_BYTES", 1 << 20)
        c1, c2 = run(), run()
        assert _bits_equal(c1, c2), i
        assert rel_fro_err(ref, c1.double().cpu().numpy()) <= tol, i


@pytest.mark.parametrize("p", [1, 4])
def test_autodiff_op_on_card_matches_plain(cuda_device, p):
    """``DifferentiableSpmm`` at ``auto`` on the card (the ``pallas`` walk,
    no halo) against the same op on the CPU (the kernels' plain versions):
    C and dB from the same B and dC within 1e-6 (relative Frobenius)."""
    from crp_tpu_torch.engine.autodiff import DifferentiableSpmm
    from crp_tpu_torch.shard.layout import shard_dense_rows

    a = powerlaw_community_csr(20000, 8, 2500, seed=52, dtype=np.float32)
    d = csr_row_partition(a.rowptr, p)
    rng = np.random.default_rng(53)
    b = rng.standard_normal((a.ncol, 48)).astype(np.float32)
    dc = rng.standard_normal((a.nrow, 48)).astype(np.float32)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        a.__dict__.pop("_torch_pack_cache", None)
        a.__dict__.pop("_torch_transpose", None)
        op = DifferentiableSpmm(a, d, d, 48, device=dev, config=SpmmConfig(kernel="auto"))
        bs = op.shard_b(b).requires_grad_(True)
        cs = op(bs)
        dcs = torch.from_numpy(shard_dense_rows(dc, op.fwd.A_row_displs,
                                                pad_rows=cs.shape[1])).to(dev)
        (dbs,) = torch.autograd.grad(cs, bs, dcs)
        out[dev.type] = (op.fwd.kernel_kind, op.unshard_c(cs), op.unshard_db(dbs))
    assert out["cuda"][0] in ("pallas", "gather")
    for k in (1, 2):
        assert rel_fro_err(out["cpu"][k].astype(np.float64), out["cuda"][k]) <= 1e-6


@pytest.mark.parametrize("example", ["gcn_train", "gat_train"])
def test_training_repeats_bit_for_bit(cuda_device, example):
    """Two 2-step runs of the trainer from one seed on the card: the same
    losses, bit for bit."""
    import importlib

    mod = importlib.import_module(f"crp_tpu_torch.examples.{example}")
    kw = dict(kernel="auto") if example == "gcn_train" else {}
    first = mod.train(nodes=4000, hidden=32, steps=2, p=4, device=cuda_device, log=None,
                      **kw)
    again = mod.train(nodes=4000, hidden=32, steps=2, p=4, device=cuda_device, log=None,
                      model=first.model, **kw)
    assert np.isfinite(first.losses).all() and first.losses == again.losses


@pytest.mark.parametrize("cfg,kind", [
    (dict(), "pallas_halo"),                          # auto at 4 x 1: the fused #12
    (dict(a2a_b_finegrain=1), "pallas"),              # exact rows, #4 a panel
    (dict(overlap=1), "pallas"),                      # the ring, #4 as the self part
    (dict(kernel="pallas", rb_p2p=0), "pallas"),
])
def test_crp_on_card_matches_cpu(cuda_device, cfg, kind):
    """``CrpSpmm`` on the card against the same engine on the CPU (the
    kernels' plain versions), x3, B in row slabs and C in column slabs:
    the same grid, kind and counters, C within 1e-6 (relative Frobenius)
    and within x3's class of fp64."""
    from crp_tpu_torch.engine.crp import CrpSpmm
    from crp_tpu_torch.shard.redist import BlockDist
    from crp_tpu_torch.utils.blocks import uniform_displs

    a = banded_random_csr(12000, nnz_per_row=9, bandwidth=300, seed=61, dtype=np.float32)
    n, p = 64, 4
    ub = BlockDist.from_grid(uniform_displs(a.ncol, p), [0, n])
    uc = BlockDist.from_grid([0, a.nrow], uniform_displs(n, p))
    b = fill_b(0, a.ncol, 0, n, dtype=np.float32)
    g = CrpSpmm(a, n, ub, uc, nproc=p, device=cuda_device, dtype=np.float32,
                config=SpmmConfig(mxu_precision="x3", **cfg))
    # the CPU engine asks for the kind the card's resolved (auto is segsum there)
    c = CrpSpmm(a, n, ub, uc, nproc=p, device="cpu", dtype=np.float32,
                config=SpmmConfig(mxu_precision="x3", **{**cfg, "kernel": g.kernel_kind}))
    cg, cc = g.exec(b), c.exec(b)
    assert (g.pm, g.pn, g.kernel_kind) == (c.pm, c.pn, c.kernel_kind) == (4, 1, kind)
    assert (g.nelem_B_a2av, g.nelem_B_a2av_min) == (c.nelem_B_a2av, c.nelem_B_a2av_min)
    assert rel_fro_err(cc.astype(np.float64), cg) <= 1e-6
    assert rel_fro_err(a.spmm_ref(b.astype(np.float64)), cg) <= 1e-5


@pytest.mark.parametrize("engine", ["rowpara", "crp"])
def test_overlapped_ring_repeats_bit_for_bit(cuda_device, engine):
    """The two-stream ring (the self part's kernel on a side stream, the
    shifts on the current one): two launches equal bit for bit, and C
    within 1e-6 of the unfused ring's on the same card."""
    from crp_tpu_torch.engine.crp import CrpSpmm
    from crp_tpu_torch.kernels import spmm_pallas
    from crp_tpu_torch.shard.redist import BlockDist
    from crp_tpu_torch.utils.blocks import uniform_displs

    a = banded_random_csr(20000, nnz_per_row=9, bandwidth=400, seed=62, dtype=np.float32)
    n, p = 96, 4
    b = fill_b(0, a.ncol, 0, n, dtype=np.float32)
    outs = {}
    for overlap in (1, 0):
        cfg = SpmmConfig(kernel="pallas", mxu_precision="x3", overlap=overlap)
        if engine == "rowpara":
            d = csr_row_partition(a.rowptr, p)
            a.__dict__.pop("_torch_pack_cache", None)
            eng = RowParaSpmm(a, d, d, n, device=cuda_device, dtype=np.float32, config=cfg)
            bs = eng.shard_b(b)
        else:
            ub = BlockDist.from_grid(uniform_displs(a.ncol, p), [0, n])
            uc = BlockDist.from_grid([0, a.nrow], uniform_displs(n, p))
            eng = CrpSpmm(a, n, ub, uc, nproc=p, device=cuda_device, dtype=np.float32,
                          config=cfg)
            bs = eng.rd_B.shard_src(b)
        spmm_pallas.spmm_window.launches = 0
        c1, c2 = eng.exec_device(bs), eng.exec_device(bs)
        torch.cuda.synchronize()
        if overlap:
            assert spmm_pallas.spmm_window.launches == 2 * p
            assert torch.equal(c1.view(torch.int32), c2.view(torch.int32))
        outs[overlap] = eng.exec(b)
    assert rel_fro_err(outs[0].astype(np.float64), outs[1]) <= 1e-6


def test_reordered_graph_auto_on_card_matches_cpu_decision(cuda_device):
    """``cluster_reorder`` on a scrambled community graph, then
    ``RowParaSpmm(kernel="auto")`` at x3 on the card against the CPU engine
    asked for ``pallas`` (what ``auto`` means on the card at p = 1; the CPU
    takes ``segsum`` for ``auto``): the same kind and variant, C within
    x3's class of the fp64 product on the reordered problem, and its
    kernel launched."""
    from crp_tpu_torch.sparse.reorder import cluster_reorder

    a = powerlaw_community_csr(40000, avg_degree=16, comm_size=1024, seed=1234,
                               permute=True, dtype=np.float32)
    ar, perm = cluster_reorder(a)
    assert ar.backend == "native"
    n = 64
    b = fill_b(0, a.ncol, 0, n, dtype=np.float32)
    bp = np.ascontiguousarray(b[perm])
    d = csr_row_partition(ar.rowptr, 1)
    g = RowParaSpmm(ar, d, d, n, device=cuda_device, dtype=np.float32,
                    config=SpmmConfig(kernel="auto", mxu_precision="x3"))
    ar.__dict__.pop("_torch_pack_cache", None)
    c = RowParaSpmm(ar, d, d, n, device="cpu", dtype=np.float32,
                    config=SpmmConfig(kernel="pallas", mxu_precision="x3"))
    assert (g.kernel_kind, g._local_op.variant) == (c.kernel_kind, c._local_op.variant)
    kernel = g._local_op.kernel
    kernel.launches = 0
    cg = g.exec(bp)
    assert kernel.launches == 1
    ref = a.spmm_ref(b.astype(np.float64))[perm]
    assert rel_fro_err(ref, cg) <= 1e-5
    assert rel_fro_err(c.exec(bp).astype(np.float64), cg) <= 1e-5


def test_native_ggp_on_card_machine_reproduces_fixture(cuda_device):
    """The native partitioner built by the GPU machine's ``g++`` gives the
    part vectors whose digests ``tests/fixtures/ggp_oracle.json`` pins
    (``std::sort`` is not stable: another libstdc++ may order equal
    degrees otherwise).  It uses no card; it runs with the card tests
    because it checks that machine's build (``test_torch_ggp.py`` checks
    the CPU machine's)."""
    import json
    import os

    from crp_tpu_torch import native

    with open(os.path.join(os.path.dirname(__file__), "fixtures", "ggp_oracle.json")) as f:
        cases = json.load(f)
    seeds = {"banded:800": 60, "banded:2000": 61}
    for case in cases:
        kind, *args = case["spec"].split(":")
        args = [int(x) for x in args]
        if kind == "banded":
            a = banded_random_csr(args[0], nnz_per_row=args[1], bandwidth=args[2],
                                  seed=seeds[f"banded:{args[0]}"])
        elif kind == "plaw":
            a = powerlaw_random_csr(args[0], avg_degree=args[1], seed=62)
        else:
            a = powerlaw_community_csr(args[0], avg_degree=args[1], comm_size=args[2],
                                       seed=63)
        a = CSRMatrix.from_scipy((a.to_scipy() + a.to_scipy().T).tocsr())
        assert (a.nrow, a.nnz) == (case["nrow"], case["nnz"])
        part = native.ggp_partition(a.rowptr, a.colidx, case["nparts"], case["imbalance"])
        assert part is not None, "the native partitioner did not build"
        assert native.part_digest(part) == case["native"]["sha256"], case["spec"]


def test_drivers_on_card(cuda_device, tmp_path, capsys):
    """``bench_cli`` and a ``suite_cli`` ``kernels`` sweep on the card on a
    small matrix: the resolved kinds (the windowed #1 at x3, the ragged
    #7 with the spill #9, the gather #10), the error class (x3, <= 1e-5),
    the kernels launched, and a Chrome trace that names them."""
    import json

    from crp_tpu_torch.cli import bench_cli, suite_cli
    from crp_tpu_torch.kernels import spmm_pallas, spmm_ragged

    spmm_pallas.spmm_window_sg_presplit.launches = 0
    assert bench_cli.main(["synth:banded:3000:7:80", "64", "2", "0", "1",
                           "--engine=rowpara", "--devices=1", "--prec=x3"]) == 0
    out = capsys.readouterr().out
    assert float(out.strip().splitlines()[-1].split("=")[-1]) <= 1e-5
    assert spmm_pallas.spmm_window_sg_presplit.launches >= 3

    for k in (spmm_ragged.spmm_ragged_presplit, spmm_ragged.spmm_spill,
              spmm_ragged.spmm_gather):
        k.launches = 0
    assert suite_cli.main(["kernels", "synth:cplaw:8192:12:512", "64", "1",
                           "--engine=rowpara", "--list=pallas,gather", "--prec=x3",
                           "--ntest=2", "--inner=2", f"--trace={tmp_path}"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [(r["kernel_resolved"], r["kernel_detail"]["variant"]) for r in recs] == [
        ("pallas", "ragged"), ("gather", "gather")]
    for r in recs:
        assert r["backend"] == "cuda" and r["rel_fro_err"] <= 1e-5
    for k in (spmm_ragged.spmm_ragged_presplit, spmm_ragged.spmm_spill,
              spmm_ragged.spmm_gather):
        assert k.launches > 0, k.__name__
    events = json.loads((tmp_path / "suite_trace.json").read_text())["traceEvents"]
    names = " ".join(e.get("name", "") for e in events if e.get("cat") == "kernel")
    # #7 runs the wgmma body, #9 and #10 the row walk with and without C
    for body in ("x3_wgmma_kernel", "spill_rows_kernel<true", "spill_rows_kernel<false"):
        assert body in names, body


def _stacked_case(cuda_device, prec, dtype, p=4):
    a = banded_random_csr(2600, nnz_per_row=7, bandwidth=90, seed=99, dtype=dtype)
    d = csr_row_partition(a.rowptr, p)
    aligned = spmm_halo.align_displs(d, a.ncol)
    shards = [a.row_slice(int(d[i]), int(d[i + 1])) for i in range(p)]
    arrays, op = spmm_halo.build_halo_plan(shards, aligned, device=cuda_device,
                                           dtype=dtype, precision=prec)
    n = 48
    b = fill_b(0, a.ncol, 0, n, dtype=dtype)
    bs = np.zeros((p, op.min_b_rows, n), dtype)
    for i in range(p):
        bs[i, : aligned[i + 1] - aligned[i]] = b[aligned[i]:aligned[i + 1]]
    return arrays, op, torch.from_numpy(bs).to(cuda_device)


class _LocalOwners(spmm_halo.HaloPeers):
    """``HaloPeers`` over owners held apart in this process, as the ranks'
    mapped buffers hold them: their bases, and each owner's flag words
    (arrive, done) given by hand, its arrive word at ``arrived``; owner 0
    is this rank."""

    def __init__(self, owners, chunk_src, arrived, bound_s):
        dev = owners[0].device
        self.buf = owners[0][None]
        self._words = [torch.tensor([arrived, 0], dtype=torch.int64, device=dev)
                       for _ in owners]
        self.flags = self._words[0]
        self.status = torch.zeros(1, dtype=torch.int64, pin_memory=True)
        self.group, self.ranks, self.me, self.readers = None, tuple(range(len(owners))), 0, ()
        self.epoch, self.launches, self.barriers, self.drains = 1, 0, 0, 0
        self.bound_s = bound_s
        self.flag_launches = dict(wait=0, signal=0, done=0)
        self._owner = chunk_src[:, 0].cpu().numpy()
        self.views = list(owners)  # held, as the mapped buffers are: the kernel reads them
        self.bases = tuple(t.data_ptr() for t in owners)
        rows, self.ptrs16 = spmm_halo.chunk_rows(
            chunk_src, self.bases, owners[0].shape[1], owners[0].element_size())
        arrive, _ = spmm_halo.chunk_rows(chunk_src, [w.data_ptr() for w in self._words], 0, 1)
        self.chunk_pairs = torch.stack([rows, arrive], dim=1).contiguous()
        self._version = self.buf._version


def _owners_apart(cuda_device, prec, dtype, arrived, bound_s=30.0):
    arrays, op, bs = _stacked_case(cuda_device, prec, dtype)
    args = op.kernel_args(arrays, bs)
    b_read = args[5]  # B as the kernel reads it (bf16 at default)
    owners = [bs[i].to(b_read.dtype).clone() for i in range(bs.shape[0])]  # one allocation each
    return op, args, _LocalOwners(owners, args[4], arrived, bound_s)


@pytest.mark.parametrize("prec,dtype", [(p, d) for p, d, _ in POINTS])
def test_halo_owner_table_equals_stacked_launch(cuda_device, prec, dtype):
    """#12 with each owner's shard a separate allocation (the owners' bases
    given by hand, as the ranks' mapped buffers give them) and its flagged
    entry (every owner arrived) equals the one-card launch on the stacked
    B bit for bit: one body, the same rows in the same order, wherever the
    owners live; the trailing kernel raises this rank's done word."""
    op, args, peers = _owners_apart(cuda_device, prec, dtype, arrived=1)
    stacked = op.kernel(*args, min_b_rows=op.min_b_rows)
    before = spmm_halo.spmm_halo.launches
    got = spmm_halo.spmm_halo(*args[:5], peers.buf, *args[6:], min_b_rows=op.min_b_rows,
                              peers=peers)
    assert spmm_halo.spmm_halo.launches == before + 1
    assert got.shape == stacked.shape
    view = torch.int64 if got.dtype == torch.float64 else torch.int32
    assert torch.equal(got.view(view), stacked.view(view))
    torch.cuda.synchronize()
    assert peers.flags.tolist() == [1, 1] and peers.flag_launches["done"] == 1
    peers.check()


@pytest.mark.parametrize("prec,dtype", [(p, d) for p, d, _ in POINTS])
def test_halo_flags_wait_is_bounded(cuda_device, prec, dtype):
    """An owner that never arrives: every body's wait gives up after its
    bound (wall time), C comes out NaN, the done word carries the failure,
    and the next sync point raises ``HaloTimeout`` naming an owner."""
    import time

    op, args, peers = _owners_apart(cuda_device, prec, dtype, arrived=0, bound_s=0.2)
    t0 = time.perf_counter()
    got = spmm_halo.spmm_halo(*args[:5], peers.buf, *args[6:], min_b_rows=op.min_b_rows,
                              peers=peers)
    torch.cuda.synchronize()
    assert time.perf_counter() - t0 < 0.2 + 5.0
    assert bool(torch.isnan(got).all())
    assert peers.flags[1].item() == 1 | spmm_halo.HALO_FAILED
    with pytest.raises(spmm_halo.HaloTimeout, match="did not arrive|gave up"):
        peers.check()


def test_halo_flags_load_waits_for_readers(cuda_device):
    """``HaloPeers.load`` on one rank: with its reader's launches counted
    it writes B and raises its arrive word; a reader that falls behind
    (the count it waits for never comes) makes the wait give up after the
    bound, the arrive word carries the failure, and the next load raises."""
    import time

    chunk_src = torch.tensor([[0, 0], [0, 128]], dtype=torch.int32, device=cuda_device)
    peers = spmm_halo.HaloPeers((256, 8), torch.float32, cuda_device, None, (0,), 0,
                                chunk_src, readers=(0,), bound_s=0.2)
    assert (peers.barriers, peers.drains) == (0, 1)  # init: no group to wait for
    b = torch.randn((1, 200, 8), device=cuda_device)
    peers.load(b)
    torch.cuda.synchronize()
    assert peers.flags.tolist() == [1, 0] and torch.equal(peers.buf[0, :200], b[0])
    assert peers.flag_launches == dict(wait=1, signal=1, done=0)
    peers.launches = 5  # as if this rank had launched 5 times and its reader not
    t0 = time.perf_counter()
    peers.load(b)
    torch.cuda.synchronize()
    assert time.perf_counter() - t0 < 0.2 + 5.0
    assert peers.flags[0].item() == 2 | spmm_halo.HALO_FAILED
    with pytest.raises(spmm_halo.HaloTimeout, match="reader 0 did not finish"):
        peers.load(b)
    with pytest.raises(spmm_halo.HaloTimeout):
        peers.close()


def test_halo_across_two_processes_equals_one_card(cuda_device):
    """Two ranks on the one card (gloo for the control plane), one process
    each, ``RowParaSpmm(kernel="pallas_halo", mesh=make_mesh_1d(2))``: each
    rank's B buffer is mapped into its peer by CUDA IPC, and each rank's C
    shard, its gathered C and its panels equal the one-card engine's bit
    for bit at every point."""
    from tests.torch_dist_ranks import bits, run_ranks

    a = banded_random_csr(2600, nnz_per_row=7, bandwidth=90, seed=98, dtype=np.float32)
    d = csr_row_partition(a.rowptr, 2)
    cases = []
    for prec, dtype in (("x3", np.float32), ("default", np.float32),
                        ("highest", np.float32), ("highest", np.float64)):
        aa = CSRMatrix(a.nrow, a.ncol, a.rowptr, a.colidx, a.val.astype(dtype))
        cases.append(dict(engine="rowpara", a=aa, displs=d, n=40, dtype=dtype,
                          config=dict(kernel="pallas_halo", mxu_precision=prec),
                          b=np.asarray(fill_b(0, a.ncol, 0, 40, dtype=dtype))))
    per_rank = run_ranks(2, "engines_on_card", cases)
    for i, case in enumerate(cases):
        one = RowParaSpmm(case["a"], d, d, 40, device=cuda_device, dtype=case["dtype"],
                          config=SpmmConfig(**case["config"]))
        c1 = one.exec(case["b"])
        shards = one.exec_device(one.shard_b(case["b"]))
        packed = [bits(x) for x in one.packed]
        for r, got in enumerate(per_rank):
            g = got[i]
            assert g["kernel_kind"] == "pallas_halo"
            assert np.array_equal(g["c"], c1) and np.array_equal(g["again"], c1)
            assert np.array_equal(g["shard"][0], bits(shards[r]))
            ws, ws_rel, *panels, push, chunk_src = packed
            mine = [ws[r : r + 1], ws_rel[r : r + 1], *(t[r : r + 1] for t in panels),
                    push, chunk_src]
            for x, y in zip(g["packed"], mine, strict=True):
                assert np.array_equal(x, y)
