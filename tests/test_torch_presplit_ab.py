"""Kernel #5 (x3 with B pre-split to bf16 hi/lo) and the presplit-B
comparison, against the JAX package on the CPU.

``split_b_bf16`` bit for bit against JAX's and ``np_split_bf16``; the
plain version of ``spmm_window_sg_presplit_ab`` against JAX's
``spmm_window_pallas_sg_presplit_ab`` in interpret mode and, bit for bit,
against the plain version of #1; the wrapper's placement and dtype rules;
and ``sweep`` against JAX's three variants.  The CUDA kernel is held
against the plain version in ``test_torch_cuda.py``."""

import functools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from crp_tpu.kernels.spmm_pallas import (
    TK, np_split_bf16, pack_window_dense, spmm_window_pallas_sg_bf16,
    spmm_window_pallas_sg_presplit, spmm_window_pallas_sg_presplit_ab,
)
from crp_tpu.kernels.spmm_pallas import split_b_bf16 as jax_split_b_bf16

from crp_tpu_torch.cli import presplit_b_sweep
from crp_tpu_torch.kernels import spmm_pallas as tsp
from crp_tpu_torch.kernels.dispatch import pack_local_kernel
from crp_tpu_torch.sparse.synth import banded_random_csr, fill_b
from crp_tpu_torch.utils.norms import rel_fro_err

# between the packages: the same exact bf16 products summed in another order
TOL_PACKAGES = 1e-6
# against the fp64 reference: the JAX records' classes (x3; one bf16 pass
# as tests/test_kernels.py:309 holds it)
TOL_REF = {"presplit_a_x3": 1e-5, "presplit_ab_x3": 1e-5, "bf16_1pass": 1e-2}


def _bits(x):
    """uint16 bits of a bf16 torch tensor, JAX array or ml_dtypes array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _to_bf16_tensor(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int16)).view(torch.bfloat16)


def _b(a, rows, n):
    b = np.zeros((rows, n), np.float32)
    b[: a.ncol] = fill_b(0, a.ncol, 0, n, dtype=np.float32)
    return b


def _split_inputs():
    """Seeded fp32 values with bf16 rounding ties (the dropped 16 bits
    exactly 0x8000, kept bits odd and even), subnormals, zeros of both
    signs and large magnitudes."""
    rng = np.random.default_rng(11)
    hi = rng.integers(0x0080, 0x7F00, 20_000, dtype=np.uint32)  # normal exponents
    sign = rng.integers(0, 2, hi.size, dtype=np.uint32) << 15
    ties = (((hi | sign) << 16) | 0x8000).view(np.float32)
    sub_bits = rng.integers(1, 0x007FFFFF, 20_000, dtype=np.uint32)
    subnormals = (sub_bits | (sign << 16)).view(np.float32)
    x = np.concatenate([
        [0.0, -0.0] * 8,
        [3.38e38, -3.38e38, 3.4e38, -3.4e38, 1e38, -1e38],
        ties, subnormals,
        rng.standard_normal(10_000) * 1e-40,
        rng.standard_normal(10_000) * 1e30,
        rng.standard_normal(40_000),
    ]).astype(np.float32)
    return x[: x.size // 64 * 64].reshape(-1, 64)


def test_split_b_bf16_bits_match_jax_and_native():
    """Bit for bit the native split everywhere; JAX's hi everywhere and its
    lo wherever neither the input nor the remainder is subnormal: XLA on
    the CPU flushes subnormal operands and results of the subtraction to
    zero, where the port (like the native split and the CUDA kernels'
    in-kernel split) keeps them."""
    x = _split_inputs()
    assert np.any(x == 0) and np.any(np.signbit(x[x == 0]))
    bh, bl = tsp.split_b_bf16(torch.from_numpy(x))
    assert bh.dtype == bl.dtype == torch.bfloat16 and bh.shape == x.shape
    nh, nl = np_split_bf16(x)
    np.testing.assert_array_equal(_bits(bh), _bits(nh))
    np.testing.assert_array_equal(_bits(bl), _bits(nl))
    jh, jl = jax_split_b_bf16(jnp.asarray(x))
    np.testing.assert_array_equal(_bits(bh), _bits(jh))
    tiny = np.finfo(np.float32).tiny
    r = np.abs(x - bh.float().numpy())
    flushed = ((np.abs(x) < tiny) & (x != 0)) | ((r < tiny) & (r != 0))
    assert flushed.mean() < 0.5
    np.testing.assert_array_equal(_bits(bl)[~flushed], _bits(jl)[~flushed])
    assert np.all(np.abs(np.asarray(jl, np.float32)[flushed]) <= tiny)
    # the ties round to even, never truncate: some round up
    ties = (x.view(np.uint32) & 0xFFFF) == 0x8000
    up = _bits(bh)[ties] != (x.view(np.uint32)[ties] >> 16)
    assert up.any() and not up.all()


@pytest.mark.parametrize("bad", ["fp64", "1-d"])
def test_split_b_bf16_refuses_other_than_2d_fp32(bad):
    b = torch.zeros((8, 4), dtype=torch.float64) if bad == "fp64" else torch.zeros(8)
    with pytest.raises(ValueError, match="2-D fp32"):
        tsp.split_b_bf16(b)


@functools.lru_cache(maxsize=None)
def _jax_case():
    """The pack of tests/test_kernels.py:281-298 (banded, 3000 rows, seed
    92, Wc = W): the matrix, the pack, its bf16 halves and the sg plan."""
    a = banded_random_csr(3000, nnz_per_row=7, bandwidth=80, seed=92,
                          dtype=np.float32)
    p = pack_window_dense(a.rowptr, a.colidx, a.val, a.ncol)
    ah = p.tiles.astype(ml_dtypes.bfloat16)
    al = (p.tiles - ah.astype(np.float32)).astype(ml_dtypes.bfloat16)
    ws = np.asarray(p.ws, np.int64)
    SG = next(d for d in range(4, 1, -1) if p.G % d == 0)
    sgc = p.G // SG
    bases = ws[::SG][:sgc]
    spans = [int(ws[min((s + 1) * SG, p.G) - 1] + p.W - bases[s]) for s in range(sgc)]
    Wsg = -(-max(spans) // TK) * TK
    return a, p, ah, al, SG, Wsg, bases.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_outputs(n):
    """JAX's three variants in interpret mode, and the B they multiplied."""
    a, p, ah, al, SG, Wsg, bases = _jax_case()
    bp = _b(a, int(bases.max()) + Wsg, n)
    bh, bl = jax_split_b_bf16(jnp.asarray(bp))
    kw = dict(SG=SG, Wsg=Wsg, W=p.W, TM=p.TM, Wc=p.W, interpret=True)
    outs = {
        "presplit_a_x3": spmm_window_pallas_sg_presplit(p.ws, bases, ah, al, bp, **kw),
        "presplit_ab_x3": spmm_window_pallas_sg_presplit_ab(p.ws, bases, ah, al,
                                                            bh, bl, **kw),
        "bf16_1pass": spmm_window_pallas_sg_bf16(p.ws, bases, ah, bh, **kw),
    }
    return {k: np.asarray(v) for k, v in outs.items()}, bp


@pytest.mark.parametrize("n", [48, 100])  # 100 pads in JAX, is masked in the port
def test_plain_matches_jax_interpret(n):
    a, p, ah, al, _, _, _ = _jax_case()
    outs, bp = _jax_outputs(n)
    bh, bl = tsp.split_b_bf16(torch.from_numpy(bp))
    c = tsp.spmm_window_sg_presplit_ab_plain(
        torch.from_numpy(np.asarray(p.ws, np.int32)), _to_bf16_tensor(ah),
        _to_bf16_tensor(al), bh, bl).numpy()
    c_jax = outs["presplit_ab_x3"]
    assert c.dtype == c_jax.dtype == np.float32 and c.shape == c_jax.shape
    assert rel_fro_err(c_jax.astype(np.float64), c) <= TOL_PACKAGES
    ref = a.spmm_ref(bp[: a.ncol].astype(np.float64))
    assert rel_fro_err(ref, c[: a.nrow]) <= TOL_REF["presplit_ab_x3"]


@functools.lru_cache(maxsize=None)
def _port_pack():
    """The port's x3 pack of a banded matrix with pad groups (max_m past
    nrow), as the CUDA tests and chip_smoke.py's kernel phase build it."""
    a = banded_random_csr(3000, nnz_per_row=7, bandwidth=80, seed=91, dtype=np.float32)
    arrays, op = pack_local_kernel([(a.rowptr, a.colidx.astype(np.int32), a.val)],
                                   a.nrow + 300, np.float32, "pallas",
                                   device="cpu", mxu_precision="x3")
    assert op.scheme == "x3"
    return a, tuple(x[0] for x in arrays), op


@pytest.mark.parametrize("n", [16, 48, 100, 256])
def test_plain_equals_presplit_plain_bit_for_bit(n):
    a, arrs, op = _port_pack()
    rng = np.random.default_rng(n)
    b = _b(a, op.min_b_rows, n) * rng.standard_normal((op.min_b_rows, n)).astype(np.float32)
    rB = torch.from_numpy(b)
    ws, ah, al = arrs[:3]
    c1 = tsp.spmm_window_sg_presplit_plain(ws, ah, al, rB)
    c5 = tsp.spmm_window_sg_presplit_ab_plain(ws, ah, al, *tsp.split_b_bf16(rB))
    assert torch.equal(c5, c1)
    assert not torch.any(c5[a.nrow:])  # pad groups come out zero


def test_wrapper_runs_plain_on_cpu_without_launching():
    a, arrs, op = _port_pack()
    ws, ah, al = arrs[:3]
    bh, bl = tsp.split_b_bf16(torch.from_numpy(_b(a, op.min_b_rows, 48)))
    before = tsp.spmm_window_sg_presplit_ab.launches
    got = tsp.spmm_window_sg_presplit_ab(ws, ah, al, bh, bl, min_b_rows=op.min_b_rows)
    assert tsp.spmm_window_sg_presplit_ab.launches == before
    assert torch.equal(got, tsp.spmm_window_sg_presplit_ab_plain(ws, ah, al, bh, bl))
    assert tsp.spmm_window_sg_presplit_ab in tsp.KERNELS


def test_wrapper_raises_on_mixed_and_other_devices():
    def bf16(*shape, device="cpu"):
        return torch.zeros(shape, dtype=torch.bfloat16, device=device)

    ws = torch.zeros(1, dtype=torch.int32, device="meta")
    args = (bf16(1, 256, 128, device="meta"), bf16(1, 256, 128, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tsp.spmm_window_sg_presplit_ab(ws, *args, bf16(128, 4, device="meta"),
                                       bf16(128, 4, device="meta"), min_b_rows=128)
    with pytest.raises(ValueError, match="several devices"):
        tsp.spmm_window_sg_presplit_ab(ws, *args, bf16(128, 4), bf16(128, 4),
                                       min_b_rows=128)


@pytest.mark.parametrize("which", ["bh", "bl"])
def test_wrapper_refuses_fp32_halves(which):
    a, arrs, op = _port_pack()
    b = torch.from_numpy(_b(a, op.min_b_rows, 16))
    bh, bl = tsp.split_b_bf16(b)
    halves = {"bh": bh, "bl": bl, which: b}
    with pytest.raises(ValueError, match="bf16"):
        tsp.spmm_window_sg_presplit_ab(*arrs[:3], halves["bh"], halves["bl"],
                                       min_b_rows=op.min_b_rows)


@pytest.mark.parametrize("n", [48, 100])
def test_sweep_matches_jax_variants(n, capsys):
    """The whole slice on the CPU: ``sweep`` packs the matrix through the
    port's x3 pack and runs the three variants; each variant's C (on that
    pack) agrees with JAX's interpret-mode kernel (on JAX's pack of the
    same matrix), and each record is within its class."""
    a = _jax_case()[0]
    recs = presplit_b_sweep.sweep(a, n, "cpu", timing=(1, 1))
    by = {r["variant"]: r for r in recs}
    assert list(by) == ["presplit_a_x3", "presplit_ab_x3", "bf16_1pass"]
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("# G=") and len(printed) == 4
    assert all(r["device"] == "cpu" and r["exec_ms"] > 0 for r in recs)
    ab = by["presplit_ab_x3"]
    assert ab["max_abs_vs_presplit_a"] == 0.0
    assert ab["split_ms"] > 0 and ab["split_exec_ms"] > 0
    assert ab["rel_fro_err"] == by["presplit_a_x3"]["rel_fro_err"]

    jax_outs, _ = _jax_outputs(n)
    arrs, op = presplit_b_sweep.pack_x3(a, torch.device("cpu"))
    rB = torch.from_numpy(_b(a, op.min_b_rows, n))
    ref = a.spmm_ref(rB[: a.ncol].double().numpy())
    for name, fn in presplit_b_sweep.variants(*arrs[:3], rB, op.min_b_rows).items():
        c = fn()[: a.nrow].double().numpy()
        c_jax = jax_outs[name][: a.nrow].astype(np.float64)
        assert rel_fro_err(c_jax, c) <= TOL_PACKAGES, name
        assert rel_fro_err(ref, c_jax) <= TOL_REF[name], name
        assert by[name]["rel_fro_err"] <= TOL_REF[name], name
        assert by[name]["rel_fro_err"] == pytest.approx(
            rel_fro_err(ref[:, :presplit_b_sweep.ERR_COLS],
                        c[:, :presplit_b_sweep.ERR_COLS]), rel=1e-12), name


def test_sweep_refuses_a_matrix_off_the_x3_pack():
    """A matrix whose windows run backwards has no super-group plan: the
    sweep's pack refuses it instead of timing another kernel."""
    from crp_tpu_torch.sparse.csr import CSRMatrix

    rng = np.random.default_rng(96)
    rows = np.repeat(np.arange(1000), 5)
    cols = np.clip(999 - rows + rng.integers(-30, 31, rows.size), 0, 999)
    key = np.unique(rows * 1000 + cols)
    a = CSRMatrix.from_coo(1000, 1000, key // 1000, key % 1000,
                           rng.standard_normal(key.size), dtype=np.float32)
    with pytest.raises(ValueError, match="super-grouped x3 pack"):
        presplit_b_sweep.pack_x3(a, torch.device("cpu"))
