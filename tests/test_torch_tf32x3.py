"""The arithmetic of the 3xTF32 tile body (kernels #3
``crp_window_sg_f32``, #4 ``crp_window_f32``, #12 ``crp_halo_f32`` and #6
``crp_ragged_f32`` at ``highest``), argued on the CPU.

``split_tf32`` pinned against an exact float64 rounding: low 13 bits
zero, ties away from zero, subnormals, signed zeros, inf and NaN, and the
split's error bound.  Then the kernels' three TF32 products are emulated
on the packs that ``test_torch_window.py`` and ``test_torch_halo.py``
build, on the JAX package's super-grouped pack and on ragged packs (each
group walking its chunks), and held against JAX's ``HIGHEST`` kernels in
interpret mode (``spmm_window_pallas_sg`` through the pack's own local
function and ``halo_spmm_local`` through the JAX engine on the CPU mesh
here; ``spmm_window_pallas`` in ``test_torch_tf32x3_window.py`` and
``spmm_ragged`` in ``test_torch_tf32x3_ragged.py``, the emulation shared
through ``tests/tf32x3_emulation.py``) under the card's tolerances:
relative Frobenius error
and max error over max |p| both within 1e-6.  The CUDA kernels are held
against their plain versions in ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from crp_tpu_torch.kernels import spmm_halo as th
from crp_tpu_torch.kernels.spmm_pallas import (
    round_tf32, spmm_window_sg_plain, split_tf32, tf32_panels,
)
from crp_tpu_torch.plan.partition1d import csr_row_partition
from crp_tpu_torch.sparse.synth import fill_b
from crp_tpu_torch.utils.norms import rel_fro_err
from tests.test_torch_halo import _banded, _jax_rowpara
from tests.test_torch_halo import _shards as _halo_shards
from tests.test_torch_spmm_pallas import _case
from tests.tf32x3_emulation import (
    CPU, TOL_FRO, TOL_MAX, _errors, one_pass_tf32, tf32x3_windows,
)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _inputs(kind):
    """Seeded fp32 values of one family."""
    rng = np.random.default_rng(hash(kind) % 2**32)
    if kind == "normals":
        x = rng.standard_normal(50_000) * np.exp2(rng.integers(-120, 120, 50_000))
    elif kind == "ties":  # dropped 13 bits exactly half a TF32 ulp, kept bits odd and even
        # the 18 kept magnitude bits (exponent and 10 mantissa bits), normal
        hi = rng.integers(0x00400, 0x3FBFF, 50_000, dtype=np.uint32)
        sign = rng.integers(0, 2, hi.size, dtype=np.uint32) << 31
        x = ((hi << 13) | 0x1000 | sign).view(np.float32)
    elif kind == "subnormals":
        sign = rng.integers(0, 2, 50_000, dtype=np.uint32) << 31
        x = (rng.integers(1, 0x007FFFFF, 50_000, dtype=np.uint32) | sign).view(np.float32)
    elif kind == "near one":  # every pattern of the dropped bits around 1
        x = (np.uint32(0x3F800000) + np.arange(1 << 14, dtype=np.uint32)).view(np.float32)
    else:
        raise ValueError(kind)
    return np.asarray(x, np.float32)


def _rna_tf32_exact(x):
    """Round fp32 ``x`` to TF32, ties away from zero, in float64 (exact):
    the grid is 2^(e - 10) for |x| in [2^e, 2^(e+1)), 2^-136 below 2^-126."""
    x = np.asarray(x, np.float64)
    mag = np.abs(x)
    e = np.frexp(mag)[1] - 1  # |x| in [2^e, 2^(e+1))
    ulp = np.exp2(np.maximum(e, -126) - 10)
    out = np.copysign(np.floor(mag / ulp + 0.5) * ulp, x)
    with np.errstate(over="ignore"):
        return out.astype(np.float32)


FAMILIES = ["normals", "ties", "subnormals", "near one"]


@pytest.mark.parametrize("kind", FAMILIES)
def test_round_tf32_is_exact_rna(kind):
    """Bit for bit the exact round-to-nearest-ties-away, sign kept, low 13
    bits zero in both halves of the split."""
    x = _inputs(kind)
    big, small = split_tf32(torch.from_numpy(x))
    big, small = big.numpy(), small.numpy()
    np.testing.assert_array_equal(_bits(big), _bits(_rna_tf32_exact(x)))
    np.testing.assert_array_equal(_bits(small), _bits(_rna_tf32_exact(x - big)))
    assert not np.any(_bits(big) & 0x1FFF) and not np.any(_bits(small) & 0x1FFF)
    nz = big != 0
    assert np.array_equal(np.signbit(big[nz]), np.signbit(x[nz]))


def test_round_tf32_ties_go_away_from_zero():
    x = _inputs("ties")
    big = round_tf32(torch.from_numpy(x)).numpy()
    assert np.all(np.abs(big.astype(np.float64)) > np.abs(x.astype(np.float64)))
    assert np.array_equal(np.signbit(big), np.signbit(x))
    # 1 + 2^-11 is halfway between 1 and 1 + 2^-10: away from zero
    one = torch.tensor([1 + 2**-11, -(1 + 2**-11), 1 + 3 * 2**-11], dtype=torch.float32)
    assert round_tf32(one).tolist() == [1 + 2**-10, -(1 + 2**-10), 1 + 2 * 2**-10]


@pytest.mark.parametrize("kind", ["normals", "ties", "near one"])
def test_split_tf32_error_bound(kind):
    """|x - big - small| <= 2^-22 |x| (float64, exact) where small's
    rounding is not cut off by the subnormal grid: |x| >= 2^-100."""
    x = _inputs(kind)
    x = x[np.abs(x) >= 2.0**-100]
    big, small = (t.numpy().astype(np.float64) for t in split_tf32(torch.from_numpy(x)))
    x64 = x.astype(np.float64)
    assert np.all(np.abs(x64 - big - small) <= np.exp2(-22) * np.abs(x64))
    # the remainder is exact in fp32: x - big loses nothing
    np.testing.assert_array_equal(
        (x - big.astype(np.float32)).astype(np.float64), x64 - big)


def test_split_tf32_zeros_subnormals_and_specials():
    """Signed zeros keep their sign in big, small is +0; a subnormal rounds
    on the 2^-136 grid; inf and NaN are left alone in big (small NaN, as
    inf - inf on the card)."""
    x = torch.tensor([0.0, -0.0, 2**-140, -(2**-137), 3 * 2**-137, float("inf"),
                      -float("inf"), float("nan")], dtype=torch.float32)
    big, small = split_tf32(x)
    assert _bits(big.numpy())[:2].tolist() == [0x00000000, 0x80000000]
    assert _bits(small.numpy())[:2].tolist() == [0, 0]
    assert big[2:5].tolist() == [0.0, -(2**-136), 2 * 2**-136]  # ties away
    assert big[5].item() == float("inf") and big[6].item() == -float("inf")
    assert torch.isnan(big[7]) and torch.isnan(small[5:]).all()
    with pytest.raises(ValueError):
        round_tf32(x.double())


# ------------------------------------------------------ the three products


@pytest.mark.parametrize("n", [16, 37, 100])
def test_emulated_window_sg_matches_jax_highest(n):
    """On #3's super-grouped pack (JAX's, of a banded matrix with pad
    groups), the emulated 3xTF32 product against JAX's local function,
    ``spmm_window_pallas_sg(interpret=True)`` at HIGHEST, and against the
    port's plain version (the fp32 ``bmm``): within 1e-6 both ways; one
    TF32 pass is not."""
    a, arrays, fn, tensors, op = _case("highest", np.float32)
    assert op.scheme == "tf32"  # (ws, planes, bases): the super-grouped pack
    ws, planes = (t[0] for t in tensors[:2])
    tiles = tf32_panels(planes)  # the fp32 panels the TF32 planes were split from
    b = np.random.default_rng(n).standard_normal((fn.min_b_rows, n)).astype(np.float32)
    bt = torch.from_numpy(b)
    want = np.asarray(fn(tuple(x[0] for x in arrays), b))
    got = tf32x3_windows(ws, tiles, bt)
    assert got.shape == want.shape and not torch.any(got[a.nrow:])  # pad groups
    for ref in (want, spmm_window_sg_plain(ws, tiles, bt).numpy()):
        max_rel, fro = _errors(ref, got.numpy())
        assert max_rel <= TOL_MAX and fro <= TOL_FRO, (max_rel, fro)
    assert _errors(want, one_pass_tf32(ws, tiles, bt).numpy())[1] > 10 * TOL_FRO


@pytest.mark.parametrize("n", [13, 40])
@pytest.mark.parametrize("p", [2, 4])
def test_emulated_halo_matches_jax_highest(devices8, p, n):
    """On #12's plan (p shards, panels and pushes as JAX's), the emulated
    3xTF32 product of every shard's windows against the JAX engine with
    ``kernel="pallas_halo"`` at HIGHEST, whose ``halo_spmm_local`` runs in
    interpret mode on the CPU mesh: within 1e-6 both ways."""
    a = _banded(np.float32, seed=80 + p)
    b = fill_b(0, a.ncol, 0, n, dtype=np.float32)
    displs, j = _jax_rowpara(a, p, n, np.float32, "highest", devices8)
    want = j.exec(b)
    shards, aligned = _halo_shards(a, p)
    arrays, op = th.build_halo_plan(shards, aligned, device=CPU, dtype=np.float32,
                                    precision="highest")
    _, ws_rel, big, small, push, _ = arrays
    panels = tf32_panels((big, small))  # the fp32 panels the TF32 planes were split from
    bs = np.zeros((p, op.min_b_rows, n), np.float32)
    for i in range(p):
        bs[i, : aligned[i + 1] - aligned[i]] = b[aligned[i]:aligned[i + 1]]
    buf = th.halo_buffers(push, torch.from_numpy(bs), op.buf_rows)
    d = csr_row_partition(a.rowptr, p)
    np.testing.assert_array_equal(d, displs)
    outs = [tf32x3_windows(ws_rel[i], panels[i], buf[i]).numpy() for i in range(p)]
    for i in range(p):
        assert not np.any(outs[i][d[i + 1] - d[i]:])
    got = np.concatenate([outs[i][: d[i + 1] - d[i]] for i in range(p)])
    assert got.shape == want.shape
    max_rel, fro = _errors(want, got)
    assert max_rel <= TOL_MAX and fro <= TOL_FRO, (max_rel, fro)
    assert rel_fro_err(a.spmm_ref(b.astype(np.float64)), got) <= 1e-6
