"""The summation order of the wgmma body (kernels #1
``crp_window_sg_presplit``, #5 ``crp_window_sg_presplit_ab``, #4
``crp_window_x3``, #12 ``crp_halo_x3`` and the ragged #7
``crp_ragged_presplit`` at x3, and #2 ``crp_window_sg_bf16`` and the
ragged #8 ``crp_ragged_bf16`` in its one-pass mode), argued on the CPU.

The body computes C^T = B^T A^T: per 16-deep k step three products, small
terms first, (bh, A_lo), (bl, A_hi), (bh, A_hi), with B split to bf16 hi/lo
in RNE; each 32-row k slice sums into a fresh fp32 accumulator, which is
added to the running sum with IEEE fp32 adds.  Here that order is emulated
(each k16 product exact in float64, rounded once to fp32 into the slice's
sum) on the JAX package's super-grouped x3 pack of a banded matrix with
pad groups, and held against JAX's ``_window_kernel_sg_presplit`` in
interpret mode (the pack's own local function on the CPU) and against the
port's plain version ``spmm_window_sg_presplit_plain``; then on #4's
multi-shard pack (the bf16 pair, split once at pack time) against JAX's x3
``_window_kernel`` on JAX's fp32 panels, shard by shard.  #12 runs the
same body on the same pair, with B's rows looked up by chunk.  The
one-pass mode's order (one exact product per k16 into the slice's fresh
accumulator, the slices added in IEEE fp32) is emulated on JAX's
super-grouped ``default`` pack and held against JAX's
``_window_kernel_sg_bf16`` in interpret mode and the plain version.  On
the port's two-shard ragged packs (hub groups, dummy chunks, the first
shard's trailing no-op steps, pad groups) both orders walk each group's
chunks as one run of slices, as the kernel's ring does, and are held
against JAX's ``spmm_ragged_presplit`` / ``spmm_ragged_bf16`` in
interpret mode and the port's plain versions, shard by shard
(``test_torch_x3_ragged_walk_n16.py``, ``_n37.py``, ``_n100.py``; the
emulation is ``tests/x3_order_emulation.py``).

Tolerance: max |e - r| / max |r| and the relative Frobenius error both
within 1e-6.  All three sum the same exact bf16 x bf16 products in fp32,
in different orders; reordering a row's fp32 sum moves it by a few fp32
ulps of its terms, ~1e-7 here, and 1e-6 is the bound the card holds #1 to
against its plain version (``chip_smoke.py`` TOL_PLAIN, TOL_PLAIN_FRO).
One bf16 pass (ah x bh alone) is far outside it, so the check can tell.
The CUDA kernel is held against the plain version in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from crp_tpu.kernels import dispatch as jd
from crp_tpu.kernels.spmm_pallas import WindowDense, spmm_window_pallas

from crp_tpu_torch.kernels import dispatch as td
from crp_tpu_torch.kernels.spmm_pallas import (
    spmm_window_sg_bf16_plain, spmm_window_sg_presplit_plain, split_b_bf16,
)
from tests.test_torch_spmm_pallas import _case
from tests.test_torch_window import _shards
from tests.tf32x3_emulation import _errors
from tests.x3_order_emulation import TOL, one_pass_wgmma_order, x3_wgmma_order


@pytest.mark.parametrize("n", [16, 37, 100])
def test_x3_wgmma_order_matches_jax_and_plain(n):
    """The emulated order against JAX's x3 kernel in interpret mode and the
    port's plain version, within 1e-6 both ways; pad groups zero; one bf16
    pass out of that bound."""
    a, arrays, fn, tensors, op = _case("x3", np.float32)  # JAX's pack, pad groups
    assert op.scheme == "x3"
    ws, ah, al = (t[0] for t in tensors[:3])
    b = np.random.default_rng(n).standard_normal((fn.min_b_rows, n)).astype(np.float32)
    bt = torch.from_numpy(b)
    want = np.asarray(fn(tuple(x[0] for x in arrays), b))
    got = x3_wgmma_order(ws, ah, al, bt)
    assert got.shape == want.shape and not torch.any(got[a.nrow:])
    for ref in (want, spmm_window_sg_presplit_plain(ws, ah, al, bt).numpy()):
        max_rel, fro = _errors(ref, got.numpy())
        assert max_rel <= TOL and fro <= TOL, (max_rel, fro)
    G, TM, W = ah.shape
    win = bt[ws.long()[:, None] + torch.arange(W)]
    one_pass = torch.bmm(ah.float(), win.to(torch.bfloat16).float()).reshape(G * TM, -1)
    assert _errors(want, one_pass.numpy())[1] > 10 * TOL


@pytest.mark.parametrize("n", [16, 37, 100])
def test_one_pass_wgmma_order_matches_jax_and_plain(n):
    """#2's emulated order on JAX's super-grouped default pack (pad groups)
    against JAX's one-pass kernel in interpret mode (the pack's own local
    function, B cast to bf16 as it casts it) and the port's plain version,
    within 1e-6 both ways; pad groups zero; the same product on the
    unrounded fp32 B is out of that bound, so the check sees B's bf16."""
    a, arrays, fn, tensors, op = _case("default", np.float32)
    assert op.scheme == "bf16"
    ws, ah = (t[0] for t in tensors[:2])
    b = np.random.default_rng(n).standard_normal((fn.min_b_rows, n)).astype(np.float32)
    bt = torch.from_numpy(b)
    bh = bt.to(torch.bfloat16)
    want = np.asarray(fn(tuple(x[0] for x in arrays), b))
    got = one_pass_wgmma_order(ws, ah, bh)
    assert got.shape == want.shape and not torch.any(got[a.nrow:])
    for ref in (want, spmm_window_sg_bf16_plain(ws, ah, bh).numpy()):
        max_rel, fro = _errors(ref, got.numpy())
        assert max_rel <= TOL and fro <= TOL, (max_rel, fro)
    G, TM, W = ah.shape
    win = bt[ws.long()[:, None] + torch.arange(W)]
    fp32_b = torch.bmm(ah.double(), win.double()).reshape(G * TM, -1)
    assert _errors(want, fp32_b.numpy())[1] > 10 * TOL


@pytest.mark.parametrize("n", [16, 37])
def test_x3_wgmma_order_on_the_multi_shard_pack(n):
    """#4 at x3: the emulated order on the port's 3-shard pair pack (an
    empty shard, pad groups) against JAX's x3 ``_window_kernel``
    (``spmm_window_pallas`` in interpret mode) on JAX's fp32 panels and
    against the op's plain version, shard by shard, within 1e-6 both ways;
    the empty shard and pad groups zero."""
    _, shards, max_m = _shards(3, np.float32)
    arrays, op = td._pack_window(shards, max_m + 300, np.float32, "x3", torch.device("cpu"))
    assert op.scheme == "window_x3"
    ws_j, tiles_j = jd._pack_pallas_uniform(shards, max_m + 300, np.float32, "x3")[0]
    b = np.random.default_rng(n).standard_normal((op.min_b_rows, n)).astype(np.float32)
    bt = torch.from_numpy(b)
    G, TM, W = tiles_j.shape[1:]
    for i, sh in enumerate(shards):
        arrs = tuple(x[i] for x in arrays)
        got = x3_wgmma_order(*arrs, bt)
        nrow = len(sh[0]) - 1 if len(sh[1]) else 0
        assert got.shape == (G * TM, n) and not torch.any(got[nrow:])
        if nrow == 0:
            continue
        packed = WindowDense(nrow=G * TM, ncol=b.shape[0], TM=TM, G=G, W=W,
                             ws=ws_j[i], tiles=tiles_j[i])
        want = np.asarray(spmm_window_pallas(packed, b, precision="x3", interpret=True))
        for ref in (want, op.plain(*op.kernel_args(arrs, bt)).numpy()):
            max_rel, fro = _errors(ref, got.numpy())
            assert max_rel <= TOL and fro <= TOL, (i, max_rel, fro)


def test_x3_wgmma_order_splits_b_in_rne():
    """The emulation's split is the kernels' RNE split: hi + lo recovers
    x to within 2^-16 relative, and hi rounds to nearest, so the remainder
    lo takes the sign opposite to x's about half the time (a truncating
    split's remainder always has x's sign)."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((64, 8)).astype(np.float32))
    hi, lo = split_b_bf16(x)
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0**-16 * x.double().abs()).all())
    flipped = float((lo.float() * x < 0).float().mean())
    assert 0.3 < flipped < 0.7


def test_feed_split_edits_apply_to_the_body():
    """``crp_tpu_torch.cli.x3_feed_split`` compiles variants of the x3 body
    with its products or copies cut out by editing a copy of its header:
    each edit's anchor is in the header exactly once, and each cut is
    under its macro."""
    from crp_tpu_torch.cli import x3_feed_split

    from crp_tpu_torch.kernels import _build

    text = x3_feed_split.edited_header()
    body = (_build.CSRC / "x3_wgmma.cuh").read_text()
    macros = ("X3_NO_PRODUCTS", "X3_NO_PANELS", "X3_NO_B")
    assert all(text.count(m) == 1 and m not in body for m in macros)
    assert text.count("#endif") - body.count("#endif") == len(macros)
    assert {m for ms in x3_feed_split.VARIANTS.values() for m in ms} == set(macros)
