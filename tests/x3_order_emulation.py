"""The wgmma body's summation order emulated on the CPU, shared by
``test_torch_x3_order.py`` and the ragged-walk files
``test_torch_x3_ragged_walk_n16.py``, ``_n37.py`` and ``_n100.py`` (one
value of n each, so that the test runner can spread them): the x3 and
one-pass orders, the JAX bf16 view of a torch tensor, the naive chunk
products, and the ragged walk's check.  ``test_torch_x3_order.py``'s
docstring states the order and the tolerance."""

import jax.numpy as jnp
import numpy as np
import torch

import tests.torch_threads  # noqa: F401  (one torch thread a test process)

from crp_tpu.kernels import spmm_ragged as js

from crp_tpu_torch.kernels.spmm_pallas import split_b_bf16
from crp_tpu_torch.kernels.spmm_ragged import (
    first_ptr, spmm_ragged_bf16_plain, spmm_ragged_presplit_plain,
)
from tests.tf32x3_emulation import _errors, _ragged_pack, _walk

TOL = 1e-6
K16 = 16     # k rows of one wgmma
SLICE = 32   # k rows summed into one fresh accumulator


def _walk_slices(G, TM, W, n, group_ptr, counts, products):
    """The wgmma body's sum over a pack's walk: group g takes its chunks
    [group_ptr[g], group_ptr[g + 1]) in order (``counts`` of them), each
    as W / 32 k slices; ``products(st, s)`` are the k16 products of the
    chunks ``st`` over the k rows ``s``, each exact in float64, rounded
    once to fp32 into the slice's fresh accumulator in turn; the slices
    are added to the running sum in IEEE fp32."""
    acc = torch.zeros((G, TM, n), dtype=torch.float32)
    for j in range(int(counts.max(initial=0))):  # every group's j-th chunk
        gs = torch.from_numpy(np.flatnonzero(counts > j))
        st = torch.from_numpy(group_ptr[:-1][counts > j] + j)
        for k0 in range(0, W, SLICE):
            part = torch.zeros((len(gs), TM, n), dtype=torch.float32)
            for k in range(k0, k0 + SLICE, K16):
                for prod in products(st, slice(k, k + K16)):
                    part = (part.double() + prod).float()
            acc[gs] += part
    return acc.reshape(G * TM, -1)


def x3_wgmma_order(ws, ah, al, b, group_ptr=None):
    """C of the x3 wgmma body, emulated: the B windows split to bf16 hi/lo
    in RNE, per k16 step the three products small first, each an exact sum
    rounded once to fp32 into the slice's fresh accumulator, the slices
    added in IEEE fp32.  With ``group_ptr`` (a ragged pack: ``ws`` its
    chunk starts) group g walks its chunks [group_ptr[g], group_ptr[g + 1])
    as one run of slices, the kernel's ragged walk; else every group owns
    the one chunk g (a uniform pack)."""
    G, counts, gp = _walk(ah, group_ptr)
    S, TM, W = ah.shape
    win = b[ws.long()[:, None] + torch.arange(W)]
    bh, bl = (t.double().view(S, W, -1) for t in split_b_bf16(win.reshape(S * W, -1)))
    ah, al = ah.double(), al.double()

    def products(st, s):
        return [torch.bmm(x[st, :, s], y[st, s]) for x, y in ((al, bh), (ah, bl), (ah, bh))]

    return _walk_slices(G, TM, W, b.shape[1], gp, counts, products)


def one_pass_wgmma_order(ws, ah, bh, group_ptr=None):
    """C of the wgmma body's one-pass mode (#2, #8), emulated: per k16 step
    the one product ah x bh (B already bf16), an exact sum rounded once to
    fp32 into the slice's fresh accumulator, the 32-row slices added in
    IEEE fp32.  The kernel's two 64-row halves of a block are two partials
    of distinct rows, each summed in this order.  ``group_ptr`` as in
    :func:`x3_wgmma_order`."""
    G, counts, gp = _walk(ah, group_ptr)
    _, TM, W = ah.shape
    win = bh[ws.long()[:, None] + torch.arange(W)].double()
    ah = ah.double()

    def products(st, s):
        return [torch.bmm(ah[st, :, s], win[st, s])]

    return _walk_slices(G, TM, W, bh.shape[1], gp, counts, products)


def _jax_bf16(x):
    """A bf16 torch tensor as the same bits in a JAX bf16 array."""
    return jnp.asarray(x.view(torch.int16).numpy().view(jnp.bfloat16))


def _chunk_products(starts, ah, b, group_ptr):
    """Each group's sum over its chunks of ah x B's rows at the chunk's
    start, in float64 and rounded once to fp32: the product without the
    kernel's rounding of B, or (with ``b`` the bf16 hi of B) without its lo
    half."""
    G, counts, _ = _walk(ah, group_ptr)
    _, TM, W = ah.shape
    st = torch.arange(int(group_ptr[-1]))
    win = b[starts.long()[st, None] + torch.arange(W)].double()
    out = torch.zeros((G, TM, b.shape[1]), dtype=torch.float64)
    out.index_add_(0, torch.from_numpy(np.repeat(np.arange(G), counts)),
                   torch.bmm(ah[st].double(), win))
    return out.float().reshape(G * TM, -1)


def check_ragged_walk(prec, TM, Wc, n):
    """#7 (x3) and #8 (default): the emulated order with each group walking
    its chunks (the port's ``group_ptr``, which stops short of a shard's
    trailing no-op steps) on the port's two-shard ragged packs against
    JAX's ``spmm_ragged_presplit`` / ``spmm_ragged_bf16`` in interpret
    mode and the port's plain versions, shard by shard, within 1e-6 both
    ways; equal bit for bit to JAX's whole step range walked (the no-op
    steps add nothing); the dummy chunks' groups and pad groups zero; one
    bf16 pass (x3), or the product on the unrounded fp32 B (default),
    outside the bound."""
    a, nrows, arrays, op = _ragged_pack(TM, Wc, prec)
    step_g, step_first, starts = arrays[:3]
    panels = arrays[3 : 3 + op.n_panels]
    group_ptr = arrays[-1]
    assert int(group_ptr[0, -1]) < panels[0].shape[1]  # the first shard's no-op steps
    assert int(np.diff(group_ptr.numpy(), axis=1).max()) > 1  # multi-chunk groups
    G = group_ptr.shape[1] - 1
    b = np.random.default_rng(n).standard_normal((op.min_b_rows, n)).astype(np.float32)
    bt = torch.from_numpy(b)
    bh = bt.to(torch.bfloat16)
    worst_naive = 0.0
    for i, nrow in enumerate(nrows):
        gp = group_ptr[i].numpy()
        ah = panels[0][i]
        jargs = (step_g[i].numpy(), step_first[i].numpy(), starts[i].numpy())
        kw = dict(G=G, TM=TM, Wc=Wc, interpret=True)
        if prec == "x3":
            al = panels[1][i]
            want = js.spmm_ragged_presplit(*jargs, _jax_bf16(ah), _jax_bf16(al), b, **kw)
            plain = spmm_ragged_presplit_plain(step_g[i], group_ptr[i], starts[i], ah, al, bt)

            def order(ptr):
                return x3_wgmma_order(starts[i], ah, al, bt, ptr)

            naive = _chunk_products(starts[i], ah, bh.float(), gp)  # ah x bh alone
        else:
            want = js.spmm_ragged_bf16(*jargs, _jax_bf16(ah), _jax_bf16(bh), **kw)
            plain = spmm_ragged_bf16_plain(step_g[i], group_ptr[i], starts[i], ah, bh)

            def order(ptr):
                return one_pass_wgmma_order(starts[i], ah, bh, ptr)

            naive = _chunk_products(starts[i], ah, bt, gp)  # B not rounded to bf16
        want = np.asarray(want)
        got = order(gp)
        assert torch.equal(got, order(first_ptr(step_first[i].numpy())))
        assert not torch.any(got[nrow:])  # pad groups
        dummy = [g for g in range(G) if gp[g + 1] - gp[g] == 1
                 and int(starts[i][gp[g]]) == 0 and not torch.any(ah[gp[g]].float())]
        assert dummy and all(not torch.any(got[g * TM:(g + 1) * TM]) for g in dummy)
        for ref in (want, plain.numpy()):
            max_rel, fro = _errors(ref, got.numpy())
            assert max_rel <= TOL and fro <= TOL, (i, max_rel, fro)
        worst_naive = max(worst_naive, _errors(want, naive.numpy())[1])
    assert worst_naive > 10 * TOL
