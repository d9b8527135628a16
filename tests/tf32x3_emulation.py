"""The 3xTF32 body's arithmetic emulated on the CPU, shared by
``test_torch_tf32x3.py``, ``test_torch_tf32x3_window.py``,
``test_torch_tf32x3_ragged.py`` and the wgmma order tests: the three TF32
products per 8-deep k step in the kernels' order, the one-pass product
that falls outside ``highest``'s class, the two error measures, and the
two-shard ragged pack they run on."""

import numpy as np
import torch

import tests.torch_threads  # noqa: F401  (one torch thread a test process)

from crp_tpu_torch.kernels import dispatch as td
from crp_tpu_torch.kernels.spmm_pallas import round_tf32, split_tf32
from crp_tpu_torch.sparse.csr import CSRMatrix
from crp_tpu_torch.sparse.synth import powerlaw_community_csr
from crp_tpu_torch.utils.norms import rel_fro_err

CPU = torch.device("cpu")
# the card's bounds between #4 / #12 at highest and the fp32 product
# (chip_smoke.py TOL_PLAIN and TOL_PLAIN_FRO)
TOL_MAX = 1e-6
TOL_FRO = 1e-6
BK = 32  # rows of one k slice: a fresh accumulator each


def _walk(tiles, group_ptr):
    """(G, each group's chunk count, group_ptr) of a pack: with no
    ``group_ptr`` (a uniform pack) group g owns the one chunk g."""
    if group_ptr is None:
        group_ptr = np.arange(tiles.shape[0] + 1)
    gp = np.asarray(group_ptr, np.int64)
    return len(gp) - 1, np.diff(gp), gp


def tf32x3_windows(ws, tiles, b, group_ptr=None):
    """C of the 3xTF32 body, emulated: A and the B windows split by
    ``split_tf32``; per 8-deep k step the three products (small terms
    first), each an exact sum rounded once to fp32 into a fresh accumulator
    per 32-row slice; the slices added in fp32.  With ``group_ptr`` (a
    ragged pack: ``ws`` its chunk starts) group g walks its chunks
    [group_ptr[g], group_ptr[g + 1]) as one run of slices, the kernel's
    walk; else every group owns the one chunk g (a uniform pack)."""
    G, counts, gp = _walk(tiles, group_ptr)
    TM, W = tiles.shape[1:]
    win = b[ws.long()[:, None] + torch.arange(W)]
    ab, al = (t.double() for t in split_tf32(tiles))
    bb, bl = (t.double() for t in split_tf32(win))
    acc = torch.zeros((G, TM, b.shape[1]), dtype=torch.float32)
    for j in range(int(counts.max(initial=0))):  # every group's j-th chunk
        gs = torch.from_numpy(np.flatnonzero(counts > j))
        st = torch.from_numpy(gp[:-1][counts > j] + j)
        for k0 in range(0, W, BK):
            part = torch.zeros((len(gs), TM, b.shape[1]), dtype=torch.float32)
            for k in range(k0, k0 + BK, 8):
                s = slice(k, k + 8)
                for x, y in ((al, bb), (ab, bl), (ab, bb)):
                    part = (part.double() + torch.bmm(x[st, :, s], y[st, s])).float()
            acc[gs] += part
    return acc.reshape(G * TM, -1)


def one_pass_tf32(ws, tiles, b, group_ptr=None):
    """big x big alone (TF32 as the tensor cores take raw fp32): out of
    ``highest``'s class, so the tests below can tell."""
    G, counts, gp = _walk(tiles, group_ptr)
    TM, W = tiles.shape[1:]
    st = torch.arange(int(gp[-1]))
    win = b[ws.long()[st, None] + torch.arange(W)]
    per = torch.bmm(round_tf32(tiles[st]).double(), round_tf32(win).double())
    out = torch.zeros((G, TM, b.shape[1]), dtype=torch.float64)
    out.index_add_(0, torch.from_numpy(np.repeat(np.arange(G), counts)), per)
    return out.float().reshape(G * TM, -1)


def _errors(want, got):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return (float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)),
            rel_fro_err(want, got))


RAGGED_CUT = 3000  # the first shard's rows
RAGGED_MIN_NNZ = 40  # the packs' break-even: groups whose nonzeros all spill


def _ragged_case(TM):
    """The two shards of :func:`_ragged_pack`, ``(a, shards, max_m)``: a
    community power-law graph with a band of empty rows."""
    a = powerlaw_community_csr(8000, 16, 1024, seed=5, dtype=np.float32)
    rows = np.repeat(np.arange(a.nrow), np.diff(a.rowptr))
    keep = (rows < 2000) | (rows >= 2000 + 2 * TM)
    a = CSRMatrix.from_coo(a.nrow, a.ncol, rows[keep], a.colidx[keep], a.val[keep],
                           dtype=np.float32)
    shards = [(s.rowptr, s.colidx.astype(np.int32), s.val)
              for s in (a.row_slice(0, RAGGED_CUT), a.row_slice(RAGGED_CUT, a.nrow))]
    return a, shards, a.nrow - RAGGED_CUT + 300


def _ragged_pack(TM, Wc, prec="highest"):
    """Two shards of a community power-law graph packed ragged at ``prec``
    (the TF32 planes (big, small) at highest, the bf16 pair at x3, bf16
    panels at default): hub groups of many chunks, a band of empty groups
    and groups whose nonzeros all spill (dummy chunks at start 0), the
    first shard's trailing no-op steps, pad groups."""
    a, shards, max_m = _ragged_case(TM)
    arrays, op = td._pack_ragged(shards, max_m, np.float32, prec, CPU,
                                 geometry=(TM, Wc), min_chunk_nnz=RAGGED_MIN_NNZ,
                                 spill_impl="segsum")
    scheme = {"highest": "tf32", "x3": "x3", "default": "bf16"}[prec]
    assert op.scheme == scheme and op.roofline["spill_nnz"] > 0
    return a, (RAGGED_CUT, a.nrow - RAGGED_CUT), arrays, op
