"""The port's segment sums in a fixed order (``kernels/spmm_segsum.py``):
the ``segsum`` kind, the chunked spill of the ragged packs and the ``dd``
kind's segment-sum tier against the ``index_add_`` sums they replace
(fp32: within 1e-6 relative Frobenius, a reordering of the same adds) and
against numpy in fp64 (1e-12), with rows that straddle chunks, empty rows,
hub rows and padding."""

import numpy as np
import pytest
import torch

from crp_tpu_torch.kernels import spmm_segsum
from crp_tpu_torch.kernels.spmm_dd import pack_coo_dd, spmm_segsum_dd
from crp_tpu_torch.kernels.spmm_ragged import spmm_spill_chunked
from crp_tpu_torch.kernels.spmm_segsum import (
    pack_device_csr, segment_sum, spmm_segment_sum,
)
from crp_tpu_torch.sparse.synth import powerlaw_community_csr
from crp_tpu_torch.utils.norms import rel_fro_err

TOL_F32, TOL_F64 = 1e-6, 1e-12


def _case(dtype, seed=40, nrow=3000, n=24, pad=37):
    """A power-law matrix (hub rows of hundreds of nonzeros, empty rows)
    packed with ``pad`` padding slots, its B, and the fp64 numpy product."""
    a = powerlaw_community_csr(nrow, 6, 256, seed=seed, dtype=dtype)
    keep = np.repeat(np.arange(a.nrow), np.diff(a.rowptr)) % 7 != 3  # empty rows
    rows = np.repeat(np.arange(a.nrow), np.diff(a.rowptr))[keep]
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=a.nrow))])
    cols, vals = a.colidx[keep], a.val[keep]
    assert np.diff(rowptr).max() >= 100 and (np.diff(rowptr) == 0).sum() >= 100
    r, c, v = pack_device_csr(rowptr, cols, vals, len(cols) + pad, nrow=a.nrow)
    b = np.random.default_rng(seed + 1).standard_normal((a.ncol, n)).astype(dtype)
    ref = np.zeros((a.nrow, n))
    np.add.at(ref, rows, vals.astype(np.float64)[:, None] * b.astype(np.float64)[cols])
    return [torch.from_numpy(x) for x in (r, c, v, b)], a.nrow, ref


def _index_add(r, c, v, b, nrow):
    out = b.new_zeros((nrow + 1, b.shape[1]))
    out.index_add_(0, r.long(), v[:, None].to(b.dtype) * b[c.long()])
    return out[:nrow]


@pytest.mark.parametrize("block_bytes", [spmm_segsum.SEGSUM_BLOCK_BYTES, 4096, 96])
@pytest.mark.parametrize("fn", ["segsum", "spill"])
def test_fp32_within_rounding_of_index_add(fn, block_bytes, monkeypatch):
    """Whole, in chunks of 42 slots (rows straddle chunks), and of one slot."""
    monkeypatch.setattr(spmm_segsum, "SEGSUM_BLOCK_BYTES", block_bytes)
    (r, c, v, b), nrow, ref = _case(np.float32)
    got = (spmm_segment_sum(r, c, v, nrow, b) if fn == "segsum"
           else spmm_spill_chunked(r, c, v, b, nrow))
    assert got.shape == (nrow, b.shape[1]) and got.dtype == torch.float32
    assert rel_fro_err(_index_add(r, c, v, b, nrow).double().numpy(), got.numpy()) <= TOL_F32
    assert rel_fro_err(ref, got.numpy()) <= TOL_F32
    assert torch.equal(got, spmm_segment_sum(r, c, v, nrow, b))  # repeats


@pytest.mark.parametrize("block_bytes", [spmm_segsum.SEGSUM_BLOCK_BYTES, 2048])
def test_fp64_within_1e12_of_numpy(block_bytes, monkeypatch):
    monkeypatch.setattr(spmm_segsum, "SEGSUM_BLOCK_BYTES", block_bytes)
    (r, c, v, b), nrow, ref = _case(np.float64, seed=41)
    for got in (spmm_segment_sum(r, c, v, nrow, b), spmm_spill_chunked(r, c, v, b, nrow)):
        assert got.dtype == torch.float64
        assert rel_fro_err(ref, got.numpy()) <= TOL_F64


def test_dd_segment_sum_tier_within_1e12_of_numpy(monkeypatch):
    monkeypatch.setattr(spmm_segsum, "SEGSUM_BLOCK_BYTES", 8192)
    a = powerlaw_community_csr(2000, 9, 256, seed=42)
    arrs = [torch.from_numpy(x) for x in pack_coo_dd(a.rowptr, a.colidx, a.val,
                                                      a.nnz + 11, a.nrow + 5)]
    b = np.random.default_rng(43).standard_normal((a.ncol, 16))
    got = spmm_segsum_dd(*arrs, torch.from_numpy(b), a.nrow + 5).numpy()
    assert not got[a.nrow:].any()
    assert rel_fro_err(a.spmm_ref(b), got[: a.nrow]) <= TOL_F64


def test_padding_only_and_empty():
    b = torch.ones((4, 3))
    pad = torch.full((5,), 6, dtype=torch.int32)
    zeros = torch.zeros(5, dtype=torch.int32)
    assert not spmm_segment_sum(pad, zeros, torch.ones(5), 6, b).any()
    empty = torch.zeros(0, dtype=torch.int32)
    assert spmm_segment_sum(empty, empty, torch.zeros(0), 6, b).shape == (6, 3)


def test_segment_sum_in_row_order():
    """``segment_sum`` over CSR offsets: empty segments are 0, and a short
    segment's sum is its elements added one after another."""
    x = torch.tensor([1e8, 1.0, -1e8, 3.0, 0.5, 2.0], dtype=torch.float32)
    offsets = torch.tensor([0, 3, 3, 4, 6])
    got = segment_sum(x, offsets)
    f = torch.tensor(1e8, dtype=torch.float32)
    want = torch.stack([(f + 1.0) - f, f * 0, f * 0 + 3.0, f * 0 + 2.5])  # fp32, in order
    assert want[0] == 0
    assert torch.equal(got, want)
    x2 = torch.randn(6, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(4))
    got2 = segment_sum(x2, offsets).numpy()
    np.testing.assert_allclose(got2, np.stack([x2[0:3].sum(0), np.zeros(3), x2[3],
                                               x2[4:6].sum(0)]), rtol=1e-14)


def test_segment_sum_long_segments_in_pieces():
    """A segment longer than ``SEGSUM_PIECE`` is cut at every
    ``SEGSUM_PIECE``-th slot of x; the pieces are summed slot after slot,
    then piece after piece: equal bit for bit to that order, in fp32."""
    piece = spmm_segsum.SEGSUM_PIECE
    rng = np.random.default_rng(44)
    lens = [5, 3 * piece + 17, 0, piece, 2 * piece - 1, 1]
    offsets = np.concatenate([[0], np.cumsum(lens)])
    x = rng.standard_normal((offsets[-1] + 9, 2)).astype(np.float32) * 1e3

    def in_order(xs):
        acc = np.zeros(xs.shape[1:], np.float32)
        for v in xs:
            acc = (acc + v).astype(np.float32)
        return acc

    want = []
    for lo, hi in zip(offsets[:-1], offsets[1:]):
        cuts = [lo] + [c for c in range(0, hi, piece) if lo < c < hi] + [hi]
        want.append(in_order(np.stack([in_order(x[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
                                      or [np.zeros(2, np.float32)])))
    got = segment_sum(torch.from_numpy(x), torch.from_numpy(offsets))
    assert torch.equal(got, torch.from_numpy(np.stack(want)))
