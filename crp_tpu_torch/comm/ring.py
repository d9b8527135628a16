"""Overlapped ring SpMM: the B-row exchange beside partial local compute
(``crp_tpu/comm/ring.py``, ``overlap=1``).

Each shard's A is split by the owner of the B row it references:

    C_i  =  A_{i,self} @ B_i  +  sum_{s=1}^{p-1}  A_{i,(i-s)%p} @ recv_s

The self part depends on no exchange and runs the engine's local kernel
(:func:`~crp_tpu_torch.kernels.dispatch.pack_local_kernel` on the shard's
own B block, ``segsum`` where that kind refuses the sparsity, as JAX's
``ring.py:115-121``).  Each shift's partial is a segment sum over that
shift's receive buffer, in the port's fixed order
(:func:`~crp_tpu_torch.kernels.spmm_segsum.segment_sum`).

Without a mesh every shard lies on the engine's one device, so a shift is
:func:`~crp_tpu_torch.comm.exchange.ring_shift` (a roll of the stacked send
buffers); on a mesh of ranks a pack holds one rank's shard (``rank``) and a
shift is :func:`~crp_tpu_torch.comm.exchange.ring_shift_rank` (one
``batch_isend_irecv``, JAX's ``ppermute``), its segment sums cut where the
stacked pack's are, so that a rank's C equals its slice of the stacked C
bit for bit.  The overlap is a CUDA-stream schedule: the self part's
kernels run on a side stream while the shifts' exchanges and segment sums
run on the current stream; an event joins the two.  The partials are then
added in JAX's order, self first and s = 1 ... p - 1 after, so that a
launch repeats bit for bit.  The host arrays (``step_rows`` padded with
``max_m``, ``step_cols`` and ``step_vals`` with 0) are JAX's; the exec's
tables drop both kinds of pad, and the self kernel's window reach past
the shard's own rows (``min_b_rows``) is the engine's to pad.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.spmm_segsum import SEGSUM_BLOCK_BYTES, segment_sum
from .exchange import BExchangePlan, ring_shift, ring_shift_rank


@dataclasses.dataclass
class RingSpmmPack:
    """Per-shift A subsets and the self part's pack."""

    p: int
    S: int                     # receive slots per shift (plan.S)
    R: int                     # padded nnz per (shard, shift)
    max_m: int
    step_rows: np.ndarray      # (p, p-1, R) int32 local C row; pad max_m
    step_cols: np.ndarray      # (p, p-1, R) int32 slot in the shift's recvbuf; pad 0
    step_vals: np.ndarray      # (p, p-1, R) dtype; pad 0
    self_arrays: tuple         # the self part's packed tensors, leading shard axis
    self_op: object            # its local op: op(arrays of one shard, b) -> (rows, n)
    self_kind: str             # the kind the self part packed to
    min_b_rows: int            # B rows the self kernel reads
    shifts: list               # per s: flat (cols, vals, rows hit) tensors, pads dropped
    shift_rows: list           # per s: each entry's index among the rows hit (host)
    rank: int | None = None    # the one shard a rank's pack holds (None: all)
    shift_base: list = dataclasses.field(default_factory=list)  # per s: its entries'
    # start in the stacked pack's run of that shift (0 for the stacked pack)
    _chunks: dict = dataclasses.field(default_factory=dict, repr=False)

    def chunks(self, s: int, n: int, itemsize: int) -> list:
        """Shift ``s``'s segment-sum chunks at width ``n``: (start, end,
        first row, last row, offsets, phase) over the rows the shift hits,
        made on the host once per width, as ``spmm_segment_sum`` cuts its
        chunks, so that the exec reads nothing back.  A rank's pack cuts
        where the stacked pack does: each chunk is its part of a stacked
        chunk, ``phase`` its first entry's place there."""
        key = (s, n, itemsize)
        if key not in self._chunks:
            rows = self.shift_rows[s - 1]
            step = max(1, SEGSUM_BLOCK_BYTES // max(1, n * itemsize))
            base = self.shift_base[s - 1] if self.shift_base else 0
            dev = self.shifts[s - 1][0].device
            out = []
            # from the stacked chunk this pack's run starts in
            for g in range(base // step * step, base + rows.size if rows.size else 0, step):
                st, en = max(g, base) - base, min(g + step, base + rows.size) - base
                r = rows[st:en]
                lo, hi = int(r[0]), int(r[-1])
                off = np.searchsorted(r, np.arange(lo, hi + 2))
                out.append((st, en, lo, hi, torch.from_numpy(off.astype(np.int64)).to(dev),
                            max(g, base) - g))
            self._chunks[key] = out
        return self._chunks[key]


def build_ring_spmm(
    shards: list, plan: BExchangePlan, B_row_displs: np.ndarray, max_m: int, dtype,
    kernel_kind: str = "segsum", *, device, mxu_precision: str = "highest",
    rank: int | None = None,
) -> RingSpmmPack:
    """Split each shard's A by B-row owner and pack it for the overlapped
    exec (``ring.py:49-128``).  ``shards[i]`` has ``rowptr`` / ``colidx`` /
    ``val`` with global columns; ``plan`` is the exchange plan built from
    the same shards (its ``pair_rows[i][j]`` fix each shift's slot order).
    ``rank``: the one shard whose tables and self part the pack holds (a
    rank of a mesh), planned from every shard as the stacked pack is."""
    from ..kernels.dispatch import pack_local_kernel
    from ..kernels.spmm_pallas import UnsupportedSparsity

    B_row_displs = np.asarray(B_row_displs, dtype=np.int64)
    device = torch.device(device)
    p = plan.p
    self_shards, per_shift = [], []
    R = 1
    for i, sh in enumerate(shards):
        nrow = len(sh.rowptr) - 1
        cols = np.asarray(sh.colidx, dtype=np.int64)
        vals = np.asarray(sh.val)
        rows = np.repeat(np.arange(nrow, dtype=np.int64), np.diff(sh.rowptr))
        owner = np.searchsorted(B_row_displs, cols, side="right") - 1
        mask = owner == i
        self_rowptr = np.zeros(nrow + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows[mask], minlength=nrow), out=self_rowptr[1:])
        self_shards.append((self_rowptr, (cols[mask] - B_row_displs[i]).astype(np.int32),
                            vals[mask]))
        shifts = []
        for s in range(1, p):
            j = (i - s) % p
            m = owner == j
            slot = np.searchsorted(plan.pair_rows[i][j], cols[m]).astype(np.int32)
            shifts.append((rows[m].astype(np.int32), slot, vals[m]))
            R = max(R, int(m.sum()))
        per_shift.append(shifts)

    step_rows = np.full((p, max(p - 1, 1), R), max_m, dtype=np.int32)
    step_cols = np.zeros((p, max(p - 1, 1), R), dtype=np.int32)
    step_vals = np.zeros((p, max(p - 1, 1), R), dtype=np.dtype(dtype))
    for i in range(p):
        for k, (r, c, v) in enumerate(per_shift[i]):
            step_rows[i, k, : len(r)] = r
            step_cols[i, k, : len(r)] = c
            step_vals[i, k, : len(r)] = v

    # the exec's tables: every shard's real entries of a shift, rows in the
    # stacked C (i * max_m + row), columns in the stacked receive buffer
    # (i * S + slot); shard by shard and row by row, so the rows stay sorted.
    # The sums run over the rows a shift hits alone (few, for a banded A):
    # each entry keeps its row's index among them
    shifts, shift_rows, shift_base = [], [], []
    held = range(p) if rank is None else [rank]
    for k in range(p - 1):
        rows = np.concatenate([per_shift[i][k][0].astype(np.int64) + j * max_m
                               for j, i in enumerate(held)])
        cols = np.concatenate([per_shift[i][k][1].astype(np.int64) + j * plan.S
                               for j, i in enumerate(held)])
        vals = np.concatenate([per_shift[i][k][2] for i in held]).astype(dtype)
        hit, idx = np.unique(rows, return_inverse=True)
        shifts.append(tuple(torch.from_numpy(x).to(device) for x in (cols, vals, hit)))
        shift_rows.append(idx.astype(np.int64))
        shift_base.append(sum(len(per_shift[i][k][0]) for i in range(held[0])))

    self_kind = kernel_kind
    try:
        self_arrays, self_op = pack_local_kernel(
            self_shards, max_m, dtype, self_kind, device=device,
            mxu_precision=mxu_precision, rank=rank)
    except UnsupportedSparsity:
        self_kind = "segsum"
        self_arrays, self_op = pack_local_kernel(self_shards, max_m, dtype, self_kind,
                                                 device=device, rank=rank)
    return RingSpmmPack(
        p=p, S=plan.S, R=R, max_m=max_m, step_rows=step_rows, step_cols=step_cols,
        step_vals=step_vals, self_arrays=self_arrays, self_op=self_op,
        self_kind=self_kind, min_b_rows=int(self_op.min_b_rows), shifts=shifts,
        shift_rows=shift_rows, rank=rank, shift_base=shift_base,
    )


def ring_send_tables(plan: BExchangePlan, max_k: int, device, rank=None) -> list:
    """Per shift s = 1 ... p - 1, the flat rows of the stacked B shards
    (p, max_k, n) that make the send buffer (p, S, n): shard i's rows for
    shard (i + s) % p (``plan.send_idx``, pads reading row 0 of the shard,
    which no receive slot references); with ``rank``, that shard's alone,
    rows of its own B shard."""
    p = plan.p
    i = np.arange(p, dtype=np.int64) if rank is None else np.array([rank])
    base = i if rank is None else np.zeros(1, dtype=np.int64)
    return [torch.from_numpy((base[:, None] * max_k + plan.send_idx[i, (i + s) % p])
                             .ravel().astype(np.int64)).to(device)
            for s in range(1, p)]


def _shift_partial(pack: RingSpmmPack, s: int, recv: torch.Tensor) -> torch.Tensor:
    """Shift ``s``'s partial on the rows it hits, (rows hit, n): each real
    entry's value times its received row, summed by row in the fixed
    order."""
    cols, vals, hit = pack.shifts[s - 1]
    n = recv.shape[1]
    out = recv.new_zeros((hit.shape[0], n))
    for st, en, lo, hi, off, phase in pack.chunks(s, n, recv.element_size()):
        contrib = vals[st:en, None].to(recv.dtype) * recv.index_select(0, cols[st:en])
        out[lo : hi + 1] += segment_sum(contrib, off, phase)
    return out


def ring_spmm(b_shards: torch.Tensor, pack: RingSpmmPack, sends: list,
              side_stream=None, group=None, ranks=None) -> torch.Tensor:
    """The overlapped exec on stacked B shards (p, rows, n) (``ring.py:
    131-163``): returns (p, max_m, n).  On a CUDA device ``side_stream``
    runs the self part while the current stream runs the shifts.  A rank's
    pack takes its own shard (1, rows, n), and each shift runs on
    ``group`` (global ``ranks`` in ring order)."""
    p, _, n = b_shards.shape
    max_m = pack.max_m
    b_flat = b_shards.reshape(-1, n)

    def self_part():
        outs = [pack.self_op(tuple(x[i] for x in pack.self_arrays), b_shards[i])[:max_m]
                for i in range(p)]
        return torch.stack(outs)

    cuda = b_shards.is_cuda and side_stream is not None
    if cuda:
        main = torch.cuda.current_stream(b_shards.device)
        side_stream.wait_stream(main)
        with torch.cuda.stream(side_stream):
            c_self = self_part()
            done = torch.cuda.Event()
            done.record(side_stream)
        for t in (b_shards, *pack.self_arrays):
            t.record_stream(side_stream)
    else:
        c_self = self_part()
    partials = []
    for s, send in enumerate(sends, start=1):
        sendbuf = b_flat.index_select(0, send).view(p, pack.S, n)
        recv = (ring_shift(sendbuf, s) if pack.rank is None
                else ring_shift_rank(sendbuf, s, pack.rank, group, ranks)).reshape(-1, n)
        partials.append(_shift_partial(pack, s, recv))
    if cuda:
        main.wait_event(done)
        c_self.record_stream(main)
    # JAX's order: self, then s = 1 ... p - 1, each added to the rows it hits
    # (JAX adds the shift's zeros to the rest)
    c = c_self.view(-1, n)
    for (_, _, hit), part in zip(pack.shifts, partials):
        c.index_copy_(0, hit, c.index_select(0, hit) + part)
    return c_self
