"""Sparsity-aware B-row exchange (``crp_tpu/comm/exchange.py``).

The host plan is a numpy copy of the JAX package's: each shard pulls
exactly the B rows its A columns reference, with every per-pair list padded
to the largest.  At exec time the engines hold every shard on their one
device, stacked along a leading axis, as the JAX package's single
controller holds them (``shard_map`` over a mesh); the exchange keeps the
send -> all_to_all -> scatter structure, and on one device the all_to_all
is an axis swap and a ring shift a roll.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class BExchangePlan:
    """Host-side plan; the index tables are stacked per shard."""

    p: int                    # shards along the exchange axis
    glb_n_axis: str           # mesh axis name ("pm" group-column axis)
    rB_nrow: np.ndarray       # (p,) compacted receive-buffer rows per shard
    rB_nrow_max: int
    S: int                    # max rows on any (src, dst) pair
    self_max: int
    rB_recv_rows: np.ndarray  # (p,) rows received from OTHER shards
    send_idx: np.ndarray      # (p, p, S) local B row index to send; pad 0
    recv_dst: np.ndarray      # (p, p, S) compact rB destination; pad rB_nrow_max
    self_src: np.ndarray      # (p, self_max) local B row; pad 0
    self_dst: np.ndarray      # (p, self_max) compact rB dst; pad rB_nrow_max
    rowmap: list              # per-shard global-B-row -> compact index
    pair_rows: list           # pair_rows[i][j] = sorted global B rows i recvs from j

    @property
    def total_recv_rows(self) -> int:
        return int(self.rB_recv_rows.sum())

    @property
    def physical_rows(self) -> int:
        """Padded rows moved by one all_to_all round: p*p*S."""
        return self.p * self.p * self.S

    @property
    def physical_rows_ring(self) -> int:
        """Padded rows moved by the p2p ring: p-1 shifts of S rows per shard."""
        return self.p * (self.p - 1) * self.S


def build_b_exchange(
    shard_colidx: list[np.ndarray],
    B_row_displs: np.ndarray,
    reidx: bool = True,
) -> BExchangePlan:
    """Exchange plan from each shard's referenced global B rows.

    ``shard_colidx[i]`` are shard i's global column indices,
    ``B_row_displs`` the (p+1,) ownership partition of B rows; ``reidx``
    compacts never-referenced rows out of the receive buffer
    (``RP_SPMM_REIDX``, ``src/rowpara_spmm.c:81-86`` of the reference).
    """
    B_row_displs = np.asarray(B_row_displs, dtype=np.int64)
    p = len(shard_colidx)
    for i, cols in enumerate(shard_colidx):
        if len(cols) and (
            int(np.min(cols)) < int(B_row_displs[0])
            or int(np.max(cols)) >= int(B_row_displs[-1])
        ):
            raise ValueError(
                f"shard {i} references B rows outside the ownership range "
                f"[{B_row_displs[0]}, {B_row_displs[-1]}): cols span "
                f"[{np.min(cols)}, {np.max(cols)}]. The B_row_displs "
                f"partition must cover all referenced rows (for square "
                f"matrices extend the last row-block boundary to k)."
            )
    refs = []
    rB_nrow = np.zeros(p, dtype=np.int64)
    win_start = np.zeros(p, dtype=np.int64)
    for i, cols in enumerate(shard_colidx):
        ref = np.unique(np.asarray(cols, dtype=np.int64))
        refs.append(ref)
        if reidx:
            rB_nrow[i] = ref.shape[0]
        else:
            win_start[i] = ref[0] if ref.shape[0] else 0
            rB_nrow[i] = (ref[-1] - ref[0] + 1) if ref.shape[0] else 0

    def dst_of(i: int, rows: np.ndarray) -> np.ndarray:
        if reidx:
            return np.searchsorted(refs[i], rows).astype(np.int64)
        return (rows - win_start[i]).astype(np.int64)

    rB_nrow_max = int(rB_nrow.max()) if p else 0
    recv_rows = [
        [
            refs[i][
                (refs[i] >= B_row_displs[j]) & (refs[i] < B_row_displs[j + 1])
            ]
            for j in range(p)
        ]
        for i in range(p)
    ]
    pair_cnt = np.array(
        [[len(recv_rows[i][j]) if i != j else 0 for j in range(p)] for i in range(p)],
        dtype=np.int64,
    )
    S = int(pair_cnt.max()) if p > 1 else 0
    self_cnt = np.array([len(recv_rows[i][i]) for i in range(p)], dtype=np.int64)
    self_max = int(self_cnt.max()) if p else 0

    send_idx = np.zeros((p, p, max(S, 1)), dtype=np.int32)
    recv_dst = np.full((p, p, max(S, 1)), rB_nrow_max, dtype=np.int32)
    self_src = np.zeros((p, max(self_max, 1)), dtype=np.int32)
    self_dst = np.full((p, max(self_max, 1)), rB_nrow_max, dtype=np.int32)
    for i in range(p):
        for j in range(p):
            if i == j:
                continue
            rows = recv_rows[i][j]
            c = len(rows)
            if c:
                send_idx[j, i, :c] = rows - B_row_displs[j]
                recv_dst[i, j, :c] = dst_of(i, rows)
        rows = recv_rows[i][i]
        c = len(rows)
        if c:
            self_src[i, :c] = rows - B_row_displs[i]
            self_dst[i, :c] = dst_of(i, rows)

    return BExchangePlan(
        p=p,
        glb_n_axis="pm",
        rB_nrow=rB_nrow,
        rB_nrow_max=rB_nrow_max,
        S=max(S, 1),
        self_max=max(self_max, 1),
        rB_recv_rows=pair_cnt.sum(axis=1),
        send_idx=send_idx,
        recv_dst=recv_dst,
        self_src=self_src,
        self_dst=self_dst,
        rowmap=refs if reidx else [win_start[i] for i in range(p)],
        pair_rows=recv_rows,
    )


@dataclasses.dataclass
class ExchangeTables:
    """The plan's index tables as flat int64 tensors on the engine's
    device, for stacked ``(p, max_k, n)`` B shards and ``(p, rb_rows, n)``
    receive buffers.

    Every padded slot of the plan (destination ``rB_nrow_max``) is stripped
    here: when the kernels' receive buffer has more rows than the plan's
    (their ``min_b_rows``), that row is real, and an index past a CUDA
    tensor's end is a fault, not a dropped write.  ``send`` gathers the
    a2a send buffer ``(p, p, S)`` (sender-major) from the flat B shards;
    ``recv_slot`` picks the real slots of the flat receive buffer
    (receiver-major) and ``recv_dst`` their flat rB rows; ``self_src`` /
    ``self_dst`` are the self-copy; ``ring`` holds, per shift s = 1 … p-1,
    the (send, recv_slot, recv_dst) of that shift.
    """

    p: int
    S: int
    max_k: int
    rb_rows: int
    send: torch.Tensor
    recv_slot: torch.Tensor
    recv_dst: torch.Tensor
    self_src: torch.Tensor
    self_dst: torch.Tensor
    ring: list


def _t(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)).to(device)


def exchange_tables(plan: BExchangePlan, max_k: int, rb_rows: int, device,
                    ring: bool = False) -> ExchangeTables:
    """Flat exec-time tables of ``plan`` (see :class:`ExchangeTables`);
    ``ring`` builds the per-shift tables of :func:`exchange_b_ring`."""
    p, S = plan.p, plan.S
    if rb_rows < plan.rB_nrow_max:
        raise ValueError(f"rb_rows {rb_rows} < the plan's {plan.rB_nrow_max} rows")
    i_idx = np.arange(p, dtype=np.int64)
    # send[j, i, s] = shard j's local row for shard i, as a flat B row
    send = i_idx[:, None, None] * max_k + plan.send_idx
    keep = plan.recv_dst < plan.rB_nrow_max                  # (i, j, s)
    recv_slot = np.flatnonzero(keep)
    recv_dst = (i_idx[:, None, None] * rb_rows + plan.recv_dst)[keep]
    skeep = plan.self_dst < plan.rB_nrow_max                 # (i, t)
    self_src = (i_idx[:, None] * max_k + plan.self_src)[skeep]
    self_dst = (i_idx[:, None] * rb_rows + plan.self_dst)[skeep]
    shifts = []
    if ring:
        for s in range(1, p):
            dst = (i_idx + s) % p
            src = (i_idx - s) % p
            # shard i sends its rows for (i + s) % p ...
            s_send = i_idx[:, None] * max_k + plan.send_idx[i_idx, dst]
            # ... and receives shard (i - s) % p's rows for it
            r_dst = plan.recv_dst[i_idx, src]                 # (i, S)
            r_keep = r_dst < plan.rB_nrow_max
            shifts.append((
                _t(s_send.ravel(), device), _t(np.flatnonzero(r_keep), device),
                _t((i_idx[:, None] * rb_rows + r_dst)[r_keep], device),
            ))
    return ExchangeTables(
        p=p, S=S, max_k=max_k, rb_rows=rb_rows,
        send=_t(send.ravel(), device), recv_slot=_t(recv_slot, device),
        recv_dst=_t(recv_dst, device), self_src=_t(self_src, device),
        self_dst=_t(self_dst, device), ring=shifts,
    )


def all_to_all(sendbuf: torch.Tensor) -> torch.Tensor:
    """The all_to_all of the stacked send buffer ``(p_src, p_dst, S, n)``
    when every shard lies on one device: the swap of the source and
    destination axes, ``(p_dst, p_src, S, n)``.  Shards on several GPUs
    replace this step with ``all_to_all_single`` (ROADMAP A8)."""
    return sendbuf.transpose(0, 1)


def ring_shift(sendbuf: torch.Tensor, s: int) -> torch.Tensor:
    """Shift s of the ring on one device: shard i receives what shard
    (i - s) % p sent (``ppermute`` over ``(i, (i + s) % p)``)."""
    return torch.roll(sendbuf, s, dims=0)


def _self_copy(b_flat, t: ExchangeTables, n: int) -> torch.Tensor:
    rB = b_flat.new_zeros((t.p * t.rb_rows, n))
    rB.index_copy_(0, t.self_dst, b_flat.index_select(0, t.self_src))
    return rB


def exchange_b(b_shards: torch.Tensor, t: ExchangeTables) -> torch.Tensor:
    """The padded all_to_all exchange (``crp_tpu/comm/exchange.py:170-198``)
    on stacked B shards ``(p, max_k, n)``: gather the send buffer, all_to_all,
    scatter the real slots into the compact receive buffers, self-copy.
    Returns ``(p, rb_rows, n)``."""
    p, _, n = b_shards.shape
    b_flat = b_shards.reshape(-1, n)
    sendbuf = b_flat.index_select(0, t.send).view(p, p, t.S, n)
    recvbuf = all_to_all(sendbuf).reshape(-1, n)
    rB = _self_copy(b_flat, t, n)
    rB.index_copy_(0, t.recv_dst, recvbuf.index_select(0, t.recv_slot))
    return rB.view(p, t.rb_rows, n)


def exchange_b_ring(b_shards: torch.Tensor, t: ExchangeTables) -> torch.Tensor:
    """The p2p ring (``crp_tpu/comm/exchange.py:201-241``, ``rb_p2p=1``):
    the self-copy, then p - 1 shifts, shift s moving each shard's rows for
    the shard s ahead.  Returns ``(p, rb_rows, n)``."""
    p, _, n = b_shards.shape
    b_flat = b_shards.reshape(-1, n)
    rB = _self_copy(b_flat, t, n)
    for s, (send, slot, dst) in enumerate(t.ring, start=1):
        sendbuf = b_flat.index_select(0, send).view(p, t.S, n)
        recvbuf = ring_shift(sendbuf, s).reshape(-1, n)
        rB.index_copy_(0, dst, recvbuf.index_select(0, slot))
    return rB.view(p, t.rb_rows, n)
