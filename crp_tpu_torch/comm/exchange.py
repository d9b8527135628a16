"""Sparsity-aware B-row exchange (``crp_tpu/comm/exchange.py``).

The host plan is a numpy copy of the JAX package's: each shard pulls
exactly the B rows its A columns reference, with every per-pair list padded
to the largest.  Without a mesh the engines hold every shard on their one
device, stacked along a leading axis, as the JAX package's single
controller holds them (``shard_map`` over a mesh); the exchange keeps the
send -> all_to_all -> scatter structure, and on one device the all_to_all
is an axis swap and a ring shift a roll.  On a mesh of ranks
(``shard.layout.RankMesh``) each rank holds its own shard and the same
steps run on this rank's slice of the tables (:func:`rank_tables`): the
all_to_all is ``dist.all_to_all_single`` on the group
(:func:`exchange_b_rank`, JAX's ``lax.all_to_all``) and a shift one
``dist.batch_isend_irecv`` with the peers JAX's ``ppermute`` pairs
(:func:`ring_shift_rank`).
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
    destination axes, ``(p_dst, p_src, S, n)``.  On a mesh of ranks
    :func:`exchange_b_rank` takes this step with ``all_to_all_single``."""
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


# ------------------------------------------------------------ across ranks


@dataclasses.dataclass
class RankTables:
    """Rank ``rank``'s slice of the plan's tables, as flat int64 tensors
    (pads stripped, as in :class:`ExchangeTables`), for its own B shard
    ``(max_k, n)`` and receive buffer ``(rb_rows, n)``: ``send`` gathers its
    a2a send buffer ``(p_dst, S)``; ``recv_slot`` / ``recv_dst`` the real
    slots of the received ``(p_src, S)`` and their rB rows; ``self_src`` /
    ``self_dst`` the self-copy; ``ring`` per shift s the (send, recv_slot,
    recv_dst) of the rows it sends to rank (r + s) % p and receives from
    rank (r - s) % p."""

    p: int
    S: int
    rank: int
    rb_rows: int
    send: torch.Tensor
    recv_slot: torch.Tensor
    recv_dst: torch.Tensor
    self_src: torch.Tensor
    self_dst: torch.Tensor
    ring: list


def rank_tables(plan: BExchangePlan, rank: int, rb_rows: int, device,
                ring: bool = False) -> RankTables:
    """This rank's exec-time tables of ``plan`` (``exchange.py:170-198``:
    the shard's slices of send_idx, recv_dst, self_src and self_dst)."""
    p, r, keep_max = plan.p, int(rank), plan.rB_nrow_max
    recv = plan.recv_dst[r]                                   # (p_src, S)
    keep = recv < keep_max
    skeep = plan.self_dst[r] < keep_max
    shifts = []
    if ring:
        for s in range(1, p):
            r_dst = plan.recv_dst[r, (r - s) % p]              # (S,)
            r_keep = r_dst < keep_max
            shifts.append((_t(plan.send_idx[r, (r + s) % p], device),
                           _t(np.flatnonzero(r_keep), device), _t(r_dst[r_keep], device)))
    return RankTables(
        p=p, S=plan.S, rank=r, rb_rows=rb_rows,
        send=_t(plan.send_idx[r].ravel(), device), recv_slot=_t(np.flatnonzero(keep), device),
        recv_dst=_t(recv[keep], device), self_src=_t(plan.self_src[r][skeep], device),
        self_dst=_t(plan.self_dst[r][skeep], device), ring=shifts,
    )


def ring_shift_rank(sendbuf: torch.Tensor, s: int, rank: int, group, ranks) -> torch.Tensor:
    """Shift s of the ring across ranks: this rank (index ``rank`` of the
    group's global ``ranks``) sends ``sendbuf`` to index (rank + s) % p and
    receives the same shape from (rank - s) % p, one
    ``dist.batch_isend_irecv`` (``ppermute`` over ``(i, (i + s) % p)``)."""
    import torch.distributed as dist

    p = len(ranks)
    recvbuf = torch.empty_like(sendbuf)
    ops = [dist.P2POp(dist.isend, sendbuf, ranks[(rank + s) % p], group),
           dist.P2POp(dist.irecv, recvbuf, ranks[(rank - s) % p], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recvbuf


def _self_copy_rank(b, t: RankTables, n: int) -> torch.Tensor:
    rB = b.new_zeros((t.rb_rows, n))
    rB.index_copy_(0, t.self_dst, b.index_select(0, t.self_src))
    return rB


def exchange_b_rank(b_loc: torch.Tensor, t: RankTables, group) -> torch.Tensor:
    """The padded all_to_all exchange on this rank's B shard ``(1, max_k,
    n)``: gather the send buffer ``(p_dst, S, n)``, ``all_to_all_single``
    on ``group`` -> ``(p_src, S, n)``, scatter the real slots, self-copy
    (``exchange.py:170-198``).  Returns ``(1, rb_rows, n)``, equal to row
    ``rank`` of :func:`exchange_b` bit for bit."""
    import torch.distributed as dist

    n = b_loc.shape[-1]
    b = b_loc.reshape(-1, n)
    sendbuf = b.index_select(0, t.send)
    recvbuf = torch.empty_like(sendbuf)
    if t.p > 1:
        dist.all_to_all_single(recvbuf, sendbuf, group=group)
    rB = _self_copy_rank(b, t, n)
    rB.index_copy_(0, t.recv_dst, recvbuf.index_select(0, t.recv_slot))
    return rB[None]


def exchange_b_ring_rank(b_loc: torch.Tensor, t: RankTables, group, ranks) -> torch.Tensor:
    """The p2p ring on this rank's B shard ``(1, max_k, n)``
    (``exchange.py:201-241``): the self-copy, then p - 1 shifts.  Returns
    ``(1, rb_rows, n)``."""
    n = b_loc.shape[-1]
    b = b_loc.reshape(-1, n)
    rB = _self_copy_rank(b, t, n)
    for s, (send, slot, dst) in enumerate(t.ring, start=1):
        recvbuf = ring_shift_rank(b.index_select(0, send), s, t.rank, group, ranks)
        rB.index_copy_(0, dst, recvbuf.index_select(0, slot))
    return rB[None]


def gather_shards(x: torch.Tensor, group, n_ranks: int) -> torch.Tensor:
    """Every rank's ``x`` (1, ...) of one shape, stacked in the group's rank
    order: (n_ranks, ...), ``all_gather`` on ``group``.  NCCL gathers on
    the device; gloo, the host's backend, on the host (the callers read C
    back to the host either way).  ``group`` None: this rank alone."""
    if group is None:
        return x
    import torch.distributed as dist

    src = x if dist.get_backend(group) == "nccl" else x.cpu()
    out = [torch.empty_like(src[0]) for _ in range(n_ranks)]
    dist.all_gather(out, src[0].contiguous(), group=group)
    return torch.stack(out)
