"""Sparsity-aware B-row exchange (``crp_tpu/comm/exchange.py:28-167``).

The host plan is a numpy copy of the JAX package's: each shard pulls
exactly the B rows its A columns reference, with every per-pair list padded
to the largest.  At exec time one engine runs on one device (p = 1), where
the exchange is the plan's self-copy; the collectives for p > 1 are the
multi-GPU engines' work.
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


def self_copy_tables(plan: BExchangePlan, device) -> tuple:
    """(src, dst) int64 tensors of shard 0's self-copy without the padding
    slots (which point at row ``rB_nrow_max``, past every real row)."""
    if plan.p != 1:
        raise NotImplementedError(
            "the exec-time B exchange for p > 1 is not yet ported "
            "(ROADMAP Queue A #8, multi-GPU engines)"
        )
    keep = plan.self_dst[0] < plan.rB_nrow_max
    src = torch.from_numpy(plan.self_src[0][keep].astype(np.int64)).to(device)
    dst = torch.from_numpy(plan.self_dst[0][keep].astype(np.int64)).to(device)
    return src, dst


def exchange_b_local(b_loc, self_src, self_dst, rb_rows: int):
    """The p = 1 exchange (``exchange.py:170-198`` with one shard): the
    owned rows of B copied to their compact receive-buffer rows."""
    rB = b_loc.new_zeros((rb_rows, b_loc.shape[1]))
    rB.index_copy_(0, self_dst, b_loc.index_select(0, self_src))
    return rB
