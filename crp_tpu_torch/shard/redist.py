"""Generic 2D block redistribution (``crp_tpu/shard/redist.py``, the
reference's ``mat_redist``, ``src/mat_redist.c:9-213,298-419``).

Each of p owners moves its "source" 2D block of a matrix to the owners of
the "destination" blocks that intersect it.  The rectangle intersections
and the pair tables are host numpy at init, as in JAX; every owner makes
them from every block's coordinates.  The audit's logical
(``nelem_moved``) and physical (``nelem_physical``, the padded
all_to_all's) volumes are JAX's.

Without a mesh every owner's block lies on the engine's one device,
stacked along a leading axis: each source block's pair patches are sliced
out of it, the all_to_all is the swap of the (source, destination) pair
index, and each destination block takes its patches in source order.  On
a mesh of ranks (``mesh=``, a :class:`~crp_tpu_torch.shard.layout.RankMesh`)
rank r holds block r alone, the mesh's row-major rank as in JAX's
flattened ("pm", "pn") axes: its patches for the other ranks travel in one
``all_to_all_single`` on the mesh's group with exact split sizes (the
reference's ``MPI_Alltoallv``), and its own patch is copied in place.
JAX pads every pair patch to (max_h, max_w) and blends it under a mask of
the pair's exact rectangle; here a patch is cut to that rectangle, so an
exec moves each element once (``nelem_moved`` elements over the ranks).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class BlockDist:
    """Per-owner 2D block layout: row i = (srow, scol, nrow, ncol)."""

    blocks: np.ndarray  # (p, 4) int64

    def __post_init__(self):
        self.blocks = np.asarray(self.blocks, dtype=np.int64).reshape(-1, 4)

    @property
    def p(self) -> int:
        return self.blocks.shape[0]

    @property
    def max_h(self) -> int:
        return int(max(self.blocks[:, 2].max(), 1))

    @property
    def max_w(self) -> int:
        return int(max(self.blocks[:, 3].max(), 1))

    @classmethod
    def from_row_slabs(cls, displs: np.ndarray, ncol: int) -> "BlockDist":
        displs = np.asarray(displs, dtype=np.int64)
        b = np.zeros((len(displs) - 1, 4), dtype=np.int64)
        b[:, 0] = displs[:-1]
        b[:, 2] = np.diff(displs)
        b[:, 3] = ncol
        return cls(b)

    @classmethod
    def from_grid(cls, row_displs: np.ndarray, col_displs: np.ndarray) -> "BlockDist":
        """Row-major (len(row_displs)-1) x (len(col_displs)-1) grid."""
        rd = np.asarray(row_displs, dtype=np.int64)
        cd = np.asarray(col_displs, dtype=np.int64)
        return cls(np.array([[rd[i], cd[j], rd[i + 1] - rd[i], cd[j + 1] - cd[j]]
                             for i in range(len(rd) - 1) for j in range(len(cd) - 1)],
                            dtype=np.int64))

    def gather_single(self, nrow: int, ncol: int, root: int = 0) -> "BlockDist":
        """All data on one owner (the drivers' result-check layout,
        ``examples/test_para2d_spmm.c:183-200``)."""
        b = np.zeros((self.p, 4), dtype=np.int64)
        b[root] = [0, 0, nrow, ncol]
        return BlockDist(b)


def _intersect(a: np.ndarray, b: np.ndarray) -> tuple[int, int, int, int]:
    """Intersection rect of two (srow, scol, nrow, ncol) blocks
    (``src/mat_redist.c:9-41``)."""
    r0 = max(a[0], b[0])
    r1 = min(a[0] + a[2], b[0] + b[2])
    c0 = max(a[1], b[1])
    c1 = min(a[1] + a[3], b[1] + b[3])
    if r0 >= r1 or c0 >= c1:
        return 0, 0, 0, 0
    return r0, c0, r1 - r0, c1 - c0


class RedistEngine:
    """init once, exec many: moves padded (p, H, W) blocks from the ``src``
    layout to the ``dst`` layout on ``device`` (default the card, or the
    mesh's device).  ``mesh``: a mesh of ``src.p`` ranks; rank r then holds
    block r alone, (1, H, W)."""

    def __init__(self, src: BlockDist, dst: BlockDist, device=None,
                 dtype=np.float64, mesh=None) -> None:
        from ..engine.rowpara import engine_device

        assert src.p == dst.p, (src.p, dst.p)
        p = src.p
        if mesh is not None and mesh.size != p:
            raise ValueError(f"RedistEngine: {p} blocks on a mesh of {mesh.size} ranks")
        self.src, self.dst, self.p, self.mesh = src, dst, p, mesh
        self.device = engine_device(
            device if device is not None else mesh.device if mesh is not None else "cuda")
        self.dtype = np.dtype(dtype)

        # rect[i, j]: what owner j sends to owner i, in global coordinates
        rect = np.array([[_intersect(dst.blocks[i], src.blocks[j]) for j in range(p)]
                         for i in range(p)], dtype=np.int64).reshape(p, p, 4)
        h, w = rect[:, :, 2], rect[:, :, 3]
        self.max_h = int(max(h.max(), 1))
        self.max_w = int(max(w.max(), 1))
        # s_start[j, i]: patch for i relative to j's block; d_start[i, j]:
        # its place in i's block; hw[i, j]: its extent
        self.s_start = np.zeros((p, p, 2), dtype=np.int32)
        self.d_start = np.zeros((p, p, 2), dtype=np.int32)
        self.hw = np.zeros((p, p, 2), dtype=np.int32)
        for i in range(p):
            for j in range(p):
                r0, c0, hh, ww = rect[i, j]
                self.s_start[j, i] = (r0 - src.blocks[j, 0], c0 - src.blocks[j, 1])
                self.d_start[i, j] = (r0 - dst.blocks[i, 0], c0 - dst.blocks[i, 1])
                self.hw[i, j] = (hh, ww)
        # the non-empty pairs in the order each destination blends them
        self._pairs = [(i, j) for i in range(p) for j in range(p)
                       if self.hw[i, j, 0] and self.hw[i, j, 1]]

        # audit (elements): the reference counts the whole destination as the
        # redistributed volume (deprecated/src/crpspmm.c:451)
        self.nelem_dst = int((dst.blocks[:, 2] * dst.blocks[:, 3]).sum())
        self.nelem_moved = int((h * w)[~np.eye(p, dtype=bool)].sum())
        self.nelem_physical = p * p * self.max_h * self.max_w

    @property
    def rank(self) -> int | None:
        return None if self.mesh is None else self.mesh.rank

    # ------------------------------------------------------------------ exec
    def exec_device(self, x_shards: torch.Tensor) -> torch.Tensor:
        """(p, src_max_h, src_max_w) padded blocks -> (p, dst_max_h,
        dst_max_w), zero where no source block covers; on a mesh this
        rank's block, (1, ...) -> (1, ...)."""
        if self.mesh is not None:
            return self._exec_rank(x_shards)
        p = self.p
        # send[j][i]: owner j's patch for owner i, a view of its block
        send = [[None] * p for _ in range(p)]
        for i, j in self._pairs:
            (r, c), (hh, ww) = self.s_start[j, i], self.hw[i, j]
            send[j][i] = x_shards[j, r : r + hh, c : c + ww]
        recv = [list(col) for col in zip(*send)]  # the all_to_all: recv[i][j]
        out = x_shards.new_zeros((p, self.dst.max_h, self.dst.max_w))
        for i, j in self._pairs:
            (r, c), (hh, ww) = self.d_start[i, j], self.hw[i, j]
            out[i, r : r + hh, c : c + ww] = recv[i][j]
        return out

    def _exec_rank(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's exec: its own patch copied in place, every other
        patch in one ``all_to_all_single`` on the mesh's group, split by
        the pairs' exact sizes (zero for itself); ranks with nothing to
        send or receive take part with empty splits."""
        import torch.distributed as dist

        p, me = self.p, self.mesh.rank
        if x.shape[0] != 1:
            raise ValueError(f"RedistEngine on a mesh takes this rank's block (1, H, W), "
                             f"got {tuple(x.shape)}")
        x0 = x[0]
        out = x.new_zeros((1, self.dst.max_h, self.dst.max_w))
        sizes = (self.hw[:, :, 0] * self.hw[:, :, 1]).astype(np.int64)  # [i, j]: j -> i
        sizes[np.arange(p), np.arange(p)] = 0
        (r, c), (hh, ww) = self.s_start[me, me], self.hw[me, me]
        if hh and ww:
            (dr, dc) = self.d_start[me, me]
            out[0, dr : dr + hh, dc : dc + ww] = x0[r : r + hh, c : c + ww]
        if not self.nelem_moved:  # no rank sends anything: no collective
            return out
        sends = []
        for i in range(p):
            if sizes[i, me]:
                (r, c), (hh, ww) = self.s_start[me, i], self.hw[i, me]
                sends.append(x0[r : r + hh, c : c + ww].reshape(-1))
        sendbuf = torch.cat(sends) if sends else x.new_empty(0)
        in_splits = sizes[:, me].tolist()
        out_splits = sizes[me, :].tolist()
        recvbuf = x.new_empty(int(sum(out_splits)))
        dist.all_to_all_single(recvbuf, sendbuf, out_splits, in_splits,
                               group=self.mesh.group)
        for j, piece in enumerate(recvbuf.split(out_splits)):
            if out_splits[j]:
                (dr, dc), (hh, ww) = self.d_start[me, j], self.hw[me, j]
                out[0, dr : dr + hh, dc : dc + ww] = piece.view(int(hh), int(ww))
        return out

    # ------------------------------------------------------------- host utils
    def shard_src(self, x: np.ndarray) -> torch.Tensor:
        """Global (m, n) -> padded per-owner source blocks on the device;
        on a mesh this rank's block alone, (1, src_max_h, src_max_w), a new
        tensor."""
        owners = range(self.p) if self.mesh is None else [self.mesh.rank]
        out = np.zeros((len(owners), self.src.max_h, self.src.max_w), dtype=self.dtype)
        for k, i in enumerate(owners):
            r, c, h, w = self.src.blocks[i]
            out[k, :h, :w] = x[r : r + h, c : c + w]
        return torch.from_numpy(out).to(self.device)

    def unshard_dst(self, shards, m: int, n: int) -> np.ndarray:
        """Padded destination blocks (a tensor or an array) -> global (m,
        n); on a mesh this rank's block, and every rank's is gathered first
        (``all_gather`` on the mesh's group), so that every rank returns
        the global matrix."""
        if self.mesh is not None:
            from ..comm.exchange import gather_shards

            shards = gather_shards(torch.as_tensor(shards), self.mesh.group, self.p)
        shards = shards.cpu().numpy() if isinstance(shards, torch.Tensor) else np.asarray(shards)
        out = np.zeros((m, n), dtype=shards.dtype)
        for i, (r, c, h, w) in enumerate(self.dst.blocks):
            out[r : r + h, c : c + w] = shards[i, :h, :w]
        return out
