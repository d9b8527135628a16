"""A handed over already distributed (``crp_tpu/shard/dist_a.py``): the
v1 engine's ``rd_Ai`` / ``rd_Av`` reshard and Allgatherv-A path, and the v2
engine's A0 replication.

The reference's v1 engine accepts A as contiguous row ranges, one per rank
(``deprecated/src/crpspmm.c:63-71``).  Init assembles only O(m) metadata on
the host (the global rowptr and each row's column range,
``crpspmm.c:90-131``); the O(nnz) payload moves between the owners: the
colidx / val vectors, as 1 x nnz blocks, from the user's nnz ranges to
per-(pi, pj) subranges of each row panel (``crpspmm.c:240-265``, here a
:class:`~crp_tpu_torch.shard.redist.RedistEngine`), then an Allgatherv
along each grid row assembles the panel (``crpspmm.c:559-584``).  Without
a mesh every owner's block lies on the engine's one device, so that
all_gather is a concatenation of the pn chunks; each panel is then staged
to the host for the kernel pack, as JAX stages one replica.  On a mesh of
ranks (``ingest_dist_a(mesh=)``, :func:`replicate_a0_rank`) each rank
reads its own block, the reshard runs on the mesh's group and the
all_gather on its row group.  The audit counters are JAX's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..sparse.csr import CSRMatrix
from ..utils.blocks import uniform_displs
from .redist import BlockDist, RedistEngine


def torch_dtype(dtype) -> torch.dtype:
    """The torch type of a numpy type."""
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def _index(ci, idx: np.ndarray) -> np.ndarray:
    """``ci[idx]`` on the host, for a numpy array or a tensor on any
    device (one gather there, O(len(idx)) back)."""
    if isinstance(ci, torch.Tensor):
        return ci[torch.from_numpy(idx).to(ci.device)].cpu().numpy()
    return np.asarray(ci)[idx]


@dataclasses.dataclass
class DistCSR:
    """A as ``p`` contiguous row-range blocks (the v1 init arguments,
    ``deprecated/src/crpspmm.c:63-71``): block ``i`` owns global rows
    ``[row_displs[i], row_displs[i+1])`` with an absolute rowptr slice
    (global nnz offsets, ``nrows_i + 1`` host ints) and its colidx / val
    slices, numpy arrays or tensors on a device."""

    m: int
    k: int
    row_displs: np.ndarray       # (p+1,)
    rowptrs: list                # block i: (nrows_i + 1,) absolute offsets
    colidxs: list                # block i: (nnz_i,)
    vals: list                   # block i: (nnz_i,)

    def __post_init__(self) -> None:
        self.row_displs = np.asarray(self.row_displs, dtype=np.int64)
        assert len(self.rowptrs) == self.p
        assert len(self.colidxs) == self.p and len(self.vals) == self.p

    @property
    def p(self) -> int:
        return len(self.row_displs) - 1

    @property
    def nrow(self) -> int:
        return self.m

    @property
    def ncol(self) -> int:
        return self.k

    @property
    def nnz(self) -> int:
        return int(self.rowptrs[-1][-1])

    @classmethod
    def from_global(cls, a, row_displs: np.ndarray, device=None) -> "DistCSR":
        """Scatter a host-global CSR into per-block slices (the
        ``scatter_csr_rows`` analog, ``examples/test_utils.c:57-119``);
        with ``device`` the colidx / val slices are tensors there (the
        engines' default is the card)."""
        if device is not None:
            from ..engine.rowpara import engine_device

            device = engine_device(device)
        row_displs = np.asarray(row_displs, dtype=np.int64)
        rowptrs, colidxs, vals = [], [], []
        for i in range(len(row_displs) - 1):
            r0, r1 = int(row_displs[i]), int(row_displs[i + 1])
            s, e = int(a.rowptr[r0]), int(a.rowptr[r1])
            ci = np.asarray(a.colidx[s:e], dtype=np.int32)
            v = np.asarray(a.val[s:e])
            if device is not None:
                ci, v = torch.from_numpy(ci).to(device), torch.from_numpy(v).to(device)
            rowptrs.append(np.asarray(a.rowptr[r0 : r1 + 1], dtype=np.int64))
            colidxs.append(ci)
            vals.append(v)
        return cls(a.nrow, a.ncol, row_displs, rowptrs, colidxs, vals)

    # ------------------------------------------------- O(m) metadata assembly
    def global_rowptr(self) -> np.ndarray:
        """(m+1,) global rowptr, the Allgatherv-rowptr analog
        (``deprecated/src/crpspmm.c:90-105``)."""
        out = np.empty(self.m + 1, dtype=np.int64)
        for i in range(self.p):
            r0, r1 = int(self.row_displs[i]), int(self.row_displs[i + 1])
            out[r0:r1] = np.asarray(self.rowptrs[i][:-1])
        out[self.m] = int(self.rowptrs[-1][-1])
        return out

    def row_col_ranges(self) -> np.ndarray:
        """(m, 2) per-row [min colidx, max colidx], [k, -1] for an empty row
        (the ``A_cidx_se`` allgather, ``crpspmm.c:107-131``), from each
        row's first and last nonzero: two ints a row leave the device."""
        out = np.empty((self.m, 2), dtype=np.int64)
        out[:, 0] = self.k
        out[:, 1] = -1
        for i in range(self.p):
            r0, r1 = int(self.row_displs[i]), int(self.row_displs[i + 1])
            rp = np.asarray(self.rowptrs[i], dtype=np.int64)
            nonempty = np.diff(rp) > 0
            firsts = (rp[:-1] - rp[0])[nonempty]
            lasts = (rp[1:] - rp[0])[nonempty] - 1
            out[r0:r1][nonempty, 0] = _index(self.colidxs[i], firsts)
            out[r0:r1][nonempty, 1] = _index(self.colidxs[i], lasts)
        return out

    def row_col_ranges_v1(self, mesh=None) -> np.ndarray:
        """Per-row ranges with the v1 empty-row quirk
        (``CSRMatrix.row_col_ranges_v1``), per block from its own arrays as
        the reference reads them before the allgather
        (``crpspmm.c:111-117``); reads past a block's edge are clipped into
        it.  On a mesh rank r reads block r alone, and the blocks' ranges
        are the ``all_gather_object`` of every rank's (the ``A_cidx_se``
        allgather, ``crpspmm.c:107-131``)."""
        if mesh is None:
            parts = [self._ranges_v1(i) for i in range(self.p)]
        else:
            import torch.distributed as tdist

            parts = [None] * self.p
            tdist.all_gather_object(parts, self._ranges_v1(mesh.rank), group=mesh.group)
        return np.concatenate(parts).reshape(self.m, 2)

    def _ranges_v1(self, i: int) -> np.ndarray:
        """Block i's rows' (first, last) colidx, (nrows_i, 2)."""
        r0, r1 = int(self.row_displs[i]), int(self.row_displs[i + 1])
        out = np.empty((r1 - r0, 2), dtype=np.int64)
        rp = np.asarray(self.rowptrs[i], dtype=np.int64)
        loc_nnz = int(rp[-1] - rp[0])
        if loc_nnz == 0:
            out[:, 0] = self.k
            out[:, 1] = -1
            return out
        firsts = np.minimum(rp[:-1] - rp[0], loc_nnz - 1)
        lasts = np.maximum(rp[1:] - 1 - rp[0], 0)
        out[:, 0] = _index(self.colidxs[i], firsts)
        out[:, 1] = _index(self.colidxs[i], lasts)
        return out


def _stack_blocks(arrays, maxw: int, dtype, device) -> torch.Tensor:
    """Per-owner 1D payloads -> one (p, 1, maxw) tensor on ``device``."""
    out = torch.zeros((len(arrays), 1, maxw), dtype=dtype, device=device)
    for i, x in enumerate(arrays):
        x = torch.as_tensor(x).to(device=device, dtype=dtype)
        out[i, 0, : x.shape[0]] = x
    return out


def _panel(grp, r0: int, r1: int, k: int, ci_chunks, v_chunks, lens) -> CSRMatrix:
    """Rows [r0, r1) of A from the pn chunks of its panel (each chunk's
    first ``lens[j]`` entries): the all_gather on one device, then the
    panel staged to the host."""
    ci = torch.cat([ci_chunks[j, : lens[j]] for j in range(len(lens))]).cpu().numpy()
    v = torch.cat([v_chunks[j, : lens[j]] for j in range(len(lens))]).cpu().numpy()
    return CSRMatrix(r1 - r0, k, grp[r0 : r1 + 1] - grp[r0], ci, v)


def ingest_dist_a(dist: DistCSR, m_split_idx: np.ndarray, pm: int, pn: int, device,
                  val_dtype=np.float64, mesh=None) -> tuple:
    """Reshard and replicate distributed A into the pm row-panel CSRs
    (``crpspmm.c:559-584``, once at init as A is constant):

      1. ``rd_Ai`` / ``rd_Av``: colidx and val (1 x nnz blocks) from the
         user's nnz ranges to per-(pi, pj) subranges, panel i's nnz split
         uniformly over its pn ranks (``crpspmm.c:242-249``);
      2. the all_gather along pn: panel i's chunks concatenated;
      3. the panel staged to the host for the kernel pack.

    On a mesh (``mesh``, pm x pn ranks) rank r reads block r's colidx and
    val alone, ``rd_Ai`` / ``rd_Av`` run on the mesh, the all_gather is
    ``dist.all_gather`` on the row group (each chunk padded to the longest
    and cut back on the host), and the panels then travel along the
    column group (``all_gather_object``), so that every rank plans from
    every panel, as :func:`replicate_a0_rank` does.

    Returns ``(panels, nelem_A_rd, nelem_A_agv)``, the audit counters summed
    over ranks as the reference's (``crpspmm.c:448-456``); on a mesh the
    same on every rank and equal to the one-device call's."""
    p = dist.p
    assert p == pm * pn, (p, pm, pn)
    grp = dist.global_rowptr()
    m_split_idx = np.asarray(m_split_idx, dtype=np.int64)
    assert len(m_split_idx) == pm + 1
    panel_s = grp[m_split_idx[:-1]]
    panel_nnz = (grp[m_split_idx[1:]] - panel_s).astype(np.int64)
    dst_blocks = np.zeros((p, 4), dtype=np.int64)
    sub_displs = []
    for i in range(pm):
        d = uniform_displs(int(panel_nnz[i]), pn)
        sub_displs.append(d)
        for j in range(pn):
            dst_blocks[i * pn + j] = (0, panel_s[i] + d[j], 1, d[j + 1] - d[j])
    src_blocks = np.zeros((p, 4), dtype=np.int64)
    for i in range(p):
        r0, r1 = int(dist.row_displs[i]), int(dist.row_displs[i + 1])
        src_blocks[i] = (0, grp[r0], 1, grp[r1] - grp[r0])
    src_bd, dst_bd = BlockDist(src_blocks), BlockDist(dst_blocks)
    rd_Ai = RedistEngine(src_bd, dst_bd, device, dtype=np.int32, mesh=mesh)
    rd_Av = RedistEngine(src_bd, dst_bd, device, dtype=val_dtype, mesh=mesh)
    owners = range(p) if mesh is None else [mesh.rank]
    x_ci = _stack_blocks([dist.colidxs[r] for r in owners], src_bd.max_w, torch.int32,
                         rd_Ai.device)
    x_v = _stack_blocks([dist.vals[r] for r in owners], src_bd.max_w,
                        torch_dtype(val_dtype), rd_Av.device)
    ci_int = rd_Ai.exec_device(x_ci)[:, 0]   # (p, dst_maxw), on a mesh (1, dst_maxw)
    v_int = rd_Av.exec_device(x_v)[:, 0]
    nelem_A_rd = int(panel_nnz.sum())          # sum of per-rank rd_A_nnz
    nelem_A_agv = 0 if pn == 1 else int(panel_nnz.sum() * pn)

    def panel(i, ci_chunks, v_chunks):
        return _panel(grp, int(m_split_idx[i]), int(m_split_idx[i + 1]), dist.k,
                      ci_chunks, v_chunks, np.diff(sub_displs[i]).tolist())

    if mesh is None:
        ci_int, v_int = ci_int.view(pm, pn, -1), v_int.view(pm, pn, -1)
        return ([panel(i, ci_int[i], v_int[i]) for i in range(pm)], nelem_A_rd,
                nelem_A_agv)
    from ..comm.exchange import gather_shards

    # the Allgatherv along pn: every chunk of the row is dst_maxw long
    mine = panel(mesh.pi, gather_shards(ci_int[None], mesh.row_group, pn)[:, 0],
                 gather_shards(v_int[None], mesh.row_group, pn)[:, 0])
    return _share_panels(mine, mesh), nelem_A_rd, nelem_A_agv


def _share_panels(mine: CSRMatrix, mesh) -> list:
    """Every panel of the grid on every rank: this rank's panel ``mesh.pi``
    along its column group (``all_gather_object``)."""
    if mesh.pm == 1:
        return [mine]
    import torch.distributed as tdist

    panels = [None] * mesh.pm
    tdist.all_gather_object(panels, mine, group=mesh.col_group)
    return panels


def replicate_a0(dist: DistCSR, a0_rowptr: np.ndarray, pm: int, pn: int, device,
                 val_dtype=np.float64) -> list:
    """v2-style A replication (``src/para2d_spmm.c:47-100``): blocks already
    in the plan's A0 layout (owner ``i*pn+j`` holds block ``i*pn+j``) are
    gathered along pn, so that panel i is the concatenation of its pn
    owners' blocks.  Returns the pm host panel CSRs."""
    from ..engine.rowpara import engine_device

    p = dist.p
    assert p == pm * pn, (p, pm, pn)
    a0 = np.asarray(a0_rowptr, dtype=np.int64)
    assert np.array_equal(a0, dist.row_displs), "blocks must be in A0 layout"
    device = engine_device(device)
    grp = dist.global_rowptr()
    blk_nnz = grp[a0[1:]] - grp[a0[:-1]]
    maxw = int(max(blk_nnz.max(), 1))
    x_ci = _stack_blocks(dist.colidxs, maxw, torch.int32, device).view(pm, pn, maxw)
    x_v = _stack_blocks(dist.vals, maxw, torch_dtype(val_dtype), device).view(pm, pn, maxw)
    return [_panel(grp, int(a0[i * pn]), int(a0[(i + 1) * pn]), dist.k, x_ci[i], x_v[i],
                   blk_nnz[i * pn : (i + 1) * pn].tolist())
            for i in range(pm)]


def replicate_a0_rank(dist_a: DistCSR, a0_rowptr: np.ndarray, mesh,
                      val_dtype=np.float64) -> list:
    """:func:`replicate_a0` on a mesh of ranks: rank ``r = pi*pn + pj``
    reads block r of ``dist_a`` alone, and panel pi is its row group's
    ``dist.all_gather`` of their blocks (JAX's device-side ``all_gather``
    along pn, ``crp_tpu/engine/para2d.py:80-104``), padded to the row's
    longest block and cut back on the host.  The exchange plan needs every
    panel's columns, so the panels then travel along the column group
    (``all_gather_object``): every rank plans from every panel, as every
    JAX process plans from the whole A.  Returns the pm host panel CSRs,
    equal to :func:`replicate_a0`'s."""
    from ..comm.exchange import gather_shards

    pm, pn, r = mesh.pm, mesh.pn, mesh.rank
    assert dist_a.p == pm * pn, (dist_a.p, pm, pn)
    a0 = np.asarray(a0_rowptr, dtype=np.int64)
    assert np.array_equal(a0, dist_a.row_displs), "blocks must be in A0 layout"
    grp = dist_a.global_rowptr()
    blk_nnz = grp[a0[1:]] - grp[a0[:-1]]
    pi = mesh.pi
    lens = blk_nnz[pi * pn : (pi + 1) * pn].tolist()
    maxw = int(max(max(lens), 1))
    device = mesh.device
    ci = _stack_blocks([dist_a.colidxs[r]], maxw, torch.int32, device)
    v = _stack_blocks([dist_a.vals[r]], maxw, torch_dtype(val_dtype), device)
    ci_row = gather_shards(ci, mesh.row_group, pn)[:, 0]   # (pn, maxw)
    v_row = gather_shards(v, mesh.row_group, pn)[:, 0]
    panel = _panel(grp, int(a0[pi * pn]), int(a0[(pi + 1) * pn]), dist_a.k, ci_row, v_row,
                   lens)
    return _share_panels(panel, mesh)
