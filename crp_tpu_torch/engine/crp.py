"""CrpSpmm, the any-layout engine (``crp_tpu/engine/crp.py``, the
reference's v1 ``crpspmm_engine``, ``deprecated/src/crpspmm.{h,c}``).

The user hands over B in arbitrary per-owner 2D blocks and wants C back in
arbitrary 2D blocks; the engine

  1. plans an ``np_row x np_col`` grid with the bandwidth-bound planner
     (``crpspmm.c:133-195`` -> ``plan/bandwidth.py``),
  2. reshards B from the user layout to k-slab x n-slab blocks (``rd_B``,
     ``shard/redist.py``),
  3. exchanges B rows along each grid column so that every row panel holds
     its window: the coarse contiguous ``[min_col, max_col]`` ranges, or the
     exact referenced rows under ``a2a_b_finegrain`` (``crpspmm.c:294-396``,
     ``comm/exchange.py``); the fused halo kernel reads the owners' rows in
     place instead, and ``overlap=1`` runs the ring of ``comm/ring.py``,
  4. runs the local kernel on every block (``kernels/dispatch.py``),
  5. reshards C to the user layout (``rd_C``).

A is a host-global CSR or already distributed (``shard/dist_a.py``
``DistCSR``, the v1 ``src_A_*`` arguments): then only O(m) metadata is
assembled on the host and the payload moves by ``ingest_dist_a``.  The
volumes are the ones a distributed run moves, computed as the reference's
audit does (``crpspmm.c:448-456``), with the "Alltoallv B necessary"
metric (``crpspmm.c:587-600``).  The dd kinds compute in fp64, so
``rd_B`` and ``rd_C`` move fp64 once where JAX moves hi / lo fp32 halves
twice; the logical counts are the same.

Without a mesh every block lives on the engine's one device (default the
card), as in the other engines: the user blocks and the internal blocks
are stacked along a leading axis, and each column group's exchange and
kernels run one after another.  ``mesh=`` (``make_mesh_2d(pm, pn)`` of the
planner's grid, as JAX's ``mesh=``, ``crp.py:82-98``) puts user block r,
internal block (pi, pj) and panel pi's pack on rank r = pi·pn + pj, one
process a rank: ``rd_B``, ``rd_C`` and distributed A's ``rd_Ai`` /
``rd_Av`` are ``all_to_all_single`` on the mesh's group, A's Allgatherv
runs on the row group, the B exchange (the a2a, the ring, the overlapped
ring, or the fused kernel over peer-mapped B blocks) on the column group,
and ``exec`` returns the global C on every rank.  Each rank plans from
every panel and packs its own; its pack equals slice pi of the one-device
pack and its user C block block r of the one-device engine's, bit for
bit; every counter is the same on every rank.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F

from ..comm.exchange import (
    build_b_exchange, exchange_b, exchange_b_rank, exchange_b_ring, exchange_b_ring_rank,
    exchange_tables, rank_tables,
)
from ..comm.ring import build_ring_spmm, ring_send_tables, ring_spmm
from ..config import SpmmConfig
from ..kernels.dispatch import pack_with_fallback, resolve_auto_kernel
from ..kernels.spmm_halo import HaloPeers, align_displs, build_halo_plan
from ..kernels.spmm_pallas import UnsupportedSparsity
from ..plan.bandwidth import calc_bandwidth_part2d
from ..shard.dist_a import DistCSR, ingest_dist_a, torch_dtype
from ..shard.redist import BlockDist, RedistEngine
from ..utils.timers import Timer, synchronize
from .rowpara import check_mesh, compact_shards, engine_device, run_shards

logger = logging.getLogger("crp_tpu_torch")


class CrpSpmm(torch.nn.Module):
    """init(A, n, user layouts) / exec(B) -> C.

    ``a`` is a global CSR (any object with ``nrow``, ``ncol``, ``rowptr``,
    ``colidx``, ``val``, ``row_slice`` and ``row_col_ranges_v1``) or a
    :class:`~crp_tpu_torch.shard.dist_a.DistCSR`; ``user_B`` / ``user_C``
    the p user blocks of B (k x n) and C (m x n); ``bplan`` a precomputed
    :class:`~crp_tpu_torch.plan.bandwidth.BandwidthPlan`; ``device`` where
    the blocks live (default the card, or the mesh's device); ``mesh`` a
    :class:`~crp_tpu_torch.shard.layout.RankMesh` of the planner's grid
    (this rank then holds user block ``mesh.rank`` and internal block
    (pi, pj) alone; see the module's docstring).
    """

    def __init__(self, a, n: int, user_B: BlockDist, user_C: BlockDist, *,
                 nproc: int | None = None, device=None,
                 config: SpmmConfig | None = None, dtype=None, bplan=None,
                 mesh=None) -> None:
        super().__init__()
        self.config = config or SpmmConfig()
        if self.config.bc_layout:
            raise ValueError(
                "BC_layout=1 is a RowParaSpmm feature (the reference's "
                "rp_spmm seam); this engine takes row-major (k, n)/(m, n)"
            )
        self.mesh = mesh
        self.peers = None
        self.device = engine_device(
            device if device is not None else mesh.device if mesh is not None else "cuda")
        self.m, self.k, self.n = a.nrow, a.ncol, n
        self.nproc = nproc or user_B.p
        assert user_B.p == self.nproc and user_C.p == self.nproc
        if mesh is not None and mesh.size != self.nproc:
            raise ValueError(f"CrpSpmm: {self.nproc} user blocks on a mesh of {mesh.size} "
                             "ranks; the mesh must be the engine's grid")
        # the dd kinds compute in fp64 ("auto" never resolves to them here)
        self.is_dd = self.config.kernel in ("dd", "dd_mxu")
        self.dtype = np.dtype(np.float64 if self.is_dd
                              else dtype if dtype is not None else self.config.dtype)
        self.timer = Timer()
        t0 = Timer()
        with t0.phase("init"):
            self._build(a, user_B, user_C, bplan)
        self.t_init = t0.t["init"]

    # ------------------------------------------------------------------ init
    def _build(self, a, user_B, user_C, bplan) -> None:
        p = self.nproc
        is_dist = isinstance(a, DistCSR)
        # 1. the v1 planner (crpspmm.c:133-195); for distributed A only the
        # O(m) metadata is assembled (crpspmm.c:90-131)
        mesh = self.mesh
        grp = a.global_rowptr() if is_dist else a.rowptr
        bp = bplan if bplan is not None else calc_bandwidth_part2d(
            p, self.m, self.n, self.k, grp,
            a.row_col_ranges_v1(mesh) if is_dist else a.row_col_ranges_v1())
        self.bplan = bp
        pm, pn = self.pm, self.pn = bp.np_row, bp.np_col
        check_mesh(mesh, pm, pn, "CrpSpmm")
        pi = None if mesh is None else mesh.pi

        self.overlap = bool(self.config.overlap)
        fine = self.fine = bool(self.config.a2a_b_finegrain)
        kind = self.config.kernel
        if kind == "auto":
            kind = resolve_auto_kernel(self.device, pm, overlap=self.overlap,
                                       allow_halo=not fine)
        if self.is_dd and self.overlap:
            raise ValueError(
                "kernel='dd' is incompatible with overlap=1: the per-shift "
                "partial SpMM is plain fp32 and would lose the dd accuracy"
            )
        self.is_halo = kind == "pallas_halo"
        if self.is_halo and self.overlap:
            raise ValueError(
                "kernel='pallas_halo' fuses exchange and compute already; "
                "overlap=1 has no meaning for it"
            )
        if self.is_halo and fine:
            raise ValueError(
                "kernel='pallas_halo' implements the coarse contiguous-"
                "window geometry (crpspmm.c:294-338); A2A_B_FINEGRAIN=1 "
                "requests exact-row exchange — use kernel='pallas'"
            )

        rd_rows = bp.B_rd_row_displs          # (pm+1,) uniform k slabs
        bc_cols = bp.BC_colptr                # (pn+1,) uniform n slabs
        m_idx = bp.m_split_idx
        # the A row panels: distributed A through rd_Ai / rd_Av and the
        # gather along pn (crpspmm.c:240-265,559-584)
        if is_dist:
            panels, self.nelem_A_rd, self.nelem_A_agv = ingest_dist_a(
                a, m_idx, pm, pn, self.device, val_dtype=self.dtype, mesh=mesh)
        else:
            panels = [a.row_slice(int(m_idx[i]), int(m_idx[i + 1])) for i in range(pm)]
            self.nelem_A_rd = int(a.nnz)
            self.nelem_A_agv = 0 if pn == 1 else int(sum(s.nnz for s in panels) * pn)
        self.max_m = max(max(s.nrow for s in panels), 1)

        prec = self.config.mxu_precision
        if self.is_halo:
            # the fused kernel owns B in 128-row aligned slabs: decided before
            # the boundaries are frozen into rd_B's tables (crp.py:160-175)
            aligned = align_displs(rd_rows, self.k)
            try:
                arrays, self._local_op = build_halo_plan(
                    panels, aligned, device=self.device, dtype=self.dtype, precision=prec,
                    ranks=None if pi is None else [pi])
                rd_rows = aligned
            except UnsupportedSparsity as e:
                logger.warning("pallas_halo unavailable (%s); falling back to the "
                               "unfused pallas path", e)
                self.is_halo = False
                kind = "pallas"

        # 2. rd_B and 5. rd_C
        internal_B = BlockDist.from_grid(rd_rows, bc_cols)
        internal_C = BlockDist.from_grid(m_idx, bc_cols)
        self.rd_B = RedistEngine(user_B, internal_B, self.device, dtype=self.dtype,
                                 mesh=mesh)
        self.rd_C = RedistEngine(internal_C, user_C, self.device, dtype=self.dtype,
                                 mesh=mesh)

        # 3. the B-row exchange along pm within each column group
        if fine:
            row_lists = [s.colidx for s in panels]
        else:  # the contiguous window of each panel's per-row ranges
            row_lists = [np.arange(bp.B_windows[i, 0], bp.B_windows[i, 1])
                         for i in range(pm)]
        self.xplan = build_b_exchange(row_lists, rd_rows, reidx=fine)
        self.max_k = int(max(np.diff(rd_rows).max(), 1))
        self.max_nloc = int(max(np.diff(bc_cols).max(), 1))
        self._b_pad = 0  # zero rows under rd_B's slabs: what the kernel reads past max_k

        if self.is_halo:
            self.kernel_kind = "pallas_halo"
            # the kernel's B shards hold min_b_rows rows: rd_B's slabs are
            # padded in the exec; on a mesh the zero rows past max_k are the
            # peers' buffer's own, which the exec writes above them alone
            self._b_pad = self._local_op.min_b_rows - self.max_k
            if mesh is not None:
                self.peers = HaloPeers(
                    (self._local_op.min_b_rows, self.max_nloc),
                    self._local_op.b_dtype or torch_dtype(self.dtype), self.device,
                    mesh.col_group, mesh.col_ranks, pi, arrays[-1],
                    np.flatnonzero(self._local_op.readers[:, pi]))
                self._b_pad = 0
        elif self.overlap:
            self.ring = build_ring_spmm(panels, self.xplan, rd_rows, self.max_m,
                                        self.dtype, kind, device=self.device,
                                        mxu_precision=prec, rank=pi)
            self.kernel_kind = self.ring.self_kind
            self._local_op, arrays = self.ring.self_op, self.ring.self_arrays
            # rd_B's slab height is frozen in its tables: pad the slabs up
            # to the self kernel's window reach in the exec instead
            self._b_pad = max(0, self.ring.min_b_rows - self.max_k)
            self._ring_send = ring_send_tables(self.xplan, self.max_k + self._b_pad,
                                               self.device, pi)
            self._side = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        else:
            arrays, self._local_op, kind = pack_with_fallback(
                compact_shards(panels, self.xplan, fine), self.max_m, self.dtype, kind,
                device=self.device, mxu_precision=prec, is_dd=self.is_dd, rank=pi)
            self.kernel_kind = kind
            self._rb_rows = max(self.xplan.rB_nrow_max, self._local_op.min_b_rows, 1)
            if mesh is None:
                self.xtables = exchange_tables(self.xplan, self.max_k, self._rb_rows,
                                               self.device, ring=bool(self.config.rb_p2p))
            else:
                self.xtables = rank_tables(self.xplan, pi, self._rb_rows, self.device,
                                           ring=bool(self.config.rb_p2p))
        synchronize(list(arrays))
        self._n_packed = len(arrays)
        for i, x in enumerate(arrays):
            self.register_buffer(f"packed_{i}", x, persistent=False)

        # audit (crpspmm.c:448-456, 587-600); the A counters are set above
        loc_ncols = np.diff(bc_cols)
        self.nelem_B_rd = self.rd_B.nelem_dst
        req_rows = np.array([len(np.unique(s.colidx)) for s in panels], dtype=np.int64)
        if pm == 1:
            self.nelem_B_a2av = 0
        elif fine:  # every requested row, the panel's own included
            self.nelem_B_a2av = int((req_rows[:, None] * loc_ncols[None, :]).sum())
        else:
            win = (bp.B_windows[:, 1] - bp.B_windows[:, 0]).astype(np.int64)
            self.nelem_B_a2av = int((win[:, None] * loc_ncols[None, :]).sum())
        self.nelem_B_a2av_min = int((req_rows[:, None] * loc_ncols[None, :]).sum())

    @property
    def packed(self) -> tuple:
        """The local kernel's packed tensors, leading panel axis included
        (panel pi alone on a mesh)."""
        return tuple(getattr(self, f"packed_{i}") for i in range(self._n_packed))

    def close(self) -> None:
        """Drop the peers' B mappings of the fused kernel across ranks
        (collective: every rank calls it, before any frees its engine);
        then raise ``HaloTimeout`` where a wait of the kernel gave up."""
        if self.peers is not None:
            peers, self.peers = self.peers, None
            peers.close()

    @property
    def physical_rows(self) -> int:
        """Padded B rows one exec's exchange moves over the pn column
        groups: every push of the fused kernel, else ``pm·(pm−1)·S`` on the
        ring (the overlapped one too) or ``pm·pm·S`` for the all_to_all."""
        if self.is_halo:
            per_group = self._local_op.halo_rows_pushed
        elif self.overlap or self.config.rb_p2p:
            per_group = self.xplan.physical_rows_ring
        else:
            per_group = self.xplan.physical_rows
        return per_group * self.pn

    # ------------------------------------------------------------------ exec
    def _blocks(self, b_int: torch.Tensor) -> torch.Tensor:
        """rd_B's output (p, max_k, max_nloc) as (pm, pn, rows, max_nloc),
        padded with zero rows to what the fused or the ring's self kernel
        reads; on a mesh this rank's block, (1, 1, rows, max_nloc), and
        for the fused kernel the peers' buffer with the block written in
        (its first ``max_k`` rows, by ``HaloPeers.load``, which alone
        orders the write with the peers' reads)."""
        if self.peers is not None:
            self.peers.load(b_int)
            return self.peers.buf[:, None]
        b4 = b_int.view(-1, self.pn if self.mesh is None else 1, self.max_k, self.max_nloc)
        return F.pad(b4, (0, 0, 0, self._b_pad)) if self._b_pad else b4

    def _exchange(self, b4: torch.Tensor) -> torch.Tensor:
        """The unfused exchange of every column group: (pm, pn, rb_rows,
        max_nloc); on a mesh along this rank's column group, (1, 1,
        rb_rows, max_nloc)."""
        mesh = self.mesh
        if mesh is None:
            xch = exchange_b_ring if self.config.rb_p2p else exchange_b
        elif self.config.rb_p2p:
            def xch(b, t):
                return exchange_b_ring_rank(b, t, mesh.col_group, mesh.col_ranks)
        else:
            def xch(b, t):
                return exchange_b_rank(b, t, mesh.col_group)
        return torch.stack([xch(b4[:, j].contiguous(), self.xtables)
                            for j in range(b4.shape[1])], dim=1)

    def _local(self, rB4: torch.Tensor) -> torch.Tensor:
        """Each panel's local op on its column groups' receive buffers:
        (pm, pn, max_m, max_nloc) (on a mesh (1, 1, ...))."""
        return torch.stack([run_shards(self._local_op, self.packed, rB4[:, j])[:, : self.max_m]
                            for j in range(rB4.shape[1])], dim=1)

    def _spmm(self, b4: torch.Tensor) -> torch.Tensor:
        """Exchange and local SpMM of every block: (pm, pn, max_m,
        max_nloc) (on a mesh (1, 1, ...)); the halo kernel's and the
        kernels' rows past max_m trimmed."""
        mesh = self.mesh
        if self.is_halo:
            if self.peers is not None:
                return self._local_op(self.packed, self.peers.buf, peers=self.peers,
                                      dtype=torch_dtype(self.dtype))[
                    :, None, : self.max_m, : self.max_nloc]
            return torch.stack([self._local_op(self.packed, b4[:, j].contiguous())
                                [:, : self.max_m, : self.max_nloc]
                                for j in range(self.pn)], dim=1)
        if self.overlap:
            return torch.stack([ring_spmm(b4[:, j].contiguous(), self.ring,
                                          self._ring_send, self._side,
                                          None if mesh is None else mesh.col_group,
                                          None if mesh is None else mesh.col_ranks)
                                for j in range(b4.shape[1])], dim=1)
        return self._local(self._exchange(b4))

    def _c_blocks(self, c4: torch.Tensor) -> torch.Tensor:
        """The internal C blocks as rd_C takes them: (p, max_m, max_nloc),
        on a mesh (1, max_m, max_nloc)."""
        return c4.reshape(-1, self.max_m, self.max_nloc)

    def forward(self, b_user_shards: torch.Tensor) -> torch.Tensor:
        """(p, userB_max_h, userB_max_w) user blocks of B on the device ->
        (p, userC_max_h, userC_max_w) user blocks of C (on a mesh this
        rank's, (1, ...) -> (1, ...)): rd_B, the exchange and local SpMM,
        rd_C, with no fence (:meth:`exec` times them)."""
        c4 = self._spmm(self._blocks(self.rd_B.exec_device(b_user_shards)))
        return self.rd_C.exec_device(self._c_blocks(c4))

    def exec_device(self, b_user_shards: torch.Tensor) -> torch.Tensor:
        return self(b_user_shards)

    def exec(self, b: np.ndarray) -> np.ndarray:
        """Host global B (k, n) -> host global C (m, n) through the user
        layouts, the phases fenced one by one as the reference times them
        (``crpspmm.c:522-689``): rd_B, a2a_B, spmm, rd_C; the fused kernel
        and the overlapped ring are one spmm phase.  On a mesh every rank
        passes the global B, moves its own user block, and returns the
        global C (every rank's user C block gathered)."""
        t = self.timer
        with t.phase("exec"):
            bs = self.rd_B.shard_src(np.asarray(b, dtype=self.dtype))
            with t.phase("rd_B"):
                b4 = self._blocks(self.rd_B.exec_device(bs))
                synchronize(b4)
            with t.phase("exec_nr"):  # the reference's t_exec_nr: a2a + spmm
                if self.overlap or self.is_halo:
                    with t.phase("spmm"):
                        c4 = self._spmm(b4)
                        synchronize(c4)
                else:
                    with t.phase("a2a_B"):
                        rB4 = self._exchange(b4)
                        synchronize(rB4)
                    with t.phase("spmm"):
                        c4 = self._local(rB4)
                        synchronize(c4)
            with t.phase("rd_C"):
                cs = self.rd_C.exec_device(self._c_blocks(c4))
                synchronize(cs)
            out = self.rd_C.unshard_dst(cs, self.m, self.n)
        if self.peers is not None:  # a host sync point: a wait that gave up raises
            self.peers.check()
        t.n_exec += 1
        return out

    # ----------------------------------------------------------------- stats
    def print_stat(self) -> str:
        """Runtime and communicated-element tables in the shape of
        ``crpspmm_engine_print_stat`` (``crpspmm.c:715-772``): min / avg /
        max over the execs of :meth:`exec`; A moves once at init, so its
        per-exec rows read zero.  On a mesh a line names this rank: the
        times are its own, the element counts the whole run's."""
        t = self.timer
        ne = max(t.n_exec, 1)

        def row(label, key):
            return (f"{label} {t.min(key):6.3f}      "
                    f"{t.t.get(key, 0.0)/ne:6.3f}      {t.max(key):6.3f}")

        mesh = self.mesh
        rank = [] if mesh is None else [
            f"Rank {mesh.rank} of {mesh.size} (pi, pj) = ({mesh.pi}, {mesh.pj})"]
        return "\n".join([
            f"crpspmm_engine init time: {self.t_init:.3f} s", *rank,
            "-------------------------- Runtime (s) -------------------------",
            "                                   min         avg         max",
            row("Redist A to internal 1D layout ", "rd_A"),
            row("Redist B to internal 2D layout ", "rd_B"),
            row("Replicate A with allgatherv    ", "agv_A"),
            row("Replicate B with alltoallv     ", "a2a_B"),
            row("Local SpMM                     ", "spmm"),
            row("SpMM w/o Redist                ", "exec_nr"),
            row("Redist C to user's 2D layout   ", "rd_C"),
            row(f"SpMM total (avg of {t.n_exec:3d} runs)   ", "exec"),
            "------------------ Communicated Matrix Elements -----------------",
            "                                       sum",
            f"Redist A                {self.nelem_A_rd:>15}",
            f"Allgatherv A            {self.nelem_A_agv:>15}",
            f"Redist B                {self.nelem_B_rd:>15}",
            f"Alltoallv B             {self.nelem_B_a2av:>15}",
            f"Alltoallv B necessary   {self.nelem_B_a2av_min:>15}",
        ])

    def clear_stat(self) -> None:
        self.timer.clear()
