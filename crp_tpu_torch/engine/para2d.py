"""2D (pm x pn) SpMM engine.

Counterpart of ``crp_tpu/engine/para2d.py`` (the reference's
``para2d_spmm``, ``src/para2d_spmm.{h,c}``): the planner's ``pm x pn``
grid.  A is cut into pm row panels, each replicated along its pn column
group; B and C are row-partitioned over pm (the plan's nnz-aware
boundaries) and column-partitioned over pn.  Each (i, j) block runs the
1D sparsity-aware B-row exchange along pm and the local SpMM on its
``nloc`` columns, as the JAX engine's ``shard_map`` over (pm, pn) does.

Every block lives on the engine's one device: the pm panels are packed
once, and the pn column groups share that one pack (on one device the
replication is the same tensor); the audit still reports the A
replication a distributed run pays, ``rA_cost``
(``src/para2d_spmm.c:102-109``).  The dd kinds run in fp64, as in
``RowParaSpmm``.  With pm > 1, ``auto`` on the card picks the fused
``pallas_halo`` kernel, as JAX does on a TPU: each column group's B blocks
are read in place by one launch over the pm panels.

``mesh=`` (``make_mesh_2d(pm, pn)``, as JAX's ``mesh=``, ``para2d.py:
48-65``) holds block (pi, pj) on rank (pi, pj), one process a rank: each
rank plans from every panel and keeps panel pi's slice of the pack, B
block (pi, pj) and its C block; the B exchange runs along pm inside its
column group (``mesh.col_group``; the fused kernel over the group's mapped
B buffers), and ``unshard_c`` all-gathers the C blocks over the grid.
``from_dist_a`` on a mesh assembles panel pi with ``dist.all_gather`` on
the row group (JAX's device-side ``all_gather`` along pn,
``para2d.py:80-104``); the panels' structure then goes to every rank of
the column group, which plans the exchange from them.

``overlap=1`` runs each column group's exchange as the ring schedule of
``comm/ring.py`` beside the panels' self parts (``para2d.py:230-248,
342-360``).  :meth:`Para2dSpmm.from_dist_a` takes A already distributed in
the plan's A0 layout (``shard/dist_a.py``): the panels are assembled from
the owners' blocks (``replicate_a0``), and ``rA_cost`` comes from the last
owner's block, as in JAX (``para2d.py:80-127``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..comm.exchange import (
    build_b_exchange, exchange_b, exchange_b_rank, exchange_b_ring, exchange_b_ring_rank,
    exchange_tables, gather_shards, rank_tables,
)
from ..comm.ring import ring_spmm
from ..config import SpmmConfig
from ..kernels.dispatch import resolve_auto_kernel
from ..kernels.spmm_halo import HaloPeers
from ..plan.planner2d import NNZ_COST_FACTOR
from ..shard.dist_a import torch_dtype
from ..shard.layout import shard_dense_2d, unshard_dense_2d
from ..utils.timers import Timer, synchronize
from .rowpara import (
    build_ring, check_dd_options, check_halo_options, check_mesh, engine_device,
    pack_engine, run_shards,
)
from .stats import format_comm_head, format_stat_table


class Para2dSpmm(torch.nn.Module):
    """init(A, plan)/exec(B)->C on the plan's pm x pn grid.

    ``a`` is the global CSR matrix, ``plan`` a :class:`Plan2D` (the
    planner's, or one with a forced grid); ``device`` where every block
    lives (default the card, or the mesh's device); ``mesh`` a pm x pn
    :class:`~crp_tpu_torch.shard.layout.RankMesh` (this rank then holds
    block (pi, pj) alone).
    """

    def __init__(self, a, plan, *, device=None, config: SpmmConfig | None = None,
                 dtype=None, mesh=None) -> None:
        super().__init__()
        self._setup(plan, device, config, dtype, mesh)
        t0 = Timer()
        with t0.phase("init"):
            panels = [a.row_slice(int(plan.AC_rowptr[i]), int(plan.AC_rowptr[i + 1]))
                      for i in range(self.pm)]
            last_blk_nnz = int(a.rowptr[plan.A0_rowptr[-1]] - a.rowptr[plan.A0_rowptr[-2]])
            self._build(panels, last_blk_nnz)
        self._finish_init(t0)

    @classmethod
    def from_dist_a(cls, dist, plan, *, device=None, config: SpmmConfig | None = None,
                    dtype=None, mesh=None) -> "Para2dSpmm":
        """Init from A already distributed: owner ``i*pn+j`` holds A0 block
        ``i*pn+j`` (a :class:`~crp_tpu_torch.shard.dist_a.DistCSR` in the
        plan's A0 layout, as ``scatter_csr_rows`` makes it,
        ``examples/test_utils.c:57-119``); each panel is gathered from its
        pn owners' blocks (``replicate_a0``), never from a host-global A.
        On a mesh rank r reads block r of ``dist`` alone, and the gather is
        ``dist.all_gather`` on its row group (``replicate_a0_rank``)."""
        from ..shard.dist_a import replicate_a0, replicate_a0_rank

        self = cls.__new__(cls)
        torch.nn.Module.__init__(self)
        self._setup(plan, device, config, dtype, mesh)
        t0 = Timer()
        with t0.phase("init"):
            if mesh is None:
                panels = replicate_a0(dist, plan.A0_rowptr, self.pm, self.pn, self.device,
                                      val_dtype=self.dtype)
            else:
                panels = replicate_a0_rank(dist, plan.A0_rowptr, mesh, val_dtype=self.dtype)
            # rA_cost from the LAST owner's block (src/para2d_spmm.c:102-109)
            rp = dist.rowptrs[-1]
            self._build(panels, int(rp[-1]) - int(rp[0]))
        self._finish_init(t0)
        return self

    def _setup(self, plan, device, config, dtype, mesh) -> None:
        self.config = config or SpmmConfig()
        check_mesh(mesh, plan.pm, plan.pn, "Para2dSpmm")
        self.mesh = mesh
        self.peers = None
        if self.config.bc_layout:
            raise ValueError(
                "BC_layout=1 is a RowParaSpmm feature (the reference's "
                "rp_spmm seam); this engine takes row-major (k, n)/(m, n)"
            )
        self.is_dd = self.config.kernel in ("dd", "dd_mxu")
        check_dd_options(self.config)
        check_halo_options(self.config)
        self.overlap = bool(self.config.overlap)
        self.device = engine_device(
            device if device is not None else mesh.device if mesh is not None else "cuda")
        self.plan = plan
        self.pm, self.pn = plan.pm, plan.pn
        self.glb_n = plan.n
        self.dtype = np.dtype(
            np.float64 if self.is_dd
            else dtype if dtype is not None else self.config.dtype
        )
        self.timer = Timer()
        self._t_build = Timer()

    def _finish_init(self, t0) -> None:
        self.t_init = t0.t["init"]
        tb = self._t_build
        self.init_breakdown = {
            k: round(tb.t.get(k, 0.0), 4) for k in ("plan", "pack", "upload")
        }

    # ------------------------------------------------------------------ init
    def _build(self, panels, last_blk_nnz: int) -> None:
        plan, tb = self.plan, self._t_build
        self.max_m = max(max(p_.nrow for p_ in panels), 1)
        # the planner's B_rowptr copies the nnz-balanced blocks for m == k,
        # which leave trailing empty rows out: extend to every column of A
        self._B_displs = np.asarray(plan.B_rowptr, dtype=np.int64).copy()
        if int(self._B_displs[-1]) < plan.k:
            self._B_displs[-1] = plan.k
        reidx = bool(self.config.rb_reidx)
        with tb.phase("plan"):
            self.xplan = build_b_exchange(
                [p_.colidx for p_ in panels], self._B_displs, reidx=reidx
            )
        kind = self.config.kernel
        if kind == "auto":
            kind = resolve_auto_kernel(self.device, self.pm, overlap=self.overlap)
        self.max_k = int(max(np.diff(self._B_displs).max(), 1))
        self.max_nloc = int(max(np.diff(plan.BC_colptr).max(), 1))
        self._identity_exchange = self.is_halo = False
        pi = None if self.mesh is None else self.mesh.pi
        if self.overlap:
            with tb.phase("pack"):
                self.ring, self.max_k, self._ring_send, self._side = build_ring(
                    panels, self.xplan, self._B_displs, self.max_m, self.max_k,
                    self.dtype, kind, device=self.device,
                    mxu_precision=self.config.mxu_precision, rank=pi)
            self._local_op, arrays = self.ring.self_op, self.ring.self_arrays
        else:
            with tb.phase("pack"):
                arrays, self._local_op, kind = pack_engine(
                    panels, self.xplan, reidx, self._B_displs, self.max_m,
                    self.dtype, kind, device=self.device,
                    mxu_precision=self.config.mxu_precision, is_dd=self.is_dd,
                    rank=pi,
                )
                synchronize(arrays)
            self.is_halo = kind == "pallas_halo"
            if self.is_halo:
                # the fused kernel owns B in 128-row aligned blocks
                self._B_displs = self._local_op.B_displs
                self.max_k = self._local_op.min_b_rows
                self.max_m = max(self.max_m, self._local_op.G * self._local_op.TM)
            self._rb_rows = max(self.xplan.rB_nrow_max,
                                1 if self.is_halo else self._local_op.min_b_rows, 1)
            with tb.phase("upload"):
                self._identity_exchange = (
                    not self.is_halo and self.pm == 1 and reidx
                    and len(self.xplan.rowmap[0]) == int(self._B_displs[-1])
                )
                if self._identity_exchange:
                    self.max_k = max(self.max_k, self._rb_rows)
                elif self.is_halo:
                    if self.mesh is not None:  # B block (pi, pj), mapped by the column
                        self.peers = HaloPeers(
                            (self.max_k, self.max_nloc),
                            self._local_op.b_dtype or torch_dtype(self.dtype), self.device,
                            self.mesh.col_group, self.mesh.col_ranks, pi, arrays[-1],
                            np.flatnonzero(self._local_op.readers[:, pi]))
                elif self.mesh is not None:
                    self.xtables = rank_tables(self.xplan, pi, self._rb_rows, self.device,
                                               ring=bool(self.config.rb_p2p))
                else:
                    self.xtables = exchange_tables(
                        self.xplan, self.max_k, self._rb_rows, self.device,
                        ring=bool(self.config.rb_p2p),
                    )
        self._n_packed = len(arrays)
        for i, x in enumerate(arrays):
            self.register_buffer(f"packed_{i}", x, persistent=False)
        self.kernel_kind = kind
        # audit (src/para2d_spmm.c:102-109): the last rank's A0 block nnz
        # sent to the other pn - 1 ranks of its group
        self.rA_cost = int(float(last_blk_nnz) * float(self.pn - 1) * NNZ_COST_FACTOR)
        self.rB_recv_size = int(self.xplan.total_recv_rows)

    @property
    def packed(self) -> tuple:
        """The pm panels' packed tensors, leading panel axis included (panel
        pi alone on a mesh)."""
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
        """Padded B rows one exec moves, over the pn column groups."""
        if self.is_halo:
            per_group = self._local_op.halo_rows_pushed
        elif self.overlap or self.config.rb_p2p:
            per_group = self.xplan.physical_rows_ring
        else:
            per_group = self.xplan.physical_rows
        return per_group * self.pn

    # ------------------------------------------------------------------ exec
    def shard_b(self, b: np.ndarray) -> torch.Tensor:
        """Global (k, n) -> (pm, pn, max_k, max_nloc) padded blocks on the
        engine's device; on a mesh block (pi, pj) alone, (1, 1, max_k,
        max_nloc).  A new tensor: never the fused kernel's mapped buffer,
        which the exec alone writes."""
        b = np.asarray(b, dtype=self.dtype)
        rows, cols = self._B_displs, self.plan.BC_colptr
        if self.mesh is not None:
            pi, pj = self.mesh.pi, self.mesh.pj
            rows, cols = rows[pi : pi + 2], cols[pj : pj + 2]
        return torch.from_numpy(shard_dense_2d(b, rows, cols, self.max_k,
                                               self.max_nloc)).to(self.device)

    def unshard_c(self, c_blocks: torch.Tensor) -> np.ndarray:
        """(pm, pn, rows, max_nloc) C blocks -> global host C (m, n); on a
        mesh every rank's block is gathered first, and every rank returns
        the global C."""
        if self.mesh is not None:
            c_blocks = gather_shards(c_blocks, self.mesh.group, self.mesh.size).reshape(
                self.pm, self.pn, *c_blocks.shape[2:])
        c = unshard_dense_2d(c_blocks.cpu().numpy(), self.plan.AC_rowptr,
                             self.plan.BC_colptr, self.plan.m, self.plan.n)
        if self.peers is not None:  # a host sync point: a wait that gave up raises
            self.peers.check()
        return c

    def forward(self, b_blocks: torch.Tensor) -> torch.Tensor:
        """Per column group j: the exchange along pm, then every panel's
        local op on its ``max_nloc`` columns; returns (pm, pn, rows,
        max_nloc) (on a mesh this rank's block, (1, 1, rows, max_nloc))."""
        mesh = self.mesh
        if mesh is None:
            xch = exchange_b_ring if self.config.rb_p2p else exchange_b
        elif self.config.rb_p2p:
            def xch(b, t):
                return exchange_b_ring_rank(b, t, mesh.col_group, mesh.col_ranks)
        else:
            def xch(b, t):
                return exchange_b_rank(b, t, mesh.col_group)
        out = []
        for j in range(b_blocks.shape[1]):
            bj = b_blocks[:, j]
            if self.is_halo:
                if self.peers is not None:
                    self.peers.load(bj)
                    out.append(self._local_op(self.packed, self.peers.buf,
                                              peers=self.peers,
                                              dtype=torch_dtype(self.dtype)))
                else:
                    out.append(self._local_op(self.packed, bj.contiguous()))
                continue
            if self.overlap:
                out.append(ring_spmm(bj.contiguous(), self.ring, self._ring_send,
                                     self._side, None if mesh is None else mesh.col_group,
                                     None if mesh is None else mesh.col_ranks))
                continue
            rB = bj if self._identity_exchange else xch(bj, self.xtables)
            out.append(run_shards(self._local_op, self.packed, rB))
        return torch.stack(out, dim=1)

    def exec_device(self, b_blocks: torch.Tensor) -> torch.Tensor:
        return self(b_blocks)

    def exec(self, b: np.ndarray) -> np.ndarray:
        """C := A @ B from a global host B; returns global host C (m, n)."""
        with self.timer.phase("pack"):
            bs = self.shard_b(b)
            synchronize(bs)
        c = self.exec_device(bs)
        with self.timer.phase("exec", fence=c):
            pass
        self.timer.n_exec += 1
        with self.timer.phase("unpack"):
            out = self.unshard_c(c)
        return out

    # ----------------------------------------------------------------- stats
    def print_stat(self) -> str:
        """Merged table in the spirit of ``para2d_spmm_print_stat``
        (``src/para2d_spmm.c:150-198``)."""
        body = format_stat_table(
            title="para2d_spmm", t_init=self.t_init, timer=self.timer,
            comm_rows=self.rB_recv_size, glb_n=self.glb_n,
            physical_rows=self.physical_rows,
            rank=None if self.mesh is None else
            f"Rank {self.mesh.rank} of {self.mesh.size} (pi, pj) = "
            f"({self.mesh.pi}, {self.mesh.pj})",
        )
        return format_comm_head(self.rA_cost, self.rB_recv_size * self.glb_n) + "\n" + body

    def clear_stat(self) -> None:
        self.timer.clear()
