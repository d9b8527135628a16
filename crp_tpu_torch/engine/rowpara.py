"""1D row-parallel SpMM engine.

Counterpart of ``crp_tpu/engine/rowpara.py`` (the reference's ``rp_spmm``,
``src/rowpara_spmm.{h,c}``): init plans and packs A once; each exec moves
exactly the B rows each shard's A references into that shard's receive
buffer (``comm/exchange.py``: a padded all_to_all, or a ring of p - 1
shifts under ``rb_p2p=1``) and runs the local SpMM kernel on every shard.
The p shards live on the engine's one device, stacked along a leading axis,
as the JAX package's single controller holds them on its mesh; the shards'
local ops run one after another.  At p = 1 with every B row referenced the
exchange is the identity and is elided: the kernel reads the owned block
of B directly.

``kernel="pallas_halo"`` (what ``auto`` picks for p > 1 on the card, as
JAX does on a TPU) fuses the exchange into the windowed kernel: B is
owned in 128-row aligned blocks, and one launch reads each shard's windows
straight from the owner shards' rows (``kernels/spmm_halo.py``).  Where
its plan refuses (an empty shard, a window over 16384 rows, falling
window starts) the engine takes the unfused ``pallas`` path, as JAX does.

``overlap=1`` runs the ring schedule of ``comm/ring.py``: each shard's
self part on the local kernel (on a second CUDA stream) beside the p - 1
shifts and their segment sums (``rowpara.py:186-203,535-545``); ``auto``
then takes ``pallas``, not the fused kernel.  ``bc_layout=1`` is the
reference's col-major view (``rowpara.py:456-500``): B arrives as (n, k)
and C returns as (n, m), each transposed on the device; ``auto`` steps
down from the fused kernel to ``pallas``.

``mesh=`` (a :class:`~crp_tpu_torch.shard.layout.RankMesh` of p ranks,
``make_mesh_1d(p)``, as JAX's ``mesh=`` keyword, ``rowpara.py:45-62``) puts
one shard on each rank's device, one process a rank: each rank plans from
the whole A, as every JAX process does, and holds its own slice of the
pack (bit for bit slice [r] of the one-device engine's); ``shard_b``
returns its B shard (1, max_k, n), the exchange runs on the mesh's group
(``all_to_all_single``, or ``batch_isend_irecv`` shifts on the ring), the
fused kernel reads the owners' B buffers through CUDA IPC
(:class:`~crp_tpu_torch.kernels.spmm_halo.HaloPeers`), and ``unshard_c``
all-gathers C, so that every rank returns the global C.  Each rank's C
equals slice [r] of the one-device engine's C bit for bit.

The ``dd`` and ``dd_mxu`` kinds compute in fp64 whatever ``dtype`` says:
A's values, B and C are fp64 (the JAX package carries B and C as hi/lo
fp32 pairs, 48 bits; the port carries 53).  As in JAX, they refuse
``bc_layout`` and ``overlap``, and an explicit ``pallas_halo`` refuses
both too (``ValueError``).
"""

from __future__ import annotations

import hashlib
import logging

import numpy as np
import torch

from ..comm.exchange import (
    build_b_exchange, exchange_b, exchange_b_rank, exchange_b_ring, exchange_b_ring_rank,
    exchange_tables, gather_shards, rank_tables,
)
from ..comm.ring import build_ring_spmm, ring_send_tables, ring_spmm
from ..config import SpmmConfig
from ..kernels.dispatch import pack_with_fallback, resolve_auto_kernel
from ..kernels.spmm_halo import HaloPeers, align_displs, build_halo_plan
from ..kernels.spmm_pallas import UnsupportedSparsity
from ..shard.dist_a import torch_dtype
from ..shard.layout import shard_dense_rows, unshard_dense_rows
from ..utils.timers import Timer, synchronize
from .stats import format_stat_table

logger = logging.getLogger("crp_tpu_torch")


def check_halo_options(config: SpmmConfig) -> None:
    """The JAX refusals of ``kernel="pallas_halo"`` (``rowpara.py:115-140``),
    made before the pack."""
    if config.kernel == "pallas_halo" and config.overlap:
        raise ValueError(
            "kernel='pallas_halo' fuses exchange and compute already; "
            "overlap=1 has no meaning for it"
        )
    if config.kernel == "pallas_halo" and config.bc_layout:
        raise ValueError(
            "BC_layout=1 is incompatible with kernel='pallas_halo' "
            "(the fused kernel reads B row-major)"
        )


def check_dd_options(config: SpmmConfig) -> None:
    """The JAX refusals of the dd kinds (``rowpara.py:125-135``), made
    before the pack."""
    if config.kernel not in ("dd", "dd_mxu"):
        return
    if config.bc_layout:
        raise ValueError(
            "BC_layout=1 supports the standard kernel paths; the dd kinds "
            "keep B and C row-major in fp64"
        )
    if config.overlap:
        raise ValueError(
            "kernel='dd' is incompatible with overlap=1: the per-shift "
            "partial SpMM is plain fp32 and would lose the dd accuracy"
        )


def engine_device(device) -> torch.device:
    """The engine's device; a CUDA device with no card raises (the engines
    never fall back to the CPU: tests ask for it with ``device="cpu"``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the engines run on the card by default; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return device


def check_mesh(mesh, pm: int, pn: int, engine: str) -> None:
    """A mesh must be the engine's grid: pm ranks along the exchange, pn
    along the columns."""
    if mesh is not None and (mesh.pm, mesh.pn) != (pm, pn):
        raise ValueError(f"{engine}: a {mesh.pm} x {mesh.pn} mesh for a {pm} x {pn} "
                         "grid; the mesh must be the engine's grid")


def _digest(*arrs) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    for x in arrs:
        h.update(np.ascontiguousarray(x))
    return h.digest()


def compact_shards(shards, xplan, reidx: bool) -> list:
    """Each shard's ``(rowptr, columns in its receive buffer's rows, val)``:
    the plan's compaction (``reidx``) or window offset."""
    out = []
    for i, s in enumerate(shards):
        if reidx:
            cc = np.searchsorted(xplan.rowmap[i], s.colidx)
        else:
            cc = s.colidx - int(xplan.rowmap[i])
        out.append((s.rowptr, cc.astype(np.int32), s.val))
    return out


def pack_engine(shards, xplan, reidx, B_displs, max_m, dtype, kind, *,
                device, mxu_precision, is_dd, rank=None) -> tuple:
    """The engines' pack: ``(arrays, op, resolved kind)``.  ``pallas_halo``
    packs the fused kernel from the shards' global columns on B ownership
    rounded to 128 rows; where its plan refuses, the engines take
    ``pallas`` with the ownership their exchange plan was built on
    (``rowpara.py:147-168``).  Every other kind packs the shards' compacted
    columns through the dispatch's fallback walk.  ``rank``: a rank of a
    mesh plans from every shard, as the one-device engine, and puts its
    own shard's slice of the arrays alone on the device (every kind
    densifies that shard alone), so that its pack equals slice [rank] of
    the whole pack bit for bit."""
    if kind == "pallas_halo":
        aligned = align_displs(B_displs, int(B_displs[-1]))
        try:
            arrays, op = build_halo_plan(shards, aligned, device=device,
                                         dtype=dtype, precision=mxu_precision,
                                         ranks=None if rank is None else [rank])
            return arrays, op, kind
        except UnsupportedSparsity as e:
            logger.warning("pallas_halo unavailable (%s); falling back to the "
                           "unfused pallas path", e)
            kind = "pallas"
    return pack_with_fallback(
        compact_shards(shards, xplan, reidx), max_m, dtype, kind, device=device,
        mxu_precision=mxu_precision, is_dd=is_dd, rank=rank,
    )


def build_ring(shards, xplan, B_displs, max_m, max_k, dtype, kind, *, device,
               mxu_precision, rank=None) -> tuple:
    """The overlapped ring of the 1D and 2D engines: ``(pack, max_k, send
    tables, side stream)``, the B shards' rows grown to the self kernel's
    window reach (it reads its windows straight from them) and a second
    CUDA stream for the self part (None off the card); ``rank``: a mesh
    rank's own shard alone."""
    ring = build_ring_spmm(shards, xplan, B_displs, max_m, dtype, kind, device=device,
                           mxu_precision=mxu_precision, rank=rank)
    synchronize(list(ring.self_arrays))
    max_k = max(max_k, ring.min_b_rows)
    side = torch.cuda.Stream(device) if device.type == "cuda" else None
    return ring, max_k, ring_send_tables(xplan, max_k, device, rank), side


def run_shards(local_op, packed, rB) -> torch.Tensor:
    """``local_op`` on every shard's packed tensors and receive buffer
    ``rB[i]``, one after another: (p, rows, n)."""
    outs = [local_op(tuple(x[i] for x in packed), rB[i]) for i in range(len(rB))]
    return outs[0][None] if len(outs) == 1 else torch.stack(outs)


class RowParaSpmm(torch.nn.Module):
    """init(plan)/exec(B)->C engine for 1D row-parallel SpMM.

    ``a`` is the global CSR matrix (any object with ``nrow``, ``ncol``,
    ``rowptr``, ``colidx``, ``val`` and ``row_slice``); ``A_row_displs`` and
    ``B_row_displs`` the (p+1,) row blocks of A/C and the ownership
    partition of B; ``device`` where the packed shards live and the kernels
    run (default the card, or the mesh's device).  The packed tensors are
    the module's buffers.  ``mesh``: a 1D
    :class:`~crp_tpu_torch.shard.layout.RankMesh` of p ranks; this rank
    then holds shard ``mesh.pi`` alone (see the module's docstring).
    """

    def __init__(self, a, A_row_displs, B_row_displs, glb_n: int, *,
                 device=None, config: SpmmConfig | None = None,
                 dtype=None, mesh=None) -> None:
        super().__init__()
        self.config = config or SpmmConfig()
        self.A_row_displs = np.asarray(A_row_displs, dtype=np.int64)
        self.B_row_displs = np.asarray(B_row_displs, dtype=np.int64)
        self.p = len(self.A_row_displs) - 1
        check_mesh(mesh, self.p, 1, "RowParaSpmm")
        self.mesh = mesh
        self.rank = None if mesh is None else mesh.pi
        self.peers = None
        # "auto" never resolves to a dd kind here (resolve_auto_kernel)
        self.is_dd = self.config.kernel in ("dd", "dd_mxu")
        check_dd_options(self.config)
        check_halo_options(self.config)
        self.overlap = bool(self.config.overlap)
        self.device = engine_device(
            device if device is not None else mesh.device if mesh is not None else "cuda")
        self.glb_n = glb_n
        self.dtype = np.dtype(
            np.float64 if self.is_dd
            else dtype if dtype is not None else self.config.dtype
        )
        self.glb_m = a.nrow
        self.timer = Timer()

        t0 = Timer()
        self._t_build = Timer()
        with t0.phase("init"):
            self._build(a)
        self.t_init = t0.t["init"]
        tb = self._t_build
        self.init_breakdown = {
            k: round(tb.t.get(k, 0.0), 4) for k in ("plan", "pack", "upload")
        }

    # ------------------------------------------------------------------ init
    def _build(self, a) -> None:
        tb = self._t_build
        with tb.phase("plan"):
            shards = [
                a.row_slice(
                    int(self.A_row_displs[i]), int(self.A_row_displs[i + 1])
                )
                for i in range(self.p)
            ]
            self.max_m = max(max(s.nrow for s in shards), 1)
            # nnz-balanced row blocks leave trailing empty rows out: extend
            # the last B boundary to cover every column of A
            if int(self.B_row_displs[-1]) < a.ncol:
                self.B_row_displs = self.B_row_displs.copy()
                self.B_row_displs[-1] = a.ncol
            reidx = bool(self.config.rb_reidx)
            self.xplan = build_b_exchange(
                [s.colidx for s in shards], self.B_row_displs, reidx=reidx
            )
        kind = self.config.kernel
        if kind == "auto":
            kind = resolve_auto_kernel(self.device, self.p, overlap=self.overlap)
            if self.config.bc_layout and kind == "pallas_halo":
                kind = "pallas"  # the nearest kernel that takes the col-major view
        self.max_k = int(max(np.diff(self.B_row_displs).max(), 1))
        self._identity_exchange = self.is_halo = False
        if self.overlap:
            with tb.phase("pack"):
                self.ring, self.max_k, self._ring_send, self._side = build_ring(
                    shards, self.xplan, self.B_row_displs, self.max_m, self.max_k,
                    self.dtype, kind, device=self.device,
                    mxu_precision=self.config.mxu_precision, rank=self.rank)
            self._local_op = self.ring.self_op
            self._finish(kind, self.ring.self_arrays)
            return

        # single-slot pack memo on the matrix (rowpara.py:205-289): a new
        # key drops the old pack's device tensors
        cache_key = (
            "rowpara_pack", kind, self.config.mxu_precision, str(self.dtype),
            reidx, str(self.device), self.rank,
            self.A_row_displs.tobytes(), self.B_row_displs.tobytes(),
            a.nnz, _digest(a.rowptr, a.colidx, a.val),
        )
        cache = a.__dict__.setdefault("_torch_pack_cache", {})
        if cache_key in cache:
            kind, self._local_op, arrays = cache[cache_key]
        else:
            cache.clear()
            with tb.phase("pack"):
                arrays, self._local_op, kind = pack_engine(
                    shards, self.xplan, reidx, self.B_row_displs, self.max_m,
                    self.dtype, kind, device=self.device,
                    mxu_precision=self.config.mxu_precision, is_dd=self.is_dd,
                    rank=self.rank,
                )
                synchronize(arrays)
            cache[cache_key] = (kind, self._local_op, arrays)
        self.is_halo = kind == "pallas_halo"
        if self.is_halo:
            # the fused kernel owns B in 128-row aligned blocks and reads the
            # shards' rows in place: no receive buffer
            self.B_row_displs = self._local_op.B_displs
            self.max_k = self._local_op.min_b_rows
            self.max_m = max(self.max_m, self._local_op.G * self._local_op.TM)
        # the windowed kernels read whole windows: rB carries min_b_rows
        self._rb_rows = max(
            self.xplan.rB_nrow_max,
            1 if self.is_halo else self._local_op.min_b_rows, 1,
        )
        with tb.phase("upload"):
            self._identity_exchange = (
                not self.is_halo
                and self.p == 1
                and bool(self.config.rb_reidx)
                and len(self.xplan.rowmap[0]) == int(self.B_row_displs[-1])
            )
            if self._identity_exchange:
                # the kernel reads the owned block directly; pad it to the
                # receive-buffer size the kernel was packed for
                self.max_k = max(self.max_k, self._rb_rows)
            elif self.is_halo:
                if self.mesh is not None:  # this rank's B buffer, mapped by its peers
                    self.peers = HaloPeers(
                        (self.max_k, self.glb_n),
                        self._local_op.b_dtype or torch_dtype(self.dtype), self.device,
                        self.mesh.col_group, self.mesh.col_ranks, self.rank, arrays[-1],
                        np.flatnonzero(self._local_op.readers[:, self.rank]))
            elif self.mesh is not None:
                self.xtables = rank_tables(self.xplan, self.rank, self._rb_rows,
                                           self.device, ring=bool(self.config.rb_p2p))
                synchronize([self.xtables.send, self.xtables.recv_dst])
            else:
                self.xtables = exchange_tables(
                    self.xplan, self.max_k, self._rb_rows, self.device,
                    ring=bool(self.config.rb_p2p),
                )
                synchronize([self.xtables.send, self.xtables.recv_dst])
        self._finish(kind, arrays)

    def _finish(self, kind: str, arrays) -> None:
        """The packed tensors as the module's buffers, and the audit."""
        self._n_packed = len(arrays)
        for i, x in enumerate(arrays):
            self.register_buffer(f"packed_{i}", x, persistent=False)
        self.kernel_kind = kind
        self.rB_recv_rows = self.xplan.rB_recv_rows
        self.rB_recv_size = int(self.xplan.total_recv_rows)

    @property
    def packed(self) -> tuple:
        """The packed local-kernel tensors, leading shard axis included (one
        shard on a mesh)."""
        return tuple(getattr(self, f"packed_{i}") for i in range(self._n_packed))

    @property
    def _group(self):
        return None if self.mesh is None else self.mesh.col_group

    def close(self) -> None:
        """Drop the peers' B mappings of the fused kernel across ranks
        (collective: every rank calls it, before any frees its engine);
        then raise ``HaloTimeout`` where a wait of the kernel gave up."""
        if self.peers is not None:
            peers, self.peers = self.peers, None
            peers.close()

    @property
    def physical_rows(self) -> int:
        """Padded B rows one exec moves: every push of the fused kernel
        (its own shard's included), else ``p·(p−1)·S`` on the ring (the
        overlapped one too) and ``p·p·S`` for the all_to_all."""
        if self.is_halo:
            return self._local_op.halo_rows_pushed
        if self.overlap or self.config.rb_p2p:
            return self.xplan.physical_rows_ring
        return self.xplan.physical_rows

    # ------------------------------------------------------------------ exec
    def shard_b(self, b: np.ndarray) -> torch.Tensor:
        """Global (k, n) host B -> stacked padded shards (p, max_k, n) on
        the engine's device.  Under ``bc_layout`` B arrives as (n, k): its
        column slabs go up as (p, n, max_k) in the user's orientation and
        are transposed on the device (``src/rowpara_spmm.c:225-264``).  On
        a mesh this rank's shard (1, max_k, n).  A new tensor: never the
        fused kernel's mapped buffer, which the exec alone writes."""
        b = np.asarray(b, dtype=self.dtype)
        held = range(self.p) if self.mesh is None else [self.rank]
        if self.config.bc_layout:
            slabs = np.zeros((len(held), b.shape[0], self.max_k), dtype=self.dtype)
            for j, i in enumerate(held):
                s, e = int(self.B_row_displs[i]), int(self.B_row_displs[i + 1])
                slabs[j, :, : e - s] = b[:, s:e]
            return torch.from_numpy(slabs).to(self.device).transpose(1, 2).contiguous()
        if self.mesh is None:
            bs = shard_dense_rows(b, self.B_row_displs, pad_rows=self.max_k)
            return torch.from_numpy(bs).to(self.device)
        s, e = int(self.B_row_displs[self.rank]), int(self.B_row_displs[self.rank + 1])
        bs = np.zeros((1, self.max_k, b.shape[1]), dtype=self.dtype)
        bs[0, : e - s] = b[s:e]
        return torch.from_numpy(bs).to(self.device)

    def unshard_c(self, c_shards: torch.Tensor) -> np.ndarray:
        """Stacked C shards -> global host C (m, n); under ``bc_layout``
        (n, m), the shards transposed on the device and joined by
        columns.  On a mesh every rank's shard is gathered first, and every
        rank returns the global C."""
        if self.mesh is not None:
            c_shards = gather_shards(c_shards, self._group, self.p)
        if self.config.bc_layout:
            ct = c_shards.transpose(1, 2).contiguous().cpu().numpy()  # (p, n, rows)
            d = self.A_row_displs
            c = np.concatenate([ct[i][:, : int(d[i + 1] - d[i])] for i in range(self.p)],
                               axis=1)
            if c.shape[1] < self.glb_m:
                c = np.concatenate(
                    [c, np.zeros((c.shape[0], self.glb_m - c.shape[1]), c.dtype)], axis=1)
            self._check_peers()
            return c
        c = unshard_dense_rows(c_shards.cpu().numpy(), self.A_row_displs)
        if c.shape[0] < self.glb_m:
            # rows past the last nnz-balanced block are empty A rows
            pad = np.zeros((self.glb_m - c.shape[0], c.shape[1]), c.dtype)
            c = np.concatenate([c, pad], axis=0)
        self._check_peers()
        return c

    def _check_peers(self) -> None:
        """At a host sync point: raise ``HaloTimeout`` if a wait of the
        fused kernel across ranks gave up."""
        if self.peers is not None:
            self.peers.check()

    def _exchange(self, b_shards: torch.Tensor) -> torch.Tensor:
        if self.mesh is not None:
            if self.config.rb_p2p:
                return exchange_b_ring_rank(b_shards, self.xtables, self._group,
                                            self.mesh.col_ranks)
            return exchange_b_rank(b_shards, self.xtables, self._group)
        xch = exchange_b_ring if self.config.rb_p2p else exchange_b
        return xch(b_shards, self.xtables)

    def _spmm(self, rB: torch.Tensor) -> torch.Tensor:
        """Each shard's local op on its receive buffer: (p, rows, n)."""
        return run_shards(self._local_op, self.packed, rB)

    def receive_buffer(self, b_shards: torch.Tensor) -> torch.Tensor:
        """The B rows each shard's packed kernel reads, (p, rows, n): the
        shards themselves where the exchange is the identity, the fused
        kernel reads the owners' rows in place or the ring's self part
        reads its own shard, else the exchange's compacted receive
        buffers."""
        if self.is_halo or self._identity_exchange or self.overlap:
            return b_shards
        return self._exchange(b_shards)

    def forward(self, b_shards: torch.Tensor) -> torch.Tensor:
        """Exchange + local SpMM on pre-sharded B; returns (p, rows, n)
        shards (rows past each shard's own are trimmed by ``unshard_c``)."""
        if self.is_halo:
            if self.peers is not None:
                self.peers.load(b_shards)
                return self._local_op(self.packed, self.peers.buf, peers=self.peers,
                                      dtype=torch_dtype(self.dtype))
            return self._local_op(self.packed, b_shards)
        if self.overlap:
            return ring_spmm(b_shards, self.ring, self._ring_send, self._side,
                             self._group, None if self.mesh is None else self.mesh.col_ranks)
        return self._spmm(self.receive_buffer(b_shards))

    def exec_device(self, b_shards: torch.Tensor) -> torch.Tensor:
        return self(b_shards)

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

    def exec_timed(self, b_shards: torch.Tensor) -> torch.Tensor:
        """Exec with per-phase fences (the reference's stat-table phases):
        ``a2a`` (the exchange) and ``spmm`` (the local ops); the fused
        kernel and the overlapped ring are one ``exec`` phase
        (``rowpara.py:565``)."""
        t = self.timer
        if self._identity_exchange or self.is_halo or self.overlap:
            c = self.exec_device(b_shards)
            with t.phase("exec", fence=c):
                pass
            t.n_exec += 1
            return c
        with t.phase("a2a"):
            rB = self._exchange(b_shards)
            synchronize(rB)
        with t.phase("spmm"):
            c = self._spmm(rB)
            synchronize(c)
        t.n_exec += 1
        return c

    # ----------------------------------------------------------------- stats
    def print_stat(self) -> str:
        """Stat table in the spirit of ``rp_spmm_print_stat``
        (``src/rowpara_spmm.c:425-464`` of the reference)."""
        return format_stat_table(
            title="rp_spmm",
            t_init=self.t_init,
            timer=self.timer,
            comm_rows=self.rB_recv_size,
            glb_n=self.glb_n,
            physical_rows=self.physical_rows,
            rank=None if self.mesh is None else f"Rank {self.rank} of {self.p}",
        )

    def clear_stat(self) -> None:
        self.timer.clear()
