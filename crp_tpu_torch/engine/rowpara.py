"""1D row-parallel SpMM engine, one device (p = 1).

Counterpart of ``crp_tpu/engine/rowpara.py`` (the reference's ``rp_spmm``,
``src/rowpara_spmm.{h,c}``): init plans and packs A once; each exec moves
the B rows A references into the kernel's receive buffer and runs the local
SpMM kernel.  At p = 1 with every B row referenced that exchange is the
identity and is elided: the kernel reads the owned block of B directly.

The ``dd`` and ``dd_mxu`` kinds compute in fp64 whatever ``dtype`` says:
A's values, B and C are fp64 (the JAX package carries B and C as hi/lo
fp32 pairs, 48 bits; the port carries 53).  As in JAX, they refuse
``bc_layout`` and ``overlap`` (``ValueError``).

Not ported yet, each raising ``NotImplementedError`` that names its ROADMAP
item: p > 1 and ``overlap`` (Queue A #8), ``kernel="pallas_halo"``
(Queue A #10) and ``bc_layout`` (Queue A #3).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from crp_tpu.config import SpmmConfig

from ..comm.exchange import build_b_exchange, exchange_b_local, self_copy_tables
from ..kernels.dispatch import pack_with_fallback, resolve_auto_kernel
from ..shard.layout import shard_dense_rows, unshard_dense_rows
from ..utils.timers import Timer, synchronize
from .stats import format_stat_table


def _unsupported(config: SpmmConfig, p: int) -> str | None:
    if p != 1:
        return (f"RowParaSpmm with p = {p}: the multi-GPU exchange is ROADMAP "
                "Queue A #8")
    if config.overlap:
        return "overlap=1 (comm/ring.py) is ROADMAP Queue A #8"
    if config.kernel == "pallas_halo":
        return "kernel='pallas_halo' (fused halo push) is ROADMAP Queue A #10"
    if config.bc_layout:
        return "bc_layout=1 (the reference's col-major B/C) is ROADMAP Queue A #3"
    return None


def _digest(*arrs) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    for x in arrs:
        h.update(np.ascontiguousarray(x))
    return h.digest()


class RowParaSpmm(torch.nn.Module):
    """init(plan)/exec(B)->C engine for 1D row-parallel SpMM.

    ``a`` is the global ``crp_tpu.sparse.CSRMatrix``; ``A_row_displs`` and
    ``B_row_displs`` the (p+1,) row blocks of A/C and the ownership
    partition of B; ``device`` where the packed A lives and the kernel
    runs.  The packed tensors are the module's buffers.
    """

    def __init__(self, a, A_row_displs, B_row_displs, glb_n: int, *, device,
                 config: SpmmConfig | None = None, dtype=None) -> None:
        super().__init__()
        self.config = config or SpmmConfig()
        self.A_row_displs = np.asarray(A_row_displs, dtype=np.int64)
        self.B_row_displs = np.asarray(B_row_displs, dtype=np.int64)
        self.p = len(self.A_row_displs) - 1
        # "auto" never resolves to a dd kind here (resolve_auto_kernel)
        self.is_dd = self.config.kernel in ("dd", "dd_mxu")
        if self.is_dd:
            # the JAX refusals (rowpara.py:125-135), before the pack
            if self.config.bc_layout:
                raise ValueError(
                    "BC_layout=1 supports the standard kernel paths; the dd "
                    "kinds keep B and C row-major in fp64"
                )
            if self.config.overlap:
                raise ValueError(
                    "kernel='dd' is incompatible with overlap=1: the per-shift "
                    "partial SpMM is plain fp32 and would lose the dd accuracy"
                )
        why = _unsupported(self.config, self.p)
        if why is not None:
            raise NotImplementedError(f"not yet ported to crp_tpu_torch: {why}")
        self.glb_n = glb_n
        self.device = torch.device(device)
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
            kind = resolve_auto_kernel(self.device)
        self.max_k = int(max(np.diff(self.B_row_displs).max(), 1))

        # single-slot pack memo on the matrix (rowpara.py:205-289): a new
        # key drops the old pack's device tensors
        cache_key = (
            "rowpara_pack", kind, self.config.mxu_precision, str(self.dtype),
            reidx, str(self.device),
            self.A_row_displs.tobytes(), self.B_row_displs.tobytes(),
            a.nnz, _digest(a.rowptr, a.colidx, a.val),
        )
        cache = a.__dict__.setdefault("_torch_pack_cache", {})
        if cache_key in cache:
            kind, self._local_op, arrays = cache[cache_key]
        else:
            cache.clear()
            shards_compact = []
            for i, s in enumerate(shards):
                if reidx:
                    cc = np.searchsorted(self.xplan.rowmap[i], s.colidx)
                else:
                    cc = s.colidx - int(self.xplan.rowmap[i])
                shards_compact.append((s.rowptr, cc.astype(np.int32), s.val))
            with tb.phase("pack"):
                arrays, self._local_op, kind = pack_with_fallback(
                    shards_compact, self.max_m, self.dtype, kind,
                    device=self.device,
                    mxu_precision=self.config.mxu_precision,
                    is_dd=self.is_dd,
                )
                synchronize(arrays)
            cache[cache_key] = (kind, self._local_op, arrays)
        # the windowed kernels read whole windows: rB carries min_b_rows
        self._rb_rows = max(
            self.xplan.rB_nrow_max, self._local_op.min_b_rows, 1
        )
        self._n_packed = len(arrays)
        for i, x in enumerate(arrays):
            self.register_buffer(f"packed_{i}", x, persistent=False)

        with tb.phase("upload"):
            self._identity_exchange = (
                bool(self.config.rb_reidx)
                and len(self.xplan.rowmap[0]) == int(self.B_row_displs[-1])
            )
            if self._identity_exchange:
                # the kernel reads the owned block directly; pad it to the
                # receive-buffer size the kernel was packed for
                self.max_k = max(self.max_k, self._rb_rows)
            else:
                src, dst = self_copy_tables(self.xplan, self.device)
                self.register_buffer("self_src", src, persistent=False)
                self.register_buffer("self_dst", dst, persistent=False)
                synchronize((src, dst))

        self.kernel_kind = kind
        self.rB_recv_rows = self.xplan.rB_recv_rows
        self.rB_recv_size = int(self.xplan.total_recv_rows)

    @property
    def packed(self) -> tuple:
        """The packed local-kernel tensors, leading shard axis included."""
        return tuple(getattr(self, f"packed_{i}") for i in range(self._n_packed))

    # ------------------------------------------------------------------ exec
    def shard_b(self, b: np.ndarray) -> torch.Tensor:
        """Global (k, n) host B -> stacked padded shards (p, max_k, n) on
        the engine's device."""
        b = np.asarray(b, dtype=self.dtype)
        bs = shard_dense_rows(b, self.B_row_displs, pad_rows=self.max_k)
        return torch.from_numpy(bs).to(self.device)

    def unshard_c(self, c_shards: torch.Tensor) -> np.ndarray:
        c = unshard_dense_rows(c_shards.cpu().numpy(), self.A_row_displs)
        if c.shape[0] < self.glb_m:
            # rows past the last nnz-balanced block are empty A rows
            pad = np.zeros((self.glb_m - c.shape[0], c.shape[1]), c.dtype)
            c = np.concatenate([c, pad], axis=0)
        return c

    def _exchange(self, b_shards: torch.Tensor) -> torch.Tensor:
        return exchange_b_local(
            b_shards[0], self.self_src, self.self_dst, self._rb_rows
        )

    def _spmm(self, rB: torch.Tensor) -> torch.Tensor:
        return self._local_op(tuple(x[0] for x in self.packed), rB)[None]

    def forward(self, b_shards: torch.Tensor) -> torch.Tensor:
        """Exchange + local SpMM on pre-sharded B; returns (p, rows, n)
        shards (rows past each shard's own are trimmed by ``unshard_c``)."""
        if self._identity_exchange:
            return self._spmm(b_shards[0])
        return self._spmm(self._exchange(b_shards))

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
        """Exec with per-phase fences (the reference's stat-table phases)."""
        t = self.timer
        if self._identity_exchange:
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
        physical = (
            self.xplan.physical_rows_ring if self.config.rb_p2p
            else self.xplan.physical_rows
        )
        return format_stat_table(
            title="rp_spmm",
            t_init=self.t_init,
            timer=self.timer,
            comm_rows=self.rB_recv_size,
            glb_n=self.glb_n,
            physical_rows=physical,
        )

    def clear_stat(self) -> None:
        self.timer.clear()
