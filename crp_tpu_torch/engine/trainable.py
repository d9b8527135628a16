"""SpMM with trainable A values (``crp_tpu/engine/trainable.py``).

GNN workloads that train edge weights (GAT-style attention, learnable
adjacency rescaling) need the forward ``C = A(v) @ B`` to take the nonzero
values ``v`` as an input, and the gradient ``dL/dv``: a sampled dense-dense
product (SDDMM), ``dv[q] = dot(dC[row_q, :], B[col_q, :])`` at A's
pattern.  ``C`` is linear in both ``B`` and ``v``, so both gradients are
exact:

  * ``dB = A(v)^T @ dC``: the engine over ``A^T`` (as in
    :mod:`.autodiff`), its packed value slots rebound on every call
    through the nonzero permutation of ``CSRMatrix.transpose``'s stable
    sort (A^T's t-th nonzero is A's ``argsort(colidx)[t]``);
  * ``dv``: an SDDMM over the same exchanged B the forward read: the
    engine's exchange lands every referenced B row on its shard, and the
    packed ``segsum`` slot arrays (rows, cols) are the SDDMM's gather
    maps.  Each slot's dot product is computed alone, in chunks of
    ``CHUNK`` slots, so peak memory is bounded and nothing is summed by
    atomics.

Only the ``segsum`` kind is supported: its pack keeps one value slot per
nonzero (``pack_device_csr``), so a change of values is a swap of one
tensor.  Slot q of shard i is global nonzero ``a.rowptr[displs[i]] + q``
(row blocks are contiguous in the CSR order), so value gradients are
assembled by per-shard slices, not scattered.

On a mesh of ranks (``mesh=``, ``trainable.py:99-160``) both engines run on
the same mesh, and rank r holds A's nonzeros ``[rowptr[d_r],
rowptr[d_r+1])``, its shard's value slots: the op takes that range of the
values, and it, ``sddmm`` and the value gradients return that range (one
device: the whole (nnz,) vector, the p ranges one after another).  The
transposed exec reads values of every row block: the ranges are
all-gathered on the mesh's group for it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..comm.exchange import gather_shards
from ..config import SpmmConfig
from ..kernels.spmm_segsum import SEGSUM_BLOCK_BYTES
from .autodiff import check_stateless, repad_rows, transposed, unshard_db
from .rowpara import RowParaSpmm, engine_device, run_shards


def _exec_with_vals(eng: RowParaSpmm, vals_shards, b_shards):
    """The engine's exec with its packed value slots replaced
    (``trainable.py:53-63``)."""
    rows, cols, packed_vals = eng.packed
    return run_shards(eng._local_op, (rows, cols, vals_shards.to(packed_vals.dtype)),
                      eng.receive_buffer(b_shards))


class _ValueSpmm(torch.autograd.Function):
    """``C = A(v) @ B``; backward dB on the ``A^T`` engine, dv by SDDMM
    (``trainable.py:196-208``)."""

    @staticmethod
    def forward(ctx, b_shards, vals, vps):
        ctx.vps = vps
        ctx.save_for_backward(b_shards, vals)
        return _exec_with_vals(vps.fwd, vps._fwd_slots(vals), b_shards)

    @staticmethod
    def backward(ctx, dc):
        vps = ctx.vps
        b_shards, vals = ctx.saved_tensors
        dc = dc.contiguous()
        db = dvals = None
        if ctx.needs_input_grad[0]:
            db = repad_rows(vps._transpose_exec(vals, dc), vps.fwd.max_k)
        if ctx.needs_input_grad[1]:
            dvals = vps._sddmm_shards(dc, vps.fwd.receive_buffer(b_shards))
            dvals = dvals.to(vals.dtype)
        return db, dvals, None


class _Sddmm(torch.autograd.Function):
    """``out[q] = dot(X[row_q], Y[col_q])``; its gradients are SpMMs with
    the values ``dout``: ``dX = A(dout) @ Y`` and ``dY = A(dout)^T @ X``."""

    @staticmethod
    def forward(ctx, x_shards, y_shards, vps):
        ctx.vps = vps
        ctx.save_for_backward(x_shards, y_shards)
        return vps._sddmm_shards(x_shards, vps.fwd.receive_buffer(y_shards))

    @staticmethod
    def backward(ctx, g):
        vps = ctx.vps
        x, y = ctx.saved_tensors
        dx = dy = None
        if ctx.needs_input_grad[0]:
            dx = _exec_with_vals(vps.fwd, vps._fwd_slots(g), y)
            dx = repad_rows(dx, x.shape[1]).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dy = repad_rows(vps._transpose_exec(g, x), y.shape[1]).to(y.dtype)
        return dx, dy, None


class ValueParameterizedSpmm(torch.nn.Module):
    """``op(B_shards, vals) -> C_shards`` with gradients to B and to vals.

    Parameters mirror :class:`RowParaSpmm`.  ``vals`` is the (nnz,) value
    vector in A's CSR order, on a mesh this rank's range of it
    (:attr:`val_range`); A's pattern stays static (plans, exchange and pack
    are pattern-only).  ``auto`` resolves to ``segsum``; any other kind,
    ``overlap`` and ``bc_layout`` are refused, as in JAX, on a mesh as
    without one.  :meth:`sddmm` is the GAT attention primitive.
    """

    CHUNK = 2048  # SDDMM slots per chunk (trainable.py:95)

    def __init__(self, a, A_row_displs, B_row_displs, glb_n: int, *,
                 device=None, config: SpmmConfig | None = None,
                 dtype=np.float32, mesh=None) -> None:
        super().__init__()
        device = engine_device(
            device if device is not None else mesh.device if mesh is not None else "cuda")
        config = config or SpmmConfig(kernel="segsum", dtype="float32")
        if config.kernel == "auto":
            config = dataclasses.replace(config, kernel="segsum")
        if config.kernel != "segsum":
            raise ValueError(
                "ValueParameterizedSpmm requires kernel='segsum' (the one "
                f"value-slot-per-nonzero packed form); got {config.kernel!r}")
        if config.overlap:
            raise ValueError(
                "overlap=1 splits values into per-ring-step partitions; "
                "use the plain exchange for value-parameterized exec")
        check_stateless(config, "ValueParameterizedSpmm")
        self.fwd = RowParaSpmm(a, A_row_displs, B_row_displs, glb_n,
                               device=device, config=config, dtype=dtype, mesh=mesh)
        self.bwd = RowParaSpmm(transposed(a), self.fwd.B_row_displs,
                               self.fwd.A_row_displs, glb_n, device=device,
                               config=config, dtype=dtype, mesh=mesh)
        assert self.fwd.kernel_kind == self.bwd.kernel_kind == "segsum"

        self.nnz = int(a.nnz)
        fd = self.fwd.A_row_displs
        held = range(self.fwd.p) if mesh is None else [self.fwd.rank]
        # slot q of fwd shard i <-> global nonzero ranges[i][0] + q
        self._ranges = [(int(a.rowptr[int(fd[i])]), int(a.rowptr[int(fd[i + 1])]))
                        for i in range(self.fwd.p)]
        self._fwd_rng = [self._ranges[i] for i in held]
        # the values this op takes and returns: A's nonzeros [s, e)
        self.val_range = (0, self.nnz) if mesh is None else self._fwd_rng[0]
        # gather maps from the (nnz + 1,) values, the last a zero for the
        # pad slots, one row a held shard: the fwd slots, and the bwd slots
        # through the transpose's stable sort (bwd slot q of shard i <-> A^T
        # nonzero at.rowptr[td[i]] + q <-> A nonzero order[t])
        fwd_idx = np.full((len(held), self.fwd.packed[0].shape[1]), self.nnz, np.int64)
        for j, (s, e) in enumerate(self._fwd_rng):
            fwd_idx[j, : e - s] = np.arange(s, e)
        colidx = np.asarray(a.colidx)
        order = np.argsort(colidx, kind="stable")
        at_rowptr = np.zeros(a.ncol + 1, dtype=np.int64)
        np.cumsum(np.bincount(colidx, minlength=a.ncol), out=at_rowptr[1:])
        td = self.bwd.A_row_displs
        bwd_idx = np.full((len(held), self.bwd.packed[0].shape[1]), self.nnz, np.int64)
        for j, i in enumerate(held):
            lo = int(at_rowptr[min(int(td[i]), a.ncol)])
            hi = int(at_rowptr[min(int(td[i + 1]), a.ncol)])
            bwd_idx[j, : hi - lo] = order[lo:hi]
        # the fwd map into the held range of values, its pad slots at the zero
        s, e = self.val_range
        fwd_take = np.where(fwd_idx == self.nnz, e - s, fwd_idx - s)
        for name, x in (("fwd_idx", fwd_idx), ("bwd_idx", bwd_idx), ("fwd_take", fwd_take)):
            self.register_buffer(name, torch.from_numpy(x).to(device), persistent=False)

    def forward(self, b_shards: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        return _ValueSpmm.apply(b_shards, vals, self)

    op = forward  # the JAX package's name

    # ----------------------------------------------------------- internals
    def _slots(self, vals, idx):
        dt = self.fwd.packed[2].dtype
        return torch.cat([vals.to(dt), vals.new_zeros(1, dtype=dt)])[idx]

    def _fwd_slots(self, vals):
        """The held range of values -> the fwd engine's (held, nnz_pad) slots."""
        return self._slots(vals, self.fwd_take)

    def _all_values(self, vals):
        """The held range of values -> the global (nnz,) vector: on a mesh
        every rank's range, all-gathered (padded to the longest) on the
        mesh's group."""
        if self.fwd.mesh is None:
            return vals
        width = max(e - s for s, e in self._ranges)
        parts = gather_shards(F.pad(vals, (0, width - vals.shape[0]))[None],
                              self.fwd._group, self.fwd.p).to(vals.device)
        return torch.cat([parts[i, : e - s] for i, (s, e) in enumerate(self._ranges)])

    def _transpose_exec(self, vals, x_shards):
        """``A(vals)^T @ X`` on the bwd engine, X in the fwd C layout."""
        return _exec_with_vals(self.bwd, self._slots(self._all_values(vals), self.bwd_idx),
                               repad_rows(x_shards, self.bwd.max_k).contiguous())

    def _sddmm_shards(self, x, rb):
        """Per-slot ``dot(x[row], rb[col])`` -> the held range, in A's order
        (``trainable.py:212-236``), in fp32 (fp64 for fp64 inputs): whole
        chunks of ``CHUNK`` slots from each shard's first slot, as many a
        step as fit ``SEGSUM_BLOCK_BYTES`` of gathered rows (the same steps
        on a rank as on one device)."""
        rows, cols = self.fwd.packed[0], self.fwd.packed[1]
        dt = torch.promote_types(torch.promote_types(x.dtype, rb.dtype), torch.float32)
        width = max(1, x.shape[-1])
        step = self.CHUNK * max(1, SEGSUM_BLOCK_BYTES // (2 * 8 * width * self.CHUNK))
        out = [x.new_zeros(0, dtype=dt)]
        for i, (s, e) in enumerate(self._fwd_rng):
            for q in range(0, e - s, step):
                r = rows[i, q : min(q + step, e - s)].long()
                c = cols[i, q : min(q + step, e - s)].long()
                out.append((x[i].index_select(0, r).to(dt)
                            * rb[i].index_select(0, c).to(dt)).sum(-1))
        return torch.cat(out)

    # ----------------------------------------------------------------- host
    def shard_b(self, b: np.ndarray) -> torch.Tensor:
        return self.fwd.shard_b(b)

    def unshard_c(self, c_shards: torch.Tensor) -> np.ndarray:
        return self.fwd.unshard_c(c_shards.detach())

    def unshard_db(self, db_shards: torch.Tensor) -> np.ndarray:
        return unshard_db(self.fwd, db_shards)

    # ------------------------------------------------------------- GAT/SDDMM
    def sddmm(self, x_shards: torch.Tensor, y_shards: torch.Tensor) -> torch.Tensor:
        """Sampled ``X @ Y^T`` at A's pattern: ``out[q] = dot(X[row_q, :],
        Y[col_q, :])`` for each nonzero q of the held range, in A's CSR
        order (``trainable.py:250-262``; one device: all nnz).  ``x_shards``
        is row-sharded like C (``max_m`` rows a shard), ``y_shards`` like B;
        Y's rows cross shards through the engine's planned exchange.
        Differentiable in both, through the engines."""
        return _Sddmm.apply(x_shards, y_shards, self)
