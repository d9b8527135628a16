"""Differentiable sparse x dense SpMM (``crp_tpu/engine/autodiff.py``).

GNN training multiplies activations by a static sparse adjacency every
step and needs gradients to flow through that product.  ``C = A @ B`` is
linear in B, so the gradient with respect to B is exact: ``dB = A^T @ dC``.
Both directions run full planned engines (the B-row exchange and the local
kernels), with ``A`` and ``A^T`` planned and packed once at init; the op is
a ``torch.autograd.Function`` whose backward runs the ``A^T`` engine.
Gradients with respect to A's values are not defined here (A is static
data); :mod:`.trainable` adds them for the ``segsum`` kind.

Layout: the op takes and returns the engines' stacked padded shards, the
tensors ``shard_b`` and ``exec_device`` use.  The forward C layout (A's
row blocks) and the backward engine's B layout agree block for block;
rows the backward layout adds are zero-padded, which is exact.  On a mesh
of ranks (``mesh=``, ``autodiff.py:64-125``) both engines run on the same
mesh: the op takes this rank's B shard (1, max_k, n) and returns its C
shard (1, max_m, n), and the backward's exchange runs on the mesh's group;
each rank's shards equal the one-device op's slice bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..comm.exchange import gather_shards
from ..config import SpmmConfig
from ..kernels.dispatch import resolve_auto_kernel
from ..shard.layout import unshard_dense_rows
from .rowpara import RowParaSpmm, _digest, engine_device


def repad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Slice or zero-pad the per-shard row axis of (p, r, n) to ``rows``
    (``autodiff.py:39-44``)."""
    if x.shape[1] == rows:
        return x
    if x.shape[1] > rows:
        return x[:, :rows]
    return F.pad(x, (0, 0, 0, rows - x.shape[1]))


def transposed(a):
    """``a.transpose()``, memoized on the matrix as the engines' pack memo
    is (keyed on its arrays): every op over one matrix shares one ``A^T``,
    and so, through that matrix's own pack memo, one packed ``A^T``."""
    key = _digest(a.rowptr, a.colidx, a.val)
    memo = a.__dict__.get("_torch_transpose")
    if memo is None or memo[0] != key:
        memo = (key, a.transpose())
        a.__dict__["_torch_transpose"] = memo
    return memo[1]


def check_stateless(config: SpmmConfig, who: str) -> None:
    """The JAX refusals of kinds whose data is not the plain (p, rows, n)
    shard form gradients flow through (``autodiff.py:92-99``)."""
    if config.kernel in ("dd", "dd_mxu", "pallas_halo"):
        raise ValueError(
            f"{who} supports the plain-B kernel paths "
            "(segsum/ell/pallas/ragged/gather); "
            f"kernel={config.kernel!r} repacks B or carries state"
        )
    if config.bc_layout:
        raise ValueError(f"{who} takes row-major (k, n) B")


def unshard_db(fwd: RowParaSpmm, db_shards: torch.Tensor) -> np.ndarray:
    """(p, rows, n) dB shards -> the global (k, n) host gradient; on a mesh
    every rank's shard is gathered first, as ``unshard_c`` gathers C."""
    db_shards = db_shards.detach()
    if fwd.mesh is not None:
        db_shards = gather_shards(db_shards, fwd._group, fwd.p)
    db = unshard_dense_rows(db_shards.cpu().numpy(), fwd.B_row_displs)
    return db[: int(fwd.B_row_displs[-1])]


class _EngineSpmm(torch.autograd.Function):
    """``C = fwd(B)``; backward ``dB = bwd(dC)`` on the ``A^T`` engine
    (``autodiff.py:100-113``)."""

    @staticmethod
    def forward(ctx, b_shards, op):
        ctx.op = op
        return op.fwd.exec_device(b_shards)

    @staticmethod
    def backward(ctx, dc):
        op = ctx.op
        db = op.bwd.exec_device(repad_rows(dc, op.bwd.max_k).contiguous())
        return repad_rows(db, op.fwd.max_k), None


class DifferentiableSpmm(torch.nn.Module):
    """``op(B_shards) -> C_shards`` with ``dB = A^T @ dC``.

    Parameters mirror :class:`RowParaSpmm`.  ``fwd`` is the engine over A;
    ``bwd`` the engine over ``A^T``, whose row blocks are ``fwd``'s B
    ownership (so dB lands in B's layout) and whose B ownership is
    ``fwd``'s row blocks (so it reads dC's layout as it is).
    ``kernel="auto"`` resolves here without the fused halo kind: ``pallas``
    on the card, ``segsum`` on the CPU.  ``dd``, ``dd_mxu``, ``pallas_halo``
    and ``bc_layout`` are refused, as in JAX, on a mesh as without one.
    ``mesh``: a 1D mesh of p ranks, on which both engines run (``device``
    then defaults to the mesh's).
    """

    def __init__(self, a, A_row_displs, B_row_displs, glb_n: int, *,
                 device=None, config: SpmmConfig | None = None,
                 dtype=np.float32, mesh=None) -> None:
        super().__init__()
        device = engine_device(
            device if device is not None else mesh.device if mesh is not None else "cuda")
        config = config or SpmmConfig(kernel="segsum", dtype="float32")
        if config.kernel == "auto":
            config = dataclasses.replace(config, kernel=resolve_auto_kernel(
                device, len(A_row_displs) - 1, allow_halo=False))
        check_stateless(config, "DifferentiableSpmm")
        # A^T on the same mesh: its row blocks are fwd's B ownership and its
        # B ownership fwd's row blocks (autodiff.py:100-107)
        self.fwd = RowParaSpmm(a, A_row_displs, B_row_displs, glb_n,
                               device=device, config=config, dtype=dtype, mesh=mesh)
        self.bwd = RowParaSpmm(transposed(a), self.fwd.B_row_displs,
                               self.fwd.A_row_displs, glb_n, device=device,
                               config=config, dtype=dtype, mesh=mesh)

    def forward(self, b_shards: torch.Tensor) -> torch.Tensor:
        return _EngineSpmm.apply(b_shards, self)

    op = forward  # the JAX package's name

    # ---------------------------------------------------------------- host
    def shard_b(self, b: np.ndarray) -> torch.Tensor:
        return self.fwd.shard_b(b)

    def unshard_c(self, c_shards: torch.Tensor) -> np.ndarray:
        return self.fwd.unshard_c(c_shards.detach())

    def unshard_db(self, db_shards: torch.Tensor) -> np.ndarray:
        return unshard_db(self.fwd, db_shards)
