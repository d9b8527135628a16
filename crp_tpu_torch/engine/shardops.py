"""Dense ops on row-sharded activations: the layers between a GNN's SpMMs.

A GCN's or GAT's dense work is row-local: ``X @ W``, the activations, the
per-row softmax and the row-wise cross entropy.  It runs here on the
engines' row blocks as they stand, without gathering a whole (nodes, w)
activation: on a (p, rows, w) stack of every shard on one device (``mesh``
None) or on this rank's (1, rows, w) shard on a
:class:`~crp_tpu_torch.shard.layout.RankMesh`.  What crosses ranks is then
the engines' own B-row exchanges, a few KB of weight-gradient partials and
the loss and accuracy partials.

The stacked run and the ranks compute alike, so that the losses and the
replicated weights of p ranks repeat the one-device run bit for bit:

  * each shard's block is computed alone, at one 2D (rows, w) shape (a
    batched product, or an elementwise kernel's vector tail, could round a
    shard otherwise on one device than on a rank);
  * a sum over shards (a weight's gradient, the loss, the accuracy) adds the
    shards' partials one after another in shard order,
    ``((P_0 + P_1) + P_2) + P_3``; on a mesh each rank all-gathers the
    partials on the mesh's group first (``gather_shards``).  Never
    ``dist.all_reduce``: its order is the backend's.

Every rank ends a backward pass with the same gradient on every weight, so
an optimizer keeps the replicated weights equal without a broadcast.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..comm.exchange import gather_shards


def gather_parts(x: torch.Tensor, mesh) -> torch.Tensor:
    """The held shards' partials ``x`` (held, ...) -> every shard's (p, ...)
    in shard order, on ``x``'s device; on one device ``x`` itself."""
    if mesh is None:
        return x
    return gather_shards(x, mesh.col_group, mesh.pm).to(x.device)


def ordered_sum(parts: torch.Tensor) -> torch.Tensor:
    """``((parts[0] + parts[1]) + parts[2]) + ...``: one addition after
    another, the same on every device and for every backend."""
    total = parts[0]
    for x in parts[1:]:
        total = total + x
    return total


def per_shard(fn, xs: torch.Tensor) -> torch.Tensor:
    """``fn`` on each shard's block alone, stacked: (held, ...)."""
    return torch.stack([fn(x) for x in xs])


class _ShardMatmul(torch.autograd.Function):
    """``xs[i] @ w`` a shard; ``dX[i] = g[i] @ w^T``, ``dW`` the ordered sum
    of ``xs[i]^T @ g[i]`` over every shard."""

    @staticmethod
    def forward(ctx, xs, w, mesh):
        ctx.mesh = mesh
        ctx.save_for_backward(xs, w)
        return torch.stack([x @ w for x in xs])

    @staticmethod
    def backward(ctx, g):
        xs, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.stack([gi @ w.T if w.dim() == 2 else torch.outer(gi, w) for gi in g])
        if ctx.needs_input_grad[1]:
            parts = torch.stack([x.T @ gi for x, gi in zip(xs, g)])
            dw = ordered_sum(gather_parts(parts, ctx.mesh))
        return dx, dw, None


def shard_matmul(xs: torch.Tensor, w: torch.Tensor, mesh=None) -> torch.Tensor:
    """(held, rows, w_in) @ ``w`` (w_in, w_out) or (w_in,) -> (held, rows,
    w_out) or (held, rows), one 2D product a shard; ``w``'s gradient summed
    over every shard in shard order (on a mesh, over the ranks)."""
    return _ShardMatmul.apply(xs, w, mesh)


class _OrderedSum(torch.autograd.Function):
    """Every shard's partial ``parts`` (held,) summed in shard order; each
    held partial's gradient is the sum's (the sum is the same on every
    rank, and each rank's partial enters it once)."""

    @staticmethod
    def forward(ctx, parts, mesh):
        ctx.held = parts.shape[0]
        return ordered_sum(gather_parts(parts, mesh))

    @staticmethod
    def backward(ctx, g):
        return g.expand(ctx.held), None


def own_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """A shard's block cut, or zero-padded, to the ``rows`` it owns (the
    padding: the empty A rows past the last block, zero in every C)."""
    if x.shape[0] >= rows:
        return x[:rows]
    return F.pad(x, (0, 0, 0, rows - x.shape[0]))


class ShardRows:
    """The row blocks ``displs`` of a ``nodes``-row graph as the engines
    hold them: every shard on one device (``mesh`` None), or shard
    ``mesh.pi`` on this rank.  Shard i owns rows ``[displs[i],
    displs[i+1])``; the last also owns the rows past ``displs[-1]``, the
    empty A rows the nnz-balanced partition leaves out (zero rows in every
    C, so their logits are zero)."""

    def __init__(self, displs, nodes: int, mesh=None) -> None:
        self.displs = np.asarray(displs, dtype=np.int64)
        self.nodes = int(nodes)
        self.mesh = mesh
        p = len(self.displs) - 1
        self.held = list(range(p)) if mesh is None else [mesh.pi]
        ends = [int(x) for x in self.displs[1:]]
        ends[-1] = self.nodes
        self.bounds = [(int(self.displs[i]), ends[i]) for i in self.held]

    def take(self, x: np.ndarray, device) -> list:
        """A per-row host array -> the held shards' rows, one tensor each."""
        return [torch.from_numpy(np.ascontiguousarray(x[s:e])).to(device)
                for s, e in self.bounds]

    def loss(self, logits: torch.Tensor, ys: list) -> torch.Tensor:
        """Mean cross entropy of (held, rows, classes) logits against the
        held shards' labels ``ys``: each shard's sum over the rows it owns,
        the shards' sums added in shard order, over ``nodes``."""
        parts = torch.stack([F.cross_entropy(own_rows(lg, y.shape[0]), y, reduction="sum")
                             for lg, y in zip(logits, ys)])
        return _OrderedSum.apply(parts, self.mesh) / self.nodes

    def accuracy(self, logits: torch.Tensor, ys: list) -> float:
        """The share of every shard's rows whose logits' argmax is its
        label (the same on every rank)."""
        hits = torch.stack([(own_rows(lg, y.shape[0]).argmax(-1) == y).sum()
                            for lg, y in zip(logits, ys)])
        return float(ordered_sum(gather_parts(hits, self.mesh))) / self.nodes
