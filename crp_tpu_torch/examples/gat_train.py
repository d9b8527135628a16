"""Train a 2-layer graph attention network (GAT) with trainable edge weights.

Counterpart of ``examples/gat_train.py`` of the JAX package, on the whole
trainable surface of :class:`ValueParameterizedSpmm`:

  * attention scores per edge by the SDDMM primitive (``vps.sddmm``:
    sampled ``X @ Y^T`` at A's pattern, through the engine's planned B-row
    exchange);
  * a per-destination-row softmax over the (nnz,) scores, its sums in a
    fixed order (``torch.segment_reduce`` over the CSR rows), so a run's
    losses repeat bit for bit;
  * the propagation ``C = A(alpha) @ (H W)`` through ``vps.op``, whose
    backward gives exact gradients to the dense input and to the edge
    values, so gradients reach W and the attention vectors.

Every activation stays row-sharded in the engines' row blocks, and each
row block's edge scores are its contiguous range of A's nonzeros, so the
softmax runs shard by shard too (:mod:`~crp_tpu_torch.engine.shardops`):
one code path trains p shards on one device or one shard on each of p
ranks (``--distributed``), bit for bit alike.

On the card (the default), or on the CPU with ``--device cpu``:

  python -m crp_tpu_torch.examples.gat_train --nodes=2000 --steps=40 --p=4

On p ranks, one GPU each (NCCL), or on gloo ranks on the CPU:

  torchrun --nproc-per-node=4 -m crp_tpu_torch.examples.gat_train --distributed
  torchrun --nproc-per-node=4 -m crp_tpu_torch.examples.gat_train --device cpu --distributed

It exits 0 when the final accuracy is over 0.7.
"""

from __future__ import annotations

import argparse
import functools
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.autodiff import repad_rows
from ..engine.shardops import ShardRows, per_shard, shard_matmul
from ..engine.trainable import ValueParameterizedSpmm
from ..kernels.spmm_segsum import segment_sum
from ..plan.partition1d import csr_row_partition
from ..sparse.csr import CSRMatrix
from .common import (
    TrainResult, accuracy, community_graph, community_task, fit, init_normal, join_mesh,
    self_loop_coo,
)

LR = 2e-2
PARAMS = ("w1", "a1s", "a1d", "w2", "a2s", "a2d")


def pattern_with_self_loops(a) -> CSRMatrix:
    """``A + I`` as a pattern-only CSRMatrix (values 1.0): GAT attends over
    each vertex's neighbourhood and itself (``examples/gat_train.py:43-55``)."""
    rows, cols = self_loop_coo(a)
    return CSRMatrix.from_coo(a.nrow, a.ncol, rows, cols, np.ones(rows.shape[0]))


class _SegmentSoftmax(torch.autograd.Function):
    """Softmax of ``e`` within each CSR row (``offsets``; ``rows`` each
    nonzero's row).  The row maxima only stabilise it and take no
    gradient; both directions sum in a fixed order."""

    @staticmethod
    def forward(ctx, e, rows, offsets):
        emax = e.new_full((offsets.shape[0] - 1,), -torch.inf).scatter_reduce(
            0, rows, e, "amax")
        ex = torch.exp(e - emax[rows])
        alpha = ex / segment_sum(ex, offsets).clamp_min(1e-12)[rows]
        ctx.save_for_backward(alpha, rows, offsets)
        return alpha

    @staticmethod
    def backward(ctx, g):
        alpha, rows, offsets = ctx.saved_tensors
        ga = g * alpha
        return ga - alpha * segment_sum(ga, offsets)[rows], None, None


def gat_ops(ah, p: int, classes: int, hidden: int, *, device=None, mesh=None) -> tuple:
    """One op per propagation width (``hidden``, then ``classes``) over
    ``p`` nnz-balanced row blocks; on ``mesh`` (p ranks) if given."""
    displs = csr_row_partition(ah.rowptr, p)
    return tuple(ValueParameterizedSpmm(ah, displs, displs, width, device=device,
                                        mesh=mesh)
                 for width in (hidden, classes))


class GAT(torch.nn.Module):
    """Two single-head attention layers, ELU between them
    (``examples/gat_train.py:107-147``), every activation in the ops' row
    blocks: it takes the held B shards of X (``vps_h.shard_b``) and returns
    the held shards' logits."""

    def __init__(self, vps_h, vps_o, rowptr, classes: int, hidden: int) -> None:
        super().__init__()
        self.vps_h, self.vps_o = vps_h, vps_o
        self.nodes = len(rowptr) - 1
        self.mesh = vps_h.fwd.mesh
        self.rows = ShardRows(vps_h.fwd.A_row_displs, self.nodes, self.mesh)
        dev = vps_h.fwd.device
        rowptr = np.asarray(rowptr, np.int64)
        d = self.rows.displs
        # each held shard's edges: their count, each edge's row and the
        # rows' CSR offsets, rebased to the shard's first row and first edge
        self.segments = []
        for i in self.rows.held:
            offsets = rowptr[d[i] : d[i + 1] + 1] - rowptr[d[i]]
            rows = np.repeat(np.arange(int(d[i + 1] - d[i])), np.diff(offsets))
            self.segments.append((int(offsets[-1]), torch.from_numpy(rows).to(dev),
                                  torch.from_numpy(offsets).to(dev)))
        shapes = ((classes, hidden), (hidden,), (hidden,), (hidden, classes),
                  (classes,), (classes,))
        for name, shape in zip(PARAMS, shapes):
            setattr(self, name, torch.nn.Parameter(torch.empty(shape, device=dev)))
        self.reset_parameters()

    @property
    def engines(self) -> tuple:
        return self.vps_h, self.vps_o

    def reset_parameters(self, seed: int = 0) -> None:
        init_normal([getattr(self, name) for name in PARAMS], seed)

    def softmax(self, e: torch.Tensor) -> torch.Tensor:
        """``softmax_j(LeakyReLU(e))`` within each row, shard by shard over
        the held shards' ranges of edges."""
        parts = torch.split(e, [n for n, _, _ in self.segments])
        return torch.cat([_SegmentSoftmax.apply(F.leaky_relu(x, 0.2), rows, off)
                          for x, (_, rows, off) in zip(parts, self.segments)])

    def layer(self, vps, hs, w, a_src, a_dst):
        """One head: ``softmax_j(LeakyReLU(s_i + d_j)) A(alpha) H W`` on the
        held B shards of H; returns the held C shards."""
        hw = shard_matmul(hs, w, self.mesh)
        s, d = shard_matmul(hw, a_src, self.mesh), shard_matmul(hw, a_dst, self.mesh)
        # e_q = s[row_q] + d[col_q] as a rank-2 SDDMM: dot([s, 1], [1, d])
        ones = torch.ones_like(s)
        e = vps.sddmm(repad_rows(torch.stack([s, ones], -1), vps.fwd.max_m),
                      torch.stack([ones, d], -1))
        return vps(hw, self.softmax(e))

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        h = per_shard(F.elu, self.layer(self.vps_h, xs, self.w1, self.a1s, self.a1d))
        return self.layer(self.vps_o, repad_rows(h, self.vps_o.fwd.max_k), self.w2,
                          self.a2s, self.a2d)


def gat_params_from_jax(params: dict) -> OrderedDict:
    """The JAX example's parameters (``w1``, ``a1s``, ``a1d``, ``w2``,
    ``a2s``, ``a2d``, as numpy arrays) as a :class:`GAT` ``state_dict``."""
    return OrderedDict((k, torch.from_numpy(np.asarray(params[k], np.float32)))
                       for k in PARAMS)


def train(nodes: int = 2000, classes: int = 8, hidden: int = 32, steps: int = 40,
          p: int = 4, *, device=None, seed: int = 0, model: GAT | None = None,
          mesh=None, log=print) -> TrainResult:
    """Build the task and the model (or take ``model``, a previous run's,
    whose engines are kept) and train it; weights drawn from ``seed``.
    ``mesh``: p ranks, each fed its rows of the features and labels (every
    rank calls ``train``; see ``fit`` for ``log``)."""
    if model is None:
        ah = pattern_with_self_loops(community_graph(nodes, classes))
        model = GAT(*gat_ops(ah, p, classes, hidden, device=device, mesh=mesh),
                    ah.rowptr, classes, hidden)
    model.reset_parameters(seed)
    x, labels = community_task(nodes, classes)
    xs = model.vps_h.shard_b(x)
    ys = model.rows.take(labels, model.w1.device)
    losses, step_s = fit(model, xs, ys, steps, LR, log)
    acc = accuracy(model, xs, ys)
    if log:
        log(f"final accuracy {acc:.3f} on {model.nodes} nodes ({model.vps_h.fwd.p} "
            f"shards, {model.vps_h.nnz} edges, single-head GAT)")
    return TrainResult(losses, acc, model, step_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=2000)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--p", type=int, default=4, help="row shards")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    ap.add_argument("--distributed", action="store_true",
                    help="one shard a rank of the launcher's group; --p is its size")
    args = ap.parse_args(argv)
    device, mesh, log = args.device, None, functools.partial(print, flush=True)
    if args.distributed:
        device, mesh, log = join_mesh(args.device, args.p)
    res = train(args.nodes, args.classes, args.hidden, args.steps, args.p,
                device=device, mesh=mesh, log=log)
    return 0 if res.accuracy > 0.7 else 1


if __name__ == "__main__":
    raise SystemExit(main())
