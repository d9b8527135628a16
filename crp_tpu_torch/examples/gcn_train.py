"""Train a 2-layer GCN with the planned SpMM engines under autograd.

Counterpart of ``examples/gcn_train.py`` of the JAX package: the graph
propagation ``A_hat @ X`` runs through :class:`DifferentiableSpmm` (the
planned B-row exchange and the local kernels, with the exact backward
``dX = A_hat^T @ dC``), composed with dense layers, ``torch.optim.Adam``
and ``F.cross_entropy``.

Every activation stays row-sharded in the engines' row blocks
(:mod:`~crp_tpu_torch.engine.shardops`): the dense layers run shard by
shard and the weights' gradients are summed over the shards in shard order.
So one code path trains p shards on one device or one shard on each of p
ranks (``--distributed``), and the ranks' losses and weights equal the
one-device run's bit for bit.

On the card (the default), or on the CPU with ``--device cpu``:

  python -m crp_tpu_torch.examples.gcn_train --nodes=2000 --steps=30 --p=4

On p ranks, one GPU each (NCCL), or on gloo ranks on the CPU:

  torchrun --nproc-per-node=4 -m crp_tpu_torch.examples.gcn_train --distributed
  torchrun --nproc-per-node=4 -m crp_tpu_torch.examples.gcn_train --device cpu --distributed

It exits 0 when the final accuracy is over 0.7.
"""

from __future__ import annotations

import argparse
import functools
from collections import OrderedDict

import numpy as np
import torch

from ..config import SpmmConfig
from ..engine.autodiff import DifferentiableSpmm, repad_rows
from ..engine.shardops import ShardRows, shard_matmul
from ..plan.partition1d import csr_row_partition
from ..sparse.csr import CSRMatrix
from .common import (
    TrainResult, accuracy, community_graph, community_task, fit, init_normal, join_mesh,
    self_loop_coo,
)

LR = 3e-2


def normalized_adjacency(a) -> CSRMatrix:
    """GCN-normalized ``A_hat = D^-1/2 (A + I) D^-1/2`` as a CSRMatrix
    (``examples/gcn_train.py:30-44``)."""
    rows, cols = self_loop_coo(a)
    vals = np.concatenate([np.abs(a.val), np.ones(a.nrow)])
    deg = np.zeros(a.nrow)
    np.add.at(deg, rows, vals)
    d = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    return CSRMatrix.from_coo(a.nrow, a.ncol, rows, cols, vals * d[rows] * d[cols])


def gcn_ops(ah, p: int, classes: int, hidden: int, kernel: str = "segsum", *,
            device=None, mesh=None) -> tuple:
    """The two propagations, one op per width (``prop_in`` at ``classes``
    columns, ``prop_h`` at ``hidden``), over ``p`` nnz-balanced row blocks,
    at ``SpmmConfig(kernel=kernel)``; on ``mesh`` (p ranks) if given."""
    displs = csr_row_partition(ah.rowptr, p)
    return tuple(DifferentiableSpmm(ah, displs, displs, width, device=device,
                                    config=SpmmConfig(kernel=kernel), mesh=mesh)
                 for width in (classes, hidden))


class GCN(torch.nn.Module):
    """``logits = A_hat relu(A_hat X W1) W2`` on the ops' engines, every
    activation in their row blocks: it takes the held B shards of X
    (``prop_in.shard_b``) and returns the held shards' logits."""

    def __init__(self, prop_in, prop_h, nodes: int, classes: int, hidden: int) -> None:
        super().__init__()
        self.prop_in, self.prop_h = prop_in, prop_h
        self.nodes = nodes
        self.mesh = prop_in.fwd.mesh
        self.rows = ShardRows(prop_in.fwd.A_row_displs, nodes, self.mesh)
        dev = prop_in.fwd.device
        self.w1 = torch.nn.Parameter(torch.empty(classes, hidden, device=dev))
        self.w2 = torch.nn.Parameter(torch.empty(hidden, classes, device=dev))
        self.reset_parameters()

    @property
    def engines(self) -> tuple:
        return self.prop_in, self.prop_h

    def reset_parameters(self, seed: int = 0) -> None:
        init_normal((self.w1, self.w2), seed)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        h = torch.relu(shard_matmul(self.prop_in(xs), self.w1, self.mesh))
        h2 = self.prop_h(repad_rows(h, self.prop_h.fwd.max_k))
        return shard_matmul(h2, self.w2, self.mesh)


def gcn_params_from_jax(params: dict) -> OrderedDict:
    """The JAX example's parameters (``w1``, ``w2``, as numpy arrays) as a
    :class:`GCN` ``state_dict``."""
    return OrderedDict((k, torch.from_numpy(np.asarray(params[k], np.float32)))
                       for k in ("w1", "w2"))


def train(nodes: int = 2000, classes: int = 8, hidden: int = 32, steps: int = 30,
          p: int = 4, kernel: str = "segsum", *, device=None, seed: int = 0,
          model: GCN | None = None, mesh=None, log=print) -> TrainResult:
    """Build the task and the model (or take ``model``, a previous run's,
    whose engines are kept) and train it; weights drawn from ``seed``.
    ``mesh``: p ranks, each fed its rows of the features and labels (every
    rank calls ``train``; see ``fit`` for ``log``)."""
    if model is None:
        ah = normalized_adjacency(community_graph(nodes, classes))
        model = GCN(*gcn_ops(ah, p, classes, hidden, kernel, device=device, mesh=mesh),
                    nodes, classes, hidden)
    model.reset_parameters(seed)
    x, labels = community_task(nodes, classes)
    xs = model.prop_in.shard_b(x)
    ys = model.rows.take(labels, model.w1.device)
    losses, step_s = fit(model, xs, ys, steps, LR, log)
    acc = accuracy(model, xs, ys)
    if log:
        log(f"final accuracy {acc:.3f} on {model.nodes} nodes ({model.prop_in.fwd.p} "
            f"shards, kernel={model.prop_in.fwd.kernel_kind})")
    return TrainResult(losses, acc, model, step_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=2000)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--p", type=int, default=4, help="row shards")
    ap.add_argument("--kernel", default="segsum",
                    help="segsum|pallas|ragged|gather|auto")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    ap.add_argument("--distributed", action="store_true",
                    help="one shard a rank of the launcher's group; --p is its size")
    args = ap.parse_args(argv)
    device, mesh, log = args.device, None, functools.partial(print, flush=True)
    if args.distributed:
        device, mesh, log = join_mesh(args.device, args.p)
    res = train(args.nodes, args.classes, args.hidden, args.steps, args.p,
                args.kernel, device=device, mesh=mesh, log=log)
    return 0 if res.accuracy > 0.7 else 1


if __name__ == "__main__":
    raise SystemExit(main())
