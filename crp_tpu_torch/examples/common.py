"""The examples' synthetic task, training loop and ``--distributed`` join.

The task (``examples/gcn_train.py:73-83`` of the JAX package): a community
power-law graph, features the noisy one-hot community indicator, labels
the community ids.  A model must beat a feature-only probe by using the
graph.

The models keep every activation row-sharded, in the engines' row blocks
(:mod:`crp_tpu_torch.engine.shardops`): all p shards on one device, or one
a rank on a mesh, through one code path.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from ..shard.layout import make_mesh_1d
from ..sparse.synth import powerlaw_community_csr


def community_graph(nodes: int, classes: int):
    """The example's graph: ``powerlaw_community_csr(nodes, 8, nodes //
    classes, seed=5)``."""
    return powerlaw_community_csr(nodes, avg_degree=8, comm_size=nodes // classes,
                                  seed=5)


def community_task(nodes: int, classes: int) -> tuple:
    """(features (nodes, classes) fp32, labels (nodes,)) as numpy arrays."""
    rng = np.random.default_rng(6)
    comm = np.minimum(np.arange(nodes) // (nodes // classes), classes - 1)
    x = np.eye(classes, dtype=np.float32)[comm] + 0.5 * rng.standard_normal(
        (nodes, classes)).astype(np.float32)
    return x, comm


def self_loop_coo(a) -> tuple:
    """(rows, cols) of ``a``'s nonzeros followed by the diagonal's."""
    rows = np.repeat(np.arange(a.nrow, dtype=np.int64), np.diff(a.rowptr))
    rows = np.concatenate([rows, np.arange(a.nrow, dtype=np.int64)])
    cols = np.concatenate([a.colidx.astype(np.int64), np.arange(a.nrow, dtype=np.int64)])
    return rows, cols


def init_normal(params, seed: int) -> None:
    """Each parameter, in order, from one seeded generator: N(0, 1) x 0.3,
    the JAX examples' scale."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for w in params:
            w.copy_(torch.randn(w.shape, generator=g) * 0.3)


@dataclasses.dataclass
class TrainResult:
    """What a ``train(...)`` returns: the loss at each step (before its
    update), the final accuracy, the model (it holds the engines) and the
    seconds each step took, host clock, the loss read back included."""

    losses: list
    accuracy: float
    model: torch.nn.Module
    step_s: list

    @property
    def engines(self) -> tuple:
        return self.model.engines


def accuracy(model, inputs, ys) -> float:
    """The model's accuracy over every node (the same on every rank)."""
    with torch.no_grad():
        return model.rows.accuracy(model(inputs), ys)


def loss(model, inputs, ys) -> torch.Tensor:
    """The mean cross entropy over every node, summed in shard order."""
    return model.rows.loss(model(inputs), ys)


def fit(model, inputs, ys, steps: int, lr: float, log=print) -> tuple:
    """Adam on the mean cross entropy (``examples/gcn_train.py:127-141``);
    logs the loss and accuracy at every fifth step and the last.  ``ys``:
    the held shards' labels (``model.rows.take``).  On a mesh the accuracy
    is a collective: give every rank a ``log``, or none to all (a rank
    that should stay quiet takes one that prints nothing).  Returns
    (losses, step seconds)."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    losses, step_s = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        opt.zero_grad()
        step_loss = loss(model, inputs, ys)
        step_loss.backward()
        opt.step()
        losses.append(float(step_loss.detach()))
        step_s.append(time.perf_counter() - t0)
        if log and (i % 5 == 0 or i == steps - 1):
            log(f"step {i:3d}  loss {losses[-1]:.4f}  acc "
                f"{accuracy(model, inputs, ys):.3f}")
    return losses, step_s


def join_mesh(device: str, p: int) -> tuple:
    """``--distributed``: join the launcher's process group (``join_ranks``:
    NCCL on the card, gloo under ``--device cpu``) and return ``(this
    rank's device, make_mesh_1d(world), a log that prints on rank 0
    alone)``; ``p`` must be the world size."""
    from ..cli._driver import join_ranks

    device, rank, world = join_ranks({"distributed": "1"}, device)
    if p != world:
        raise SystemExit(f"--p={p} shards on {world} ranks: --p must be the world size")
    say = functools.partial(print, flush=True) if rank == 0 else (lambda *_: None)
    return device, make_mesh_1d(world), say
