"""The examples' synthetic task, shard layout and training loop.

The task (``examples/gcn_train.py:73-83`` of the JAX package): a community
power-law graph, features the noisy one-hot community indicator, labels
the community ids.  A model must beat a feature-only probe by using the
graph.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

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


def unpad(cs: torch.Tensor, displs, nodes: int) -> torch.Tensor:
    """(p, rows, w) shards -> (nodes, w) along the row blocks ``displs``;
    rows past the last block are zero."""
    out = torch.cat([cs[i, : int(displs[i + 1] - displs[i])]
                     for i in range(len(displs) - 1)])
    return F.pad(out, (0, 0, 0, nodes - out.shape[0]))


def repad(xg: torch.Tensor, displs, rows: int) -> torch.Tensor:
    """(nodes, w) -> (p, rows, w) shards along the row blocks ``displs``."""
    return torch.stack([F.pad(xg[int(displs[i]) : int(displs[i + 1])],
                              (0, 0, 0, rows - int(displs[i + 1] - displs[i])))
                        for i in range(len(displs) - 1)])


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


def accuracy(model, inputs, y) -> float:
    with torch.no_grad():
        return float((model(inputs).argmax(-1) == y).float().mean())


def fit(model, inputs, y, steps: int, lr: float, log=print) -> tuple:
    """Adam on the mean cross entropy (``examples/gcn_train.py:127-141``);
    logs the loss and accuracy at every fifth step and the last.  Returns
    (losses, step seconds)."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    losses, step_s = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = F.cross_entropy(model(inputs), y)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        step_s.append(time.perf_counter() - t0)
        if log and (i % 5 == 0 or i == steps - 1):
            log(f"step {i:3d}  loss {losses[-1]:.4f}  acc "
                f"{accuracy(model, inputs, y):.3f}")
    return losses, step_s
