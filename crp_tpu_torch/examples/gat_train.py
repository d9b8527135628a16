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

On the card (the default), or on the CPU with ``--device cpu``:

  python -m crp_tpu_torch.examples.gat_train --nodes=2000 --steps=40 --p=4

It exits 0 when the final accuracy is over 0.7.
"""

from __future__ import annotations

import argparse
import functools
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.trainable import ValueParameterizedSpmm
from ..kernels.spmm_segsum import segment_sum
from ..plan.partition1d import csr_row_partition
from ..sparse.csr import CSRMatrix
from .common import (
    TrainResult, accuracy, community_graph, community_task, fit, init_normal, repad,
    self_loop_coo, unpad,
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


def gat_ops(ah, p: int, classes: int, hidden: int, *, device="cuda") -> tuple:
    """One op per propagation width (``hidden``, then ``classes``) over
    ``p`` nnz-balanced row blocks."""
    displs = csr_row_partition(ah.rowptr, p)
    return tuple(ValueParameterizedSpmm(ah, displs, displs, width, device=device)
                 for width in (hidden, classes))


class GAT(torch.nn.Module):
    """Two single-head attention layers, ELU between them
    (``examples/gat_train.py:107-147``)."""

    def __init__(self, vps_h, vps_o, rowptr, classes: int, hidden: int) -> None:
        super().__init__()
        self.vps_h, self.vps_o = vps_h, vps_o
        self.displs = vps_h.fwd.A_row_displs
        self.nodes = len(rowptr) - 1
        dev = vps_h.fwd.device
        rowptr = np.asarray(rowptr, np.int64)
        self.register_buffer("offsets", torch.from_numpy(rowptr).to(dev),
                             persistent=False)
        self.register_buffer("rows", torch.from_numpy(
            np.repeat(np.arange(self.nodes), np.diff(rowptr))).to(dev), persistent=False)
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

    def layer(self, vps, h, w, a_src, a_dst):
        """One head: ``softmax_j(LeakyReLU(s_i + d_j)) A(alpha) H W``."""
        m_pad, k_pad = self.vps_h.fwd.max_m, self.vps_h.fwd.max_k
        hw = h @ w
        s, d = hw @ a_src, hw @ a_dst
        # e_q = s[row_q] + d[col_q] as a rank-2 SDDMM: dot([s, 1], [1, d])
        ones = torch.ones_like(s)
        e = vps.sddmm(repad(torch.stack([s, ones], 1), self.displs, m_pad),
                      repad(torch.stack([ones, d], 1), self.displs, k_pad))
        alpha = _SegmentSoftmax.apply(F.leaky_relu(e, 0.2), self.rows, self.offsets)
        return unpad(vps(repad(hw, self.displs, k_pad), alpha), self.displs, self.nodes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.elu(self.layer(self.vps_h, x, self.w1, self.a1s, self.a1d))
        return self.layer(self.vps_o, h, self.w2, self.a2s, self.a2d)


def gat_params_from_jax(params: dict) -> OrderedDict:
    """The JAX example's parameters (``w1``, ``a1s``, ``a1d``, ``w2``,
    ``a2s``, ``a2d``, as numpy arrays) as a :class:`GAT` ``state_dict``."""
    return OrderedDict((k, torch.from_numpy(np.asarray(params[k], np.float32)))
                       for k in PARAMS)


def train(nodes: int = 2000, classes: int = 8, hidden: int = 32, steps: int = 40,
          p: int = 4, *, device="cuda", seed: int = 0, model: GAT | None = None,
          log=print) -> TrainResult:
    """Build the task and the model (or take ``model``, a previous run's,
    whose engines are kept) and train it; weights drawn from ``seed``."""
    if model is None:
        ah = pattern_with_self_loops(community_graph(nodes, classes))
        model = GAT(*gat_ops(ah, p, classes, hidden, device=device), ah.rowptr,
                    classes, hidden)
    model.reset_parameters(seed)
    x, labels = community_task(nodes, classes)
    xg = torch.from_numpy(x).to(model.w1.device)
    y = torch.from_numpy(labels).to(model.w1.device)
    losses, step_s = fit(model, xg, y, steps, LR, log)
    acc = accuracy(model, xg, y)
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
    args = ap.parse_args(argv)
    res = train(args.nodes, args.classes, args.hidden, args.steps, args.p,
                device=args.device, log=functools.partial(print, flush=True))
    return 0 if res.accuracy > 0.7 else 1


if __name__ == "__main__":
    raise SystemExit(main())
