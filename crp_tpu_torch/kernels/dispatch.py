"""Local-kernel selection and packing shared by the engines.

Counterpart of ``crp_tpu/kernels/dispatch.py``.  A kernel kind packs a
shard's compact CSR into tensors on the engine's device and returns a local
op, ``op(arrays, rB) -> C`` for the shard, where ``arrays`` are the packed
tensors with their leading shard axis stripped.  Ported kinds:

  * ``"segsum"`` — gather + ``index_add_`` (any CSR, any device, exact);
  * ``"pallas"`` — the uniform super-grouped windowed kernels, one pack per
    operating point (``x3``, ``default``, ``highest``; fp64 data takes the
    fp64 FMA kernel).

The other kinds of the JAX package (``ell``, ``ragged``, ``gather``,
``dd``, ``dd_mxu``, ``pallas_halo``) and the non-super-grouped
``_window_kernel`` raise :class:`UnsupportedSparsity` ("not yet ported"),
so the fallback walk ends at ``segsum`` (logged, and reported as the
engine's ``kernel_kind``) where the JAX package would have run one of them.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from . import device_pack
from .spmm_pallas import (
    SG_BUDGET, SG_BUDGET_CPU, TK, UnsupportedSparsity, choose_chunks,
    plan_supergroups, spmm_window_sg, spmm_window_sg_bf16, spmm_window_sg_bf16_plain,
    spmm_window_sg_plain, spmm_window_sg_presplit,
    spmm_window_sg_presplit_plain, window_extents,
)
from .spmm_segsum import pack_device_csr, spmm_segment_sum

logger = logging.getLogger("crp_tpu_torch")

# kinds of the JAX package whose kernels this package does not have yet,
# with the ROADMAP item that ports each
_NOT_PORTED = {
    "ell": "Queue A #6",
    "ragged": "Queue A #5 (Queue B #6-#9)",
    "gather": "Queue A #6 (Queue B #10)",
    "dd": "Queue A #7",
    "dd_mxu": "Queue A #7 (Queue B #11)",
    "pallas_halo": "Queue A #10 (Queue B #12)",
}


def resolve_auto_kernel(device) -> str:
    """``kernel="auto"``: ``"pallas"`` on a CUDA device, ``"segsum"``
    elsewhere (``dispatch.py:30-62`` picks segsum off the TPU too).

    The JAX package sends fp64 data on the TPU to ``dd`` and multi-shard
    engines to ``pallas_halo``; here fp64 runs natively in the windowed
    FMA kernel, and only p = 1 engines exist yet.
    """
    return "pallas" if torch.device(device).type == "cuda" else "segsum"


def sparsity_fallback_chain(kind: str, dtype, device, is_dd: bool = False) -> list:
    """Kinds to try, in order, after ``kind`` raised
    :class:`UnsupportedSparsity` (``dispatch.py:65-103``): dd-class
    requests keep ``"dd"`` only; everything else ends at ``"segsum"``.

    On the TPU the JAX package tries ``"gather"`` before ``"segsum"`` for
    fp32; that kind is not ported yet (ROADMAP Queue B #10), so the walk
    leaves it out on every device until it is.
    """
    if is_dd:
        return ["dd"]
    return ["segsum"]


def pack_with_fallback(
    shards: list, max_m: int, dtype, kind: str, *, device,
    mxu_precision: str = "highest", is_dd: bool = False,
) -> tuple:
    """:func:`pack_local_kernel` plus the sparsity-fallback walk
    (``dispatch.py:106-150``).  Returns ``(arrays, op, resolved_kind)``."""
    try:
        arrays, op = pack_local_kernel(
            shards, max_m, dtype, kind, device=device,
            mxu_precision=mxu_precision,
        )
        return arrays, op, kind
    except UnsupportedSparsity as e:
        err = e
    for fb in sparsity_fallback_chain(kind, dtype, device, is_dd=is_dd):
        logger.warning(
            "kernel=%r rejected this sparsity (%s); falling back to %s",
            kind, err, fb,
        )
        try:
            arrays, op = pack_local_kernel(
                shards, max_m, dtype, fb, device=device,
                mxu_precision=mxu_precision,
            )
            return arrays, op, fb
        except UnsupportedSparsity as e2:
            err = e2
    raise err


@dataclasses.dataclass
class SegsumOp:
    """Local op of the ``segsum`` kind: arrays are (row_ids, cols, vals)."""

    nrow: int
    min_b_rows: int = 1

    def __call__(self, arrs, rB):
        return spmm_segment_sum(arrs[0], arrs[1], arrs[2], self.nrow, rB)


@dataclasses.dataclass
class WindowOp:
    """Local op of the ``pallas`` kind on a uniform super-grouped pack.

    ``scheme`` picks the kernel and the arrays it reads: ``"x3"`` (ws, ah,
    al, bases), ``"bf16"`` (ws, ah, bases), ``"full"`` (ws, tiles, bases).
    ``bases`` stays in the pack for parity with the JAX pack; the Hopper
    kernels read only ``ws``.  ``min_b_rows``: rows rB must have.
    """

    scheme: str
    min_b_rows: int
    roofline: dict = dataclasses.field(default_factory=dict)

    @property
    def kernel(self):
        """The kernel wrapper this op launches."""
        return {
            "x3": spmm_window_sg_presplit,
            "bf16": spmm_window_sg_bf16,
            "full": spmm_window_sg,
        }[self.scheme]

    @property
    def plain(self):
        """The kernel's plain PyTorch version (same positional args)."""
        return {
            "x3": spmm_window_sg_presplit_plain,
            "bf16": spmm_window_sg_bf16_plain,
            "full": spmm_window_sg_plain,
        }[self.scheme]

    def kernel_args(self, arrs, rB) -> tuple:
        """Positional args of :attr:`kernel` and :attr:`plain` for one
        shard's ``arrs`` and receive buffer ``rB``."""
        if self.scheme == "x3":
            ws, ah, al, _ = arrs
            return ws, ah, al, rB
        if self.scheme == "bf16":
            ws, ah, _ = arrs
            return ws, ah, rB.to(torch.bfloat16)  # as dispatch.py:529 casts
        ws, tiles, _ = arrs
        return ws, tiles, rB

    def __call__(self, arrs, rB):
        c = self.kernel(*self.kernel_args(arrs, rB), min_b_rows=self.min_b_rows)
        # rows past the shard's own are zero panels: engines trim them
        return c.to(rB.dtype)


def pack_local_kernel(
    shards: list, max_m: int, dtype, kind: str = "segsum", *, device,
    mxu_precision: str = "highest",
) -> tuple:
    """Pack shards ``[(rowptr, compact_colidx, val), ...]`` for ``kind``
    (``dispatch.py:153-293``).  Returns ``(arrays, op)``: tensors on
    ``device`` with a leading shard axis, and the local op."""
    device = torch.device(device)
    if kind == "segsum":
        nnz_pad = max(max(int(r[-1] - r[0]) for r, _, _ in shards), 1)
        packs = [
            pack_device_csr(rowptr, cc, v.astype(dtype), nnz_pad, nrow=max_m)
            for rowptr, cc, v in shards
        ]
        arrays = tuple(
            torch.from_numpy(np.stack([p[i] for p in packs])).to(device)
            for i in range(3)
        )
        return arrays, SegsumOp(max_m)
    if kind == "pallas":
        return _pack_pallas(shards, max_m, dtype, mxu_precision, device)
    if kind in _NOT_PORTED:
        raise UnsupportedSparsity(
            f"kernel kind {kind!r} not yet ported (ROADMAP {_NOT_PORTED[kind]})"
        )
    raise ValueError(f"unknown local SpMM kernel kind {kind!r}")


def _sg_geometry(ws_shard, W, win_itemsize, small_budget, G):
    """Super-group plan shared by the packs (``dispatch.py:395-427``):
    (SG, Wsg, bases, sgc, G_sg) or None.  The JAX plan's k-chunk ``Wc_sg``
    is left out: the Hopper kernels do not chunk k.

    ``small_budget`` is the JAX package's ``interpret`` (off the TPU it
    plans with a 4 MB budget): the port passes True on the CPU, so its CPU
    packs equal the JAX packs its tests compare with, and False on CUDA,
    which gives the packs of the TPU runs.
    """
    sg_plan = plan_supergroups(
        ws_shard, W, 256, win_itemsize,
        vmem_budget=SG_BUDGET_CPU if small_budget else SG_BUDGET,
    )
    if sg_plan is None:
        return None
    SG, Wsg, bases = sg_plan
    sgc = -(-G // SG)
    G_sg = sgc * SG
    if len(bases) < sgc:
        bases = np.concatenate(
            [bases, np.full(sgc - len(bases), bases[-1], np.int32)]
        )
    return SG, Wsg, bases, sgc, G_sg


def _pack_pallas(shards, max_m, dtype, mxu_precision, device):
    """The ``pallas`` kind: the uniform windowed pack, or the ragged family
    when the uniform window is refused (``dispatch.py:330-392``).

    The JAX gate also prices a ragged cover for wide windows and tries it
    first when it is 3x smaller; a ragged pack that fails lands back on the
    uniform pack.  With the ragged family unported every branch of that
    gate ends at the uniform pack, so the port runs it directly; where the
    uniform pack refuses, JAX's ragged fallback is what is missing.
    """
    try:
        return _pack_pallas_uniform(shards, max_m, dtype, mxu_precision, device)
    except UnsupportedSparsity as e:
        raise UnsupportedSparsity(
            f"{e}; the ragged kernels the JAX package falls back to are not "
            f"yet ported (ROADMAP Queue A #5)"
        ) from e


def _pack_pallas_uniform(shards, max_m, dtype, mxu_precision, device):
    if len(shards) != 1:
        raise UnsupportedSparsity(
            "multi-shard uniform packs run the non-super-grouped "
            "_window_kernel, not yet ported (ROADMAP Queue B #4)"
        )
    dt = np.dtype(dtype)
    if dt == np.float32 and mxu_precision in ("default", "x3"):
        return _pack_uniform_single_bf16(shards[0], max_m, mxu_precision, device)
    if dt in (np.float32, np.float64):
        return _pack_uniform_single_full(
            shards[0], max_m, dt, mxu_precision, device
        )
    raise UnsupportedSparsity(f"no windowed kernel for dtype {dt}")


def _window_geometry(shard, max_m, win_itemsize, tile_itemsize, device):
    """Window extents, padding and super-group plan of one shard
    (``dispatch.py:450-473``); raises where the JAX pack has no sg plan."""
    rowptr, cc, _ = shard
    if len(rowptr) < 2 or int(rowptr[-1]) - int(rowptr[0]) == 0:
        raise UnsupportedSparsity("all shards empty")
    TM, max_window = 256, 16384
    nrow = len(rowptr) - 1
    rowptr64 = np.ascontiguousarray(rowptr, dtype=np.int64)
    min_t, W0 = window_extents(rowptr64, cc, TM)
    if W0 > max_window:
        raise UnsupportedSparsity(f"window {W0} rows > cap {max_window}")
    W, _, _ = choose_chunks(W0)
    G0 = -(-nrow // TM)
    G = max(G0, -(-max_m // TM))
    if G * W * TM * tile_itemsize > (8 << 30):
        raise UnsupportedSparsity(
            f"dense window tiles {(G * W * TM * tile_itemsize) >> 20} MiB > cap"
        )
    ws_shard = (min_t * TK).astype(np.int32)
    sg = _sg_geometry(ws_shard, W, win_itemsize, device.type == "cpu", G)
    if sg is None:
        raise UnsupportedSparsity(
            "no super-group plan (non-monotone windows): the non-super-grouped "
            "_window_kernel is not yet ported (ROADMAP Queue B #4)"
        )
    return rowptr64, nrow, TM, W, G0, ws_shard, sg


def _finish_window_pack(scheme, ws_full, panels, G0, TM, W, sg, b_itemsize,
                        passes, device):
    SG, Wsg, bases, sgc, G_sg = sg
    if G_sg > G0:  # pad-group window starts stay monotone and in range
        ws_full[G0:] = ws_full[G0 - 1]
    min_b_rows = max(int(ws_full.max()) + W, int(bases.max()) + Wsg)
    roofline = dict(
        G=G_sg, TM=TM, W=W,
        a_bytes=sum(p.numel() * p.element_size() for p in panels),
        b_rows_read=sgc * Wsg, c_rows=G_sg * TM, b_itemsize=b_itemsize,
        passes=passes,
    )
    arrays = (
        torch.from_numpy(ws_full[None]).to(device),
        *(p[None] for p in panels),
        torch.from_numpy(np.ascontiguousarray(bases[None])).to(device),
    )
    return arrays, WindowOp(scheme, min_b_rows, roofline)


def _pack_uniform_single_bf16(shard, max_m, mxu_precision, device):
    """x3 / default: densify on the device straight to the bf16 hi/lo pair
    (x3) or the hi half (default), as ``dispatch.py:430-540`` does on the
    TPU."""
    split = mxu_precision == "x3"
    rowptr64, nrow, TM, W, G0, ws_shard, sg = _window_geometry(
        shard, max_m, 4 if split else 2, 4, device
    )
    ws_full, ah, al = device_pack.uniform_fill(
        rowptr64, shard[1], shard[2], nrow, TM, W, sg[4], ws_shard,
        "pair" if split else "bf16", device,
    )
    if split:
        return _finish_window_pack(
            "x3", ws_full, (ah, al), G0, TM, W, sg, 4, 3, device
        )
    return _finish_window_pack("bf16", ws_full, (ah,), G0, TM, W, sg, 2, 1, device)


def _pack_uniform_single_full(shard, max_m, dtype, mxu_precision, device):
    """fp32 ``highest`` and fp64 data: full-precision panels densified on
    the device (``dispatch.py:543-608``, and the generic sg pack of
    ``:633-791`` for fp64)."""
    itemsize = np.dtype(dtype).itemsize
    rowptr64, nrow, TM, W, G0, ws_shard, sg = _window_geometry(
        shard, max_m, itemsize, itemsize, device
    )
    ws_full, tiles, _ = device_pack.uniform_fill(
        rowptr64, shard[1], shard[2], nrow, TM, W, sg[4], ws_shard,
        "f64" if itemsize == 8 else "f32", device,
    )
    passes = {"x3": 3, "highest": 6, "default": 1}.get(mxu_precision, 1)
    return _finish_window_pack(
        "full", ws_full, (tiles,), G0, TM, W, sg, itemsize, passes, device
    )


def _tensor_from_jax(x: np.ndarray) -> torch.Tensor:
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint16:  # bf16 bits
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def local_op_from_jax_pack(arrays, min_b_rows: int, device="cpu",
                           roofline: dict | None = None):
    """The port's packed tensors and local op for a JAX ``pallas`` sg pack.

    ``arrays`` are the JAX pack's numpy arrays with their leading shard
    axis, bf16 ones passed as ``.view(np.uint16)``: (ws, ah, al, bases) for
    x3, (ws, ah, bases) for the 1-pass bf16 pack, (ws, tiles, bases) for
    fp32/fp64.  One pack then feeds both packages.
    """
    tensors = tuple(_tensor_from_jax(x).to(device) for x in arrays)
    if len(tensors) == 4:
        scheme = "x3"
    elif tensors[1].dtype == torch.bfloat16:
        scheme = "bf16"
    else:
        scheme = "full"
    return tensors, WindowOp(scheme, int(min_b_rows), dict(roofline or {}))
