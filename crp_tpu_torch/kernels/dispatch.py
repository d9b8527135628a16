"""Local-kernel selection and packing shared by the engines.

Counterpart of ``crp_tpu/kernels/dispatch.py``.  A kernel kind packs a
shard's compact CSR into tensors on the engine's device and returns a local
op, ``op(arrays, rB) -> C`` for the shard, where ``arrays`` are the packed
tensors with their leading shard axis stripped.  Ported kinds:

  * ``"segsum"`` — gather + ``index_add_`` (any CSR, any device, exact);
  * ``"pallas"`` — the windowed family with the JAX package's gate between
    its two packs: the uniform super-grouped windows, or the ragged
    gathered-window chunks (+ spill) where the uniform window is refused
    or over 3x a ragged cover; one pack per operating point (``x3``,
    ``default``, ``highest``; fp64 data takes the fp64 FMA kernels);
  * ``"ragged"`` — the ragged pack directly;
  * ``"gather"`` — every nonzero through the block-step gather kernel
    (fp32, any CSR: the scrambled power-law graphs the ragged cover
    refuses);
  * ``"ell"`` — an ELL slot scan in plain PyTorch;
  * ``"dd_mxu"`` — fp64 class on the FP64 tensor cores, on the ragged total
    cover with fp64 panels;
  * ``"dd"`` — fp64 class: ``dd_mxu`` on a CUDA device where its cover
    fits, else the fp64 ELL (at most 128 nonzeros per row) or chunked
    segment-sum tier.  B and C are fp64 whatever the engine's dtype.

The JAX package's ``pallas_halo`` and multi-shard windowed packs raise
:class:`UnsupportedSparsity` ("not yet ported"), so the fallback walk goes
on (logged, and reported as the engine's ``kernel_kind``) where the JAX
package would have run them.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from . import device_pack
from .spmm_dd import (
    ELL_MAX_L, pack_coo_dd, pack_ell_dd, spmm_ell_dd, spmm_segsum_dd,
)
from .spmm_dd_mxu import dd_mxu_geometry, ragged_dd_cover, spmm_ragged_dd
from .spmm_ell import pack_ell, spmm_ell
from .spmm_pallas import (
    SG_BUDGET, SG_BUDGET_CPU, TK, UnsupportedSparsity, choose_chunks,
    plan_supergroups, spmm_window_sg, spmm_window_sg_bf16, spmm_window_sg_bf16_plain,
    spmm_window_sg_plain, spmm_window_sg_presplit,
    spmm_window_sg_presplit_plain, window_extents,
)
from .spmm_ragged import (
    PANEL_CAP_BYTES, SPILL_Q, SPILL_TMO, cover_with_cap, default_min_chunk_nnz,
    estimate_ragged, first_ptr, gather_step_layout, pack_gather_blocks,
    pack_spill, pack_spill_blocks, resolve_ragged_geometry, spmm_gather,
    spmm_gather_plain, spmm_ragged, spmm_ragged_bf16, spmm_ragged_bf16_plain,
    spmm_ragged_plain, spmm_ragged_presplit, spmm_ragged_presplit_plain,
    spmm_spill, spmm_spill_chunked, spmm_spill_plain,
)
from .spmm_segsum import pack_device_csr, spmm_segment_sum

logger = logging.getLogger("crp_tpu_torch")

# kinds of the JAX package whose kernels this package does not have yet,
# with the ROADMAP item that ports each
_NOT_PORTED = {
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


def sparsity_fallback_chain(kind: str, dtype, device, is_dd: bool = False,
                            fallback: list | None = None) -> list:
    """Kinds to try, in order, after ``kind`` raised
    :class:`UnsupportedSparsity` (``dispatch.py:65-103``): dd-class
    requests keep ``"dd"`` only (never an fp32 kernel); fp32 on a CUDA
    device tries ``"gather"`` before ``"segsum"``, as the JAX package does
    on a TPU; everything else ends at ``"segsum"``.

    ``fallback`` stands for ``CRP_TPU_FALLBACK``: when given it replaces
    the chain, except for dd-class requests, which ignore it.
    """
    if is_dd:
        return ["dd"]
    if fallback:
        return list(fallback)
    chain = []
    if (kind != "gather" and np.dtype(dtype) == np.float32
            and torch.device(device).type == "cuda"):
        chain.append("gather")
    chain.append("segsum")
    return chain


def pack_with_fallback(
    shards: list, max_m: int, dtype, kind: str, *, device,
    mxu_precision: str = "highest", is_dd: bool = False,
    fallback: list | None = None,
) -> tuple:
    """:func:`pack_local_kernel` plus the sparsity-fallback walk
    (``dispatch.py:106-150``).  Returns ``(arrays, op, resolved_kind)``.
    After a failed ``dd_mxu`` pack the ``dd`` retry skips the MXU cover
    (``dd_skip_mxu``) rather than repeat it only to fail again."""
    try:
        arrays, op = pack_local_kernel(
            shards, max_m, dtype, kind, device=device,
            mxu_precision=mxu_precision,
        )
        return arrays, op, kind
    except UnsupportedSparsity as e:
        err = e
    extra = {"dd_skip_mxu": True} if kind == "dd_mxu" else {}
    for fb in sparsity_fallback_chain(kind, dtype, device, is_dd=is_dd,
                                      fallback=fallback):
        logger.warning(
            "kernel=%r rejected this sparsity (%s); falling back to %s",
            kind, err, fb,
        )
        try:
            arrays, op = pack_local_kernel(
                shards, max_m, dtype, fb, device=device,
                mxu_precision=mxu_precision, **extra,
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
    variant = "segsum"

    def __call__(self, arrs, rB):
        return spmm_segment_sum(arrs[0], arrs[1], arrs[2], self.nrow, rB)


@dataclasses.dataclass
class EllOp:
    """Local op of the ``ell`` kind: arrays are (cols, vals) of (max_m, L)."""

    min_b_rows = 1
    variant = "ell"

    def __call__(self, arrs, rB):
        return spmm_ell(arrs[0], arrs[1], rB)


@dataclasses.dataclass
class DDOp:
    """Local op of the ``dd`` kind's non-MXU tier, in fp64: ``tier``
    ``"ell"`` (arrays cols, vals) or ``"segsum"`` (row_ids, cols, vals);
    ``nrow`` rows of C."""

    tier: str
    nrow: int
    min_b_rows = 1

    @property
    def variant(self) -> str:
        return self.tier

    def __call__(self, arrs, rB):
        if self.tier == "ell":
            return spmm_ell_dd(arrs[0], arrs[1], rB)
        return spmm_segsum_dd(arrs[0], arrs[1], arrs[2], rB, self.nrow)


@dataclasses.dataclass
class GatherOp:
    """Local op of the ``gather`` kind: arrays are the JAX pack's (rel,
    cols, vals, first, blk), then ``blk_ptr`` (:func:`first_ptr` of
    ``first``), the step ranges the CUDA kernel reads.  ``M`` output rows
    (``max_m`` rounded up to TMo)."""

    M: int
    mxu_precision: str
    roofline: dict = dataclasses.field(default_factory=dict)
    min_b_rows = 1
    variant = "gather"
    kernel = staticmethod(spmm_gather)
    plain = staticmethod(spmm_gather_plain)

    def kernel_args(self, arrs, rB) -> tuple:
        """Positional args of :attr:`kernel` and :attr:`plain` for one
        shard's ``arrs`` and receive buffer ``rB``."""
        rel, cols, vals, _, blk, blk_ptr = arrs
        return (rel, cols, vals, blk, blk_ptr, rB, self.M, self.mxu_precision)

    def __call__(self, arrs, rB):
        # rows past the shard's own are zero: engines trim them
        return self.kernel(*self.kernel_args(arrs, rB)).to(rB.dtype)


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
    variant = "uniform"

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


def _stacked(packs, device) -> tuple:
    """Per-shard tuples of numpy arrays -> tensors on ``device`` with a
    leading shard axis."""
    return tuple(
        torch.from_numpy(np.stack([p[i] for p in packs])).to(device)
        for i in range(len(packs[0]))
    )


def _max_row_nnz(shards) -> int:
    """The largest row of any shard, at least 1: the ELL slot count."""
    return max(
        max((int(np.diff(r).max()) if len(r) > 1 else 0) for r, _, _ in shards), 1
    )


def pack_local_kernel(
    shards: list, max_m: int, dtype, kind: str = "segsum", *, device,
    mxu_precision: str = "highest", dd_skip_mxu: bool = False,
) -> tuple:
    """Pack shards ``[(rowptr, compact_colidx, val), ...]`` for ``kind``
    (``dispatch.py:153-293``).  Returns ``(arrays, op)``: tensors on
    ``device`` with a leading shard axis, and the local op.
    ``dd_skip_mxu`` sends ``kind="dd"`` straight to its non-MXU tier."""
    device = torch.device(device)
    if kind == "segsum":
        nnz_pad = max(max(int(r[-1] - r[0]) for r, _, _ in shards), 1)
        packs = [
            pack_device_csr(rowptr, cc, v.astype(dtype), nnz_pad, nrow=max_m)
            for rowptr, cc, v in shards
        ]
        return _stacked(packs, device), SegsumOp(max_m)
    if kind == "ell":
        L = _max_row_nnz(shards)
        packs = [pack_ell(rowptr, cc, v.astype(dtype), max_m, L=L)
                 for rowptr, cc, v in shards]
        return _stacked(packs, device), EllOp()
    if kind == "pallas":
        return _pack_pallas(shards, max_m, dtype, mxu_precision, device)
    if kind == "ragged":
        return _pack_ragged(shards, max_m, dtype, mxu_precision, device)
    if kind == "gather":
        return _pack_gather(shards, max_m, dtype, mxu_precision, device)
    if kind == "dd_mxu":
        return _pack_dd_mxu(shards, max_m, device)
    if kind == "dd":
        # on a CUDA device the FP64 tensor cores where the total cover fits,
        # as the JAX package takes its MXU tier on a TPU; the CPU goes
        # straight to the non-MXU tier, as JAX does off the TPU
        if device.type == "cuda" and not dd_skip_mxu:
            try:
                return _pack_dd_mxu(shards, max_m, device)
            except UnsupportedSparsity:
                pass
        return _pack_dd(shards, max_m, device)
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


def _uniform_cost_estimate(shards, max_m, TM=256):
    """Predicted uniform pack without densifying: (W, G, ok)
    (``dispatch.py:296-327``)."""
    W_raw = 0
    G = -(-max_m // TM)
    for rowptr, cc, _ in shards:
        nrow = len(rowptr) - 1
        if nrow == 0 or int(rowptr[-1]) == int(rowptr[0]):
            continue
        rowptr = np.asarray(rowptr, dtype=np.int64)
        counts = np.diff(rowptr)
        nonempty = counts > 0
        row_min = np.full(nrow, np.iinfo(np.int64).max, dtype=np.int64)
        row_max = np.full(nrow, -1, dtype=np.int64)
        row_min[nonempty] = cc[rowptr[:-1][nonempty]]
        row_max[nonempty] = cc[rowptr[1:][nonempty] - 1]
        Gs = -(-nrow // TM)
        starts = np.arange(Gs) * TM
        min_t = np.minimum.reduceat(row_min, starts) // TK
        max_t = np.maximum.reduceat(row_max, starts) // TK
        empty = max_t < 0
        min_t = np.where(empty, 0, np.minimum(min_t, max_t))
        max_t = np.where(empty, 0, max_t)
        W_raw = max(W_raw, int((max_t - min_t + 1).max()) * TK)
        G = max(G, Gs)
    W, _, _ = choose_chunks(max(W_raw, TK))
    return W, G, W_raw <= 16384


def _pack_pallas(shards, max_m, dtype, mxu_precision, device):
    """The ``pallas`` kind: the JAX package's gate between the uniform
    windowed pack and the ragged family (``dispatch.py:330-392``).

    Windows over 16384 rows go straight to ragged.  Wide windows (over
    4096 rows or 1 GiB) price a ragged cover at the geometry the ragged
    pack would use and take it when the uniform pack is over 3x larger,
    landing back on the uniform pack if the ragged one refuses.  Any
    uniform refusal (no super-group plan, per-row-unsorted columns) goes
    to ragged.  ``device.type == "cpu"`` stands where JAX has
    ``interpret``, so CPU packs equal the JAX CPU packs.
    """
    if len(shards) != 1:
        raise UnsupportedSparsity(
            "multi-shard windowed packs (the non-super-grouped _window_kernel, "
            "ROADMAP Queue B #4; ragged packs at p > 1, Queue A #8) are not "
            "yet ported"
        )
    W_est, G_est, uniform_ok = _uniform_cost_estimate(shards, max_m)
    if not uniform_ok:
        return _pack_ragged(shards, max_m, dtype, mxu_precision, device)
    itemsize = np.dtype(dtype).itemsize
    bytes_uniform = G_est * 256 * W_est * itemsize
    rowptr, cc, _ = shards[0]
    nonempty = len(rowptr) > 1 and int(rowptr[-1]) > int(rowptr[0])
    if (W_est > 4096 or bytes_uniform > (1 << 30)) and nonempty:
        geometry = resolve_ragged_geometry(
            rowptr, cc, mxu_precision, small=device.type == "cpu"
        )
        S, _, _ = estimate_ragged(rowptr, cc, *geometry)
        if bytes_uniform > 3 * max(S * geometry[0] * geometry[1] * itemsize, 1):
            try:
                return _pack_ragged(shards, max_m, dtype, mxu_precision, device,
                                    geometry=geometry)
            except UnsupportedSparsity:
                pass  # ragged not worthwhile either; try uniform below
    try:
        return _pack_pallas_uniform(shards[0], max_m, dtype, mxu_precision, device)
    except UnsupportedSparsity:
        return _pack_ragged(shards, max_m, dtype, mxu_precision, device)


def _pack_pallas_uniform(shard, max_m, dtype, mxu_precision, device):
    dt = np.dtype(dtype)
    if dt == np.float32 and mxu_precision in ("default", "x3"):
        return _pack_uniform_single_bf16(shard, max_m, mxu_precision, device)
    if dt in (np.float32, np.float64):
        return _pack_uniform_single_full(shard, max_m, dt, mxu_precision, device)
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


RAGGED_MIN_PCT = 30  # the JAX default of CRP_TPU_RAGGED_MIN_PCT
SPILL_IMPLS = ("auto", "segsum", "pallas")


def _check_keep_share(mxu_nnz: int, nnz: int) -> None:
    """Refuse a ragged cover that keeps under RAGGED_MIN_PCT of the
    nonzeros in panels (``dispatch.py:934-939``)."""
    if mxu_nnz * 100 < RAGGED_MIN_PCT * nnz:
        raise UnsupportedSparsity(
            f"ragged cover keeps only {mxu_nnz * 100 // nnz}% of nnz "
            f"in panels (min {RAGGED_MIN_PCT}%)"
        )


@dataclasses.dataclass
class RaggedOp:
    """Local op of the ``pallas``/``ragged`` kinds on a ragged pack.

    ``arrays`` are the JAX pack's, (step_g, step_first, starts, *panels,
    *spill), then the step ranges the CUDA kernels read: ``group_ptr`` and,
    for the fused spill, ``blk_ptr`` (both :func:`first_ptr` of the pack's
    ``first`` arrays).  ``scheme`` picks the ragged kernel: ``"x3"`` (ah,
    al), ``"bf16"`` (ah), ``"full"`` (fp32/fp64 panels, FMA) or ``"dd"``
    (fp64 panels of the ``dd_mxu`` total cover, FP64 tensor cores; its
    variant is ``"dd_mxu"``).  ``spill_impl``: ``"none"``, ``"segsum"``
    (rows, cols, vals; plain ``index_add_``) or ``"pallas"`` (rel, cols,
    vals, first, blk; the fused spill kernel).
    """

    scheme: str
    min_b_rows: int
    spill_impl: str
    mxu_precision: str
    roofline: dict = dataclasses.field(default_factory=dict)

    @property
    def variant(self) -> str:
        return "dd_mxu" if self.scheme == "dd" else "ragged"

    @property
    def n_panels(self) -> int:
        return 2 if self.scheme == "x3" else 1

    @property
    def kernel(self):
        """The ragged kernel wrapper this op launches."""
        return {
            "x3": spmm_ragged_presplit,
            "bf16": spmm_ragged_bf16,
            "full": spmm_ragged,
            "dd": spmm_ragged_dd,
        }[self.scheme]

    @property
    def plain(self):
        """The ragged kernel's plain PyTorch version (same positional args)."""
        return {
            "x3": spmm_ragged_presplit_plain,
            "bf16": spmm_ragged_bf16_plain,
            "full": spmm_ragged_plain,
            "dd": spmm_ragged_plain,
        }[self.scheme]

    spill_kernel = staticmethod(spmm_spill)
    spill_plain = staticmethod(spmm_spill_plain)

    def _spill_arrays(self, arrs):
        k = 3 + self.n_panels
        return arrs[k : k + {"none": 0, "segsum": 3, "pallas": 5}[self.spill_impl]]

    def kernel_args(self, arrs, rB) -> tuple:
        """Positional args of :attr:`kernel` and :attr:`plain` for one
        shard's ``arrs`` and receive buffer ``rB``."""
        group_ptr = arrs[3 + self.n_panels + len(self._spill_arrays(arrs))]
        b = rB.to(torch.bfloat16) if self.scheme == "bf16" else rB
        return (arrs[0], group_ptr, arrs[2], *arrs[3 : 3 + self.n_panels], b)

    def spill_args(self, arrs, c, rB) -> tuple:
        """Positional args of :attr:`spill_kernel` and :attr:`spill_plain`
        (the ``pallas`` spill) for the ragged kernel's output ``c``."""
        rel, cols, vals, _, blk = self._spill_arrays(arrs)
        return (c, rel, cols, vals, blk, arrs[-1], rB, self.mxu_precision)

    def __call__(self, arrs, rB):
        c = self.kernel(*self.kernel_args(arrs, rB), min_b_rows=self.min_b_rows)
        if self.spill_impl == "pallas":
            c = self.spill_kernel(*self.spill_args(arrs, c, rB))
        elif self.spill_impl == "segsum":
            rows, cols, vals = self._spill_arrays(arrs)
            c = c + spmm_spill_chunked(rows, cols, vals, rB, c.shape[0])
        # rows past the shard's own are zero (dummy chunks): engines trim them
        return c.to(rB.dtype)


def _extend_and_stack_steps(shard_steps, G):
    """Stacking discipline of the ragged packs (``dispatch.py:815-853``).

    ``shard_steps``: per shard, None (empty shard) or (starts, step_g,
    step_first, G_s).  Groups past a shard's own count get dummy chunks
    (start 0, first=1: every output block must be initialized); shards are
    then padded to a common S with trailing no-op steps on the LAST group
    (first=0, zero payload).  Returns (a_g, a_first, a_starts, S).
    """
    per = []
    for st in shard_steps:
        if st is None:
            starts = np.zeros(G, np.int32)
            step_g = np.arange(G, dtype=np.int32)
            step_first = np.ones(G, np.int32)
        else:
            starts, step_g, step_first, G_s = st
            if G_s < G:
                extra = G - G_s
                starts = np.concatenate([starts, np.zeros(extra, np.int32)])
                step_g = np.concatenate(
                    [step_g, np.arange(G_s, G, dtype=np.int32)]
                )
                step_first = np.concatenate(
                    [step_first, np.ones(extra, np.int32)]
                )
        per.append((starts, step_g, step_first))
    S = max(len(x[0]) for x in per)
    p = len(shard_steps)
    a_starts = np.zeros((p, S), np.int32)
    a_g = np.full((p, S), G - 1, np.int32)
    a_first = np.zeros((p, S), np.int32)
    for i, (starts, step_g, step_first) in enumerate(per):
        k = len(starts)
        a_starts[i, :k] = starts
        a_g[i, :k] = step_g
        a_first[i, :k] = step_first
    return a_g, a_first, a_starts, S


def _pack_ragged(shards, max_m, dtype, mxu_precision, device, *, geometry=None,
                 min_chunk_nnz=None, spill_impl="auto", TMo=SPILL_TMO, Q=SPILL_Q):
    """Ragged gathered-window pack, p = 1 (``dispatch.py:856-1158``).

    Keyword arguments stand for the JAX package's environment knobs, with
    its defaults: ``geometry`` (TM, Wc) (``CRP_TPU_RAGGED_TM``/``_WC``; None:
    the model picks), ``min_chunk_nnz`` (``CRP_TPU_RAGGED_MIN_NNZ``; None:
    the break-even model), ``spill_impl`` (``CRP_TPU_SPILL_IMPL``: "auto",
    "segsum" or "pallas"), ``TMo``/``Q`` (``CRP_TPU_SPILL_TMO``/``_Q``).
    "auto" takes the fused spill kernel for a dense spill (at least one
    spilled nnz per output row) of an fp32 pack on a CUDA device, and
    ``segsum`` otherwise.  Raises UnsupportedSparsity when the cover keeps
    under 30% of the nonzeros in panels; where the cover's own count
    settles that, before any panel is filled.
    """
    if spill_impl not in SPILL_IMPLS:
        raise ValueError(f"spill_impl={spill_impl!r} not in {SPILL_IMPLS}")
    if len(shards) != 1:
        raise UnsupportedSparsity(
            "multi-shard ragged packs need p > 1 engines (ROADMAP Queue A #8)"
        )
    rowptr, cc, v = shards[0]
    nnz = int(rowptr[-1]) - int(rowptr[0]) if len(rowptr) > 1 else 0
    if nnz == 0:
        raise UnsupportedSparsity("all shards empty")
    if geometry is None:
        geometry = resolve_ragged_geometry(
            rowptr, cc, mxu_precision, small=device.type == "cpu"
        )
    TM, Wc = geometry
    is_f32 = np.dtype(dtype) == np.float32
    pack_dtype = np.float64 if np.dtype(dtype) == np.float64 else np.float32
    if is_f32 and mxu_precision in ("default", "x3"):
        mode = "pair" if mxu_precision == "x3" else "bf16"
    else:
        mode = "f64" if pack_dtype == np.float64 else "f32"

    rowptr64 = np.ascontiguousarray(rowptr, dtype=np.int64)
    cc32 = np.ascontiguousarray(cc, dtype=np.int32)
    nrow = len(rowptr64) - 1
    G_s = max(-(-nrow // TM), 1)
    # the bf16 modes cap at fp32 bytes, as the JAX direct-bf16 pack does
    starts_s, group_ptr_s, spill_s = cover_with_cap(
        rowptr64, cc32, TM, Wc,
        default_min_chunk_nnz(TM, Wc) if min_chunk_nnz is None else min_chunk_nnz,
        G_s, PANEL_CAP_BYTES, np.dtype(pack_dtype).itemsize,
    )
    # The keep share before the fill.  The cover's spill count bounds the
    # fill's from above: a group that keeps no chunk gets a dummy chunk over
    # [0, Wc), which takes back its nonzeros there.  So with every column
    # below Wc taken back, a cover still under the share is refused here,
    # uploading no panel; the fill's own count decides the rest (below), as
    # in the JAX pack.
    _check_keep_share(nnz - spill_s + int(np.count_nonzero(cc32[:nnz] < Wc)), nnz)
    G = max(-(-max_m // TM), G_s)
    first_s = np.zeros(len(starts_s), np.int32)
    first_s[group_ptr_s[:-1]] = 1
    a_g, a_first, a_starts, S = _extend_and_stack_steps(
        [(starts_s, np.repeat(np.arange(G_s, dtype=np.int32), np.diff(group_ptr_s)),
          first_s, G_s)],
        G,
    )
    group_ptr = first_ptr(a_first[0])
    # the pad groups' dummy chunks are part of the fill: their panels are zero
    ah, al, spill = device_pack.ragged_fill(
        rowptr64, cc32, v, TM, Wc, a_starts[0], group_ptr, mode, device,
    )
    Z = len(spill[0])
    mxu_nnz = nnz - Z
    _check_keep_share(mxu_nnz, nnz)

    sp_impl = spill_impl if Z else "segsum"
    if sp_impl == "auto":
        # the fused kernel passes over every output block (the C pass-through):
        # worth it only for a dense spill
        sp_impl = "pallas" if Z >= max_m and device.type == "cuda" else "segsum"
    if sp_impl == "pallas" and pack_dtype != np.float32:
        sp_impl = "segsum"  # the fused spill kernel is fp32-only
    extras = [group_ptr]
    sp_arrays = ()
    if Z and sp_impl == "pallas":
        while (G * TM) % TMo:  # M = G*TM is only 128-aligned
            TMo //= 2
        r, c, vv = spill
        # (block, column) order: the B gather walks near-monotonically
        order = np.lexsort((c, r // TMo))
        r, c, vv = r[order], c[order], vv[order]
        nblk = G * TM // TMo
        counts = np.bincount(r // TMo, minlength=nblk)
        ns = int(np.maximum(-(-counts // Q), 1).sum())
        sp_arrays = pack_spill_blocks((r, c, vv), ns, G * TM, pack_dtype,
                                      TMo=TMo, Q=Q)
        extras.append(first_ptr(sp_arrays[3]))
    elif Z:
        sp_arrays = pack_spill(spill, Z, G * TM, pack_dtype)

    panels = (ah,) if al is None else (ah, al)
    a_bytes = sum(p.numel() * p.element_size() for p in panels)
    arrays = (
        *(torch.from_numpy(x).to(device) for x in (a_g, a_first, a_starts)),
        *(p[None] for p in panels),
        *(torch.from_numpy(x[None]).to(device) for x in (*sp_arrays, *extras)),
    )
    scheme = {"pair": "x3", "bf16": "bf16"}.get(mode, "full")
    roofline = dict(
        G=G, TM=TM, W=Wc, a_bytes=a_bytes,
        b_rows_read=S * Wc, c_rows=G * TM,
        b_itemsize=2 if mode == "bf16" else np.dtype(dtype).itemsize,
        S=S, spill_nnz=Z, spill_max=Z, spill_impl=sp_impl,
        mxu_frac=mxu_nnz / nnz,
        passes={"x3": 3, "highest": 6, "default": 1}.get(mxu_precision, 1),
    )
    op = RaggedOp(scheme, int(a_starts.max()) + Wc,
                  sp_impl if Z else "none", mxu_precision, roofline)
    return arrays, op


def _pack_gather(shards, max_m, dtype, mxu_precision, device, *, TMo=SPILL_TMO,
                 Q=SPILL_Q):
    """The ``gather`` kind (``dispatch.py:1161-1224``): every nonzero in
    the block steps of the fused spill, no cover and no scatter.  fp32 only;
    ``TMo``/``Q`` stand for ``CRP_TPU_SPILL_TMO``/``_Q``.  The output has
    its own ``M = ceil(max_m / TMo) * TMo`` rows: TMo is never halved to
    divide another pack's rows, as the ragged pack's fused spill does."""
    if np.dtype(dtype) != np.float32:
        raise UnsupportedSparsity("gather kernel is fp32-only")
    if TMo % 128 or Q % 128:
        raise ValueError(f"TMo={TMo} and Q={Q} must be multiples of 128")
    M = -(-max_m // TMo) * TMo
    nblk = M // TMo
    total_nnz = 0
    blk_counts = []
    for rowptr, _, _ in shards:
        nrow = len(rowptr) - 1
        idx = np.minimum(np.arange(nblk + 1, dtype=np.int64) * TMo, max(nrow, 0))
        blk_counts.append(np.diff(rowptr[idx]).astype(np.int64))
        total_nnz += int(rowptr[-1]) - int(rowptr[0]) if nrow > 0 else 0
    if total_nnz == 0:
        raise UnsupportedSparsity("all shards empty")
    step_base = gather_step_layout(blk_counts, Q)
    packs = [
        pack_gather_blocks(rowptr, cc, v, step_base, M, TMo=TMo, Q=Q)
        for rowptr, cc, v in shards
    ]
    ns = int(step_base[-1])
    roofline = dict(
        G=nblk, TM=TMo, W=Q, S=ns,
        a_bytes=sum(x.nbytes for p in packs for x in p),
        b_rows_read=ns * Q, c_rows=M, b_itemsize=4,
        spill_nnz=total_nnz, mxu_frac=0.0,
        passes={"x3": 2, "highest": 6, "default": 1}.get(mxu_precision, 1),
    )
    packs = [(*p, first_ptr(p[3])) for p in packs]
    return _stacked(packs, device), GatherOp(M, mxu_precision, roofline)


def _pack_dd_mxu(shards, max_m, device, *, max_panel_bytes=PANEL_CAP_BYTES):
    """The ``dd_mxu`` kind, p = 1 (``dispatch.py:1227-1311``): the ragged
    total cover of :func:`ragged_dd_cover` with fp64 panels filled on the
    device, the stacking discipline of the ragged pack (dummy chunks for
    pad groups, which come out zero).  Refuses as the JAX pack does: a
    spill under the panel cap (``max_panel_bytes``, for
    ``CRP_TPU_RAGGED_PANEL_GB``), the slice-plane cap."""
    if len(shards) != 1:
        raise UnsupportedSparsity(
            "multi-shard dd_mxu packs need p > 1 engines (ROADMAP Queue A #8)"
        )
    rowptr, cc, v = shards[0]
    nnz = int(rowptr[-1]) - int(rowptr[0]) if len(rowptr) > 1 else 0
    if nnz == 0:
        raise UnsupportedSparsity("all shards empty")
    TM, Wc = dd_mxu_geometry(small=device.type == "cpu")
    rowptr64 = np.ascontiguousarray(rowptr, dtype=np.int64)
    cc32 = np.ascontiguousarray(cc, dtype=np.int32)
    G_s = max(-(-(len(rowptr64) - 1) // TM), 1)
    starts_s, group_ptr_s = ragged_dd_cover(rowptr64, cc32, TM, Wc, G_s,
                                            max_panel_bytes)
    G = max(-(-max_m // TM), G_s)
    first_s = np.zeros(len(starts_s), np.int32)
    first_s[group_ptr_s[:-1]] = 1
    a_g, a_first, a_starts, S = _extend_and_stack_steps(
        [(starts_s, np.repeat(np.arange(G_s, dtype=np.int32), np.diff(group_ptr_s)),
          first_s, G_s)],
        G,
    )
    group_ptr = first_ptr(a_first[0])
    panels, _, spill = device_pack.ragged_fill(
        rowptr64, cc32, v, TM, Wc, a_starts[0], group_ptr, "f64", device,
    )
    if len(spill[0]):
        raise UnsupportedSparsity(
            f"dd_mxu total cover infeasible under panel cap ({len(spill[0])} "
            f"nnz would spill)"
        )
    arrays = (
        *(torch.from_numpy(x).to(device) for x in (a_g, a_first, a_starts)),
        panels[None],
        torch.from_numpy(group_ptr[None]).to(device),
    )
    roofline = dict(
        G=G, TM=TM, W=Wc, a_bytes=panels.numel() * panels.element_size(),
        b_rows_read=S * Wc, c_rows=G * TM, b_itemsize=8,
        S=S, spill_nnz=0, mxu_frac=1.0, passes=1,
    )
    return arrays, RaggedOp("dd", int(a_starts.max()) + Wc, "none", "highest",
                            roofline)


def _pack_dd(shards, max_m, device):
    """The ``dd`` kind's non-MXU tier in fp64 (``dispatch.py:236-291``):
    ELL for at most ELL_MAX_L nonzeros per row, else the chunked
    segment-sum.  The JAX package's 4M-nnz cap on the segment-sum tier is
    not kept (see :mod:`.spmm_dd`)."""
    L = _max_row_nnz(shards)
    if L <= ELL_MAX_L:
        packs = [pack_ell_dd(rowptr, cc, v, max_m, L=L) for rowptr, cc, v in shards]
        return _stacked(packs, device), DDOp("ell", max_m)
    nnz_pad = max(max(int(r[-1] - r[0]) for r, _, _ in shards), 1)
    packs = [pack_coo_dd(rowptr, cc, v, nnz_pad, max_m) for rowptr, cc, v in shards]
    return _stacked(packs, device), DDOp("segsum", max_m)


def _tensor_from_jax(x: np.ndarray) -> torch.Tensor:
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint16:  # bf16 bits
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def local_op_from_jax_pack(arrays, min_b_rows: int, device="cpu",
                           roofline: dict | None = None, variant=None):
    """The port's packed tensors and local op for a JAX ``pallas`` pack.

    ``arrays`` are the JAX pack's numpy arrays with their leading shard
    axis, bf16 ones passed as ``.view(np.uint16)``: for a uniform sg pack
    (ws, ah, al, bases) at x3, (ws, ah, bases) for the 1-pass bf16 pack,
    (ws, tiles, bases) for fp32/fp64; for ``variant="ragged"`` the ragged
    pack's (step_g, step_first, starts, *panels, *spill), to which the step
    ranges the CUDA kernels read are appended; for ``variant="gather"`` the
    gather pack's (rel, cols, vals, first, blk), plus ``blk_ptr``, its
    output rows and operating point read from ``roofline`` (G blocks of TM
    rows, passes); for ``variant="dd_mxu"`` the dd_mxu pack's (step_g,
    step_first, starts, mu, slices), whose fp64 panels are rebuilt as
    ``mu * sum_p slice_p * 2**(-7 (p + 1))`` (exact in fp64: 7 slices of 7
    bits and a power-of-two scale).  One pack then feeds both packages.
    """
    roofline = dict(roofline or {})
    if variant == "dd_mxu":
        g, first, starts, mu, sl = (_tensor_from_jax(x).to(device) for x in arrays)
        panels = torch.zeros(sl.shape[0:1] + sl.shape[2:], dtype=torch.float64,
                             device=device)
        for p in range(sl.shape[1]):
            panels += sl[:, p].double() * 2.0 ** (-7 * (p + 1))
        panels *= mu.double()[..., None]
        group_ptr = first_ptr(arrays[1][0])
        roofline.update(a_bytes=panels.numel() * panels.element_size(), passes=1)
        return ((g, first, starts, panels, torch.from_numpy(group_ptr[None]).to(device)),
                RaggedOp("dd", int(min_b_rows), "none", "highest", roofline))
    tensors = tuple(_tensor_from_jax(x).to(device) for x in arrays)
    if variant == "gather":
        blk_ptr = torch.from_numpy(first_ptr(arrays[3][0])[None]).to(device)
        prec = {2: "x3", 6: "highest", 1: "default"}[roofline["passes"]]
        return (*tensors, blk_ptr), GatherOp(roofline["G"] * roofline["TM"], prec,
                                             roofline)
    if variant == "ragged":
        bf = [t.dtype == torch.bfloat16 for t in tensors[3:5]]
        scheme = "x3" if all(bf) and len(bf) == 2 else ("bf16" if bf[0] else "full")
        n_sp = len(tensors) - 3 - (2 if scheme == "x3" else 1)
        spill_impl = {0: "none", 3: "segsum", 5: "pallas"}[n_sp]
        extras = [first_ptr(arrays[1][0])]
        if spill_impl == "pallas":
            extras.append(first_ptr(arrays[-2][0]))
        tensors += tuple(torch.from_numpy(x[None]).to(device) for x in extras)
        prec = {3: "x3", 6: "highest", 1: "default"}[roofline["passes"]]
        return tensors, RaggedOp(scheme, int(min_b_rows), spill_impl, prec, roofline)
    if len(tensors) == 4:
        scheme = "x3"
    elif tensors[1].dtype == torch.bfloat16:
        scheme = "bf16"
    else:
        scheme = "full"
    return tensors, WindowOp(scheme, int(min_b_rows), roofline)
