"""Local-kernel selection and packing shared by the engines.

Counterpart of ``crp_tpu/kernels/dispatch.py``.  A kernel kind packs a
shard's compact CSR into tensors on the engine's device and returns a local
op, ``op(arrays, rB) -> C`` for the shard, where ``arrays`` are the packed
tensors with their leading shard axis stripped.  Ported kinds:

  * ``"segsum"`` — gather + a segment sum in a fixed order (any CSR, any
    device, exact);
  * ``"pallas"`` — the windowed family with the JAX package's gate between
    its two packs: the uniform windows (super-grouped for one shard with
    monotone windows, else the non-super-grouped kernel #4 on fp32 panels,
    at ``x3`` on their bf16 hi/lo pair), or the ragged gathered-window
    chunks (+ spill) where the uniform window is refused or over 3x a
    ragged cover; one pack per operating point (``x3``, ``default``,
    ``highest``; fp64 data takes the panel kernels' fp64 entries, #3, #4
    and #6, all on the FP64 tensor cores);
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

Every kind packs any number of shards into tensors with a leading shard
axis.  ``pallas_halo``, the fused exchange + windowed kernel of the
multi-shard engines, is no local kind: the engines pack it themselves
(``spmm_halo.build_halo_plan``), from the shards' global columns and the
B ownership, and here it refuses (:class:`UnsupportedSparsity`).
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
    plan_supergroups, spmm_window, spmm_window_plain, spmm_window_sg,
    spmm_window_sg_bf16, spmm_window_sg_bf16_plain, spmm_window_sg_plain,
    spmm_window_sg_presplit, spmm_window_sg_presplit_plain, window_extents,
)
from .spmm_ragged import (
    PANEL_CAP_BYTES, SPILL_Q, SPILL_TMO, cover_with_cap, default_min_chunk_nnz,
    estimate_ragged, first_ptr, gather_step_layout, pack_gather_blocks,
    pack_spill, pack_spill_blocks, resolve_ragged_geometry, row_view_sizes,
    row_view_sizes_of_counts, spill_row_view,
    spmm_gather, spmm_gather_plain, spmm_ragged, spmm_ragged_bf16,
    spmm_ragged_bf16_plain, spmm_ragged_plain, spmm_ragged_presplit,
    spmm_ragged_presplit_plain, spmm_spill, spmm_spill_chunked, spmm_spill_plain,
    stack_row_views,
)
from .spmm_segsum import pack_device_csr, spmm_segment_sum

logger = logging.getLogger("crp_tpu_torch")

def resolve_auto_kernel(device, nshards: int = 1, *, overlap: bool = False,
                        allow_halo: bool = True) -> str:
    """``kernel="auto"`` (``dispatch.py:30-62``): on a CUDA device the fused
    ``"pallas_halo"`` for multi-shard engines (unless ``overlap`` asks for
    the ring schedule, or ``allow_halo`` is False, as the autodiff op and
    ``CrpSpmm``'s finegrain exchange ask) and ``"pallas"`` otherwise;
    ``"segsum"`` elsewhere, as JAX picks segsum off the TPU.  The engines
    land on ``"pallas"`` where the halo plan refuses.

    The JAX package sends fp64 data on the TPU to ``dd``; here fp64 runs
    natively in the panel kernels' fp64 entries, #3, #4, #6 and #12, all
    on the FP64 tensor cores (#11's DMMA body).
    """
    if torch.device(device).type != "cuda":
        return "segsum"
    return "pallas_halo" if allow_halo and not overlap and nshards > 1 else "pallas"


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
    fallback: list | None = None, rank: int | None = None,
) -> tuple:
    """:func:`pack_local_kernel` plus the sparsity-fallback walk
    (``dispatch.py:106-150``).  Returns ``(arrays, op, resolved_kind)``.
    After a failed ``dd_mxu`` pack the ``dd`` retry skips the MXU cover
    (``dd_skip_mxu``) rather than repeat it only to fail again."""
    try:
        arrays, op = pack_local_kernel(
            shards, max_m, dtype, kind, device=device,
            mxu_precision=mxu_precision, rank=rank,
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
                mxu_precision=mxu_precision, rank=rank, **extra,
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
    cols, vals, first, blk), then the pack's row-ordered view (vcols,
    vvals, items, parts; :func:`_row_views`), which the CUDA kernel reads.
    ``M`` output rows (``max_m`` rounded up to TMo, the roofline's
    ``TM``)."""

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
        rel, cols, vals, _, blk, *view = arrs
        return (rel, cols, vals, blk, self.roofline["TM"], rB, self.M,
                self.mxu_precision, tuple(view))

    def __call__(self, arrs, rB):
        # rows past the shard's own are zero: engines trim them
        return self.kernel(*self.kernel_args(arrs, rB)).to(rB.dtype)


@dataclasses.dataclass
class WindowOp:
    """Local op of the ``pallas`` kind on a uniform windowed pack.

    ``scheme`` picks the kernel and the arrays it reads.  On a
    super-grouped pack (variant ``"uniform"``): ``"x3"`` (ws, ah, al,
    bases), ``"bf16"`` (ws, ah, bases), ``"tf32"`` (ws, planes, bases) on
    fp32 at ``highest``, ``"full"`` (ws, tiles, bases) on fp64; ``bases``
    stays in the pack for parity with the JAX pack, the Hopper kernels read
    only ``ws``.  On a pack with no super-group plan (variant ``"window"``,
    every multi-shard pack): ``"window"`` (ws, tiles), fp64 panels; on fp32
    ``"window_x3"`` (ws, ah, al) at ``x3``, the panels split to their bf16
    hi/lo pair once at pack time, ``"window_bf16"`` (ws, ah) at
    ``default``, the panels rounded to their bf16 hi plane once at pack
    time, and ``"window_tf32"`` (ws, planes) at ``highest``, the panels
    split to their TF32 big/small planes once at pack time (``(2, G, TM,
    W)`` a shard, ``device_pack.tf32_operands``), as kernel #4's ``wgmma``
    body reads them (TMA copies and can neither split nor round, and the
    tensor cores truncate an fp32 operand; the kernel's arguments take the
    pair as one ``(ah, al)``, and B cast to bf16 beside the plane).
    ``min_b_rows``: rows rB must have.
    """

    scheme: str
    min_b_rows: int
    roofline: dict = dataclasses.field(default_factory=dict)
    precision: str = "highest"

    @property
    def variant(self) -> str:
        return "window" if self.scheme.startswith("window") else "uniform"

    @property
    def kernel(self):
        """The kernel wrapper this op launches."""
        return {
            "x3": spmm_window_sg_presplit,
            "bf16": spmm_window_sg_bf16,
            "full": spmm_window_sg,
            "tf32": spmm_window_sg,
            "window": spmm_window,
            "window_x3": spmm_window,
            "window_bf16": spmm_window,
            "window_tf32": spmm_window,
        }[self.scheme]

    @property
    def plain(self):
        """The kernel's plain PyTorch version (same positional args)."""
        return {
            "x3": spmm_window_sg_presplit_plain,
            "bf16": spmm_window_sg_bf16_plain,
            "full": spmm_window_sg_plain,
            "tf32": spmm_window_sg_plain,
            "window": spmm_window_plain,
            "window_x3": spmm_window_plain,
            "window_bf16": spmm_window_plain,
            "window_tf32": spmm_window_plain,
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
        if self.scheme in ("window", "window_tf32"):
            ws, tiles = arrs
            return ws, tiles, rB, self.precision
        if self.scheme == "window_x3":
            ws, ah, al = arrs
            return ws, (ah, al), rB, self.precision
        if self.scheme == "window_bf16":
            ws, ah = arrs
            return ws, ah, rB.to(torch.bfloat16), self.precision
        ws, tiles, _ = arrs
        return ws, tiles, rB

    def __call__(self, arrs, rB):
        c = self.kernel(*self.kernel_args(arrs, rB), min_b_rows=self.min_b_rows)
        # rows past the shard's own are zero panels: engines trim them
        return c.to(rB.dtype)


def _row_views(rel, cols, vals, blk, M: int, TMo: int) -> tuple:
    """The row-ordered views (:func:`spill_row_view`) of a stacked
    block-step pack's shards, stacked (:func:`stack_row_views`), built on
    the pack's device."""
    return stack_row_views([spill_row_view(rel[i], cols[i], vals[i], blk[i], M, TMo)
                            for i in range(rel.shape[0])])


def _rank_row_views(host, M: int, TMo: int, rank: int, device) -> tuple:
    """A mesh rank's slice of :func:`_row_views`: ``host`` the stacked
    block-step pack's ``(rel, cols, vals, blk)`` numpy arrays of every
    shard.  Each shard's view is built on the host in turn, for the
    padding the stacked views share (a view is integer work and copies:
    the same arrays on every device), and the rank's alone goes to
    ``device``, so that the rank's init holds no other shard's view nor
    its own view's temporaries there."""
    sizes, mine = [0] * 4, None
    for i in range(host[0].shape[0]):
        view = spill_row_view(*(torch.from_numpy(x[i]) for x in host), M, TMo)
        sizes = [max(a, b) for a, b in zip(sizes, row_view_sizes([view]))]
        if i == rank:
            mine = view
        del view
    return tuple(x.to(device) for x in stack_row_views([mine], sizes))


def _stacked(packs, device, rank=None) -> tuple:
    """Per-shard tuples of numpy arrays -> tensors on ``device`` with a
    leading shard axis; ``rank``: that shard's alone (a mesh rank's
    slice)."""
    if rank is not None:
        packs = packs[rank : rank + 1]
    return tuple(
        torch.from_numpy(np.stack([p[i] for p in packs])).to(device)
        for i in range(len(packs[0]))
    )


def _kept(x: np.ndarray, rank) -> np.ndarray:
    """A stacked host array, or a mesh rank's slice of it."""
    return x if rank is None else x[rank : rank + 1]


def _stack(tensors: list) -> torch.Tensor:
    """Per-shard tensors with a leading shard axis (one shard: a view)."""
    return tensors[0][None] if len(tensors) == 1 else torch.stack(tensors)


def _max_row_nnz(shards) -> int:
    """The largest row of any shard, at least 1: the ELL slot count."""
    return max(
        max((int(np.diff(r).max()) if len(r) > 1 else 0) for r, _, _ in shards), 1
    )


def pack_local_kernel(
    shards: list, max_m: int, dtype, kind: str = "segsum", *, device,
    mxu_precision: str = "highest", dd_skip_mxu: bool = False,
    rank: int | None = None,
) -> tuple:
    """Pack shards ``[(rowptr, compact_colidx, val), ...]`` for ``kind``
    (``dispatch.py:153-293``).  Returns ``(arrays, op)``: tensors on
    ``device`` with a leading shard axis, and the local op.
    ``dd_skip_mxu`` sends ``kind="dd"`` straight to its non-MXU tier.
    ``rank``: a mesh rank's pack, slice [rank] of the stacked one bit for
    bit with the same op: the geometry comes from every shard, and only
    that shard's arrays go to ``device`` (the others' spills are made one
    at a time, on the host or briefly on the device, their row views on
    the host; the ``gather`` kind sizes those from their rows' counts and
    packs that shard alone)."""
    device = torch.device(device)
    if kind == "segsum":
        nnz_pad = max(max(int(r[-1] - r[0]) for r, _, _ in shards), 1)
        packs = [
            pack_device_csr(rowptr, cc, v.astype(dtype), nnz_pad, nrow=max_m)
            for rowptr, cc, v in shards
        ]
        return _stacked(packs, device, rank), SegsumOp(max_m)
    if kind == "ell":
        L = _max_row_nnz(shards)
        packs = [pack_ell(rowptr, cc, v.astype(dtype), max_m, L=L)
                 for rowptr, cc, v in shards]
        return _stacked(packs, device, rank), EllOp()
    if kind == "pallas":
        return _pack_pallas(shards, max_m, dtype, mxu_precision, device, rank)
    if kind == "ragged":
        return _pack_ragged(shards, max_m, dtype, mxu_precision, device, rank=rank)
    if kind == "gather":
        return _pack_gather(shards, max_m, dtype, mxu_precision, device, rank=rank)
    if kind == "dd_mxu":
        return _pack_dd_mxu(shards, max_m, device, rank=rank)
    if kind == "dd":
        # on a CUDA device the FP64 tensor cores where the total cover fits,
        # as the JAX package takes its MXU tier on a TPU; the CPU goes
        # straight to the non-MXU tier, as JAX does off the TPU
        if device.type == "cuda" and not dd_skip_mxu:
            try:
                return _pack_dd_mxu(shards, max_m, device, rank=rank)
            except UnsupportedSparsity:
                pass
        return _pack_dd(shards, max_m, device, rank)
    if kind == "pallas_halo":
        raise UnsupportedSparsity(
            "kernel kind 'pallas_halo' is packed by the engines "
            "(spmm_halo.build_halo_plan), not as a local kernel"
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


def _largest_shard(shards):
    """The shard with the most nonzeros (the ragged geometry is resolved
    on it, ``dispatch.py:359-373``), or None when no shard has a row."""
    return max((s for s in shards if len(s[0]) > 1),
               key=lambda s: int(s[0][-1]) - int(s[0][0]), default=None)


def _pack_pallas(shards, max_m, dtype, mxu_precision, device, rank=None):
    """The ``pallas`` kind: the JAX package's gate between the uniform
    windowed pack and the ragged family (``dispatch.py:330-392``).

    Windows over 16384 rows go straight to ragged.  Wide windows (over
    4096 rows, or uniform panels over 1 GiB summed over the shards) price a
    ragged cover at the geometry the ragged pack would use (resolved once
    on the largest shard, the ragged bytes summed over the shards) and take
    it when the uniform pack is over 3x larger, landing back on the uniform
    pack if the ragged one refuses.  Any uniform refusal (a window over the
    cap, per-row-unsorted columns) goes to ragged.  ``device.type ==
    "cpu"`` stands where JAX has ``interpret``, so CPU packs equal the JAX
    CPU packs.
    """
    W_est, G_est, uniform_ok = _uniform_cost_estimate(shards, max_m)
    if not uniform_ok:
        return _pack_ragged(shards, max_m, dtype, mxu_precision, device, rank=rank)
    itemsize = np.dtype(dtype).itemsize
    bytes_uniform = len(shards) * G_est * 256 * W_est * itemsize
    if W_est > 4096 or bytes_uniform > (1 << 30):
        big = _largest_shard(shards)
        if big is None:
            # no shard has a row: the uniform pack refuses the degenerate
            # shards itself
            return _pack_pallas_uniform(shards, max_m, dtype, mxu_precision, device,
                                        rank)
        geometry = resolve_ragged_geometry(
            big[0], big[1], mxu_precision, small=device.type == "cpu"
        )
        bytes_ragged = 0
        for rowptr, cc, _ in shards:
            if len(rowptr) < 2 or int(rowptr[-1]) == int(rowptr[0]):
                continue
            S, _, _ = estimate_ragged(rowptr, cc, *geometry)
            bytes_ragged += S * geometry[0] * geometry[1] * itemsize
        if bytes_uniform > 3 * max(bytes_ragged, 1):
            try:
                return _pack_ragged(shards, max_m, dtype, mxu_precision, device,
                                    geometry=geometry, rank=rank)
            except UnsupportedSparsity:
                pass  # ragged not worthwhile either; try uniform below
    try:
        return _pack_pallas_uniform(shards, max_m, dtype, mxu_precision, device, rank)
    except UnsupportedSparsity:
        return _pack_ragged(shards, max_m, dtype, mxu_precision, device, rank=rank)


def _pack_pallas_uniform(shards, max_m, dtype, mxu_precision, device, rank=None):
    """The uniform windowed pack (``dispatch.py:611-812``): one shard with a
    super-group plan takes the super-grouped kernels; several shards, or
    one with no plan (non-monotone windows), take the non-super-grouped
    kernel #4 on fp32 (or fp64) panels, at x3 on their bf16 hi/lo pair."""
    dt = np.dtype(dtype)
    if dt not in (np.float32, np.float64):
        raise UnsupportedSparsity(f"no windowed kernel for dtype {dt}")
    if len(shards) == 1:
        if dt == np.float32 and mxu_precision in ("default", "x3"):
            got = _pack_uniform_single_bf16(shards[0], max_m, mxu_precision, device)
        else:
            got = _pack_uniform_single_full(shards[0], max_m, dt, mxu_precision,
                                            device)
        if got is not None:
            return got
    return _pack_window(shards, max_m, dt, mxu_precision, device, rank)


def _shard_window(shard, TM, tile_itemsize):
    """(ws, W, G) of one shard's own uniform pack (``pack_window_dense``,
    ``spmm_pallas.py:124-158``), None for an empty shard; raises where that
    pack refuses (a window over 16384 rows, panels over 8 GiB)."""
    rowptr, cc, _ = shard
    if len(rowptr) < 2 or int(rowptr[-1]) - int(rowptr[0]) == 0:
        return None
    max_window = 16384
    nrow = len(rowptr) - 1
    rowptr64 = np.ascontiguousarray(rowptr, dtype=np.int64)
    min_t, W0 = window_extents(rowptr64, cc, TM)
    if W0 > max_window:
        raise UnsupportedSparsity(f"window {W0} rows > cap {max_window}")
    W, _, _ = choose_chunks(W0)
    G = -(-nrow // TM)
    if G * W * TM * tile_itemsize > (8 << 30):
        raise UnsupportedSparsity(
            f"dense window tiles {(G * W * TM * tile_itemsize) >> 20} MiB > cap"
        )
    return (min_t * TK).astype(np.int32), W, G


def _window_geometry(shard, max_m, win_itemsize, tile_itemsize, device):
    """Window extents, padding and super-group plan of one shard
    (``dispatch.py:450-473``); None where the JAX pack has no sg plan."""
    TM = 256
    got = _shard_window(shard, TM, tile_itemsize)
    if got is None:
        raise UnsupportedSparsity("all shards empty")
    ws_shard, W, G0 = got
    G = max(G0, -(-max_m // TM))
    sg = _sg_geometry(ws_shard, W, win_itemsize, device.type == "cpu", G)
    if sg is None:
        return None
    rowptr64 = np.ascontiguousarray(shard[0], dtype=np.int64)
    return rowptr64, len(rowptr64) - 1, TM, W, G0, ws_shard, sg


def _pack_window(shards, max_m, dtype, mxu_precision, device, rank=None):
    """The pack of kernel #4 (``dispatch.py:633-668,793-812``): each
    shard's window panels at a shared chunk-exact W and group count G,
    ``(p, G, TM, W)`` panels densified on the device; an empty shard gets
    zero panels with ``ws`` 0.  On fp32 at ``x3`` the panels are split to
    their bf16 hi/lo pair once here, at ``default`` rounded to their bf16
    hi plane (``device_pack.split_bf16`` of the JAX pack's fp32 panels, bit
    for bit: the split and the rounding the TPU kernel makes on every read,
    which TMA cannot make), and at ``highest`` split to their TF32 planes,
    ``(p, 2, G, TM, W)`` (``device_pack.tf32_operands``: the big and small
    operand bits of the 3xTF32 split), densified slab by slab; in fp64
    they stay fp64 (the JAX pack).  The 8 GiB cap prices the pack's own
    dtype, as JAX's does.  ``a_bytes`` counts the panels held: the pair is
    the bytes of one fp32 plane, the hi plane half of them (and B is then
    read in bf16, as JAX's #2 pack counts it), the TF32 planes twice
    them."""
    TM = 256
    itemsize = np.dtype(dtype).itemsize
    got = [_shard_window(s, TM, itemsize) for s in shards]
    real = [g for g in got if g is not None]
    if not real:
        raise UnsupportedSparsity("all shards empty")
    G = max(max(g[2] for g in real), -(-max_m // TM))
    W, _, _ = choose_chunks(max(g[1] for g in real))
    mode = device_pack.panel_mode(dtype, mxu_precision)
    ws, ah, al = device_pack.uniform_fill_stacked(
        shards, [None if g is None else g[0] for g in got], TM, W, G, mode, device,
        keep=rank,
    )
    panels = (ah, al) if mode == "pair" else (ah,)
    shares = len(shards) if rank is not None else 1  # a rank holds one shard's panels
    roofline = dict(
        G=G, TM=TM, W=W,
        a_bytes=shares * sum(t.numel() * t.element_size() for t in panels),
        b_rows_read=G * W, c_rows=G * TM, b_itemsize=2 if mode == "bf16" else itemsize,
        passes={"x3": 3, "highest": 6, "default": 1}.get(mxu_precision, 1),
    )
    scheme = {"pair": "window_x3", "bf16": "window_bf16", "tf32": "window_tf32"}.get(
        mode, "window")
    return ((torch.from_numpy(_kept(ws, rank)).to(device), *panels),
            WindowOp(scheme, int(ws.max()) + W, roofline, mxu_precision))


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
    TPU); None where the shard has no super-group plan."""
    split = mxu_precision == "x3"
    geo = _window_geometry(shard, max_m, 4 if split else 2, 4, device)
    if geo is None:
        return None
    rowptr64, nrow, TM, W, G0, ws_shard, sg = geo
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
    """fp32 ``highest`` and fp64 data (``dispatch.py:543-608``, and the
    generic sg pack of ``:633-791`` for fp64), densified on the device:
    fp64 panels, or on fp32 their TF32 planes ``(2, G, TM, W)`` (scheme
    ``"tf32"``, as :func:`_pack_window`'s at ``highest``; JAX's fp32 panels
    come back from them bit for bit); None where the shard has no
    super-group plan.  The geometry and its 8 GiB cap price the pack's
    dtype, as JAX's does."""
    itemsize = np.dtype(dtype).itemsize
    geo = _window_geometry(shard, max_m, itemsize, itemsize, device)
    if geo is None:
        return None
    rowptr64, nrow, TM, W, G0, ws_shard, sg = geo
    ws_full, tiles, _ = device_pack.uniform_fill(
        rowptr64, shard[1], shard[2], nrow, TM, W, sg[4], ws_shard,
        "f64" if itemsize == 8 else "tf32", device,
    )
    passes = {"x3": 3, "highest": 6, "default": 1}.get(mxu_precision, 1)
    return _finish_window_pack(
        "full" if itemsize == 8 else "tf32", ws_full, (tiles,), G0, TM, W, sg, itemsize,
        passes, device
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
    *spill), then the step ranges the ragged kernels read, ``group_ptr``
    (:func:`first_ptr` of ``step_first``), and for the fused spill its
    row-ordered view (vcols, vvals, items, parts; :func:`_row_views`),
    which its kernel reads; ``spill_tmo`` is that spill's block height
    TMo.  ``scheme``
    picks the ragged kernel: ``"x3"`` (ah, al), ``"bf16"`` (ah), ``"tf32"``
    (big, small: fp32 at ``highest``, the panels split to their TF32
    planes once at pack time, ``device_pack.tf32_operands``, each ``(S,
    TM, Wc)`` a shard, which the kernel takes as one ``(big, small)``
    argument; three TF32 products on the ``wgmma`` body's TF32 mode),
    ``"full"`` (fp64 panels on the FP64 tensor cores) or ``"dd"`` (fp64
    panels of the ``dd_mxu`` total cover, FP64 tensor cores; its variant
    is ``"dd_mxu"``).  ``spill_impl``:
    ``"none"``, ``"segsum"`` (rows, cols, vals; the ``segsum`` kind's
    fixed-order sum) or
    ``"pallas"`` (rel, cols, vals, first, blk; the fused spill kernel).
    """

    scheme: str
    min_b_rows: int
    spill_impl: str
    mxu_precision: str
    roofline: dict = dataclasses.field(default_factory=dict)
    spill_tmo: int = 0

    @property
    def variant(self) -> str:
        return "dd_mxu" if self.scheme == "dd" else "ragged"

    @property
    def n_panels(self) -> int:
        return 2 if self.scheme in ("x3", "tf32") else 1

    @property
    def kernel(self):
        """The ragged kernel wrapper this op launches."""
        return {
            "x3": spmm_ragged_presplit,
            "bf16": spmm_ragged_bf16,
            "tf32": spmm_ragged,
            "full": spmm_ragged,
            "dd": spmm_ragged_dd,
        }[self.scheme]

    @property
    def plain(self):
        """The ragged kernel's plain PyTorch version (same positional args)."""
        return {
            "x3": spmm_ragged_presplit_plain,
            "bf16": spmm_ragged_bf16_plain,
            "tf32": spmm_ragged_plain,
            "full": spmm_ragged_plain,
            "dd": spmm_ragged_plain,
        }[self.scheme]

    spill_kernel = staticmethod(spmm_spill)
    spill_plain = staticmethod(spmm_spill_plain)

    def _spill_arrays(self, arrs):
        k = 3 + self.n_panels
        return arrs[k : k + {"none": 0, "segsum": 3, "pallas": 5}[self.spill_impl]]

    def _ptrs(self, arrs):
        """The arrays after the JAX pack's: group_ptr, then for the fused
        spill its view."""
        return arrs[3 + self.n_panels + len(self._spill_arrays(arrs)):]

    def kernel_args(self, arrs, rB) -> tuple:
        """Positional args of :attr:`kernel` and :attr:`plain` for one
        shard's ``arrs`` and receive buffer ``rB`` (the TF32 planes as one
        ``(big, small)`` argument)."""
        b = rB.to(torch.bfloat16) if self.scheme == "bf16" else rB
        panels = arrs[3 : 3 + self.n_panels]
        if self.scheme == "tf32":
            panels = (tuple(panels),)
        return (arrs[0], self._ptrs(arrs)[0], arrs[2], *panels, b)

    def spill_args(self, arrs, c, rB) -> tuple:
        """Positional args of :attr:`spill_kernel` and :attr:`spill_plain`
        (the ``pallas`` spill) for the ragged kernel's output ``c``."""
        rel, cols, vals, _, blk = self._spill_arrays(arrs)
        _, *view = self._ptrs(arrs)
        return (c, rel, cols, vals, blk, self.spill_tmo, rB, self.mxu_precision,
                tuple(view))

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


def _group_ptrs(a_first, steps, G) -> np.ndarray:
    """Each shard's group ranges (:func:`first_ptr` of its ``first`` row),
    the last range ending at the shard's own steps: the trailing no-op
    steps that pad a shard to the common S carry zero panels, and a CUDA
    block would otherwise walk all of them for the last group."""
    ptr = np.stack([first_ptr(f) for f in a_first])
    ptr[:, -1] = [G if st is None else len(st[0]) + max(G - st[3], 0) for st in steps]
    return ptr


def _pack_ragged(shards, max_m, dtype, mxu_precision, device, *, geometry=None,
                 min_chunk_nnz=None, spill_impl="auto", TMo=SPILL_TMO, Q=SPILL_Q,
                 rank=None):
    """Ragged gathered-window pack (``dispatch.py:856-1158``), any number
    of shards.

    Keyword arguments stand for the JAX package's environment knobs, with
    its defaults: ``geometry`` (TM, Wc) (``CRP_TPU_RAGGED_TM``/``_WC``; None:
    the model picks, on the largest shard), ``min_chunk_nnz``
    (``CRP_TPU_RAGGED_MIN_NNZ``; None: the break-even model), ``spill_impl``
    (``CRP_TPU_SPILL_IMPL``: "auto", "segsum" or "pallas"), ``TMo``/``Q``
    (``CRP_TPU_SPILL_TMO``/``_Q``).  "auto" takes the fused spill kernel
    for a dense spill (the largest shard spill Z at least one nnz per
    output row) of an fp32 pack on a CUDA device, and ``segsum`` otherwise.
    Shards share (TM, Wc), the group count G and the step count S (dummy
    chunks and trailing no-op steps); every shard's spill arrays are padded
    to Z (``segsum``) or to the largest step count (``pallas``), and its
    ``group_ptr`` and the spill's row-ordered view (built on ``device``,
    each shard's padded to the longest) are its own.  Raises
    UnsupportedSparsity when the covers keep under 30% of all nonzeros in
    panels; where the covers' own counts settle that, before any panel is
    filled.  ``rank``: a mesh rank's slice (:func:`pack_local_kernel`); the
    other shards' spills come from their host placement alone.  The panels
    are densified on the device straight to what the kernel reads: on fp32
    the bf16 hi/lo pair at ``x3``, the hi plane at ``default`` and the TF32
    planes at ``highest`` (two ``(p, S, TM, Wc)`` tensors, big and small,
    ``device_pack.tf32_operands``), slab by slab; the cap prices fp32
    all the same, as JAX's pack does, and ``a_bytes`` counts what is held.
    """
    if spill_impl not in SPILL_IMPLS:
        raise ValueError(f"spill_impl={spill_impl!r} not in {SPILL_IMPLS}")
    total_nnz = sum(int(r[-1]) - int(r[0]) if len(r) > 1 else 0 for r, _, _ in shards)
    if total_nnz == 0:
        raise UnsupportedSparsity("all shards empty")
    if geometry is None:
        big = _largest_shard(shards)
        geometry = resolve_ragged_geometry(
            big[0], big[1], mxu_precision, small=device.type == "cpu"
        )
    TM, Wc = geometry
    pack_dtype = np.float64 if np.dtype(dtype) == np.float64 else np.float32
    mode = device_pack.panel_mode(dtype, mxu_precision)
    if min_chunk_nnz is None:
        min_chunk_nnz = default_min_chunk_nnz(TM, Wc)

    # per shard: (rowptr64, cc32, v, nnz) and its cover, None when empty
    prepared, steps = [], []
    keep_bound = 0
    for rowptr, cc, v in shards:
        nnz = int(rowptr[-1]) - int(rowptr[0]) if len(rowptr) > 1 else 0
        if nnz == 0:
            prepared.append(None)
            steps.append(None)
            continue
        rowptr64 = np.ascontiguousarray(rowptr, dtype=np.int64)
        cc32 = np.ascontiguousarray(cc, dtype=np.int32)
        G_s = max(-(-(len(rowptr64) - 1) // TM), 1)
        # the split modes cap at fp32 bytes, as the JAX direct-bf16 pack does
        starts_s, group_ptr_s, spill_s = cover_with_cap(
            rowptr64, cc32, TM, Wc, min_chunk_nnz, G_s, PANEL_CAP_BYTES,
            np.dtype(pack_dtype).itemsize,
        )
        # The keep share before the fill.  A cover's spill count bounds its
        # fill's from above: a group that keeps no chunk gets a dummy chunk
        # over [0, Wc), which takes back its nonzeros there.  So with every
        # column below Wc taken back, covers still under the share are
        # refused here, uploading no panel; the fills' own counts decide
        # the rest (below), as in the JAX pack.
        keep_bound += nnz - spill_s + int(np.count_nonzero(cc32[:nnz] < Wc))
        first_s = np.zeros(len(starts_s), np.int32)
        first_s[group_ptr_s[:-1]] = 1
        step_g = np.repeat(np.arange(G_s, dtype=np.int32), np.diff(group_ptr_s))
        prepared.append((rowptr64, cc32, v, nnz))
        steps.append((starts_s, step_g, first_s, G_s))
    _check_keep_share(keep_bound, total_nnz)
    G = max(-(-max_m // TM), max(st[3] for st in steps if st is not None))
    a_g, a_first, a_starts, S = _extend_and_stack_steps(steps, G)
    group_ptr = _group_ptrs(a_first, steps, G)

    # the pad groups' dummy chunks are part of the fill: their panels are
    # zero.  Each shard fills its own slice of the stacked planes in place.
    panel_dtype = torch.bfloat16 if mode in ("pair", "bf16") else (
        torch.float64 if mode == "f64" else torch.float32)
    held = range(len(shards)) if rank is None else [rank]
    panels = tuple(torch.empty((len(held), S, TM, Wc), dtype=panel_dtype, device=device)
                   for _ in range(2 if mode in ("pair", "tf32") else 1))
    spills = []
    for i, sh in enumerate(prepared):
        slot = i if rank is None else 0
        if sh is None:
            if i in held:
                device_pack.zero_panels([t[slot] for t in panels], mode)
            spills.append(None)
            continue
        rowptr64, cc32, v, _ = sh
        if i in held:
            *_, spill = device_pack.ragged_fill(
                rowptr64, cc32, v, TM, Wc, a_starts[i], group_ptr[i], mode, device,
                out=tuple(t[slot] for t in panels),
            )
        else:
            spill = device_pack.ragged_place(rowptr64, cc32, v, TM, Wc, a_starts[i],
                                             group_ptr[i], mode)[3]
        spills.append(spill)
    Z = max((len(s[0]) for s in spills if s is not None), default=0)
    spill_nnz = sum(len(s[0]) for s in spills if s is not None)
    mxu_nnz = total_nnz - spill_nnz
    _check_keep_share(mxu_nnz, total_nnz)

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
        nblk = G * TM // TMo
        sorted_spills, ns = [], []
        for s in spills:
            n_steps = nblk
            if s is not None:
                r, c, vv = s
                # (block, column) order: the B gather walks near-monotonically
                order = np.lexsort((c, r // TMo))
                s = r[order], c[order], vv[order]
                counts = np.bincount(s[0] // TMo, minlength=nblk)
                n_steps = int(np.maximum(-(-counts // Q), 1).sum())
            sorted_spills.append(s)
            ns.append(n_steps)
        per = [pack_spill_blocks(s, max(ns), G * TM, pack_dtype, TMo=TMo, Q=Q)
               for s in sorted_spills]
        sp_arrays = tuple(np.stack([x[k] for x in per]) for k in range(5))
    elif Z:
        per = [pack_spill(s, Z, G * TM, pack_dtype) for s in spills]
        sp_arrays = tuple(np.stack([x[k] for x in per]) for k in range(3))

    a_bytes = len(shards) // len(held) * sum(p.numel() * p.element_size() for p in panels)
    arrays = (
        *(torch.from_numpy(_kept(x, rank)).to(device) for x in (a_g, a_first, a_starts)),
        *panels,
        *(torch.from_numpy(_kept(x, rank)).to(device) for x in (*sp_arrays, *extras)),
    )
    if Z and sp_impl == "pallas" and rank is not None:
        rel, cols, vals, _, blk = sp_arrays
        arrays += _rank_row_views((rel, cols, vals, blk), G * TM, TMo, rank, device)
    elif Z and sp_impl == "pallas":
        rel, cols, vals, _, blk = arrays[-6:-1]
        arrays += _row_views(rel, cols, vals, blk, G * TM, TMo)
    scheme = {"pair": "x3", "bf16": "bf16", "tf32": "tf32"}.get(mode, "full")
    roofline = dict(
        G=G, TM=TM, W=Wc, a_bytes=a_bytes,
        b_rows_read=S * Wc, c_rows=G * TM,
        b_itemsize=2 if mode == "bf16" else np.dtype(dtype).itemsize,
        S=S, spill_nnz=spill_nnz, spill_max=Z, spill_impl=sp_impl,
        mxu_frac=mxu_nnz / total_nnz,
        passes={"x3": 3, "highest": 6, "default": 1}.get(mxu_precision, 1),
    )
    op = RaggedOp(scheme, int(a_starts.max()) + Wc,
                  sp_impl if Z else "none", mxu_precision, roofline,
                  TMo if Z and sp_impl == "pallas" else 0)
    return arrays, op


def _pack_gather(shards, max_m, dtype, mxu_precision, device, *, TMo=SPILL_TMO,
                 Q=SPILL_Q, rank=None):
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
    # a mesh rank packs its own shard alone: every shard's pack has the step
    # layout's shapes, and its view's lengths follow from its rows' counts
    packs = [
        pack_gather_blocks(rowptr, cc, v, step_base, M, TMo=TMo, Q=Q)
        for rowptr, cc, v in (shards if rank is None else shards[rank : rank + 1])
    ]
    ns = int(step_base[-1])
    roofline = dict(
        G=nblk, TM=TMo, W=Q, S=ns,
        a_bytes=len(shards) // len(packs) * sum(x.nbytes for p in packs for x in p),
        b_rows_read=ns * Q, c_rows=M, b_itemsize=4,
        spill_nnz=total_nnz, mxu_frac=0.0,
        passes={"x3": 2, "highest": 6, "default": 1}.get(mxu_precision, 1),
    )
    arrays = _stacked(packs, device)
    if rank is None:
        arrays += _row_views(*arrays[:3], arrays[4], M, TMo)
    else:  # the view built on the host, padded as the stacked views are
        sizes = [max(x) for x in zip(*(row_view_sizes_of_counts(np.diff(rowptr), M)
                                       for rowptr, _, _ in shards))]
        view = spill_row_view(*(torch.from_numpy(packs[0][k]) for k in (0, 1, 2, 4)), M, TMo)
        arrays += tuple(x.to(device) for x in stack_row_views([view], sizes))
    return arrays, GatherOp(M, mxu_precision, roofline)


def _pack_dd_mxu(shards, max_m, device, *, max_panel_bytes=PANEL_CAP_BYTES, rank=None):
    """The ``dd_mxu`` kind (``dispatch.py:1227-1311``): each shard's ragged
    total cover (:func:`ragged_dd_cover`) with fp64 panels filled on the
    device, stacked as the ragged pack stacks (dummy chunks for pad groups
    and empty shards, which come out zero; per-shard ``group_ptr``).
    Refuses as the JAX pack does, on any shard: a spill under the panel cap
    (``max_panel_bytes``, for ``CRP_TPU_RAGGED_PANEL_GB``), the slice-plane
    cap.  ``rank``: a mesh rank's slice; the other shards' spills are
    checked from their host placement alone."""
    TM, Wc = dd_mxu_geometry(small=device.type == "cpu")
    prepared, steps = [], []
    for rowptr, cc, v in shards:
        nnz = int(rowptr[-1]) - int(rowptr[0]) if len(rowptr) > 1 else 0
        if nnz == 0:
            prepared.append(None)
            steps.append(None)
            continue
        rowptr64 = np.ascontiguousarray(rowptr, dtype=np.int64)
        cc32 = np.ascontiguousarray(cc, dtype=np.int32)
        G_s = max(-(-(len(rowptr64) - 1) // TM), 1)
        starts_s, group_ptr_s = ragged_dd_cover(rowptr64, cc32, TM, Wc, G_s,
                                                max_panel_bytes)
        first_s = np.zeros(len(starts_s), np.int32)
        first_s[group_ptr_s[:-1]] = 1
        prepared.append((rowptr64, cc32, v))
        steps.append((starts_s, np.repeat(np.arange(G_s, dtype=np.int32),
                                          np.diff(group_ptr_s)), first_s, G_s))
    if all(st is None for st in steps):
        raise UnsupportedSparsity("all shards empty")
    G = max(-(-max_m // TM), max(st[3] for st in steps if st is not None))
    a_g, a_first, a_starts, S = _extend_and_stack_steps(steps, G)
    group_ptr = _group_ptrs(a_first, steps, G)
    per = []
    for i, sh in enumerate(prepared):
        held = rank is None or i == rank
        if sh is None:
            if held:
                per.append(torch.zeros((S, TM, Wc), dtype=torch.float64, device=device))
            continue
        if held:
            panels_i, _, spill = device_pack.ragged_fill(
                *sh, TM, Wc, a_starts[i], group_ptr[i], "f64", device,
            )
        else:
            spill = device_pack.ragged_place(*sh, TM, Wc, a_starts[i], group_ptr[i],
                                             "f64")[3]
        if len(spill[0]):
            raise UnsupportedSparsity(
                f"dd_mxu total cover infeasible under panel cap ({len(spill[0])} "
                f"nnz would spill)"
            )
        if held:
            per.append(panels_i)
    panels = _stack(per)
    del per
    arrays = (
        *(torch.from_numpy(_kept(x, rank)).to(device) for x in (a_g, a_first, a_starts)),
        panels,
        torch.from_numpy(_kept(group_ptr, rank)).to(device),
    )
    roofline = dict(
        G=G, TM=TM, W=Wc,
        a_bytes=len(shards) // panels.shape[0] * panels.numel() * panels.element_size(),
        b_rows_read=S * Wc, c_rows=G * TM, b_itemsize=8,
        S=S, spill_nnz=0, mxu_frac=1.0, passes=1,
    )
    return arrays, RaggedOp("dd", int(a_starts.max()) + Wc, "none", "highest",
                            roofline)


def _pack_dd(shards, max_m, device, rank=None):
    """The ``dd`` kind's non-MXU tier in fp64 (``dispatch.py:236-291``):
    ELL for at most ELL_MAX_L nonzeros per row, else the chunked
    segment-sum.  The JAX package's 4M-nnz cap on the segment-sum tier is
    not kept (see :mod:`.spmm_dd`)."""
    L = _max_row_nnz(shards)
    if L <= ELL_MAX_L:
        packs = [pack_ell_dd(rowptr, cc, v, max_m, L=L) for rowptr, cc, v in shards]
        return _stacked(packs, device, rank), DDOp("ell", max_m)
    nnz_pad = max(max(int(r[-1] - r[0]) for r, _, _ in shards), 1)
    packs = [pack_coo_dd(rowptr, cc, v, nnz_pad, max_m) for rowptr, cc, v in shards]
    return _stacked(packs, device, rank), DDOp("segsum", max_m)


def _tensor_from_jax(x: np.ndarray) -> torch.Tensor:
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint16:  # bf16 bits
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _ptrs(first, device) -> torch.Tensor:
    """Each shard's :func:`first_ptr` of its 0/1 ``first`` row, stacked."""
    return torch.from_numpy(np.stack([first_ptr(f) for f in first])).to(device)


def local_op_from_jax_pack(arrays, min_b_rows: int, device="cuda",
                           roofline: dict | None = None, variant=None):
    """The port's packed tensors and local op for a JAX ``pallas`` pack.

    ``arrays`` are the JAX pack's numpy arrays with their leading shard
    axis, bf16 ones passed as ``.view(np.uint16)``: for a uniform sg pack
    (ws, ah, al, bases) at x3, (ws, ah, bases) for the 1-pass bf16 pack,
    (ws, tiles, bases) for fp32/fp64, whose fp32 panels are split to their
    TF32 planes on upload (scheme ``"tf32"``); for a pack with no
    super-group plan (every multi-shard pack) (ws, tiles), whose fp32
    panels at x3 are split to their bf16 hi/lo pair on upload
    (:func:`_pack_window`'s scheme ``"window_x3"``, bit for bit), at
    default rounded to their bf16 hi plane (scheme ``"window_bf16"``) and
    at highest split to their TF32 planes (scheme ``"window_tf32"``), the
    roofline's bytes their own; for
    ``variant="ragged"`` the ragged pack's (step_g, step_first, starts,
    *panels, *spill), to which the step ranges the CUDA kernels read are
    appended (and, for the fused spill, its row-ordered view); for ``variant="gather"`` the gather pack's (rel,
    cols, vals, first, blk), plus the row-ordered view, its output rows and operating point read from ``roofline`` (G blocks
    of TM rows, passes); for ``variant="dd_mxu"`` the dd_mxu pack's (step_g,
    step_first, starts, mu, slices), whose fp64 panels are rebuilt as
    ``mu * sum_p slice_p * 2**(-7 (p + 1))`` (exact in fp64: 7 slices of 7
    bits and a power-of-two scale).  One pack then feeds both packages.
    ``device`` follows the engines' rule (``engine_device``): the card by
    default, raising without one; the CPU where the caller asks for it.
    """
    from ..engine.rowpara import engine_device

    device = engine_device(device)
    roofline = dict(roofline or {})
    if variant == "dd_mxu":
        g, first, starts, mu, sl = (_tensor_from_jax(x).to(device) for x in arrays)
        panels = torch.zeros(sl.shape[0:1] + sl.shape[2:], dtype=torch.float64,
                             device=device)
        for p in range(sl.shape[1]):
            panels += sl[:, p].double() * 2.0 ** (-7 * (p + 1))
        panels *= mu.double()[..., None]
        roofline.update(a_bytes=panels.numel() * panels.element_size(), passes=1)
        return ((g, first, starts, panels, _ptrs(arrays[1], device)),
                RaggedOp("dd", int(min_b_rows), "none", "highest", roofline))
    tensors = tuple(_tensor_from_jax(x).to(device) for x in arrays)
    if variant == "gather":
        prec = {2: "x3", 6: "highest", 1: "default"}[roofline["passes"]]
        M = roofline["G"] * roofline["TM"]
        view = _row_views(*tensors[:3], tensors[4], M, roofline["TM"])
        return (*tensors, *view), GatherOp(M, prec, roofline)
    if variant == "ragged":
        bf = [t.dtype == torch.bfloat16 for t in tensors[3:5]]
        scheme = "x3" if all(bf) and len(bf) == 2 else ("bf16" if bf[0] else "full")
        n_sp = len(tensors) - 3 - (2 if scheme == "x3" else 1)
        if scheme == "full" and tensors[3].dtype == torch.float32:  # highest: the planes
            planes = device_pack.tf32_pair(tensors[3])
            tensors = (*tensors[:3], *planes, *tensors[4:])
            roofline.update(a_bytes=2 * planes[0].numel() * 4)
            scheme = "tf32"
        spill_impl = {0: "none", 3: "segsum", 5: "pallas"}[n_sp]
        tensors += (_ptrs(arrays[1], device),)
        TMo = 0
        if spill_impl == "pallas":  # every output block has a first step
            M = roofline["G"] * roofline["TM"]
            TMo = M // int(np.asarray(arrays[-2])[0].sum())
            rel, cols, vals, _, blk = tensors[-6:-1]
            tensors += _row_views(rel, cols, vals, blk, M, TMo)
        prec = {3: "x3", 6: "highest", 1: "default"}[roofline["passes"]]
        return tensors, RaggedOp(scheme, int(min_b_rows), spill_impl, prec, roofline,
                                 TMo)
    if len(tensors) == 2:  # (ws, tiles): no super-group plan
        prec = {3: "x3", 6: "highest", 1: "default"}[roofline["passes"]]
        ws, tiles = tensors
        if prec == "x3" and tiles.dtype == torch.float32:
            ah, al = device_pack.split_bf16(tiles, with_lo=True)
            return (ws, ah, al), WindowOp("window_x3", int(min_b_rows), roofline, prec)
        if prec == "default" and tiles.dtype == torch.float32:
            ah, _ = device_pack.split_bf16(tiles, with_lo=False)
            roofline.update(a_bytes=ah.numel() * ah.element_size(), b_itemsize=2)
            return (ws, ah), WindowOp("window_bf16", int(min_b_rows), roofline, prec)
        if prec == "highest" and tiles.dtype == torch.float32:
            planes = device_pack.tf32_planes(tiles)
            roofline.update(a_bytes=planes.numel() * 4)
            return (ws, planes), WindowOp("window_tf32", int(min_b_rows), roofline, prec)
        return tensors, WindowOp("window", int(min_b_rows), roofline, prec)
    if len(tensors) == 4:
        scheme = "x3"
    elif tensors[1].dtype == torch.bfloat16:
        scheme = "bf16"
    elif tensors[1].dtype == torch.float32:
        ws, tiles, bases = tensors
        tensors = (ws, device_pack.tf32_planes(tiles), bases)
        roofline.update(a_bytes=tensors[1].numel() * 4)
        scheme = "tf32"
    else:
        scheme = "full"
    return tensors, WindowOp(scheme, int(min_b_rows), roofline)
