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
  * ``"ragged"`` — the ragged pack directly.

The other kinds of the JAX package (``ell``, ``gather``, ``dd``,
``dd_mxu``, ``pallas_halo``) and multi-shard windowed packs raise
:class:`UnsupportedSparsity` ("not yet ported"), so the fallback walk ends
at ``segsum`` (logged, and reported as the engine's ``kernel_kind``) where
the JAX package would have run one of them.
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
from .spmm_ragged import (
    PANEL_CAP_BYTES, SPILL_Q, SPILL_TMO, cover_with_cap, default_min_chunk_nnz,
    estimate_ragged, first_ptr, pack_spill, pack_spill_blocks,
    resolve_ragged_geometry, spmm_ragged, spmm_ragged_bf16,
    spmm_ragged_bf16_plain, spmm_ragged_plain, spmm_ragged_presplit,
    spmm_ragged_presplit_plain, spmm_spill, spmm_spill_chunked,
    spmm_spill_plain,
)
from .spmm_segsum import pack_device_csr, spmm_segment_sum

logger = logging.getLogger("crp_tpu_torch")

# kinds of the JAX package whose kernels this package does not have yet,
# with the ROADMAP item that ports each
_NOT_PORTED = {
    "ell": "Queue A #6",
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
    if kind == "ragged":
        return _pack_ragged(shards, max_m, dtype, mxu_precision, device)
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


@dataclasses.dataclass
class RaggedOp:
    """Local op of the ``pallas``/``ragged`` kinds on a ragged pack.

    ``arrays`` are the JAX pack's, (step_g, step_first, starts, *panels,
    *spill), then the step ranges the CUDA kernels read: ``group_ptr`` and,
    for the fused spill, ``blk_ptr`` (both :func:`first_ptr` of the pack's
    ``first`` arrays).  ``scheme`` picks the ragged kernel: ``"x3"`` (ah,
    al), ``"bf16"`` (ah), ``"full"`` (fp32/fp64 panels).  ``spill_impl``:
    ``"none"``, ``"segsum"`` (rows, cols, vals; plain ``index_add_``) or
    ``"pallas"`` (rel, cols, vals, first, blk; the fused spill kernel).
    """

    scheme: str
    min_b_rows: int
    spill_impl: str
    mxu_precision: str
    roofline: dict = dataclasses.field(default_factory=dict)
    variant = "ragged"

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
        }[self.scheme]

    @property
    def plain(self):
        """The ragged kernel's plain PyTorch version (same positional args)."""
        return {
            "x3": spmm_ragged_presplit_plain,
            "bf16": spmm_ragged_bf16_plain,
            "full": spmm_ragged_plain,
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
    under 30% of the nonzeros in panels.
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
    starts_s, group_ptr_s, _ = cover_with_cap(
        rowptr64, cc32, TM, Wc,
        default_min_chunk_nnz(TM, Wc) if min_chunk_nnz is None else min_chunk_nnz,
        G_s, PANEL_CAP_BYTES, np.dtype(pack_dtype).itemsize,
    )
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
    if mxu_nnz * 100 < RAGGED_MIN_PCT * nnz:
        raise UnsupportedSparsity(
            f"ragged cover keeps only {mxu_nnz * 100 // nnz}% of nnz "
            f"in panels (min {RAGGED_MIN_PCT}%)"
        )

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
    ranges the CUDA kernels read are appended.  One pack then feeds both
    packages.
    """
    roofline = dict(roofline or {})
    tensors = tuple(_tensor_from_jax(x).to(device) for x in arrays)
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
