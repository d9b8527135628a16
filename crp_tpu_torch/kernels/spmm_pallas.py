"""Windowed dense-panel SpMM for uniform super-grouped packs.

Counterpart of ``crp_tpu/kernels/spmm_pallas.py``.  A pack covers TM-row
groups of A; group g holds a dense (TM, W) panel over the B rows
``[ws[g], ws[g] + W)`` (its *window*), and

    C[g*TM + r, j] = sum_k A[g, r, k] * B[ws[g] + k, j].

The geometry helpers are numpy copies of the JAX package's (which imports
jax on the way in); ``tests/test_torch_geometry.py`` pins each one equal to
its original.  The three kernels of the p = 1 main path are CUDA kernels
for Hopper (``csrc/window_sg.cu``), one per operating point:

  * :func:`spmm_window_sg_presplit` — ``x3``: A pre-split to bf16 hi/lo,
    B split in the kernel, three bf16 products summed in fp32;
  * :func:`spmm_window_sg_bf16` — ``default``: one bf16 product;
  * :func:`spmm_window_sg` — ``highest``: fp32 (or fp64) FMA, no TF32.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
its ``launches`` attribute; for CPU tensors it runs its plain PyTorch
version (``*_plain``), which is also what the kernel is checked against on
the card.
"""

from __future__ import annotations

import numpy as np
import torch

TK = 128    # B window row alignment
WCHUNK = 1536  # max k-loop chunk rows of the TPU kernels (geometry parity)
PLAIN_BLOCK_BYTES = 256 << 20  # window gather per step of a plain version
# Byte budgets of the TPU kernels' double-buffered B super-window slots
# (``spmm_pallas.py:856-868`` on the TPU, the 4 MB interpreter budget of
# ``dispatch.py:406-409`` off it).  The port plans with them so that its
# packs are the JAX packs; the Hopper kernels do not use super-windows.
SG_BUDGET = 48 << 20
SG_BUDGET_CPU = 4 << 20


def choose_chunks(W0: int) -> tuple[int, int, int]:
    """(W_padded, Wc, C) for a raw window of W0 rows: C even chunks of at
    most ~WCHUNK rows, chunk size TK-aligned (``spmm_pallas.py:47-54``)."""
    C = -(-W0 // WCHUNK)
    per = -(-W0 // C)
    Wc = -(-per // TK) * TK
    return C * Wc, Wc, C


class UnsupportedSparsity(ValueError):
    """Shard shape does not fit a ported kernel; use a fallback."""


def window_extents(rowptr: np.ndarray, colidx: np.ndarray, TM: int):
    """Per-group window start tiles and the raw window width W0
    (``spmm_pallas.py:101-121``; columns sorted within each row)."""
    nrow = len(rowptr) - 1
    G = -(-nrow // TM)
    counts = np.diff(rowptr)
    nonempty = counts > 0
    row_min = np.full(nrow, np.iinfo(np.int64).max, dtype=np.int64)
    row_max = np.full(nrow, -1, dtype=np.int64)
    row_min[nonempty] = colidx[rowptr[:-1][nonempty]]
    row_max[nonempty] = colidx[rowptr[1:][nonempty] - 1]
    starts = np.arange(G) * TM
    min_t = np.minimum.reduceat(row_min, starts) // TK
    max_t = np.maximum.reduceat(row_max, starts) // TK
    empty = max_t < 0
    min_t = np.where(empty, 0, np.minimum(min_t, max_t))
    max_t = np.where(empty, 0, max_t)
    W0 = int(((max_t - min_t + 1).max()) * TK)
    return min_t, W0


def plan_supergroups(
    ws: np.ndarray, W: int, TN: int, itemsize: int,
    vmem_budget: int = SG_BUDGET,
) -> tuple[int, int, np.ndarray] | None:
    """(SG, Wsg, bases) for window reuse, or None when windows are
    non-monotone or SG < 2 would not fit (``spmm_pallas.py:883-937``)."""
    ws = np.asarray(ws, dtype=np.int64)
    if ws.size < 2 or np.any(np.diff(ws) < 0):
        return None
    cap = vmem_budget // (2 * TN * itemsize)
    cap = min(cap, 24576)
    G = ws.size

    def plan_for(SG):
        sgc = -(-G // SG)
        bases = ws[::SG][:sgc]
        spans = np.empty(sgc, dtype=np.int64)
        for s in range(sgc):
            hi = min((s + 1) * SG, G) - 1
            spans[s] = ws[hi] + W - bases[s]
        Wsg = int(-(-int(spans.max()) // TK) * TK)
        return SG, Wsg, bases.astype(np.int32), sgc

    feasible = []
    for SG in range(2, 129):
        got = plan_for(SG)
        if got[1] > cap:
            break
        feasible.append(got)
    if not feasible:
        return None
    b_min = min(p[3] * p[1] for p in feasible)
    near = [p for p in feasible if p[3] * p[1] <= b_min + b_min // 10]
    SG, Wsg, bases, sgc = min(near, key=lambda p: (p[3] * p[0] - G, p[0]))
    return SG, Wsg, bases


# ------------------------------------------------------------ plain versions


def plain_blocks(step_g, starts, panels, b, G, out_dtype, product):
    """Run ``product(s0, s1, windows)`` over blocks of steps, where
    ``windows`` is the gathered ``(s1 - s0, W, n)`` stack of the B windows
    ``b[starts[s] : starts[s] + W]``, and add each step's (TM, n) result
    into the rows of its group ``step_g[s]`` of the (G*TM, n) output with
    ``index_add_``.  The blocks keep the gather bounded (the whole headline
    gather is ~5 GB).  TF32 is off while they run and the caller's setting
    comes back after.  A uniform pack is one step per group."""
    S, TM, W = panels.shape
    n = b.shape[1]
    out = torch.zeros((G, TM, n), dtype=out_dtype, device=b.device)
    step = max(1, PLAIN_BLOCK_BYTES // max(1, max(W, TM) * n * 4))
    ar = torch.arange(W, device=b.device)
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s0 in range(0, S, step):
            s1 = min(S, s0 + step)
            win = b[starts[s0:s1].long()[:, None] + ar]
            out.index_add_(0, step_g[s0:s1].long(), product(s0, s1, win))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    return out.view(G * TM, n)


def presplit_product(ah, al):
    """x3 in plain PyTorch: B split in RNE like the kernels, the three
    products as fp32 ``bmm``s of bf16-valued fp32 tensors (exact
    products), sums in fp32."""

    def product(s0, s1, win):
        bh = win.to(torch.bfloat16)
        bl = (win - bh.float()).to(torch.bfloat16).float()
        bh = bh.float()
        a_h = ah[s0:s1].float()
        return torch.bmm(a_h, bh) + (
            torch.bmm(a_h, bl) + torch.bmm(al[s0:s1].float(), bh)
        )

    return product


def bf16_product(ah):
    """One bf16 pass in plain PyTorch (the windows are bf16 B)."""
    return lambda s0, s1, win: torch.bmm(ah[s0:s1].float(), win.float())


def full_product(tiles):
    """fp32 / fp64 panels times B windows in plain PyTorch (no TF32)."""
    return lambda s0, s1, win: torch.bmm(tiles[s0:s1], win)


def _uniform(ws, panels, b, out_dtype, product):
    G = panels.shape[0]
    steps = torch.arange(G, device=b.device)
    return plain_blocks(steps, ws, panels, b, G, out_dtype, product)


def spmm_window_sg_presplit_plain(ws, ah, al, b):
    """x3 windowed SpMM in plain PyTorch."""
    return _uniform(ws, ah, b, torch.float32, presplit_product(ah, al))


def spmm_window_sg_bf16_plain(ws, ah, bh):
    """One-pass bf16 windowed SpMM in plain PyTorch (``bh`` is the bf16 B)."""
    return _uniform(ws, ah, bh, torch.float32, bf16_product(ah))


def spmm_window_sg_plain(ws, tiles, b):
    """fp32 / fp64 windowed SpMM in plain PyTorch (no TF32)."""
    return _uniform(ws, tiles, b, tiles.dtype, full_product(tiles))


# ----------------------------------------------------------------- wrappers


def _placement(name, *tensors) -> str:
    """"cpu" or "cuda" when every tensor lies there (on one device), else
    raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    kind = next(iter(devices)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {kind!r}")
    return kind


def _check_cuda_args(name, ws, panels, b, min_b_rows, panel_dtypes, b_dtype):
    G, TM, W = panels[0].shape
    for p in panels:
        if p.dtype != panel_dtypes or p.shape != (G, TM, W) or not p.is_contiguous():
            raise ValueError(
                f"{name}: panels must be contiguous {panel_dtypes} of one "
                f"shape (G, TM, W); got {p.dtype} {tuple(p.shape)}"
            )
    if ws.dtype != torch.int32 or ws.shape != (G,) or not ws.is_contiguous():
        raise ValueError(f"{name}: ws must be contiguous int32 of shape ({G},)")
    if b.dtype != b_dtype or b.dim() != 2 or not b.is_contiguous():
        raise ValueError(f"{name}: B must be a contiguous 2-D {b_dtype} tensor")
    if b.shape[0] < min_b_rows:
        raise ValueError(
            f"{name}: B has {b.shape[0]} rows < min_b_rows {min_b_rows}"
        )
    if TM % 128 or W % 32:
        raise ValueError(f"{name}: TM % 128 and W % 32 must be 0 (TM={TM}, W={W})")
    return G, TM, W, b.shape[1]


def _launch(name, ptrs, G, TM, W, n, device):
    from . import _build

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _build.entry(name)(*ptrs, G, TM, W, n, stream)
    _build.check(rc, name)


def spmm_window_sg_presplit(ws, ah, al, b, *, min_b_rows: int):
    """x3 windowed SpMM: (G*TM, n) fp32 from bf16 ``ah``/``al`` panels and
    fp32 ``b``.  Replaces ``spmm_window_pallas_sg_presplit``
    (``spmm_pallas.py:795``)."""
    if _placement("spmm_window_sg_presplit", ws, ah, al, b) == "cpu":
        return spmm_window_sg_presplit_plain(ws, ah, al, b)
    G, TM, W, n = _check_cuda_args(
        "spmm_window_sg_presplit", ws, (ah, al), b, min_b_rows,
        torch.bfloat16, torch.float32,
    )
    c = torch.empty((G * TM, n), dtype=torch.float32, device=b.device)
    _launch(
        "crp_window_sg_presplit",
        (ws.data_ptr(), ah.data_ptr(), al.data_ptr(), b.data_ptr(),
         c.data_ptr()),
        G, TM, W, n, b.device,
    )
    spmm_window_sg_presplit.launches += 1
    return c


spmm_window_sg_presplit.launches = 0


def spmm_window_sg_bf16(ws, ah, bh, *, min_b_rows: int):
    """One-pass bf16 windowed SpMM: (G*TM, n) fp32 from bf16 ``ah`` and
    bf16 ``bh``.  Replaces ``spmm_window_pallas_sg_bf16``
    (``spmm_pallas.py:691``)."""
    if _placement("spmm_window_sg_bf16", ws, ah, bh) == "cpu":
        return spmm_window_sg_bf16_plain(ws, ah, bh)
    G, TM, W, n = _check_cuda_args(
        "spmm_window_sg_bf16", ws, (ah,), bh, min_b_rows,
        torch.bfloat16, torch.bfloat16,
    )
    c = torch.empty((G * TM, n), dtype=torch.float32, device=bh.device)
    _launch(
        "crp_window_sg_bf16",
        (ws.data_ptr(), ah.data_ptr(), bh.data_ptr(), c.data_ptr()),
        G, TM, W, n, bh.device,
    )
    spmm_window_sg_bf16.launches += 1
    return c


spmm_window_sg_bf16.launches = 0


def spmm_window_sg(ws, tiles, b, *, min_b_rows: int):
    """fp32 or fp64 windowed SpMM (FMA, no TF32): (G*TM, n) in the panels'
    dtype.  Replaces ``spmm_window_pallas_sg`` (``spmm_pallas.py:940``)."""
    if _placement("spmm_window_sg", ws, tiles, b) == "cpu":
        return spmm_window_sg_plain(ws, tiles, b)
    if tiles.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"spmm_window_sg: panels must be fp32 or fp64, not {tiles.dtype}")
    G, TM, W, n = _check_cuda_args(
        "spmm_window_sg", ws, (tiles,), b, min_b_rows, tiles.dtype, tiles.dtype,
    )
    c = torch.empty((G * TM, n), dtype=tiles.dtype, device=b.device)
    name = "crp_window_sg_f32" if tiles.dtype == torch.float32 else "crp_window_sg_f64"
    _launch(
        name, (ws.data_ptr(), tiles.data_ptr(), b.data_ptr(), c.data_ptr()),
        G, TM, W, n, b.device,
    )
    spmm_window_sg.launches += 1
    return c


spmm_window_sg.launches = 0

KERNELS = (spmm_window_sg_presplit, spmm_window_sg_bf16, spmm_window_sg)
