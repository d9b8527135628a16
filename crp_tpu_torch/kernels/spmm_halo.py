"""Fused halo exchange + windowed SpMM for the multi-shard engines.

Counterpart of ``crp_tpu/kernels/spmm_halo.py``.  On a TPU every shard is
a chip, and one kernel per shard pushes each owned 128-row chunk of B into
the window buffers of the shards that read it (remote DMA) while it runs
the windowed product, gated on per-owner arrival semaphores.  The port's
engines hold every shard on one card, so the owners' rows are in the same
memory: the kernel (``csrc/halo.cu``, one launch for every shard) reads
each row group's window straight from the owner shards' rows of the
stacked B, through a table that maps each global 128-row chunk to its
owner's row.  No receive buffer is built and nothing is copied; stream
order stands where the TPU kernel has its barrier and semaphores.

The plan is the JAX plan: the B ownership boundaries rounded to 128 rows
(:func:`align_displs`), one uniform window pack per shard over the global
columns with non-decreasing window starts (else
:class:`UnsupportedSparsity`, and the engines take the unfused ``pallas``
path), panels at a shared chunk-exact W, and the push lists, which the
plain version replays and the audit counts.  The panels are densified on
the device: on fp32 at ``x3`` straight to the bf16 hi/lo pair, and at
``default`` to the hi plane alone, the RNE split and rounding the TPU
kernel makes of its fp32 panels on every read (TMA, which feeds the
``wgmma`` body, can do neither; two bf16 planes are the bytes of one fp32
plane, the hi plane half of them); at ``highest`` in fp32 (and fp64),
split in the kernel, as the TPU kernel does.

:func:`spmm_halo` launches the kernel for CUDA tensors and counts the
launch in its ``launches`` attribute; for CPU tensors it runs
:func:`spmm_halo_plain`: the pushes as one gather into per-shard window
buffers, then the windowed product of :func:`spmm_window_plain`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import device_pack
from .spmm_pallas import (
    TK, UnsupportedSparsity, _check_aligned, _placement, choose_chunks,
    spmm_window_plain, window_entry, window_extents,
)


def align_displs(displs: np.ndarray, k: int) -> np.ndarray:
    """Round interior ownership boundaries to TK multiples (monotone)
    (``spmm_halo.py:94-99``)."""
    d = (np.asarray(displs, dtype=np.int64) + TK // 2) // TK * TK
    d[0] = 0
    d[-1] = k
    return np.maximum.accumulate(d)


@dataclasses.dataclass
class HaloOp:
    """The ``pallas_halo`` kind's op over every shard at once.

    Its arrays are ``(ws, ws_rel, panels, push, chunk_src)``: the global
    window starts (p, G) int32 the kernel reads; the starts relative to
    each shard's window base, and the push list (P, 4) int32 of (owner,
    owner row, consumer, buffer row), which the plain version reads; the
    (p, G, TM, W) panels, on fp32 at ``x3`` the two bf16 planes ``ah,
    al`` in their place and at ``default`` the bf16 hi plane ``ah``; and
    the chunk table (global 128-row chunk -> row
    of the stacked B, -1 past the matrix).  ``buf_rows``: rows of the
    plain version's window buffers; ``min_b_rows``: rows each shard of B
    must have (``max_k``); ``B_displs``: the aligned ownership the engine
    shards B by; ``halo_rows_pushed``: the physical rows one exec moves,
    every push including a shard's own (``spmm_halo.py:75-78``).
    """

    precision: str
    TM: int
    G: int
    W: int
    buf_rows: int
    min_b_rows: int
    B_displs: np.ndarray
    halo_rows_pushed: int
    roofline: dict = dataclasses.field(default_factory=dict)
    variant = "halo"

    @property
    def kernel(self):
        return spmm_halo

    @property
    def plain(self):
        return spmm_halo_plain

    def kernel_args(self, arrs, b_shards) -> tuple:
        """Positional args of :attr:`kernel` and :attr:`plain` for the
        packed ``arrs`` and the stacked B shards (p, max_k, n): on the bf16
        hi plane, B cast to bf16 (RNE) once, as ``WindowOp`` casts it."""
        ws, ws_rel, *panels, push, chunk_src = arrs
        panels = tuple(panels) if len(panels) == 2 else panels[0]
        if not isinstance(panels, tuple) and panels.dtype == torch.bfloat16:
            b_shards = b_shards.to(torch.bfloat16)
        return (ws, ws_rel, panels, push, chunk_src, b_shards, self.precision,
                self.buf_rows)

    def __call__(self, arrs, b_shards):
        """(p, G*TM, n) C shards; rows past a shard's own are zero."""
        c = self.kernel(*self.kernel_args(arrs, b_shards),
                        min_b_rows=self.min_b_rows)
        return c.to(b_shards.dtype)


def build_halo_plan(shards: list, B_displs: np.ndarray, *, device, dtype,
                    precision: str = "highest", TM: int = 256,
                    max_window: int = 16384) -> tuple:
    """Pack the panels and the exchange tables of the fused kernel
    (``build_halo_plan``, ``spmm_halo.py:102-182``) from per-shard CSR
    views with global column indices.  Returns ``(arrays, HaloOp)``;
    raises :class:`UnsupportedSparsity` where the JAX plan refuses: B
    boundaries not TK-aligned, an empty shard, a window over
    ``max_window`` rows, panels over 8 GiB, or window starts that fall.
    On fp32 at ``x3`` the panels are the bf16 pair (the arrays' ``ah,
    al``; ``roofline["a_bytes"]`` the same bytes as fp32 panels), at
    ``default`` the bf16 hi plane (half the bytes, and B counted in bf16)."""
    B_displs = np.asarray(B_displs, dtype=np.int64)
    if np.any(B_displs[:-1] % TK):
        raise UnsupportedSparsity("halo kernel needs TK-aligned B displs")
    dt = np.dtype(dtype)
    if dt not in (np.float32, np.float64):
        raise UnsupportedSparsity(f"no halo kernel for dtype {dt}")
    k_glb = int(B_displs[-1])
    p = len(shards)
    ws_own, los, Ws, Gs = [], [], [], []
    for sh in shards:
        rowptr = np.ascontiguousarray(sh.rowptr, dtype=np.int64)
        if int(rowptr[-1]) == 0:
            raise UnsupportedSparsity("empty shard")
        min_t, W0 = window_extents(rowptr, sh.colidx, TM)
        if W0 > max_window:
            raise UnsupportedSparsity(f"window {W0} rows > cap {max_window}")
        W_i, _, _ = choose_chunks(W0)
        G_i = -(-(len(rowptr) - 1) // TM)
        if G_i * W_i * TM * dt.itemsize > (8 << 30):
            raise UnsupportedSparsity(
                f"dense window tiles {(G_i * W_i * TM * dt.itemsize) >> 20} MiB > cap"
            )
        ws_i = (min_t * TK).astype(np.int32)
        if np.any(np.diff(ws_i) < 0):
            raise UnsupportedSparsity("halo kernel needs non-decreasing group windows")
        ws_own.append(ws_i)
        los.append(int(ws_i.min()))
        Ws.append(W_i)
        Gs.append(G_i)

    G = max(Gs)
    W, _, _ = choose_chunks(max(Ws))
    cols = [(s.rowptr, s.colidx, s.val) for s in shards]
    mode = device_pack.panel_mode(dt, precision)
    ws, ah, al = device_pack.uniform_fill_stacked(cols, ws_own, TM, W, G, mode, device)
    panels = (ah, al) if mode == "pair" else (ah,)
    ws_rel = np.zeros((p, G), dtype=np.int32)
    for i, ws_i in enumerate(ws_own):
        ws_rel[i, : len(ws_i)] = ws_i - los[i]
    lo = np.asarray(los, dtype=np.int64)
    buf_rows = max(TK, int((ws_rel.max(axis=1) + W).max()))

    # push lists (spmm_halo.py:143-173): owner j sends each owned TK chunk
    # to every shard whose window extent covers it, within the matrix
    n_chunks_glb = -(-k_glb // TK)
    pushes = []
    for i in range(p):
        ext_tk = (int(ws_rel[i].max()) + W) // TK
        c = np.arange(los[i] // TK, min(n_chunks_glb, los[i] // TK + ext_tk))
        row = c * TK
        j = np.minimum(np.searchsorted(B_displs, row, side="right") - 1, p - 1)
        pushes.append(np.stack([j, row - B_displs[j], np.full_like(j, i),
                                row - los[i]], axis=1))
    push = np.concatenate(pushes).astype(np.int32)

    # the kernel's chunk table: global chunk -> row of the stacked B, over
    # every row any window reads (pad groups read from their shard's base)
    max_k = -(-int(np.diff(B_displs).max()) // TK) * TK
    span = int((lo[:, None] + ws_rel).max()) + W
    row = np.arange(-(-span // TK), dtype=np.int64) * TK
    j = np.minimum(np.searchsorted(B_displs, row, side="right") - 1, p - 1)
    chunk_src = np.where(row < k_glb, j * max_k + row - B_displs[j], -1)
    if int(chunk_src.max()) + TK > p * max_k:
        raise AssertionError("halo chunk table reads past the stacked B")

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(device)

    arrays = (put(lo[:, None] + ws_rel), put(ws_rel), *panels, put(push),
              put(chunk_src))
    nnz = sum(int(s.rowptr[-1]) for s in shards)
    roofline = dict(
        G=G, TM=TM, W=W, p=p, nnz=nnz,
        a_bytes=sum(t.numel() * t.element_size() for t in panels),
        b_rows_read=p * G * W, c_rows=p * G * TM,
        b_itemsize=2 if mode == "bf16" else dt.itemsize,
        passes={"x3": 3, "highest": 6, "default": 1}.get(precision, 1),
    )
    op = HaloOp(precision, TM, G, W, buf_rows, max_k, B_displs,
                len(push) * TK, roofline)
    return arrays, op


# ------------------------------------------------------------- plain version


def halo_buffers(push, b_shards, buf_rows: int) -> torch.Tensor:
    """The window buffers the TPU kernel's pushes fill: (p, buf_rows, n),
    zero where nothing is pushed."""
    p, _, n = b_shards.shape
    buf = torch.zeros((p, buf_rows, n), dtype=b_shards.dtype, device=b_shards.device)
    rows = torch.arange(TK, device=b_shards.device)
    push = push.long()
    src = b_shards[push[:, 0, None], push[:, 1, None] + rows]  # (P, TK, n)
    buf[push[:, 2, None], push[:, 3, None] + rows] = src
    return buf


def spmm_halo_plain(ws, ws_rel, panels, push, chunk_src, b_shards, precision,
                    buf_rows):
    """The fused kernel's function in plain PyTorch: the pushes into
    per-shard window buffers, then each shard's windowed product at
    ``precision`` (:func:`spmm_window_plain`; on the x3 pair ``panels =
    (ah, al)`` that is ``spmm_window_sg_presplit_plain``, on the default
    hi plane ``spmm_window_sg_bf16_plain``); ``ws`` and ``chunk_src`` are
    the kernel's and go unused.  Returns (p, G*TM, n)."""
    buf = halo_buffers(push, b_shards, buf_rows)
    pair = isinstance(panels, tuple)
    return torch.stack([
        spmm_window_plain(ws_rel[i], tuple(t[i] for t in panels) if pair else panels[i],
                          buf[i], precision)
        for i in range(ws_rel.shape[0])
    ])


# ------------------------------------------------------------------ wrapper

def spmm_halo(ws, ws_rel, panels, push, chunk_src, b_shards, precision, buf_rows,
              *, min_b_rows: int):
    """Fused halo exchange + windowed SpMM over every shard
    (``csrc/halo.cu``): (p, G*TM, n) from the stacked B shards (p, max_k,
    n) and (p, G, TM, W) panels: at ``x3`` the bf16 pair ``panels = (ah,
    al)`` and fp32 B (#4's ``wgmma`` body with the chunk lookup), at
    ``default`` the bf16 hi plane and bf16 B (its one-pass mode, fp32 C),
    at ``highest`` fp32 panels and B (3xTF32 on the tensor cores), or fp64
    panels and B; the bf16 panels must start on 16 bytes.  fp32 panels at
    ``x3`` and ``default`` have no kernel: the plans hold the pair and the
    plane.  Replaces ``halo_spmm_local`` (``spmm_halo.py:349``, kernel
    ``_halo_kernel``)."""
    pair = isinstance(panels, tuple)
    planes = panels if pair else (panels,)
    if _placement("spmm_halo", ws, *planes, chunk_src, b_shards) == "cpu":
        return spmm_halo_plain(ws, ws_rel, panels, push, chunk_src, b_shards,
                               precision, buf_rows)
    name, panel_dtype, b_dtype = window_entry("spmm_halo", planes, precision)
    p, G, TM, W = planes[0].shape
    for t in planes:
        if (t.dtype != panel_dtype or t.shape != (p, G, TM, W) or not t.is_contiguous()
                or TM % 128 or W % 32):
            raise ValueError(f"spmm_halo: panels must be contiguous {panel_dtype} of one "
                             f"shape with TM % 128 == 0 and W % 32 == 0; got {t.dtype} "
                             f"{tuple(t.shape)}")
    if panel_dtype == torch.bfloat16:
        _check_aligned("spmm_halo", **dict(zip(("ah", "al"), planes)))
    if ws.dtype != torch.int32 or ws.shape != (p, G) or not ws.is_contiguous():
        raise ValueError(f"spmm_halo: ws must be contiguous int32 of shape ({p}, {G})")
    if chunk_src.dtype != torch.int32 or chunk_src.dim() != 1 or not chunk_src.is_contiguous():
        raise ValueError("spmm_halo: chunk_src must be a contiguous 1-D int32 tensor")
    if (b_shards.dtype != b_dtype or b_shards.dim() != 3
            or b_shards.shape[0] != p or not b_shards.is_contiguous()):
        raise ValueError(f"spmm_halo: B must be contiguous {b_dtype} shards of "
                         f"shape ({p}, rows, n)")
    if b_shards.shape[1] != min_b_rows:
        raise ValueError(f"spmm_halo: B shards have {b_shards.shape[1]} rows, the "
                         f"chunk table was built for {min_b_rows}")
    from . import _build

    n = b_shards.shape[2]
    c = torch.empty((p, G * TM, n), dtype=torch.float64 if panel_dtype == torch.float64
                    else torch.float32, device=b_shards.device)
    with torch.cuda.device(b_shards.device):
        stream = torch.cuda.current_stream(b_shards.device).cuda_stream
        rc = _build.entry(name)(chunk_src.data_ptr(), ws.data_ptr(),
                                *(t.data_ptr() for t in planes), b_shards.data_ptr(),
                                c.data_ptr(), p * G, TM, W, n, stream)
    _build.check(rc, name)
    spmm_halo.launches += 1
    return c


spmm_halo.launches = 0

KERNELS = (spmm_halo,)
