"""Windowed dense-panel SpMM for uniform packs.

Counterpart of ``crp_tpu/kernels/spmm_pallas.py``.  A pack covers TM-row
groups of A; group g holds a dense (TM, W) panel over the B rows
``[ws[g], ws[g] + W)`` (its *window*), and

    C[g*TM + r, j] = sum_k A[g, r, k] * B[ws[g] + k, j].

The geometry helpers are numpy copies of the JAX package's (which imports
jax on the way in); ``tests/test_torch_geometry.py`` pins each one equal to
its original.  The kernels are CUDA kernels for Hopper.  On a single-shard
pack with a super-group plan (``csrc/window_sg.cu``), one per operating
point:

  * :func:`spmm_window_sg_presplit` — ``x3``: A pre-split to bf16 hi/lo,
    B split in the kernel, three bf16 products summed in fp32 (``wgmma``
    fed by TMA, ``csrc/x3_wgmma.cuh``);
  * :func:`spmm_window_sg_presplit_ab` — ``x3`` with B pre-split too, by
    :func:`split_b_bf16` (no engine path takes it: the presplit-B
    comparison of ``crp_tpu_torch.cli.presplit_b_sweep`` does);
  * :func:`spmm_window_sg_bf16` — ``default``: one bf16 product (the
    ``wgmma`` body's one-pass mode, the hi panels fed by TMA);
  * :func:`spmm_window_sg` — ``highest``: fp32 panels as three TF32
    tensor-core products (:func:`split_tf32`), held to the fp32 plain
    version: the ``wgmma`` body's TF32 mode on the panels' TF32 planes,
    split once when they are packed (``device_pack.tf32_operands``) and
    fed by TMA; fp64 panels on the FP64 tensor cores (#11's DMMA body
    with its windowed walk, ``csrc/dd_tc.cu``).

On every other uniform pack (several shards, or windows that are not
monotone): :func:`spmm_window` (``csrc/window.cu``, the TPU's
``_window_kernel``).  At ``x3`` its panels are the bf16 hi/lo pair, and at
``default`` the bf16 hi plane alone, split or rounded once when they are
packed (the TPU kernel splits or rounds its fp32 panels on every read;
TMA, which feeds the ``wgmma`` body, copies and can do neither): it runs
#1's body, or #2's one pass on B cast to bf16; at ``highest`` #3's, the
same body's TF32 mode, on the panels' TF32 big/small planes (split once
when they are packed: the tensor cores truncate an fp32 operand) and B
split in registers (:func:`split_tf32`) for three TF32 tensor-core
products; fp64 panels on the FP64 tensor cores, the DMMA body of #3's
fp64 entry (``csrc/dd_tc.cu``).

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


def _x3(a_h, a_l, b_h, b_l):
    """The three products of x3 as fp32 ``bmm``s of bf16-valued fp32
    tensors (exact products), summed in fp32: ah·bh + (ah·bl + al·bh)."""
    return torch.bmm(a_h, b_h) + (torch.bmm(a_h, b_l) + torch.bmm(a_l, b_h))


def presplit_product(ah, al):
    """x3 in plain PyTorch: B split in RNE like the kernels, then
    :func:`_x3`."""

    def product(s0, s1, win):
        bh = win.to(torch.bfloat16)
        bl = (win - bh.float()).to(torch.bfloat16).float()
        return _x3(ah[s0:s1].float(), al[s0:s1].float(), bh.float(), bl)

    return product


def presplit_ab_product(ah, al):
    """x3 in plain PyTorch on B pre-split: the windows are ``(..., W, n,
    2)`` bf16 pairs (bh, bl), multiplied as they are by :func:`_x3`."""

    def product(s0, s1, win):
        return _x3(ah[s0:s1].float(), al[s0:s1].float(),
                   win[..., 0].float(), win[..., 1].float())

    return product


def bf16_product(ah):
    """One bf16 pass in plain PyTorch (the windows are bf16 B)."""
    return lambda s0, s1, win: torch.bmm(ah[s0:s1].float(), win.float())


def full_product(tiles):
    """fp32 / fp64 panels times B windows in plain PyTorch (no TF32)."""
    return lambda s0, s1, win: torch.bmm(tiles[s0:s1], win)


def tf32_panels(planes):
    """The fp32 panels that TF32 planes ``(2, ...)`` were split from
    (``device_pack.tf32_operands``): the big plane's bits less half a TF32
    ulp, exact."""
    return (planes[0].view(torch.int32) - 0x1000).view(torch.float32)


def tf32_product(big):
    """The fp32 panels, rebuilt a block at a time from the big TF32 plane
    ``(S, TM, W)`` (:func:`tf32_panels`), times B windows in plain PyTorch
    (no TF32): the function of the fp32 panels, bit for bit."""
    return lambda s0, s1, win: torch.bmm(tf32_panels((big[s0:s1],)), win)


def _planes(tiles) -> bool:
    """Whether ``tiles`` are TF32 planes, a uniform pack's ``(2, G, TM,
    W)`` tensor or #12's ``(big, small)`` pair, not fp32 ``(G, TM, W)``
    panels; either way ``tiles[0]`` is the big plane."""
    if isinstance(tiles, tuple):
        return tiles[0].dtype == torch.float32
    return tiles.dtype == torch.float32 and tiles.dim() == 4


def _uniform(ws, panels, b, out_dtype, product):
    G = panels.shape[0]
    steps = torch.arange(G, device=b.device)
    return plain_blocks(steps, ws, panels, b, G, out_dtype, product)


def spmm_window_sg_presplit_plain(ws, ah, al, b):
    """x3 windowed SpMM in plain PyTorch."""
    return _uniform(ws, ah, b, torch.float32, presplit_product(ah, al))


def spmm_window_sg_presplit_ab_plain(ws, ah, al, bh, bl):
    """x3 windowed SpMM in plain PyTorch on B pre-split to bf16 ``bh``,
    ``bl``: the windows of both halves are gathered as one (rows, n, 2)
    pair.  Equal bit for bit to :func:`spmm_window_sg_presplit_plain` on
    B when ``(bh, bl) = split_b_bf16(B)``."""
    return _uniform(ws, ah, torch.stack((bh, bl), dim=-1), torch.float32,
                    presplit_ab_product(ah, al))


def spmm_window_sg_bf16_plain(ws, ah, bh):
    """One-pass bf16 windowed SpMM in plain PyTorch (``bh`` is the bf16 B)."""
    return _uniform(ws, ah, bh, torch.float32, bf16_product(ah))


def spmm_window_sg_plain(ws, tiles, b):
    """fp32 / fp64 windowed SpMM in plain PyTorch (no TF32), on the
    panels or, fp32, on their TF32 planes (:func:`_planes`; the same
    function)."""
    if _planes(tiles):
        return _uniform(ws, tiles[0], b, torch.float32, tf32_product(tiles[0]))
    return _uniform(ws, tiles, b, tiles.dtype, full_product(tiles))


def window_product(tiles, precision: str):
    """fp32 (or fp64) panels times B windows at an operating point, in
    plain PyTorch: ``x3`` splits each block of panels and B to bf16 hi/lo
    in RNE, ``default`` rounds both to bf16, ``highest`` and fp64 panels
    multiply in full precision."""
    if tiles.dtype == torch.float64 or precision == "highest":
        return full_product(tiles)
    if precision == "x3":
        def product(s0, s1, win):
            a = tiles[s0:s1]
            ah = a.to(torch.bfloat16)
            al = (a - ah.float()).to(torch.bfloat16)
            return presplit_product(ah, al)(0, s1 - s0, win)
        return product
    if precision == "default":
        return lambda s0, s1, win: bf16_product(tiles[s0:s1].to(torch.bfloat16))(
            0, s1 - s0, win.to(torch.bfloat16))
    raise ValueError(f"unknown operating point {precision!r}")


def spmm_window_plain(ws, tiles, b, precision: str):
    """Non-super-grouped windowed SpMM in plain PyTorch: (G*TM, n) from
    fp32 (or fp64) ``tiles`` and B of the same dtype, at ``precision``; at
    ``x3`` ``tiles`` may be the bf16 pair ``(ah, al)`` of the x3 pack, and
    then this is :func:`spmm_window_sg_presplit_plain`; at ``default`` the
    bf16 hi plane of the default pack, and then this is
    :func:`spmm_window_sg_bf16_plain` on B rounded to bf16 (RNE); at
    ``highest`` the TF32 planes of the ``highest`` pack, one ``(2, G, TM,
    W)`` tensor (#4's) or the pair ``(big, small)`` (#12's).
    Each is equal bit for bit to this function on the fp32 panels the
    pair, the plane or the planes were made from."""
    if _planes(tiles):
        if precision != "highest":
            raise ValueError(f"spmm_window_plain: TF32 planes at {precision!r}")
        return spmm_window_sg_plain(ws, tiles, b)
    if isinstance(tiles, tuple):
        if precision != "x3":
            raise ValueError(f"spmm_window_plain: a bf16 pair at {precision!r}")
        return spmm_window_sg_presplit_plain(ws, *tiles, b)
    if tiles.dtype == torch.bfloat16:
        if precision != "default":
            raise ValueError(f"spmm_window_plain: a bf16 plane at {precision!r}")
        return spmm_window_sg_bf16_plain(ws, tiles, b.to(torch.bfloat16))
    return _uniform(ws, tiles, b, tiles.dtype, window_product(tiles, precision))


def split_b_bf16(b):
    """fp32 (k, n) ``b`` -> bf16 ``(bh, bl)`` with ``bh = RNE(b)`` and
    ``bl = RNE(b - f32(bh))``: the bits of JAX's ``reduce_precision``
    split (``spmm_pallas.py:777-792``) and of ``np_split_bf16``, and the
    split the x3 kernels make of fp32 B.  Plain PyTorch on the tensor's
    device, as the JAX package leaves it to XLA; never a truncation."""
    from .device_pack import split_bf16

    if b.dtype != torch.float32 or b.dim() != 2:
        raise ValueError(
            f"split_b_bf16: B must be a 2-D fp32 tensor, not {b.dtype} "
            f"{tuple(b.shape)}"
        )
    return split_bf16(b, with_lo=True)


def round_tf32(x):
    """fp32 ``x`` rounded to TF32 (10 mantissa bits, the low 13 of the 32
    cleared) to nearest, ties away from zero: ``cvt.rna.tf32.f32``, by
    int32 bit operations.  Subnormals round on the same grid and keep
    their sign; inf and NaN are left as they are."""
    if x.dtype != torch.float32:
        raise ValueError(f"round_tf32: x must be fp32, not {x.dtype}")
    bits = x.view(torch.int32)
    finite = torch.isfinite(x)
    # on the magnitude bits, + half a TF32 ulp then truncate = ties away;
    # a carry into the exponent is the right result, up to inf
    r = (torch.where(finite, bits, 0) + 0x1000) & -0x2000
    return torch.where(finite, r, bits).view(torch.float32)


def split_tf32(x):
    """fp32 ``x`` -> fp32 ``(big, small)``: ``big = round_tf32(x)`` and
    ``small = round_tf32(x - big)`` (the remainder is exact in fp32), so
    ``|x - big - small| <= 2**-22 |x|`` for ``|x| >= 2**-100`` (below,
    small's grid is the subnormal one).  The split the
    3xTF32 kernels make of each operand as its fragment is read; plain
    PyTorch, for the tests (the kernels' plain version is the fp32 product
    itself).  inf and NaN give ``big = x`` and a NaN ``small``, as on the
    card."""
    big = round_tf32(x)
    return big, round_tf32(x - big)


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


def _tf32_plane_views(name, planes) -> tuple:
    """The big and small planes of contiguous fp32 TF32 planes ``(2, G,
    TM, W)``, the operand of #3's and #4's fp32 entries; raise on any
    other fp32 panels (the ``highest`` packs hold the planes)."""
    if planes.dim() != 4 or planes.shape[0] != 2 or not planes.is_contiguous():
        raise ValueError(
            f"{name}: fp32 panels run at highest on their TF32 planes, a contiguous "
            f"(2, G, TM, W) tensor (device_pack.tf32_planes); got {tuple(planes.shape)}"
        )
    return planes[0], planes[1]


def _check_aligned(name, **tensors) -> None:
    """Raise unless each tensor starts on 16 bytes: the panels the kernels
    copy by TMA or 16-byte ``cp.async`` (a shard's view may not)."""
    for label, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(
                f"{name}: {label} must start on 16 bytes for the kernel's "
                f"copies; this view is {t.data_ptr() % 16} bytes off"
            )


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
    _check_aligned("spmm_window_sg_presplit", ah=ah, al=al)
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


def spmm_window_sg_presplit_ab(ws, ah, al, bh, bl, *, min_b_rows: int):
    """x3 windowed SpMM on B pre-split: (G*TM, n) fp32 from bf16
    ``ah``/``al`` panels and bf16 ``bh``/``bl`` (:func:`split_b_bf16`).
    Replaces ``spmm_window_pallas_sg_presplit_ab`` (``spmm_pallas.py:654``)
    and equals :func:`spmm_window_sg_presplit` on the B that was split, bit
    for bit."""
    name = "spmm_window_sg_presplit_ab"
    if bh.dtype != torch.bfloat16 or bl.dtype != torch.bfloat16:
        raise ValueError(
            f"{name}: bh and bl must be bf16 halves (split_b_bf16), not "
            f"{bh.dtype} / {bl.dtype}"
        )
    if _placement(name, ws, ah, al, bh, bl) == "cpu":
        return spmm_window_sg_presplit_ab_plain(ws, ah, al, bh, bl)
    G, TM, W, n = _check_cuda_args(name, ws, (ah, al), bh, min_b_rows,
                                   torch.bfloat16, torch.bfloat16)
    if bl.shape != bh.shape or not bl.is_contiguous():
        raise ValueError(f"{name}: bl must be contiguous of bh's shape {tuple(bh.shape)}")
    _check_aligned(name, ah=ah, al=al)
    c = torch.empty((G * TM, n), dtype=torch.float32, device=bh.device)
    _launch(
        "crp_window_sg_presplit_ab",
        (ws.data_ptr(), ah.data_ptr(), al.data_ptr(), bh.data_ptr(),
         bl.data_ptr(), c.data_ptr()),
        G, TM, W, n, bh.device,
    )
    spmm_window_sg_presplit_ab.launches += 1
    return c


spmm_window_sg_presplit_ab.launches = 0


def spmm_window_sg_bf16(ws, ah, bh, *, min_b_rows: int):
    """One-pass bf16 windowed SpMM: (G*TM, n) fp32 from bf16 ``ah`` and
    bf16 ``bh`` (the ``wgmma`` body of #1 in one pass, whose panels must
    start on 16 bytes for TMA).  Replaces ``spmm_window_pallas_sg_bf16``
    (``spmm_pallas.py:691``)."""
    if _placement("spmm_window_sg_bf16", ws, ah, bh) == "cpu":
        return spmm_window_sg_bf16_plain(ws, ah, bh)
    G, TM, W, n = _check_cuda_args(
        "spmm_window_sg_bf16", ws, (ah,), bh, min_b_rows,
        torch.bfloat16, torch.bfloat16,
    )
    _check_aligned("spmm_window_sg_bf16", ah=ah)
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
    """fp32 or fp64 windowed SpMM: (G*TM, n) in the panels' dtype.  fp32
    ``tiles`` are the TF32 planes ``(2, G, TM, W)`` of the ``highest`` pack
    (on the CPU the fp32 panels too), and run as three TF32 tensor-core
    products on the ``wgmma`` body's TF32 mode (``csrc/x3_wgmma.cuh``: the
    planes by TMA; the instantiation of :func:`spmm_window` at
    ``highest``, so the two equal each other bit for bit); fp64 on the
    FP64 tensor cores, the
    DMMA body of #11 (``csrc/dd_tc.cu``) with one chunk a group, s = g
    over ``ws[g]``: each C element one accumulator chain, k upward, so a
    launch equals the next bit for bit, and equals
    :func:`~crp_tpu_torch.kernels.spmm_ragged.spmm_ragged` on the same
    panels written as a ragged pack.  Both bodies copy the panels in
    16-byte pieces (TMA for fp32), so the panels must start on 16 bytes; TM
    % 128 and W % 32 must be 0.  Bound by the products (fp32: 3 x 2 G TM W
    n at 495 TFLOP/s; fp64: 2 G TM W n at 67 TFLOP/s).  Replaces
    ``spmm_window_pallas_sg`` (``spmm_pallas.py:940``)."""
    if _placement("spmm_window_sg", ws, tiles, b) == "cpu":
        return spmm_window_sg_plain(ws, tiles, b)
    if tiles.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"spmm_window_sg: panels must be fp32 or fp64, not {tiles.dtype}")
    views = (_tf32_plane_views("spmm_window_sg", tiles) if tiles.dtype == torch.float32
             else (tiles,))
    G, TM, W, n = _check_cuda_args(
        "spmm_window_sg", ws, views, b, min_b_rows, tiles.dtype, tiles.dtype,
    )
    _check_aligned("spmm_window_sg", tiles=tiles)
    c = torch.empty((G * TM, n), dtype=tiles.dtype, device=b.device)
    name = "crp_window_sg_f32" if tiles.dtype == torch.float32 else "crp_window_sg_f64"
    _launch(
        name, (ws.data_ptr(), tiles.data_ptr(), b.data_ptr(), c.data_ptr()),
        G, TM, W, n, b.device,
    )
    spmm_window_sg.launches += 1
    return c


spmm_window_sg.launches = 0


def window_entry(name: str, panels: tuple, precision: str) -> tuple:
    """(entry, panel dtype, B dtype) of the non-super-grouped kernel that
    takes ``panels`` (a pair, or one tensor) at ``precision``, for the
    wrapper ``name`` (#4 ``crp_window_*``, #12 ``crp_halo_*``): the x3
    bf16 pair, the default bf16 hi plane, fp32 TF32 planes at ``highest``
    (#4 one ``(2, G, TM, W)`` tensor, #12 the pair ``(big, small)``), fp64
    panels; raises where there is none (fp32 panels at ``x3`` or
    ``default``: those packs hold the pair or the hi plane)."""
    stem = {"spmm_window": "crp_window", "spmm_halo": "crp_halo"}[name]
    dtype = panels[0].dtype if len({t.dtype for t in panels}) == 1 else None
    pair = len(panels) == 2
    if pair and dtype == torch.bfloat16 and precision == "x3":
        return f"{stem}_x3", torch.bfloat16, torch.float32
    if not pair and dtype == torch.bfloat16 and precision == "default":
        return f"{stem}_bf16", torch.bfloat16, torch.bfloat16
    if (dtype == torch.float32 and precision == "highest"
            and pair == (name == "spmm_halo")):
        return f"{stem}_f32", torch.float32, torch.float32
    if not pair and dtype == torch.float64:
        return f"{stem}_f64", torch.float64, torch.float64
    got = f"a {dtype} pair" if pair else f"{dtype} panels"
    raise ValueError(f"{name}: no kernel for {got} at {precision!r}")


def spmm_window(ws, tiles, b, precision: str, *, min_b_rows: int):
    """Non-super-grouped windowed SpMM (``csrc/window.cu``): (G*TM, n) at
    ``precision`` from, at ``x3``, the bf16 pair ``tiles = (ah, al)`` and
    fp32 ``b`` (#1's ``wgmma`` body), at ``default`` the bf16 hi plane
    ``tiles`` and bf16 ``b`` (#2's one-pass body; fp32 C), at ``highest``
    the TF32 planes ``tiles`` (``(2, G, TM, W)``, split once when packed)
    and fp32 ``b`` (3xTF32 on the tensor cores, the ``wgmma`` body's TF32
    mode, held to the fp32 plain version; the instantiation of
    :func:`spmm_window_sg`'s fp32 entry), or fp64 tiles and B (on the FP64
    tensor cores: #11's DMMA body with its windowed walk,
    ``csrc/dd_tc.cu``, the same instantiation as :func:`spmm_window_sg`'s
    fp64 entry); the panels must start on 16 bytes (TMA, 16-byte
    ``cp.async``: the bf16 and fp64 ones are checked here, and the fp32
    entry refuses a launch on others, which raises).  fp32 panels at ``x3`` and
    ``default`` have no kernel: the packs hold the pair and the plane.
    Replaces ``spmm_window_pallas`` (``spmm_pallas.py:267``)."""
    pair = isinstance(tiles, tuple)
    panels = tiles if pair else (tiles,)
    if _placement("spmm_window", ws, *panels, b) == "cpu":
        return spmm_window_plain(ws, tiles, b, precision)
    name, panel_dtype, b_dtype = window_entry("spmm_window", panels, precision)
    views = _tf32_plane_views("spmm_window", tiles) if name == "crp_window_f32" else panels
    G, TM, W, n = _check_cuda_args("spmm_window", ws, views, b, min_b_rows,
                                   panel_dtype, b_dtype)
    if panel_dtype == torch.bfloat16:
        _check_aligned("spmm_window", **dict(zip(("ah", "al"), panels)))
    elif panel_dtype == torch.float64:
        _check_aligned("spmm_window", tiles=tiles)
    c = torch.empty((G * TM, n), dtype=torch.float64 if panel_dtype == torch.float64
                    else torch.float32, device=b.device)
    _launch(name, (ws.data_ptr(), *(t.data_ptr() for t in panels), b.data_ptr(),
                   c.data_ptr()),
            G, TM, W, n, b.device)
    spmm_window.launches += 1
    return c


spmm_window.launches = 0

KERNELS = (spmm_window_sg_presplit, spmm_window_sg_presplit_ab,
           spmm_window_sg_bf16, spmm_window_sg, spmm_window)
