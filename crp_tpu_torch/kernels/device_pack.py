"""On-device densify of uniform window panels and ragged chunk panels.

Counterpart of ``crp_tpu/kernels/device_pack.py``, and the port's
replacement for both it and the native host packers
(``native.pack_window_flat_bf16``, ``native.ragged_fill_*``): only the
O(nnz) flat panel positions and the values travel to the device, which
scatters them into zeroed panels and splits those to bf16 in RNE.  The
split is bit-identical to the native ``split_bf16_one``
(``fastops.cpp:206-215``) that the JAX packs use, so one matrix gives the
same panels in both packages (``tests/test_torch_device_pack.py``,
``tests/test_torch_ragged.py``).  In the bf16 modes the panels are
densified slab by slab through one reused fp32 buffer, so the fp32 panels
never exist whole beside their bf16 planes.  Every fp32 panel pack at
``highest`` (#3's and #4's uniform packs, #12's halo plan, #6's ragged
pack) densifies the same way to two fp32 planes, the operand bits of the
TF32 split (``"tf32"`` mode, :func:`tf32_operands`): TMA copies bytes,
and the tensor cores truncate an fp32 operand.
"""

from __future__ import annotations

import numpy as np
import torch

from .spmm_pallas import UnsupportedSparsity

_SPLIT_CHUNK = 1 << 26  # elements per split step: bounds the fp32 temporaries
_SLAB = 1 << 25  # panel elements densified at a time in the bf16 modes (whole panels)

MODES = ("pair", "bf16", "tf32", "f32", "f64")


def panel_mode(dtype, precision: str) -> str:
    """The densify mode of a pack of ``dtype`` at operating point
    ``precision``: on fp32 the operands of the ``wgmma`` body (fed by TMA,
    which copies and can neither split nor round), the bf16 hi/lo pair at
    ``x3``, the hi plane at ``default`` and the TF32 planes at ``highest``;
    fp64 panels in fp64."""
    if np.dtype(dtype) == np.float64:
        return "f64"
    if np.dtype(dtype) == np.float32:
        return {"x3": "pair", "default": "bf16", "highest": "tf32"}.get(precision, "f32")
    return "f32"


def tf32_operands(x: torch.Tensor, big: torch.Tensor, small: torch.Tensor) -> None:
    """Write into fp32 ``big`` and ``small`` (x's shape) the bits that
    ``split_tf32`` (``csrc/panel_tiles.cuh``) hands the tensor cores for
    fp32 ``x``: big is x's bits plus half a TF32 ulp, whose top 19 bits
    (what the tensor cores read) are cvt.rna's rounding of x; small is the
    same of the exact remainder x - big, clamped so that a NaN stays one.
    So the values the products see are ``spmm_pallas.split_tf32``'s bit
    for bit, and x is big's bits less half an ulp
    (:func:`~crp_tpu_torch.kernels.spmm_pallas.tf32_panels`)."""
    bi, si = big.view(torch.int32), small.view(torch.int32)
    torch.add(x.view(torch.int32), 0x1000, out=bi)
    rem = x - (bi & -0x2000).view(torch.float32)
    torch.clamp(rem.view(torch.int32), max=0x7FFFEFFF, out=si)
    si.add_(0x1000)


def _split_into(x: torch.Tensor, big: torch.Tensor, small: torch.Tensor) -> None:
    """:func:`tf32_operands` of ``x`` into ``big`` and ``small`` (flat, x's
    size) in steps of ``_SPLIT_CHUNK`` elements."""
    x = x.reshape(-1)
    for j in range(0, x.numel(), _SPLIT_CHUNK):
        s = slice(j, j + _SPLIT_CHUNK)
        tf32_operands(x[s], big[s], small[s])


def tf32_planes(panels: torch.Tensor) -> torch.Tensor:
    """fp32 stacked panels ``(p, G, TM, W)`` -> their TF32 planes ``(p,
    2, G, TM, W)`` (:func:`tf32_operands`; shard i's big plane then its
    small one, as #3's and #4's entries take them)."""
    out = torch.empty((panels.shape[0], 2, *panels.shape[1:]), dtype=torch.float32,
                      device=panels.device)
    for i in range(panels.shape[0]):
        _split_into(panels[i], out[i, 0].view(-1), out[i, 1].view(-1))
    return out


def tf32_pair(panels: torch.Tensor) -> tuple:
    """fp32 panels -> their TF32 planes as two tensors of the panels'
    shape, ``(big, small)`` (:func:`tf32_operands`), as #12's and #6's
    entries take them."""
    big, small = (torch.empty(panels.shape, dtype=torch.float32, device=panels.device)
                  for _ in range(2))
    _split_into(panels, big.view(-1), small.view(-1))
    return big, small


def zero_panels(planes, mode: str) -> None:
    """Fill ``planes`` (one pack's, in ``mode``) with those of all-zero
    panels: zeros, but in "tf32" the split of 0, whose bits are half a TF32
    ulp (:func:`tf32_operands`; the tensor cores read 0), so that the fp32
    panels come back from the big plane exactly there too."""
    for t in planes:
        if mode == "tf32":
            t.view(torch.int32).fill_(0x1000)
        else:
            t.zero_()


def split_bf16(t: torch.Tensor, with_lo: bool):
    """RNE bf16 hi (and lo = bf16(t - hi)) halves of fp32 ``t``."""
    flat = t.reshape(-1)
    ah = torch.empty(flat.shape, dtype=torch.bfloat16, device=t.device)
    al = torch.empty_like(ah) if with_lo else None
    for i in range(0, flat.numel(), _SPLIT_CHUNK):
        x = flat[i : i + _SPLIT_CHUNK]
        hi = x.to(torch.bfloat16)
        ah[i : i + _SPLIT_CHUNK] = hi
        if with_lo:
            al[i : i + _SPLIT_CHUNK] = (x - hi.float()).to(torch.bfloat16)
    return ah.view(t.shape), (al.view(t.shape) if with_lo else None)


def uniform_fill(rowptr64, cc, v, nrow, TM, W, G_sg, ws_shard, mode, device):
    """Densify one shard into ``(G_sg, TM, W)`` panels on ``device``
    (:func:`uniform_fill_stacked` with one shard).  Returns ``(ws_full, ah,
    al_or_None)``; ``ws_full`` (G_sg,) int32 holds the shard's window
    starts and zeros for the pad groups."""
    ws, ah, al = uniform_fill_stacked([(rowptr64, cc, v)], [ws_shard], TM, W,
                                      G_sg, mode, device)
    return ws[0], ah[0], None if al is None else al[0]


def uniform_fill_stacked(shards, ws_shards, TM, W, G, mode, device, keep=None, out=None):
    """Densify shards into ``(p, G, TM, W)`` panels at a shared window
    width ``W`` and group count ``G`` on ``device`` (the uniform packs; the
    multi-shard one is ``crp_tpu/kernels/dispatch.py:637-668``).

    ``shards`` are ``(rowptr, cc, v)``; ``ws_shards[i]`` is shard i's
    window starts, None for an empty shard (all-zero panels, ``ws`` 0).
    ``mode``: "pair" (x3 hi/lo bf16), "bf16" (1-pass), "tf32" (the TF32
    planes, ``(p, 2, G, TM, W)``, or into ``out``), "f32" / "f64"
    (full-precision panels).
    Duplicate entries add, as ``np.add.at`` does in the JAX host pack
    (``spmm_pallas.py:181``).  Returns ``(ws (p, G) int32, ah, al_or_None)``
    (``ah`` the planes in "tf32"); pad groups past a shard's own have zero
    panels and ``ws`` 0.  ``keep``: the one shard whose panels are
    densified, ``(1, G, TM, W)`` (a mesh rank's slice); every shard's
    ``ws`` and column check all the same.  ``out``: the planes to fill (as
    :func:`_densify` takes them), else new ones.
    """
    if mode not in MODES:
        raise ValueError(f"unknown densify mode {mode!r}")
    p = len(shards)
    ws = np.zeros((p, G), dtype=np.int32)
    flats, vals = [], []
    val_dtype = np.float64 if mode == "f64" else np.float32
    for i, ((rowptr, cc, v), ws_i) in enumerate(zip(shards, ws_shards)):
        if ws_i is None:
            continue
        rowptr64 = np.asarray(rowptr, dtype=np.int64)
        if int(rowptr64[0]) != 0:
            raise ValueError("rowptr must start at 0")
        nrow, nnz = len(rowptr64) - 1, int(rowptr64[-1])
        r = np.repeat(np.arange(nrow, dtype=np.int64), np.diff(rowptr64))
        off = np.asarray(cc[:nnz], dtype=np.int64) - ws_i.astype(np.int64)[r // TM]
        if len(off) and (int(off.min()) < 0 or int(off.max()) >= W):
            # window_extents reads each row's first and last column
            raise UnsupportedSparsity(
                "column outside its group's window: columns are not sorted "
                "within each row"
            )
        ws[i, : len(ws_i)] = ws_i
        if keep is not None and i != keep:
            continue
        # int64 positions: p*G*TM*W reaches 2^31
        slot = i if keep is None else 0
        flats.append((slot * G * TM + r) * W + off)
        vals.append(np.asarray(v[:nnz], dtype=val_dtype))
    flat = np.concatenate(flats) if flats else np.zeros(0, np.int64)
    val = np.concatenate(vals) if vals else np.zeros(0, val_dtype)
    ah, al = _densify(flat, val, (p if keep is None else 1, G, TM, W), mode, device,
                      out=out)
    return ws, ah, al


def _slabs(cuts, per: int) -> np.ndarray:
    """Slab bounds, in panels, from the sorted panel indices ``cuts`` where
    a slab may end (the first 0, the last the panel count): each slab runs
    from one cut to the furthest that keeps it within ``_SLAB`` elements of
    ``per`` each, and at least to the next cut."""
    bounds, k = [int(cuts[0])], 0
    while k < len(cuts) - 1:
        far = int(np.searchsorted(cuts, bounds[-1] + max(_SLAB // per, 1), side="right")) - 1
        k = max(far, k + 1)
        bounds.append(int(cuts[k]))
    return np.asarray(bounds, dtype=np.int64)


def _densify(flat, vals, shape, mode, device, cuts=None, out=None):
    """Scatter-add ``vals`` at ``flat`` into zeroed panels of ``shape`` on
    ``device`` (duplicates add, as the JAX host packs' ``+=``), then split
    per ``mode``: (panels, None) for "f32"/"f64"; for "tf32" (planes, None),
    the stacked ``(shape[0], 2, *shape[1:])`` planes of #3 and #4, or, with
    ``out`` two tensors of ``shape``, (big, small), #12's and #6's; (ah,
    al_or_None) else.

    "f32"/"f64" scatter once: the panels are the output.  The split modes
    never hold the whole fp32 tensor: slab by slab of whole panels (at most
    ``_SLAB`` elements where the cuts allow), the slab's nonzeros are
    scattered into one reused fp32 buffer, which is split into the output
    planes with :func:`split_bf16`'s RNE split, bit for bit, or with
    :func:`tf32_operands`.  ``cuts``
    (default: every panel) are the panel indices where a slab may end: the
    nonzeros of the panels below a cut all precede, in ``flat``, those at
    or past it, so ``np.searchsorted`` finds each slab's run of ``flat``.
    ``out``: the planes to fill, of ``shape`` (a shard's view of a stacked
    pack; "tf32": the stacked planes, or big and small apart), else new
    ones (the stacked planes in "tf32")."""
    if mode in ("f32", "f64"):
        t = out[0] if out is not None else torch.empty(
            shape, dtype=torch.float64 if mode == "f64" else torch.float32, device=device)
        t.zero_()
        t.view(-1).index_put_((torch.from_numpy(flat).to(device),),
                              torch.from_numpy(vals).to(device), accumulate=True)
        return t, None
    tf32 = mode == "tf32"
    if out is None and tf32:
        out = (torch.empty((shape[0], 2, *shape[1:]), dtype=torch.float32, device=device),)
    elif out is None:
        out = tuple(torch.empty(shape, dtype=torch.bfloat16, device=device)
                    for _ in range(2 if mode == "pair" else 1))
    if tf32 and len(out) == 2:  # big and small apart: one run of elements
        segs = [(out[0].view(-1), out[1].view(-1))]
    elif tf32:  # (shards, big/small, elements of a shard)
        segs = [(x[0], x[1]) for x in out[0].view(out[0].shape[0], 2, -1)]
    else:
        ah, al = out[0].view(-1), (out[1].view(-1) if mode == "pair" else None)
    per = int(np.prod(shape[-2:]))  # elements of one panel
    cuts = np.arange(int(np.prod(shape)) // per + 1) if cuts is None else np.asarray(cuts)
    bounds = _slabs(cuts, per) * per
    runs = np.searchsorted(flat, bounds)
    buf = torch.empty(int(np.diff(bounds).max(initial=0)), dtype=torch.float32,
                      device=device)
    for lo, hi, i0, i1 in zip(bounds[:-1], bounds[1:], runs[:-1], runs[1:]):
        x = buf[: hi - lo].zero_()
        x.index_put_((torch.from_numpy(flat[i0:i1] - lo).to(device),),
                     torch.from_numpy(vals[i0:i1]).to(device), accumulate=True)
        if tf32:  # the slab's run of each segment it spans
            size = segs[0][0].numel()
            for i in range(int(lo) // size, (int(hi) - 1) // size + 1):
                a, b = max(int(lo), i * size), min(int(hi), (i + 1) * size)
                big, small = segs[i]
                tf32_operands(x[a - lo: b - lo], big[a - i * size: b - i * size],
                              small[a - i * size: b - i * size])
        else:
            ah[lo:hi].copy_(x)  # RNE, as x.to(torch.bfloat16)
            if al is not None:
                al[lo:hi].copy_(x.sub_(ah[lo:hi]))  # the exact remainder, rounded
    return out[0], (out[1] if len(out) == 2 else None)


def ragged_place(rowptr64, cc, v, TM, Wc, starts, group_ptr, mode) -> tuple:
    """The host half of :func:`ragged_fill`: ``(flat, vals, cuts,
    spill)``, each panel nonzero's flat position and value, the slab cuts
    and the spill COO; a mesh rank takes the other shards' spills from it
    without densifying their panels."""
    if mode not in MODES:
        raise ValueError(f"unknown densify mode {mode!r}")
    rowptr64 = np.asarray(rowptr64, dtype=np.int64)
    if int(rowptr64[0]) != 0:
        raise ValueError("rowptr must start at 0")
    nrow = len(rowptr64) - 1
    nnz = int(rowptr64[-1])
    S = len(starts)
    r = np.repeat(np.arange(nrow, dtype=np.int64), np.diff(rowptr64))
    g = r // TM
    cols = np.asarray(cc[:nnz], dtype=np.int64)
    starts64 = np.asarray(starts, dtype=np.int64)
    # every group's chunk search in ONE searchsorted: key = group*span + col
    # with span past any col + Wc keeps the groups' key ranges disjoint
    span = int(max(cols.max(initial=0), starts64.max(initial=0))) + Wc + 1
    chunk_group = np.repeat(np.arange(len(group_ptr) - 1, dtype=np.int64),
                            np.diff(np.asarray(group_ptr, dtype=np.int64)))
    ch = np.searchsorted(chunk_group * span + starts64[: len(chunk_group)],
                         g * span + cols, side="right") - 1
    chc = np.clip(ch, 0, None)
    off = cols - starts64[chc]
    inside = (ch >= 0) & (chunk_group[chc] == g) & (off >= 0) & (off < Wc)
    pi = np.flatnonzero(inside)
    flat = (chc[pi] * TM + (r[pi] - g[pi] * TM)) * Wc + off[pi]
    val_dtype = np.float64 if mode == "f64" else np.float32
    vals = np.asarray(v[:nnz], dtype=val_dtype)
    # slabs end at group boundaries, and past the last group's at S
    cuts = np.union1d(np.asarray(group_ptr, dtype=np.int64), [0, S])
    si = np.flatnonzero(~inside)
    spill = (r[si].astype(np.int32), cols[si].astype(np.int32), vals[si])
    return flat, vals[pi], cuts, spill


def ragged_fill(rowptr64, cc, v, TM, Wc, starts, group_ptr, mode, device, out=None):
    """Densify one shard into ragged chunk panels ``(S, TM, Wc)`` on
    ``device`` and extract the spill COO on the host.

    Semantics of the JAX ``ragged_fill_bf16`` (``device_pack.py:150-206``)
    and the native fill (``fastops.cpp:225-309``): a nonzero whose column
    falls inside one of its group's kept chunks (dropped-chunk nonzeros
    included, and a dummy chunk's range too) goes to that chunk's panel;
    the rest spill, in CSR order.  The chunks are the first
    ``group_ptr[-1]`` of ``starts``; steps past them (the no-op steps that
    pad a shard to a common S) keep zero panels.  ``mode`` as in
    :func:`uniform_fill`; ``out`` as in :func:`_densify` (the split modes
    densify group by group: a group's chunks are one run of panels; in
    "tf32" ``out`` is the big and the small plane, each ``(S, TM, Wc)``).
    Returns ``(ah_or_panels, al_or_None, (sp_rows, sp_cols, sp_vals))``
    with spill rows relative to the shard, int32, and values in fp64 for
    "f64", fp32 otherwise.
    """
    flat, vals, cuts, spill = ragged_place(rowptr64, cc, v, TM, Wc, starts, group_ptr,
                                           mode)
    ah, al = _densify(flat, vals, (len(starts), TM, Wc), mode, device, cuts, out)
    return ah, al, spill
