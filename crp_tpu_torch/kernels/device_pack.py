"""On-device densify of uniform window panels and ragged chunk panels.

Counterpart of ``crp_tpu/kernels/device_pack.py``, and the port's
replacement for both it and the native host packers
(``native.pack_window_flat_bf16``, ``native.ragged_fill_*``): only the
O(nnz) flat panel positions and the values travel to the device, which
scatters them into zeroed panels and splits those to bf16 in RNE.  The
split is bit-identical to the native ``split_bf16_one``
(``fastops.cpp:206-215``) that the JAX packs use, so one matrix gives the
same panels in both packages (``tests/test_torch_device_pack.py``,
``tests/test_torch_ragged.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .spmm_pallas import UnsupportedSparsity

_SPLIT_CHUNK = 1 << 26  # elements per split step: bounds the fp32 temporaries

MODES = ("pair", "bf16", "f32", "f64")


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
    """Densify one shard into ``(G_sg, TM, W)`` panels on ``device``.

    ``mode``: "pair" (x3 hi/lo bf16), "bf16" (1-pass), "f32" / "f64"
    (full-precision panels).  Duplicate entries add, as ``np.add.at`` does
    in the JAX host pack (``spmm_pallas.py:181``).  Returns
    ``(ws_full, ah, al_or_None)``; ``ws_full`` (G_sg,) int32 holds the
    shard's window starts and zeros for the pad groups.
    """
    if mode not in MODES:
        raise ValueError(f"unknown densify mode {mode!r}")
    rowptr64 = np.asarray(rowptr64, dtype=np.int64)
    if int(rowptr64[0]) != 0:
        raise ValueError("rowptr must start at 0")
    r = np.repeat(np.arange(nrow, dtype=np.int64), np.diff(rowptr64))
    off = np.asarray(cc, dtype=np.int64) - ws_shard.astype(np.int64)[r // TM]
    if len(off) and (int(off.min()) < 0 or int(off.max()) >= W):
        # window_extents reads each row's first and last column
        raise UnsupportedSparsity(
            "column outside its group's window: columns are not sorted "
            "within each row"
        )
    vals = np.asarray(v, dtype=np.float64 if mode == "f64" else np.float32)
    # int64 positions: G_sg*TM*W reaches 2^31
    ah, al = _densify(r * W + off, vals, (G_sg, TM, W), mode, device)
    ws_full = np.zeros(G_sg, dtype=np.int32)
    ws_full[: len(ws_shard)] = ws_shard
    return ws_full, ah, al


def _densify(flat, vals, shape, mode, device):
    """Scatter-add ``vals`` at ``flat`` into zeroed panels of ``shape`` on
    ``device`` (duplicates add, as the JAX host packs' ``+=``), then split
    per ``mode``: (panels, None) for "f32"/"f64", (ah, al_or_None) else."""
    panel_dtype = torch.float64 if mode == "f64" else torch.float32
    t = torch.zeros(int(np.prod(shape)), dtype=panel_dtype, device=device)
    t.index_put_((torch.from_numpy(flat).to(device),),
                 torch.from_numpy(vals).to(device), accumulate=True)
    t = t.view(shape)
    if mode in ("f32", "f64"):
        return t, None
    return split_bf16(t, with_lo=mode == "pair")


def ragged_fill(rowptr64, cc, v, TM, Wc, starts, group_ptr, mode, device):
    """Densify one shard into ragged chunk panels ``(S, TM, Wc)`` on
    ``device`` and extract the spill COO on the host.

    Semantics of the JAX ``ragged_fill_bf16`` (``device_pack.py:150-206``)
    and the native fill (``fastops.cpp:225-309``): a nonzero whose column
    falls inside one of its group's kept chunks (dropped-chunk nonzeros
    included, and a dummy chunk's range too) goes to that chunk's panel;
    the rest spill, in CSR order.  ``mode`` as in :func:`uniform_fill`.
    Returns ``(ah_or_panels, al_or_None, (sp_rows, sp_cols, sp_vals))``
    with spill rows relative to the shard, int32, and values in fp64 for
    "f64", fp32 otherwise.
    """
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
    ch = np.searchsorted(chunk_group * span + starts64, g * span + cols,
                         side="right") - 1
    chc = np.clip(ch, 0, None)
    off = cols - starts64[chc]
    inside = (ch >= 0) & (chunk_group[chc] == g) & (off >= 0) & (off < Wc)
    pi = np.flatnonzero(inside)
    flat = (chc[pi] * TM + (r[pi] - g[pi] * TM)) * Wc + off[pi]
    val_dtype = np.float64 if mode == "f64" else np.float32
    vals = np.asarray(v[:nnz], dtype=val_dtype)
    ah, al = _densify(flat, vals[pi], (S, TM, Wc), mode, device)
    si = np.flatnonzero(~inside)
    spill = (r[si].astype(np.int32), cols[si].astype(np.int32), vals[si])
    return ah, al, spill
