"""On-device densify of uniform window panels.

Counterpart of ``crp_tpu/kernels/device_pack.py:55-147``, and the port's
replacement for both it and the native host packer
(``native.pack_window_flat_bf16``): only the O(nnz) flat positions
``r*W + (c - ws[g])`` and the values travel to the device, which scatters
them into zeroed panels and splits those to bf16 in RNE.  The split is
bit-identical to the native ``split_bf16_one`` (``fastops.cpp:206-215``)
that the JAX packs use, so one matrix gives the same panels in both
packages (``tests/test_torch_device_pack.py``).
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
    flat = torch.from_numpy(r * W + off).to(device)  # int64: G_sg*TM*W ~ 2^31
    panel_dtype = torch.float64 if mode == "f64" else torch.float32
    vals = torch.from_numpy(np.asarray(v, dtype=np.float64 if mode == "f64" else np.float32))
    t = torch.zeros(G_sg * TM * W, dtype=panel_dtype, device=device)
    t.index_put_((flat,), vals.to(device), accumulate=True)
    del flat
    t = t.view(G_sg, TM, W)
    ws_full = np.zeros(G_sg, dtype=np.int32)
    ws_full[: len(ws_shard)] = ws_shard
    if mode in ("f32", "f64"):
        return ws_full, t, None
    ah, al = split_bf16(t, with_lo=mode == "pair")
    return ws_full, ah, al
