"""Plan -> padded stacked layout (``crp_tpu/shard/layout.py:17-50``).

Shards are stacked along a leading axis and padded to the largest block;
these numpy helpers move between the user's global row-major matrices and
that layout.  The JAX module also builds device meshes; the port has none
(one device per engine until the multi-GPU engines land).
"""

from __future__ import annotations

import numpy as np


def stack_padded(arrays: list[np.ndarray], pad_value=0, dtype=None) -> np.ndarray:
    """Stack 1D/2D arrays along a new leading axis, padding dim 0 to the max."""
    n = max((a.shape[0] for a in arrays), default=0)
    n = max(n, 1)
    rest = arrays[0].shape[1:] if arrays else ()
    dtype = dtype or arrays[0].dtype
    out = np.full((len(arrays), n) + rest, pad_value, dtype=dtype)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a
    return out


def shard_dense_rows(
    b: np.ndarray, displs: np.ndarray, pad_rows: int | None = None
) -> np.ndarray:
    """Global (k, n) -> stacked padded shards (p, max_rows, n) by row blocks."""
    displs = np.asarray(displs)
    blocks = [b[displs[i] : displs[i + 1]] for i in range(len(displs) - 1)]
    out = stack_padded(blocks, pad_value=0, dtype=b.dtype)
    if pad_rows is not None and out.shape[1] < pad_rows:
        pad = np.zeros((out.shape[0], pad_rows - out.shape[1], out.shape[2]), out.dtype)
        out = np.concatenate([out, pad], axis=1)
    return out


def unshard_dense_rows(c_shards: np.ndarray, displs: np.ndarray) -> np.ndarray:
    """Stacked padded shards (p, max_rows, n) -> global (m, n)."""
    displs = np.asarray(displs)
    c_shards = np.asarray(c_shards)
    return np.concatenate(
        [c_shards[i, : displs[i + 1] - displs[i]] for i in range(len(displs) - 1)],
        axis=0,
    )
