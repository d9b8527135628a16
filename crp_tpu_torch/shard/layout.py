"""Plan -> padded stacked layout (``crp_tpu/shard/layout.py:17-50``).

Shards are stacked along a leading axis and padded to the largest block;
these numpy helpers move between the user's global row-major matrices and
that layout: row blocks ``(p, rows, n)`` for ``RowParaSpmm`` and 2D blocks
``(pm, pn, rows, cols)`` for ``Para2dSpmm`` (``crp_tpu/engine/para2d.py:
399-453``).  The JAX module also builds device meshes; the port's engines
hold every shard on their one device.
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


def shard_dense_2d(b: np.ndarray, row_displs, col_displs, rows: int,
                   cols: int) -> np.ndarray:
    """Global (k, n) -> (pm, pn, rows, cols) blocks: block (i, j) holds
    ``b[row_displs[i]:row_displs[i+1], col_displs[j]:col_displs[j+1]]``,
    zero-padded."""
    pm, pn = len(row_displs) - 1, len(col_displs) - 1
    out = np.zeros((pm, pn, rows, cols), dtype=b.dtype)
    for i in range(pm):
        r0, r1 = int(row_displs[i]), int(row_displs[i + 1])
        for j in range(pn):
            c0, c1 = int(col_displs[j]), int(col_displs[j + 1])
            out[i, j, : r1 - r0, : c1 - c0] = b[r0:r1, c0:c1]
    return out


def unshard_dense_2d(c_blocks: np.ndarray, row_displs, col_displs, m: int,
                     n: int) -> np.ndarray:
    """(pm, pn, rows, cols) blocks -> global (m, n); rows past the last
    block are zero."""
    out = np.zeros((m, n), dtype=c_blocks.dtype)
    for i in range(len(row_displs) - 1):
        r0, r1 = int(row_displs[i]), int(row_displs[i + 1])
        for j in range(len(col_displs) - 1):
            c0, c1 = int(col_displs[j]), int(col_displs[j + 1])
            out[r0:r1, c0:c1] = c_blocks[i, j, : r1 - r0, : c1 - c0]
    return out
