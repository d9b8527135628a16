"""Uniform block partition (``crp_tpu/utils/blocks.py``): ``length``
items in ``nblk`` blocks, the first ``length % nblk`` one larger, as the
reference's ``calc_block_spos_size`` (``src/utils.c:26-48``)."""

from __future__ import annotations

import numpy as np


def calc_block_spos_size(length: int, nblk: int, iblk: int) -> tuple[int, int]:
    """Start position and size of block ``iblk``."""
    if iblk < 0 or iblk > nblk:
        return -1, 0
    rem = length % nblk
    bs0 = length // nblk
    if iblk < rem:
        return (bs0 + 1) * iblk, bs0 + 1
    return bs0 * iblk + rem, bs0


def uniform_displs(length: int, nblk: int) -> np.ndarray:
    """(nblk+1,) displacements of the uniform block partition."""
    rem = length % nblk
    bs0 = length // nblk
    i = np.arange(nblk + 1, dtype=np.int64)
    return np.where(i < rem, (bs0 + 1) * i, bs0 * i + rem).astype(np.int64)
