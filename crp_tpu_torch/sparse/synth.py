"""Deterministic synthetic sparse matrices (``crp_tpu/sparse/synth.py``).

Banded FEM-like matrices (pwtk-class) and power-law graphs
(com-Orkut-class) from fixed seeds, the same arrays as the JAX package's
generators; ``fill_b`` is the reference's analytic B
(``examples/test_utils.c:121-154``).
"""

from __future__ import annotations

import numpy as np

from .csr import CSRMatrix


def banded_random_csr(n: int, nnz_per_row: int = 53, bandwidth: int = 2500,
                      seed: int = 1234, dtype=np.float64) -> CSRMatrix:
    """Banded random matrix ~ pwtk-class: ``nnz_per_row - 1`` columns
    uniform within ``bandwidth`` of the diagonal (clipped), plus the
    diagonal, duplicates removed."""
    rng = np.random.default_rng(seed)
    k = max(1, nnz_per_row - 1)
    offsets = rng.integers(-bandwidth, bandwidth + 1, size=(n, k))
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    cols = np.clip(rows + offsets.ravel(), 0, n - 1)
    rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
    cols = np.concatenate([cols, np.arange(n, dtype=np.int64)])
    key = rows * n + cols
    _, uniq_idx = np.unique(key, return_index=True)
    rows, cols = rows[uniq_idx], cols[uniq_idx]
    vals = rng.standard_normal(rows.shape[0]).astype(dtype)
    return CSRMatrix.from_coo(n, n, rows, cols, vals, dtype=dtype)


def _powerlaw_degrees(rng, n: int, alpha: float, avg_degree: int) -> np.ndarray:
    deg = rng.zipf(alpha, size=n).astype(np.int64)
    deg = np.minimum(deg, n // 2)
    return np.maximum((deg * avg_degree) // max(int(deg.mean()), 1), 1)


def powerlaw_random_csr(n: int, avg_degree: int = 30, alpha: float = 2.1,
                        seed: int = 1234, dtype=np.float64) -> CSRMatrix:
    """Power-law degree graph adjacency ~ com-Orkut-class."""
    rng = np.random.default_rng(seed)
    deg = _powerlaw_degrees(rng, n, alpha, avg_degree)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = rng.integers(0, n, size=rows.shape[0])
    key = rows * n + cols
    _, uniq_idx = np.unique(key, return_index=True)
    rows, cols = rows[uniq_idx], cols[uniq_idx]
    vals = rng.standard_normal(rows.shape[0]).astype(dtype)
    return CSRMatrix.from_coo(n, n, rows, cols, vals, dtype=dtype)


def powerlaw_community_csr(n: int, avg_degree: int = 16, comm_size: int = 1024,
                           p_local: float = 0.85, alpha: float = 2.1,
                           seed: int = 1234, permute: bool = False,
                           dtype=np.float64) -> CSRMatrix:
    """Community-structured power-law graph: ``p_local`` of each vertex's
    edges inside its own contiguous ``comm_size`` block, the rest to
    degree-weighted targets (hubs); ``permute=True`` scrambles the ids."""
    rng = np.random.default_rng(seed)
    deg = _powerlaw_degrees(rng, n, alpha, avg_degree)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    m = len(rows)
    local = rng.random(m) < p_local
    cols = np.empty(m, dtype=np.int64)
    comm_lo = (rows // comm_size) * comm_size
    width = np.minimum(comm_lo + comm_size, n) - comm_lo
    cols[local] = comm_lo[local] + rng.integers(0, width[local])
    cum = np.cumsum(deg)
    u = rng.integers(0, cum[-1], size=(~local).sum())
    cols[~local] = np.searchsorted(cum, u, side="right")
    if permute:
        perm = rng.permutation(n)
        rows, cols = perm[rows], perm[cols]
    key = rows * n + cols
    _, uniq_idx = np.unique(key, return_index=True)
    rows, cols = rows[uniq_idx], cols[uniq_idx]
    vals = rng.standard_normal(rows.shape[0]).astype(dtype)
    return CSRMatrix.from_coo(n, n, rows, cols, vals, dtype=dtype)


def fill_b(srow: int, nrow: int, scol: int, ncol: int, factor_i: float = 0.19,
           factor_j: float = 0.24, dtype=np.float64) -> np.ndarray:
    """Analytic B block ``B[i, j] = factor_i*i + factor_j*j`` in global
    indices (the reference's ``fill_B``)."""
    i = np.arange(srow, srow + nrow, dtype=dtype)[:, None]
    j = np.arange(scol, scol + ncol, dtype=dtype)[None, :]
    return factor_i * i + factor_j * j
