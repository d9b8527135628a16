"""The bandwidth-bound (v1) planner (``crp_tpu/plan/bandwidth.py``, numpy
only).

The decision procedure of the v1 engine's embedded planner
(``deprecated/src/crpspmm.c:133-195``; standalone driver
``deprecated/examples/crpspmm_calc_partition.c``): the greedy prime-factor
loop decides "split M or split N" per factor, costing a row panel's B
requirement by the contiguous column range ``[min_col, max_col]`` of its
rows.  It reproduces three reference quirks, which the oracle fixture
``tests/fixtures/bandwidth_oracle.json`` pins:

  * per-row ranges are the v1 ``A_cidx_se`` values: EMPTY rows read their
    neighbours' first / last columns (``crpspmm.c:111-117``; pass
    ``row_col_ranges_v1()``);
  * the last row panel stops at the first row whose rowptr reaches
    ``A_nnz``: trailing empty rows stay outside every panel
    (``crpspmm.c:167-183``);
  * per-panel B-copy sizes accumulate in C ``size_t``: a negative window
    extent wraps modulo 2^64 (``crpspmm.c:181``).

Requires colidx sorted within each row (``crpspmm.c:108``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.blocks import uniform_displs
from .partition1d import prime_factorization

SIZE_MAX = (1 << 64) - 1
_M64 = 1 << 64
NNZ_COST_FACTOR = 1.5


@dataclasses.dataclass
class BandwidthPlan:
    nproc: int
    m: int
    n: int
    k: int
    np_row: int               # m_split
    np_col: int               # n_split
    m_split_idx: np.ndarray   # (np_row+1,) row panel boundaries of A/C
    B_rd_row_displs: np.ndarray  # (np_row+1,) uniform internal B row slabs
    BC_colptr: np.ndarray     # (np_col+1,) uniform B/C column slabs
    B_windows: np.ndarray     # (np_row, 2) per row panel [loc_B_srow, loc_B_erow)
    copy_B_size: int          # final B-copy cost term (elements, size_t)


def _panel_boundaries(rowptr: np.ndarray, m: int, nsplit: int) -> np.ndarray:
    """Row panel boundaries for the v1 nnz-balance scan.

    Panel j ends at the first row index > its start whose rowptr reaches the
    quota ``A_nnz // nsplit * (j+1)`` (``deprecated/src/crpspmm.c:163-183``).
    The last quota is ``A_nnz`` itself, so the final boundary is the first
    row index past the last nonzero — NOT ``m`` when trailing rows are
    empty (reference parity; see module docstring).
    """
    a_nnz = int(rowptr[m])
    quotas = (a_nnz // nsplit) * np.arange(1, nsplit + 1, dtype=np.int64)
    quotas[-1] = a_nnz
    e = np.searchsorted(rowptr[: m + 1], quotas, side="left").astype(np.int64)
    # each scan starts at srow + 1 => enforce e_j >= e_{j-1} + 1 (and >= 1)
    e = np.maximum(e, 1)
    j = np.arange(nsplit, dtype=np.int64)
    e = np.maximum.accumulate(e - j) + j
    idx = np.empty(nsplit + 1, dtype=np.int64)
    idx[0] = 0
    idx[1:] = e
    if idx[-1] > m:
        # the forced +1 per-panel increments ran past m: several quota
        # boundaries collapsed onto the matrix end (nnz concentrated in
        # trailing rows).  The reference scans past rowptr here (undefined
        # behaviour, deprecated/src/crpspmm.c:163-183); fail loudly instead.
        raise ValueError(
            f"cannot nnz-balance {m} rows into {nsplit} panels: trailing "
            f"rows hold too few distinct quota boundaries (degenerate "
            f"trailing-nnz distribution) — use fewer splits or the exact "
            f"planner (plan_from_csr)"
        )
    return idx


def _panel_b_windows(ranges: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Per-panel [min_col, max_col+1) windows from per-row v1 ranges.

    Only rows inside panels (``< idx[-1]``) participate, exactly like the
    reference scan; a window may have NEGATIVE extent when the empty-row
    quirk inverts min/max — callers must treat it like the reference does
    (size_t wrap in costs, empty row list in exchanges)."""
    nsplit = idx.shape[0] - 1
    starts = idx[:-1]
    r = ranges[: int(idx[-1])]
    out = np.empty((nsplit, 2), dtype=np.int64)
    out[:, 0] = np.minimum.reduceat(r[:, 0], starts)
    out[:, 1] = np.maximum.reduceat(r[:, 1], starts) + 1
    return out


def _copy_b_size(windows: np.ndarray, n: int) -> int:
    """sum over panels of (size_t)(max-min+1) * n, in C size_t arithmetic
    (``deprecated/src/crpspmm.c:181``)."""
    total = 0
    for w in (windows[:, 1] - windows[:, 0]).tolist():
        total = (total + (int(w) % _M64) * n) % _M64
    return total


def calc_bandwidth_part2d(
    nproc: int,
    m: int,
    n: int,
    k: int,
    rowptr: np.ndarray,
    row_ranges: np.ndarray,
    dbg_print: bool = False,
) -> BandwidthPlan:
    """Greedy split-M / split-N search with bandwidth-bound B cost.

    ``row_ranges`` is the (m, 2) per-row [min colidx, max colidx] array in
    the reference's v1 semantics — ``CSRMatrix.row_col_ranges_v1()`` /
    ``DistCSR.row_col_ranges_v1()`` (the engine allgathers these at init,
    ``deprecated/src/crpspmm.c:107-131``).

    ``dbg_print`` dumps the per-factor cost comparison in the style of
    the reference's standalone driver
    (``deprecated/examples/crpspmm_calc_partition.c:60-116``).
    """
    rowptr = np.asarray(rowptr)
    row_ranges = np.asarray(row_ranges)
    a_nnz = int(rowptr[m])

    m_split, n_split = 1, 1
    m_split_idx = np.array([0, m], dtype=np.int64)
    curr_copy_b = int(k) * int(n)  # one copy of B to start
    fac = prime_factorization(nproc)
    nfac = len(fac)
    for i in range(nfac):
        p_i = fac[nfac - 1 - i]
        if dbg_print:
            print(f"step {i}: factor {p_i}")
        # Split N: B copies unchanged, A copies multiplied by p_i
        a_copy_cost1 = int(float(a_nnz) * float(n_split) * NNZ_COST_FACTOR)
        split_n_cost = (a_copy_cost1 * p_i + curr_copy_b) % _M64
        if n_split * p_i > n:
            split_n_cost = SIZE_MAX
        if dbg_print:
            print(f"  split-N cost: copy A = {a_copy_cost1 * p_i}, "
                  f"copy B = {curr_copy_b}, total = {split_n_cost}")
        # Split M: A copies unchanged, recompute panel B ranges
        trial_m = m_split * p_i
        if trial_m > m:
            # more row panels than rows: the reference scans past rowptr's
            # end (undefined behaviour) — treat as infeasible instead
            split_m_cost = SIZE_MAX
            idx2, copy_b2 = m_split_idx, curr_copy_b
        else:
            try:
                idx2 = _panel_boundaries(rowptr, m, trial_m)
            except ValueError:
                # quota boundaries collapse past m (trailing-nnz degenerate
                # input, reference UB) — this M split is infeasible, but a
                # split-N alternative may still yield a valid plan
                split_m_cost = SIZE_MAX
                idx2, copy_b2 = m_split_idx, curr_copy_b
            else:
                windows = _panel_b_windows(row_ranges, idx2)
                copy_b2 = _copy_b_size(windows, n)
                split_m_cost = (a_copy_cost1 + copy_b2) % _M64
                if dbg_print:
                    for j in range(trial_m):
                        w0, w1 = int(windows[j, 0]), int(windows[j, 1])
                        print(
                            f"  row block {j}: rows [{idx2[j]}, "
                            f"{idx2[j + 1]}), B rows to copy: "
                            f"[{w0}, {w1}) ({w1 - w0})"
                        )
        if split_m_cost == SIZE_MAX and split_n_cost == SIZE_MAX:
            # neither axis can absorb this factor (M split exceeds m or
            # degenerates on trailing-nnz quota collapse; N split exceeds
            # n): growing n_split past n would emit empty B/C column
            # slabs — surface the nproc-too-large condition
            raise ValueError(
                f"bandwidth planner: cannot split factor {p_i} — the M "
                f"split is infeasible (m_split={m_split}*{p_i} vs m={m}, "
                f"or degenerate trailing-nnz quotas) and "
                f"n_split={n_split}*{p_i} > n={n}; reduce nproc"
            )
        if dbg_print:
            print(f"  split-M cost: copy A = {a_copy_cost1}, "
                  f"copy B = {copy_b2}, total = {split_m_cost}")
        if split_m_cost < split_n_cost:
            m_split = trial_m
            curr_copy_b = copy_b2
            m_split_idx = idx2
        else:
            n_split *= p_i
        if dbg_print:
            axis = "M" if split_m_cost < split_n_cost else "N"
            print(f"  -> split {axis}: m_split = {m_split}, "
                  f"n_split = {n_split}\n")

    windows = _panel_b_windows(row_ranges, m_split_idx)
    return BandwidthPlan(
        nproc=nproc, m=m, n=n, k=k, np_row=m_split, np_col=n_split,
        m_split_idx=m_split_idx,
        B_rd_row_displs=uniform_displs(k, m_split),
        BC_colptr=uniform_displs(n, n_split),
        B_windows=windows,
        copy_B_size=curr_copy_b,
    )
