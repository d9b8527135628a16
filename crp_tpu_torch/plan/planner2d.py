"""The 2D partition planner (``crp_tpu/plan/planner2d.py``): the greedy
grid search of the reference's ``calc_spmm_part2d_from_1d``
(``src/spmat_part.c:85-210``) minimizing communicated elements.

Same greedy order (largest prime factor first), nnz cost factor 1.5, the
``m == k`` B-row rule and the failed-factor memo, so that given the same
matrix, process count and n it picks the same ``pm x pn`` grid and block
boundaries as the reference (``tests/fixtures/planner_oracle.json``).  With
``idx_m0(i) = [A0_rowptr[i], A0_rowptr[i+1])`` etc., before replicating A
rank ``(i, j)`` owns ``A(idx_m0(i*pn + j), :)``, before exchanging B it owns
``B(idx_k(i), idx_n(j))``, and it computes ``C(idx_m(i), idx_n(j))``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np

from ..utils.blocks import uniform_displs
from .partition1d import csr_row_part_comm_size, csr_row_partition, prime_factorization

logger = logging.getLogger("crp_tpu_torch")

NNZ_COST_FACTOR = 1.5  # CSR int32+double cost per nnz / sizeof(double)


@dataclasses.dataclass
class Plan2D:
    """Output of the 2D planner, consumed by ``Para2dSpmm``."""

    nproc: int
    m: int
    n: int
    k: int
    pm: int
    pn: int
    comm_cost: int
    A0_rowptr: np.ndarray   # (nproc+1,) 1D row layout of A before replication
    B_rowptr: np.ndarray    # (pm+1,)    B row slabs
    AC_rowptr: np.ndarray   # (pm+1,)    replicated-A / C row slabs
    BC_colptr: np.ndarray   # (pn+1,)    B/C column slabs
    basic_1d_cost: int = 0
    candidates: list = dataclasses.field(default_factory=list)
    rA_cost: int = 0          # the planner's A-replication cost term
    rB_comm_rows: Optional[np.ndarray] = None  # (pm,) non-owned B rows per row group
    rB_cost: int = 0          # sum(rB_comm_rows) * n

    def device_coords(self, rank: int) -> tuple[int, int]:
        """rank -> (pi, pj) on the row-major pm x pn grid."""
        return rank // self.pn, rank % self.pn

    def describe(self) -> str:
        """Text dump in the spirit of ``examples/test_spmm_2dpg.c:53-79``
        (``crp_tpu/plan/planner2d.py:96-121``, the same text)."""
        lines = [
            f"Calculated 2D grid: pm, pn = {self.pm}, {self.pn}, comm cost = {self.comm_cost}",
            "",
            "1D row partitioning of A:",
        ]
        for i in range(self.pm):
            for j in range(self.pn):
                r = i * self.pn + j
                lines.append(f"Rank {r:3d}: [{self.A0_rowptr[r]}, {self.A0_rowptr[r+1]-1}]")
            rs, re = i * self.pn, (i + 1) * self.pn - 1
            lines.append(
                f"Ranks [{rs}, {re}] all own A rows "
                f"[{self.A0_rowptr[rs]}, {self.A0_rowptr[re+1]-1}] after replicating A"
            )
        lines.append("")
        lines.append("1D row partitioning of B:")
        lines += [f"Block {i}: [{self.B_rowptr[i]}, {self.B_rowptr[i+1]-1}]" for i in range(self.pm)]
        lines.append("")
        lines.append("1D row partitioning of C:")
        lines += [f"Block {i}: [{self.AC_rowptr[i]}, {self.AC_rowptr[i+1]-1}]" for i in range(self.pm)]
        lines.append("")
        lines.append("1D column partitioning of B and C:")
        lines += [f"Block {i}: [{self.BC_colptr[i]}, {self.BC_colptr[i+1]-1}]" for i in range(self.pn)]
        return "\n".join(lines)


def calc_spmm_part2d_from_1d(nproc: int, m: int, n: int, k: int,
                             rb_displs0: np.ndarray, rowptr: np.ndarray,
                             colidx: np.ndarray, rA: int = 1,
                             dbg_print: bool = False) -> Plan2D:
    """A ``pm x pn`` grid and block boundaries from a 1D row partition.
    Each greedy step tries moving one more prime factor from ``pm`` to
    ``pn``; cost = A replication ``nnz * (pn-1) * 1.5`` + B exchange
    ``rA * exact_comm_rows * n`` (``src/spmat_part.c:117-161``)."""
    rb_displs0 = np.asarray(rb_displs0, dtype=np.int64)
    rowptr = np.asarray(rowptr)
    colidx = np.asarray(colidx)
    candidates = []

    def b_row_displs(nblk: int, m_displs: np.ndarray) -> np.ndarray:
        # square A: B rows split like A rows; else uniformly
        if m == k:
            return m_displs[: nblk + 1]
        return uniform_displs(k, nblk)

    _, total = csr_row_part_comm_size(
        k, rowptr, colidx, rb_displs0, b_row_displs(nproc, rb_displs0)
    )
    best_cost = int(total) * int(n)
    basic_1d_cost = best_cost
    m_displs = rb_displs0.copy()
    if dbg_print:
        logger.info("Basic 1D row partitioning comm cost: %d", best_cost)

    pm_, pn_ = nproc, 1
    failed_p = -1
    a_nnz = int(rowptr[m])
    fac = prime_factorization(nproc)
    nfac = len(fac)
    for ifac in range(nfac):
        p_i = fac[nfac - 1 - ifac]
        if p_i == failed_p:
            continue
        pn2 = pn_ * p_i
        pm2 = nproc // pn2
        m_displs2 = rb_displs0[::pn2][: pm2 + 1].copy()
        _, total = csr_row_part_comm_size(
            k, rowptr, colidx, m_displs2, b_row_displs(pm2, m_displs2)
        )
        # float multiply then truncate, as the reference does
        a_copy_cost = int(float(a_nnz) * float(pn2 - 1) * NNZ_COST_FACTOR)
        b_copy_cost = int(rA) * int(total) * int(n)
        curr_cost = a_copy_cost + b_copy_cost
        candidates.append(dict(step=ifac, factor=p_i, pm=pm2, pn=pn2, cost=curr_cost,
                               a_cost=a_copy_cost, b_cost=b_copy_cost))
        if dbg_print:
            logger.info("Evaluated: pm = %d, pn = %d, cost = %d", pm2, pn2, curr_cost)
        if curr_cost < best_cost:
            best_cost = curr_cost
            pn_, pm_ = pn2, pm2
            m_displs = m_displs2
            failed_p = -1
        else:
            failed_p = p_i
    if dbg_print:
        logger.info("Final 2D partitioning: pm = %d, pn = %d, cost = %d",
                    pm_, pn_, best_cost)

    AC_rowptr = m_displs[: pm_ + 1].copy()
    B_rowptr = AC_rowptr.copy() if m == k else uniform_displs(k, pm_)
    BC_colptr = uniform_displs(n, pn_)
    # nnz-balanced sub-split of each replicated row panel over its pn ranks
    A0_rowptr = np.empty(nproc + 1, dtype=np.int64)
    for im in range(pm_):
        srow, erow = int(m_displs[im]), int(m_displs[im + 1])
        local_rowptr = rowptr[srow : erow + 1] - rowptr[srow]
        A0_rowptr[im * pn_ : (im + 1) * pn_ + 1] = csr_row_partition(local_rowptr, pn_) + srow
    rb_rows, rb_total = csr_row_part_comm_size(k, rowptr, colidx, AC_rowptr, B_rowptr)
    return Plan2D(
        nproc=nproc, m=m, n=n, k=k, pm=pm_, pn=pn_, comm_cost=int(best_cost),
        A0_rowptr=A0_rowptr, B_rowptr=B_rowptr, AC_rowptr=AC_rowptr,
        BC_colptr=BC_colptr, basic_1d_cost=basic_1d_cost, candidates=candidates,
        rA_cost=int(float(a_nnz) * float(pn_ - 1) * NNZ_COST_FACTOR),
        rB_comm_rows=rb_rows, rB_cost=int(rb_total) * int(n),
    )


def plan_from_csr(a, n: int, nproc: int, method: str = "nnz", rA: int = 1,
                  dbg_print: bool = False) -> Plan2D:
    """The 1D partition, then the 2D grid search.

    ``method``: ``"nnz"`` (the nnz-balanced 1D partition) or ``"metis"``
    (graph-partitioned, square matrices only).  ``"metis"`` follows the
    reference driver (``examples/test_spmm_2dpg.c:30-37``):
    ``metis_row_partition`` permutes the matrix symmetrically **in place**
    (``a.rowptr``, ``a.colidx`` and ``a.val`` are rewritten) and its
    per-part displacements seed the grid search, so the plan matches the
    caller's ``a``.  Its backend chain: ``sparse.reorder.partition_backend``.
    """
    if method == "metis":
        from ..sparse.reorder import metis_row_partition

        out, _perm, rb_displs0 = metis_row_partition(a, nproc)
        a.rowptr, a.colidx, a.val = out.rowptr, out.colidx, out.val
    elif method == "nnz":
        rb_displs0 = csr_row_partition(a.rowptr, nproc)
    else:
        raise ValueError(f"unknown 1D partition method {method!r}")
    return calc_spmm_part2d_from_1d(nproc, a.nrow, n, a.ncol, rb_displs0, a.rowptr,
                                    a.colidx, rA=rA, dbg_print=dbg_print)
