"""crp-plan: the planner-only driver (the reference's ``test_spmm_2dpg``),
``crp_tpu/cli/plan_cli.py`` on the port's host layer.

Usage: python -m crp_tpu_torch.cli.plan_cli <mtx-file|synth:spec>
         <num-of-B-col> <num-of-devices> <part-method>
  <part-method>: 0 native nnz-balanced 1D partition,
                 1 METIS 1D partition (symmetric matrix only; reference
                   ``test_spmm_2dpg.c:30-37`` — libmetis/pymetis/native
                   greedy-growing backend chain),
                 2 RCM-reorder first, then nnz-balanced (the documented
                   symrcm alternative, ``SC23_AD/readme.md:95-102``)

Prints the chosen grid, comm cost, and all four boundary arrays exactly like
``examples/test_spmm_2dpg.c:53-79``.  It runs on the host only.
"""

from __future__ import annotations

import sys
import time


def load_matrix(spec: str, need_symm: bool = False):
    """Load .mtx, or generate 'synth:banded:<n>:<nnz>:<bw>' /
    'synth:plaw:<n>:<deg>' /
    'synth:cplaw:<n>:<deg>:<comm>[:<p_local_pct>[:perm]]'."""
    from ..sparse.mmio import read_mtx_csr
    from ..sparse.synth import (
        banded_random_csr, powerlaw_community_csr, powerlaw_random_csr,
    )

    if spec.startswith("synth:"):
        parts = spec.split(":")
        kind = parts[1]
        if kind == "banded":
            n, nnzr, bw = (int(x) for x in parts[2:5])
            return banded_random_csr(n, nnz_per_row=nnzr, bandwidth=bw)
        if kind == "plaw":
            n, deg = (int(x) for x in parts[2:4])
            return powerlaw_random_csr(n, avg_degree=deg)
        if kind == "cplaw":
            n, deg, comm = (int(x) for x in parts[2:5])
            pct = int(parts[5]) if len(parts) > 5 else 85
            perm = len(parts) > 6 and parts[6] == "perm"
            return powerlaw_community_csr(
                n, avg_degree=deg, comm_size=comm, p_local=pct / 100, permute=perm,
            )
        raise SystemExit(f"unknown synth spec {spec}")
    return read_mtx_csr(spec, need_symm=need_symm)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 4:
        print(
            "Usage: crp-plan <mtx-file|synth:spec> <num-of-B-col> "
            "<num-of-devices> <part-method>"
        )
        print(
            "<part-method>: 0 native 1D partition, 1 METIS 1D partition, "
            "2 RCM reorder first"
        )
        return 255
    n, nproc, method = int(argv[1]), int(argv[2]), int(argv[3])

    from ..plan.partition1d import csr_row_partition
    from ..plan.planner2d import calc_spmm_part2d_from_1d

    a = load_matrix(argv[0], need_symm=method != 0)
    print("=" * 60)
    st = time.perf_counter()
    if method == 1:
        from ..sparse.reorder import metis_row_partition

        a, _, rb = metis_row_partition(a, nproc)
    else:
        if method == 2:
            from ..sparse.reorder import rcm_reorder

            a, _ = rcm_reorder(a)
        rb = csr_row_partition(a.rowptr, nproc)
    t1 = time.perf_counter() - st
    print(f"Calculate 1D row partitioning time = {t1:.2f} s")
    st = time.perf_counter()
    plan = calc_spmm_part2d_from_1d(
        nproc, a.nrow, n, a.ncol, rb, a.rowptr, a.colidx, rA=1, dbg_print=True
    )
    t2 = time.perf_counter() - st
    print(f"Calculate 2D partitioning from 1D partitioning time = {t2:.2f} s")
    print(f"Total partitioning time = {t1 + t2:.2f} s")
    print(plan.describe())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
