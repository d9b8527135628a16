"""crp-calc-partition: the standalone bandwidth-bound (v1) planner driver
(``crp_tpu/cli/calc_partition_cli.py``, the reference's
``deprecated/examples/crpspmm_calc_partition.c``).

Usage: python -m crp_tpu_torch.cli.calc_partition_cli <mtx-file|synth:spec>
       <num-of-B-col> <num-of-devices>

Loads the matrix, prints its size, nnz and bandwidth, then runs the port's
planner (``plan/bandwidth.py``, the one ``CrpSpmm`` uses) with the
per-factor cost trace the reference prints (``crpspmm_calc_partition.c:
60-116``), the planning wall time and the final grid.  It runs on the host
alone: no device is touched.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .plan_cli import load_matrix


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 3:
        print(
            "Usage: crp-calc-partition <mtx-file|synth:spec> "
            "<num-of-B-col> <num-of-devices>"
        )
        return 255
    n, nproc = int(argv[1]), int(argv[2])

    from ..plan.bandwidth import calc_bandwidth_part2d

    print(f"Reading matrix A from {argv[0]}")
    a = load_matrix(argv[0])
    # bandwidth = max |row - col| over nonzeros (crpspmm_calc_partition.c:42-47)
    rows = np.repeat(np.arange(a.nrow, dtype=np.int64), np.diff(a.rowptr.astype(np.int64)))
    bw = int(np.abs(rows - a.colidx.astype(np.int64)).max()) if a.nnz else 0
    print(
        f"A size = {a.nrow} * {a.ncol}, nnz = {a.nnz}, "
        f"nnz/row = {a.nnz // max(a.nrow, 1)}, bandwidth = {bw}\n"
    )

    st = time.perf_counter()
    plan = calc_bandwidth_part2d(
        nproc, a.nrow, n, a.ncol, a.rowptr, a.row_col_ranges_v1(), dbg_print=True,
    )
    et = time.perf_counter()
    print(f"Calculate partitioning time = {et - st:.2f} s")
    print(
        f"Final grid: {plan.np_row} row panels x {plan.np_col} B/C column "
        f"slabs, copy_B_size = {plan.copy_B_size}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
