"""crp-bench: the end-to-end SpMM driver (the reference's
``test_para2d_spmm``), ``crp_tpu/cli/bench_cli.py`` on the port's engines.

Usage: python -m crp_tpu_torch.cli.bench_cli <mtx-file|synth:spec>
         <num-of-B-col> <num-of-tests> <part-method> [<check-correct>]
         [--engine=para2d|rowpara|crp]
         [--kernel=auto|segsum|ell|pallas|pallas_halo|ragged|gather|dd]
         [--prec=highest|x3|default] [--dtype=float32|float64]
         [--devices=N] [--device=cuda|cpu] [--profile=DIR]

Plan -> distribute -> timed exec loop -> stats -> optional
``||C_ref - C||_F`` check, as the reference CLI (``README.md:33-40``).
<part-method>: 0 native 1D partition, 1 METIS 1D partition
(``test_para2d_spmm.c:50-57``), 2 RCM-reorder first.  ``--devices=N`` is
the number of shards, all on the engine's one device (default the card,
N = ``torch.cuda.device_count()``; ``--device=cpu`` runs the plain
PyTorch versions on the CPU, one shard unless N says more).
``--profile=DIR`` wraps the timed loop in ``torch.profiler`` and writes a
Chrome trace into DIR.  ``--distributed`` (a multi-host run) raises: it
waits for ROADMAP A8.
"""

from __future__ import annotations

import sys

import numpy as np

from ..utils.timers import get_wtime_sec
from ._driver import config_from, device_flag, parse_argv, profiled, refuse_distributed
from .plan_cli import load_matrix

USAGE = ("Usage: crp-bench <mtx-file|synth:spec> <num-of-B-col> "
         "<num-of-tests> <part-method> [<check-correct>] [--engine=...] "
         "[--kernel=...] [--prec=...] [--dtype=...] [--devices=N] "
         "[--device=cuda|cpu] [--profile=DIR]")


def build_engine(engine_kind, a, plan, glb_n, nproc, device, config, dtype,
                 bplan=None):
    """The ``engine_kind`` engine on ``a``: ``para2d`` on ``plan``'s grid,
    ``rowpara`` on nnz-balanced row blocks, ``crp`` on the v1 planner's
    grid (``bplan``, or planned here) with B and C in uniform row slabs
    (the reference driver's layouts)."""
    from ..plan.partition1d import csr_row_partition
    from ..utils.blocks import uniform_displs

    if engine_kind == "para2d":
        from ..engine.para2d import Para2dSpmm

        return Para2dSpmm(a, plan, device=device, config=config, dtype=dtype)
    if engine_kind == "rowpara":
        from ..engine.rowpara import RowParaSpmm

        rb = csr_row_partition(a.rowptr, nproc)
        b_displs = rb if a.nrow == a.ncol else uniform_displs(a.ncol, nproc)
        return RowParaSpmm(a, rb, b_displs, glb_n, device=device, config=config,
                           dtype=dtype)
    if engine_kind == "crp":
        from ..engine.crp import CrpSpmm
        from ..plan.bandwidth import calc_bandwidth_part2d
        from ..shard.redist import BlockDist

        user_B = BlockDist.from_row_slabs(uniform_displs(a.ncol, nproc), glb_n)
        user_C = BlockDist.from_row_slabs(uniform_displs(a.nrow, nproc), glb_n)
        bp = bplan or calc_bandwidth_part2d(nproc, a.nrow, glb_n, a.ncol, a.rowptr,
                                            a.row_col_ranges_v1())
        return CrpSpmm(a, glb_n, user_B, user_C, nproc=nproc, device=device,
                       config=config, dtype=dtype, bplan=bp)
    raise SystemExit(f"unknown engine {engine_kind}")


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    pos, opt = parse_argv(argv)
    if len(pos) < 4:
        print(USAGE)
        return 255
    refuse_distributed(opt)
    glb_n, n_test, method = int(pos[1]), int(pos[2]), int(pos[3])
    chk_res = int(pos[4]) if len(pos) > 4 else 0
    engine_kind = opt.get("engine", "para2d")
    dtype = np.dtype(opt.get("dtype", "float32"))

    import torch

    from ..plan.planner2d import plan_from_csr
    from ..sparse.synth import fill_b
    from ..utils.norms import rel_fro_err

    device = device_flag(opt)
    nproc = int(opt.get("devices", torch.cuda.device_count() if device != "cpu" else 1))
    config = config_from(opt)

    a = load_matrix(pos[0], need_symm=method != 0)
    if method == 2:
        from ..sparse.reorder import rcm_reorder

        a, _ = rcm_reorder(a)

    st = get_wtime_sec()
    # method=1: plan_from_csr runs METIS_row_partition, which permutes `a`
    # in place like the reference driver (test_para2d_spmm.c:50-57)
    plan = plan_from_csr(a, glb_n, nproc, method="metis" if method == 1 else "nnz")
    print(f"Calculate 2D partitioning time = {get_wtime_sec() - st:.2f} s")
    print(f"2D process grid: pm, pn = {plan.pm}, {plan.pn}")

    eng = build_engine(engine_kind, a, plan, glb_n, nproc, device, config, dtype)
    b = np.asarray(fill_b(0, a.ncol, 0, glb_n, dtype=dtype))
    c = eng.exec(b)  # warm-up (the kernels build at their first call)
    eng.clear_stat()
    with profiled(opt.get("profile"), "bench_trace.json") as trace:
        for _ in range(n_test):
            st = get_wtime_sec()
            c = eng.exec(b)
            print(f"{get_wtime_sec() - st:.4f}")
    if trace:
        print(f"Profiler trace written to {trace}")
    print(eng.print_stat())

    if chk_res:
        err = rel_fro_err(a.spmm_ref(b), c)
        print(f"||C_ref - C||_f / ||C_ref||_f = {err:e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
