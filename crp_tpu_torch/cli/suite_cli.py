"""crp-suite: the benchmark sweep harness (the reference's ``SC23_AD``
analog), ``crp_tpu/cli/suite_cli.py`` on the port's engines.

The reference ships SLURM scripts and MATLAB plotters holding the
published sweep results (``deprecated/SC23_AD/scripts/*.pbs``,
``figures/*.m``: strong scaling, n sweeps, runtime breakdowns, comm
volumes).  This harness reproduces those sweep shapes on the card (or the
CPU) and prints one JSON line per configuration, with the comm-volume
audit (planned / physical / minimal).  Every key of the JAX package's
record keeps its name and meaning, so one reader reads both.

Usage:
  python -m crp_tpu_torch.cli.suite_cli scaling <mtx|synth:spec> <n>
                                        [--procs=1,2,4,8] [--ntest=3] ...
  ... vary_n  <mtx|synth:spec> <p> [--ns=16,64,256,1024]
              [--plan-procs=P]  # also record the 2D planner's pm x pn
                                # choice per n for P devices (the SC23
                                # Fig. 7 shape: pn grows with n)
  ... modes   <mtx|synth:spec> <n> <p>        # a2a vs ring vs overlap
  ... kernels <mtx|synth:spec> <n> <p>        # --list=segsum,ell,
              # pallas,ragged,gather,dd,dd_mxu,pallas_halo

Common flags: --engine=para2d|rowpara|crp  --kernel=...  --dtype=...
  --prec=highest|x3|default (the operating point of fp32 data)
  --reorder=rcm|metis|cluster (locality reordering before packing,
  recorded with the bandwidth before and after)
  --ntest=N  --inner=N (execs per fence)  --check=0|1  --out=FILE.jsonl
  --project=1 (attach the projected multi-GPU exec block, plan.project,
  to rowpara records; the rate flags of project_cli apply)
  --device=cuda|cpu (default the card; every shard of p runs on it)
  --cpu-mesh=N (the JAX drivers' spelling of --device=cpu; N is not used)
  --trace=DIR (wrap the sweep in torch.profiler and write a Chrome trace
  into DIR: each kernel's device time beside the host's work)
  --distributed (one shard a rank of the launcher's process group, as
  ``torchrun --nproc-per-node=N -m crp_tpu_torch.cli.suite_cli ...
  --distributed``; each run's p must be the world size, the scaling
  sweep's default; rank 0 prints and writes the records; --engine=crp
  on the v1 planner's grid).

Matrices: a Matrix Market path, or synth:banded:<nrow>:<nnz_per_row>:<bw>,
synth:plaw:<nrow>:<deg>, or
synth:cplaw:<nrow>:<deg>:<comm>[:<p_local_pct>[:perm]].
"""

from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np

from ..utils.timers import get_wtime_sec
from ._driver import (
    config_from, device_flag, join_ranks, parse_argv, profiled, rates_from,
)


def _exec_note(device, p, distributed=False) -> str | None:
    """The record's warning that its times are not p devices' times."""
    if p <= 1:
        return None
    if distributed:
        return (f"one shard on each of {p} ranks: exec_s is rank 0's wall time "
                "per exec, collectives included")
    if device.type == "cuda":
        return (f"every shard of the {p} ran on the one card: exec_s/gflops "
                "are one card's, not a multi-GPU run's; comm volumes are "
                "the meaningful fields")
    return ("every shard ran on the CPU: exec_s/gflops are NOT performance "
            "data; comm volumes are the meaningful fields")


def _timed(run, sync, ntest, inner, label) -> tuple:
    """(seconds per exec of ``inner`` back-to-back ``run()`` calls per
    fence (``sync`` the device) over ``ntest`` fences, the last output);
    the loop is one ``torch.profiler`` range named ``suite_cli timed:
    <label>``, so a ``--trace`` separates the timed execs from the init and
    the checks."""
    from torch.profiler import record_function

    times = []
    with record_function(f"suite_cli timed: {label}"):
        for _ in range(ntest):
            st = get_wtime_sec()
            for _ in range(inner):
                c = run()
            sync(c)
            times.append((get_wtime_sec() - st) / inner)
    return times, c


def _exec_stats(times, a, n) -> dict:
    return dict(
        exec_s=dict(min=round(min(times), 6), avg=round(sum(times) / len(times), 6),
                    max=round(max(times), 6)),
        gflops=round(2.0 * a.nnz * n / min(times) / 1e9, 1),
    )


def run_one(a, n, p, engine_kind, config, dtype, ntest, check, inner=10,
            device="cuda", distributed=False):
    """Build one engine config, time ``ntest`` fences of ``inner`` execs,
    return a result record (``crp_tpu/cli/suite_cli.py:66-276``);
    ``distributed``: on the mesh of the world's p ranks."""
    from ..engine.rowpara import engine_device
    from ..kernels.points import PEAK, op_point
    from ..plan.planner2d import plan_from_csr
    from ..sparse.synth import fill_b
    from ..utils.norms import rel_fro_err
    from ..utils.timers import synchronize
    from .bench_cli import build_engine

    device = engine_device(device)
    rec = dict(
        matrix=dict(m=a.nrow, k=a.ncol, nnz=a.nnz), n=n, p=p,
        engine=engine_kind, kernel=config.kernel,
        mode=("overlap" if config.overlap else ("ring" if config.rb_p2p else "a2a")),
        dtype=str(np.dtype(dtype)) if config.kernel != "dd" else "dd",
        backend=device.type,
    )
    label = f"{engine_kind} {config.kernel} n={n} p={p}"
    note = _exec_note(device, p, distributed)
    if note:
        rec["exec_note"] = note
    t0 = get_wtime_sec()
    plan = bplan = None
    if engine_kind == "para2d":
        plan = plan_from_csr(a, n, p)
        rec["pm"], rec["pn"] = plan.pm, plan.pn
    elif engine_kind == "crp":
        from ..plan.bandwidth import calc_bandwidth_part2d

        bplan = calc_bandwidth_part2d(p, a.nrow, n, a.ncol, a.rowptr,
                                      a.row_col_ranges_v1())
        rec["pm"], rec["pn"] = bplan.np_row, bplan.np_col
    else:
        rec["pm"], rec["pn"] = p, 1
    rec["plan_s"] = round(get_wtime_sec() - t0, 4)
    eng = build_engine(engine_kind, a, plan, n, p, device, config, dtype, bplan,
                       distributed=distributed)
    if engine_kind == "crp":
        rec["comm"] = dict(
            redist_A=eng.nelem_A_rd, allgatherv_A=eng.nelem_A_agv,
            redist_B=eng.nelem_B_rd, a2av_B=eng.nelem_B_a2av,
            a2av_B_necessary=eng.nelem_B_a2av_min,
        )
        rec["init_s"] = round(eng.t_init, 4)
        if config.kernel == "dd":
            # dd runs B and C in fp64 through both redistributions: time
            # exec() (host round trip), as the JAX record does
            rec["timing"] = "host_roundtrip"
            b = np.asarray(fill_b(0, a.ncol, 0, n, dtype=np.float64))
            out = eng.exec(b)  # warm-up
            eng.clear_stat()
            times = []
            for _ in range(ntest):
                st = get_wtime_sec()
                out = eng.exec(b)
                times.append(get_wtime_sec() - st)
        else:
            b = np.asarray(fill_b(0, a.ncol, 0, n, dtype=dtype))
            bs = eng.rd_B.shard_src(b)
            synchronize(eng.exec_device(bs))  # warm-up
            eng.clear_stat()
            times, c = _timed(lambda: eng.exec_device(bs), synchronize, ntest, 1, label)
            out = eng.rd_C.unshard_dst(c, a.nrow, n) if check else None
        rec.update(_exec_stats(times, a, n))
        if check:
            rec["rel_fro_err"] = float(rel_fro_err(a.spmm_ref(b), out))
        return rec
    if engine_kind == "para2d":
        rec["comm"] = dict(
            replicate_A=eng.rA_cost, exchange_B=eng.rB_recv_size * n,
            physical_B_rows=eng.xplan.physical_rows_ring
            if (config.overlap or config.rb_p2p) else eng.xplan.physical_rows,
        )
    else:
        rec["comm"] = dict(
            exchange_B=eng.rB_recv_size * n,
            physical_B_rows=eng.xplan.physical_rows_ring
            if (config.overlap or config.rb_p2p) else eng.xplan.physical_rows,
        )
    rec["init_s"] = round(eng.t_init, 4)
    if getattr(eng, "init_breakdown", None):
        rec["init_breakdown"] = eng.init_breakdown
    rec["kernel_resolved"] = eng.kernel_kind
    lf = eng._local_op
    rl = getattr(lf, "roofline", None)
    if rl:
        # panel-vs-CSR storage accounting
        rec["kernel_detail"] = dict(
            variant=getattr(lf, "variant", "uniform"),
            a_panel_bytes=int(rl["a_bytes"]),
            csr_bytes=int(a.nnz * (4 + np.dtype(dtype).itemsize) + (a.nrow + 1) * 8),
            **{k: rl[k] for k in ("mxu_frac", "S", "spill_nnz", "spill_impl", "TM", "W")
               if k in rl},
        )

    b = np.asarray(fill_b(0, a.ncol, 0, n,
                          dtype=np.float64 if config.kernel == "dd" else dtype))
    bs = eng.shard_b(b)
    synchronize(eng.exec_device(bs))  # the kernels build at their first call
    times, c = _timed(lambda: eng.exec_device(bs), synchronize, ntest, inner, label)
    rec.update(_exec_stats(times, a, n))
    rec["inner"] = inner
    if rl:
        # the roofline audit of the panels this design multiplies, against
        # the card's peak of the point's product type
        tn_ = 256 if n % 256 == 0 else 128
        n_pad = -(-n // tn_) * tn_
        passes, peak = op_point(lf, eng.dtype)
        chunks = rl.get("S", rl["G"])
        dense_flops = 2.0 * chunks * rl["TM"] * rl["W"] * n_pad
        t_ = min(times)
        rec["roofline"] = dict(
            mxu_prec=config.mxu_precision,
            dense_gflops=round(dense_flops / 1e9, 1),
            achieved_tflops=round(dense_flops * passes / t_ / 1e12, 2),
            mxu_util=round(dense_flops * passes / t_ / PEAK[peak], 3),
            passes=passes, peak=peak, peak_tflops=PEAK[peak] / 1e12,
        )
    if check:
        rec["rel_fro_err"] = float(rel_fro_err(a.spmm_ref(b), eng.unshard_c(c)))
    if hasattr(eng, "close"):
        eng.close()
    return rec


def _reorder(a, opt) -> tuple:
    """``--reorder=rcm|metis|cluster``: the reordered matrix and its record
    (method, seconds, bandwidth before and after)."""
    from ..sparse.reorder import cluster_reorder, metis_row_partition, rcm_reorder

    bw0 = int(a.bandwidth())
    t0 = get_wtime_sec()
    if opt["reorder"] == "rcm":
        a, _ = rcm_reorder(a)
    elif opt["reorder"] == "metis":
        a, _, _ = metis_row_partition(a, int(opt.get("reorder-parts", 8)))
    elif opt["reorder"] == "cluster":
        a, _ = cluster_reorder(a, leaf_size=int(opt.get("reorder-leaf", 256)))
    else:
        raise SystemExit(f"unknown --reorder={opt['reorder']!r}")
    return a, dict(method=opt["reorder"], seconds=round(get_wtime_sec() - t0, 2),
                   bandwidth_before=bw0, bandwidth_after=int(a.bandwidth()))


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    pos, opt = parse_argv(argv)
    if len(pos) < 2:
        print(__doc__)
        return 255
    device, rank, world = join_ranks(opt, device_flag(opt))

    from .plan_cli import load_matrix

    sweep = pos[0]
    a = load_matrix(pos[1], need_symm=False)
    reorder_info = None
    if "reorder" in opt:
        a, reorder_info = _reorder(a, opt)
    ntest = int(opt.get("ntest", 3))
    inner = int(opt.get("inner", 10))
    check = int(opt.get("check", 1))
    engine = opt.get("engine", "para2d")
    dtype = np.dtype(opt.get("dtype", "float32"))
    base = config_from(opt)

    def cfg(**kw):
        return dataclasses.replace(base, **kw)

    if sweep == "scaling":
        n = int(pos[2])
        procs = [int(x) for x in opt.get(
            "procs", str(world) if "distributed" in opt else "1,2,4,8").split(",")]
        runs = [(a, n, p, engine, base, dtype) for p in procs]
    elif sweep == "vary_n":
        p = int(pos[2])
        ns = [int(x) for x in opt.get("ns", "16,64,256,1024").split(",")]
        runs = [(a, n, p, engine, base, dtype) for n in ns]
    elif sweep == "modes":
        n, p = int(pos[2]), int(pos[3])
        runs = [
            (a, n, p, engine, cfg(rb_p2p=0, overlap=0), dtype),
            (a, n, p, engine, cfg(rb_p2p=1, overlap=0), dtype),
            (a, n, p, engine, cfg(overlap=1), dtype),
        ]
    elif sweep == "kernels":
        n, p = int(pos[2]), int(pos[3])
        runs = [(a, n, p, engine, cfg(kernel=k), dtype)
                for k in opt.get("list", "segsum,ell,pallas,dd").split(",")]
    else:
        raise SystemExit(f"unknown sweep {sweep!r}")

    out = open(opt["out"], "a") if "out" in opt and rank == 0 else None
    try:
        with profiled(opt.get("trace") if rank == 0 else None,
                      "suite_trace.json") as trace:
            _sweep(runs, opt, pos, sweep, a, dtype, reorder_info, ntest, check,
                   inner, out, device, rank)
    finally:
        if out:
            out.close()
    if trace:
        print(f"Profiler trace written to {trace}", flush=True)
    return 0


def _sweep(runs, opt, pos, sweep, a, dtype, reorder_info, ntest, check, inner,
           out, device, rank=0):
    plan_procs = int(opt.get("plan-procs", 0))
    rates = rates_from(opt)
    for args in runs:
        try:
            rec = run_one(*args, ntest=ntest, check=check, inner=inner, device=device,
                          distributed="distributed" in opt)
        except Exception as e:  # record the failure, keep sweeping
            rec = dict(sweep=sweep, engine=args[3], n=args[1], p=args[2],
                       kernel=args[4].kernel, error=f"{type(e).__name__}: {e}")
        if int(opt.get("project", 0)) and args[3] == "rowpara" and "error" not in rec:
            from ..plan.project import project_exec_1d

            rec["projected"] = project_exec_1d(
                a, args[1], args[2], mxu_prec=args[4].mxu_precision, dtype=dtype,
                rates=rates,
            )
        if plan_procs:
            # the grid the 2D planner WOULD pick for this n on plan_procs
            # devices (independent of the exec config)
            from ..plan.planner2d import plan_from_csr

            pl = plan_from_csr(a, args[1], plan_procs)
            rec["planner"] = dict(nproc=plan_procs, pm=pl.pm, pn=pl.pn,
                                  comm_cost=int(pl.comm_cost))
        rec["sweep"] = sweep
        rec["spec"] = pos[1]
        if reorder_info is not None:
            rec["reorder"] = reorder_info
        # the switches that shaped the pack and the exec, from the parsed
        # config, so A/B rows in one file stay distinguishable
        rec["config"] = dataclasses.asdict(args[4])
        line = json.dumps(rec)
        if rank == 0:
            print(line, flush=True)
        if out:
            out.write(line + "\n")


if __name__ == "__main__":
    raise SystemExit(main())
