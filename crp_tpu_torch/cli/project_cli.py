"""crp-project: per-plan projected multi-GPU exec times (JSON lines),
``crp_tpu/cli/project_cli.py`` on the port's model.

One card is available, so strong-scaling exec cannot be measured; this
driver makes the multi-GPU story falsifiable instead: the kernel term comes
from the pack geometry and one card's measured effective rates, the comm
term from the plan's exact exchange volumes over the link rate (see
``plan.project``).  It runs on the host only.

Usage:
  python -m crp_tpu_torch.cli.project_cli <mtx|synth:spec> <n>
      [--procs=1,4,8,16] [--prec=x3] [--dtype=float32] [--calibrate-s=S]
      [--md] [--out=FILE] [--x3-tflops=R] [--default-tflops=R]
      [--highest-tflops=R] [--hbm-gbps=R] [--link-gbps=R] [--spill-ns=T]

--calibrate-s=S scales the kernel term so the p=1 projection equals a
measured single-card exec of S seconds.  Each rate flag replaces one of
``plan.project.DEFAULT_RATES`` (the tensor rates per pass of their
operating point).
"""

from __future__ import annotations

import json
import sys

import numpy as np

from ._driver import parse_argv, rates_from


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    pos, opt = parse_argv(argv)
    if len(pos) < 2:
        print(__doc__)
        return 255

    from ..plan.project import project_exec_1d
    from .plan_cli import load_matrix

    a = load_matrix(pos[0], need_symm=False)
    n = int(pos[1])
    procs = [int(x) for x in opt.get("procs", "1,4,8,16").split(",")]
    prec = opt.get("prec", "x3")
    dtype = np.dtype(opt.get("dtype", "float32"))
    rates = rates_from(opt)

    calibration = 1.0
    if "calibrate-s" in opt:
        base = project_exec_1d(a, n, 1, mxu_prec=prec, dtype=dtype, rates=rates)
        if base["kernel_s"] > 0:
            calibration = float(opt["calibrate-s"]) / base["kernel_s"]

    rows = []
    out = open(opt["out"], "a") if "out" in opt else None
    for i, p in enumerate(procs):
        rec = project_exec_1d(
            a, n, p, mxu_prec=prec, dtype=dtype, calibration=calibration,
            include_provenance=(i == 0), rates=rates,
        )
        rec.update(matrix=pos[0], n=n, prec=prec)
        rows.append(rec)
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
    if out:
        out.close()

    if "md" in opt:
        print("\n| p | kernel (s) | comm (s) | projected (s) | "
              "projected+overlap (s) | per-card wire MB |")
        print("|---|---|---|---|---|---|")
        for r in rows:
            print(
                f"| {r['p']} | {r['kernel_s']:.5f} | {r['comm_s']:.5f} | "
                f"{r['projected_s']:.5f} | {r['projected_overlap_s']:.5f} | "
                f"{r['comm_bytes_per_chip'] / 1e6:.1f} |"
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
