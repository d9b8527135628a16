"""What the port's drivers (``bench_cli``, ``suite_cli``, ``project_cli``)
share: their flag parsing, the projection's rate flags, the ranks of a
``--distributed`` run, the engine device, and the ``torch.profiler``
trace that stands where the JAX drivers write a ``jax.profiler`` trace."""

from __future__ import annotations

import contextlib
import os

def parse_argv(argv) -> tuple:
    """(positional arguments, ``--key[=value]`` options; a bare flag is
    ``"1"``), as the JAX drivers split them."""
    pos = [a for a in argv if not a.startswith("--")]
    opt = dict((a[2:].split("=", 1) + ["1"])[:2] for a in argv if a.startswith("--"))
    return pos, opt


# one flag per rate of ``plan.project.DEFAULT_RATES`` (JAX's CRP_PROJ_* knobs)
RATE_FLAGS = ("x3-tflops", "default-tflops", "highest-tflops", "hbm-gbps",
              "link-gbps", "spill-ns")


def rates_from(opt) -> dict:
    """The rates the rate flags in ``opt`` set, keyed as ``DEFAULT_RATES``."""
    return {f.replace("-", "_"): float(opt[f]) for f in RATE_FLAGS if f in opt}


def join_ranks(opt, device: str):
    """``--distributed`` (``crp_tpu/cli/bench_cli.py:41-47``): join the
    launcher's process group (``init_distributed``: NCCL on the card,
    gloo under ``--device=cpu``) and return ``(this rank's device, rank,
    world size)``; without the flag ``(device, 0, 1)``.  The JAX drivers
    print on every process; the port's print on rank 0 alone, so that N
    ranks give one record."""
    if "distributed" not in opt:
        return device, 0, 1
    import torch.distributed as dist

    from ..shard.layout import init_distributed

    dev = init_distributed(device="cpu" if device == "cpu" else None)
    return dev, dist.get_rank(), dist.get_world_size()


def engine_mesh(engine_kind: str, plan, nproc: int):
    """The mesh of a ``--distributed`` run for the engine: the plan's
    pm x pn grid for ``para2d``, the v1 planner's ``np_row x np_col`` for
    ``crp`` (``plan`` its :class:`BandwidthPlan`), nproc ranks along pm for
    ``rowpara``."""
    from ..shard.layout import make_mesh_1d, make_mesh_2d

    if engine_kind == "para2d":
        return make_mesh_2d(plan.pm, plan.pn)
    if engine_kind == "crp":
        return make_mesh_2d(plan.np_row, plan.np_col)
    return make_mesh_1d(nproc)


def device_flag(opt) -> str:
    """``--device=cuda|cpu`` (default the card).  ``--cpu-mesh=N``, the
    JAX drivers' spelling of a CPU run, means ``--device=cpu``: the shards
    share the one device there as on the card, so N is not used."""
    if "cpu-mesh" in opt:
        return "cpu"
    return opt.get("device", "cuda")


def config_from(opt):
    """The engines' :class:`SpmmConfig`: the switches the JAX drivers read
    (``SpmmConfig.from_env``), with ``--kernel`` and ``--prec`` (the
    operating point, ``CRP_TPU_MXU_PREC``'s counterpart) on top."""
    from ..config import SpmmConfig

    config = SpmmConfig.from_env()
    if "kernel" in opt:
        config.kernel = opt["kernel"]
    if "prec" in opt:
        config.mxu_precision = opt["prec"]
    return config


@contextlib.contextmanager
def profiled(trace_dir, name: str):
    """``torch.profiler`` over the block (CPU activity, and CUDA where a
    card is present), its Chrome trace written to ``trace_dir/name``;
    a no-op for ``trace_dir`` None.  Yields the trace's path."""
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, name)
    with profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(path)
