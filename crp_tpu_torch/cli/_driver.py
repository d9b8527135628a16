"""What the port's drivers (``bench_cli``, ``suite_cli``, ``project_cli``)
share: their flag parsing, the projection's rate flags, the refusal of
multi-host runs, the engine device, and the ``torch.profiler`` trace that
stands where the JAX drivers write a ``jax.profiler`` trace."""

from __future__ import annotations

import contextlib
import os

DISTRIBUTED_REFUSAL = (
    "--distributed: multi-host and multi-GPU runs are not ported yet "
    "(ROADMAP A8, init_distributed and the meshes); every shard runs on "
    "the engine's one device"
)


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


def refuse_distributed(opt) -> None:
    if "distributed" in opt:
        raise NotImplementedError(DISTRIBUTED_REFUSAL)


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
