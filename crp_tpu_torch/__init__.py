"""crp_tpu_torch — the CRP-SpMM system on PyTorch and CUDA (NVIDIA Hopper).

A port of ``crp_tpu`` (JAX on a TPU), which stays beside it as the reference
the port is tested against.  The port imports only the framework-neutral,
jax-free host layer of ``crp_tpu`` (CSR container and generators, ``.mtx``
reader, row partitioner, ``SpmmConfig``, error norms) and never ``jax``;
the numpy helpers it needs from modules that import jax are copied into it.
It re-exports that host layer, so a user of the port imports only
``crp_tpu_torch``.

Ported so far: the single-device (p = 1) ``RowParaSpmm`` main path, with
the windowed SpMM kernels written in CUDA for Hopper: the uniform
super-grouped windows (``kernels/csrc/window_sg.cu``), the ragged
gathered-window chunks for power-law and variable-bandwidth matrices
(``kernels/csrc/ragged.cu``) and their fused spill
(``kernels/csrc/spill.cu``); the ``gather`` kind for any CSR (the same
spill kernel with no C); the fp64 class, ``dd_mxu`` on the FP64 tensor
cores (``kernels/csrc/dd_tc.cu``) and ``dd``'s fp64 ELL and segment-sum
tiers; and the ``ell`` kind.  The engine is imported on first use, and the
kernels build at their first call on a CUDA tensor.
"""

__version__ = "0.1.0"

from crp_tpu.config import SpmmConfig
from crp_tpu.plan.partition1d import csr_row_partition
from crp_tpu.sparse.csr import CSRMatrix
from crp_tpu.sparse.mmio import read_mtx_csr
from crp_tpu.sparse.synth import banded_random_csr, fill_b, powerlaw_community_csr
from crp_tpu.utils.norms import rel_fro_err


def __getattr__(name):
    if name == "RowParaSpmm":
        from .engine.rowpara import RowParaSpmm

        return RowParaSpmm
    raise AttributeError(f"module 'crp_tpu_torch' has no attribute {name!r}")


__all__ = [
    "CSRMatrix",
    "read_mtx_csr",
    "banded_random_csr",
    "powerlaw_community_csr",
    "fill_b",
    "rel_fro_err",
    "csr_row_partition",
    "SpmmConfig",
    "RowParaSpmm",
]
