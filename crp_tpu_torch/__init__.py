"""crp_tpu_torch — the CRP-SpMM system on PyTorch and CUDA (NVIDIA Hopper).

A port of ``crp_tpu`` (JAX on a TPU), which stays beside it as the reference
the port is tested against.  The port imports nothing of ``crp_tpu`` and
never ``jax``: it carries its own host layer (CSR container and
generators, ``.mtx`` reader, row partitioner, the 2D planner,
``SpmmConfig``, error norms), pinned equal to the originals by the CPU
tests.

The host layer also carries the reordering of ``sparse/reorder.py``
(``cluster_reorder``, ``rcm_reorder``, ``metis_row_partition`` behind the
METIS seam, with the greedy graph-growing partitioner of
``native/ggp.cpp``, built by ``g++`` at first use) and the planner's
``method="metis"``.

Ported so far: ``RowParaSpmm`` at any p (with the overlapped ring,
``overlap=1``, and the col-major B/C view, ``bc_layout=1``),
``Para2dSpmm`` on the planner's ``pm x pn`` grid (A from a global CSR or
already distributed, ``from_dist_a``) and ``CrpSpmm``, the any-layout
engine (B and C in the user's 2D blocks, the v1 bandwidth planner, A
global or distributed), with every shard on the engine's one device: the
B-row exchange (a padded all_to_all or a ring of shifts) moves exactly
the rows each shard's A references.  The local kernels are written in CUDA for
Hopper: the windowed dense panels, super-grouped (``kernels/csrc/
window_sg.cu``) or not (``kernels/csrc/window.cu``, multi-shard and
non-monotone packs); the ragged gathered-window chunks
(``kernels/csrc/ragged.cu``) and their fused spill (``kernels/csrc/
spill.cu``); the ``gather`` kind for any CSR (the same spill kernel with no
C); the fp64 class, ``dd_mxu`` on the FP64 tensor cores
(``kernels/csrc/dd_tc.cu``) and ``dd``'s fp64 ELL and segment-sum tiers;
and the ``ell`` kind.  The engines are imported on first use, and the
kernels build at their first call on a CUDA tensor.
"""

__version__ = "0.1.0"

from .config import SpmmConfig
from .plan.partition1d import csr_row_part_comm_size, csr_row_partition
from .plan.planner2d import Plan2D, plan_from_csr
from .sparse.csr import CSRMatrix
from .sparse.mmio import read_mtx_csr
from .sparse.reorder import (
    cluster_reorder, metis_row_partition, permute_symmetric, rcm_reorder,
)
from .sparse.synth import banded_random_csr, fill_b, powerlaw_community_csr
from .utils.norms import rel_fro_err


def __getattr__(name):
    if name == "RowParaSpmm":
        from .engine.rowpara import RowParaSpmm

        return RowParaSpmm
    if name == "Para2dSpmm":
        from .engine.para2d import Para2dSpmm

        return Para2dSpmm
    if name == "CrpSpmm":
        from .engine.crp import CrpSpmm

        return CrpSpmm
    raise AttributeError(f"module 'crp_tpu_torch' has no attribute {name!r}")


__all__ = [
    "CSRMatrix",
    "read_mtx_csr",
    "cluster_reorder",
    "rcm_reorder",
    "metis_row_partition",
    "permute_symmetric",
    "banded_random_csr",
    "powerlaw_community_csr",
    "fill_b",
    "rel_fro_err",
    "csr_row_partition",
    "csr_row_part_comm_size",
    "plan_from_csr",
    "Plan2D",
    "SpmmConfig",
    "RowParaSpmm",
    "Para2dSpmm",
    "CrpSpmm",
]
