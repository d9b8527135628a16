"""fp64-class SpMM on Hopper's FP64 tensor cores (the ``dd_mxu`` kind).

Counterpart of ``crp_tpu/kernels/spmm_dd_mxu.py``.  The JAX package puts
the fp64-class path on a TPU's matrix unit, which has no fp64, by exact
slicing (Ozaki): A as 7 bf16 integer slice planes with a power-of-two scale
per row, B sliced in the kernel, 34 exact bf16 passes summed in
double-float.  Hopper multiplies fp64 on its tensor cores, so the port
keeps the contract and drops the mechanism:

  * the same pack decisions: the ragged total cover (``min_chunk_nnz = 1``,
    every nonzero in a panel, no spill) under half the panel cap at fp64
    itemsize, refused when the cap forces a spill
    (``spmm_dd_mxu.py:85-122``);
  * the slice-plane check ``S * TM * Wc * (2 * QA + 4) > cap`` of the JAX
    pack is kept, though the port stores no slice planes: without it the
    port would take matrices that the JAX package sends to its non-MXU
    tier.  It is kept for parity of decisions;
  * the geometry of :func:`dd_mxu_geometry` (``dispatch.py:1240-1248``):
    the ragged defaults with ``Wc`` clamped to 1024 (the slices' exactness
    bound) and to 256 on the CPU (the JAX clamp under ``interpret``), so
    both packages cover alike;
  * fp64 panels (``device_pack.ragged_fill(mode="f64")``) in place of the
    slice planes, and one fp64 pass: ``slice_a_f64``, ``_extract_b_slices``
    and the double-float sums are not ported, as they exist only because
    the TPU has no fp64 unit.

The kernel is :func:`spmm_ragged_dd` (``csrc/dd_tc.cu``), which launches
``crp_ragged_dd_f64tc`` for CUDA tensors and counts the launch; for CPU
tensors it runs its plain PyTorch version, :func:`.spmm_ragged_plain` on the
fp64 panels.
"""

from __future__ import annotations

import numpy as np
import torch

from .spmm_pallas import UnsupportedSparsity, _placement
from .spmm_ragged import (
    PANEL_CAP_BYTES, _ragged, cover_with_cap, ragged_params, spmm_ragged_plain,
)

QA = 7  # the JAX package's A slice planes (its slice-plane check reads it)


def dd_mxu_geometry(small: bool) -> tuple[int, int]:
    """(TM, Wc) of the dd_mxu pack: the ragged defaults, ``Wc`` at most
    1024, and at most 256 where ``small`` (the port's CPU, the JAX
    package's ``interpret``)."""
    TM, Wc = ragged_params()
    Wc = min(Wc, 1024)
    return TM, (min(Wc, 256) if small else Wc)


def ragged_dd_cover(rowptr, colidx, TM: int, Wc: int, G: int,
                    max_panel_bytes: int = PANEL_CAP_BYTES):
    """The total cover of one shard: (starts, group_ptr) with every chunk
    kept, or UnsupportedSparsity where the JAX pack refuses
    (``spmm_dd_mxu.py:101-119``).

    The cover's spill count bounds the fill's from above: a group that
    keeps no chunk gets a dummy chunk over [0, Wc), which takes back its
    nonzeros there.  So a spill past every column below ``Wc`` refuses here,
    before any panel is filled; the caller checks the fill's own count.
    """
    rowptr = np.asarray(rowptr, dtype=np.int64)
    colidx = np.asarray(colidx, dtype=np.int32)
    starts, group_ptr, spill_nnz = cover_with_cap(
        rowptr, colidx, TM, Wc, 1, G, max(max_panel_bytes // 2, 1), 8,
    )
    nnz = int(rowptr[-1]) - int(rowptr[0])
    if spill_nnz > int(np.count_nonzero(colidx[:nnz] < Wc)):
        raise UnsupportedSparsity(
            f"dd_mxu total cover infeasible under panel cap ({spill_nnz} "
            f"nnz would spill)"
        )
    S = len(starts)
    if S * TM * Wc * (2 * QA + 4) > max_panel_bytes:
        raise UnsupportedSparsity(
            f"dd slice planes {(S * TM * Wc * 2 * QA) >> 20} MiB > cap"
        )
    return starts, group_ptr


def spmm_ragged_dd(step_g, group_ptr, starts, panels, b, *, min_b_rows: int):
    """fp64 ragged SpMM on the FP64 tensor cores: (G*TM, n) fp64 from fp64
    chunk panels and fp64 ``b``.  Replaces ``spmm_ragged_dd``
    (``spmm_dd_mxu.py:242``, kernel ``_ragged_kernel_dd`` ``:163``)."""
    name = "spmm_ragged_dd"
    if _placement(name, step_g, group_ptr, starts, panels, b) == "cpu":
        return spmm_ragged_plain(step_g, group_ptr, starts, panels, b)
    c = _ragged(name, "crp_ragged_dd_f64tc", step_g, group_ptr, starts,
                (panels,), b, min_b_rows, torch.float64, torch.float64,
                torch.float64)
    spmm_ragged_dd.launches += 1
    return c


spmm_ragged_dd.launches = 0

KERNELS = (spmm_ragged_dd,)
