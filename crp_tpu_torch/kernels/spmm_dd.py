"""fp64-class SpMM off the tensor cores: the ``dd`` kind's non-MXU tier.

Counterpart of ``crp_tpu/kernels/spmm_dd.py``.  A TPU has no fp64 unit, so
the JAX package carries every value as a double-float pair of fp32 (hi +
lo, 48 bits) through error-free transformations, in two XLA shapes picked
by the shard's largest row: an ELL slot tree for at most ``ELL_MAX_L``
nonzeros per row, a segmented scan over the nonzeros above it.  Hopper
computes fp64 natively, so the port keeps the two shapes and the rule (it
picks the JAX package's tier) and computes in fp64 (53 bits): A's values,
B and C are fp64 tensors, not hi/lo pairs.

  * :func:`pack_ell_dd` / :func:`spmm_ell_dd` — the ELL slot loop of
    :mod:`.spmm_ell` in fp64;
  * :func:`pack_coo_dd` / :func:`spmm_segsum_dd` — ``index_add_`` over
    bounded chunks of nonzeros (one (nnz, n) fp64 contribution array is
    22 GB at the cplaw shape, 10.8M nnz and n = 256).

The JAX package refuses the segmented scan over 4M nonzeros per shard
(``CRP_TPU_DD_SEGSUM_MAX_NNZ``, ``dispatch.py:264-279``): the scan's
unrolled levels exhaust XLA's compile memory.  The port compiles nothing
and chunks its sum, so it has no such cap.  That is a decision that
differs: the 10.8M-nnz cplaw matrix runs at fp64 class here.
"""

from __future__ import annotations

import numpy as np
import torch

from .spmm_ell import pack_ell, spmm_ell
from .spmm_ragged import spmm_spill_chunked
from .spmm_segsum import pack_device_csr

ELL_MAX_L = 128  # the JAX package's ELL bound (dispatch.py:247)


def pack_ell_dd(rowptr, colidx, val, nrow_pad: int, L: int | None = None):
    """CSR -> ELL (cols, vals) with fp64 values (``spmm_dd.py:96-117``
    without the hi/lo split)."""
    return pack_ell(rowptr, colidx, np.asarray(val, np.float64), nrow_pad, L=L)


def pack_coo_dd(rowptr, colidx, val, nnz_pad: int, nrow_pad: int):
    """CSR -> padded row-sorted COO (row_ids, cols, vals) with fp64 values
    (``spmm_dd.py:156-186`` without the hi/lo split and ``row_last``, which
    only the scan needs); pad entries carry ``row_id = nrow_pad``."""
    return pack_device_csr(rowptr, colidx, np.asarray(val, np.float64), nnz_pad,
                           nrow=nrow_pad)


def _require_f64(name, b):
    if b.dtype != torch.float64:
        raise ValueError(f"{name}: the dd kind computes in fp64; B is {b.dtype}")


def spmm_ell_dd(cols, vals, b):
    """fp64 C = A @ B over the ELL slots (``spmm_dd.py:120-153``)."""
    _require_f64("spmm_ell_dd", b)
    return spmm_ell(cols, vals, b)


def spmm_segsum_dd(row_ids, cols, vals, b, nrow: int):
    """fp64 C = A @ B over the COO nonzeros in bounded chunks
    (``spmm_dd.py:189-222``); pad rows are dropped."""
    _require_f64("spmm_segsum_dd", b)
    return spmm_spill_chunked(row_ids, cols, vals, b, nrow)
