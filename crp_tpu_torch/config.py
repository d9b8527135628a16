"""Runtime configuration (``crp_tpu/config.py``).

The reference configures its algorithm switches through environment
variables read with ``GET_ENV_INT_VAR`` (reference ``src/utils.h:71-87``),
e.g. ``RP_SPMM_P2P`` / ``RP_SPMM_REIDX`` (``src/rowpara_spmm.c:42-43``).
The port keeps the JAX package's switches, names and defaults, so that one
``SpmmConfig`` means the same run in both packages.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

logger = logging.getLogger("crp_tpu_torch")


def get_env_int(
    env_name: str,
    default: int,
    min_val: int,
    max_val: int,
    *,
    var_name: Optional[str] = None,
    log: bool = True,
) -> int:
    """Read an integer env var with default / clamp-to-range semantics
    (``GET_ENV_INT_VAR``): missing -> default, out of range -> default, and
    the override is logged once."""
    var_name = var_name or env_name.lower()
    raw = os.environ.get(env_name)
    if raw is None:
        return default
    try:
        val = int(raw)
    except ValueError:
        logger.warning("Ignoring non-integer env %s=%r", env_name, raw)
        return default
    if val < min_val or val > max_val:
        logger.warning(
            "Env %s=%d out of range [%d, %d]; using default %d",
            env_name, val, min_val, max_val, default,
        )
        return default
    if log and val != default:
        logger.info("Overriding parameter %s = %d (default %d)", var_name, val, default)
    return val


@dataclasses.dataclass
class SpmmConfig:
    """Algorithm switches for the SpMM engines.

    ``rb_p2p``: 1 -> the B exchange runs as a ring of p - 1 shifts, 0 -> one
    padded all_to_all (``src/rowpara_spmm.c:275-309``).  ``rb_reidx``:
    compact never-referenced B rows out of the receive buffer
    (``src/rowpara_spmm.c:81-86``).  ``a2a_b_finegrain``: the v1 engine's
    switch, kept for parity.  ``dtype``: value dtype when an engine gets
    none.  ``kernel``: the local SpMM kind ("auto", "segsum", "ell",
    "pallas", "ragged", "gather", "dd", "dd_mxu", "pallas_halo"), with the
    structure-aware fallback walk of ``kernels/dispatch.py``.  ``overlap``:
    the exchange overlapped with compute.  ``bc_layout``: the reference's
    col-major B/C view.  ``mxu_precision``: the operating point of fp32
    data, "highest" (fp32), "x3" (three bf16 products) or "default" (one
    bf16 product).
    """

    rb_p2p: int = 1
    rb_reidx: int = 1
    a2a_b_finegrain: int = 0
    dtype: str = "float64"
    kernel: str = "auto"
    overlap: int = 0
    bc_layout: int = 0
    mxu_precision: str = "highest"

    @classmethod
    def from_env(cls) -> "SpmmConfig":
        return cls(
            rb_p2p=get_env_int("RP_SPMM_P2P", 1, 0, 1, var_name="rB_p2p"),
            rb_reidx=get_env_int("RP_SPMM_REIDX", 1, 0, 1, var_name="rB_reidx"),
            a2a_b_finegrain=get_env_int(
                "A2A_B_FINEGRAIN", 0, 0, 1, var_name="a2a_B_finegrain"
            ),
            dtype=os.environ.get("CRP_TPU_DTYPE", "float64"),
            kernel=os.environ.get("CRP_TPU_KERNEL", "auto"),
            overlap=get_env_int("CRP_TPU_OVERLAP", 0, 0, 1, var_name="overlap"),
            bc_layout=get_env_int(
                "CRP_TPU_BC_LAYOUT", 0, 0, 1, var_name="BC_layout"
            ),
            mxu_precision=os.environ.get("CRP_TPU_MXU_PREC", "highest"),
        )
