"""Error norms (``crp_tpu/utils/norms.py``): the reference's acceptance
metric ``||C_ref - C||_F / ||C_ref||_F`` (``src/utils.c:75-89``)."""

from __future__ import annotations

import numpy as np


def calc_err_2norm(x0: np.ndarray, x1: np.ndarray) -> tuple[float, float]:
    """(||x0||_2, ||x0 - x1||_2) over flattened arrays."""
    x0 = np.asarray(x0, dtype=np.float64).ravel()
    x1 = np.asarray(x1, dtype=np.float64).ravel()
    return float(np.linalg.norm(x0)), float(np.linalg.norm(x0 - x1))


def rel_fro_err(c_ref: np.ndarray, c: np.ndarray) -> float:
    """``||C_ref - C||_F / ||C_ref||_F`` (the plain error when C_ref = 0)."""
    ref_norm, err_norm = calc_err_2norm(c_ref, c)
    if ref_norm == 0.0:
        return err_norm
    return err_norm / ref_norm
