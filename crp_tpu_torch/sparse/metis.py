"""Direct ctypes binding to libmetis (``METIS_PartGraphKway``), a copy of
``crp_tpu/sparse/metis.py`` (the port keeps its own).

The reference partitions rows with METIS using the *communication volume*
objective and 5% imbalance (``examples/metis_mat_part.c:44-62``):

    options[METIS_OPTION_OBJTYPE] = METIS_OBJTYPE_VOL;
    ubvec = 1.05;
    METIS_PartGraphKway(&nvtxs, &ncon, xadj, adjncy, NULL, NULL, NULL,
                        &nparts, NULL, &ubvec, options, &objval, part);

pymetis's ``part_graph`` exposes neither the objective nor ubvec, so this
module binds libmetis directly when a shared library is installed.  METIS
builds vary in ``IDXTYPEWIDTH``/``REALTYPEWIDTH`` (32 or 64 bit); the width
is probed once with a tiny path graph whose valid partitions are known.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import logging

import numpy as np

logger = logging.getLogger("crp_tpu_torch")

# metis.h (5.x): enum moptions_et / mobjtype_et / rstatus_et
_METIS_NOPTIONS = 40
_METIS_OPTION_OBJTYPE = 1
_METIS_OPTION_UFACTOR = 16
_METIS_OBJTYPE_VOL = 1
_METIS_OK = 1

_lib = None
_widths: tuple | None = None  # (idx_dtype, real_dtype) once probed


def _load():
    global _lib
    if _lib is not None:
        return _lib
    names = []
    found = ctypes.util.find_library("metis")
    if found:
        names.append(found)
    names += ["libmetis.so", "libmetis.so.5", "libmetis.dylib"]
    for name in names:
        try:
            lib = ctypes.CDLL(name)
            lib.METIS_PartGraphKway  # noqa: B018 - presence check
            _lib = lib
            return _lib
        except (OSError, AttributeError):
            continue
    return None


def available() -> bool:
    return _load() is not None


def _part_kway_raw(lib, idx_dt, real_dt, xadj, adjncy, nparts, ubvec, ufactor):
    """One METIS_PartGraphKway call at the given idx/real widths."""
    idx_c = ctypes.c_int32 if idx_dt == np.int32 else ctypes.c_int64
    nvtxs = len(xadj) - 1
    xadj = np.ascontiguousarray(xadj, dtype=idx_dt)
    adjncy = np.ascontiguousarray(adjncy, dtype=idx_dt)
    part = np.zeros(max(nvtxs, 1), dtype=idx_dt)
    # options buffer sized for the widest build so a 64-bit
    # METIS_SetDefaultOptions cannot write past the end
    options = np.full(_METIS_NOPTIONS * 2, -1, dtype=np.int64).view(idx_dt)
    lib.METIS_SetDefaultOptions(options.ctypes.data_as(ctypes.c_void_p))
    options[_METIS_OPTION_OBJTYPE] = _METIS_OBJTYPE_VOL
    if ufactor is not None:
        options[_METIS_OPTION_UFACTOR] = ufactor
    ub = np.array([ubvec], dtype=real_dt)
    c_nvtxs, c_ncon, c_nparts, objval = idx_c(nvtxs), idx_c(1), idx_c(nparts), idx_c(0)
    vp = ctypes.c_void_p
    rc = lib.METIS_PartGraphKway(
        ctypes.byref(c_nvtxs), ctypes.byref(c_ncon),
        xadj.ctypes.data_as(vp), adjncy.ctypes.data_as(vp),
        None, None, None,
        ctypes.byref(c_nparts), None,
        ub.ctypes.data_as(vp),
        options.ctypes.data_as(vp),
        ctypes.byref(objval), part.ctypes.data_as(vp),
    )
    return rc, part.astype(np.int64), int(objval.value)


def _probe_widths(lib) -> tuple | None:
    """Find (idx, real) dtypes by partitioning a 6-vertex path into 2.

    Widest-first: a 32-bit-IDXTYPEWIDTH library reading int64 buffers stays
    in bounds (reads half the bytes, sees a garbled graph, returns an
    error), while a 64-bit library reading int32 buffers would read PAST
    them — possibly segfaulting before a narrower combo is ever tried.
    """
    xadj = np.array([0, 1, 3, 5, 7, 9, 10])
    adjncy = np.array([1, 0, 2, 1, 3, 2, 4, 3, 5, 4])
    for idx_dt, real_dt in (
        (np.int64, np.float64), (np.int64, np.float32),
        (np.int32, np.float32), (np.int32, np.float64),
    ):
        try:
            rc, part, _ = _part_kway_raw(
                lib, idx_dt, real_dt, xadj, adjncy, 2, 1.05, None
            )
        except (OSError, ctypes.ArgumentError):
            continue
        counts = np.bincount(part[(part >= 0) & (part < 2)], minlength=2)
        if rc == _METIS_OK and counts.min() >= 2:
            return idx_dt, real_dt
    return None


def part_graph_kway(
    rowptr: np.ndarray,
    colidx: np.ndarray,
    nparts: int,
    imbalance: float = 1.05,
) -> np.ndarray:
    """K-way partition of the CSR adjacency with the reference's settings.

    Self-loops are stripped (METIS requires adjncy without them).  Returns
    the (nvtxs,) int64 part vector.  Raises ``RuntimeError`` if libmetis is
    missing or rejects the graph.
    """
    global _widths
    lib = _load()
    if lib is None:
        raise RuntimeError("libmetis shared library not found")
    if _widths is None:
        _widths = _probe_widths(lib)
        if _widths is None:
            raise RuntimeError("could not determine libmetis idx_t width")
    nvtxs = len(rowptr) - 1
    rows = np.repeat(np.arange(nvtxs, dtype=np.int64), np.diff(rowptr))
    keep = rows != np.asarray(colidx, dtype=np.int64)
    adjncy = np.asarray(colidx, dtype=np.int64)[keep]
    xadj = np.zeros(nvtxs + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows[keep], minlength=nvtxs), out=xadj[1:])
    # ufactor is METIS's (imbalance - 1) * 1000; the reference leaves it at
    # the default and passes ubvec = 1.05 instead — do the same
    rc, part, objval = _part_kway_raw(
        lib, *_widths, xadj, adjncy, nparts, imbalance, None
    )
    if rc != _METIS_OK:
        raise RuntimeError(f"METIS_PartGraphKway failed with status {rc}")
    logger.info(
        "METIS_PartGraphKway done, objval (comm volume) = %d", objval
    )
    return part
