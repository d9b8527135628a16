"""Matrix reordering for bandwidth reduction and the METIS seam
(``crp_tpu/sparse/reorder.py``, numpy and the port's own C++ only).

The reference offers METIS k-way partitioning with a symmetric permutation
applied in place (``examples/metis_mat_part.c:31-112``) and documents
MATLAB ``symrcm`` reordering as the alternative that shrinks planner windows
(``deprecated/SC23_AD/readme.md:95-102``).  Reordering reduces the
communicated elements and shrinks the windows of the panel kernels.

The k-way backend chain is JAX's: libmetis (``sparse/metis.py``), then
pymetis, then the native greedy graph growing (``native/ggp.cpp``), then its
numpy twin (:func:`_ggp_partition_py`).  :func:`partition_backend` and
:func:`bisect_backend` name the backend a call takes, the functions log
it, and the matrices that :func:`metis_row_partition` and
:func:`cluster_reorder` return carry it as ``backend``.  The functions take
any CSR object (``nrow``, ``ncol``, ``rowptr``, ``colidx``, ``val``) and
return the port's :class:`CSRMatrix`; their decisions equal the JAX
package's bit for bit (``tests/test_torch_reorder.py``).
"""

from __future__ import annotations

import heapq
import logging

import numpy as np

from .. import native
from . import metis as libmetis
from .csr import CSRMatrix

logger = logging.getLogger("crp_tpu_torch")


def _as_csr(a) -> CSRMatrix:
    if isinstance(a, CSRMatrix):
        return a
    return CSRMatrix(a.nrow, a.ncol, a.rowptr, a.colidx, a.val)


def permute_symmetric(a, perm: np.ndarray) -> CSRMatrix:
    """Apply the symmetric permutation ``A' = A[perm][:, perm]``.

    ``perm[new] = old`` (scipy convention).  Equivalent to the reference's
    COO rebuild (``examples/metis_mat_part.c:66-112``).
    """
    perm = np.asarray(perm, dtype=np.int64)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(len(perm))
    rows = np.repeat(np.arange(a.nrow), np.diff(a.rowptr))
    return CSRMatrix.from_coo(
        a.nrow, a.ncol, iperm[rows], iperm[a.colidx], a.val, dtype=a.val.dtype
    )


def rcm_reorder(a) -> tuple[CSRMatrix, np.ndarray]:
    """Reverse Cuthill-McKee reordering (the symrcm analog).

    Returns (permuted matrix, perm) with ``perm[new] = old``.
    """
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    a = _as_csr(a)
    if a.nrow != a.ncol:
        raise ValueError("RCM reordering requires a square matrix")
    perm = np.asarray(
        reverse_cuthill_mckee(a.to_scipy(), symmetric_mode=True), dtype=np.int64
    )
    out = permute_symmetric(a, perm)
    logger.info("RCM reorder: bandwidth %d -> %d", a.bandwidth(), out.bandwidth())
    return out, perm


def _ggp_partition_py(
    rowptr: np.ndarray, colidx: np.ndarray, nparts: int, imbalance: float
) -> np.ndarray:
    """Pure-python twin of ``native.ggp_partition`` (greedy graph growing):
    grow parts from min-degree seeds, absorbing the frontier vertex with the
    most neighbors already inside the part, under the imbalance cap.  Its
    decisions differ from the C++ one's (a stable degree sort, Python's
    heap order) and equal the JAX twin's."""
    nrow = len(rowptr) - 1
    if nparts <= 1 or nrow == 0:
        return np.zeros(nrow, dtype=np.int64)
    part = np.full(nrow, -1, dtype=np.int64)
    by_deg = np.argsort(np.diff(rowptr), kind="stable")
    cursor = 0
    in_cur = np.zeros(nrow, dtype=np.int64)
    stamp = np.full(nrow, -1, dtype=np.int64)
    remaining = nrow
    cap = int(imbalance * nrow / nparts) + 1
    for p in range(nparts):
        target = -(-remaining // (nparts - p))
        target = remaining if p == nparts - 1 else min(target, cap)
        heap: list = []  # (-gain, v), stale entries skipped on pop
        size = 0
        while size < target and remaining > 0:
            v = -1
            while heap:
                g, u = heapq.heappop(heap)
                if part[u] != -1:
                    continue
                cur = in_cur[u] if stamp[u] == p else 0
                if -g != cur:
                    heapq.heappush(heap, (-cur, u))
                    continue
                v = u
                break
            if v == -1:
                while cursor < nrow and part[by_deg[cursor]] != -1:
                    cursor += 1
                if cursor >= nrow:
                    break
                v = int(by_deg[cursor])
            part[v] = p
            size += 1
            remaining -= 1
            for w in colidx[rowptr[v]:rowptr[v + 1]]:
                w = int(w)
                if w == v or w >= nrow or part[w] != -1:
                    continue
                if stamp[w] != p:
                    stamp[w] = p
                    in_cur[w] = 0
                in_cur[w] += 1
                heapq.heappush(heap, (-int(in_cur[w]), w))
    part[part == -1] = nparts - 1
    return part


def _pymetis():
    try:
        import pymetis
    except ImportError:
        return None
    return pymetis


def partition_backend() -> str:
    """The backend :func:`metis_partition_rows` takes here: ``"libmetis"``,
    ``"pymetis"``, ``"native"`` (the C++ greedy graph growing) or
    ``"numpy"`` (its twin), the first available in that order."""
    if libmetis.available():
        return "libmetis"
    if _pymetis() is not None:
        return "pymetis"
    return bisect_backend()


def bisect_backend() -> str:
    """The backend of :func:`cluster_reorder`'s bisections: ``"native"``
    where ``native/ggp.cpp`` builds, else ``"numpy"``."""
    return "native" if native.available() else "numpy"


def _ggp(rowptr, colidx, nparts, imbalance, backend) -> np.ndarray:
    if backend == "native":
        parts = native.ggp_partition(rowptr, colidx, nparts, imbalance)
    else:
        parts = _ggp_partition_py(rowptr, colidx, nparts, imbalance)
    return np.asarray(parts, dtype=np.int64)


def metis_partition_rows(a, nparts: int, imbalance: float = 1.05) -> np.ndarray:
    """K-way row partition behind the reference's METIS seam.

    Backend chain (:func:`partition_backend`), logged at info level:

      1. **libmetis** via ctypes (``sparse.metis``): the reference's exact
         call, ``METIS_OBJTYPE_VOL`` and ubvec 1.05
         (``examples/metis_mat_part.c:44-62``);
      2. **pymetis** (edge-cut objective; ufactor honored when the build
         exposes Options);
      3. **native greedy graph growing** (``native/ggp.cpp``), or its numpy
         twin where no compiler is present.

    Returns the (nrow,) int64 part-id vector.
    """
    return _partition_rows(a, nparts, imbalance)[0]


def _partition_rows(a, nparts: int, imbalance: float) -> tuple[np.ndarray, str]:
    """:func:`metis_partition_rows` and the name of the backend it took."""
    backend = partition_backend()
    if backend == "libmetis":
        logger.info("METIS row partition: libmetis (OBJTYPE_VOL)")
        return libmetis.part_graph_kway(a.rowptr, a.colidx, nparts, imbalance), backend
    if backend == "pymetis":  # pragma: no cover - optional dependency
        pymetis = _pymetis()
        logger.info("METIS row partition: pymetis (edge-cut)")
        adj = [
            a.colidx[a.rowptr[i]:a.rowptr[i + 1]].tolist()
            for i in range(a.nrow)
        ]
        kw = {}
        if hasattr(pymetis, "Options"):
            try:
                opts = pymetis.Options()
                opts.ufactor = max(int(round((imbalance - 1.0) * 1000)), 1)
                kw["options"] = opts
            except (AttributeError, TypeError):
                pass
        _, parts = pymetis.part_graph(nparts, adjacency=adj, **kw)
        return np.asarray(parts, dtype=np.int64), backend
    logger.info("METIS row partition: greedy graph growing (%s)", backend)
    return _ggp(a.rowptr, a.colidx, nparts, imbalance, backend), backend


def metis_row_partition(
    a, nparts: int, imbalance: float = 1.05
) -> tuple[CSRMatrix, np.ndarray, np.ndarray]:
    """METIS k-way partition + symmetric permutation grouping parts.

    Mirrors ``METIS_row_partition`` (``examples/metis_mat_part.c:31-112``):
    partition the adjacency graph (:func:`metis_partition_rows` backend
    chain), sort vertices by part id, permute symmetrically, and return the
    per-part row displacements to seed the planner.  Returns
    ``(permuted matrix, perm, displs)`` with ``perm[new] = old``; the
    matrix's ``backend`` names the partitioner that ran.
    """
    if a.nrow != a.ncol:
        raise ValueError("METIS partitioning requires a symmetric matrix")
    parts, backend = _partition_rows(a, nparts, imbalance)
    perm = np.argsort(parts, kind="stable").astype(np.int64)
    out = permute_symmetric(a, perm)
    out.backend = backend
    counts = np.bincount(parts, minlength=nparts)
    displs = np.zeros(nparts + 1, dtype=np.int64)
    np.cumsum(counts, out=displs[1:])
    return out, perm, displs


def _bisect(rowptr: np.ndarray, colidx: np.ndarray, imbalance: float,
            backend: str) -> np.ndarray:
    """One 2-way GGGP split of a (sub)graph: part-id vector in {0, 1}."""
    return _ggp(rowptr, colidx, 2, imbalance, backend)


def _refine_bisection(
    rowptr: np.ndarray,
    colidx: np.ndarray,
    parts: np.ndarray,
    rounds: int,
    imbalance: float,
) -> np.ndarray:
    """Synchronous boundary refinement of a 2-way split (vectorized
    Kernighan-Lin-flavored sweeps): each round moves every positive-gain
    vertex (more neighbors across the cut than inside), trimming the
    lowest-gain movers when the net flow would breach the balance cap.
    O(nnz) per round in numpy."""
    n = len(rowptr) - 1
    if n == 0 or rounds <= 0:
        return parts
    deg = np.diff(rowptr)
    row_of = np.repeat(np.arange(n), deg)
    cap = int(imbalance * n / 2) + 1
    for _ in range(rounds):
        in1 = np.bincount(row_of, weights=parts[colidx], minlength=n)
        gain = np.where(parts == 0, 2 * in1 - deg, deg - 2 * in1)
        move = gain > 0
        m0 = np.nonzero(move & (parts == 0))[0]
        m1 = np.nonzero(move & (parts == 1))[0]
        if len(m0) == 0 and len(m1) == 0:
            break
        c0 = int((parts == 0).sum())
        # net flow into part 0 is len(m1) - len(m0); trim the lowest-gain
        # movers on whichever side overfills
        c0_new = c0 - len(m0) + len(m1)
        if c0_new > cap and len(m1):
            k = c0_new - cap
            order = np.argsort(gain[m1], kind="stable")
            m1 = m1[order[k:]] if k < len(m1) else m1[:0]
            c0_new = c0 - len(m0) + len(m1)
        if c0_new < n - cap and len(m0):
            k = (n - cap) - c0_new
            order = np.argsort(gain[m0], kind="stable")
            m0 = m0[order[k:]] if k < len(m0) else m0[:0]
        if len(m0) == 0 and len(m1) == 0:
            break
        parts = parts.copy()
        parts[m0] = 1
        parts[m1] = 0
    return parts


def cluster_reorder(
    a,
    leaf_size: int = 256,
    imbalance: float = 1.10,
    refine_rounds: int = 8,
) -> tuple[CSRMatrix, np.ndarray]:
    """Recursive-bisection locality ordering (nested GGGP).

    The reference's METIS reorder sorts vertices by a flat k-way part id,
    so with few parts the vertices within a part keep their original
    (possibly scrambled) order.  Recursive bisection splits each level by
    connectivity and emits the leaves depth-first, so strongly connected
    vertex sets get contiguous new ids at every scale down to
    ``leaf_size``.  Each split is polished by ``refine_rounds`` synchronous
    boundary-refinement sweeps (:func:`_refine_bisection`).

    Cost: O(depth x nnz) with depth = log2(nrow / leaf_size).  Returns
    (permuted matrix, perm), ``perm[new] = old``; the matrix's ``backend``
    names the bisection's partitioner (:func:`bisect_backend`).
    """
    a = _as_csr(a)
    if a.nrow != a.ncol:
        raise ValueError("cluster reordering requires a symmetric matrix")
    backend = bisect_backend()
    rowptr = np.asarray(a.rowptr, dtype=np.int64)
    colidx = np.asarray(a.colidx, dtype=np.int64)
    nrow = a.nrow
    perm = np.empty(nrow, dtype=np.int64)
    n_out = 0
    pos = np.full(nrow, -1, dtype=np.int64)  # orig id -> local id scratch
    stack = [np.arange(nrow, dtype=np.int64)]
    while stack:
        ids = stack.pop()
        if len(ids) <= leaf_size:
            perm[n_out: n_out + len(ids)] = ids
            n_out += len(ids)
            continue
        # the induced subgraph A[ids][:, ids]: the gather index list is the
        # concatenation of each row's CSR range
        pos[ids] = np.arange(len(ids))
        deg = rowptr[ids + 1] - rowptr[ids]
        total = int(deg.sum())
        cum = np.zeros(len(ids), dtype=np.int64)
        np.cumsum(deg[:-1], out=cum[1:])
        gather = (
            np.repeat(rowptr[ids] - cum, deg) + np.arange(total)
        ) if len(ids) < nrow else np.arange(len(colidx))
        sub_cols_orig = colidx[gather]
        keep = pos[sub_cols_orig] >= 0
        # re-count per-row degrees after dropping cross-subset edges
        row_of = np.repeat(np.arange(len(ids)), deg)
        kept_rows = row_of[keep]
        sub_colidx = pos[sub_cols_orig[keep]]
        sub_rowptr = np.zeros(len(ids) + 1, dtype=np.int64)
        np.cumsum(np.bincount(kept_rows, minlength=len(ids)),
                  out=sub_rowptr[1:])
        pos[ids] = -1
        parts = _bisect(sub_rowptr, sub_colidx, imbalance, backend)
        parts = _refine_bisection(
            sub_rowptr, sub_colidx, parts, refine_rounds, imbalance
        )
        left, right = ids[parts == 0], ids[parts == 1]
        if len(left) == 0 or len(right) == 0:  # degenerate: emit as leaf
            perm[n_out: n_out + len(ids)] = ids
            n_out += len(ids)
            continue
        stack.append(right)  # LIFO: left emitted first (depth-first)
        stack.append(left)
    if n_out != nrow:
        raise RuntimeError(f"cluster reorder emitted {n_out} of {nrow} rows")
    out = permute_symmetric(a, perm)
    out.backend = backend
    logger.info(
        "cluster reorder (%s): bandwidth %d -> %d (leaf %d)",
        backend, a.bandwidth(), out.bandwidth(), leaf_size,
    )
    return out, perm


def spectral_partition_rows(a, nparts: int) -> np.ndarray:
    """Degree-balanced fallback 1D partition for graph matrices without
    METIS.  Returns (nparts+1,) displacements."""
    from ..plan.partition1d import csr_row_partition

    return csr_row_partition(a.rowptr, nparts)
