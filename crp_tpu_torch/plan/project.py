"""Projected multi-GPU exec model (``crp_tpu/plan/project.py``).

One card is available, so the exec time of a row-parallel run over p
cards cannot be measured; what can be grounded is (a) the local kernel's
roofline terms, priced on one card's measured rates, and (b) the exchange
volumes, which the plans compute exactly.  This module combines them into
a per-plan projected exec time, in JAX's form:

    kernel_s = max_i max(hbm_bytes_i / HBM, flops_i / tensor)
               + spill_nnz_i * spill_ns
    comm_s   = max_i ring_bytes_i / link
    projected_no_overlap = kernel_s + comm_s
    projected_overlap    = max(kernel_s, comm_s)

The byte, FLOP and spill terms, the pack gate they mirror and the comm
volumes are JAX's.  The rates and the pass prices are the card's: the
rates are an argument (``rates=``, defaults :data:`DEFAULT_RATES`, each
with its origin in :data:`RATE_PROVENANCE`), and the passes those of the
port's bodies (:func:`~crp_tpu_torch.kernels.points.precision_point`: 3
bf16 passes at x3, 1 at default, 3 TF32 passes at highest, where JAX
prices 6).
"""

from __future__ import annotations

import numpy as np

from ..kernels.points import precision_point

# effective rates of one NVIDIA H100 80GB HBM3 at a 700.00 W power limit,
# derived from chip_smoke.py's run (see RATE_PROVENANCE); the tensor rates
# are counted per pass, each at its operating point
DEFAULT_RATES = dict(
    x3_tflops=507.05, default_tflops=412.37, highest_tflops=179.32,
    hbm_gbps=3011.8, link_gbps=450.0, spill_ns=0.7525,
)

# where each default rate comes from: emitted with the first projection
# record of a run, so a reader can audit (and re-pin) the weakest terms
RATE_PROVENANCE = dict(
    x3_tflops="measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py): "
              "#1 spmm_window_sg_presplit on the headline, its design bound "
              "at 989 TF/s bf16 over its time, times 989 TF/s",
    default_tflops="measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py): "
                   "#2 spmm_window_sg_bf16 on the headline, its design bound "
                   "at 989 TF/s bf16 over its time, times 989 TF/s",
    highest_tflops="measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py): "
                   "#3 spmm_window_sg on the headline, its design bound at "
                   "495 TF/s TF32 (3 passes) over its time, times 495 TF/s",
    hbm_gbps="measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py "
             "drivers_path): a device copy of 2 GiB of panels, read and "
             "write counted",
    link_gbps="UNMEASURED (one card here): H100 SXM NVLink 4 data sheet, "
              "450 GB/s per direction, ring send and receive concurrent",
    spill_ns="measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py): "
             "#9 spmm_spill on cplaw at x3, its time over its spilled nnz",
)


def _shard_kernel_terms(shard, n_pad, mxu_prec, itemsize, geometry=None):
    """Roofline inputs for one shard's local SpMM: (hbm_bytes, flops,
    spill_nnz) (``crp_tpu/plan/project.py:69-123``).  Mirrors the pack
    selection: uniform windowed geometry when feasible, else the ragged
    cover estimate.  ``geometry`` is the partition-shared ragged (TM, Wc)
    that ``_pack_ragged`` resolves once on the largest shard."""
    from ..kernels.dispatch import _uniform_cost_estimate
    from ..kernels.spmm_ragged import estimate_ragged, resolve_ragged_geometry

    passes, _ = precision_point(mxu_prec, np.float64 if itemsize == 8 else np.float32)
    a_item = 2 if mxu_prec in ("x3", "default") else itemsize
    a_item = a_item * 2 if mxu_prec == "x3" else a_item  # hi/lo pair
    b_item = 2 if mxu_prec == "default" else itemsize

    cc = shard.colidx
    trip = (shard.rowptr, cc, shard.val)
    W, G, ok = _uniform_cost_estimate([trip], shard.nrow)
    if geometry is not None:
        TMr, Wcr = geometry
    else:
        TMr, Wcr = resolve_ragged_geometry(shard.rowptr, cc, mxu_prec)
    S, spill, Gr = estimate_ragged(shard.rowptr, cc, TMr, Wcr)
    if ok:
        # dispatch._pack_pallas's gate: the uniform-vs-ragged byte
        # comparison (at the pack dtype's itemsize) runs only for wide or
        # large windows; small feasible windows take the uniform path
        TM = 256
        bytes_uniform_gate = G * TM * W * itemsize
        take_uniform = True
        if W > 4096 or bytes_uniform_gate > (1 << 30):
            bytes_ragged_gate = S * TMr * Wcr * itemsize
            take_uniform = bytes_uniform_gate <= 3 * max(bytes_ragged_gate, 1)
        if take_uniform:
            a_bytes = G * TM * W * a_item
            b_rows = G * W
            flops = 2.0 * G * TM * W * n_pad * passes
            hbm = a_bytes + b_rows * n_pad * b_item + G * TM * n_pad * 4
            return hbm, flops, 0
    G = Gr
    a_bytes = S * TMr * Wcr * a_item
    flops = 2.0 * S * TMr * Wcr * n_pad * passes
    hbm = a_bytes + S * Wcr * n_pad * b_item + G * TMr * n_pad * 4
    return hbm, flops, spill


def project_exec_1d(
    a, n, p, *, mxu_prec="x3", dtype=np.float32, reidx=True,
    calibration: float = 1.0, include_provenance: bool = False,
    rates: dict | None = None,
):
    """Projected 1D row-parallel exec time for p cards
    (``crp_tpu/plan/project.py:126-192``).

    Returns a dict with the roofline terms, the exact plan comm volumes,
    and the projected times with and without comm-compute overlap, in
    seconds rounded to the nanosecond (JAX rounds to the microsecond,
    which at the card's rates drops most digits of a small matrix).
    ``rates`` overrides keys of :data:`DEFAULT_RATES`; ``calibration``
    scales the kernel term by (measured p=1 exec / projected p=1 exec).
    """
    from ..comm.exchange import build_b_exchange
    from ..kernels.spmm_ragged import resolve_ragged_geometry
    from ..plan.partition1d import csr_row_partition

    r = {**DEFAULT_RATES, **(rates or {})}
    itemsize = np.dtype(dtype).itemsize
    # fp64 runs on the FP64 tensor cores: #3 or #6 at one card, the fused
    # #12 over several
    passes, peak = precision_point(mxu_prec, dtype, fp64_tc=True)
    tensor = r.get(f"{mxu_prec}_tflops", r["highest_tflops"]) * 1e12
    hbm_rate, link = r["hbm_gbps"] * 1e9, r["link_gbps"] * 1e9
    tn = 256 if n % 256 == 0 else 128
    n_pad = -(-n // tn) * tn

    # A slicing uses the row partition as-is; B ownership extends the last
    # slab to ncol like RowParaSpmm
    displs = csr_row_partition(a.rowptr, p)
    b_displs = displs
    if int(b_displs[-1]) < a.ncol:
        b_displs = b_displs.copy()
        b_displs[-1] = a.ncol
    shards = [a.row_slice(int(displs[i]), int(displs[i + 1])) for i in range(p)]
    # one ragged geometry for the whole partition, resolved on the
    # largest-nnz shard, as _pack_ragged resolves it
    geometry = None
    live = [sh for sh in shards if sh.nnz > 0]
    if live:
        big = max(live, key=lambda sh: sh.nnz)
        big_loc, _, _ = big.localize() if reidx else (big, 0, 0)
        geometry = resolve_ragged_geometry(big_loc.rowptr, big_loc.colidx, mxu_prec)
    kernel_s = 0.0
    for sh in shards:
        if sh.nnz == 0:
            continue
        loc, _, _ = sh.localize() if reidx else (sh, 0, 0)
        hbm, flops, spill = _shard_kernel_terms(loc, n_pad, mxu_prec, itemsize,
                                                geometry=geometry)
        t = max(hbm / hbm_rate, flops / tensor) + spill * r["spill_ns"] * 1e-9
        kernel_s = max(kernel_s, t)
    kernel_s *= calibration

    xplan = build_b_exchange([s.colidx for s in shards], b_displs, reidx=reidx)
    # ring schedule: each card sends and receives (p-1) shifts of S padded
    # rows concurrently, per-card wire bytes per direction, at the logical
    # n (the exchange runs before the kernel's n-tile padding)
    ring_bytes = (p - 1) * xplan.S * n * itemsize
    comm_s = ring_bytes / link if p > 1 else 0.0
    logical_rows = int(xplan.rB_recv_rows.max()) if p > 1 else 0

    return dict(
        p=p,
        kernel_s=round(kernel_s, 9),
        comm_s=round(comm_s, 9),
        projected_s=round(kernel_s + comm_s, 9),
        projected_overlap_s=round(max(kernel_s, comm_s), 9),
        comm_bytes_per_chip=int(ring_bytes),
        comm_rows_logical_max=logical_rows,
        passes=passes, peak=peak,
        rates=dict(tensor_tflops=tensor / 1e12, hbm_gbps=r["hbm_gbps"],
                   link_gbps=r["link_gbps"], spill_ns=r["spill_ns"]),
        **({"rate_provenance": RATE_PROVENANCE} if include_provenance else {}),
        calibration=round(calibration, 4),
    )


def project_scaling(a, n, procs, **kw):
    """Projection rows for a strong-scaling sweep (one dict per p)."""
    return [project_exec_1d(a, n, p, **kw) for p in procs]
