"""Smoke test of the PyTorch/CUDA port (``crp_tpu_torch``) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``crp_tpu_torch/kernels/csrc`` into
``build/crp_tpu_torch/`` (one ``nvcc`` per source, all started together),
prints the shared-memory rings of the wgmma body in each library that
builds it (#1 with #5, the one-pass #2 and the TF32 mode of #3 at
highest, #4 with its one-pass default and its TF32 mode, #12 with its
one-pass default and its TF32 mode, each also with the waits across
processes, the ragged #7 with the one-pass #8 and the TF32 mode of #6 at
highest: stages, dynamic shared memory, registers, spills and blocks per
SM, which must be 0 and at least 1),
the spill and gather kernels' resources (``[spill]``: registers, spills
and blocks per SM of each, which must be 0 and at least 1), the DMMA
body's (``[dd]``: its ring, block tile, DMMA shape, and the same for its
ragged walk, #11 and #6 on fp64, its windowed walk, #3 and #4 on fp64,
with B through the chunk table, #12 on fp64, and with the flags' waits,
#12 across processes, which must be 0 and exactly 1) and then,
failing on the first check
that does not hold (every engine init prints its peak device memory; an
x3 or default panel pack, and every fp32 pack's TF32 planes at highest,
must peak within 1.2 x what it holds after):

1. kernel phase — each windowed kernel against its plain PyTorch version on
   small banded packs with pad groups, n in {16, 48, 100, 256}; then #5
   (x3 on B pre-split by ``split_b_bf16``) on the x3 pack against its
   plain version and against #1's C, which it must equal bit for bit;
2. ragged phase — each ragged kernel and the fused spill kernel against
   their plain versions (the spill also equal bit for bit to the emulation
   of its fixed sum order and to a second launch) on small power-law and
   multiband packs, over
   (TM, Wc) geometries, n in {16, 37, 100, 256} and at n = 100 a B that
   starts off 16 bytes (odd n and that B take the plain B copies), with
   pad groups that must come out zero, and #6 at highest (the wgmma body's
   TF32 mode on the pack's TF32 planes) equal to a second launch bit for
   bit;
3. headline — the pwtk-class banded matrix (217,918 rows, 11,429,953 nnz,
   fp32) times the analytic B (n = 256) through ``RowParaSpmm`` at p = 1
   for each operating point (x3, default, highest): the engine must
   resolve to the uniform windowed kernel (the ragged gate priced and
   passed over), launch it, and match an fp64 numpy reference on the first
   32 columns; then each kernel against its plain version at the main
   path's shapes, with times, and cuSPARSE (``torch.sparse_csr_tensor @
   B``) as a yardstick; on the x3 engine's pack, the presplit-B comparison
   (``crp_tpu_torch.cli.presplit_b_sweep.sweep``: #1 on fp32 B, #5 on
   ``split_b_bf16(B)``, #2 on its hi half) with its launch counts, #5 at
   x3's class and equal to #1 bit for bit, #2 faster than #1, then #5
   against its plain version at the main path's shape, timed in turns (no
   engine takes #5: every engine's exec must launch it zero times); on the
   default pack, #2's C against #1's on (ah, 0, bh as fp32);
4. cplaw path — the community power-law matrix
   ``powerlaw_community_csr(786432, 16, 1024)`` (10.8M nnz, fp32, n = 256)
   the same way: the engine must resolve to the ragged kernels with the
   fused spill and launch both; each kernel against its plain version
   (the spill also bit for bit against its order's emulation and a second
   launch; its share of rows with a live slot), times, the host cover
   time and cuSPARSE; at highest #6 equal to a second launch bit for bit,
   its time beside the previous body's (3xTF32 on ``mma.sync``);
5. gather phase — the gather kernel against its plain version, and bit
   for bit against its order's emulation and a second launch, on small
   scrambled power-law packs at each operating point, n in {16, 37, 48,
   100, 256, 512} and at n = 256 a B off 16 bytes, B row 0 set to NaN (pad
   slots must be skipped) and trailing blocks with no nonzero (they must
   come out zero);
6. dd phase — the FP64 tensor-core kernel against its plain version on
   small banded and power-law total covers, (TM, Wc) = (128, 512) and
   (128, 256), with pad groups that must come out zero, and equal bit for
   bit to a second launch;
7. scrambled-cplaw path — the same cplaw matrix with its vertex ids
   permuted (``permute=True``), through ``RowParaSpmm(kernel="auto")``:
   the ragged cover refuses and the walk must land on ``gather`` and launch
   its kernel, within each point's class; the kernel against its plain
   version and bit for bit against its order's emulation, times beside
   the gathered-rows floor, cuSPARSE;
8. reorder path — (a) ``cluster_reorder`` on the same scrambled matrix
   (the native greedy graph growing, its host time, the bandwidth and
   the cover's spill share, JAX's values), then ``RowParaSpmm(kernel=
   "auto")`` at x3 on A' = A[perm][:, perm] and B[perm]: the ragged kind,
   #7 and #9 launched once, the fill's spill count pinned, C within x3's
   class of the fp64 reference's rows ``perm``; #7 and #9 against their
   plain versions (#9 bit for bit to its order), timed with their bounds,
   cuSPARSE on A' and ``addmm`` for the spill, the exec beside the
   scrambled graph's ``gather`` exec, and for comparison the gather
   kernel on A'; (b) the native GGGP's digest on the
   first case of ``tests/fixtures/ggp_oracle.json``, ``plan_from_csr(
   method="metis")`` at n = 16, p = 4 on a copy (4 x 1, rB_cost
   17,489,488) beside the nnz plan (2 x 2), and ``Para2dSpmm`` on the
   METIS plan at x3 (``auto`` -> ``gather`` on each of the 4 panels) within
   x3's class, its exchanged rows and elements equal to the plan's, and
   #10 on panel 0 against its plain version, timed;
9. fp64-class path — ``banded_random_csr(217918, 53, 256)`` in fp64
   through ``RowParaSpmm(kernel="dd")`` must resolve to ``dd_mxu`` (S =
   3,402) on the FP64 tensor cores at <= 1e-12; on its pack the kernel
   against its plain version, #6's fp64 entry (the same DMMA body) equal
   to it bit for bit, and cuSPARSE in fp64; then the
   fp64 cplaw (segment-sum tier) and the pwtk-class headline (ELL tier)
   with ``kernel="dd"`` at <= 1e-12; on each of the three,
   ``kernel="auto"`` in fp64 (the panel kernels' fp64 entries: #3 on the
   banded matrix, #6 on the other two, on the FP64 tensor cores) at <=
   1e-12, its kernel launched, a second launch equal bit for bit, its exec
   and kernel times beside ``dd``'s and cuSPARSE's, and its record; on the
   cplaw ``dd`` segment-sum tier and the segsum spills of fp64 ``auto``,
   the fixed-order segment sum twice (equal bit for bit), against the sum
   in fp64 and ``index_add_``'s, both timed;
10. window phase — the non-super-grouped windowed kernel (#4) against its
   plain version at x3 (on the bf16 hi/lo pair, #1's wgmma body, and equal
   bit for bit to #1 on the same arrays), default (on the bf16 hi plane
   and B cast to bf16, #2's one-pass body, and equal bit for bit to #2),
   highest (on the TF32 planes, the body's TF32 mode, and equal bit for
   bit to #3 and to #6 on them written as a ragged pack, a chunk a group)
   and fp64 on a 4-shard pack (pad groups, an empty shard) and on
   a single-shard pack with non-monotone windows, n in {16, 37, 100, 256}
   and at n = 100 a B off 16 bytes (odd n and that B take the plain B
   copies at x3 and default and the 4-byte ones at highest);
11. halo phase — the fused halo kernel (#12: one launch over 4 shards,
   each reading its windows straight from the owner shards' rows) against
   its plain version (the pushes into window buffers, then the windowed
   product) at x3, default, highest and fp64, n in {16, 37, 100, 256} and
   a B off 16 bytes, the chunks past the matrix read as zeros; on fp32 (x3,
   default, highest: the pair, the hi plane, the TF32 planes) also equal
   bit for bit to a second launch and to #4 run shard by shard on those
   buffers;
12. headline at p = 4 — the headline matrix in 4 nnz-balanced row shards
   on the one card through ``RowParaSpmm(kernel="auto")`` at x3, default
   and highest: ``auto`` must resolve to the fused ``pallas_halo`` kernel
   and launch it once per exec, within each point's class (at highest
   equal bit for bit to a second launch and to #4 on each shard's TF32
   planes, its time beside the previous body's); then
   ``kernel="pallas"`` at each point with the all_to_all exchange, and at
   x3 on the ring:
   the unfused path, windowed kernel #4 on every shard (variant
   ``"window"``), with the exchange and SpMM phase times and the received
   and physical rows; each kernel against its plain version at its
   main-path shape, timed, with cuSPARSE on the same work; at default the
   packs must hold the bf16 hi plane alone, and B's cast to bf16 is timed
   beside each kernel; at highest #4 on shard 0 (the wgmma body's TF32
   mode) must equal a second launch and #3's fp32 entry on the same
   arrays bit for bit;
12b. fp64 at p = 4 (``fp64_p4``) — the fp64 headline in 4 row shards,
   the reference's own setting: ``auto`` -> the fused #12's fp64 entry
   once an exec, ``kernel="pallas"`` -> #4's fp64 entry on every shard,
   both on #11's DMMA body, each exec within 1e-12 of the fp64 reference;
   each kernel against its plain version (1e-12) and a second launch (bit
   for bit), timed beside cuSPARSE fp64 and the previous FMA body's time;
   #12's C equal to #4's shard by shard on the plain version's window
   buffers and #4's to #3's fp64 entry on the same arrays, bit for bit;
13. cplaw at p = 4 on the ring (x3): the multi-shard ragged pack with the
   fused spill, 591,732 received B rows and 627,300 physical ring rows;
   on the host, the p = 8 exchange plan's received rows times 32 equal the
   planner's ``comm_cost`` 26,551,360;
14. ``Para2dSpmm`` — on cplaw at n = 256 over 4 ranks the planner must
   pick 1 x 4 with ``rA_cost`` 12,170,731 and no B exchange; then a forced
   2 x 2 grid on the headline at x3 (the fused kernel over the 2 row
   panels of each column group);
15. any-layout path — ``CrpSpmm`` with the reference driver's layouts (B
   in 4 row slabs, C in 4 column slabs), x3: the headline on the v1
   planner's 4 x 1 grid (copy_B_size 59,607,296) with ``auto`` -> the
   fused #12 once an exec; the same from A distributed over 4 row blocks
   (``DistCSR``), its panels and C equal bit for bit; with
   ``a2a_b_finegrain=1`` -> #4 a panel on the exact rows (the "necessary"
   volume, under the coarse one); with ``overlap=1`` -> the ring, #4 as
   each panel's self part on a side stream, two execs equal bit for bit,
   timed beside ``overlap=0, rb_p2p=1``; cplaw on the planner's 1 x 4 ->
   the ragged #7 and the spill #9 a slab (n = 64), no B exchange; each
   with ``exec_device`` and the staged phases rd_B / a2a_B / spmm / rd_C;
   ``Para2dSpmm.from_dist_a`` on the forced 2 x 2 headline plan equal to
   ``Para2dSpmm(a, plan)`` bit for bit; ``RowParaSpmm(bc_layout=1)`` at p
   = 1 (#1), C (n, m) the row-major C transposed bit for bit, the two
   device transposes timed; each kernel against its plain version;
15b. ranks (``multirank_path``) — (b) one rank over NCCL
   (``init_distributed()`` in this process, world size 1) on the headline's
   p = 1 engine at x3: its C equal to the one-device engine's bit for bit;
   a probe, in 2 processes of its own, of what gloo carries for CUDA
   tensors; (a) the headline at p = 4 as 4 spawned processes on the one
   card (``init_distributed(backend="gloo")``: NCCL refuses two ranks on
   one device), ``RowParaSpmm(mesh=make_mesh_1d(4))``: ``auto`` takes #12
   across processes (each rank's B buffer mapped into its peers by CUDA
   IPC) at x3, default and highest, and on the fp64 headline in fp64 (the
   DMMA body with the flags' waits; its C shards equal to ``fp64_p4``'s,
   its withheld exec raising ``HaloTimeout`` with C NaN, as at x3),
   launched once a rank an exec; each
   rank's C shard equal to slice r of the one-device fused engine's C
   bit for bit, its rows within the point's class, the kernel against its
   plain version on the same inputs, each rank's init memory beside the
   one-device pack; (c) the a2a (and the ring, where gloo carries
   send/recv) across the 4 processes, each C shard equal to the one-device
   engine's; (d) in the same processes ``CrpSpmm(mesh=make_mesh_2d(...))``
   as the any-layout path drives it on one device: the headline's 4 x 1
   ``auto`` (#12 across the processes over the column group's
   peer-mapped B blocks, rd_B and rd_C one ``all_to_all_single`` with
   exact splits, which the probe must find gloo carrying), finegrain (#4
   after the all_to_all), cplaw's 1 x 4 (#7 + #9 a rank) and A as a
   ``DistCSR`` of which each rank holds its own block: every rank's user C
   block equal to block r of the any-layout path's one-device engine bit
   for bit, the counters equal, one launch a rank, each headline rank's
   init holding a quarter of the one-device pack; every time there is
   time-shared (four processes on one card) and printed as such;
16. training path — the examples' graph at the cplaw class's rows,
   ``powerlaw_community_csr(786432, 8, 98304, seed=5)`` with self-loops
   (6,331,056 nnz), 8 classes, hidden n = 256: the GCN's two
   ``DifferentiableSpmm`` ops at ``auto`` (``pallas`` without the halo;
   ``highest``) at p = 1 and p = 4, every engine walked to ``gather``, C and
   dB within highest's class of the fp64 product, each engine's kernel
   against its plain version, its order and the fp64 product of shard 0,
   timed, with cuSPARSE; the launches of one training step; the GCN
   trained at p = 4 for 3 steps twice from one seed (losses equal bit for
   bit, falling); the GAT on ``ValueParameterizedSpmm`` at p = 4: dvals
   on 4,096 sampled nonzeros against fp64, the ``segsum`` kind's
   fixed-order sum (as in the fp64 path), and 3 steps twice, bit for bit.

Every kernel's record carries its time, its plain version's, the least
time the card could take for the product it computes (``bound_ms``, from
this run's inputs: the CSR and the B rows it references read once and C
written once, over 3.35 TB/s, or 2 nnz n operations per pass over the
peak of their type, the larger), the same for the dense panels this
design multiplies (``design_bound_ms``), and a PyTorch library call's time
on the same inputs where one computes the same product (cuSPARSE,
``library_ms``).  Each phase ends with its host-clock time (``[time]``
lines).  The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
Without a CUDA device it exits 2 and prints no result.  It imports only
``crp_tpu_torch`` of this repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from crp_tpu_torch.kernels.points import HBM_BYTES_PER_S, PEAK

NROW, NNZ_PER_ROW, BANDWIDTH, SEED = 217918, 53, 2500, 1234  # bench.py:129
CPLAW = dict(n=786432, avg_degree=16, comm_size=1024, seed=1234)  # synth:cplaw:786432:16:1024
DD_BAND = 256  # banded_random_csr(217918, 53, 256): the dd_mxu matrix (r3_tpu_dd.jsonl)
DD_BAND_S = 3402  # its total cover's chunk count at (TM, Wc) = (128, 512)
N = 256
ERR_COLS = 32
PRECS = ("x3", "default", "highest")
# rel_fro_err against the fp64 reference (the JAX records' classes)
TOL_REF = {"x3": 1e-5, "default": 5e-3, "highest": 1e-6}
TOL_DD = 1e-12  # the dd kinds: the reference's own acceptance bar
# kernel against its plain version: the same exact products (bf16 x bf16,
# TF32 x TF32 or fp64 x fp64) summed in another order.  On the small packs the
# elementwise max|k - p| / max|p| is held to TOL_PLAIN; at the main paths'
# shapes the maximum of a reordered fp32 sum reaches ~2e-6 (measured at
# the headline), so there the relative Frobenius error is held to
# TOL_PLAIN_FRO, the bound the CPU tests put between the two packages.
TOL_PLAIN = {np.float32: 1e-6, np.float64: 1e-12}
TOL_PLAIN_FRO = 1e-6
# the ragged kernels on power-law packs: a hub row sums thousands of rounded
# fp32 products, whose reordering moves the largest elements by up to
# 1.2e-6 of max|p| (measured), so there too the relative Frobenius error is
# held, per dtype; the spill and gather kernels too against their plain
# versions, whose index_add_ sums in an order of its own.  Those two sum in
# a fixed order, the same at every launch: each is also held bit for bit
# to the emulation of that order (spill_rows_ordered) and to a second
# launch.
TOL_RAGGED_FRO = {np.float32: 1e-6, np.float64: 1e-12}
# the training path's graphs: the rows of their hubs (and of A^T) are long,
# so index_add_'s order of adds in the plain versions and the old segment
# sum moves their sums by up to 1.5e-6 relative Frobenius from fp64, ten
# times the kernels' 1.1e-7 (measured, H100); there the kernels and the
# fixed-order sums are held bit for bit to their order (the emulation, or
# a second launch) and within highest's class of the fp64 product, and to
# their plain versions or index_add_ within this
TOL_TRAIN_PLAIN_FRO = 4e-6
# the previous bodies on the main paths, ms (NVIDIA H100 80GB HBM3, 700
# W), printed beside the times of this run: #3, #4, #12 and #6 at highest
# on the 3xTF32 mma.sync body (the headline at p = 1, its p = 4 shard 0 and
# all four shards, cplaw's ragged pack; the smoke's runs, #3 and #4 beside
# crp_tpu_torch.cli.f64_ab --point highest's), the spill and gather kernels'
# (a block per output block and 32 columns, shared-memory atomics), #11's
# (64 x 64 blocks of m8n8k4 DMMA, one shared-memory stage) and the fp64
# entries of #3 and #6 on fp64 `auto`'s packs (the FMA tile body that
# panel_tiles.cuh then held; keyed by the fp64 path's matrix), and of #12
# and #4 at the fp64 headline's p = 4 (the same body, crp_tpu_torch.cli.
# f64_ab beside this tree's in one call)
PREVIOUS_MS = {"spmm_spill": 2.0822, "spmm_gather": 7.3080, "spmm_ragged_dd": 4.6211,
               "fp64 banded": 6.0605, "fp64 cplaw": 28.9420, "fp64 headline": 21.7533,
               "fp64 p=4 spmm_halo": 44.5400, "fp64 p=4 spmm_window": 10.8390,
               "headline highest": 10.3785, "headline p=4 highest": 2.6446,
               "headline p=4 fused highest": 10.1958, "cplaw highest": 7.1609}
# the card's peaks (NVIDIA H100 SXM data sheet, dense, at 700 W), HBM_BYTES_PER_S
# and PEAK, are the package's table, which the suite's roofline and the
# projection read too (imported at the top)
# an x3, default or highest TF32-plane init's peak device memory over what
# it holds after it: the panels are densified slab by slab, never whole in
# fp32 beside their bf16 or TF32 planes (device_pack._densify)
INIT_PEAK_OVER_HELD = 1.2
# the ops whose packs hold the TF32 planes at highest: #3's and #4's (their
# stacked (2, G, TM, W) planes), #6's (big and small apart); #12's plan
# holds them too (holds_tf32_planes)
TF32_SCHEMES = ("tf32", "window_tf32")
PANEL_VARIANTS = ("uniform", "ragged", "window", "halo")
CPLAW_P4_RECV, CPLAW_P4_RING_ROWS = 591732, 627300  # r4_cpu_mesh_commvol.jsonl
CPLAW_P8_COMM_N32 = 26551360  # the planner's comm_cost at n = 32, p = 8
CPLAW_2D_RA_COST = 12170731   # the 1 x 4 grid's A replication at n = 256
# the v1 bandwidth planner at p = 4, n = 256 (crp_tpu.plan.bandwidth on the
# same matrices): the headline's 4 x 1 grid and its B-copy cost; cplaw's 1 x 4
ANY_HEADLINE_GRID, ANY_HEADLINE_COPY_B = (4, 1), 59607296
ANY_CPLAW_GRID = (1, 4)
# the reorder path on the scrambled cplaw: bandwidth before and after
# cluster_reorder, the x3 geometry and the cover's (S, spill) there on the
# global columns (the JAX package's values on the CPU, crp_tpu.sparse.
# reorder and estimate_ragged), and the engine's pack's (S, spill) on the
# columns its exchange plan compacts, the exact fill (the JAX engine's on a
# TPU, bench_results/r4_tpu_reorder.jsonl:5; tests/test_torch_reorder.py
# holds the port's pack equal to JAX's on a smaller graph)
REORDER_BANDWIDTH = (786234, 786264)
REORDER_GEOMETRY = (512, 128)
REORDER_COVER = (23256, 2517802)
REORDER_FILL = (23253, 2517698)
# plan_from_csr on the scrambled cplaw at n = 16, p = 4 (JAX's on the CPU):
# (pm, pn, rA_cost, rB_cost) of method="metis" and of "nnz"; the kind and
# variant Para2dSpmm's auto resolves to on the METIS plan (the fused plan
# refuses the panels' windows and the ragged covers keep too little)
METIS_N = 16
METIS_PLAN = (4, 1, 0, 17489488)
NNZ_PLAN = (2, 2, 16227637, 12552464)
METIS_KIND = ("gather", "gather")
# the training path: the examples' graph at the cplaw class's rows and 8
# classes, hidden n = N; steps of each training run; GAT's dvals sample
GNN_NODES, GNN_CLASSES = CPLAW["n"], 8
TRAIN_STEPS = 3
DVALS_SAMPLE = 4096
CSRC = "crp_tpu_torch/kernels/csrc/"
KERNEL_INFO = {  # name -> (source, the TPU kernel it replaces)
    "spmm_window_sg_presplit": ("window_sg.cu", "crp_tpu/kernels/spmm_pallas.py:415"),
    "spmm_window_sg_presplit_ab": ("window_sg.cu", "crp_tpu/kernels/spmm_pallas.py:480"),
    "spmm_window_sg_bf16": ("window_sg.cu", "crp_tpu/kernels/spmm_pallas.py:559"),
    "spmm_window_sg": ("window_sg.cu", "crp_tpu/kernels/spmm_pallas.py:338"),
    "spmm_ragged_presplit": ("ragged.cu", "crp_tpu/kernels/spmm_ragged.py:684"),
    "spmm_ragged_bf16": ("ragged.cu", "crp_tpu/kernels/spmm_ragged.py:727"),
    "spmm_ragged": ("ragged.cu", "crp_tpu/kernels/spmm_ragged.py:633"),
    "spmm_spill": ("spill.cu", "crp_tpu/kernels/spmm_ragged.py:1047"),
    "spmm_gather": ("spill.cu", "crp_tpu/kernels/spmm_ragged.py:1047"),
    "spmm_ragged_dd": ("dd_tc.cu", "crp_tpu/kernels/spmm_dd_mxu.py:163"),
    "spmm_window": ("window.cu", "crp_tpu/kernels/spmm_pallas.py:189"),
    "spmm_halo": ("halo.cu", "crp_tpu/kernels/spmm_halo.py:185"),
}
POINTS = (("x3", np.float32), ("default", np.float32), ("highest", np.float32),
          ("highest", np.float64))


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def say(*args) -> None:
    print(*args, flush=True)


def launch(op, args):
    """One launch of the op's kernel on its ``kernel_args``: the gather
    kernel takes its output rows among them, the panel kernels the rows
    B must have as a keyword."""
    if op.variant == "gather":
        return op.kernel(*args)
    return op.kernel(*args, min_b_rows=op.min_b_rows)


def time_ms(fn, reps: int = 5, inner: int = 20) -> float:
    """Median over ``reps`` runs of ``inner`` back-to-back calls, CUDA
    events around each run; one warm-up call first."""
    from crp_tpu_torch.utils.timers import median_ms

    return median_ms(fn, torch.device("cuda", 0), reps, inner)


def in_turns(run_kernel, run_plain, plain_inner: int = 20, kernel_inner: int = 20):
    """(kernel ms, plain ms, the four samples) timed in turns on one card:
    plain, kernel, kernel, plain; the plain versions over 3 runs, the
    kernels over 5 (the plain versions' times are no yardstick)."""
    p1 = time_ms(run_plain, reps=3, inner=plain_inner)
    k1 = time_ms(run_kernel, inner=kernel_inner)
    k2 = time_ms(run_kernel, inner=kernel_inner)
    p2 = time_ms(run_plain, reps=3, inner=plain_inner)
    return (k1 + k2) / 2, (p1 + p2) / 2, (k1, k2, p1, p2)


def spmm_ref_f64(a, b: np.ndarray) -> np.ndarray:
    """fp64 A @ B in plain numpy from A's CSR arrays, one column at a time
    (``np.bincount`` sums each row's products in fp64)."""
    rows = np.repeat(np.arange(a.nrow), np.diff(a.rowptr))
    val = a.val.astype(np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.stack(
        [np.bincount(rows, weights=val * b[a.colidx, j], minlength=a.nrow)
         for j in range(b.shape[1])],
        axis=1,
    )


def compare(name, run_kernel, run_plain):
    """(max_abs_err, max relative error, relative Frobenius error) of a
    kernel's output against its plain version's on the same CUDA tensors;
    these launches are checks, not the main path's."""
    k = run_kernel()
    p = run_plain()
    torch.cuda.synchronize()
    check(k.shape == p.shape, f"{name}: shape {k.shape} vs {p.shape}")
    check(bool(torch.isfinite(k).all()), f"{name}: non-finite output")
    d = (k - p).double()
    max_abs = float(d.abs().max())
    rel_fro = float(d.norm() / max(float(p.double().norm()), 1e-300))
    return max_abs, max_abs / max(float(p.abs().max()), 1e-300), rel_fro


def flat(args) -> list:
    """Positional args with the x3 pair ``(ah, al)`` taken apart."""
    return [x for a in args for x in (a if isinstance(a, tuple) else (a,))]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in flat(tensors)
               if isinstance(t, torch.Tensor))


def bound(n_bytes: float, ops: float, peak: str) -> tuple:
    """(the least ms the card could take, what bounds it): bytes over the
    HBM rate against operations over the peak of their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def op_point(op, dtype) -> tuple:
    """(passes, peak) of an op's products (``kernels.points.op_point``): x3
    three bf16 products, default one (#2, #4 ``window_bf16``, #8 and #12
    on the bf16 hi plane), highest three TF32 products (#3, #4, #6 and
    #12; #3 and #4 on the wgmma body's TF32 mode), fp64 one pass on the
    FP64 tensor cores (#3, #6, #11) or the FMA units (#4, #12); the gather
    kind's on the FMA units."""
    from crp_tpu_torch.kernels import points

    return points.op_point(op, dtype)


def function_bound(op, work, n, dtype) -> tuple:
    """Bound of the product itself, ``work`` = (nnz, rows, B rows): the CSR
    (an int32 column and a value per nonzero, int32 row pointers) and the
    B rows it references read once, C written once; 2 nnz n operations
    per pass of the op's point."""
    nnz, rows, b_rows = work
    item = 8 if dtype == torch.float64 else 4
    passes, peak = op_point(op, dtype)
    n_bytes = nnz * (4 + item) + (rows + 1) * 4 + (b_rows + rows) * n * item
    return bound(n_bytes, passes * 2.0 * nnz * n, peak)


def holds_tf32_planes(op) -> bool:
    """Whether the op's pack holds the TF32 planes (every fp32 panel pack
    at highest: #3, #4, #6 by scheme, #12's plan by its point and B)."""
    if getattr(op, "variant", None) == "halo":
        return op.precision == "highest" and op.roofline.get("b_itemsize") == 4
    return getattr(op, "scheme", None) in TF32_SCHEMES


def panel_bound(op, arrs, rB) -> tuple:
    """Bound of the dense panels this design multiplies (windowed, ragged,
    dd, halo): its inputs read once (panels, or the TF32 planes at
    highest, indices, B as it takes it) and its C written once; its
    operations are the panels' products with B at the op's point (on the
    planes, one plane's)."""
    args = op.kernel_args(arrs, rB)
    panel = next(t for t in flat(args) if isinstance(t, torch.Tensor) and t.dim() >= 3)
    if op.variant in ("uniform", "window") and holds_tf32_planes(op):  # (2, G, TM, W)
        panel = panel[0]
    n = rB.shape[-1]
    rl = op.roofline
    rows = rl.get("c_rows", rl["G"] * rl["TM"])
    passes, peak = op_point(op, panel.dtype)
    out = 8 if panel.dtype == torch.float64 else 4
    return bound(nbytes(*args) + rows * n * out,
                 passes * 2.0 * panel.numel() * n, peak)


def view_bound(view, b, M, with_c) -> tuple:
    """Bound of the spill / gather kernels on what they read: the
    row-ordered view (each live slot's column and value, the items, the
    hub rows' partial counts) and the distinct B rows its slots reference
    read once, C read (spill) and the output written once; 2 fp32
    operations per live slot and column."""
    vcols, vvals, items, parts = view
    z = int(items[-1, 1])  # the sentinel's first slot: the live slots
    rows_b = int(torch.unique(vcols[:z]).numel())
    n = b.shape[1]
    n_bytes = (z * (vcols.element_size() + vvals.element_size()) + nbytes(items, parts)
               + rows_b * n * b.element_size() + M * n * 4 * (2 if with_c else 1))
    return bound(n_bytes, 2.0 * z * n, "fp32")


def csr_library_ms(rowptr, cols, vals, ncols, b) -> float:
    """cuSPARSE (``torch.sparse_csr_tensor @ B``) on one shard's CSR and
    the B it reads: the library's time for the same product."""
    dev = b.device
    A = torch.sparse_csr_tensor(
        torch.from_numpy(np.asarray(rowptr, np.int64)).to(dev),
        torch.from_numpy(np.asarray(cols, np.int64)).to(dev),
        torch.from_numpy(np.asarray(vals)).to(dev).to(b.dtype),
        size=(len(rowptr) - 1, ncols), device=dev,
    )
    return time_ms(lambda: A @ b)


def kernel_vs_plain(op, arrs, rB):
    args = op.kernel_args(arrs, rB)
    return compare(op.kernel.__name__, lambda: launch(op, args),
                   lambda: op.plain(*args))


def spill_vs_plain(op, arrs, rB):
    args = op.spill_args(arrs, op.plain(*op.kernel_args(arrs, rB)), rB)
    return compare("spmm_spill", lambda: op.spill_kernel(*args),
                   lambda: op.spill_plain(*args))


def in_order(name, run_kernel, run_order, msg) -> None:
    """The spill or gather kernel equal bit for bit to the emulation of its
    fixed sum order and to a second launch (these launches are checks)."""
    k1, k2, e = run_kernel(), run_kernel(), run_order()
    same = lambda x, y: x.shape == y.shape and torch.equal(  # noqa: E731
        x.view(torch.int32), y.view(torch.int32))
    check(same(k1, k2), f"{msg}: {name}: two launches differ")
    check(same(k1, e), f"{msg}: {name} differs from the emulation of its order by "
          f"{float((k1 - e).abs().max()):.3e}")


def spill_in_order(op, arrs, rB, msg) -> None:
    from crp_tpu_torch.kernels.spmm_ragged import spill_rows_ordered

    args = op.spill_args(arrs, op.plain(*op.kernel_args(arrs, rB)), rB)
    in_order("spmm_spill", lambda: op.spill_kernel(*args),
             lambda: spill_rows_ordered(args[0], args[-1], rB, args[0].shape[0],
                                        op.mxu_precision), msg)


def gather_in_order(op, arrs, rB, msg) -> None:
    from crp_tpu_torch.kernels.spmm_ragged import spill_rows_ordered

    args = op.kernel_args(arrs, rB)
    in_order("spmm_gather", lambda: launch(op, args),
             lambda: spill_rows_ordered(None, args[-1], args[5], op.M, op.mxu_precision),
             msg)


def all_kernels():
    from crp_tpu_torch.kernels import spmm_dd_mxu, spmm_halo, spmm_pallas, spmm_ragged

    return (spmm_pallas.KERNELS + spmm_ragged.KERNELS + spmm_dd_mxu.KERNELS
            + spmm_halo.KERNELS)


def padded_b(a, rows, n, dtype):
    from crp_tpu_torch import fill_b

    b = np.zeros((rows, n), dtype)
    b[: a.ncol] = fill_b(0, a.ncol, 0, n, dtype=dtype)
    return b


def kernel_phase(device) -> None:
    from crp_tpu_torch import banded_random_csr
    from crp_tpu_torch.kernels.dispatch import pack_local_kernel

    for prec, dtype in (("x3", np.float32), ("default", np.float32),
                        ("highest", np.float32), ("highest", np.float64)):
        a = banded_random_csr(3000, nnz_per_row=7, bandwidth=80, seed=91,
                              dtype=dtype)
        shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
        # max_m past nrow: the pack carries pad groups past the shard's own
        arrays, op = pack_local_kernel(shard, a.nrow + 300, dtype, "pallas",
                                       device=device, mxu_precision=prec)
        arrs = tuple(x[0] for x in arrays)
        G = arrs[0].shape[0]
        for n in (16, 48, 100, 256):
            rB = torch.from_numpy(padded_b(a, op.min_b_rows, n, dtype)).to(device)
            max_abs, rel, rel_fro = kernel_vs_plain(op, arrs, rB)
            tol = TOL_PLAIN[dtype]
            say(f"kernel {op.kernel.__name__:24s} {prec:8s} "
                f"{np.dtype(dtype).name} G={G} n={n:3d}: max rel err "
                f"{rel:.3e} (tol {tol:g}), max abs err {max_abs:.3e}, "
                f"rel fro err {rel_fro:.3e}")
            check(rel <= tol, f"{op.kernel.__name__} n={n} {prec}: {rel} > {tol}")


class PresplitAbOp:
    """Kernel #5 on an x3 pack, in the form the record helpers take (no
    engine builds one): its arguments are the pack's and ``split_b_bf16``
    of the receive buffer."""

    variant = "uniform"
    scheme = "x3"

    def __init__(self, x3_op):
        from crp_tpu_torch.kernels import spmm_pallas

        self.kernel = spmm_pallas.spmm_window_sg_presplit_ab
        self.plain = spmm_pallas.spmm_window_sg_presplit_ab_plain
        self.min_b_rows = x3_op.min_b_rows
        self.roofline = x3_op.roofline

    def kernel_args(self, arrs, rB) -> tuple:
        from crp_tpu_torch.kernels.spmm_pallas import split_b_bf16

        ws, ah, al = arrs[:3]
        return (ws, ah, al, *split_b_bf16(rB))


def presplit_ab_vs_presplit(op5, arrs, rB) -> float:
    """max |C5 - C1| of #5 on ``split_b_bf16(rB)`` and #1 on ``rB``
    (0 when they agree bit for bit); check launches, not the main path's."""
    from crp_tpu_torch.kernels.spmm_pallas import spmm_window_sg_presplit

    c5 = launch(op5, op5.kernel_args(arrs, rB))
    c1 = spmm_window_sg_presplit(*arrs[:3], rB, min_b_rows=op5.min_b_rows)
    return float((c5 - c1).abs().max())


def one_pass_vs_x3(ws, ah, bh, min_b_rows) -> float:
    """max |C2 - C1| of #2 on (ah, bh) and #1 on (ah, 0, bh as fp32), whose
    B splits to hi = bh and lo = 0: every extra product of #1 is an exact
    zero, so 0 when the tensor cores sum the rest alike; check launches,
    not the main path's."""
    from crp_tpu_torch.kernels.spmm_pallas import (
        spmm_window_sg_bf16, spmm_window_sg_presplit,
    )

    c2 = spmm_window_sg_bf16(ws, ah, bh, min_b_rows=min_b_rows)
    c1 = spmm_window_sg_presplit(ws, ah, torch.zeros_like(ah), bh.float(),
                                 min_b_rows=min_b_rows)
    return float((c2 - c1).abs().max())


def presplit_ab_phase(device) -> None:
    """#5 on the kernel phase's x3 pack (pad groups): within TOL_PLAIN of
    its plain version, #1's C bit for bit, pad rows zero."""
    from crp_tpu_torch import banded_random_csr
    from crp_tpu_torch.kernels.dispatch import pack_local_kernel

    a = banded_random_csr(3000, nnz_per_row=7, bandwidth=80, seed=91, dtype=np.float32)
    arrays, op = pack_local_kernel([(a.rowptr, a.colidx.astype(np.int32), a.val)],
                                   a.nrow + 300, np.float32, "pallas",
                                   device=device, mxu_precision="x3")
    check(op.scheme == "x3", f"presplit-B phase: scheme {op.scheme!r}")
    arrs = tuple(x[0] for x in arrays)
    op5 = PresplitAbOp(op)
    for n in (16, 48, 100, 256):
        rB = torch.from_numpy(padded_b(a, op.min_b_rows, n, np.float32)).to(device)
        _, rel, _ = kernel_vs_plain(op5, arrs, rB)
        diff = presplit_ab_vs_presplit(op5, arrs, rB)
        c = launch(op5, op5.kernel_args(arrs, rB))
        check(not bool(torch.any(c[a.nrow:])), f"spmm_window_sg_presplit_ab n={n}: "
              "pad rows not zero")
        msg = (f"kernel spmm_window_sg_presplit_ab x3 float32 G={arrs[0].shape[0]} "
               f"n={n:3d}: max rel err {rel:.3e} (tol {TOL_PLAIN[np.float32]:g}), "
               f"max |C5 - C1| {diff:.3e} (must be 0)")
        check(rel <= TOL_PLAIN[np.float32] and diff == 0.0, msg)
        say(msg)


def presplit_b_phase(a, op, arrs, rB, device) -> dict:
    """This slice's main path on the headline's x3 pack: the presplit-B
    comparison through ``sweep``, every launch count set to 0 just before
    it and read just after (its checked exec and its timed ones); each
    variant in its class, #5 equal to #1.  Then #5 against its plain
    version at the main path's shape (``rB``), timed in turns, and bit for
    bit against #1 there.  Returns #5's record."""
    from crp_tpu_torch.cli.presplit_b_sweep import sweep

    t0 = time.perf_counter()
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    recs = {r["variant"]: r for r in sweep(a, N, device, pack=(arrs, op))}
    launches = {k.__name__: k.launches for k in kernels}
    say(f"[presplit-B] launches in the sweep: {json.dumps(launches)}")
    for name in ("spmm_window_sg_presplit", "spmm_window_sg_presplit_ab",
                 "spmm_window_sg_bf16"):
        check(launches[name] > 0, f"presplit-B: {name} was not launched")
    for variant, prec in (("presplit_a_x3", "x3"), ("presplit_ab_x3", "x3"),
                          ("bf16_1pass", "default")):
        err = recs[variant]["rel_fro_err"]
        check(err <= TOL_REF[prec], f"presplit-B {variant}: rel_fro_err {err} > "
              f"{TOL_REF[prec]}")
    ab = recs["presplit_ab_x3"]
    check(ab["max_abs_vs_presplit_a"] == 0.0,
          f"presplit-B: #5 differs from #1 by {ab['max_abs_vs_presplit_a']}")
    ms1, ms2 = recs["presplit_a_x3"]["exec_ms"], recs["bf16_1pass"]["exec_ms"]
    say(f"[presplit-B] split_b_bf16 {ab['split_ms']:.4f} ms, #5 "
        f"{ab['exec_ms']:.4f} ms, split + #5 {ab['split_exec_ms']:.4f} ms per exec; "
        f"#1 {ms1:.4f} ms, #2 (1 pass) {ms2:.4f} ms")
    check(ms2 < ms1, f"presplit-B: #2 in one pass ({ms2} ms) is not faster than #1 at "
          f"x3 ({ms1} ms) on the same pack")
    op5 = PresplitAbOp(op)
    got = time_kernel(op5, arrs, rB, "headline presplit-B", "x3", csr_work(a),
                      plain_inner=3)
    diff = presplit_ab_vs_presplit(op5, arrs, rB)
    say(f"[headline presplit-B x3] max |C5 - C1| on the main path's B {diff:.3e}")
    check(diff == 0.0, f"headline: #5 differs from #1 by {diff}")
    say(f"[time] presplit_b_phase: {time.perf_counter() - t0:.1f} s")
    return record("spmm_window_sg_presplit_ab",
                  launches["spmm_window_sg_presplit_ab"], *got)


def multiband(n, seed, dtype):
    """Two diagonal bands half the matrix apart: disjoint chunks per group."""
    from crp_tpu_torch import CSRMatrix

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), 6)
    off = rng.integers(-60, 61, size=(n, 3))
    c1 = np.clip(np.arange(n)[:, None] + off, 0, n - 1)
    c2 = (np.arange(n)[:, None] + n // 2 + off) % n
    cols = np.concatenate([c1, c2], axis=1).ravel()
    return CSRMatrix.from_coo(n, n, rows, cols, rng.standard_normal(len(rows)),
                              dtype=dtype)


def misaligned(x, elems: int = 1):
    """A copy of ``x`` that starts ``elems`` elements past a 16-byte
    boundary (the allocator's blocks start on 512 bytes)."""
    buf = torch.empty(x.numel() + elems, dtype=x.dtype, device=x.device)
    out = buf[elems:].view(x.shape)
    out.copy_(x)
    return out


def ragged_phase(device) -> None:
    from crp_tpu_torch import powerlaw_community_csr
    from crp_tpu_torch.kernels.dispatch import _pack_ragged

    for prec, dtype in (("x3", np.float32), ("default", np.float32),
                        ("highest", np.float32), ("highest", np.float64)):
        mats = {
            "cplaw": powerlaw_community_csr(40000, 16, 1024, seed=91, dtype=dtype),
            "multiband": multiband(6000, 92, dtype),
        }
        for label, a in mats.items():
            shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
            for TM, Wc in ((128, 512), (256, 256), (512, 128)):
                # a break-even that spills, max_m past nrow: pad groups
                arrays, op = _pack_ragged(shard, a.nrow + 700, dtype, prec, device,
                                          geometry=(TM, Wc), min_chunk_nnz=60,
                                          spill_impl="pallas")
                arrs = tuple(x[0] for x in arrays)
                rl = op.roofline
                for n, b_off in ((16, 0), (37, 0), (100, 0), (100, 1), (256, 0)):
                    rB = torch.from_numpy(padded_b(a, op.min_b_rows, n, dtype)).to(device)
                    args = op.kernel_args(arrs, rB)
                    if b_off:  # the kernel's B (bf16 at default) off 16 bytes
                        args = (*args[:-1], misaligned(args[-1], b_off))
                    _, _, rel_fro = compare(op.kernel.__name__, lambda: launch(op, args),
                                            lambda: op.plain(*args))
                    tol = TOL_RAGGED_FRO[dtype]
                    c = launch(op, args)
                    check(not bool(torch.any(c[a.nrow:])),
                          f"{op.kernel.__name__} {label}: pad rows not zero")
                    if op.scheme == "tf32":  # #6 on the TF32 planes: a fixed order
                        check(same_bits(c, launch(op, args)),
                              f"{op.kernel.__name__} {label} highest: two launches differ")
                    msg = (f"ragged {op.kernel.__name__:21s} {prec:8s} "
                           f"{np.dtype(dtype).name} {label:9s} (TM, Wc)=({TM}, {Wc}) "
                           f"S={rl['S']} spill={rl['spill_nnz']} n={n:3d}"
                           f"{' B off 16 bytes' if b_off else ''}: rel fro "
                           f"err {rel_fro:.3e} (tol {tol:g})")
                    check(rel_fro <= tol, msg)
                    if op.spill_impl == "pallas" and not b_off:
                        _, _, s_fro = spill_vs_plain(op, arrs, rB)
                        msg += (f"; spmm_spill rel fro err {s_fro:.3e}, its order bit "
                                f"for bit")
                        check(s_fro <= TOL_RAGGED_FRO[np.float32], msg)
                        spill_in_order(op, arrs, rB, msg)
                    say(msg)


def cusparse_yardstick(a, b, c_ref, device, tag="cusparse") -> float:
    """cuSPARSE on the same matrix (not a port: the baseline the kernels
    are held to); returns its ms per product."""
    from crp_tpu_torch import rel_fro_err

    A = torch.sparse_csr_tensor(
        torch.from_numpy(a.rowptr.astype(np.int64)),
        torch.from_numpy(a.colidx.astype(np.int64)),
        torch.from_numpy(a.val), size=(a.nrow, a.ncol), device=device,
    )
    Bd = torch.from_numpy(b).to(device)
    cus_ms = time_ms(lambda: A @ Bd)
    c = (A @ Bd).cpu().numpy()
    err = rel_fro_err(c_ref, c[:, :ERR_COLS].astype(np.float64))
    say(f"[{tag}] torch.sparse_csr_tensor @ B ({a.val.dtype}): {cus_ms:.4f} "
        f"ms/exec, rel_fro_err {err:.3e}")
    return cus_ms


def measured_init(device, make) -> tuple:
    """(the engine ``make()`` builds, its init's peak device memory and the
    memory it holds after, both over what was held before it)."""
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    eng = make()
    torch.cuda.synchronize(device)
    return (eng, torch.cuda.max_memory_allocated(device) - base,
            torch.cuda.memory_allocated(device) - base)


def check_init_memory(tag, prec, eng, peak, held, extra="") -> None:
    """Print an init's peak device memory, what it holds after and its
    packed arrays' bytes; an x3, default or TF32-plane (every fp32 pack at
    highest) panel pack must peak within INIT_PEAK_OVER_HELD of what it
    holds.  An earlier phase's objects
    collected during the init lower ``held``, never the pack's bytes, so
    the larger of the two is what it holds."""
    keep = max(held, nbytes(*eng.packed), 1)
    say(f"[{tag}] init device memory: peak {peak / 1e9:.3f} GB, held after "
        f"{held / 1e9:.3f} GB, packed {nbytes(*eng.packed) / 1e9:.3f} GB "
        f"({peak / keep:.3f}x){extra}")
    split = prec in ("x3", "default") or holds_tf32_planes(eng._local_op)
    if split and eng._local_op.variant in PANEL_VARIANTS:
        check(peak <= INIT_PEAK_OVER_HELD * keep,
              f"{tag}: init peaks at {peak / 1e9:.3f} GB, over {INIT_PEAK_OVER_HELD} x "
              f"the {keep / 1e9:.3f} GB it holds")


def main_path(eng, b, c_ref, tol, tag, timing=(5, 20), n=N):
    """The engine's main path through the user's entry point: every launch
    count set to 0 just before ``eng.exec(b)`` and read just after; the
    output's shape (``n`` columns), finiteness and error against the fp64
    reference (within ``tol``) checked; then ``exec_device`` timed
    (``timing`` = reps, inner calls).  Returns (launches, err, exec ms, B
    shards)."""
    from crp_tpu_torch import rel_fro_err

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    c = eng.exec(b)
    launches = {k.__name__: k.launches for k in kernels}
    say(f"[{tag}] launches in the main-path exec: {json.dumps(launches)}")
    check(c.shape == (c_ref.shape[0], n) and bool(np.isfinite(c).all()),
          f"{tag}: output shape {c.shape} or non-finite values")
    err = rel_fro_err(c_ref, c[:, :ERR_COLS].astype(np.float64))
    say(f"[{tag}] rel_fro_err vs fp64 reference (first {min(n, ERR_COLS)} columns) = "
        f"{err:.3e} (tol {tol:g})")
    check(err <= tol, f"{tag}: rel_fro_err {err} > {tol}")
    bs = eng.shard_b(b)
    exec_ms = time_ms(lambda: eng.exec_device(bs), *timing)
    say(f"[{tag}] exec_device {exec_ms:.4f} ms/exec")
    return launches, err, exec_ms, bs


def drive(a, b, c_ref, prec, device, tag, expect, kernel="auto",
          dtype=np.float32, tol=None, timing=(5, 20)):
    """One engine at ``prec`` through the user's entry point: resolve to
    ``expect`` = (kind, variant) (any, where None), launch counts in the
    main-path exec (its kernel must launch, where the op has one), error
    against the reference (``tol``, default the point's class), exec time
    (``timing`` = reps, inner calls).  Returns (engine, op, B shards,
    launches, exec ms)."""
    from crp_tpu_torch import RowParaSpmm, SpmmConfig, csr_row_partition

    tol = TOL_REF[prec] if tol is None else tol
    displs = csr_row_partition(a.rowptr, 1)
    config = SpmmConfig(kernel=kernel, mxu_precision=prec)
    eng, peak, held = measured_init(device, lambda: RowParaSpmm(
        a, displs, displs, N, device=device, config=config, dtype=dtype))
    op = eng._local_op
    kernel_fn = getattr(op, "kernel", None)  # the dd kind's non-MXU tier has none
    say(f"[{tag} {prec}] kernel={kernel!r}: kind {eng.kernel_kind}, variant "
        f"{op.variant}, init {eng.t_init:.3f} s, init_breakdown "
        f"{json.dumps(eng.init_breakdown)}, kernel "
        f"{kernel_fn.__name__ if kernel_fn else 'none (plain PyTorch tier)'}, "
        f"roofline {json.dumps(getattr(op, 'roofline', {}))}")
    check(expect is None or (eng.kernel_kind, op.variant) == expect,
          f"{tag} {prec}: resolved to {eng.kernel_kind!r}/{op.variant!r}, "
          f"expected {expect}")
    check_init_memory(f"{tag} {prec}", prec, eng, peak, held)

    launches, _, exec_ms, bs = main_path(eng, b, c_ref, tol, f"{tag} {prec}", timing)
    if kernel_fn is not None:
        check(launches[kernel_fn.__name__] > 0,
              f"{tag} {prec}: {kernel_fn.__name__} was not launched")
    return eng, op, bs, launches, exec_ms


def record(name, launches, max_abs, kernel_ms, plain_ms, bound_ms, bound_by,
           design_bound_ms, library_ms=None, source=None):
    """A kernel's record; ``source`` names the file of an entry that is not
    in its wrapper's usual one (the fp64 entries of #3 and #6)."""
    usual, replaces = KERNEL_INFO[name]
    return dict(name=name, route="cuda", source=CSRC + (source or usual),
                replaces=replaces, launches=launches, max_abs_err=max_abs, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                design_bound_ms=design_bound_ms, library_ms=library_ms)


def csr_work(a) -> tuple:
    """(nnz, rows, distinct B rows referenced) of a CSR matrix or shard."""
    return a.nnz, a.nrow, int(np.unique(a.colidx).size)


def time_kernel(op, arrs, rB, tag, prec, work, plain_inner=20, tol=TOL_PLAIN_FRO):
    """The op's kernel against its plain version at the main path (relative
    Frobenius error within ``tol``), and both timed in turns; ``work`` is
    the product's (nnz, rows, B rows).  Returns (max_abs_err, kernel ms,
    plain ms, bound ms, bound by, design bound ms)."""
    max_abs, rel, rel_fro = kernel_vs_plain(op, arrs, rB)
    name = op.kernel.__name__
    say(f"[{tag} {prec}] {name} vs plain at the main path: rel fro err "
        f"{rel_fro:.3e} (tol {tol:g}), max rel err {rel:.3e}, "
        f"max abs err {max_abs:.3e}")
    check(rel_fro <= tol, f"{tag} {prec}: {name} vs plain rel fro err {rel_fro}")
    args = op.kernel_args(arrs, rB)
    kernel_ms, plain_ms, s = in_turns(lambda: launch(op, args),
                                      lambda: op.plain(*args), plain_inner)
    rl = op.roofline
    if op.variant == "gather":
        desc = (f"{rl['spill_nnz']} nnz, {rl['spill_nnz'] * rB.shape[-1] * 4 / 1e9:.2f} "
                f"GB of gathered B rows")
    else:
        panels = rl.get("p", 1) * rl.get("S", rl["G"]) * rl["TM"] * rl["W"]
        desc = f"dense-panel work {2.0 * panels * rB.shape[-1] / 1e9:.1f} GFLOP/pass"
    if op.variant == "gather":
        design_ms, _ = view_bound(args[-1], rB, op.M, with_c=False)
        dtype = torch.float32
    else:
        design_ms, _ = panel_bound(op, arrs, rB)
        dtype = next(t for t in flat(args)
                     if isinstance(t, torch.Tensor) and t.dim() >= 3).dtype
        dtype = torch.float64 if dtype == torch.float64 else torch.float32
    b_ms, b_by = function_bound(op, work, rB.shape[-1], dtype)
    say(f"[{tag} {prec}] {name} {kernel_ms:.4f} ms ({s[0]:.4f}, {s[1]:.4f}), "
        f"plain {plain_ms:.4f} ms ({s[2]:.4f}, {s[3]:.4f}); {desc}; bound "
        f"{b_ms:.4f} ms ({b_by}; {work[0]} nnz, {work[2]} B rows), design bound "
        f"{design_ms:.4f} ms")
    return max_abs, kernel_ms, plain_ms, b_ms, b_by, design_ms


_CASES = {}
_EXEC_MS = {}  # exec_device ms of a phase's engine that a later phase prints beside its own
_MEASURED = {}  # kernel records measured off a phase's main path, for a later phase's
_RECORDS = []  # every phase's kernel records so far (main() fills it)
# host work a later phase needs, run in one worker process (spawned, so it
# holds no CUDA context) while earlier phases keep the card busy; main()
# closes the pool
_HOST = {"pool": None, "jobs": {}}


def start_host_job(name, fn, *args) -> None:
    """Run ``fn(*args)`` in the worker process; :func:`host_job` takes its
    result."""
    if _HOST["pool"] is None:
        import torch.multiprocessing as mp

        _HOST["pool"] = mp.get_context("spawn").Pool(1)
    _HOST["jobs"][name] = _HOST["pool"].apply_async(fn, args)


def host_job(name, fn, *args):
    """The result of the job ``name`` started earlier, or of ``fn(*args)``
    run here where none was (a phase run alone)."""
    job = _HOST["jobs"].pop(name, None)
    return job.get() if job is not None else fn(*args)


def make_case(name: str, directory=None) -> tuple:
    """(a, c_ref, generation s, set-up s) of a CASES matrix: ``a`` and the
    fp64 reference of the first ERR_COLS columns of its analytic B (fp32
    for the fp32 cases, fp64 for the ``"fp64 ..."`` ones).  ``main`` runs
    every case in the worker process first, with ``directory``: the arrays
    then go to a file there whose path comes back in their place, so that
    the pool's result thread hands the main process a few bytes, not
    hundreds of MB while a phase times the card (:func:`shared_case`
    loads the file)."""
    from crp_tpu_torch import banded_random_csr, fill_b, powerlaw_community_csr

    t0 = time.perf_counter()
    if name == "headline":
        a = banded_random_csr(NROW, nnz_per_row=NNZ_PER_ROW, bandwidth=BANDWIDTH,
                              seed=SEED, dtype=np.float32)
    elif name in ("cplaw", "scrambled"):
        a = powerlaw_community_csr(**CPLAW, permute=name == "scrambled",
                                   dtype=np.float32)
    elif name == "fp64 banded":
        a = banded_random_csr(NROW, nnz_per_row=NNZ_PER_ROW, bandwidth=DD_BAND)
    elif name == "fp64 cplaw":
        a = powerlaw_community_csr(**CPLAW)
    else:  # "fp64 headline"
        a = banded_random_csr(NROW, NNZ_PER_ROW, BANDWIDTH, seed=SEED)
    t_gen = time.perf_counter() - t0
    c_ref = spmm_ref_f64(a, np.asarray(fill_b(0, a.ncol, 0, ERR_COLS, dtype=a.val.dtype)))
    t_setup = time.perf_counter() - t0
    if directory is None:
        return a, c_ref, t_gen, t_setup
    path = directory / (name.replace(" ", "_") + ".npz")
    np.savez(path, shape=(a.nrow, a.ncol), rowptr=a.rowptr, colidx=a.colidx, val=a.val,
             c_ref=c_ref)
    return path, None, t_gen, t_setup


# the matrices the phases share, in the order they are first needed
CASES = ("headline", "cplaw", "scrambled", "fp64 banded", "fp64 cplaw", "fp64 headline")


def shared_case(name: str) -> tuple:
    """(a, b, c_ref, generation s, host set-up s) of the CASES matrix
    ``name`` (``"scrambled"`` is cplaw with its vertex ids permuted), the
    analytic B of N columns in its values' type (B is the
    same function of the indices at any width, so c_ref is its first
    ERR_COLS columns' product): made in the worker process while earlier
    phases run, and shared by every later phase that drives the same
    matrix (the matrix's pack memo is cleared at each hand-out, so no
    phase inherits another's pack)."""
    if name not in _CASES:
        from crp_tpu_torch import fill_b

        from crp_tpu_torch.sparse.csr import CSRMatrix

        a, c_ref, t_gen, t_setup = host_job(f"case {name}", make_case, name)
        if not isinstance(a, CSRMatrix):  # made in the worker: its file
            path = a
            with np.load(path) as f:
                a, c_ref = CSRMatrix(*(int(x) for x in f["shape"]), f["rowptr"],
                                     f["colidx"], f["val"]), f["c_ref"]
            path.unlink()
        b = np.asarray(fill_b(0, a.ncol, 0, N, dtype=a.val.dtype))
        _CASES[name] = (a, b, c_ref, t_gen, t_setup)
    _CASES[name][0].__dict__.pop("_torch_pack_cache", None)
    return _CASES[name]


def headline(device) -> list:
    a, b, c_ref, _, t_setup = shared_case("headline")
    say(f"headline matrix: {a.nrow} rows, {a.nnz} nnz, n={N}, host set-up "
        f"{t_setup:.2f} s in the worker process")
    records = []
    for prec in PRECS:
        eng, op, bs, launches, exec_ms = drive(a, b, c_ref, prec, device, "headline",
                                               ("pallas", "uniform"))
        _EXEC_MS[f"headline {prec}"] = exec_ms
        check(launches["spmm_window_sg_presplit_ab"] == 0,
              f"headline {prec}: the engine launched spmm_window_sg_presplit_ab")
        arrs = tuple(x[0] for x in eng.packed)
        rB = eng.receive_buffer(bs)[0]
        got = time_kernel(op, arrs, rB, "headline", prec, csr_work(a), plain_inner=2)
        records.append(record(op.kernel.__name__, launches[op.kernel.__name__], *got))
        _MEASURED[f"rates {prec}"] = records[-1]
        if prec == "highest":
            say(f"[headline highest] {op.kernel.__name__} on the wgmma body's TF32 mode "
                f"{got[1]:.4f} ms, the previous body (3xTF32 on mma.sync) "
                f"{PREVIOUS_MS['headline highest']:.4f} ms; design bound {got[5]:.4f} ms")
        if prec == "x3":  # what multirank_path's one-rank NCCL engine must equal
            c = eng.exec_device(bs)
            _MEASURED["headline p=1 x3 bits"] = (digest(c), digest(eng.unshard_c(c)))
            del c
            records.append(presplit_b_phase(a, op, arrs, rB, device))
        if prec == "default":
            diff = one_pass_vs_x3(arrs[0], arrs[1], rB.to(torch.bfloat16), op.min_b_rows)
            say(f"[headline default] #2 against #1 on (ah, 0, bh as fp32): max "
                f"|C2 - C1| {diff:.3e} (0: the same sums)")
        del eng, op, bs, arrs, rB
        a.__dict__.pop("_torch_pack_cache", None)
        torch.cuda.empty_cache()
    cus_ms = cusparse_yardstick(a, b, c_ref, device)
    for r in records:
        r["library_ms"] = cus_ms
    return records


def cplaw_path(device) -> list:
    from crp_tpu_torch.kernels import spmm_ragged

    a, b, c_ref, t_gen, t_setup = shared_case("cplaw")
    say(f"cplaw matrix: {a.nrow} rows, {a.nnz} nnz, n={N}, generated in "
        f"{t_gen:.2f} s, host set-up {t_setup:.2f} s in the worker process")
    t0 = time.perf_counter()
    cover = spmm_ragged.ragged_cover(a.rowptr, a.colidx, 512, 128,
                                     spmm_ragged.default_min_chunk_nnz(512, 128))
    t_cover = time.perf_counter() - t0
    t0 = time.perf_counter()
    geometry = spmm_ragged.choose_ragged_geometry(a.rowptr, a.colidx, "x3")
    say(f"[cplaw] host cover at (512, 128): {t_cover:.3f} s, S={len(cover[0])}, "
        f"spill {cover[2]}; geometry chooser (x3): {geometry} in "
        f"{time.perf_counter() - t0:.3f} s")

    records, spill = [], dict(launches=0, max_abs=0.0)
    for prec in PRECS:
        eng, op, bs, launches, exec_ms = drive(a, b, c_ref, prec, device, "cplaw",
                                               ("pallas", "ragged"))
        _EXEC_MS[f"cplaw {prec}"] = exec_ms
        rl = op.roofline
        check(rl["spill_impl"] == "pallas", f"cplaw {prec}: spill_impl {rl['spill_impl']!r}")
        check(launches["spmm_spill"] > 0, f"cplaw {prec}: spmm_spill was not launched")
        if prec == "x3":
            check((rl["TM"], rl["W"]) == (512, 128),
                  f"cplaw x3: (TM, Wc) = ({rl['TM']}, {rl['W']}), expected (512, 128)")
        arrs = tuple(x[0] for x in eng.packed)
        rB = eng.receive_buffer(bs)[0]
        got = time_kernel(op, arrs, rB, "cplaw", prec, csr_work(a), plain_inner=2)
        records.append(record(op.kernel.__name__, launches[op.kernel.__name__], *got))
        if prec == "highest":
            args = op.kernel_args(arrs, rB)
            check(op.scheme == "tf32" and same_bits(launch(op, args), launch(op, args)),
                  f"cplaw highest: scheme {op.scheme!r}, or two launches differ")
            say(f"[cplaw highest] {op.kernel.__name__} on the wgmma body's TF32 mode "
                f"(the ragged walk, the pack's TF32 planes) {got[1]:.4f} ms, the previous "
                f"body (3xTF32 on mma.sync) {PREVIOUS_MS['cplaw highest']:.4f} ms; design "
                f"bound {got[5]:.4f} ms; a second launch equal bit for bit")
            del args
        s_abs, s_rel, s_fro = spill_vs_plain(op, arrs, rB)
        say(f"[cplaw {prec}] spmm_spill vs plain at the main path: rel fro err "
            f"{s_fro:.3e} (tol {TOL_PLAIN_FRO:g}), max rel err {s_rel:.3e}, "
            f"max abs err {s_abs:.3e}")
        check(s_fro <= TOL_PLAIN_FRO, f"cplaw {prec}: spmm_spill vs plain rel fro err {s_fro}")
        spill_in_order(op, arrs, rB, f"cplaw {prec}")
        say(f"[cplaw {prec}] spmm_spill equals the emulation of its order and a second "
            f"launch bit for bit")
        args = op.spill_args(arrs, op.kernel(*op.kernel_args(arrs, rB),
                                             min_b_rows=op.min_b_rows), rB)
        s_ms, s_plain, s = in_turns(lambda: op.spill_kernel(*args),
                                    lambda: op.spill_plain(*args), 3)
        say(f"[cplaw {prec}] spmm_spill {s_ms:.4f} ms ({s[0]:.4f}, {s[1]:.4f}), "
            f"plain {s_plain:.4f} ms ({s[2]:.4f}, {s[3]:.4f}); "
            f"{rl['spill_nnz']} spilled nnz")
        spill["launches"] += launches["spmm_spill"]
        spill["max_abs"] = max(spill["max_abs"], s_abs)
        if prec == "x3":
            spill["ms"], spill["plain_ms"] = s_ms, s_plain
            _MEASURED["rates spill"] = dict(ms=s_ms, spill_nnz=rl["spill_nnz"])
            spill["bound"] = view_bound(args[-1], rB, args[0].shape[0], with_c=True)
            spill["library_ms"] = spill_library_ms(op, arrs, args[0], rB)
            items = args[-1][2]  # the view's (row, first slot, ...) per item
            rows_live = int(torch.unique(items[:-1, 0][items[:-1, 1] < items[1:, 1]])
                            .numel())
            say(f"[cplaw x3] spmm_spill bound {spill['bound'][0]:.4f} ms "
                f"({spill['bound'][1]}); torch.addmm(C, spill CSR, B) "
                f"{spill['library_ms']:.4f} ms; the previous body "
                f"{PREVIOUS_MS['spmm_spill']:.4f} ms; rows with a live slot "
                f"{rows_live} of {args[0].shape[0]} "
                f"({100.0 * rows_live / args[0].shape[0]:.2f}%), "
                f"{args[-1][3].numel()} partials of hub rows")
        del eng, op, bs, arrs, rB, args
        a.__dict__.pop("_torch_pack_cache", None)
        torch.cuda.empty_cache()
    # the spill's bound counts the view of its live nonzeros and their B
    # rows, what its kernel reads: the function's work and this design's
    # are one
    records.append(record("spmm_spill", spill["launches"], spill["max_abs"],
                          spill["ms"], spill["plain_ms"], *spill["bound"],
                          spill["bound"][0], spill["library_ms"]))
    cus_ms = cusparse_yardstick(a, b, c_ref, device)
    for r in records[:-1]:
        r["library_ms"] = cus_ms
    # for comparison, off the main path: the gather kind on this matrix
    from crp_tpu_torch.kernels.dispatch import _pack_gather

    arrays, op = _pack_gather([(a.rowptr, a.colidx.astype(np.int32), a.val)],
                              a.nrow, np.float32, "x3", device)
    args = op.kernel_args(tuple(x[0] for x in arrays),
                          torch.from_numpy(b).to(device))
    say(f"[cplaw x3] for comparison, the gather kind's kernel on this matrix: "
        f"{time_ms(lambda: launch(op, args)):.4f} ms (the ragged kernel and the "
        f"spill: {records[0]['ms'] + spill['ms']:.4f} ms)")
    del arrays, op, args
    torch.cuda.empty_cache()
    return records


def without_column_0(a):
    """``a`` with its column-0 entries dropped, so that a NaN in B row 0
    reaches the product only through a pad slot (whose column is 0)."""
    from crp_tpu_torch import CSRMatrix

    rows = np.repeat(np.arange(a.nrow), np.diff(a.rowptr))
    keep = a.colidx != 0
    return CSRMatrix.from_coo(a.nrow, a.ncol, rows[keep], a.colidx[keep],
                              a.val[keep], dtype=a.val.dtype)


def gather_phase(device) -> None:
    from crp_tpu_torch import powerlaw_community_csr
    from crp_tpu_torch.kernels.dispatch import _pack_gather

    a = without_column_0(powerlaw_community_csr(40000, 16, 1024, seed=91,
                                                permute=True, dtype=np.float32))
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    for prec in PRECS:
        # max_m past nrow: trailing output blocks with no nonzero
        arrays, op = _pack_gather(shard, a.nrow + 700, np.float32, prec, device)
        arrs = tuple(x[0] for x in arrays)
        for n, b_off in ((16, 0), (37, 0), (48, 0), (100, 0), (256, 0), (256, 1), (512, 0)):
            b = padded_b(a, a.ncol, n, np.float32)
            b[0] = np.nan  # pad slots point at column 0: they must be skipped
            rB = torch.from_numpy(b).to(device)
            if b_off:  # B off 16 bytes: the narrower loads
                rB = misaligned(rB, b_off)
            _, _, rel_fro = kernel_vs_plain(op, arrs, rB)
            c = launch(op, op.kernel_args(arrs, rB))
            msg = (f"gather spmm_gather {prec:8s} M={op.M} steps={op.roofline['S']} "
                   f"n={n:3d}{' B off 16 bytes' if b_off else ''}: rel fro err "
                   f"{rel_fro:.3e} (tol {TOL_PLAIN_FRO:g}), its order bit for bit")
            check(rel_fro <= TOL_PLAIN_FRO, msg)
            check(not bool(torch.any(c[a.nrow:])), f"gather {prec}: empty blocks not zero")
            gather_in_order(op, arrs, rB, msg)
            say(msg)


def dd_phase(device) -> None:
    from crp_tpu_torch import banded_random_csr, powerlaw_community_csr
    from crp_tpu_torch.kernels.dispatch import _pack_dd_mxu

    mats = {
        "banded": banded_random_csr(6000, nnz_per_row=9, bandwidth=300, seed=93),
        "cplaw": powerlaw_community_csr(12000, 9, 256, seed=94),
    }
    for label, a in mats.items():
        shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
        # the card's pack has Wc = 512; the CPU's (moved over) Wc = 256
        for pack_device in (device, torch.device("cpu")):
            arrays, op = _pack_dd_mxu(shard, a.nrow + 300, pack_device)
            arrs = tuple(x[0].to(device) for x in arrays)
            rl = op.roofline
            for n in (16, 48, 100, 256):
                rB = torch.from_numpy(padded_b(a, op.min_b_rows, n, np.float64)).to(device)
                _, _, rel_fro = kernel_vs_plain(op, arrs, rB)
                c = launch(op, op.kernel_args(arrs, rB))
                c2 = launch(op, op.kernel_args(arrs, rB))
                msg = (f"dd spmm_ragged_dd {label:7s} (TM, Wc)=({rl['TM']}, {rl['W']}) "
                       f"S={rl['S']} n={n:3d}: rel fro err {rel_fro:.3e} (tol {TOL_DD:g}), "
                       f"a second launch equal bit for bit")
                check(rel_fro <= TOL_DD, msg)
                check(torch.equal(c.view(torch.int64), c2.view(torch.int64)),
                      f"dd {label} n={n}: two launches differ")
                check(not bool(torch.any(c[a.nrow:])), f"dd {label}: pad rows not zero")
                say(msg)


def scrambled_cplaw_path(device) -> list:
    a, b, c_ref, _, t_setup = shared_case("scrambled")
    say(f"scrambled cplaw matrix: {a.nrow} rows, {a.nnz} nnz, n={N}, host set-up "
        f"{t_setup:.2f} s in the worker process")
    start_host_job("reorder", reorder_host, a.rowptr, a.colidx, a.val, b[:, :METIS_N])
    rec = dict(launches=0, max_abs=0.0)
    for prec in PRECS:
        eng, op, bs, launches, exec_ms = drive(a, b, c_ref, prec, device, "scrambled",
                                               ("gather", "gather"))
        arrs = tuple(x[0] for x in eng.packed)
        rB = eng.receive_buffer(bs)[0]
        got = time_kernel(op, arrs, rB, "scrambled", prec, csr_work(a), plain_inner=2)
        gather_in_order(op, arrs, rB, f"scrambled {prec}")
        floor = a.nnz * N * 4 / HBM_BYTES_PER_S * 1e3
        say(f"[scrambled {prec}] spmm_gather equals the emulation of its order and a "
            f"second launch bit for bit; {got[1]:.4f} ms against the previous body's "
            f"{PREVIOUS_MS['spmm_gather']:.4f} (x3); gathered-rows floor {floor:.4f} ms "
            f"(every nonzero's B row from device memory: {a.nnz} x {N} x 4 B over "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s) beside the bound {got[3]:.4f} ms")
        rec["launches"] += launches["spmm_gather"]
        rec["max_abs"] = max(rec["max_abs"], got[0])
        if prec == "x3":
            rec["timing"] = got[1:]
            _EXEC_MS["scrambled x3"] = exec_ms
        del eng, op, bs, arrs, rB
        a.__dict__.pop("_torch_pack_cache", None)
        torch.cuda.empty_cache()
    cus_ms = cusparse_yardstick(a, b, c_ref, device, "scrambled cusparse")
    return [record("spmm_gather", rec["launches"], rec["max_abs"], *rec["timing"],
                   cus_ms)]


def ggp_fixture_digest() -> tuple:
    """(digest, the fixture's) of the native partition of the first case of
    ``tests/fixtures/ggp_oracle.json`` (the symmetrized ``banded:800:6:12``
    in 4 parts), built as ``tests/test_ggp_oracle.py`` builds it."""
    from crp_tpu_torch import CSRMatrix, banded_random_csr, native

    with open("tests/fixtures/ggp_oracle.json") as f:
        case = json.load(f)[0]
    check(case["spec"] == "banded:800:6:12", f"fixture case {case['spec']}")
    a = banded_random_csr(800, nnz_per_row=6, bandwidth=12, seed=60)
    a = CSRMatrix.from_scipy((a.to_scipy() + a.to_scipy().T).tocsr())
    part = native.ggp_partition(a.rowptr, a.colidx, case["nparts"], case["imbalance"])
    check(part is not None, "the native partitioner did not build")
    return native.part_digest(part), case["native"]["sha256"]


def reorder_host(rowptr, colidx, val, bm) -> dict:
    """The host half of :func:`reorder_path` on the scrambled cplaw's
    arrays: ``cluster_reorder``, and ``plan_from_csr(method="metis")`` at
    n = METIS_N, p = 4 on a copy (which it permutes in place) beside the
    nnz plan, each with its host seconds and the backend that ran, and the
    fp64 reference of the permuted copy times ``bm`` (B's first METIS_N
    columns)."""
    from crp_tpu_torch import CSRMatrix, cluster_reorder, plan_from_csr
    from crp_tpu_torch.sparse import reorder

    n = len(rowptr) - 1
    a = CSRMatrix(n, n, rowptr, colidx, val)
    t0 = time.perf_counter()
    ar, perm = cluster_reorder(a)
    t_reorder = time.perf_counter() - t0
    am = CSRMatrix(n, n, rowptr.copy(), colidx.copy(), val.copy())
    t0 = time.perf_counter()
    plan = plan_from_csr(am, METIS_N, 4, method="metis")
    t_metis = time.perf_counter() - t0
    return dict(ar=ar, perm=perm, t_reorder=t_reorder, am=am, plan=plan, t_metis=t_metis,
                backend=reorder.partition_backend(), nplan=plan_from_csr(a, METIS_N, 4),
                cm_ref=spmm_ref_f64(am, bm))


def reorder_path(device) -> list:
    """(a) ``cluster_reorder`` on the scrambled cplaw and the reordered
    problem C' = A' B[perm] through ``RowParaSpmm(kernel="auto")`` at x3
    (the ragged kind: #7 and #9); (b) ``plan_from_csr(method="metis")`` at
    n = 16, p = 4 beside the nnz plan, and ``Para2dSpmm`` on the METIS
    plan (x3, ``auto``)."""
    from crp_tpu_torch import Para2dSpmm, SpmmConfig
    from crp_tpu_torch.comm.exchange import exchange_b, exchange_b_ring
    from crp_tpu_torch.kernels import spmm_ragged
    from crp_tpu_torch.kernels.dispatch import _pack_gather

    a, b, c_ref = shared_case("scrambled")[:3]
    records = []
    host = host_job("reorder", reorder_host, a.rowptr, a.colidx, a.val, b[:, :METIS_N])

    # (a) the reordering (in the worker process, beside the scrambled phase)
    ar, perm = host["ar"], host["perm"]
    bw = (a.bandwidth(), ar.bandwidth())
    S, est, _ = spmm_ragged.estimate_ragged(ar.rowptr, ar.colidx, *REORDER_GEOMETRY)
    say(f"[reorder] cluster_reorder: {host['t_reorder']:.2f} s on the host, backend "
        f"{ar.backend}, bandwidth {bw[0]} -> {bw[1]}; cover at {REORDER_GEOMETRY}: "
        f"S={S}, spill {est} ({100.0 * est / ar.nnz:.2f}% of {ar.nnz} nnz)")
    check(ar.backend == "native", f"reorder: backend {ar.backend}, not the native GGGP")
    check(bw == REORDER_BANDWIDTH and (S, est) == REORDER_COVER,
          f"reorder: bandwidth {bw}, cover {(S, est)}; expected {REORDER_BANDWIDTH}, "
          f"{REORDER_COVER}")
    bp = np.ascontiguousarray(b[perm])
    cp_ref = c_ref[perm]
    eng, op, bs, launches, exec_ms = drive(ar, bp, cp_ref, "x3", device, "reorder",
                                           ("pallas", "ragged"))
    rl = op.roofline
    say(f"[reorder x3] exec_device {exec_ms:.4f} ms on the reordered graph (ragged: #7 "
        f"and #9) against {_EXEC_MS.get('scrambled x3', 'not measured')} ms on the "
        f"scrambled one (gather, #10) in this run; spill {rl['spill_nnz']} nnz, "
        f"S={rl['S']}")
    check(rl["spill_impl"] == "pallas" and (rl["TM"], rl["W"]) == REORDER_GEOMETRY
          and (rl["S"], rl["spill_nnz"]) == REORDER_FILL
          and launches["spmm_spill"] == 1 and launches[op.kernel.__name__] == 1,
          f"reorder x3: {json.dumps(rl)}, launches {launches}; expected (S, spill) "
          f"{REORDER_FILL}")
    arrs = tuple(x[0] for x in eng.packed)
    rB = eng.receive_buffer(bs)[0]
    got = time_kernel(op, arrs, rB, "reorder", "x3", csr_work(ar), plain_inner=2)
    cus_ms = cusparse_yardstick(ar, bp, cp_ref, device, "reorder cusparse")
    records.append(dict(record(op.kernel.__name__, launches[op.kernel.__name__], *got,
                               cus_ms), path="reorder"))
    s_abs, s_rel, s_fro = spill_vs_plain(op, arrs, rB)
    check(s_fro <= TOL_PLAIN_FRO, f"reorder: spmm_spill vs plain rel fro err {s_fro}")
    spill_in_order(op, arrs, rB, "reorder x3")
    args = op.spill_args(arrs, op.kernel(*op.kernel_args(arrs, rB),
                                         min_b_rows=op.min_b_rows), rB)
    s_ms, s_plain, s = in_turns(lambda: op.spill_kernel(*args),
                                lambda: op.spill_plain(*args), 3)
    s_bound = view_bound(args[-1], rB, args[0].shape[0], with_c=True)
    s_lib = spill_library_ms(op, arrs, args[0], rB)
    say(f"[reorder x3] spmm_spill vs plain: rel fro err {s_fro:.3e} (tol "
        f"{TOL_PLAIN_FRO:g}), max rel err {s_rel:.3e}; equal to the emulation of its "
        f"order and a second launch bit for bit; {s_ms:.4f} ms ({s[0]:.4f}, "
        f"{s[1]:.4f}), plain {s_plain:.4f} ms; bound {s_bound[0]:.4f} ms "
        f"({s_bound[1]}); torch.addmm(C, spill CSR, B) {s_lib}")
    records.append(dict(record("spmm_spill", launches["spmm_spill"], s_abs, s_ms, s_plain,
                               *s_bound, s_bound[0], s_lib), path="reorder"))
    del eng, op, bs, arrs, rB, args
    ar.__dict__.pop("_torch_pack_cache", None)
    torch.cuda.empty_cache()
    # for comparison, off the main path: the gather kind on A'
    arrays, gop = _pack_gather([(ar.rowptr, ar.colidx.astype(np.int32), ar.val)], ar.nrow,
                               np.float32, "x3", device)
    gargs = gop.kernel_args(tuple(x[0] for x in arrays), torch.from_numpy(bp).to(device))
    say(f"[reorder x3] for comparison, the gather kind's kernel on A': "
        f"{time_ms(lambda: launch(gop, gargs)):.4f} ms (the ragged kernel and the spill: "
        f"{got[1] + s_ms:.4f} ms)")
    del arrays, gop, gargs
    torch.cuda.empty_cache()

    # (b) METIS: the planner's 1D partition on a copy (plan_from_csr
    # permutes it in place), beside the nnz-balanced plan
    digest, want = ggp_fixture_digest()
    say(f"[metis] native GGGP on the fixture's banded:800:6:12, 4 parts: sha256 "
        f"{digest} (fixture {want})")
    check(digest == want, "metis: the card's native GGGP differs from the fixture")
    am, plan, nplan, backend = host["am"], host["plan"], host["nplan"], host["backend"]
    say(f"[metis] plan_from_csr(method='metis') at n={METIS_N}, p=4: "
        f"{host['t_metis']:.2f} s on the host, backend {backend}, {plan.pm} x {plan.pn}, "
        f"rA_cost {plan.rA_cost}, "
        f"rB_cost {plan.rB_cost} (rows {plan.rB_comm_rows.tolist()}); method='nnz': "
        f"{nplan.pm} x {nplan.pn}, rA_cost {nplan.rA_cost}, rB_cost {nplan.rB_cost}, "
        f"{nplan.rA_cost + nplan.rB_cost} elements in all")
    check(backend == "native", f"metis: backend {backend}, not the native GGGP")
    check((plan.pm, plan.pn, plan.rA_cost, plan.rB_cost) == METIS_PLAN
          and (nplan.pm, nplan.pn, nplan.rA_cost, nplan.rB_cost) == NNZ_PLAN,
          f"metis: plans {(plan.pm, plan.pn, plan.rA_cost, plan.rB_cost)} / "
          f"{(nplan.pm, nplan.pn, nplan.rA_cost, nplan.rB_cost)}, expected {METIS_PLAN} / "
          f"{NNZ_PLAN}")
    bm, cm_ref = np.ascontiguousarray(b[:, :METIS_N]), host["cm_ref"]
    eng, peak, held = measured_init(device, lambda: Para2dSpmm(
        am, plan, device=device, dtype=np.float32,
        config=SpmmConfig(kernel="auto", mxu_precision="x3")))
    op = eng._local_op
    say(f"[metis para2d] {plan.pm} x {plan.pn}: kind {eng.kernel_kind}, variant "
        f"{op.variant}, init {eng.t_init:.3f} s, init_breakdown "
        f"{json.dumps(eng.init_breakdown)}")
    check((eng.kernel_kind, op.variant) == METIS_KIND,
          f"metis para2d: {eng.kernel_kind}/{op.variant}, expected {METIS_KIND}")
    check_init_memory("metis para2d", "x3", eng, peak, held)
    launches, _, exec_ms, bs = main_path(eng, bm, cm_ref, TOL_REF["x3"], "metis para2d",
                                         (3, 5), n=METIS_N)
    head = eng.print_stat().splitlines()[:3]
    say(f"[metis para2d] exec_device {exec_ms:.4f} ms; exchanged B rows "
        f"{eng.rB_recv_size} ({eng.rB_recv_size * METIS_N} elements, "
        f"{eng.rB_recv_size * METIS_N * 4 / 1e6:.1f} MB), rA_cost {eng.rA_cost}; "
        f"{' | '.join(head)}")
    check(eng.rB_recv_size * METIS_N == plan.rB_cost and eng.rA_cost == plan.rA_cost
          and launches[op.kernel.__name__] == plan.pm,
          f"metis para2d: rB {eng.rB_recv_size * METIS_N}, rA {eng.rA_cost}, launches "
          f"{launches}; the plan's {plan.rB_cost}, {plan.rA_cost}, {plan.pm} launches")
    xch = exchange_b_ring if eng.config.rb_p2p else exchange_b
    rB = xch(bs[:, 0], eng.xtables)[0]
    rec = engine_record(eng, am, rB, "metis para2d", "reorder", tol=TOL_PLAIN_FRO,
                        prec="x3")
    rec["launches"] = launches[op.kernel.__name__]
    records.append(rec)
    del eng, op, bs, rB, am, host
    torch.cuda.empty_cache()
    return records


def fp64_auto(a, b, c_ref, device, tag, expect) -> dict:
    """``RowParaSpmm(kernel="auto")`` in fp64 on one of the fp64 path's
    matrices, within 1e-12: the port sends fp64 ``auto`` to the panel
    kernels' fp64 entries (#3 on a uniform pack, #6 on a ragged one, both
    on the FP64 tensor cores) where the JAX package sends it to ``dd``;
    ``expect`` the (kind, variant) it must resolve to.  Its kernel against
    its plain version at the main path and a second launch (bit for bit),
    timed.  Returns its kind, kernel, exec_device ms, launches, and
    ``timed``: :func:`time_kernel`'s numbers."""
    eng, op, bs, launches, exec_ms = drive(a, b, c_ref, "highest", device, f"{tag} auto",
                                           expect, dtype=np.float64, tol=TOL_DD,
                                           timing=(3, 5))
    name = op.kernel.__name__
    got = dict(kind=f"{eng.kernel_kind}/{op.variant}", kernel=name, exec_ms=exec_ms,
               launches=launches[name])
    arrs = tuple(x[0] for x in eng.packed)
    rB = eng.receive_buffer(bs)[0]
    got["timed"] = time_kernel(op, arrs, rB, f"{tag} auto", "highest", csr_work(a),
                               plain_inner=2, tol=TOL_DD)
    args = op.kernel_args(arrs, rB)
    c1, c2 = launch(op, args), launch(op, args)
    check(torch.equal(c1.view(torch.int64), c2.view(torch.int64)),
          f"{tag} auto: {name}: two launches differ")
    say(f"[{tag} auto] {name} (FP64 tensor cores) {got['timed'][1]:.4f} ms, the previous "
        f"body (fp64 FMA) {PREVIOUS_MS[tag]:.4f} ms; a second launch equal bit for bit")
    del c1, c2, args
    if getattr(op, "spill_impl", None) == "segsum":  # C2: its spill's order
        fixed_order(f"{tag} auto segsum spill", *op._spill_arrays(arrs), rB,
                    op.roofline["G"] * op.roofline["TM"], chunked=True)
    del arrs, rB, eng, op, bs
    a.__dict__.pop("_torch_pack_cache", None)
    torch.cuda.empty_cache()
    return got


def fp64_path(device) -> list:
    from crp_tpu_torch.kernels.spmm_ragged import spmm_ragged

    a, b, c_ref, _, t_setup = shared_case("fp64 banded")
    say(f"fp64 banded matrix: {a.nrow} rows, {a.nnz} nnz, n={N}, host set-up "
        f"{t_setup:.2f} s in the worker process")
    eng, op, bs, launches, exec_ms = drive(a, b, c_ref, "highest", device, "fp64 banded",
                                           ("dd", "dd_mxu"), kernel="dd",
                                           dtype=np.float64, tol=TOL_DD)
    check(op.roofline["S"] == DD_BAND_S,
          f"fp64 banded: S = {op.roofline['S']}, expected {DD_BAND_S}")
    arrs = tuple(x[0] for x in eng.packed)
    rB = eng.receive_buffer(bs)[0]
    got = time_kernel(op, arrs, rB, "fp64 banded", "dd", csr_work(a), plain_inner=3,
                      tol=TOL_DD)
    # #6's fp64 entry on the same arrays (the pack has no spill): the same
    # DMMA body with the same walk, so the same bits (one instantiation: its
    # time is #11's)
    args = op.kernel_args(arrs, rB)
    c11, c6 = launch(op, args), spmm_ragged(*args, min_b_rows=op.min_b_rows)
    check(torch.equal(c11.view(torch.int64), c6.view(torch.int64)),
          "fp64 banded: spmm_ragged (fp64) differs from spmm_ragged_dd on the dd_mxu pack")
    del c11, c6
    gflop = 2.0 * op.roofline["S"] * op.roofline["TM"] * op.roofline["W"] * N / 1e9
    say(f"[fp64 banded] on one pack: spmm_ragged_dd {got[1]:.4f} ms (the previous body "
        f"{PREVIOUS_MS['spmm_ragged_dd']:.4f}), spmm_ragged fp64 equal to it bit for bit "
        f"(one DMMA body on the FP64 tensor cores); {gflop:.1f} GFLOP, "
        f"{gflop / got[1]:.2f} TFLOP/s")
    records = [record("spmm_ragged_dd", launches["spmm_ragged_dd"], *got)]
    del eng, op, bs, arrs, rB, args
    a.__dict__.pop("_torch_pack_cache", None)
    torch.cuda.empty_cache()
    records[0]["library_ms"] = cusparse_yardstick(a, b, c_ref, device,
                                                  "fp64 banded cusparse")
    dd = {"fp64 banded": ("dd_mxu", exec_ms, got[1], records[0]["library_ms"])}
    auto = {"fp64 banded": fp64_auto(a, b, c_ref, device, "fp64 banded",
                                     ("pallas", "uniform"))}

    # the dd kind's other tiers: the dd_mxu cover refuses both matrices
    for tag, tier in (("fp64 cplaw", "segsum"), ("fp64 headline", "ell")):
        a, b, c_ref, _, t_setup = shared_case(tag)
        say(f"{tag} matrix: {a.nrow} rows, {a.nnz} nnz, host set-up {t_setup:.2f} s in "
            f"the worker process")
        eng, op, bs, _, exec_ms = drive(a, b, c_ref, "highest", device, tag, ("dd", tier),
                                        kernel="dd", dtype=np.float64, tol=TOL_DD,
                                        timing=(3, 2))
        if tier == "segsum":  # C2: the tier's order
            fixed_order(f"{tag} dd segment-sum tier", *(x[0] for x in eng.packed),
                        eng.receive_buffer(bs)[0], op.nrow, chunked=True)
        del eng, op, bs
        a.__dict__.pop("_torch_pack_cache", None)
        torch.cuda.empty_cache()
        dd[tag] = (tier, exec_ms, None,
                   cusparse_yardstick(a, b, c_ref, device, f"{tag} cusparse"))
        _MEASURED[f"{tag} cusparse"] = dd[tag][3]  # fp64_p4 prints it beside its kernels
        auto[tag] = fp64_auto(a, b, c_ref, device, tag, ("pallas", "ragged"))
    for tag, got_auto in auto.items():
        tier, exec_ms, kernel_ms, cus_ms = dd[tag]
        k_auto = got_auto["timed"][1]
        # #3 and #6 on fp64: their records on fp64 auto's main path
        records.append(dict(record(got_auto["kernel"], got_auto["launches"],
                                   *got_auto["timed"], library_ms=cus_ms,
                                   source="dd_tc.cu"), path=f"{tag} auto"))
        say(f"[fp64 auto vs dd] {tag}: auto -> {got_auto['kind']} "
            f"({got_auto['kernel']}) exec_device {got_auto['exec_ms']:.4f} ms, kernel "
            f"{k_auto:.4f} ms (the previous body, fp64 FMA: {PREVIOUS_MS[tag]:.4f})"
            + f"; dd -> {tier} exec_device {exec_ms:.4f} ms"
            + (f", kernel {kernel_ms:.4f} ms" if kernel_ms is not None else "")
            + f"; cuSPARSE fp64 {cus_ms:.4f} ms; the faster: "
            + ("auto" if got_auto["exec_ms"] < exec_ms else "dd"))
    for tag in ("fp64 banded", "fp64 cplaw"):  # no later phase drives these
        _CASES.pop(tag)
    return records


def spill_library_ms(op, arrs, c, rB):
    """``torch.addmm(C, S, B)`` with S the spilled nonzeros as a CSR
    tensor: the library's time for the spill kernel's function, or None
    where this PyTorch has no such call for a CSR operand on the card."""
    rel, cols, vals, blk, TMo = op.spill_args(arrs, c, rB)[1:6]
    M = c.shape[0]
    rel2 = rel.reshape(cols.shape)
    live = rel2 < TMo
    rows = (blk.long()[:, None] * TMo + rel2.long())[live]
    S = torch.sparse_coo_tensor(torch.stack([rows, cols.long()[live]]),
                                vals[live], size=(M, rB.shape[0])).coalesce()
    S = S.to_sparse_csr()
    try:
        return time_ms(lambda: torch.addmm(c, S, rB))
    except RuntimeError as e:  # a yardstick, not the port's path
        say(f"[cplaw x3] torch.addmm with a CSR operand: {e}")
        return None


def window_phase(device) -> None:
    """Kernel #4 against its plain version on a 4-shard pack (an empty
    shard, pad groups) and a single shard with non-monotone windows, odd n
    and a B off 16 bytes; at x3 its C equal bit for bit to #1's on the same
    pair and receive buffer, at default to #2's on the same hi plane and
    bf16 B, at highest on fp32 to #3's on the same TF32 planes (the same
    body) and to #6's on them written as a ragged pack, a chunk a group
    (the walk changes nothing)."""
    from crp_tpu_torch import CSRMatrix, banded_random_csr, csr_row_partition
    from crp_tpu_torch.kernels.dispatch import _pack_window
    from crp_tpu_torch.kernels.spmm_pallas import (
        spmm_window_sg, spmm_window_sg_bf16, spmm_window_sg_presplit,
    )
    from crp_tpu_torch.kernels.spmm_ragged import spmm_ragged

    for prec, dtype in (("x3", np.float32), ("default", np.float32),
                        ("highest", np.float32), ("highest", np.float64)):
        band = banded_random_csr(6000, nnz_per_row=7, bandwidth=80, seed=95, dtype=dtype)
        d = csr_row_partition(band.rowptr, 4)
        multi = []
        for i in range(4):
            sh = band.row_slice(int(d[i]), int(d[i + 1]))
            multi.append((sh.rowptr, sh.colidx.astype(np.int32), sh.val) if i != 2
                         else (np.zeros(sh.nrow + 1, np.int64), np.zeros(0, np.int32),
                               np.zeros(0, dtype)))
        rng = np.random.default_rng(96)
        rows = np.repeat(np.arange(3000), 5)
        cols = np.clip(2999 - rows + rng.integers(-30, 31, rows.size), 0, 2999)
        key = np.unique(rows * 3000 + cols)
        anti = CSRMatrix.from_coo(3000, 3000, key // 3000, key % 3000,
                                  rng.standard_normal(key.size), dtype=dtype)
        for label, shards, a, max_m in (
            ("4 shards", multi, band, int(np.diff(d).max())),
            ("non-monotone", [(anti.rowptr, anti.colidx.astype(np.int32), anti.val)],
             anti, anti.nrow),
        ):
            arrays, op = _pack_window(shards, max_m + 300, dtype, prec, device)
            check(op.variant == "window", f"window phase {label}: variant {op.variant}")
            x3 = prec == "x3" and dtype == np.float32
            one = prec == "default" and dtype == np.float32
            tf = prec == "highest" and dtype == np.float32  # the TF32 planes
            want = (torch.bfloat16 if x3 or one else
                    torch.float64 if dtype == np.float64 else torch.float32)
            scheme = ("window_x3" if x3 else "window_bf16" if one else
                      "window_tf32" if tf else "window")
            # #4's C is #1's at x3, #2's at default, #3's at highest on fp32
            ref = "1" if x3 else "2" if one else "3"
            check(op.scheme == scheme and arrays[1].dtype == want
                  and len(arrays) == (3 if x3 else 2) and arrays[1].dim() == (5 if tf else 4),
                  f"window phase {label} {prec}: scheme {op.scheme}, panels "
                  f"{[tuple(t.shape) for t in arrays[1:]]} {arrays[1].dtype}")
            G = arrays[0].shape[1]
            for n, b_off in ((16, 0), (37, 0), (100, 0), (100, 1), (256, 0)):
                rB = torch.from_numpy(padded_b(a, op.min_b_rows, n, dtype)).to(device)
                worst, same = 0.0, 0.0
                for i, sh in enumerate(shards):
                    arrs = tuple(x[i] for x in arrays)
                    args = op.kernel_args(arrs, rB)
                    if b_off:  # the kernel's B (bf16 at default) off 16 bytes
                        args = (*args[:2], misaligned(args[2], b_off), *args[3:])
                    _, rel, _ = compare("spmm_window", lambda: launch(op, args),
                                        lambda: op.plain(*args))
                    c = launch(op, args)
                    nrow = len(sh[0]) - 1 if len(sh[1]) else 0
                    check(not bool(torch.any(c[nrow:])),
                          f"window {label} shard {i}: pad rows not zero")
                    worst = max(worst, rel)
                    if x3 or one or tf:  # #1 on the same pair, #2 on the same plane, #3
                        same_as = (spmm_window_sg_presplit if x3 else
                                   spmm_window_sg_bf16 if one else spmm_window_sg)
                        c1 = same_as(*arrs, args[2], min_b_rows=op.min_b_rows)
                        same = max(same, float((c1 - c).abs().max()))
                        check(torch.equal(c1.view(torch.int32), c.view(torch.int32)),
                              f"window {label} {prec} shard {i} n={n}: #4 differs from "
                              f"#{ref} by {same}")
                    if tf:  # #6 on the same planes written as a ragged pack, a chunk a group
                        ws, planes = arrs
                        walk = torch.arange(G + 1, dtype=torch.int32, device=device)
                        c6 = spmm_ragged(walk[:-1], walk, ws, (planes[0], planes[1]),
                                         args[2], min_b_rows=op.min_b_rows)
                        check(same_bits(c6, c), f"window {label} highest shard {i} n={n}: "
                              f"#6 on a chunk a group differs from #4 by "
                              f"{float((c6 - c).abs().max())}")
                tol = TOL_PLAIN[dtype]
                msg = (f"window spmm_window {prec:8s} {np.dtype(dtype).name} "
                       f"{label:12s} p={len(shards)} G={G} n={n:3d}"
                       f"{' B off 16 bytes' if b_off else ''}: max rel err "
                       f"{worst:.3e} (tol {tol:g})"
                       + (f", max |C4 - C{ref}| {same:.3e} (must be 0)"
                          if x3 or one or tf else "")
                       + (", #6 on a chunk a group equal bit for bit" if tf else ""))
                check(worst <= tol, msg)
                say(msg)


def stacked_b(b, displs, rows):
    """Global B in row blocks ``displs``, each padded to ``rows``:
    (p, rows, n)."""
    p = len(displs) - 1
    out = np.zeros((p, rows, b.shape[1]), b.dtype)
    for i in range(p):
        out[i, : displs[i + 1] - displs[i]] = b[displs[i]:displs[i + 1]]
    return out


def halo_phase(device) -> None:
    """The fused halo kernel (#12) against its plain version over 4 shards
    in one launch at every point, odd n and a B off 16 bytes; rows past
    each shard's own zero (the chunks past the matrix read as zeros); on
    fp32 (x3, default, highest) its C equal bit for bit to a second launch
    and to #4 run shard by shard on the same pair, plane or TF32 planes
    with the plain version's window buffers."""
    from crp_tpu_torch import banded_random_csr, csr_row_partition
    from crp_tpu_torch.kernels.spmm_halo import align_displs, build_halo_plan

    for prec, dtype in POINTS:
        a = banded_random_csr(6000, nnz_per_row=7, bandwidth=300, seed=97, dtype=dtype)
        d = csr_row_partition(a.rowptr, 4)
        aligned = align_displs(d, a.ncol)
        shards = [a.row_slice(int(d[i]), int(d[i + 1])) for i in range(4)]
        arrays, op = build_halo_plan(shards, aligned, device=device, dtype=dtype,
                                     precision=prec)
        x3 = prec == "x3" and dtype == np.float32
        one = prec == "default" and dtype == np.float32
        tf = prec == "highest" and dtype == np.float32  # the TF32 planes
        panels = arrays[2:-2]
        check(len(panels) == (2 if x3 or tf else 1) and panels[0].dtype == (
            torch.bfloat16 if x3 or one else torch.float64 if dtype == np.float64
            else torch.float32), f"halo {prec}: the plan holds {[t.dtype for t in panels]}")
        dead = int((arrays[-1] < 0).sum())
        for n, b_off in ((16, 0), (37, 0), (100, 0), (100, 1), (256, 0)):
            bs = stacked_b(padded_b(a, a.ncol, n, dtype), aligned, op.min_b_rows)
            args = op.kernel_args(arrays, torch.from_numpy(bs).to(device))
            if b_off:  # the kernel's B (bf16 at default) off 16 bytes
                args = (*args[:5], misaligned(args[5], b_off), *args[6:])
            _, rel, _ = compare("spmm_halo", lambda: launch(op, args),
                                lambda: op.plain(*args))
            c = launch(op, args)
            for i in range(4):
                check(not bool(torch.any(c[i, d[i + 1] - d[i]:])),
                      f"halo {prec} shard {i}: pad rows not zero")
            if x3 or one or tf:  # a second launch, #4 per shard on the window buffers
                halo_vs_window(op, args, f"halo {prec} n={n}")
            tol = TOL_PLAIN[dtype]
            msg = (f"halo spmm_halo {prec:8s} {np.dtype(dtype).name} p=4 G={op.G} "
                   f"W={op.W} n={n:3d}{' B off 16 bytes' if b_off else ''}, {dead} "
                   f"chunks past the matrix: max rel err {rel:.3e} (tol {tol:g})"
                   + (", C equal to a second launch's and to #4's per shard"
                      if x3 or one or tf else ""))
            check(rel <= tol, msg)
            say(msg)


def timed_phases(eng, bs, reps=5):
    """Median ms of the exchange and the local ops over ``reps`` fenced
    execs (``exec_timed``)."""
    eng.clear_stat()
    for _ in range(reps + 1):
        eng.exec_timed(bs)
    return {k: 1e3 * float(np.median(eng.timer.samples[k][1:]))
            for k in ("a2a", "spmm", "exec") if k in eng.timer.samples}


def drive_p(a, b, c_ref, p, prec, device, tag, expect, rb_p2p, kernel="auto",
            dtype=np.float32, tol=None):
    """``RowParaSpmm`` over p nnz-balanced row shards on the one card: the
    resolved kind and variant, the local kernel's launches in the main
    path's exec (one per shard; the fused kernel once), the error against
    the reference (``tol``, default the point's class), exec and phase
    times, the exchange's rows."""
    from crp_tpu_torch import RowParaSpmm, SpmmConfig, csr_row_partition

    d = csr_row_partition(a.rowptr, p)
    eng, peak, held = measured_init(device, lambda: RowParaSpmm(
        a, d, d, N, device=device, dtype=dtype,
        config=SpmmConfig(kernel=kernel, mxu_precision=prec, rb_p2p=rb_p2p)))
    op = eng._local_op
    mode = "fused" if eng.is_halo else "ring" if rb_p2p else "a2a"
    tag = f"{tag} {prec} {mode}"
    panels = [x for x in eng.packed if x.dim() >= 3]
    say(f"[{tag}] p={p} kernel={kernel!r}: kind {eng.kernel_kind}, variant "
        f"{op.variant}, init {eng.t_init:.3f} s, init_breakdown "
        f"{json.dumps(eng.init_breakdown)}, roofline {json.dumps(op.roofline)}")
    check((eng.kernel_kind, op.variant) == expect,
          f"{tag}: resolved to {eng.kernel_kind!r}/{op.variant!r}, expected {expect}")
    check_init_memory(tag, prec, eng, peak, held, "; panels " + ", ".join(
        f"{t.dtype} {tuple(t.shape)} {nbytes(t) / 1e9:.3f} GB" for t in panels))
    check(prec != "default" or {t.dtype for t in panels} == {torch.bfloat16},
          f"{tag}: the default pack holds {[t.dtype for t in panels]}, not the bf16 "
          f"hi plane alone")
    launches, _, exec_ms, bs = main_path(eng, b, c_ref,
                                         TOL_REF[prec] if tol is None else tol, tag)
    want = 1 if eng.is_halo else p
    check(launches[op.kernel.__name__] == want,
          f"{tag}: {op.kernel.__name__} launched {launches[op.kernel.__name__]} "
          f"times, expected {want}")
    ph = timed_phases(eng, bs)
    xch_bytes = eng.physical_rows * N * np.dtype(dtype).itemsize
    phases = ", ".join(f"{k} {v:.4f} ms" for k, v in ph.items())
    rate = (f", {xch_bytes / max(ph['a2a'], 1e-9) / 1e6:.1f} GB/s of exchange"
            if "a2a" in ph else "")
    say(f"[{tag}] exec_timed phases {phases}; rB_recv_size {eng.rB_recv_size} rows "
        f"({eng.rB_recv_size * N} elements), physical rows {eng.physical_rows} "
        f"({xch_bytes / 1e6:.1f} MB moved{rate}), rb_rows {eng._rb_rows}")
    print_stat = eng.print_stat().splitlines()
    say(f"[{tag}] print_stat: {print_stat[1]} | {print_stat[2]}")
    _EXEC_MS[tag] = exec_ms
    return eng, op, bs, launches


def halo_vs_window(op, args, tag) -> None:
    """#12's C against a second launch and against #4 run shard by shard on
    the same panels (the pair, the plane or the TF32 planes) with the plain
    version's window buffers, bit for bit: the same body, the same
    products in the same order."""
    from crp_tpu_torch.kernels.spmm_halo import halo_buffers
    from crp_tpu_torch.kernels.spmm_pallas import spmm_window

    c = launch(op, args)
    check(same_bits(c, launch(op, args)), f"{tag}: spmm_halo: two launches differ")
    buf = halo_buffers(args[3], args[5], op.buf_rows)
    planes = args[2] if isinstance(args[2], tuple) else (args[2],)
    for i in range(c.shape[0]):
        mine = tuple(t[i] for t in planes)
        panels = (torch.stack(mine) if holds_tf32_planes(op) else mine if len(mine) == 2
                  else mine[0])
        c4 = spmm_window(args[1][i], panels, buf[i], op.precision, min_b_rows=op.buf_rows)
        check(same_bits(c4, c[i]), f"{tag} shard {i}: #12 differs from #4 by "
              f"{float((c4 - c[i]).abs().max())}")


def headline_p4(device) -> list:
    """The headline in 4 row shards: ``auto`` takes the fused kernel at
    every point; ``kernel="pallas"`` the exchange and #4 on every shard (at
    highest, shard 0's #4 against a second launch and #3's fp32 entry on
    the same arrays, bit for bit: one TF32 instantiation)."""
    from crp_tpu_torch.kernels.spmm_pallas import spmm_window_sg

    a, b, c_ref = shared_case("headline")[:3]
    halo = dict(launches=0, max_abs=0.0)
    for prec in PRECS:
        eng, op, bs, launches = drive_p(a, b, c_ref, 4, prec, device, "headline p=4",
                                        ("pallas_halo", "halo"), 0)
        halo["launches"] += launches["spmm_halo"]
        c = eng.exec_device(bs)  # what multirank_path's ranks must equal, shard by shard
        _MEASURED[f"p=4 fused {prec}"] = dict(
            bits=[digest(c[i]) for i in range(4)], packed=nbytes(*eng.packed))
        del c
        got = time_kernel(op, eng.packed, bs, "headline p=4 fused", prec,
                          csr_work(a), plain_inner=2)
        halo["max_abs"] = max(halo["max_abs"], got[0])
        if prec == "default":  # the exec's B cast, outside the kernel's time
            say(f"[headline p=4 default] fused: B cast to bf16 "
                f"{time_ms(lambda: bs.to(torch.bfloat16)):.4f} ms a exec beside "
                f"spmm_halo's {got[1]:.4f} ms")
        say(f"[headline p=4 {prec}] fused: B pushes {eng.physical_rows} rows "
            f"({eng.physical_rows * N * 4 / 1e6:.1f} MB), panels "
            f"{tuple(eng.packed[2].shape)}")
        if prec == "x3":
            halo["timing"] = got[1:]
        if prec == "highest":  # a second launch, and #4 shard by shard on the same planes
            halo_vs_window(op, op.kernel_args(eng.packed, bs), "headline p=4 highest")
            say(f"[headline p=4 highest] fused: spmm_halo on the wgmma body's TF32 mode "
                f"{got[1]:.4f} ms, the previous body (3xTF32 on mma.sync) "
                f"{PREVIOUS_MS['headline p=4 fused highest']:.4f} ms; design bound "
                f"{got[5]:.4f} ms; a second launch and #4 on each shard's planes equal "
                f"bit for bit")
        del eng, op, bs
        a.__dict__.pop("_torch_pack_cache", None)
        torch.cuda.empty_cache()
    halo_lib = cusparse_yardstick(a, b, c_ref, device, "headline cusparse")

    window = dict(launches=0, max_abs=0.0)
    for prec, rb_p2p in (("x3", 0), ("default", 0), ("highest", 0), ("x3", 1)):
        eng, op, bs, launches = drive_p(a, b, c_ref, 4, prec, device, "headline p=4",
                                        ("pallas", "window"), rb_p2p, kernel="pallas")
        window["launches"] += launches["spmm_window"]
        if prec == "x3":  # multirank_path's exchanges across ranks must equal these
            c = eng.exec_device(bs)
            _MEASURED[f"p=4 {'ring' if rb_p2p else 'a2a'} x3"] = dict(
                bits=[digest(c[i]) for i in range(4)], packed=nbytes(*eng.packed))
            del c
        if not rb_p2p:  # #4 at its main-path shape: shard 0
            rB = eng.receive_buffer(bs)
            arrs = tuple(x[0] for x in eng.packed)
            s0 = a.row_slice(int(eng.A_row_displs[0]), int(eng.A_row_displs[1]))
            got = time_kernel(op, arrs, rB[0], "headline p=4 unfused", prec,
                              csr_work(s0), plain_inner=2)
            window["max_abs"] = max(window["max_abs"], got[0])
            if prec == "highest":  # one TF32 instantiation: #4 is #3 on the same arrays
                args = op.kernel_args(arrs, rB[0])
                k4 = launch(op, args)
                check(same_bits(k4, launch(op, args)),
                      "headline p=4 highest: spmm_window: two launches differ")
                k3 = spmm_window_sg(*args[:3], min_b_rows=op.min_b_rows)
                check(same_bits(k4, k3), "headline p=4 highest: #4 differs from #3's fp32 "
                      "entry on the same arrays")
                say(f"[headline p=4 highest] unfused: spmm_window on the wgmma body's TF32 "
                    f"mode on shard 0 {got[1]:.4f} ms, the previous body (3xTF32 on "
                    f"mma.sync) {PREVIOUS_MS['headline p=4 highest']:.4f} ms; design bound "
                    f"{got[5]:.4f} ms; a second launch and #3's fp32 entry equal bit for bit")
                del args, k4, k3
            if prec == "default":  # each shard's B cast, outside the kernel's time
                cast = time_ms(lambda: rB[0].to(torch.bfloat16))
                say(f"[headline p=4 default] unfused: B cast to bf16 {cast:.4f} ms a "
                    f"shard ({rB.shape[0]} a exec) beside spmm_window's {got[1]:.4f} ms")
            if prec == "x3":
                cols = np.searchsorted(eng.xplan.rowmap[0], s0.colidx)
                lib = csr_library_ms(s0.rowptr, cols, s0.val, rB.shape[1], rB[0])
                say(f"[headline p=4 x3] cuSPARSE on shard 0 ({s0.nnz} nnz) "
                    f"{lib:.4f} ms; shard 0 panels {tuple(arrs[1].shape)}")
                window["timing"], window["library_ms"] = got[1:], lib
            del rB, arrs
        del eng, op, bs
        a.__dict__.pop("_torch_pack_cache", None)
        torch.cuda.empty_cache()
    return [record("spmm_halo", halo["launches"], halo["max_abs"], *halo["timing"],
                   halo_lib),
            record("spmm_window", window["launches"], window["max_abs"],
                   *window["timing"], window["library_ms"])]


def fp64_p4(device) -> list:
    """The fp64 headline in 4 row shards on the one card, the reference's
    own setting (fp64 CSR on 4 ranks): ``auto`` must resolve to the fused
    kernel and launch #12's fp64 entry once an exec, ``kernel="pallas"``
    #4's four times, each exec within 1e-12 of the fp64 reference; each
    kernel against its plain version (1e-12) at its main-path shape (#12
    over every shard, #4 on shard 0) and a second launch (bit for bit),
    timed beside cuSPARSE fp64 (on the matrix and on shard 0); #12's C
    equal to #4's shard by shard on the plain version's window buffers, and
    #4's to #3's fp64 entry on the same arrays (one DMMA body, one
    accumulator chain a C element, k upward).  The fused exec's C shards go
    to ``_MEASURED`` for multirank_path's fp64 point."""
    from crp_tpu_torch.kernels.spmm_halo import halo_buffers
    from crp_tpu_torch.kernels.spmm_pallas import spmm_window, spmm_window_sg

    a, b, c_ref = shared_case("fp64 headline")[:3]
    tag = "fp64 headline p=4"
    eng, op, bs, launches = drive_p(a, b, c_ref, 4, "highest", device, tag,
                                    ("pallas_halo", "halo"), 0, dtype=np.float64, tol=TOL_DD)
    c = eng.exec_device(bs)
    _MEASURED["p=4 fused fp64"] = dict(bits=[digest(c[i]) for i in range(4)],
                                       packed=nbytes(*eng.packed))
    del c
    halo = time_kernel(op, eng.packed, bs, f"{tag} fused", "highest", csr_work(a),
                       plain_inner=2, tol=TOL_DD)
    args = op.kernel_args(eng.packed, bs)
    k12 = launch(op, args)
    check(same_bits(k12, launch(op, args)), f"{tag}: spmm_halo (fp64): two launches differ")
    buf = halo_buffers(args[3], args[5], op.buf_rows)
    for i in range(4):
        c4 = spmm_window(args[1][i], args[2][i], buf[i], "highest", min_b_rows=op.buf_rows)
        check(same_bits(c4, k12[i]),
              f"{tag}: #12 shard {i} differs from #4 on its window buffer by "
              f"{float((c4 - k12[i]).abs().max())}")
    del k12, buf, c4, args, eng, op, bs
    a.__dict__.pop("_torch_pack_cache", None)
    torch.cuda.empty_cache()
    lib = _MEASURED.get("fp64 headline cusparse")
    if lib is None:  # the phase run alone
        lib = cusparse_yardstick(a, b, c_ref, device, "fp64 headline cusparse")
    say(f"[{tag}] fused: spmm_halo (FP64 tensor cores) {halo[1]:.4f} ms, the previous "
        f"body (fp64 FMA) {PREVIOUS_MS['fp64 p=4 spmm_halo']:.4f} ms; design bound "
        f"{halo[5]:.4f} ms; cuSPARSE fp64 on the matrix {lib:.4f} ms; a second launch "
        f"equal bit for bit, each shard equal to #4 on its window buffer")
    records = [dict(record("spmm_halo", launches["spmm_halo"], *halo, library_ms=lib,
                           source="dd_tc.cu"), path=f"{tag} fused")]

    eng, op, bs, launches = drive_p(a, b, c_ref, 4, "highest", device, tag,
                                    ("pallas", "window"), 0, kernel="pallas",
                                    dtype=np.float64, tol=TOL_DD)
    rB = eng.receive_buffer(bs)
    arrs = tuple(x[0] for x in eng.packed)
    s0 = a.row_slice(int(eng.A_row_displs[0]), int(eng.A_row_displs[1]))
    window = time_kernel(op, arrs, rB[0], f"{tag} unfused", "highest", csr_work(s0),
                         plain_inner=2, tol=TOL_DD)
    args = op.kernel_args(arrs, rB[0])
    k4 = launch(op, args)
    check(same_bits(k4, launch(op, args)), f"{tag}: spmm_window (fp64): two launches differ")
    k3 = spmm_window_sg(*args[:3], min_b_rows=op.min_b_rows)
    check(same_bits(k4, k3), f"{tag}: #4 differs from #3's fp64 entry on the same arrays")
    cols = np.searchsorted(eng.xplan.rowmap[0], s0.colidx)
    lib0 = csr_library_ms(s0.rowptr, cols, s0.val, rB.shape[1], rB[0])
    say(f"[{tag}] unfused: spmm_window (FP64 tensor cores) on shard 0 {window[1]:.4f} ms, "
        f"the previous body (fp64 FMA) {PREVIOUS_MS['fp64 p=4 spmm_window']:.4f} ms; "
        f"design bound {window[5]:.4f} ms; cuSPARSE fp64 on shard 0 ({s0.nnz} nnz) "
        f"{lib0:.4f} ms; a second launch and #3's fp64 entry equal bit for bit; exec_device "
        f"fused {_EXEC_MS[f'{tag} highest fused']:.4f} ms, a2a + #4 "
        f"{_EXEC_MS[f'{tag} highest a2a']:.4f} ms")
    records.append(dict(record("spmm_window", launches["spmm_window"], *window,
                               library_ms=lib0, source="dd_tc.cu"), path=f"{tag} unfused"))
    del eng, op, bs, rB, arrs, args, k4, k3
    a.__dict__.pop("_torch_pack_cache", None)
    torch.cuda.empty_cache()
    return records


# ------------------------------------------------------------------ ranks
MULTIRANK_P = 4
MULTIRANK_TIMEOUT = 300  # s a set of ranks may take before the phase fails
RANK_THREADS = 2  # torch threads a rank process: the host's 8 cores over 4 ranks
PROBE_TIMEOUT = 90
B2B_EXECS = 6  # execs of the back-to-back run, over B2B_SEEDS' B in turn
B2B_SEEDS = (1, 2, 3)
SKEW_S = 0.05  # s rank r sleeps on the host before exec r of the back-to-back run
BOUND_TEST_S = 0.5  # s the waits are bounded by where one rank withholds an exec
WITHHOLD_RANK = 1
BOUND_SLACK_S = 5.0  # s past the bound a rank may take to raise HaloTimeout
PR20_RANK_MS = 8.1320  # #12 across 4 processes, rank 0 at x3, host barriers included (PR 20)


def changing_bs(a, dtype=np.float32) -> list:
    """The back-to-back run's distinct B: ``fill_b``'s analytic B at other
    factors, one a seed."""
    from crp_tpu_torch import fill_b

    return [np.asarray(fill_b(0, a.ncol, 0, N, factor_i=0.19 * (1 + s), factor_j=0.24 / s,
                              dtype=dtype)) for s in B2B_SEEDS]


def host_counts(peers) -> tuple:
    """The host barriers and stream drains ``HaloPeers`` has made, and its
    flag kernels' launches (wait, signal, done)."""
    return (peers.barriers, peers.drains, *peers.flag_launches.values())


def moved(before, peers) -> list:
    return [y - x for x, y in zip(before, host_counts(peers))]


def owner_rows(peers) -> torch.Tensor:
    """Every owner's rows as the plain version reads them: in place after
    a host barrier (every owner's B loaded), or on the CPU (a rehearsal)
    gathered."""
    if peers.views is None:
        return peers.rows()
    peers.sync()
    return torch.stack(peers.views)


def back_to_back(eng, rank, device, shards, kernel_and_plain) -> dict:
    """B2B_EXECS execs of ``eng`` over the distinct B ``shards`` in turn,
    with no host sync between them and rank r sleeping SKEW_S on the host
    before exec r, so that the others run ahead and wait on the device;
    every C block against an ordered replay's (``peers.sync()`` before and
    after each exec) by digest; the kernel's output for each distinct B
    against ``spmm_halo_plain`` on the owners' rows, read after a sync
    (``kernel_and_plain()``: the pair for the B just loaded); the host
    barriers, drains and flag launches of the run (the first two must not
    move) and its wall ms, the sleep included."""
    peers = eng.peers
    torch.cuda.synchronize(device)
    peers.sync()
    before = host_counts(peers)
    t0 = time.perf_counter()
    outs = []
    for i in range(B2B_EXECS):
        if i == rank:
            time.sleep(SKEW_S)
        outs.append(eng.exec_device(shards[i % len(shards)]))
    torch.cuda.synchronize(device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    run_moved = moved(before, peers)
    peers.check()
    got = [digest(o) for o in outs]
    replay, plain = [], []
    for i in range(B2B_EXECS):
        peers.sync()
        replay.append(digest(eng.exec_device(shards[i % len(shards)])))
        peers.sync()
        if i < len(shards):
            k, pl = kernel_and_plain()
            d = (k - pl).double()
            plain.append(float(d.norm() / max(float(pl.double().norm()), 1e-300)))
    return dict(same=got == replay, distinct=len(set(got)), moved=run_moved, plain=plain,
                wall_ms=wall_ms)


def withheld_exec(eng, rank, device, bs) -> dict:
    """Rank WITHHOLD_RANK withholds one exec; every other rank runs execs
    (at most 3) with the waits bounded by BOUND_TEST_S until one raises
    ``HaloTimeout`` at the sync after it: which exec, the seconds since the
    ranks set out together, whether its C is NaN throughout.  Then every
    rank closes the engine (``close`` raises again where a wait gave up)."""
    from crp_tpu_torch.kernels.spmm_halo import HaloTimeout

    peers = eng.peers
    torch.cuda.synchronize(device)
    peers.sync()
    peers.bound_s = BOUND_TEST_S
    got = dict(withheld=rank == WITHHOLD_RANK, raised=None)
    t0 = time.perf_counter()
    if rank != WITHHOLD_RANK:
        for attempt in range(1, 4):
            c = eng.exec_device(bs)
            torch.cuda.synchronize(device)
            try:
                peers.check()
            except HaloTimeout as e:
                got.update(raised=str(e), attempt=attempt, s=time.perf_counter() - t0,
                           nan=bool(torch.isnan(c).all()))
                break
    try:
        eng.close()
        got["closed"] = "clean"
    except HaloTimeout as e:
        got["closed"] = f"raised HaloTimeout: {e}"
    got["close_s"] = time.perf_counter() - t0
    return got


def rank_env(rank: int, world: int, port: int) -> None:
    """The env a launcher (``torchrun``) gives a rank; every rank on the one
    card (``LOCAL_RANK`` 0)."""
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def multirank_probe(rank, world, port, out) -> None:
    """What torch's gloo carries here for CUDA tensors, in a process set of
    its own (a transport that reads a device pointer as host memory ends
    the process): ``all_to_all_single`` with equal splits, with uneven
    splits (the transport of ``RedistEngine`` on a mesh), then
    ``batch_isend_irecv``; each result is written as soon as it is
    known."""
    import torch.distributed as dist

    from crp_tpu_torch.shard.layout import init_distributed

    rank_env(rank, world, port)
    device = init_distributed(backend="gloo")
    got = {}

    def note(key, fn):
        try:
            got[key] = "ok" if fn() else "wrong values"
        except Exception as e:  # a refusal is the answer the probe asks for
            got[key] = f"{type(e).__name__}: {e}"[:300]
        with open(out, "w") as f:
            f.write(json.dumps(got))

    def a2a():
        x = torch.arange(world * 4, dtype=torch.float32, device=device) + 100 * rank
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        torch.cuda.synchronize(device)
        want = torch.cat([torch.arange(rank * 4, rank * 4 + 4, dtype=torch.float32)
                          + 100 * j for j in range(world)])
        return torch.equal(y.cpu(), want)

    def p2p():
        x = torch.full((8,), float(rank), device=device)
        y = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (rank + 1) % world),
               dist.P2POp(dist.irecv, y, (rank - 1) % world)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        torch.cuda.synchronize(device)
        return bool(torch.all(y.cpu() == float((rank - 1) % world)))

    def a2av():  # uneven splits: rank r sends r + j + 1 elements to rank j
        sizes = [rank + j + 1 for j in range(world)]
        x = torch.cat([torch.arange(n, dtype=torch.float32) + 100 * rank + 10 * j
                       for j, n in enumerate(sizes)]).to(device)
        y = torch.empty(sum(j + rank + 1 for j in range(world)), device=device)
        dist.all_to_all_single(y, x, [j + rank + 1 for j in range(world)], sizes)
        torch.cuda.synchronize(device)
        want = torch.cat([torch.arange(j + rank + 1, dtype=torch.float32) + 100 * j
                          + 10 * rank for j in range(world)])
        return torch.equal(y.cpu(), want)

    note("all_to_all_single", a2a)
    dist.barrier()
    note("all_to_all_single uneven", a2av)
    dist.barrier()
    note("batch_isend_irecv", p2p)
    try:
        dist.barrier()
        dist.destroy_process_group()
    except RuntimeError:  # a refused op ends the group: its answer is written
        pass


def rank_wall_ms(fn, device, reps=5) -> float:
    """Median host wall ms of ``fn()`` and a device sync over ``reps``
    calls, after one warm-up: a rank's time, which the card's other
    processes share."""
    fn()
    torch.cuda.synchronize(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def load_case(path) -> tuple:
    """(A, c_ref) from a case file multirank_path wrote."""
    from crp_tpu_torch.sparse.csr import CSRMatrix

    with np.load(path) as f:
        return (CSRMatrix(*(int(x) for x in f["shape"]), f["rowptr"], f["colidx"], f["val"]),
                f["c_ref"])


def multirank_rank(rank, world, port, case_path, out, unfused, cplaw_path=None,
                   f64_path=None) -> None:
    """One rank of multirank_path, a process of its own, as a user runs it:
    the launcher's env, ``init_distributed`` (gloo for the control plane:
    NCCL refuses several ranks on one device), ``make_mesh_1d`` and
    ``RowParaSpmm(mesh=...)`` on the headline at p = 4.  At each point
    ``auto`` must take the fused kernel across processes (this rank's B
    buffer mapped by its peers through CUDA IPC); the main path is one
    ``exec(b)`` (launch counts zeroed just before it and read just after);
    then this rank's C shard's digest, its rows' error against the fp64
    reference, its init's device memory, the kernel against its plain
    version on the same inputs (the owners' rows read through the mapped
    buffers), and times, which are time-shared: four processes take turns
    on the one card.  At each point also: the host barriers and stream
    drains ``HaloPeers`` made across the main path (none), the
    back-to-back run with B changing every exec (:func:`back_to_back`) and
    its pipelined ms an exec; at x3, last, one withheld exec
    (:func:`withheld_exec`).  ``f64_path``: the fp64 headline's case file,
    then the same at the fp64 point (key ``"fp64"``: the fused kernel's
    fp64 entry, #11's DMMA body with the flags' waits in its producer
    warpgroup), its withheld exec included.  ``unfused``: the exchanges
    gloo carries for CUDA tensors (``"a2a"``, ``"ring"``), each with
    ``kernel="pallas"`` at x3.  ``cplaw_path``: then :func:`multirank_crp`
    on the same group.  Writes a JSON record to ``out``."""
    import torch.distributed as dist

    from crp_tpu_torch import RowParaSpmm, SpmmConfig, csr_row_partition, fill_b, rel_fro_err
    from crp_tpu_torch.kernels import spmm_halo as sh
    from crp_tpu_torch.shard.layout import init_distributed, make_mesh_1d

    torch.set_num_threads(RANK_THREADS)
    rank_env(rank, world, port)
    device = init_distributed(backend="gloo")
    mesh = make_mesh_1d(world)
    a, c_ref = load_case(case_path)
    b = np.asarray(fill_b(0, a.ncol, 0, N, dtype=np.float32))
    d = csr_row_partition(a.rowptr, world)
    r0, r1 = int(d[rank]), int(d[rank + 1])
    shard = a.row_slice(r0, r1)
    kernels = all_kernels()
    got = dict(rank=rank, points={}, unfused={})

    def wall_ms(fn, reps=5):
        return rank_wall_ms(fn, device, reps)

    def fused_point(key, prec, a, c_ref, b, tol, withhold, timed=True):
        dtype = a.val.dtype.type
        dd = csr_row_partition(a.rowptr, world)
        eng, peak, held = measured_init(device, lambda: RowParaSpmm(
            a, dd, dd, N, mesh=mesh, dtype=dtype,
            config=SpmmConfig(kernel="auto", mxu_precision=prec)))
        check(eng.kernel_kind == "pallas_halo" and eng.peers is not None
              and eng.peers.bases is not None,
              f"rank {rank} {key}: resolved to {eng.kernel_kind}, peers {eng.peers}")
        for k in kernels:
            k.launches = 0
        before = host_counts(eng.peers)
        c = eng.exec(b)  # the main path: every rank returns the global C
        launches = {k.__name__: k.launches for k in kernels}
        main_moved = moved(before, eng.peers)
        check(c.shape == (a.nrow, N) and bool(np.isfinite(c).all()),
              f"rank {rank} {key}: C {c.shape} or non-finite")
        q0, q1 = int(dd[rank]), int(dd[rank + 1])
        err = rel_fro_err(c_ref[q0:q1], c[q0:q1, :ERR_COLS].astype(np.float64))
        err_all = rel_fro_err(c_ref, c[:, :ERR_COLS].astype(np.float64))
        bs = eng.shard_b(b)
        cs = eng.exec_device(bs)
        op = eng._local_op
        args = op.kernel_args(eng.packed, eng.peers.buf)
        owners = owner_rows(eng.peers)
        pargs = (*args[:5], owners, *args[6:])

        def run_kernel():
            return op.kernel(*args, min_b_rows=op.min_b_rows, peers=eng.peers)

        def run_plain():
            return sh.spmm_halo_plain(*pargs, consumers=[rank])

        max_abs, _, rel_fro = compare(f"spmm_halo across ranks {key}", run_kernel, run_plain)
        pt = got["points"][key] = dict(
            kind=eng.kernel_kind, launches=launches, bits=digest(cs[0]), err=err,
            err_all=err_all, tol=tol, peak=peak, held=held, packed=nbytes(*eng.packed),
            max_abs=max_abs, rel_fro=rel_fro, bases16=eng.peers.ptrs16,
            exec_ms=wall_ms(lambda: eng.exec_device(bs)), rows=(q0, q1),
            stat=eng.print_stat().splitlines()[1], main_moved=main_moved)
        if timed:
            sh_a = a.row_slice(q0, q1)
            pt.update(kernel_ms=wall_ms(run_kernel), plain_ms=wall_ms(run_plain, 3),
                      bound=function_bound(op, csr_work(sh_a), N,
                                           torch.float64 if dtype == np.float64
                                           else torch.float32))

        def kernel_and_plain():
            k = run_kernel()
            return k, sh.spmm_halo_plain(*args[:5], owner_rows(eng.peers), *args[6:],
                                         consumers=[rank])

        pt["b2b"] = back_to_back(eng, rank, device,
                                 [eng.shard_b(x) for x in changing_bs(a, dtype)],
                                 kernel_and_plain)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()  # pipelined: the execs back to back, one sync at the end
        for _ in range(B2B_EXECS):
            eng.exec_device(bs)
        torch.cuda.synchronize(device)
        pt["pipelined_ms"] = (time.perf_counter() - t0) * 1e3 / B2B_EXECS
        if withhold:
            pt["withheld"] = withheld_exec(eng, rank, device, bs)
        else:
            eng.close()
        del eng, op, args, pargs, owners, cs, bs
        a.__dict__.pop("_torch_pack_cache", None)  # the engines' pack memo on A
        torch.cuda.empty_cache()
        return pt

    for prec in PRECS:
        pt = fused_point(prec, prec, a, c_ref, b, TOL_REF[prec], withhold=prec == "x3")
        if prec == "x3":  # cuSPARSE on this rank's shard and the global B
            pt["library_ms"] = csr_library_ms(shard.rowptr, shard.colidx, shard.val,
                                              a.ncol, torch.from_numpy(b).to(device))
    if f64_path is not None:
        a64, c64_ref = load_case(f64_path)
        fused_point("fp64", "highest", a64, c64_ref,
                    np.asarray(fill_b(0, a64.ncol, 0, N)), TOL_DD, withhold=True,
                    timed=False)
        del a64
    for mode in unfused:
        eng, peak, held = measured_init(device, lambda: RowParaSpmm(
            a, d, d, N, mesh=mesh, dtype=np.float32, config=SpmmConfig(
                kernel="pallas", mxu_precision="x3", rb_p2p=int(mode == "ring"))))
        for k in kernels:
            k.launches = 0
        c = eng.exec(b)
        launches = {k.__name__: k.launches for k in kernels}
        bs = eng.shard_b(b)
        got["unfused"][mode] = dict(
            kind=eng.kernel_kind, variant=eng._local_op.variant, launches=launches,
            bits=digest(eng.exec_device(bs)[0]),
            err=rel_fro_err(c_ref, c[:, :ERR_COLS].astype(np.float64)),
            rB_recv_size=eng.rB_recv_size, physical_rows=eng.physical_rows,
            peak=peak, held=held, packed=nbytes(*eng.packed),
            exec_ms=wall_ms(lambda: eng.exec_device(bs)))
        del eng, bs
        a.__dict__.pop("_torch_pack_cache", None)
        torch.cuda.empty_cache()
    if cplaw_path is not None:
        got["crp"] = multirank_crp(rank, device, a, b, c_ref, cplaw_path, unfused)
    dist.barrier()
    dist.destroy_process_group()
    with open(out, "w") as f:
        f.write(json.dumps(got))


CRP_COUNTERS = ("nelem_A_rd", "nelem_A_agv", "nelem_B_rd", "nelem_B_a2av",
                "nelem_B_a2av_min", "physical_rows")


def crp_layouts(a):
    """The reference driver's user layouts at p = 4 (crp_drive's): B in 4
    row slabs, C in 4 column slabs."""
    from crp_tpu_torch.shard.redist import BlockDist
    from crp_tpu_torch.utils.blocks import uniform_displs

    return (BlockDist.from_grid(uniform_displs(a.ncol, 4), [0, N]),
            BlockDist.from_grid([0, a.nrow], uniform_displs(N, 4)))


def crp_counters(eng) -> dict:
    return {k: getattr(eng, k) for k in CRP_COUNTERS}


def multirank_crp(rank, device, a, b, c_ref, cplaw_path, unfused) -> dict:
    """multirank_rank's ``CrpSpmm`` cases, in the same process group, as
    any_layout_path drives them on one device, each on the mesh of the
    planner's grid: (a) the headline, ``auto`` -> #12 across the processes
    over the column group's peer-mapped B blocks (4 x 1); (b) with
    ``a2a_b_finegrain=1`` -> #4 after the exact-row exchange across them
    (where gloo carries the all_to_all); (c) cplaw on 1 x 4 -> #7 and #9,
    rd_B and rd_C across the processes, no B exchange; (d) the headline's
    A as a ``DistCSR`` of which this rank holds block r alone.  Each: the
    main path's launches (counts zeroed just before ``exec(b)``), this
    rank's user C block's digest, the global C's error, every counter,
    the init's device memory; the kernels against their plain versions on
    this rank's inputs (timed on rank 0, time-shared)."""
    from crp_tpu_torch import CrpSpmm, SpmmConfig, fill_b, rel_fro_err
    from crp_tpu_torch.kernels import spmm_halo as sh
    from crp_tpu_torch.shard.dist_a import DistCSR
    from crp_tpu_torch.shard.layout import make_mesh_2d
    from crp_tpu_torch.utils.blocks import uniform_displs

    kernels = all_kernels()
    got = {}

    def run(tag, a_in, a, b, c_ref, cfg, grid):
        ub, uc = crp_layouts(a)
        mesh = make_mesh_2d(*grid)
        eng, peak, held = measured_init(device, lambda: CrpSpmm(
            a_in, N, ub, uc, dtype=np.float32, mesh=mesh,
            config=SpmmConfig(mxu_precision="x3", **cfg)))
        for k in kernels:
            k.launches = 0
        before = host_counts(eng.peers) if eng.peers is not None else None
        c = eng.exec(b)  # the main path: every rank returns the global C
        launches = {k.__name__: k.launches for k in kernels if k.launches}
        main_moved = moved(before, eng.peers) if before is not None else None
        bs = eng.rd_B.shard_src(b)
        cs = eng.exec_device(bs)
        got[tag] = dict(
            kind=eng.kernel_kind, variant=eng._local_op.variant, grid=(eng.pm, eng.pn),
            launches=launches, bits=digest(cs[0]), shape=list(cs.shape),
            finite=bool(np.isfinite(c).all()) and c.shape == (a.nrow, N),
            err=rel_fro_err(c_ref, c[:, :ERR_COLS].astype(np.float64)),
            counters=crp_counters(eng), peak=peak, held=held, packed=nbytes(*eng.packed),
            moved=(eng.rd_B.nelem_moved, eng.rd_C.nelem_moved),
            aliased=eng.peers is not None and bs.data_ptr() == eng.peers.buf.data_ptr(),
            exec_ms=rank_wall_ms(lambda: eng.exec_device(bs), device, 3),
            stat=[ln for ln in eng.print_stat().splitlines() if ln.startswith("Rank")][0],
            main_moved=main_moved)
        return eng, bs

    def panel(eng, a):
        i = eng.mesh.pi
        return a.row_slice(int(eng.bplan.m_split_idx[i]), int(eng.bplan.m_split_idx[i + 1]))

    # (a) the headline, auto -> #12 across the processes
    eng, bs = run("auto", a, a, b, c_ref, {}, ANY_HEADLINE_GRID)
    op = eng._local_op
    eng._blocks(eng.rd_B.exec_device(bs))  # this rank's block into the peers' buffer
    args = op.kernel_args(eng.packed, eng.peers.buf)
    pargs = (*args[:5], owner_rows(eng.peers), *args[6:])

    def run_kernel():
        return op.kernel(*args, min_b_rows=op.min_b_rows, peers=eng.peers)

    def run_plain():
        return sh.spmm_halo_plain(*pargs, consumers=[eng.peers.me])

    max_abs, _, rel_fro = compare("spmm_halo across ranks (CrpSpmm)", run_kernel, run_plain)
    pa = panel(eng, a)
    got["auto"].update(
        max_abs=max_abs, rel_fro=rel_fro, bound=function_bound(op, csr_work(pa), N,
                                                               torch.float32),
        kernel_ms=rank_wall_ms(run_kernel, device, 3))  # collective: every rank times it
    if rank == 0:
        got["auto"].update(plain_ms=rank_wall_ms(run_plain, device, 1),
                           library_ms=csr_library_ms(pa.rowptr, pa.colidx, pa.val, a.ncol,
                                                     torch.from_numpy(b).to(device)))

    def kernel_and_plain():
        k = run_kernel()
        return k, sh.spmm_halo_plain(*args[:5], owner_rows(eng.peers), *args[6:],
                                     consumers=[eng.peers.me])

    got["auto"]["b2b"] = back_to_back(eng, rank, device,
                                      [eng.rd_B.shard_src(x) for x in changing_bs(a)],
                                      kernel_and_plain)
    eng.close()
    del eng, op, args, pargs, bs, run_kernel, run_plain, kernel_and_plain
    a.__dict__.pop("_torch_pack_cache", None)
    torch.cuda.empty_cache()

    # (d) A as a DistCSR: this rank holds block r alone, on the card
    d = DistCSR.from_global(a, uniform_displs(a.nrow, 4))
    d.colidxs = [torch.from_numpy(x).to(device) if i == rank else None
                 for i, x in enumerate(d.colidxs)]
    d.vals = [torch.from_numpy(x).to(device) if i == rank else None
              for i, x in enumerate(d.vals)]
    eng, bs = run("dist A", d, a, b, c_ref, {}, ANY_HEADLINE_GRID)
    eng.close()
    del eng, bs, d
    torch.cuda.empty_cache()

    def unfused_kernels(tag, eng, a, bs, spill):
        """The panel kernel (and the spill) against its plain version on
        this rank's receive buffer after the exchange (a collective: every
        rank); timed with its library call on rank 0."""
        op = eng._local_op
        rB = eng._exchange(eng._blocks(eng.rd_B.exec_device(bs)))[0, 0]
        arrs = tuple(x[0] for x in eng.packed)
        pa = panel(eng, a)
        cols = (np.searchsorted(eng.xplan.rowmap[eng.mesh.pi], pa.colidx) if eng.fine
                else pa.colidx - int(eng.xplan.rowmap[eng.mesh.pi]))
        mx, _, fro = kernel_vs_plain(op, arrs, rB)
        out = dict(max_abs=mx, rel_fro=fro, bound=function_bound(
            op, csr_work(pa), rB.shape[-1], torch.float32))
        kargs = op.kernel_args(arrs, rB)
        if rank == 0:
            out.update(kernel_ms=rank_wall_ms(lambda: launch(op, kargs), device, 3),
                       plain_ms=rank_wall_ms(lambda: op.plain(*kargs), device, 1),
                       library_ms=csr_library_ms(pa.rowptr, cols, pa.val, rB.shape[0], rB))
        if spill:
            s_abs, _, s_fro = spill_vs_plain(op, arrs, rB)
            sargs = op.spill_args(arrs, launch(op, kargs), rB)
            out["spill"] = dict(max_abs=s_abs, rel_fro=s_fro,
                                bound=view_bound(sargs[-1], rB, sargs[0].shape[0], True))
            if rank == 0:
                out["spill"].update(
                    kernel_ms=rank_wall_ms(lambda: op.spill_kernel(*sargs), device, 3),
                    plain_ms=rank_wall_ms(lambda: op.spill_plain(*sargs), device, 1),
                    library_ms=spill_library_ms(op, arrs, sargs[0], rB))
        got[tag]["kernels"] = out

    # (b) finegrain -> #4 after the exact-row all_to_all across the processes
    if "a2a" in unfused:
        eng, bs = run("fine", a, a, b, c_ref, dict(a2a_b_finegrain=1, rb_p2p=0),
                      ANY_HEADLINE_GRID)
        unfused_kernels("fine", eng, a, bs, spill=False)
        del eng, bs
        a.__dict__.pop("_torch_pack_cache", None)
        torch.cuda.empty_cache()

    # (c) cplaw on 1 x 4: #7 + #9 a rank, rd_B and rd_C across the processes
    ac, cc_ref = load_case(cplaw_path)
    bc = np.asarray(fill_b(0, ac.ncol, 0, N, dtype=np.float32))
    eng, bs = run("cplaw", ac, ac, bc, cc_ref, {}, ANY_CPLAW_GRID)
    unfused_kernels("cplaw", eng, ac, bs, spill=True)
    del eng, bs
    torch.cuda.empty_cache()
    return got


def run_rank_set(target, world, args, timeout, tag, may_fail=False) -> list:
    """``target(rank, world, port, *args(rank))`` in ``world`` spawned
    processes; every one must exit 0 within ``timeout`` s (else the phase
    fails, unless ``may_fail``).  Returns their exit codes."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=target, args=(r, world, port, *args(r)))
             for r in range(world)]
    for q in procs:
        q.start()
    deadline = time.monotonic() + timeout
    for q in procs:
        q.join(max(deadline - time.monotonic(), 0.1))
    for q in procs:  # stop whatever outlived the deadline
        if q.is_alive():
            q.kill()
            q.join()
    codes = [q.exitcode for q in procs]
    check(may_fail or codes == [0] * world, f"{tag}: the ranks exited {codes}")
    return codes


def one_rank_nccl(a, b, c_ref, device) -> None:
    """(b) One rank over NCCL, in this process: ``init_distributed()`` with
    its default backend, ``make_mesh_1d(1)`` and the headline's p = 1
    engine at x3: its C shard and its exec's global C (gathered by NCCL's
    ``all_gather``) equal the one-device engine's bit for bit."""
    import torch.distributed as dist

    from crp_tpu_torch import RowParaSpmm, SpmmConfig, csr_row_partition
    from crp_tpu_torch.shard.layout import init_distributed, make_mesh_1d

    rank_env(0, 1, free_port())
    dev = init_distributed()
    try:
        check(dist.get_backend() == "nccl" and dev == device,
              f"one rank: backend {dist.get_backend()} on {dev}")
        d = csr_row_partition(a.rowptr, 1)
        eng = RowParaSpmm(a, d, d, N, mesh=make_mesh_1d(1), dtype=np.float32,
                          config=SpmmConfig(kernel="auto", mxu_precision="x3"))
        kernels = all_kernels()
        for k in kernels:
            k.launches = 0
        c = eng.exec(b)
        launches = {k.__name__: k.launches for k in kernels if k.launches}
        bs = eng.shard_b(b)
        cs = eng.exec_device(bs)
        want = _MEASURED.get("headline p=1 x3 bits")
        got = (digest(cs), digest(c))
        same = want is not None and got == want
        from crp_tpu_torch import rel_fro_err

        err = rel_fro_err(c_ref, c[:, :ERR_COLS].astype(np.float64))
        say(f"[multirank nccl] one rank over NCCL (world size 1), p = 1 x3: kind "
            f"{eng.kernel_kind}, launches {json.dumps(launches)}, rel_fro_err {err:.3e}; "
            f"C shard and the exec's all_gather-ed C "
            f"{'equal the one-device engine bit for bit' if same else 'DIFFER'}"
            f"{'' if want else ' (no one-device run to compare with)'}")
        check(same, "one rank over NCCL: C differs from the one-device engine's")
        check(launches.get("spmm_window_sg_presplit") == 1 and err <= TOL_REF["x3"],
              f"one rank over NCCL: launches {launches}, err {err}")
        del eng, bs, cs
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()


def multirank_path(device) -> list:
    """Shards on several ranks, on the one card: (b) one rank over NCCL;
    a probe of what gloo carries for CUDA tensors; (a) 4 ranks, one
    process each, on the headline at p = 4: ``auto`` -> #12 across
    processes at x3, default and highest, and on the fp64 headline in fp64
    (#12's fp64 entry: #11's DMMA body, the flags' waits in its producer
    warpgroup), each rank's C shard equal bit for bit to slice [r] of the
    one-device fused engine's (headline_p4, fp64_p4), its rows within the
    point's class (1e-12 in fp64); (c) the unfused exchanges gloo
    carries, their C shards equal to the one-device engine's likewise;
    (d) ``CrpSpmm`` on the ranks' meshes (multirank_crp, checked against
    any_layout_path's one-device engines by multirank_crp_check).  #12
    across processes is ordered by flags in peer memory: across the main
    path ``HaloPeers`` makes no host barrier and no stream drain, and
    launches its wait, signal and done kernels once each a rank; the
    back-to-back run with B changing every exec and the ranks skewed on
    the host gives every rank's C equal to an ordered replay's, within
    the plain version's tolerance; at x3 and at fp64 one exec withheld by
    rank WITHHOLD_RANK makes every other rank raise ``HaloTimeout`` within
    BOUND_TEST_S + BOUND_SLACK_S with its C NaN, and the set still
    closes and exits 0.  The records of #12 across processes: its
    main-path launches over the ranks, its largest difference from its
    plain version, rank 0's times at x3 (time-shared); then those of
    (d)."""
    import os
    import tempfile

    a, b, c_ref = shared_case("headline")[:3]
    one_rank_nccl(a, b, c_ref, device)

    torch.cuda.empty_cache()
    from crp_tpu_torch import native

    with tempfile.TemporaryDirectory(dir=native.BUILD_DIR) as tmp:
        outs = [f"{tmp}/probe{r}.json" for r in range(2)]
        t0 = time.perf_counter()
        codes = run_rank_set(multirank_probe, 2, lambda r: (outs[r],), PROBE_TIMEOUT,
                             "gloo probe", may_fail=True)
        probe = [json.loads(open(o).read()) if os.path.exists(o) else {} for o in outs]
        # an op gloo refuses ends its group, and the ranks exit non-zero after it
        carried = {op: all(pr.get(op) == "ok" for pr in probe)
                   for op in ("all_to_all_single", "all_to_all_single uneven",
                              "batch_isend_irecv")}
        say(f"[multirank probe] gloo on CUDA tensors, 2 ranks: {json.dumps(probe)}, "
            f"exit codes {codes} ({time.perf_counter() - t0:.1f} s)")
        unfused = [m for m, op in (("a2a", "all_to_all_single"), ("ring", "batch_isend_irecv"))
                   if carried[op]]

        check(carried["all_to_all_single uneven"],
              "gloo here does not carry all_to_all_single with uneven splits on CUDA "
              "tensors, RedistEngine's transport across ranks")
        case, cplaw_case, f64_case = (f"{tmp}/{x}.npz" for x in
                                      ("headline", "cplaw", "fp64_headline"))
        ac, _, cc_ref = shared_case("cplaw")[:3]
        a64, _, c64_ref = shared_case("fp64 headline")[:3]
        for path, (x, x_ref) in ((case, (a, c_ref)), (cplaw_case, (ac, cc_ref)),
                                 (f64_case, (a64, c64_ref))):
            np.savez(path, shape=(x.nrow, x.ncol), rowptr=x.rowptr, colidx=x.colidx,
                     val=x.val, c_ref=x_ref)
        _CASES.pop("fp64 headline")  # no later phase drives it
        outs = [f"{tmp}/rank{r}.json" for r in range(MULTIRANK_P)]
        t0 = time.perf_counter()
        run_rank_set(multirank_rank, MULTIRANK_P,
                     lambda r: (case, outs[r], unfused, cplaw_case, f64_case),
                     MULTIRANK_TIMEOUT, "multirank")
        ranks = [json.loads(open(o).read()) for o in outs]
        say(f"[multirank] {MULTIRANK_P} ranks, one process each, on the one card: "
            f"{time.perf_counter() - t0:.1f} s from spawn to exit")

    halo = dict(launches=0, max_abs=0.0, flag_launches=[0, 0, 0])
    for prec in (*PRECS, "fp64"):
        want = _MEASURED.get(f"p=4 fused {prec}")
        for r, rk in enumerate(ranks):
            pt = rk["points"][prec]
            tag = f"multirank {prec} rank {r}"
            tol_plain = TOL_PLAIN[np.float64] if prec == "fp64" else TOL_PLAIN_FRO
            halo["launches"] += pt["launches"]["spmm_halo"]
            halo["max_abs"] = max(halo["max_abs"], pt["max_abs"])
            same = want is not None and pt["bits"] == want["bits"][r]
            one = (f"one-device engine's pack {want['packed'] / 1e9:.3f} GB for 4 shards"
                   if want else "no one-device run")
            say(f"[{tag}] kind {pt['kind']}, rows {pt['rows']}, main-path launches "
                f"spmm_halo {pt['launches']['spmm_halo']} (others "
                f"{sum(v for k, v in pt['launches'].items() if k != 'spmm_halo')}); C "
                f"shard {'equal to the one-device fused engine bit for bit' if same else 'DIFFERS'}"
                f"; rel_fro_err of its rows {pt['err']:.3e} (whole C {pt['err_all']:.3e}, "
                f"tol {pt['tol']:g}); init device memory peak {pt['peak'] / 1e9:.3f} "
                f"GB, held {pt['held'] / 1e9:.3f} GB, packed {pt['packed'] / 1e9:.3f} GB "
                f"({one}); vs plain rel fro err {pt['rel_fro']:.3e}, max abs "
                f"{pt['max_abs']:.3e}; bases on 16 bytes {pt['bases16']}; {pt['stat']}")
            say(f"[{tag}] time-shared (4 processes on one card; flags, no host barrier; "
                f"no speed figure): exec {pt['exec_ms']:.3f} ms, {B2B_EXECS} execs back "
                f"to back {pt['pipelined_ms']:.3f} ms an exec"
                + (f", kernel {pt['kernel_ms']:.3f} ms, plain {pt['plain_ms']:.3f} ms, "
                   f"bound {pt['bound'][0]:.4f} ms ({pt['bound'][1]})"
                   if "kernel_ms" in pt else "")
                + (f"; PR 20's host barriers included: {PR20_RANK_MS:.4f} ms (rank 0, x3)"
                   if r == 0 and prec == "x3" else ""))
            mv, b2b = pt["main_moved"], pt["b2b"]
            replay = "equal to" if b2b["same"] else "DIFFERS from"
            for i in range(3):
                halo["flag_launches"][i] += mv[2 + i]
            say(f"[{tag}] HaloPeers across the main path: host barriers {mv[0]}, stream "
                f"drains {mv[1]}, flag kernels wait / signal / done {mv[2]} / {mv[3]} / "
                f"{mv[4]}; back to back ({B2B_EXECS} execs over {len(B2B_SEEDS)} B, rank "
                f"{r} {SKEW_S * 1e3:.0f} ms late at exec {r}, {b2b['wall_ms']:.1f} ms): "
                f"host barriers {b2b['moved'][0]}, drains {b2b['moved'][1]}; C {replay} "
                f"the ordered replay bit for bit ({b2b['distinct']} distinct), vs plain "
                f"rel fro err up to "
                f"{max(b2b['plain']):.3e}")
            check(mv[:2] == [0, 0] and mv[2:] == [1, 1, 1],
                  f"{tag}: HaloPeers across the main path: {mv}")
            check(b2b["same"] and b2b["distinct"] == len(B2B_SEEDS)
                  and b2b["moved"][:2] == [0, 0] and max(b2b["plain"]) <= tol_plain,
                  f"{tag}: back to back {b2b}")
            check(want is not None and same,
                  f"{tag}: C shard differs from slice {r} of the one-device fused engine's")
            check(pt["launches"]["spmm_halo"] == 1 and pt["err"] <= pt["tol"]
                  and pt["err_all"] <= pt["tol"] and pt["rel_fro"] <= tol_plain,
                  f"{tag}: launches {pt['launches']}, err {pt['err']}, vs plain "
                  f"{pt['rel_fro']}")
    for mode in ("a2a", "ring"):
        want = _MEASURED.get(f"p=4 {mode} x3")
        if mode not in ranks[0]["unfused"]:
            say(f"[multirank {mode}] not driven across the processes: gloo here does not "
                f"carry its CUDA collective (see the probe); on the CPU the tests drive it "
                f"across ranks, on the card the one-device engine")
            continue
        for r, rk in enumerate(ranks):
            uf = rk["unfused"][mode]
            same = want is not None and uf["bits"] == want["bits"][r]
            keep = max(uf["held"], uf["packed"], 1)
            say(f"[multirank {mode} x3 rank {r}] kind {uf['kind']}/{uf['variant']}, "
                f"launches spmm_window {uf['launches']['spmm_window']}, rB_recv_size "
                f"{uf['rB_recv_size']}, physical rows {uf['physical_rows']}, rel_fro_err "
                f"{uf['err']:.3e}; C shard "
                f"{'equal to the one-device engine bit for bit' if same else 'DIFFERS'}; "
                f"init device memory peak {uf['peak'] / 1e9:.3f} GB, held "
                f"{uf['held'] / 1e9:.3f} GB, packed {uf['packed'] / 1e9:.3f} GB "
                f"({uf['peak'] / keep:.3f}x; one-device engine's pack "
                f"{want['packed'] / 1e9 if want else float('nan'):.3f} GB for 4 shards); "
                f"exec {uf['exec_ms']:.3f} ms time-shared")
            check(same and uf["launches"]["spmm_window"] == 1 and uf["err"] <= TOL_REF["x3"],
                  f"multirank {mode} rank {r}: {uf}")
            check(uf["peak"] <= INIT_PEAK_OVER_HELD * keep,
                  f"multirank {mode} rank {r}: init peaks at {uf['peak'] / 1e9:.3f} GB, over "
                  f"{INIT_PEAK_OVER_HELD} x the {keep / 1e9:.3f} GB it holds")
    for key, r, rk in ((k, r, rk) for k in ("x3", "fp64") for r, rk in enumerate(ranks)):
        w = rk["points"][key]["withheld"]  # (c) the withheld exec, at x3 and fp64
        tag = f"multirank bound {key} rank {r}"
        if w["withheld"]:
            say(f"[{tag}] withheld one exec; closed {w['closed']} after {w['close_s']:.2f} s")
            check(w["closed"] == "clean", f"{tag}: {w}")
            continue
        say(f"[{tag}] raised HaloTimeout at exec {w.get('attempt')} after "
            f"{w.get('s', float('nan')):.2f} s (bound {BOUND_TEST_S} s), C all NaN "
            f"{w.get('nan')}: {w['raised']}; closed ({w['close_s']:.2f} s): {w['closed']}")
        check(w["raised"] is not None and w["s"] <= BOUND_TEST_S + BOUND_SLACK_S and w["nan"]
              and w["closed"].startswith("raised HaloTimeout"), f"{tag}: {w}")
    x3 = ranks[0]["points"]["x3"]
    rec = record("spmm_halo", halo["launches"], halo["max_abs"], x3["kernel_ms"],
                 x3["plain_ms"], *x3["bound"], None, x3["library_ms"])
    rec.update(path="multirank", timing="time-shared: 4 processes on one card, rank 0, "
               "x3, flags in peer memory (no host barrier)",
               flag_launches=dict(zip(("wait", "signal", "done"), halo["flag_launches"])))
    return [rec] + multirank_crp_check([rk["crp"] for rk in ranks])


def multirank_crp_check(ranks) -> list:
    """multirank_crp's results against any_layout_path's one-device
    ``CrpSpmm`` on the same inputs: every rank's user C block equal to
    block r bit for bit (distributed A's to the global A's), the counters
    equal, the global C within x3's class, the main path's launches one a
    rank, the kernels within their plain versions' tolerance, each
    headline rank's init holding about a quarter of the one-device pack
    and peaking within INIT_PEAK_OVER_HELD of it.  Returns the records of
    #12, #4, #7 and #9 across the processes (``"path": "multirank_crp"``;
    rank 0's times, time-shared)."""
    records = []
    for tag, want_tag, kernel in (("auto", "auto", "spmm_halo"),
                                  ("dist A", "auto", "spmm_halo"),
                                  ("fine", "fine", "spmm_window"),
                                  ("cplaw", "cplaw", None)):
        if tag not in ranks[0]:
            say(f"[multirank crp {tag}] not driven across the processes: gloo here does "
                f"not carry its CUDA collective (see the probe)")
            continue
        want = _MEASURED.get(f"any crp {want_tag}")
        check(want is not None, f"multirank crp {tag}: no one-device run to compare with")
        kernel = kernel or want["kernel"]
        counters = want["counters"]
        if tag == "fine":  # across the processes the a2a, which gloo carries; C the same
            counters = dict(counters, physical_rows=want["a2a_rows"])
        for r, rk in enumerate(ranks):
            got = rk[tag]
            same = got["bits"] == want["bits"][r]
            keep = max(got["held"], got["packed"], 1)
            say(f"[multirank crp {tag} rank {r}] {got['stat']}: grid {got['grid']}, kind "
                f"{got['kind']}/{got['variant']}, main-path launches "
                f"{json.dumps(got['launches'])}; user C block {tuple(got['shape'])} "
                f"{'equal to the one-device engine bit for bit' if same else 'DIFFERS'}; "
                f"global C rel_fro_err {got['err']:.3e} (tol {TOL_REF['x3']:g}); counters "
                f"{'equal' if got['counters'] == counters else 'DIFFER'} "
                f"{json.dumps(got['counters'])}; rd_B / rd_C move {got['moved'][0]} / "
                f"{got['moved'][1]} elements over the ranks ({4e-6 * sum(got['moved']):.1f}"
                f" MB, exact splits); init device memory peak "
                f"{got['peak'] / 1e9:.3f} GB, held {got['held'] / 1e9:.3f} GB, packed "
                f"{got['packed'] / 1e9:.3f} GB ({got['peak'] / keep:.3f}x; one-device "
                f"pack {want['packed'] / 1e9:.3f} GB); exec {got['exec_ms']:.3f} ms "
                f"time-shared")
            check(same and got["counters"] == counters and got["finite"]
                  and got["err"] <= TOL_REF["x3"] and not got["aliased"]
                  and (got["kind"], got["variant"]) == (want["kind"], want["variant"]),
                  f"multirank crp {tag} rank {r}: {got}")
            expect = {kernel: 1, **({"spmm_spill": 1} if tag == "cplaw" else {})}
            check(got["launches"] == expect,
                  f"multirank crp {tag} rank {r}: main-path launches {got['launches']}")
            if got["main_moved"] is not None:  # #12: HaloPeers's host barriers, drains, flags
                check(got["main_moved"] == [0, 0, 1, 1, 1],
                      f"multirank crp {tag} rank {r}: HaloPeers across the main path "
                      f"{got['main_moved']}")
            if "b2b" in got:
                b2b = got["b2b"]
                replay = "equal to" if b2b["same"] else "DIFFERS from"
                say(f"[multirank crp {tag} rank {r}] back to back ({B2B_EXECS} execs over "
                    f"{len(B2B_SEEDS)} B, {b2b['wall_ms']:.1f} ms): HaloPeers host barriers "
                    f"{b2b['moved'][0]}, drains {b2b['moved'][1]}; user C block {replay} the "
                    f"ordered replay bit for bit ({b2b['distinct']} distinct); #12 vs plain "
                    f"rel fro err up to "
                    f"{max(b2b['plain']):.3e}")
                check(b2b["same"] and b2b["distinct"] == len(B2B_SEEDS)
                      and b2b["moved"][:2] == [0, 0] and max(b2b["plain"]) <= TOL_PLAIN_FRO,
                      f"multirank crp {tag} rank {r}: back to back {b2b}")
            check(got["peak"] <= INIT_PEAK_OVER_HELD * keep,
                  f"multirank crp {tag} rank {r}: init peaks at {got['peak'] / 1e9:.3f} GB, "
                  f"over {INIT_PEAK_OVER_HELD} x the {keep / 1e9:.3f} GB it holds")
            if tag in ("auto", "dist A"):  # the pack of panel r alone
                check(got["packed"] <= 0.26 * want["packed"],
                      f"multirank crp {tag} rank {r}: packed {got['packed']} of the "
                      f"one-device {want['packed']}")
        if tag == "dist A":
            continue
        parts = ([(kernel, [rk[tag] for rk in ranks])] if tag == "auto" else
                 [(kernel, [rk[tag]["kernels"] for rk in ranks])]
                 + ([("spmm_spill", [rk[tag]["kernels"]["spill"] for rk in ranks])]
                    if tag == "cplaw" else []))
        for name, per_rank in parts:
            worst = max(x["rel_fro"] for x in per_rank)
            r0 = per_rank[0]
            say(f"[multirank crp {tag}] {name} against its plain version on each rank's "
                f"inputs: rel fro err up to {worst:.3e}, max abs "
                f"{max(x['max_abs'] for x in per_rank):.3e}; rank 0 (time-shared, no "
                f"speed figure): {r0['kernel_ms']:.4f} ms, plain {r0['plain_ms']:.4f} "
                f"ms, library {r0['library_ms'] or float('nan'):.4f} ms, bound "
                f"{r0['bound'][0]:.4f} ms ({r0['bound'][1]})")
            check(worst <= TOL_PLAIN_FRO, f"multirank crp {tag}: {name} vs plain {worst}")
            rec = record(name, sum(rk[tag]["launches"].get(name, 0) for rk in ranks),
                         max(x["max_abs"] for x in per_rank), r0["kernel_ms"],
                         r0["plain_ms"], *r0["bound"], None, r0["library_ms"])
            rec.update(path="multirank_crp", timing="time-shared: 4 processes on one card, "
                       "rank 0, x3" + (", flags in peer memory (no host barrier)"
                                       if tag == "auto" else ""))
            records.append(rec)
    return records


def cplaw_p4(device) -> None:
    """cplaw in 4 row shards on the ring at x3: the fused kernel's plan
    refuses (windows over 16384 rows), and the multi-shard ragged pack with
    the fused spill serves it, with the JAX record's exchange volumes; then
    the p = 8 exchange plan against the planner on the host."""
    from crp_tpu_torch import csr_row_partition, plan_from_csr
    from crp_tpu_torch.comm.exchange import build_b_exchange

    a, b, c_ref = shared_case("cplaw")[:3]
    eng, op, _, launches = drive_p(a, b, c_ref, 4, "x3", device, "cplaw p=4",
                                   ("pallas", "ragged"), 1)
    check(op.roofline["spill_impl"] == "pallas" and launches["spmm_spill"] == 4,
          f"cplaw p=4: spill {op.roofline['spill_impl']!r}, "
          f"{launches['spmm_spill']} spill launches")
    check((eng.rB_recv_size, eng.physical_rows) == (CPLAW_P4_RECV, CPLAW_P4_RING_ROWS),
          f"cplaw p=4: rB_recv_size {eng.rB_recv_size}, ring rows "
          f"{eng.physical_rows}; the JAX record has {CPLAW_P4_RECV}, "
          f"{CPLAW_P4_RING_ROWS}")
    del eng, op
    a.__dict__.pop("_torch_pack_cache", None)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    d8 = csr_row_partition(a.rowptr, 8)
    bd = d8.copy()
    bd[-1] = a.ncol
    x8 = build_b_exchange([a.colidx[a.rowptr[d8[i]]:a.rowptr[d8[i + 1]]]
                           for i in range(8)], bd)
    comm = plan_from_csr(a, 32, 8).comm_cost
    say(f"[cplaw p=8, host] exchange plan {x8.total_recv_rows} rows x 32 = "
        f"{x8.total_recv_rows * 32}; planner comm_cost {comm} "
        f"({time.perf_counter() - t0:.2f} s)")
    check(x8.total_recv_rows * 32 == comm == CPLAW_P8_COMM_N32,
          f"cplaw p=8: {x8.total_recv_rows * 32} / {comm}, expected {CPLAW_P8_COMM_N32}")


def para2d_phase(device) -> None:
    """``Para2dSpmm``: the planner's grid on cplaw (n = 256, 4 ranks), then
    a forced 2 x 2 grid on the headline at x3."""
    from crp_tpu_torch import Para2dSpmm, Plan2D, SpmmConfig, csr_row_partition, plan_from_csr

    def run(case, plan, tag, expect):
        a, b, c_ref = shared_case(case)[:3]
        eng = Para2dSpmm(a, plan, device=device, dtype=np.float32,
                         config=SpmmConfig(kernel="auto", mxu_precision="x3"))
        op = eng._local_op
        launches, _, exec_ms, _ = main_path(eng, b, c_ref, TOL_REF["x3"], tag, (3, 5))
        head = eng.print_stat().splitlines()[:3]
        say(f"[{tag}] {plan.pm} x {plan.pn}: kind {eng.kernel_kind}, variant "
            f"{op.variant}, init {eng.t_init:.3f} s, rA_cost {eng.rA_cost}, "
            f"rB_recv_size {eng.rB_recv_size}; {' | '.join(head)}")
        check((eng.kernel_kind, op.variant) == expect
              and launches[op.kernel.__name__] >= plan.pn,
              f"{tag}: {eng.kernel_kind}/{op.variant}, launches {launches}")
        return eng

    a = shared_case("cplaw")[0]
    plan = plan_from_csr(a, N, 4)
    say(f"[para2d cplaw] planner: {plan.pm} x {plan.pn}, comm_cost {plan.comm_cost}")
    check((plan.pm, plan.pn) == (1, 4), f"para2d cplaw: planner grid {plan.pm} x {plan.pn}")
    eng = run("cplaw", plan, "para2d cplaw", ("pallas", "ragged"))
    check((eng.rA_cost, eng.rB_recv_size) == (CPLAW_2D_RA_COST, 0),
          f"para2d cplaw: rA_cost {eng.rA_cost}, rB_recv_size {eng.rB_recv_size}")
    del eng
    torch.cuda.empty_cache()

    a = shared_case("headline")[0]
    rb = csr_row_partition(a.rowptr, 4)
    plan = Plan2D(nproc=4, m=a.nrow, n=N, k=a.ncol, pm=2, pn=2, comm_cost=0,
                  A0_rowptr=rb, B_rowptr=rb[::2].copy(), AC_rowptr=rb[::2].copy(),
                  BC_colptr=np.array([0, N // 2, N]))
    run("headline", plan, "para2d headline forced", ("pallas_halo", "halo"))
    torch.cuda.empty_cache()


def digest(x) -> str:
    """A hash of a tensor's or an array's bytes, its shape and its type:
    equal digests, equal bits."""
    import hashlib

    x = np.ascontiguousarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)
    h = hashlib.blake2b(f"{x.dtype} {x.shape}".encode(), digest_size=16)
    h.update(x)
    return h.hexdigest()


def same_bits(x, y) -> bool:
    return (x.shape == y.shape and x.dtype == y.dtype
            and torch.equal(x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8)))


def index_add_sum(rows, cols, vals, b, nrow, step=None):
    """The segment sum as the port summed it before its order was fixed:
    ``index_add_`` of ``vals * B[cols]``, over chunks of ``step`` nonzeros
    (the chunked spill) or all at once (the ``segsum`` kind); timed beside
    the fixed-order sum, never on a path."""
    out = b.new_zeros((nrow + 1, b.shape[1]))
    step = step or rows.shape[0]
    for i in range(0, rows.shape[0], step):
        out.index_add_(0, rows[i : i + step].long(),
                       vals[i : i + step, None].to(b.dtype) * b[cols[i : i + step].long()])
    return out[:nrow]


def fixed_order(tag, rows, cols, vals, b, nrow, chunked) -> None:
    """The fixed-order segment sum (``spmm_segment_sum``) on one shard's
    arrays: two launches equal bit for bit, within the dtype's class of the
    same sum in fp64 (first ERR_COLS columns: TOL_REF["highest"], fp64
    TOL_DD) and within reordering of ``index_add_``'s sum
    (TOL_TRAIN_PLAIN_FRO, fp64 TOL_DD); both timed in turns.  Whether two
    ``index_add_`` launches agree, and how far that sum is from fp64, are
    printed."""
    from crp_tpu_torch.kernels.spmm_segsum import SEGSUM_BLOCK_BYTES, spmm_segment_sum

    step = max(1, SEGSUM_BLOCK_BYTES // (b.shape[1] * b.element_size())) if chunked else None
    run = lambda: spmm_segment_sum(rows, cols, vals, nrow, b)  # noqa: E731
    old = lambda: index_add_sum(rows, cols, vals, b, nrow, step)  # noqa: E731
    c1, c2, o1, o2 = run(), run(), old(), old()
    ref = index_add_sum(rows, cols, vals.double(), b[:, :ERR_COLS].double(), nrow, step)
    fro = lambda x, y: float((x.double() - y.double()).norm()  # noqa: E731
                             / max(float(y.double().norm()), 1e-300))
    f64 = b.dtype == torch.float64
    e_new, e_old, e_vs = fro(c1[:, :ERR_COLS], ref), fro(o1[:, :ERR_COLS], ref), fro(c1, o1)
    check(same_bits(c1, c2), f"{tag}: two launches of the fixed-order segment sum differ")
    check(e_new <= (TOL_DD if f64 else TOL_REF["highest"]),
          f"{tag}: the fixed-order sum against fp64: rel fro {e_new}")
    check(e_vs <= (TOL_DD if f64 else TOL_TRAIN_PLAIN_FRO),
          f"{tag}: the fixed-order sum against index_add_'s: rel fro {e_vs}")
    ms, old_ms, s = in_turns(run, old, plain_inner=3, kernel_inner=3)
    say(f"[{tag}] fixed-order segment sum {ms:.4f} ms ({s[0]:.4f}, {s[1]:.4f}), "
        f"index_add_ {old_ms:.4f} ms ({s[2]:.4f}, {s[3]:.4f}) "
        f"({'chunked' if chunked else 'at once'}); {rows.shape[0]} slots, n={b.shape[1]}, "
        f"{b.dtype}; two launches equal bit for bit (index_add_'s two "
        f"{'equal' if same_bits(o1, o2) else 'differ'}); rel fro err against the sum "
        f"in fp64 (first {ERR_COLS} columns) {e_new:.3e}, index_add_'s {e_old:.3e}; "
        f"against index_add_ {e_vs:.3e}")


def engine_csr(eng, a, i: int):
    """Shard ``i`` of the engine's matrix ``a`` (a ``RowParaSpmm`` shard or
    a ``Para2dSpmm`` row panel) as (CSR, its columns in the receive
    buffer's rows): cuSPARSE's operand for the same product."""
    displs = eng.plan.AC_rowptr if hasattr(eng, "plan") else eng.A_row_displs
    s = a.row_slice(int(displs[i]), int(displs[i + 1]))
    if eng._identity_exchange:
        return s, s.colidx
    return s, np.searchsorted(eng.xplan.rowmap[i], s.colidx)


def engine_record(eng, a, rB, tag, path, tol=TOL_TRAIN_PLAIN_FRO, prec="highest") -> dict:
    """Shard 0's gather kernel of ``eng`` (over ``a``) on the receive
    buffer ``rB``: within the class of the engine's point ``prec`` of the
    shard's fp64 product, bit for bit its order's emulation and a second
    launch, against its plain version (within ``tol``), timed, with its
    bound and cuSPARSE on the same shard.  The caller fills in the
    launches."""
    from crp_tpu_torch import CSRMatrix, rel_fro_err

    op = eng._local_op
    arrs = tuple(x[0] for x in eng.packed)
    s0, cols = engine_csr(eng, a, 0)
    ref = spmm_ref_f64(CSRMatrix(s0.nrow, rB.shape[0], s0.rowptr, cols, s0.val),
                       rB[:, :ERR_COLS].cpu().numpy())
    err = lambda c: rel_fro_err(  # noqa: E731
        ref, c[: s0.nrow, :ERR_COLS].cpu().numpy().astype(np.float64))
    args = op.kernel_args(arrs, rB)
    e_k, e_p = err(launch(op, args)), err(op.plain(*args))
    say(f"[{tag}] shard 0 against its fp64 product (first {ERR_COLS} columns): "
        f"spmm_gather {e_k:.3e} (tol {TOL_REF[prec]:g}), its plain version {e_p:.3e}")
    check(e_k <= TOL_REF[prec], f"{tag}: spmm_gather rel_fro_err {e_k}")
    gather_in_order(op, arrs, rB, tag)
    say(f"[{tag}] spmm_gather equals the emulation of its order and a second launch "
        f"bit for bit")
    got = time_kernel(op, arrs, rB, tag, prec, csr_work(s0), plain_inner=2, tol=tol)
    lib = csr_library_ms(s0.rowptr, cols, s0.val, rB.shape[0], rB)
    return dict(record("spmm_gather", 0, *got, lib), path=path)


def gcn_ops_check(ah, p, b, dc, refs, device):
    """The GCN's two ``DifferentiableSpmm`` ops at ``auto`` over p row
    blocks: every engine on ``gather`` (the gate's ragged cover keeps 22-23%
    of this graph's nonzeros; never ``segsum``); ``prop_h``'s C and dB
    (from ``dc``) within ``highest``'s class of the fp64 references
    ``refs`` on the first ERR_COLS columns, its kernels launched; each
    engine's kernel on shard 0 (``engine_record``).  Returns (model,
    records)."""
    from crp_tpu_torch import rel_fro_err
    from crp_tpu_torch.engine.autodiff import repad_rows, transposed
    from crp_tpu_torch.examples import gcn_train
    from crp_tpu_torch.shard.layout import shard_dense_rows

    tag = f"gcn p={p}"
    t0 = time.perf_counter()
    model, peak, held = measured_init(device, lambda: gcn_train.GCN(
        *gcn_train.gcn_ops(ah, p, GNN_CLASSES, N, "auto", device=device), ah.nrow,
        GNN_CLASSES, N))
    say(f"[{tag}] the GCN's ops at kernel='auto', highest: init {time.perf_counter() - t0:.3f} "
        f"s, device memory peak {peak / 1e9:.3f} GB, held {held / 1e9:.3f} GB")
    for name, op in (("prop_in", model.prop_in), ("prop_h", model.prop_h)):
        for side, eng in (("fwd", op.fwd), ("bwd", op.bwd)):
            say(f"[{tag}] {name}.{side}: kind {eng.kernel_kind}, variant "
                f"{eng._local_op.variant}, init {eng.t_init:.3f} s "
                f"{json.dumps(eng.init_breakdown)}, roofline "
                f"{json.dumps(getattr(eng._local_op, 'roofline', {}))}")
            check((eng.kernel_kind, eng._local_op.variant) == ("gather", "gather"),
                  f"{tag} {name}.{side}: resolved to {eng.kernel_kind!r}, expected gather")
    prop = model.prop_h
    bs = prop.shard_b(b).requires_grad_(True)
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    cs = prop(bs)
    dcs = torch.from_numpy(shard_dense_rows(dc, prop.fwd.A_row_displs,
                                            pad_rows=cs.shape[1])).to(device)
    (dbs,) = torch.autograd.grad(cs, bs, dcs)
    launches = {k.__name__: k.launches for k in kernels}
    say(f"[{tag}] launches in prop_h's forward and backward: {json.dumps(launches)}")
    check(launches["spmm_gather"] == 2 * p, f"{tag}: spmm_gather launched "
          f"{launches['spmm_gather']} times, expected {2 * p}")
    c, db = prop.unshard_c(cs), prop.unshard_db(dbs)
    for label, got, ref in (("C", c, refs[0]), ("dB", db, refs[1])):
        check(got.shape == (ref.shape[0], N) and bool(np.isfinite(got).all()),
              f"{tag} {label}: shape {got.shape} or non-finite values")
        err = rel_fro_err(ref, got[:, :ERR_COLS].astype(np.float64))
        say(f"[{tag}] prop_h {label} rel_fro_err vs fp64 reference (first {ERR_COLS} "
            f"columns) = {err:.3e} (tol {TOL_REF['highest']:g})")
        check(err <= TOL_REF["highest"], f"{tag} {label}: rel_fro_err {err}")
    records = [engine_record(eng, a, eng.receive_buffer(x)[0], f"{tag} {side}",
                             f"training: gcn p={p}, {side} shard 0, n={N}")
               for side, eng, a, x in (("A", prop.fwd, ah, bs.detach()),
                                       ("A^T", prop.bwd, transposed(ah),
                                        repad_rows(dcs, prop.bwd.max_k).contiguous()))]
    for r in records:
        r["launches"] = launches["spmm_gather"]
    del bs, cs, dcs, dbs
    return model, records


def gcn_training(model, device) -> dict:
    """Launches of one training step (the model's forward and backward),
    then ``gcn_train.train`` twice from one seed on the model's engines:
    losses equal bit for bit, the last below the first (kept for the
    ranks, ``_MEASURED["gcn losses"]``).  Returns the launches per step."""
    from crp_tpu_torch.examples import common, gcn_train

    x, labels = common.community_task(model.nodes, GNN_CLASSES)
    xs = model.prop_in.shard_b(x)
    ys = model.rows.take(labels, device)
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    common.loss(model, xs, ys).backward()
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    model.zero_grad(set_to_none=True)
    say(f"[gcn p=4 training] launches in one training step: {json.dumps(launches)}")
    # prop_in forward, prop_h forward and backward, on every shard
    check(launches["spmm_gather"] == 12, f"gcn training: spmm_gather launched "
          f"{launches['spmm_gather']} times in a step, expected 12")
    _MEASURED["gcn losses"] = train_runs("gcn p=4", lambda: gcn_train.train(
        model.nodes, GNN_CLASSES, N, TRAIN_STEPS, 4, "auto", device=device, model=model,
        log=say))
    return launches


def train_runs(tag, run) -> list:
    """``run()`` twice: the losses of the two runs finite and equal bit for
    bit, the last below the first; ms per step printed.  Returns the
    losses."""
    runs = [run() for _ in range(2)]
    losses = [r.losses for r in runs]
    say(f"[{tag} training] losses {losses[0]} and {losses[1]}; ms per step "
        f"{[round(1e3 * s, 4) for s in runs[0].step_s]} and "
        f"{[round(1e3 * s, 4) for s in runs[1].step_s]}; accuracy "
        f"{runs[0].accuracy:.3f}")
    check(all(np.isfinite(losses[0])), f"{tag}: non-finite loss")
    check(losses[0] == losses[1], f"{tag}: the two runs' losses differ")
    check(losses[0][-1] < losses[0][0], f"{tag}: the loss did not fall")
    return losses[0]


def gat_check(g, ah_gcn, dc, device) -> None:
    """The GAT at p = 4 on ``ValueParameterizedSpmm``: its graph A + I with
    A_hat's pattern (the ranks build it so); dvals from a seeded dC against
    an fp64 reference on a seeded sample of DVALS_SAMPLE nonzeros; the
    ``segsum`` kind's fixed-order sum on the fwd engine's shard 0; then
    ``gat_train.train`` twice from one seed (the losses kept for the
    ranks, ``_MEASURED["gat losses"]``)."""
    from crp_tpu_torch import rel_fro_err
    from crp_tpu_torch.examples import gat_train
    from crp_tpu_torch.shard.layout import shard_dense_rows

    t0 = time.perf_counter()
    ah = gat_train.pattern_with_self_loops(g)
    check(np.array_equal(ah.rowptr, ah_gcn.rowptr) and np.array_equal(ah.colidx, ah_gcn.colidx)
          and np.array_equal(ah.val, gat_graph(ah_gcn).val),
          "gat: A + I is not A_hat's pattern with values 1")
    model = gat_train.GAT(*gat_train.gat_ops(ah, 4, GNN_CLASSES, N, device=device),
                          ah.rowptr, GNN_CLASSES, N)
    vps = model.vps_h
    say(f"[gat p=4] A + I: {ah.nrow} rows, {ah.nnz} nnz; ops built in "
        f"{time.perf_counter() - t0:.3f} s (fwd init {vps.fwd.t_init:.3f} s, bwd "
        f"{vps.bwd.t_init:.3f} s), kinds {vps.fwd.kernel_kind} / {vps.bwd.kernel_kind}")
    rng = np.random.default_rng(8)
    b = rng.standard_normal((ah.ncol, N)).astype(np.float32)
    bs = vps.shard_b(b).requires_grad_(True)
    vals = torch.from_numpy(rng.standard_normal(ah.nnz).astype(np.float32)).to(device)
    vals.requires_grad_(True)
    cs = vps(bs, vals)
    dcs = torch.from_numpy(shard_dense_rows(dc, vps.fwd.A_row_displs,
                                            pad_rows=cs.shape[1])).to(device)
    _, dv = torch.autograd.grad(cs, (bs, vals), dcs)
    q = np.sort(rng.choice(ah.nnz, DVALS_SAMPLE, replace=False))
    rows = np.repeat(np.arange(ah.nrow), np.diff(ah.rowptr))[q]
    ref = np.sum(dc[rows].astype(np.float64) * b[ah.colidx[q]].astype(np.float64), 1)
    err = rel_fro_err(ref[None], dv.detach().cpu().numpy()[q][None].astype(np.float64))
    say(f"[gat p=4] dvals on {DVALS_SAMPLE} sampled nonzeros: rel_fro_err vs fp64 "
        f"reference {err:.3e} (tol {TOL_REF['highest']:g})")
    check(err <= TOL_REF["highest"], f"gat dvals: rel_fro_err {err}")
    fixed_order("gat p=4 segsum kind, shard 0", *(x[0] for x in vps.fwd.packed),
                vps.fwd.receive_buffer(bs.detach())[0], vps.fwd.max_m, chunked=False)
    del bs, vals, cs, dcs, dv
    _MEASURED["gat losses"] = train_runs("gat p=4", lambda: gat_train.train(
        model.nodes, GNN_CLASSES, N, TRAIN_STEPS, 4, device=device, model=model, log=say))


TRAIN_RANKS = 4
TRAIN_RANKS_TIMEOUT = 180  # s the training ranks may take before the phase fails


def gat_graph(ah):
    """The GAT's A + I from A_hat: its pattern with values 1 (what
    ``gat_train.pattern_with_self_loops`` gives the graph; gat_check
    checks it)."""
    from crp_tpu_torch.sparse.csr import CSRMatrix

    return CSRMatrix(ah.nrow, ah.ncol, ah.rowptr, ah.colidx, np.ones(ah.nnz))


def training_matrix(f, key):
    """The CSR matrix ``key`` of a training case file (``training_case``)."""
    from crp_tpu_torch.sparse.csr import CSRMatrix

    return CSRMatrix(*(int(x) for x in f[f"{key}_shape"]), f[f"{key}_rowptr"],
                     f[f"{key}_colidx"], f[f"{key}_val"])


def training_rank(rank, world, port, path, out) -> None:
    """One rank of the training rank set, a process of its own, as a user
    runs it: the launcher's env, ``init_distributed`` (gloo for the control
    plane: NCCL refuses several ranks on one card), ``make_mesh_1d``; the
    examples' graph read from the worker's file.  The GCN at p = 4 on the
    mesh, ``auto`` (``gather`` on every engine): one training step's
    launches (counts zeroed just before, read just after), #10 against its
    plain version on this rank's shard of ``prop_h.fwd`` (the main path's
    shapes) and timed, then ``gcn_train.train`` for TRAIN_STEPS steps; the
    GAT likewise on ``ValueParameterizedSpmm``.  Writes its losses, its
    weights' digests, its init's device memory, the launches and times
    (time-shared: four processes take turns on the one card) to ``out``."""
    import torch.distributed as dist

    from crp_tpu_torch import SpmmConfig, csr_row_partition
    from crp_tpu_torch.engine.autodiff import DifferentiableSpmm, transposed
    from crp_tpu_torch.engine.trainable import ValueParameterizedSpmm
    from crp_tpu_torch.examples import common, gat_train, gcn_train
    from crp_tpu_torch.shard.layout import init_distributed, make_mesh_1d

    t_start = time.perf_counter()
    torch.set_num_threads(RANK_THREADS)
    rank_env(rank, world, port)
    device = init_distributed(backend="gloo")
    mesh = make_mesh_1d(world)
    with np.load(path) as f:
        ah = training_matrix(f, "ah")
    got = dict(rank=rank, load_s=time.perf_counter() - t_start, marks=[])

    def mark(label):  # where a rank's seconds go
        got["marks"].append((label, round(time.perf_counter() - t_start, 2)))
    kernels = all_kernels()
    x, labels = common.community_task(ah.nrow, GNN_CLASSES)
    # the ops of gcn_ops / gat_ops, on the a2a: gloo carries all_to_all_single on
    # CUDA tensors, not the ring's send/recv (the one-device runs ring: the same bits)
    d = csr_row_partition(ah.rowptr, world)

    def ops(cls, a, kernel, widths):
        cfg = SpmmConfig(kernel=kernel, dtype="float32", rb_p2p=0)
        return [cls(a, d, d, w, config=cfg, mesh=mesh) for w in widths]

    t0 = time.perf_counter()
    model, peak, held = measured_init(device, lambda: gcn_train.GCN(
        *ops(DifferentiableSpmm, ah, "auto", (GNN_CLASSES, N)), ah.nrow, GNN_CLASSES, N))
    got["gcn"] = dict(init_s=time.perf_counter() - t0, peak=peak, held=held,
                      kinds=[(e.kernel_kind, e._local_op.variant) for op in model.engines
                             for e in (op.fwd, op.bwd)])
    mark("gcn init")
    xs = model.prop_in.shard_b(x)
    ys = model.rows.take(labels, device)
    for k in kernels:
        k.launches = 0
    common.loss(model, xs, ys).backward()  # the main path: one training step
    torch.cuda.synchronize(device)
    got["gcn"]["launches"] = {k.__name__: k.launches for k in kernels}
    model.zero_grad(set_to_none=True)
    mark("gcn step")
    eng = model.prop_h.fwd
    b = np.random.default_rng(8).standard_normal((ah.ncol, N)).astype(np.float32)
    rB = eng.receive_buffer(eng.shard_b(b))[0]  # the exchange: every rank joins
    op, arrs = eng._local_op, tuple(x[0] for x in eng.packed)
    args = op.kernel_args(arrs, rB)
    max_abs, _, rel_fro = compare("spmm_gather across ranks", lambda: launch(op, args),
                                  lambda: op.plain(*args))
    shard, cols = engine_csr(eng, ah, rank)
    got["gather"] = dict(
        max_abs=max_abs, rel_fro=rel_fro, rows=(int(eng.A_row_displs[rank]),
                                                int(eng.A_row_displs[rank + 1])),
        kernel_ms=rank_wall_ms(lambda: launch(op, args), device),
        plain_ms=rank_wall_ms(lambda: op.plain(*args), device, 3),
        bound=function_bound(op, csr_work(shard), N, torch.float32),
        design_ms=view_bound(args[-1], rB, op.M, with_c=False)[0],
        library_ms=csr_library_ms(shard.rowptr, cols, shard.val, rB.shape[0], rB))
    del rB, args
    mark("gather checked and timed")
    t0 = time.perf_counter()
    res = gcn_train.train(ah.nrow, GNN_CLASSES, N, TRAIN_STEPS, world, "auto", model=model,
                          mesh=mesh, log=None)
    got["gcn"].update(losses=res.losses, accuracy=res.accuracy, step_s=res.step_s,
                      train_s=time.perf_counter() - t0,
                      params={k: digest(w) for k, w in model.named_parameters()})
    mark("gcn trained")
    del model, res
    for a in (ah, transposed(ah)):
        a.__dict__.pop("_torch_pack_cache", None)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    gah = gat_graph(ah)
    model, peak, held = measured_init(device, lambda: gat_train.GAT(
        *ops(ValueParameterizedSpmm, gah, "segsum", (N, GNN_CLASSES)), gah.rowptr,
        GNN_CLASSES, N))
    mark("gat init")
    got["gat"] = dict(init_s=time.perf_counter() - t0, peak=peak, held=held,
                      kinds=[e.kernel_kind for op in model.engines for e in (op.fwd, op.bwd)])
    t0 = time.perf_counter()
    res = gat_train.train(ah.nrow, GNN_CLASSES, N, TRAIN_STEPS, world, model=model,
                          mesh=mesh, log=None)
    got["gat"].update(losses=res.losses, accuracy=res.accuracy, step_s=res.step_s,
                      train_s=time.perf_counter() - t0,
                      params={k: digest(w) for k, w in model.named_parameters()})
    mark("gat trained")
    got["total_s"] = time.perf_counter() - t_start
    dist.barrier()
    dist.destroy_process_group()
    with open(out, "w") as f:
        f.write(json.dumps(got))


def training_ranks(path) -> dict:
    """The training rank set: TRAIN_RANKS processes on the one card
    (``training_rank``), every rank's losses equal to the one-device p = 4
    runs' (gcn_training, gat_check) bit for bit and its weights to every
    other rank's, #10 launched 3 times a rank in a GCN step (``prop_in``
    forward, ``prop_h`` forward and backward), every engine on ``gather``
    (GCN) or ``segsum`` (GAT), each init's peak device memory within
    INIT_PEAK_OVER_HELD of what it holds.  Returns #10's record across
    processes: its main-path launches over the ranks, its largest
    difference from its plain version, rank 0's times (time-shared)."""
    import os
    import tempfile

    from crp_tpu_torch import native

    with tempfile.TemporaryDirectory(dir=native.BUILD_DIR) as tmp:
        outs = [f"{tmp}/train{r}.json" for r in range(TRAIN_RANKS)]
        t0 = time.perf_counter()
        run_rank_set(training_rank, TRAIN_RANKS, lambda r: (path, outs[r]),
                     TRAIN_RANKS_TIMEOUT, "training ranks")
        ranks = [json.loads(open(o).read()) for o in outs if os.path.exists(o)]
    say(f"[training ranks] {TRAIN_RANKS} ranks, one process each, on the one card: "
        f"{time.perf_counter() - t0:.1f} s from spawn to exit")
    check(len(ranks) == TRAIN_RANKS, "training ranks: a rank wrote no result")
    gather = dict(launches=0, max_abs=0.0)
    for model, kinds in (("gcn", [("gather", "gather")] * 4), ("gat", ["segsum"] * 4)):
        want = _MEASURED.get(f"{model} losses")
        for r, rk in enumerate(ranks):
            m = rk[model]
            tag = f"training ranks {model} rank {r}"
            same = want is not None and m["losses"] == want
            say(f"[{tag}] kinds {m['kinds']}; init {m['init_s']:.2f} s, device memory "
                f"peak {m['peak'] / 1e9:.3f} GB, held {m['held'] / 1e9:.3f} GB; losses "
                f"{m['losses']} "
                f"{'equal the one-device p = 4 run bit for bit' if same else 'DIFFER'} "
                f"(one device {want}); accuracy {m['accuracy']:.3f}; ms per step "
                f"{[round(1e3 * t, 3) for t in m['step_s']]} (time-shared, no speed figure), "
                f"train() {m['train_s']:.1f} s"
                + (f"; launches in one step {json.dumps(m['launches'])}"
                   if model == "gcn" else "")
                + f"; rank total {rk['total_s']:.1f} s (graph read {rk['load_s']:.1f} s)")
            check(same, f"{tag}: losses differ from the one-device p = 4 run's")
            check(m["params"] == ranks[0][model]["params"],
                  f"{tag}: weights differ from rank 0's")
            check([tuple(k) if isinstance(k, list) else k for k in m["kinds"]] == kinds,
                  f"{tag}: kinds {m['kinds']}")
            check(m["peak"] <= INIT_PEAK_OVER_HELD * max(m["held"], 1),
                  f"{tag}: init peaks at {m['peak'] / 1e9:.3f} GB, over "
                  f"{INIT_PEAK_OVER_HELD} x the {m['held'] / 1e9:.3f} GB it holds")
            if model == "gcn":
                launches = m["launches"]
                check(launches["spmm_gather"] == 3
                      and sum(launches.values()) == launches["spmm_gather"],
                      f"{tag}: launches in one step {launches}, expected spmm_gather 3")
                gather["launches"] += launches["spmm_gather"]
    say(f"[training ranks] rank 0's seconds from its start: {ranks[0]['marks']}")
    for r, rk in enumerate(ranks):
        g = rk["gather"]
        gather["max_abs"] = max(gather["max_abs"], g["max_abs"])
        say(f"[training ranks gather rank {r}] rows {g['rows']}, prop_h.fwd's spmm_gather "
            f"vs plain: rel fro err {g['rel_fro']:.3e} (tol {TOL_TRAIN_PLAIN_FRO:g}), max "
            f"abs {g['max_abs']:.3e}; time-shared: kernel {g['kernel_ms']:.4f} ms, plain "
            f"{g['plain_ms']:.4f} ms, cuSPARSE {g['library_ms']:.4f} ms, bound "
            f"{g['bound'][0]:.4f} ms ({g['bound'][1]}), design bound {g['design_ms']:.4f} ms")
        check(g["rel_fro"] <= TOL_TRAIN_PLAIN_FRO,
              f"training ranks rank {r}: spmm_gather vs plain rel fro err {g['rel_fro']}")
    g0 = ranks[0]["gather"]
    rec = record("spmm_gather", gather["launches"], gather["max_abs"], g0["kernel_ms"],
                 g0["plain_ms"], *g0["bound"], g0["design_ms"], g0["library_ms"])
    rec.update(path=f"training ranks: gcn p=4, prop_h.fwd, n={N}",
               timing="time-shared: 4 processes on one card, rank 0, highest, host "
               "sync included")
    return rec


def crp_drive(a, b, c_ref, tag, cfg, grid, kind, variant, device, *, dist=None,
              timing=(5, 20)):
    """``CrpSpmm`` at p = 4, x3, through the user's entry point with the
    reference driver's layouts (B in 4 row slabs, C in 4 column slabs;
    ``deprecated/examples/test_crpspmm.c``): the planner's grid (``grid``),
    the kind and the local op's variant, the init's device memory, every
    launch count set to 0 just before ``exec`` and read just after, C
    within x3's class of fp64, ``exec_device`` timed (``timing`` = reps,
    inner calls), the staged phases of three fenced execs.  ``dist``: A as
    a ``DistCSR`` in place of ``a``.  Returns (engine, launches, C, exec ms,
    user B blocks on the card)."""
    from crp_tpu_torch import CrpSpmm, SpmmConfig, rel_fro_err
    from crp_tpu_torch.shard.redist import BlockDist
    from crp_tpu_torch.utils.blocks import uniform_displs

    ub = BlockDist.from_grid(uniform_displs(a.ncol, 4), [0, N])
    uc = BlockDist.from_grid([0, a.nrow], uniform_displs(N, 4))
    eng, peak, held = measured_init(device, lambda: CrpSpmm(
        dist if dist is not None else a, N, ub, uc, nproc=4, device=device,
        dtype=np.float32, config=SpmmConfig(mxu_precision="x3", **cfg)))
    op = eng._local_op
    bp = eng.bplan
    say(f"[{tag}] CrpSpmm {cfg or 'auto'}: grid {eng.pm} x {eng.pn} (copy_B_size "
        f"{bp.copy_B_size}), kind {eng.kernel_kind}, variant {op.variant}, init "
        f"{eng.t_init:.3f} s; Redist B {eng.nelem_B_rd}, Alltoallv B {eng.nelem_B_a2av}, "
        f"necessary {eng.nelem_B_a2av_min}, Redist A {eng.nelem_A_rd}, Allgatherv A "
        f"{eng.nelem_A_agv}; physical exchanged rows {eng.physical_rows}")
    check((eng.pm, eng.pn) == grid and (eng.kernel_kind, op.variant) == (kind, variant),
          f"{tag}: grid {eng.pm} x {eng.pn}, {eng.kernel_kind}/{op.variant}, expected "
          f"{grid}, {kind}/{variant}")
    check_init_memory(tag, "x3", eng, peak, held)
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    c = eng.exec(b)
    launches = {k.__name__: k.launches for k in kernels}
    say(f"[{tag}] launches in the main-path exec: {json.dumps(launches)}")
    check(c.shape == (a.nrow, N) and bool(np.isfinite(c).all()),
          f"{tag}: output shape {c.shape} or non-finite values")
    err = rel_fro_err(c_ref, c[:, :ERR_COLS].astype(np.float64))
    say(f"[{tag}] rel_fro_err vs fp64 reference (first {ERR_COLS} columns) = {err:.3e} "
        f"(tol {TOL_REF['x3']:g})")
    check(err <= TOL_REF["x3"], f"{tag}: rel_fro_err {err}")
    bs = eng.rd_B.shard_src(b)
    exec_ms = time_ms(lambda: eng.exec_device(bs), *timing)
    eng.clear_stat()
    for _ in range(3):
        eng.exec(b)
    ph = {k: 1e3 * float(np.median(v)) for k, v in eng.timer.samples.items()
          if k in ("rd_B", "a2a_B", "spmm", "rd_C")}
    say(f"[{tag}] exec_device {exec_ms:.4f} ms/exec; staged phases (median of 3 "
        f"fenced execs) " + ", ".join(f"{k} {v:.4f} ms" for k, v in ph.items()))
    return eng, launches, c, exec_ms, bs


def ring_parts(eng, b) -> tuple:
    """ms of an overlapped engine's ring parts, each alone on the current
    stream, on column group 0's B slabs: the self part (``ring_spmm``
    with no shift) and the p - 1 shifts (gather, roll, fixed-order
    segment sum)."""
    from crp_tpu_torch.comm.exchange import ring_shift
    from crp_tpu_torch.comm.ring import _shift_partial, ring_spmm

    bj = eng._blocks(eng.rd_B.exec_device(eng.rd_B.shard_src(b)))[:, 0].contiguous()
    p, _, n = bj.shape
    flat = bj.reshape(-1, n)

    def shifts():
        return [_shift_partial(eng.ring, s, ring_shift(
            flat.index_select(0, send).view(p, eng.ring.S, n), s).reshape(-1, n))
            for s, send in enumerate(eng._ring_send, start=1)]

    return time_ms(lambda: ring_spmm(bj, eng.ring, [])), time_ms(shifts)


def crp_blocks(eng, bs) -> dict:
    """What multirank_path's ranks must equal of a one-device ``CrpSpmm``:
    each user C block's digest, the counters, the pack's bytes, the kind
    and variant, and the local kernel's name."""
    cs = eng.exec_device(bs)
    return dict(bits=[digest(cs[r]) for r in range(cs.shape[0])], counters=crp_counters(eng),
                packed=nbytes(*eng.packed), kind=eng.kernel_kind,
                variant=eng._local_op.variant, kernel=eng._local_op.kernel.__name__,
                a2a_rows=eng.xplan.physical_rows * eng.pn)


def same_tensors(xs, ys) -> bool:
    return len(xs) == len(ys) and all(same_bits(x, y) for x, y in zip(xs, ys))


def any_layout_path(device) -> list:
    """The any-layout engine, ``CrpSpmm``, at p = 4 (x3, n = 256), and
    ``bc_layout``: (a) the headline, ``auto`` -> the fused #12 on the
    planner's 4 x 1; (b) the same with ``a2a_b_finegrain=1`` -> #4 a panel
    on the exact rows; (c) with ``overlap=1`` -> the ring, #4 the self
    part, beside ``overlap=0, rb_p2p=1``; (d) cplaw on the planner's 1 x 4
    -> the ragged #7 and the spill #9 a slab, no B exchange; (e) A as a
    ``DistCSR``: ``CrpSpmm`` equal to (a) bit for bit, and
    ``Para2dSpmm.from_dist_a`` on the forced 2 x 2 equal to
    ``Para2dSpmm(a, plan)``; (f) ``RowParaSpmm(bc_layout=1)`` at p = 1
    (#1), C (n, m) the row-major C transposed bit for bit.  Returns the
    records of #12, #4, #7, #9 and #1 on this path (``"path":
    "any_layout"``)."""
    from crp_tpu_torch import (
        Para2dSpmm, Plan2D, RowParaSpmm, SpmmConfig, csr_row_partition,
    )
    from crp_tpu_torch.shard.dist_a import DistCSR
    from crp_tpu_torch.utils.blocks import uniform_displs

    a, b, c_ref = shared_case("headline")[:3]
    records = []
    # (a) the headline: auto -> #12 once an exec
    eng, launches, c_a, ms_a, bs = crp_drive(a, b, c_ref, "any headline", {},
                                             ANY_HEADLINE_GRID, "pallas_halo", "halo", device)
    _MEASURED["any crp auto"] = crp_blocks(eng, bs)
    check(eng.bplan.copy_B_size == ANY_HEADLINE_COPY_B and launches["spmm_halo"] == 1,
          f"any headline: copy_B_size {eng.bplan.copy_B_size}, spmm_halo launched "
          f"{launches['spmm_halo']} times")
    coarse = eng.nelem_B_a2av
    b4 = eng._blocks(eng.rd_B.exec_device(eng.rd_B.shard_src(b)))[:, 0].contiguous()
    got = time_kernel(eng._local_op, eng.packed, b4, "any headline fused", "x3",
                      csr_work(a), plain_inner=2)
    records.append(dict(record("spmm_halo", launches["spmm_halo"], *got,
                               cusparse_yardstick(a, b, c_ref, device, "any cusparse")),
                        path="any_layout"))
    # (e) A distributed over 4 uniform row blocks: the same panels and C
    d = DistCSR.from_global(a, uniform_displs(a.nrow, 4), device=device)
    eng_d, _, c_d, _, _ = crp_drive(a, b, c_ref, "any headline dist A", {},
                                    ANY_HEADLINE_GRID, "pallas_halo", "halo", device,
                                    dist=d, timing=(3, 5))
    same_c = np.array_equal(c_d.view(np.int32), c_a.view(np.int32))
    check(same_tensors(eng_d.packed, eng.packed) and same_c
          and (eng_d.nelem_A_rd, eng_d.nelem_A_agv) == (eng.nelem_A_rd, eng.nelem_A_agv),
          "any headline dist A: the panels or C differ from the global A's")
    say("[any headline dist A] panels and C equal the global A's bit for bit")
    del eng, eng_d, d, b4, bs
    torch.cuda.empty_cache()

    # (b) finegrain -> #4 a panel on the exact rows
    eng, launches, _, _, bs = crp_drive(a, b, c_ref, "any headline fine",
                                        dict(a2a_b_finegrain=1), ANY_HEADLINE_GRID,
                                        "pallas", "window", device)
    _MEASURED["any crp fine"] = crp_blocks(eng, bs)
    check(launches["spmm_window"] == 4 and eng.nelem_B_a2av == eng.nelem_B_a2av_min
          and coarse >= eng.nelem_B_a2av_min,
          f"any headline fine: {launches['spmm_window']} launches, Alltoallv B "
          f"{eng.nelem_B_a2av}, necessary {eng.nelem_B_a2av_min}, coarse {coarse}")
    rB = eng._exchange(eng._blocks(eng.rd_B.exec_device(eng.rd_B.shard_src(b))))[0, 0]
    s0 = a.row_slice(*(int(x) for x in eng.bplan.m_split_idx[:2]))
    got = time_kernel(eng._local_op, tuple(x[0] for x in eng.packed), rB,
                      "any headline fine", "x3", csr_work(s0), plain_inner=3)
    cols = np.searchsorted(eng.xplan.rowmap[0], s0.colidx)
    window = dict(record("spmm_window", launches["spmm_window"], *got,
                         csr_library_ms(s0.rowptr, cols, s0.val, rB.shape[0], rB)),
                  path="any_layout")
    records.append(window)
    del eng, rB, bs
    torch.cuda.empty_cache()

    # (c) overlap=1: the ring, #4 the self part on a side stream
    eng, launches, c_o, ms_o, bs = crp_drive(a, b, c_ref, "any headline overlap",
                                             dict(overlap=1), ANY_HEADLINE_GRID,
                                             "pallas", "window", device)
    check(launches["spmm_window"] == 4 and eng._side is not None,
          f"any headline overlap: {launches['spmm_window']} launches of spmm_window")
    window["launches"] += launches["spmm_window"]
    c1, c2 = eng.exec_device(bs), eng.exec_device(bs)
    check(same_bits(c1, c2), "any headline overlap: two execs differ")
    self_ms, shifts_ms = ring_parts(eng, b)
    say(f"[any headline overlap] alone on one stream: the self part {self_ms:.4f} ms, the "
        f"{eng.pm - 1} shifts {shifts_ms:.4f} ms ({sum(len(h[2]) for h in eng.ring.shifts)} "
        f"rows hit, {sum(len(h[0]) for h in eng.ring.shifts)} entries)")
    say(f"[any headline overlap] the self part on stream "
        f"{getattr(eng._side, 'cuda_stream', None)}, the shifts on the current stream "
        f"{torch.cuda.current_stream().cuda_stream}; two "
        f"execs equal bit for bit; {eng.physical_rows} ring rows")
    del eng, bs, c1, c2
    torch.cuda.empty_cache()
    eng, _, c_r, ms_r, _ = crp_drive(a, b, c_ref, "any headline ring",
                                     dict(kernel="pallas", rb_p2p=1), ANY_HEADLINE_GRID,
                                     "pallas", "window", device)
    diff = float(np.abs(c_o.astype(np.float64) - c_r).max())
    say(f"[any headline overlap] overlap=1 {ms_o:.4f} ms against overlap=0, rb_p2p=1 "
        f"{ms_r:.4f} ms ({ms_r / ms_o:.3f}x), fused #12 {ms_a:.4f} ms; max |C_overlap - "
        f"C_ring| {diff:.3e}")
    del eng
    a.__dict__.pop("_torch_pack_cache", None)
    torch.cuda.empty_cache()

    # (d) cplaw on the planner's 1 x 4: the ragged #7 and the spill #9 a slab
    ac, bc, cc_ref = shared_case("cplaw")[:3]
    eng, launches, _, _, bs = crp_drive(ac, bc, cc_ref, "any cplaw", {}, ANY_CPLAW_GRID,
                                        "pallas", "ragged", device, timing=(3, 5))
    _MEASURED["any crp cplaw"] = crp_blocks(eng, bs)
    op = eng._local_op
    check(launches[op.kernel.__name__] == 4 and launches["spmm_spill"] == 4
          and eng.nelem_B_a2av == 0 and op.roofline["spill_impl"] == "pallas",
          f"any cplaw: launches {launches}, Alltoallv B {eng.nelem_B_a2av}")
    rB = eng._exchange(eng._blocks(eng.rd_B.exec_device(eng.rd_B.shard_src(bc))))[0, 0]
    arrs = tuple(x[0] for x in eng.packed)
    lib = csr_library_ms(ac.rowptr, ac.colidx - int(eng.xplan.rowmap[0]), ac.val,
                         rB.shape[0], rB)
    got = time_kernel(op, arrs, rB, "any cplaw", "x3", csr_work(ac), plain_inner=2)
    records.append(dict(record(op.kernel.__name__, launches[op.kernel.__name__], *got, lib),
                        path="any_layout"))
    s_abs, _, s_fro = spill_vs_plain(op, arrs, rB)
    check(s_fro <= TOL_PLAIN_FRO, f"any cplaw: spmm_spill vs plain rel fro err {s_fro}")
    spill_in_order(op, arrs, rB, "any cplaw")
    args = op.spill_args(arrs, op.kernel(*op.kernel_args(arrs, rB),
                                         min_b_rows=op.min_b_rows), rB)
    s_ms, s_plain, _ = in_turns(lambda: op.spill_kernel(*args),
                                lambda: op.spill_plain(*args), 3)
    s_bound = view_bound(args[-1], rB, args[0].shape[0], with_c=True)
    say(f"[any cplaw] spmm_spill at n={rB.shape[1]}: {s_ms:.4f} ms, plain {s_plain:.4f} "
        f"ms, rel fro err {s_fro:.3e}; bit for bit its order's emulation")
    records.append(dict(record("spmm_spill", launches["spmm_spill"], s_abs, s_ms, s_plain,
                               *s_bound, s_bound[0], spill_library_ms(op, arrs, args[0], rB)),
                        path="any_layout"))
    del eng, op, rB, arrs, args, bs
    ac.__dict__.pop("_torch_pack_cache", None)
    torch.cuda.empty_cache()

    # (e) Para2dSpmm from distributed A on the forced 2 x 2 headline plan
    rb = csr_row_partition(a.rowptr, 4)
    plan = Plan2D(nproc=4, m=a.nrow, n=N, k=a.ncol, pm=2, pn=2, comm_cost=0,
                  A0_rowptr=rb, B_rowptr=rb[::2].copy(), AC_rowptr=rb[::2].copy(),
                  BC_colptr=np.array([0, N // 2, N]))
    cfg = SpmmConfig(mxu_precision="x3")
    eng_d = Para2dSpmm.from_dist_a(DistCSR.from_global(a, rb, device=device), plan,
                                   device=device, dtype=np.float32, config=cfg)
    c_d = eng_d.exec(b)
    eng_g = Para2dSpmm(a, plan, device=device, dtype=np.float32, config=cfg)
    c_g = eng_g.exec(b)
    check(eng_d.kernel_kind == "pallas_halo" and np.array_equal(c_d.view(np.int32),
                                                                c_g.view(np.int32))
          and same_tensors(eng_d.packed, eng_g.packed)
          and (eng_d.rA_cost, eng_d.rB_recv_size) == (eng_g.rA_cost, eng_g.rB_recv_size),
          "para2d from_dist_a: differs from Para2dSpmm(a, plan)")
    say(f"[any para2d dist A] 2 x 2 from_dist_a: {eng_d.kernel_kind}, init "
        f"{eng_d.t_init:.3f} s (global A {eng_g.t_init:.3f} s), rA_cost {eng_d.rA_cost}; "
        f"panels and C equal Para2dSpmm(a, plan)'s bit for bit")
    del eng_d, eng_g
    a.__dict__.pop("_torch_pack_cache", None)
    torch.cuda.empty_cache()

    # (f) bc_layout=1 at p = 1: #1, C (n, m) the row-major C transposed
    displs = csr_row_partition(a.rowptr, 1)
    cfg = dict(kernel="auto", mxu_precision="x3")
    eng = RowParaSpmm(a, displs, displs, N, device=device, dtype=np.float32,
                      config=SpmmConfig(bc_layout=1, **cfg))
    op = eng._local_op
    bt = np.ascontiguousarray(b.T)
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    c_t = eng.exec(bt)
    n1 = op.kernel.launches
    row = RowParaSpmm(a, displs, displs, N, device=device, dtype=np.float32,
                      config=SpmmConfig(**cfg))
    c_row = row.exec(b)
    check(op.variant == "uniform" and n1 == 1 and c_t.shape == (N, a.nrow)
          and np.array_equal(c_t.view(np.int32), np.ascontiguousarray(c_row.T).view(np.int32)),
          f"bc_layout: variant {op.variant}, {n1} launches of {op.kernel.__name__}, C "
          f"{c_t.shape} not the "
          f"row-major C transposed")
    slabs = torch.from_numpy(bt).to(device)[None]
    t_b = time_ms(lambda: slabs.transpose(1, 2).contiguous())
    cs = eng.exec_device(eng.shard_b(bt))
    t_c = time_ms(lambda: cs.transpose(1, 2).contiguous())
    say(f"[any bc_layout] p=1: C (n, m) equals the row-major C transposed bit for bit; "
        f"the device transposes of B {t_b:.4f} ms and of C {t_c:.4f} ms; #1 launched "
        f"{n1} time in the main-path exec")
    rB = eng.receive_buffer(eng.shard_b(bt))[0]
    got = time_kernel(op, tuple(x[0] for x in eng.packed), rB, "any bc_layout", "x3",
                      csr_work(a), plain_inner=2)
    records.append(dict(record(op.kernel.__name__, n1, *got, records[0]["library_ms"]),
                        path="any_layout"))
    del eng, row, op, rB, cs, slabs
    a.__dict__.pop("_torch_pack_cache", None)
    torch.cuda.empty_cache()
    return records


def training_inputs(ah) -> tuple:
    """(B, dC) of the training path's op checks: the analytic B and a
    seeded normal dC, N columns, fp32."""
    from crp_tpu_torch import fill_b

    return (np.asarray(fill_b(0, ah.ncol, 0, N, dtype=np.float32)),
            np.random.default_rng(7).standard_normal((ah.nrow, N)).astype(np.float32))


def training_case(directory=None) -> tuple:
    """(the examples' graph, A_hat, the fp64 references of A_hat @ B and
    A_hat^T @ dC on the first ERR_COLS columns, host s): the training
    path's host set-up.  ``main`` runs it in the worker process while the
    card runs the p = 4 phases, with ``directory``: the arrays then go to a
    file there whose path comes back in their place."""
    from crp_tpu_torch.engine.autodiff import transposed
    from crp_tpu_torch.examples import gcn_train
    from crp_tpu_torch.examples.common import community_graph

    t0 = time.perf_counter()
    g = community_graph(GNN_NODES, GNN_CLASSES)
    ah = gcn_train.normalized_adjacency(g)
    b, dc = training_inputs(ah)
    refs = (spmm_ref_f64(ah, b[:, :ERR_COLS]),
            spmm_ref_f64(transposed(ah), dc[:, :ERR_COLS]))
    t_host = time.perf_counter() - t0
    if directory is None:
        return g, ah, refs, t_host
    return write_training(directory / "training.npz", g, ah, refs), None, None, t_host


def write_training(path, g, ah, refs):
    """The training case's arrays to the file ``path`` (``training_matrix``
    reads them); returns ``path``."""
    np.savez(path, ref_b=refs[0], ref_dc=refs[1], **{
        f"{k}_{f}": getattr(x, f) if f != "shape" else (x.nrow, x.ncol)
        for k, x in (("g", g), ("ah", ah)) for f in ("shape", "rowptr", "colidx", "val")})
    return path


def training_path(device) -> list:
    """Training through the engines at full width: the examples' graph at
    the cplaw class's rows (``powerlaw_community_csr(786432, 8, 98304,
    seed=5)`` with self-loops), 8 classes, hidden n = 256; the GCN's ops
    at p = 1 and p = 4 (``gcn_ops_check``), its training at p = 4
    (``gcn_training``), the GAT's (``gat_check``), then both across 4
    processes (``training_ranks``, the graph read from the worker's
    file).  Returns the records of the GCN engines' gather kernel, with its
    launches in the p = 1 op check, in one p = 4 training step, and over
    the ranks in one step."""
    import os
    import tempfile

    from crp_tpu_torch import native
    from crp_tpu_torch.engine.autodiff import transposed
    from crp_tpu_torch.sparse.csr import CSRMatrix

    t0 = time.perf_counter()
    g, ah, refs, t_host = host_job("training graph", training_case)
    tmp = tempfile.TemporaryDirectory(dir=native.BUILD_DIR)
    if isinstance(g, CSRMatrix):  # made here (the phase run alone): a file for the ranks
        path = write_training(os.path.join(tmp.name, "training.npz"), g, ah, refs)
    else:  # made in the worker: its file, which the ranks read too
        path = g
        with np.load(path) as f:
            g, ah = (training_matrix(f, k) for k in ("g", "ah"))
            refs = (f["ref_b"], f["ref_dc"])
    b, dc = training_inputs(ah)
    say(f"training graph: A_hat {ah.nrow} rows, {ah.nnz} nnz, n={N}, host set-up "
        f"{t_host:.2f} s (the graph and the references), here "
        f"{time.perf_counter() - t0:.2f} s")

    def drop_packs():
        for x in (ah, transposed(ah)):
            x.__dict__.pop("_torch_pack_cache", None)
        torch.cuda.empty_cache()

    model, records = gcn_ops_check(ah, 1, b, dc, refs, device)
    del model
    drop_packs()
    model, recs = gcn_ops_check(ah, 4, b, dc, refs, device)
    step = gcn_training(model, device)
    for r in recs:
        r["launches"] = step["spmm_gather"]
    del model
    drop_packs()
    gat_check(g, ah, dc, device)
    drop_packs()
    t1 = time.perf_counter()
    try:
        ranks = training_ranks(path)
    finally:
        if os.path.exists(path):
            os.unlink(path)
        tmp.cleanup()
    say(f"[time] training ranks: {time.perf_counter() - t1:.1f} s")
    return records + recs + [ranks]


# the drivers path: the headline and cplaw as the drivers name them
DRIVERS_HEADLINE = f"synth:banded:{NROW}:{NNZ_PER_ROW}:{BANDWIDTH}"
DRIVERS_CPLAW = "synth:cplaw:{n}:{avg_degree}:{comm_size}".format(**CPLAW)
# the 2D planner's grid and comm_cost for each n of the vary_n sweep on 8
# devices: the host decisions of the TPU record bench_results/r2_tpu_vary_n.jsonl
VARY_N_PLAN = {16: (8, 1, 538416), 64: (8, 1, 2153664), 256: (8, 1, 8614656),
               1024: (4, 2, 31918177), 2048: (4, 2, 46691425)}
# the sweep's execs, each checked against the fp64 product on the host; n =
# 1024 and 2048 run no exec (the smoke's time, and an fp64 host check there
# takes too long): their planner rows come from the worker process
# (drivers_host), the same plan_from_csr
VARY_N_NS = (16, 64, 256)
VARY_N_HOST = (1024, 2048)
# cplaw's ragged pack at x3, (S, spill nnz): the TPU record's kernel_detail
# (bench_results/r5_tpu_spill_fused.jsonl)
CPLAW_X3_DETAIL = (12322, 2054574)
LINK_GBPS = 450.0  # H100 SXM NVLink 4 data sheet, per direction (one card: unmeasured)
HBM_COPY_BYTES = 1 << 31  # the device copy that measures the projection's HBM rate
DRIVERS_KERNELS = ("spmm_window_sg_presplit", "spmm_halo", "spmm_ragged_presplit",
                   "spmm_spill")


class _Captured:
    """A stand-in for ``sys.stdout`` that keeps what a driver prints."""

    def __init__(self) -> None:
        self.parts = []

    def write(self, text) -> int:
        self.parts.append(text)
        return len(text)

    def flush(self) -> None:
        pass

    def text(self) -> str:
        return "".join(self.parts)


def captured(main, argv) -> str:
    """What ``main(argv)`` prints; fails unless it returns 0 (its output
    is printed where it raises or fails)."""
    out, old = _Captured(), sys.stdout
    sys.stdout = out
    try:
        rc = main(argv)
    except BaseException:
        sys.stdout = old
        say(out.text())
        raise
    sys.stdout = old
    check(rc == 0, f"{main.__module__} {' '.join(argv)}: exit code {rc}\n{out.text()}")
    return out.text()


def run_driver(main, argv) -> tuple:
    """(printed text, launches) of one driver run through its ``main``:
    every launch count set to 0 just before and read just after."""
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    text = captured(main, argv)
    return text, {k.__name__: k.launches for k in kernels}


def json_lines(text) -> list:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def projection_rates(device) -> dict:
    """The projection's rates from this run: each tensor rate from its
    headline kernel's design bound over its time (per pass, at the peak of
    its type), the spill's from #9 on cplaw at x3 over its spilled nnz, HBM
    from a device copy of HBM_COPY_BYTES (read and write counted), the
    link from the data sheet; ``plan.project.DEFAULT_RATES`` where this
    run has no such record (the phase run alone)."""
    from crp_tpu_torch.plan.project import DEFAULT_RATES

    rates = dict(DEFAULT_RATES, link_gbps=LINK_GBPS)
    for key, prec, peak in (("x3_tflops", "x3", "bf16"), ("default_tflops", "default", "bf16"),
                            ("highest_tflops", "highest", "tf32")):
        r = _MEASURED.get(f"rates {prec}")  # the headline's record at prec
        if r is not None:
            rates[key] = PEAK[peak] / 1e12 * r["design_bound_ms"] / r["ms"]
    spill = _MEASURED.get("rates spill")  # #9 on cplaw at x3 (cplaw_path)
    if spill is not None:
        rates["spill_ns"] = spill["ms"] * 1e6 / spill["spill_nnz"]
    x = torch.empty(HBM_COPY_BYTES // 4, dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    copy_ms = time_ms(lambda: y.copy_(x), reps=5, inner=5)
    rates["hbm_gbps"] = 2 * HBM_COPY_BYTES / (copy_ms * 1e-3) / 1e9
    del x, y
    torch.cuda.empty_cache()
    say(f"[drivers] projection rates from this run: {json.dumps(rates)} (tensor rates "
        f"per pass from #1, #2, #3 on the headline, spill from #9 on cplaw; HBM: a "
        f"{HBM_COPY_BYTES >> 30} GiB device copy in {copy_ms:.4f} ms; link: data sheet)"
        + ("" if _MEASURED else "; earlier phases did not run: tensor and spill rates "
           "are plan.project's defaults"))
    return rates


def drivers_host(rate_argv) -> dict:
    """The host half of :func:`drivers_path`: ``project_cli`` on the
    headline and cplaw at p = 1, 4, 8, 16 (x3, n = N, the card's rates
    ``rate_argv``), the 2D planner's grid for the headline at each n of
    VARY_N_HOST on 8 devices, and a ``.mtx`` round trip of the headline
    (``write_mtx`` into the build directory, read back by scipy's reader,
    the default, and by the native one, the file removed after)."""
    from crp_tpu_torch import native, plan_from_csr
    from crp_tpu_torch.cli import project_cli
    from crp_tpu_torch.cli.plan_cli import load_matrix
    from crp_tpu_torch.sparse.mmio import mm_read_sparse, write_mtx

    out = {}
    for tag, spec in (("headline", DRIVERS_HEADLINE), ("cplaw", DRIVERS_CPLAW)):
        t0 = time.perf_counter()
        text = captured(project_cli.main, [spec, str(N), "--procs=1,4,8,16", "--prec=x3",
                                           *rate_argv])
        out[tag] = (json_lines(text), time.perf_counter() - t0)
    a = load_matrix(DRIVERS_HEADLINE)
    out["plan"] = {}
    for n in VARY_N_HOST:
        pl = plan_from_csr(a, n, 8)
        out["plan"][n] = (pl.pm, pl.pn, int(pl.comm_cost))
    native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = native.BUILD_DIR / "drivers_headline.mtx"
    t0 = time.perf_counter()
    write_mtx(str(path), a)
    t_write = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        asp = mm_read_sparse(str(path))
        t_scipy = time.perf_counter() - t0
        t0 = time.perf_counter()
        an = mm_read_sparse(str(path), backend="native")
        t_native = time.perf_counter() - t0
        size = path.stat().st_size
    finally:
        path.unlink(missing_ok=True)
    same = lambda x, y, f: np.array_equal(getattr(x, f), getattr(y, f))  # noqa: E731
    out["mtx"] = dict(
        bytes=size, nnz=a.nnz, write_s=t_write, native_s=t_native, scipy_s=t_scipy,
        backend=an.backend, scipy_backend=asp.backend,
        native_equals_scipy=all(same(an, asp, f) for f in ("rowptr", "colidx", "val")),
        structure_equals_written=same(asp, a, "rowptr") and same(asp, a, "colidx"),
        values_equal_written=same(asp, a, "val"),
    )
    return out


def short(name) -> str:
    """A kernel's demangled name without its return type, its anonymous
    namespace and its argument list."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            return name[:i]
    return name


def trace_windows(path) -> list:
    """(label, kernel ms, span ms, {kernel: ms}) of each ``suite_cli timed``
    range of a ``torch.profiler`` Chrome trace: the device time of the
    kernels that start in the range (in all and by kernel, its name cut
    before its arguments), and the range's host span."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    out = []
    for w in events:
        if w.get("cat") != "user_annotation" or not str(w.get("name", "")).startswith(
                "suite_cli timed"):
            continue
        t0, t1 = w["ts"], w["ts"] + w["dur"]
        by_name = {}
        for k in kernels:
            if t0 <= k["ts"] < t1:
                by_name[short(k["name"])] = by_name.get(short(k["name"]), 0.0) + k["dur"] / 1e3
        out.append((w["name"], sum(by_name.values()), w["dur"] / 1e3,
                    dict(sorted(by_name.items(), key=lambda kv: -kv[1]))))
    return out


def drivers_path(device) -> list:
    """The drivers at full width through their ``main(argv)``, x3: (1)
    ``bench_cli`` on the headline at p = 1 (#1) and (2) with
    ``--engine=crp --devices=4`` (the fused #12 on the v1 planner's 4 x 1);
    (3) the ``suite_cli`` vary_n sweep on the headline, n = 16, 64, 256
    (n = 1024 and 2048 planner rows alone), with the 2D planner's grid for
    8 devices equal to the TPU record's; (4) the ``kernels`` sweep on cplaw
    (``pallas`` -> the ragged #7 with the spill #9) under ``--trace``, the
    trace's kernel time against its span; (5) in the worker process,
    ``project_cli`` at the card's rates from this run and a ``.mtx`` round
    trip of the headline.  Returns the records of #1, #12, #7 and #9 with
    their launches here (``"path": "drivers"``), their other numbers those
    measured for the same kernel on the same inputs earlier in this run
    (``"measured_in"``)."""
    from crp_tpu_torch import native
    from crp_tpu_torch.cli import bench_cli, suite_cli

    rates = projection_rates(device)
    rate_argv = [f"--{k.replace('_', '-')}={v!r}" for k, v in rates.items()]
    start_host_job("drivers", drivers_host, rate_argv)
    launches = dict.fromkeys(DRIVERS_KERNELS, 0)

    def add(got):
        for k in launches:
            launches[k] += got[k]

    # (1), (2) bench_cli at p = 1 and p = 4
    for tag, extra, kernel in (("p1", ["--engine=rowpara", "--devices=1"],
                                "spmm_window_sg_presplit"),
                               ("p4", ["--engine=crp", "--devices=4"], "spmm_halo")):
        t0 = time.perf_counter()
        text, got = run_driver(bench_cli.main, [DRIVERS_HEADLINE, str(N), "3", "0", "1",
                                                *extra, "--prec=x3", "--dtype=float32"])
        lines = text.splitlines()
        secs = [float(x) for x in lines if x.replace(".", "", 1).isdigit()]
        err = float(lines[-1].split("=")[-1])
        grid = next(x for x in lines if x.startswith("2D process grid"))
        fired = {k: v for k, v in got.items() if v}
        last = max(i for i, x in enumerate(lines) if x.replace(".", "", 1).isdigit())
        stat = [" ".join(x.split()) for x in lines[last + 1:-1]
                if any(c.isdigit() for c in x)]
        say(f"[drivers bench {tag}] {' '.join(extra)}: {grid}; s/exec {secs}; "
            f"{lines[-1]}; launches {json.dumps(fired)}; {time.perf_counter() - t0:.1f} s; "
            f"print_stat: {' | '.join(stat)}")
        # 1 warm-up and 3 timed execs, one launch each: the 4 x 1 grid runs
        # one column group (a launch of #12 an exec)
        check(fired == {kernel: 4}, f"drivers bench {tag}: launches {fired}, expected "
              f"{kernel} 4 times")
        check(err <= TOL_REF["x3"] and len(secs) == 3,
              f"drivers bench {tag}: error {err}, {len(secs)} timed execs")
        if tag == "p4":
            vol = {"necessary" if "necessary" in x else "all": int(x.split()[-1])
                   for x in lines if x.startswith("Alltoallv B")}
            say(f"[drivers bench p4] Alltoallv B {vol['all']}, necessary "
                f"{vol['necessary']}")
            check(vol["necessary"] <= vol["all"], f"drivers bench p4: volumes {vol}")
        add(got)

    # (3) the vary_n sweep on the headline
    t0 = time.perf_counter()
    text, got = run_driver(suite_cli.main, [
        "vary_n", DRIVERS_HEADLINE, "1", "--engine=rowpara", "--plan-procs=8",
        "--dtype=float32", "--prec=x3", f"--ns={','.join(map(str, VARY_N_NS))}",
        "--check=1"])
    vary = json_lines(text)
    fired = {k: v for k, v in got.items() if v}
    say(f"[drivers vary_n] ns={list(VARY_N_NS)}, checked: launches {json.dumps(fired)}; "
        f"{time.perf_counter() - t0:.1f} s")
    check(list(fired) == ["spmm_window_sg_presplit"], f"drivers vary_n: launches {fired}")
    for r in vary:
        check("error" not in r, f"drivers vary_n: {r}")
        pl = r["planner"]
        say(f"[drivers vary_n] n={r['n']}: {r['kernel_resolved']}/"
            f"{r['kernel_detail']['variant']}, exec_s min {r['exec_s']['min'] * 1e3:.4f} "
            f"ms (avg {r['exec_s']['avg'] * 1e3:.4f}), {r['gflops']} GFLOP/s, roofline "
            f"{json.dumps(r['roofline'])}, planner {pl['pm']} x {pl['pn']} comm_cost "
            f"{pl['comm_cost']}, rel_fro_err {r['rel_fro_err']}")
        check((pl["nproc"], pl["pm"], pl["pn"], pl["comm_cost"])
              == (8, *VARY_N_PLAN[r["n"]]),
              f"drivers vary_n n={r['n']}: planner {pl}, the TPU record's "
              f"{VARY_N_PLAN[r['n']]}")
        check((r["kernel_resolved"], r["kernel_detail"]["variant"])
              == ("pallas", "uniform"), f"drivers vary_n: {r['kernel_resolved']}")
        check(r["rel_fro_err"] <= TOL_REF["x3"],
              f"drivers vary_n n={r['n']}: rel_fro_err {r['rel_fro_err']}")
    add(got)
    check([r["n"] for r in vary] + list(VARY_N_HOST) == sorted(VARY_N_PLAN),
          f"drivers vary_n: {[r['n'] for r in vary]}")

    # (4) the kernels sweep on cplaw, traced
    trace_dir = native.BUILD_DIR / "drivers_trace"
    t0 = time.perf_counter()
    text, got = run_driver(suite_cli.main, [
        "kernels", DRIVERS_CPLAW, str(N), "1", "--engine=rowpara", "--list=pallas",
        "--dtype=float32", "--prec=x3", f"--trace={trace_dir}"])
    recs = json_lines(text)
    fired = {k: v for k, v in got.items() if v}
    say(f"[drivers kernels] cplaw: launches {json.dumps(fired)}; "
        f"{time.perf_counter() - t0:.1f} s")
    for r in recs:
        check("error" not in r, f"drivers kernels: {r}")
        say(f"[drivers kernels] {r['kernel']}: {r['kernel_resolved']}, detail "
            f"{json.dumps(r['kernel_detail'])}, exec_s min {r['exec_s']['min'] * 1e3:.4f} "
            f"ms (avg {r['exec_s']['avg'] * 1e3:.4f}, traced), rel_fro_err "
            f"{r['rel_fro_err']:.3e}")
        check(r["rel_fro_err"] <= TOL_REF["x3"], f"drivers kernels {r['kernel']}: "
              f"rel_fro_err {r['rel_fro_err']}")
    (rp,) = recs
    dp = rp["kernel_detail"]
    check((rp["kernel_resolved"], dp["variant"], dp["S"], dp["spill_nnz"])
          == ("pallas", "ragged", *CPLAW_X3_DETAIL),
          f"drivers kernels: {rp['kernel_resolved']} {dp}")
    check(list(fired) == list(DRIVERS_KERNELS[2:]), f"drivers kernels: launches {fired}")
    add(got)
    trace = trace_dir / "suite_trace.json"
    wins = trace_windows(trace)
    say(f"[drivers trace] {trace.stat().st_size / 1e6:.1f} MB Chrome trace")
    bodies = {"pallas": ("x3_wgmma_kernel", "spill_rows_kernel<true")}
    check(len(wins) == 1, f"drivers trace: {len(wins)} timed ranges")
    for (label, k_ms, span_ms, names), r in zip(wins, recs):
        execs = 3 * r["inner"]
        say(f"[drivers trace] {label}: kernel time {k_ms:.4f} ms in a span of "
            f"{span_ms:.4f} ms ({100.0 * k_ms / span_ms:.1f}% busy; 3 fences of "
            f"{r['inner']} execs); ms an exec by kernel: "
            + "; ".join(f"{k} {v / execs:.4f}" for k, v in names.items()))
        for body in bodies[r["kernel"]]:
            check(any(body in x for x in names),
                  f"drivers trace: no {body} kernel in the {label} range: {names}")
    trace.unlink()

    # (5) the host half: projections beside the measured execs, the .mtx
    host = host_job("drivers", drivers_host, rate_argv)
    measured = {"headline": (vary[-1]["exec_s"]["min"], f"vary_n n={vary[-1]['n']}"),
                "cplaw": (rp["exec_s"]["min"], "kernels pallas, traced")}
    for tag in ("headline", "cplaw"):
        rows, secs = host[tag]
        for r in rows:
            say(f"[drivers project {tag}] p={r['p']}: kernel {r['kernel_s'] * 1e3:.4f} ms, "
                f"comm {r['comm_s'] * 1e3:.4f} ms, projected {r['projected_s'] * 1e3:.4f} "
                f"ms (overlap {r['projected_overlap_s'] * 1e3:.4f}), "
                f"{r['comm_bytes_per_chip'] / 1e6:.1f} MB a card on the ring")
        one = rows[0]["projected_s"]
        ex = _EXEC_MS.get(f"{tag} x3")
        say(f"[drivers project {tag}] p=1 projected {one * 1e3:.4f} ms against "
            f"{measured[tag][0] * 1e3:.4f} ms measured ({measured[tag][1]}) and "
            f"exec_device {ex if ex is None else round(ex, 4)} ms ({tag} phase); "
            f"model / measured {one / measured[tag][0]:.3f}; project_cli {secs:.1f} s "
            f"on the host")
    for n, pl in host["plan"].items():
        say(f"[drivers vary_n] n={n} (no exec; plan_from_csr in the worker process): "
            f"planner {pl[0]} x {pl[1]} comm_cost {pl[2]}")
        check(pl == VARY_N_PLAN[n],
              f"drivers vary_n n={n}: planner {pl}, the TPU record's {VARY_N_PLAN[n]}")
    m = host["mtx"]
    say(f"[drivers mtx] headline .mtx: {m['bytes'] / 1e6:.1f} MB, {m['nnz']} nnz; "
        f"write_mtx {m['write_s']:.2f} s; {m['scipy_backend']} (the default) "
        f"{m['scipy_s']:.2f} s, {m['backend']} {m['native_s']:.2f} s (each into CSR); "
        f"native equals scipy "
        f"bit for bit: {m['native_equals_scipy']}; structure as written: "
        f"{m['structure_equals_written']}, values as written: {m['values_equal_written']}")
    check(m["backend"] == "native" and m["scipy_backend"] == "scipy",
          f"drivers mtx: backends {m['backend']}, {m['scipy_backend']}")
    check(m["native_equals_scipy"] and m["structure_equals_written"],
          f"drivers mtx: {m}")

    # the records: launches here, the other numbers measured earlier in this run
    out = []
    sources = (("spmm_window_sg_presplit", None), ("spmm_halo", "any_layout"),
               ("spmm_ragged_presplit", None), ("spmm_spill", None))
    for name, path in sources:
        src = next((r for r in _RECORDS if r["name"] == name and r.get("path") == path),
                   None)
        if src is not None:
            out.append(dict(src, launches=launches[name], path="drivers",
                            measured_in=path or "main"))
    check(not _RECORDS or len(out) == len(DRIVERS_KERNELS),
          f"drivers: records of {[r['name'] for r in out]}")
    return out


def x3_layout(build) -> None:
    """Print the rings of the wgmma body once per library that builds it
    (#1 with #5, #2 and #3 at highest as its modes, #4 with its default as
    the one-pass mode and its highest as the TF32 mode, #12 likewise, the
    ragged #7 with #8 as its one-pass mode and #6 at highest as its TF32
    mode): stages, dynamic shared memory, threads, the block tile, and for
    each of its kernels (fp32 B by 16-byte or plain copies, #5's likewise
    on the bf16 planes, the one-pass mode's on one bf16 plane in its own
    deeper ring, the TF32 mode's on fp32 B in its own ring of 32-row
    stages, #12's through the chunk table, in all three modes, with and
    without the waits across processes) registers, spill bytes and
    resident blocks per SM, which must be 0 and at least 1."""
    for name, label, copies in (
        ("crp_window_sg_presplit", "crp_window_sg_presplit / _ab / _bf16 / _f32",
         ("b16", "b4", "pair16", "pair2", "one16", "one2", "tf32_16", "tf32_4")),
        ("crp_window_x3", "crp_window_x3 / _bf16 / _f32",
         ("b16", "b4", "one16", "one2", "tf32_16", "tf32_4")),
        ("crp_halo_x3", "crp_halo_x3 / _bf16 / _f32 (and _flags)",
         ("chunk16", "chunk4", "chunkone16", "chunkone2", "flag16", "flag4", "flagone16",
          "flagone2", "chunktf32_16", "chunktf32_4", "flagtf32_16", "flagtf32_4")),
        ("crp_ragged_presplit", "crp_ragged_presplit / _bf16 / _f32",
         ("b16", "b4", "one16", "one2", "tf32_16", "tf32_4")),
    ):
        lay = build.x3_layout(name)
        say(f"[x3] {label}: {json.dumps(lay)}")
        for copy in copies:
            check(lay[f"{copy}.local_bytes"] == 0 and lay[f"{copy}.blocks_per_sm"] >= 1,
                  f"wgmma {name} ({copy}): {lay}: spills, or no block fits an SM")


def spill_layout(build) -> None:
    """Print the spill and gather kernels' resources once (``[spill]``):
    warps a block, columns a lane holds, B rows in flight a warp, and for
    each of the six kernels (spill and gather by load width) registers,
    spill bytes and resident blocks per SM, which must be 0 and at least
    1."""
    lay = build.spill_layout()
    say(f"[spill] crp_spill_blocks / crp_gather_blocks: {json.dumps(lay)}")
    for name in ("c4", "c2", "c1", "g4", "g2", "g1"):
        check(lay[f"{name}.local_bytes"] == 0 and lay[f"{name}.blocks_per_sm"] >= 1,
              f"spill kernel {name}: {lay}: spills, or no block fits an SM")


def dd_layout(build) -> None:
    """Print the DMMA body's resources once (``[dd]``): the ring's stages,
    dynamic shared memory, threads, the block tile and the DMMA shape, and
    for its 16-byte and 8-byte B copy kernels, on the ragged walk (#11 and
    #6 on fp64), on the windowed walk (#3 and #4 on fp64), with B through
    the chunk table (#12 on fp64) and with the waits across processes
    (#12's ``_flags`` entry), registers, spill bytes and resident blocks
    per SM, which must be 0 and exactly 1; with why the tile is what it
    is."""
    lay = build.dd_layout()
    say(f"[dd] crp_ragged_dd_f64tc / crp_ragged_f64 (b16, b8) / crp_window_sg_f64 / "
        f"crp_window_f64 (w16, w8) / crp_halo_f64 (c16, c8) / crp_halo_f64_flags (f16, "
        f"f8): {json.dumps(lay)}; a {lay['BM']} x {lay['BN']} tile "
        f"owns a group's rows at TM = 128 (each B chunk read once per n-tile); "
        f"{lay['consumers'] // 32} consumer warps of 64 x 32 hold 64 fp64 accumulators "
        f"a thread, so one block an SM walks tiles and {lay['stages']} ring stages of "
        f"{lay['BK']}-deep k slices, filled by a producer warpgroup, stand in for "
        f"occupancy; setmaxnreg gives the consumers {lay['consumer_registers']} "
        f"registers of the {lay['b16.registers']} launched; "
        f"m{lay['mma_m']}n{lay['mma_n']}k{lay['mma_k']}: the fastest shape in "
        f"crp_tpu_torch.cli.dd_split")
    for copy in ("b16", "b8", "w16", "w8", "c16", "c8", "f16", "f8"):
        check(lay[f"{copy}.local_bytes"] == 0 and lay[f"{copy}.blocks_per_sm"] == 1,
              f"dd kernel {copy}: {lay}: spills, or not one block an SM")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on a GPU",
              file=sys.stderr)
        return 2
    from crp_tpu_torch import native
    from crp_tpu_torch.kernels import _build

    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    say(card)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    paths = _build.library_paths()
    _build.libraries()
    say(f"build: {', '.join(p.name for p in paths.values())} in "
        f"{time.perf_counter() - t0:.2f} s")
    x3_layout(_build)
    spill_layout(_build)
    dd_layout(_build)

    records = _RECORDS
    case_dir = native.BUILD_DIR / "smoke_cases"  # in the checkout's git-ignored build tree
    case_dir.mkdir(parents=True, exist_ok=True)
    try:
        for name in CASES:  # the host set-ups, in the worker beside the card's work
            start_host_job(f"case {name}", make_case, name, case_dir)
        for phase in (kernel_phase, presplit_ab_phase, ragged_phase, gather_phase,
                      dd_phase, window_phase, halo_phase, headline, cplaw_path,
                      scrambled_cplaw_path, reorder_path, fp64_path, headline_p4,
                      fp64_p4, cplaw_p4, para2d_phase, any_layout_path, multirank_path,
                      training_path, drivers_path):
            if phase is headline_p4:  # the worker is free of the cases and reorder_host
                start_host_job("training graph", training_case, case_dir)
            t0 = time.perf_counter()
            records += phase(device) or []
            say(f"[time] {phase.__name__}: {time.perf_counter() - t0:.1f} s")
    finally:
        if _HOST["pool"] is not None:
            _HOST["pool"].terminate()
            _HOST["pool"].join()
        for path in case_dir.glob("*.npz"):  # cases no phase took
            path.unlink()
        case_dir.rmdir()
    say(json.dumps({"kernels": records}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
