"""Smoke test of the PyTorch/CUDA port (``crp_tpu_torch``) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``crp_tpu_torch/kernels/csrc`` into
``build/crp_tpu_torch/`` (one ``nvcc`` per source, all started together)
and then, failing on the first check that does not hold:

1. kernel phase — each windowed kernel against its plain PyTorch version on
   small banded packs with pad groups, n in {16, 48, 100, 256};
2. ragged phase — each ragged kernel and the fused spill kernel against
   their plain versions on small power-law and multiband packs, over
   (TM, Wc) geometries, with pad groups that must come out zero;
3. headline — the pwtk-class banded matrix (217,918 rows, 11,429,953 nnz,
   fp32) times the analytic B (n = 256) through ``RowParaSpmm`` at p = 1
   for each operating point (x3, default, highest): the engine must
   resolve to the uniform windowed kernel (the ragged gate priced and
   passed over), launch it, and match an fp64 numpy reference on the first
   32 columns; then each kernel against its plain version at the main
   path's shapes, with times, and cuSPARSE (``torch.sparse_csr_tensor @
   B``) as a yardstick;
4. cplaw path — the community power-law matrix
   ``powerlaw_community_csr(786432, 16, 1024)`` (10.8M nnz, fp32, n = 256)
   the same way: the engine must resolve to the ragged kernels with the
   fused spill and launch both; each kernel against its plain version,
   times, the host cover time and cuSPARSE;
5. gather phase — the gather kernel against its plain version on small
   scrambled power-law packs at each operating point, n in {16, 48, 100,
   256}, B row 0 set to NaN (pad slots must be skipped) and trailing
   blocks with no nonzero (they must come out zero);
6. dd phase — the FP64 tensor-core kernel against its plain version on
   small banded and power-law total covers, (TM, Wc) = (128, 512) and
   (128, 256), with pad groups that must come out zero;
7. scrambled-cplaw path — the same cplaw matrix with its vertex ids
   permuted (``permute=True``), through ``RowParaSpmm(kernel="auto")``:
   the ragged cover refuses and the walk must land on ``gather`` and launch
   its kernel, within each point's class; the kernel against its plain
   version, times, cuSPARSE;
8. fp64-class path — ``banded_random_csr(217918, 53, 256)`` in fp64
   through ``RowParaSpmm(kernel="dd")`` must resolve to ``dd_mxu`` (S =
   3,402) on the FP64 tensor cores at <= 1e-12; on its pack the kernel
   against its plain version, the fp64 FMA ragged kernel and cuSPARSE in
   fp64; then the fp64 cplaw (segment-sum tier) and the pwtk-class
   headline (ELL tier) with ``kernel="dd"`` at <= 1e-12.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2 and
prints no result.  It imports only ``crp_tpu_torch`` of this repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

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
# or fp32/fp64 FMA) summed in another order.  On the small packs the
# elementwise max|k - p| / max|p| is held to TOL_PLAIN; at the main paths'
# shapes the maximum of a reordered fp32 sum reaches ~2e-6 (measured at
# the headline), so there the relative Frobenius error is held to
# TOL_PLAIN_FRO, the bound the CPU tests put between the two packages.
TOL_PLAIN = {np.float32: 1e-6, np.float64: 1e-12}
TOL_PLAIN_FRO = 1e-6
# the ragged kernels on power-law packs: a hub row sums thousands of rounded
# fp32 products, whose reordering moves the largest elements by up to
# 1.2e-6 of max|p| (measured), so there too the relative Frobenius error is
# held, per dtype; the spill kernel too (its sum order within a row varies
# from run to run).
TOL_RAGGED_FRO = {np.float32: 1e-6, np.float64: 1e-12}
CSRC = "crp_tpu_torch/kernels/csrc/"
KERNEL_INFO = {  # name -> (source, the TPU kernel it replaces)
    "spmm_window_sg_presplit": ("window_sg.cu", "crp_tpu/kernels/spmm_pallas.py:415"),
    "spmm_window_sg_bf16": ("window_sg.cu", "crp_tpu/kernels/spmm_pallas.py:559"),
    "spmm_window_sg": ("window_sg.cu", "crp_tpu/kernels/spmm_pallas.py:338"),
    "spmm_ragged_presplit": ("ragged.cu", "crp_tpu/kernels/spmm_ragged.py:684"),
    "spmm_ragged_bf16": ("ragged.cu", "crp_tpu/kernels/spmm_ragged.py:727"),
    "spmm_ragged": ("ragged.cu", "crp_tpu/kernels/spmm_ragged.py:633"),
    "spmm_spill": ("spill.cu", "crp_tpu/kernels/spmm_ragged.py:1047"),
    "spmm_gather": ("spill.cu", "crp_tpu/kernels/spmm_ragged.py:1047"),
    "spmm_ragged_dd": ("dd_tc.cu", "crp_tpu/kernels/spmm_dd_mxu.py:163"),
}


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
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    samples = []
    for _ in range(reps):
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return float(np.median(samples))


def in_turns(run_kernel, run_plain, plain_inner: int = 20):
    """(kernel ms, plain ms, the four samples) timed in turns on one card:
    plain, kernel, kernel, plain."""
    p1 = time_ms(run_plain, inner=plain_inner)
    k1 = time_ms(run_kernel)
    k2 = time_ms(run_kernel)
    p2 = time_ms(run_plain, inner=plain_inner)
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


def kernel_vs_plain(op, arrs, rB):
    args = op.kernel_args(arrs, rB)
    return compare(op.kernel.__name__, lambda: launch(op, args),
                   lambda: op.plain(*args))


def spill_vs_plain(op, arrs, rB):
    args = op.spill_args(arrs, op.plain(*op.kernel_args(arrs, rB)), rB)
    return compare("spmm_spill", lambda: op.spill_kernel(*args),
                   lambda: op.spill_plain(*args))


def all_kernels():
    from crp_tpu_torch.kernels import spmm_dd_mxu, spmm_pallas, spmm_ragged

    return spmm_pallas.KERNELS + spmm_ragged.KERNELS + spmm_dd_mxu.KERNELS


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
                for n in (16, 100, 256):
                    rB = torch.from_numpy(padded_b(a, op.min_b_rows, n, dtype)).to(device)
                    _, _, rel_fro = kernel_vs_plain(op, arrs, rB)
                    tol = TOL_RAGGED_FRO[dtype]
                    c = op.kernel(*op.kernel_args(arrs, rB), min_b_rows=op.min_b_rows)
                    check(not bool(torch.any(c[a.nrow:])),
                          f"{op.kernel.__name__} {label}: pad rows not zero")
                    msg = (f"ragged {op.kernel.__name__:21s} {prec:8s} "
                           f"{np.dtype(dtype).name} {label:9s} (TM, Wc)=({TM}, {Wc}) "
                           f"S={rl['S']} spill={rl['spill_nnz']} n={n:3d}: rel fro "
                           f"err {rel_fro:.3e} (tol {tol:g})")
                    check(rel_fro <= tol, msg)
                    if op.spill_impl == "pallas":
                        _, _, s_fro = spill_vs_plain(op, arrs, rB)
                        msg += f"; spmm_spill rel fro err {s_fro:.3e}"
                        check(s_fro <= TOL_RAGGED_FRO[np.float32], msg)
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


def drive(a, b, c_ref, prec, device, tag, expect, kernel="auto",
          dtype=np.float32, tol=None, timing=(5, 20)):
    """One engine at ``prec`` through the user's entry point: resolve to
    ``expect`` = (kind, variant), launch counts in the main-path exec (its
    kernel must launch, where the op has one), error against the reference
    (``tol``, default the point's class), exec time (``timing`` = reps,
    inner calls)."""
    from crp_tpu_torch import RowParaSpmm, SpmmConfig, csr_row_partition, rel_fro_err

    tol = TOL_REF[prec] if tol is None else tol
    displs = csr_row_partition(a.rowptr, 1)
    config = SpmmConfig(kernel=kernel, mxu_precision=prec)
    eng = RowParaSpmm(a, displs, displs, N, device=device, config=config,
                      dtype=dtype)
    op = eng._local_op
    kernel_fn = getattr(op, "kernel", None)  # the dd kind's non-MXU tier has none
    say(f"[{tag} {prec}] kernel={kernel!r}: kind {eng.kernel_kind}, variant "
        f"{op.variant}, init {eng.t_init:.3f} s, init_breakdown "
        f"{json.dumps(eng.init_breakdown)}, kernel "
        f"{kernel_fn.__name__ if kernel_fn else 'none (plain PyTorch tier)'}, "
        f"roofline {json.dumps(getattr(op, 'roofline', {}))}")
    check((eng.kernel_kind, op.variant) == expect,
          f"{tag} {prec}: resolved to {eng.kernel_kind!r}/{op.variant!r}, "
          f"expected {expect}")

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    c = eng.exec(b)  # the main path, through the user's entry point
    launches = {k.__name__: k.launches for k in kernels}
    say(f"[{tag} {prec}] launches in the main-path exec: {json.dumps(launches)}")
    if kernel_fn is not None:
        check(launches[kernel_fn.__name__] > 0,
              f"{tag} {prec}: {kernel_fn.__name__} was not launched")
    check(c.shape == (a.nrow, N) and bool(np.isfinite(c).all()),
          f"{tag} {prec}: output shape {c.shape} or non-finite values")
    err = rel_fro_err(c_ref, c[:, :ERR_COLS].astype(np.float64))
    say(f"[{tag} {prec}] rel_fro_err vs fp64 reference (first {ERR_COLS} "
        f"columns) = {err:.3e} (tol {tol:g})")
    check(err <= tol, f"{tag} {prec}: rel_fro_err {err} > {tol}")
    bs = eng.shard_b(b)
    exec_ms = time_ms(lambda: eng.exec_device(bs), *timing)
    say(f"[{tag} {prec}] exec_device {exec_ms:.4f} ms/exec")
    return eng, op, bs, launches


def record(name, launches, max_abs, kernel_ms, plain_ms):
    source, replaces = KERNEL_INFO[name]
    return dict(name=name, route="cuda", source=CSRC + source, replaces=replaces,
                launches=launches, max_abs_err=max_abs, ms=kernel_ms,
                plain_ms=plain_ms)


def time_kernel(op, arrs, rB, tag, prec, plain_inner=20, tol=TOL_PLAIN_FRO):
    """The op's kernel against its plain version at the main path (relative
    Frobenius error within ``tol``), and both timed in turns; returns
    (max_abs_err, kernel ms, plain ms)."""
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
        work = (f"{rl['spill_nnz']} nnz, {rl['spill_nnz'] * N * 4 / 1e9:.2f} GB "
                f"of gathered B rows")
    else:
        work = (f"dense-panel work {2.0 * rl.get('S', rl['G']) * rl['TM'] * rl['W'] * N / 1e9:.1f}"
                f" GFLOP/pass")
    say(f"[{tag} {prec}] {name} {kernel_ms:.4f} ms ({s[0]:.4f}, {s[1]:.4f}), "
        f"plain {plain_ms:.4f} ms ({s[2]:.4f}, {s[3]:.4f}); {work}")
    return max_abs, kernel_ms, plain_ms


def headline(device) -> list:
    from crp_tpu_torch import banded_random_csr, fill_b

    t0 = time.perf_counter()
    a = banded_random_csr(NROW, nnz_per_row=NNZ_PER_ROW, bandwidth=BANDWIDTH,
                          seed=SEED, dtype=np.float32)
    b = np.asarray(fill_b(0, a.ncol, 0, N, dtype=np.float32))
    c_ref = spmm_ref_f64(a, b[:, :ERR_COLS])
    say(f"headline matrix: {a.nrow} rows, {a.nnz} nnz, n={N}, host set-up "
        f"{time.perf_counter() - t0:.2f} s")
    records = []
    for prec in PRECS:
        eng, op, bs, launches = drive(a, b, c_ref, prec, device, "headline",
                                      ("pallas", "uniform"))
        arrs = tuple(x[0] for x in eng.packed)
        max_abs, kernel_ms, plain_ms = time_kernel(op, arrs, bs[0], "headline", prec)
        records.append(record(op.kernel.__name__, launches[op.kernel.__name__],
                              max_abs, kernel_ms, plain_ms))
        del eng, op, bs, arrs
        a.__dict__.pop("_torch_pack_cache", None)
        torch.cuda.empty_cache()
    cusparse_yardstick(a, b, c_ref, device)
    return records


def cplaw_path(device) -> list:
    from crp_tpu_torch import fill_b, powerlaw_community_csr
    from crp_tpu_torch.kernels import spmm_ragged

    t0 = time.perf_counter()
    a = powerlaw_community_csr(**CPLAW, dtype=np.float32)
    t_gen = time.perf_counter() - t0
    b = np.asarray(fill_b(0, a.ncol, 0, N, dtype=np.float32))
    c_ref = spmm_ref_f64(a, b[:, :ERR_COLS])
    say(f"cplaw matrix: {a.nrow} rows, {a.nnz} nnz, n={N}, generated in "
        f"{t_gen:.2f} s, host set-up {time.perf_counter() - t0:.2f} s")
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
        eng, op, bs, launches = drive(a, b, c_ref, prec, device, "cplaw",
                                      ("pallas", "ragged"))
        rl = op.roofline
        check(rl["spill_impl"] == "pallas", f"cplaw {prec}: spill_impl {rl['spill_impl']!r}")
        check(launches["spmm_spill"] > 0, f"cplaw {prec}: spmm_spill was not launched")
        if prec == "x3":
            check((rl["TM"], rl["W"]) == (512, 128),
                  f"cplaw x3: (TM, Wc) = ({rl['TM']}, {rl['W']}), expected (512, 128)")
        arrs = tuple(x[0] for x in eng.packed)
        rB = bs[0]
        max_abs, kernel_ms, plain_ms = time_kernel(op, arrs, rB, "cplaw", prec,
                                                   plain_inner=3)
        records.append(record(op.kernel.__name__, launches[op.kernel.__name__],
                              max_abs, kernel_ms, plain_ms))
        s_abs, s_rel, s_fro = spill_vs_plain(op, arrs, rB)
        say(f"[cplaw {prec}] spmm_spill vs plain at the main path: rel fro err "
            f"{s_fro:.3e} (tol {TOL_PLAIN_FRO:g}), max rel err {s_rel:.3e}, "
            f"max abs err {s_abs:.3e}")
        check(s_fro <= TOL_PLAIN_FRO, f"cplaw {prec}: spmm_spill vs plain rel fro err {s_fro}")
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
        del eng, op, bs, arrs, rB, args
        a.__dict__.pop("_torch_pack_cache", None)
        torch.cuda.empty_cache()
    records.append(record("spmm_spill", spill["launches"], spill["max_abs"],
                          spill["ms"], spill["plain_ms"]))
    cusparse_yardstick(a, b, c_ref, device)
    # for comparison, off the main path: the gather kind on this matrix
    from crp_tpu_torch.kernels.dispatch import _pack_gather

    arrays, op = _pack_gather([(a.rowptr, a.colidx.astype(np.int32), a.val)],
                              a.nrow, np.float32, "x3", device)
    args = op.kernel_args(tuple(x[0] for x in arrays),
                          torch.from_numpy(b).to(device))
    say(f"[cplaw x3] for comparison, the gather kind's kernel on this matrix: "
        f"{time_ms(lambda: launch(op, args)):.4f} ms")
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
        for n in (16, 48, 100, 256):
            b = padded_b(a, a.ncol, n, np.float32)
            b[0] = np.nan  # pad slots point at column 0: they must be skipped
            rB = torch.from_numpy(b).to(device)
            _, _, rel_fro = kernel_vs_plain(op, arrs, rB)
            c = launch(op, op.kernel_args(arrs, rB))
            msg = (f"gather spmm_gather {prec:8s} M={op.M} steps={op.roofline['S']} "
                   f"n={n:3d}: rel fro err {rel_fro:.3e} (tol {TOL_PLAIN_FRO:g})")
            check(rel_fro <= TOL_PLAIN_FRO, msg)
            check(not bool(torch.any(c[a.nrow:])), f"gather {prec}: empty blocks not zero")
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
                msg = (f"dd spmm_ragged_dd {label:7s} (TM, Wc)=({rl['TM']}, {rl['W']}) "
                       f"S={rl['S']} n={n:3d}: rel fro err {rel_fro:.3e} (tol {TOL_DD:g})")
                check(rel_fro <= TOL_DD, msg)
                check(not bool(torch.any(c[a.nrow:])), f"dd {label}: pad rows not zero")
                say(msg)


def scrambled_cplaw_path(device) -> list:
    from crp_tpu_torch import fill_b, powerlaw_community_csr
    from crp_tpu_torch.kernels import spmm_ragged
    from crp_tpu_torch.kernels.dispatch import _pack_gather

    t0 = time.perf_counter()
    a = powerlaw_community_csr(**CPLAW, permute=True, dtype=np.float32)
    b = np.asarray(fill_b(0, a.ncol, 0, N, dtype=np.float32))
    c_ref = spmm_ref_f64(a, b[:, :ERR_COLS])
    say(f"scrambled cplaw matrix: {a.nrow} rows, {a.nnz} nnz, n={N}, host set-up "
        f"{time.perf_counter() - t0:.2f} s")
    # the init's parts: the gate's geometry chooser, the cover it refuses,
    # and the gather pack that serves the matrix
    t0 = time.perf_counter()
    geometry = spmm_ragged.choose_ragged_geometry(a.rowptr, a.colidx, "x3")
    t_choose = time.perf_counter() - t0
    t0 = time.perf_counter()
    S, spill, _ = spmm_ragged.estimate_ragged(a.rowptr, a.colidx, *geometry)
    t_cover = time.perf_counter() - t0
    t0 = time.perf_counter()
    arrays, _ = _pack_gather([(a.rowptr, a.colidx.astype(np.int32), a.val)], a.nrow,
                             np.float32, "x3", device)
    torch.cuda.synchronize()
    say(f"[scrambled] host init parts: geometry chooser (x3) {geometry} "
        f"{t_choose:.3f} s; cover there {t_cover:.3f} s (S={S}, spill {spill}, "
        f"{100 * (a.nnz - spill) / a.nnz:.1f}% kept); gather pack + upload "
        f"{time.perf_counter() - t0:.3f} s")
    del arrays
    rec = dict(launches=0, max_abs=0.0)
    for prec in PRECS:
        eng, op, bs, launches = drive(a, b, c_ref, prec, device, "scrambled",
                                      ("gather", "gather"))
        arrs = tuple(x[0] for x in eng.packed)
        max_abs, kernel_ms, plain_ms = time_kernel(op, arrs, bs[0], "scrambled",
                                                   prec, plain_inner=2)
        rec["launches"] += launches["spmm_gather"]
        rec["max_abs"] = max(rec["max_abs"], max_abs)
        if prec == "x3":
            rec["ms"], rec["plain_ms"] = kernel_ms, plain_ms
        del eng, op, bs, arrs
        a.__dict__.pop("_torch_pack_cache", None)
        torch.cuda.empty_cache()
    cusparse_yardstick(a, b, c_ref, device, "scrambled cusparse")
    return [record("spmm_gather", rec["launches"], rec["max_abs"], rec["ms"],
                   rec["plain_ms"])]


def fp64_path(device) -> list:
    from crp_tpu_torch import banded_random_csr, fill_b, powerlaw_community_csr
    from crp_tpu_torch.kernels.spmm_ragged import spmm_ragged

    t0 = time.perf_counter()
    a = banded_random_csr(NROW, nnz_per_row=NNZ_PER_ROW, bandwidth=DD_BAND)
    b = np.asarray(fill_b(0, a.ncol, 0, N))
    c_ref = spmm_ref_f64(a, b[:, :ERR_COLS])
    say(f"fp64 banded matrix: {a.nrow} rows, {a.nnz} nnz, n={N}, host set-up "
        f"{time.perf_counter() - t0:.2f} s")
    eng, op, bs, launches = drive(a, b, c_ref, "highest", device, "fp64 banded",
                                  ("dd", "dd_mxu"), kernel="dd", dtype=np.float64,
                                  tol=TOL_DD)
    check(op.roofline["S"] == DD_BAND_S,
          f"fp64 banded: S = {op.roofline['S']}, expected {DD_BAND_S}")
    arrs = tuple(x[0] for x in eng.packed)
    rB = bs[0]
    max_abs, kernel_ms, plain_ms = time_kernel(op, arrs, rB, "fp64 banded", "dd",
                                               plain_inner=3, tol=TOL_DD)
    # the fp64 FMA ragged kernel on the same arrays: the pack has no spill
    args = op.kernel_args(arrs, rB)
    _, _, fma_fro = compare("spmm_ragged", lambda: spmm_ragged(*args, min_b_rows=op.min_b_rows),
                            lambda: op.plain(*args))
    check(fma_fro <= TOL_DD, f"fp64 banded: spmm_ragged vs plain rel fro err {fma_fro}")
    dd_ms, fma_ms, s = in_turns(lambda: launch(op, args),
                                lambda: spmm_ragged(*args, min_b_rows=op.min_b_rows))
    gflop = 2.0 * op.roofline["S"] * op.roofline["TM"] * op.roofline["W"] * N / 1e9
    say(f"[fp64 banded] on one pack, in turns: spmm_ragged_dd (FP64 tensor cores) "
        f"{dd_ms:.4f} ms ({s[0]:.4f}, {s[1]:.4f}), spmm_ragged fp64 FMA "
        f"{fma_ms:.4f} ms ({s[2]:.4f}, {s[3]:.4f}; rel fro err {fma_fro:.3e}); "
        f"{gflop:.1f} GFLOP")
    records = [record("spmm_ragged_dd", launches["spmm_ragged_dd"], max_abs,
                      kernel_ms, plain_ms)]
    del eng, op, bs, arrs, rB, args
    a.__dict__.pop("_torch_pack_cache", None)
    torch.cuda.empty_cache()
    cusparse_yardstick(a, b, c_ref, device, "fp64 banded cusparse")

    # the dd kind's other tiers: the dd_mxu cover refuses both matrices
    for tag, gen, tier in (
        ("fp64 cplaw", lambda: powerlaw_community_csr(**CPLAW), "segsum"),
        ("fp64 headline", lambda: banded_random_csr(NROW, NNZ_PER_ROW, BANDWIDTH,
                                                    seed=SEED), "ell"),
    ):
        t0 = time.perf_counter()
        a = gen()
        b = np.asarray(fill_b(0, a.ncol, 0, N))
        c_ref = spmm_ref_f64(a, b[:, :ERR_COLS])
        say(f"{tag} matrix: {a.nrow} rows, {a.nnz} nnz, host set-up "
            f"{time.perf_counter() - t0:.2f} s")
        eng, _, _, _ = drive(a, b, c_ref, "highest", device, tag, ("dd", tier),
                             kernel="dd", dtype=np.float64, tol=TOL_DD,
                             timing=(3, 2))
        del eng
        a.__dict__.pop("_torch_pack_cache", None)
        torch.cuda.empty_cache()
        cusparse_yardstick(a, b, c_ref, device, f"{tag} cusparse")
    return records


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on a GPU",
              file=sys.stderr)
        return 2
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

    kernel_phase(device)
    ragged_phase(device)
    gather_phase(device)
    dd_phase(device)
    records = (headline(device) + cplaw_path(device)
               + scrambled_cplaw_path(device) + fp64_path(device))
    say(json.dumps({"kernels": records}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
