"""Smoke test of the PyTorch/CUDA port (``crp_tpu_torch``) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``crp_tpu_torch/kernels/csrc`` into
``build/crp_tpu_torch/`` and then, failing on the first check that does not
hold:

1. kernel phase — each windowed kernel against its plain PyTorch version on
   small banded packs with pad groups, n in {16, 48, 100, 256};
2. main path — the pwtk-class banded matrix (217,918 rows, 11,429,953 nnz,
   fp32) times the analytic B (n = 256) through ``RowParaSpmm`` at p = 1
   for each operating point (x3, default, highest): the engine must resolve
   to the windowed kernel, launch it, and match an fp64 numpy reference on
   the first 32 columns; then each kernel against its plain version at the
   main path's shapes, with times, and the cuSPARSE baseline
   (``torch.sparse_csr_tensor @ B``) as a yardstick.

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
N = 256
ERR_COLS = 32
# rel_fro_err against the fp64 reference (the JAX records' classes)
TOL_REF = {"x3": 1e-5, "default": 5e-3, "highest": 1e-6}
# kernel against its plain version: the same exact products (bf16 x bf16,
# or fp32/fp64 FMA) summed in another order.  On the small packs the
# elementwise max|k - p| / max|p| is held to TOL_PLAIN; at the main path's
# 5632-row windows that maximum of a reordered fp32 sum reaches ~2e-6
# (measured), so there the relative Frobenius error is held to
# TOL_PLAIN_FRO, the bound the CPU tests put between the two packages.
TOL_PLAIN = {np.float32: 1e-6, np.float64: 1e-12}
TOL_PLAIN_FRO = 1e-6
REPLACES = {
    "spmm_window_sg_presplit": "crp_tpu/kernels/spmm_pallas.py:415",
    "spmm_window_sg_bf16": "crp_tpu/kernels/spmm_pallas.py:559",
    "spmm_window_sg": "crp_tpu/kernels/spmm_pallas.py:338",
}
SOURCE = "crp_tpu_torch/kernels/csrc/window_sg.cu"


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def say(*args) -> None:
    print(*args, flush=True)


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


def kernel_vs_plain(op, arrs, rB):
    """(max_abs_err, max relative error, relative Frobenius error) of the
    op's kernel against its plain version on the same CUDA tensors; these
    launches are checks, not the main path's."""
    args = op.kernel_args(arrs, rB)
    k = op.kernel(*args, min_b_rows=op.min_b_rows)
    p = op.plain(*args)
    torch.cuda.synchronize()
    check(k.shape == p.shape, f"{op.kernel.__name__}: shape {k.shape} vs {p.shape}")
    check(bool(torch.isfinite(k).all()), f"{op.kernel.__name__}: non-finite output")
    d = (k - p).double()
    max_abs = float(d.abs().max())
    rel_fro = float(d.norm() / max(float(p.double().norm()), 1e-300))
    return max_abs, max_abs / max(float(p.abs().max()), 1e-300), rel_fro


def kernel_phase(device) -> None:
    from crp_tpu_torch import banded_random_csr, fill_b
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
            b = np.zeros((op.min_b_rows, n), dtype)
            b[: a.ncol] = fill_b(0, a.ncol, 0, n, dtype=dtype)
            rB = torch.from_numpy(b).to(device)
            max_abs, rel, rel_fro = kernel_vs_plain(op, arrs, rB)
            tol = TOL_PLAIN[dtype]
            say(f"kernel {op.kernel.__name__:24s} {prec:8s} "
                f"{np.dtype(dtype).name} G={G} n={n:3d}: max rel err "
                f"{rel:.3e} (tol {tol:g}), max abs err {max_abs:.3e}, "
                f"rel fro err {rel_fro:.3e}")
            check(rel <= tol, f"{op.kernel.__name__} n={n} {prec}: {rel} > {tol}")


def main_path(device) -> list:
    from crp_tpu_torch import (
        SpmmConfig, banded_random_csr, csr_row_partition, fill_b, rel_fro_err,
    )
    from crp_tpu_torch.engine.rowpara import RowParaSpmm
    from crp_tpu_torch.kernels.spmm_pallas import KERNELS

    t0 = time.perf_counter()
    a = banded_random_csr(NROW, nnz_per_row=NNZ_PER_ROW, bandwidth=BANDWIDTH,
                          seed=SEED, dtype=np.float32)
    b = np.asarray(fill_b(0, a.ncol, 0, N, dtype=np.float32))
    c_ref = spmm_ref_f64(a, b[:, :ERR_COLS])
    displs = csr_row_partition(a.rowptr, 1)
    say(f"matrix: {a.nrow} rows, {a.nnz} nnz, n={N}, host set-up "
        f"{time.perf_counter() - t0:.2f} s")

    records = []
    for prec in ("x3", "default", "highest"):
        config = SpmmConfig(kernel="auto", mxu_precision=prec)
        eng = RowParaSpmm(a, displs, displs, N, device=device, config=config,
                          dtype=np.float32)
        op = eng._local_op
        check(eng.kernel_kind == "pallas",
              f"{prec}: kernel_kind {eng.kernel_kind!r}, expected 'pallas'")
        say(f"[{prec}] init {eng.t_init:.3f} s, init_breakdown "
            f"{json.dumps(eng.init_breakdown)}, kernel {op.kernel.__name__}, "
            f"roofline {json.dumps(op.roofline)}")

        for k in KERNELS:
            k.launches = 0
        c = eng.exec(b)  # the main path, through the user's entry point
        launches = {k.__name__: k.launches for k in KERNELS}
        say(f"[{prec}] launches in the main-path exec: {json.dumps(launches)}")
        check(launches[op.kernel.__name__] > 0,
              f"{prec}: {op.kernel.__name__} was not launched")
        check(c.shape == (a.nrow, N) and bool(np.isfinite(c).all()),
              f"{prec}: output shape {c.shape} or non-finite values")
        err = rel_fro_err(c_ref, c[:, :ERR_COLS].astype(np.float64))
        say(f"[{prec}] rel_fro_err vs fp64 reference (first {ERR_COLS} "
            f"columns) = {err:.3e} (tol {TOL_REF[prec]:g})")
        check(err <= TOL_REF[prec], f"{prec}: rel_fro_err {err} > {TOL_REF[prec]}")

        bs = eng.shard_b(b)
        exec_ms = time_ms(lambda: eng.exec_device(bs))
        arrs = tuple(x[0] for x in eng.packed)
        max_abs, rel, rel_fro = kernel_vs_plain(op, arrs, bs[0])
        say(f"[{prec}] kernel vs plain at the main path: rel fro err "
            f"{rel_fro:.3e} (tol {TOL_PLAIN_FRO:g}), max rel err {rel:.3e}, "
            f"max abs err {max_abs:.3e}")
        check(rel_fro <= TOL_PLAIN_FRO,
              f"{prec}: kernel vs plain rel fro err {rel_fro} at the main path")
        args = op.kernel_args(arrs, bs[0])

        def run_kernel():
            op.kernel(*args, min_b_rows=op.min_b_rows)

        def run_plain():
            op.plain(*args)

        # in turns on one card: plain, kernel, kernel, plain
        p1 = time_ms(run_plain)
        k1 = time_ms(run_kernel)
        k2 = time_ms(run_kernel)
        p2 = time_ms(run_plain)
        kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        gflop = 2.0 * op.roofline["G"] * op.roofline["TM"] * op.roofline["W"] * N / 1e9
        say(f"[{prec}] exec_device {exec_ms:.4f} ms/exec; kernel "
            f"{kernel_ms:.4f} ms ({k1:.4f}, {k2:.4f}), plain {plain_ms:.4f} ms "
            f"({p1:.4f}, {p2:.4f}); dense-window work {gflop:.1f} GFLOP/pass")
        records.append(dict(
            name=op.kernel.__name__, route="cuda", source=SOURCE,
            replaces=REPLACES[op.kernel.__name__],
            launches=launches[op.kernel.__name__], max_abs_err=max_abs,
            ms=kernel_ms, plain_ms=plain_ms,
        ))
        del eng, op, bs, arrs, args, c
        a.__dict__.pop("_torch_pack_cache", None)
        torch.cuda.empty_cache()

    # cuSPARSE yardstick (not a port: the baseline the kernels are held to)
    A = torch.sparse_csr_tensor(
        torch.from_numpy(a.rowptr.astype(np.int64)),
        torch.from_numpy(a.colidx.astype(np.int64)),
        torch.from_numpy(a.val), size=(a.nrow, a.ncol), device=device,
    )
    Bd = torch.from_numpy(b).to(device)
    cus_ms = time_ms(lambda: A @ Bd)
    c = (A @ Bd).cpu().numpy()
    err = rel_fro_err(c_ref, c[:, :ERR_COLS].astype(np.float64))
    say(f"[cusparse] torch.sparse_csr_tensor @ B: {cus_ms:.4f} ms/exec, "
        f"rel_fro_err {err:.3e}")
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
    so = _build.library_path()
    _build.library()
    say(f"build: {so.name} in {time.perf_counter() - t0:.2f} s")

    kernel_phase(device)
    records = main_path(device)
    say(json.dumps({"kernels": records}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
