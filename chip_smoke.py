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
   times, the host cover time and cuSPARSE.

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
N = 256
ERR_COLS = 32
PRECS = ("x3", "default", "highest")
# rel_fro_err against the fp64 reference (the JAX records' classes)
TOL_REF = {"x3": 1e-5, "default": 5e-3, "highest": 1e-6}
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
}


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
    return compare(op.kernel.__name__,
                   lambda: op.kernel(*args, min_b_rows=op.min_b_rows),
                   lambda: op.plain(*args))


def spill_vs_plain(op, arrs, rB):
    args = op.spill_args(arrs, op.plain(*op.kernel_args(arrs, rB)), rB)
    return compare("spmm_spill", lambda: op.spill_kernel(*args),
                   lambda: op.spill_plain(*args))


def all_kernels():
    from crp_tpu_torch.kernels import spmm_pallas, spmm_ragged

    return spmm_pallas.KERNELS + spmm_ragged.KERNELS


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


def cusparse_yardstick(a, b, c_ref, device) -> None:
    """cuSPARSE on the same matrix (not a port: the baseline the kernels
    are held to)."""
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
    say(f"[cusparse] torch.sparse_csr_tensor @ B: {cus_ms:.4f} ms/exec, "
        f"rel_fro_err {err:.3e}")


def drive(a, b, c_ref, prec, device, tag, variant):
    """One engine at ``prec`` through the user's entry point: resolve,
    launch counts in the main-path exec, error against the reference."""
    from crp_tpu_torch import RowParaSpmm, SpmmConfig, csr_row_partition, rel_fro_err

    displs = csr_row_partition(a.rowptr, 1)
    config = SpmmConfig(kernel="auto", mxu_precision=prec)
    eng = RowParaSpmm(a, displs, displs, N, device=device, config=config,
                      dtype=np.float32)
    op = eng._local_op
    say(f"[{tag} {prec}] kind {eng.kernel_kind}, variant {op.variant}, init "
        f"{eng.t_init:.3f} s, init_breakdown {json.dumps(eng.init_breakdown)}, "
        f"kernel {op.kernel.__name__}, roofline {json.dumps(op.roofline)}")
    check((eng.kernel_kind, op.variant) == ("pallas", variant),
          f"{tag} {prec}: resolved to {eng.kernel_kind!r}/{op.variant!r}, "
          f"expected 'pallas'/{variant!r}")

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    c = eng.exec(b)  # the main path, through the user's entry point
    launches = {k.__name__: k.launches for k in kernels}
    say(f"[{tag} {prec}] launches in the main-path exec: {json.dumps(launches)}")
    check(launches[op.kernel.__name__] > 0,
          f"{tag} {prec}: {op.kernel.__name__} was not launched")
    check(c.shape == (a.nrow, N) and bool(np.isfinite(c).all()),
          f"{tag} {prec}: output shape {c.shape} or non-finite values")
    err = rel_fro_err(c_ref, c[:, :ERR_COLS].astype(np.float64))
    say(f"[{tag} {prec}] rel_fro_err vs fp64 reference (first {ERR_COLS} "
        f"columns) = {err:.3e} (tol {TOL_REF[prec]:g})")
    check(err <= TOL_REF[prec], f"{tag} {prec}: rel_fro_err {err} > {TOL_REF[prec]}")
    bs = eng.shard_b(b)
    exec_ms = time_ms(lambda: eng.exec_device(bs))
    say(f"[{tag} {prec}] exec_device {exec_ms:.4f} ms/exec")
    return eng, op, bs, launches


def record(name, launches, max_abs, kernel_ms, plain_ms):
    source, replaces = KERNEL_INFO[name]
    return dict(name=name, route="cuda", source=CSRC + source, replaces=replaces,
                launches=launches, max_abs_err=max_abs, ms=kernel_ms,
                plain_ms=plain_ms)


def time_kernel(op, arrs, rB, tag, prec, plain_inner=20):
    """The op's kernel against its plain version at the main path, and both
    timed in turns; returns (max_abs_err, kernel ms, plain ms)."""
    max_abs, rel, rel_fro = kernel_vs_plain(op, arrs, rB)
    name = op.kernel.__name__
    say(f"[{tag} {prec}] {name} vs plain at the main path: rel fro err "
        f"{rel_fro:.3e} (tol {TOL_PLAIN_FRO:g}), max rel err {rel:.3e}, "
        f"max abs err {max_abs:.3e}")
    check(rel_fro <= TOL_PLAIN_FRO, f"{tag} {prec}: {name} vs plain rel fro err {rel_fro}")
    args = op.kernel_args(arrs, rB)
    kernel_ms, plain_ms, s = in_turns(
        lambda: op.kernel(*args, min_b_rows=op.min_b_rows),
        lambda: op.plain(*args), plain_inner,
    )
    gflop = 2.0 * op.roofline["S" if "S" in op.roofline else "G"] * \
        op.roofline["TM"] * op.roofline["W"] * N / 1e9
    say(f"[{tag} {prec}] {name} {kernel_ms:.4f} ms ({s[0]:.4f}, {s[1]:.4f}), "
        f"plain {plain_ms:.4f} ms ({s[2]:.4f}, {s[3]:.4f}); dense-panel work "
        f"{gflop:.1f} GFLOP/pass")
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
        eng, op, bs, launches = drive(a, b, c_ref, prec, device, "headline", "uniform")
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
        eng, op, bs, launches = drive(a, b, c_ref, prec, device, "cplaw", "ragged")
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
    records = headline(device) + cplaw_path(device)
    say(json.dumps({"kernels": records}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
