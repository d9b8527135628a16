"""Package boundaries: the port runs without jax, ml_dtypes and any module
of crp_tpu, and the GPU smoke script imports only the port and refuses to
run without a GPU."""

import ast
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]

_NO_JAX = r"""
import sys
sys.modules["jax"] = None
sys.modules["ml_dtypes"] = None
sys.modules["crp_tpu"] = None
import json
import numpy as np
import crp_tpu_torch
from crp_tpu_torch import (
    Para2dSpmm, RowParaSpmm, SpmmConfig, banded_random_csr, csr_row_partition,
    fill_b, plan_from_csr, rel_fro_err,
)
from crp_tpu_torch import powerlaw_community_csr
from crp_tpu_torch.kernels import (
    _build, device_pack, dispatch, spmm_dd, spmm_dd_mxu, spmm_ell, spmm_pallas,
    spmm_ragged,
)

errs = {}
for kernel, a in (
    ("pallas", banded_random_csr(900, nnz_per_row=6, bandwidth=40, seed=1,
                                 dtype=np.float32)),
    ("ragged", powerlaw_community_csr(3000, 16, 1024, seed=2, dtype=np.float32)),
    ("gather", powerlaw_community_csr(3000, 4, 1024, seed=2, permute=True,
                                      dtype=np.float32)),
    ("dd", powerlaw_community_csr(3000, 16, 1024, seed=2)),
    ("dd_mxu", banded_random_csr(900, nnz_per_row=6, bandwidth=40, seed=1)),
):
    d = csr_row_partition(a.rowptr, 1)
    b = fill_b(0, a.ncol, 0, 16, dtype=np.float32)
    for prec in ("x3", "default", "highest"):
        eng = RowParaSpmm(a, d, d, 16, device="cpu", dtype=np.float32,
                          config=SpmmConfig(kernel=kernel, mxu_precision=prec))
        errs[f"{kernel} {prec}"] = rel_fro_err(a.spmm_ref(b.astype(np.float64)),
                                               eng.exec(b))
# the multi-shard engines: p = 4 rows, a 2 x 2 grid
a = banded_random_csr(2000, nnz_per_row=7, bandwidth=60, seed=3, dtype=np.float32)
b = fill_b(0, a.ncol, 0, 16, dtype=np.float32)
ref = a.spmm_ref(b.astype(np.float64))
d = csr_row_partition(a.rowptr, 4)
for kernel in ("pallas", "segsum"):
    eng = RowParaSpmm(a, d, d, 16, device="cpu", dtype=np.float32,
                      config=SpmmConfig(kernel=kernel, mxu_precision="x3"))
    errs[f"p4 {kernel}"] = rel_fro_err(ref, eng.exec(b))
plan = plan_from_csr(a, 16, 4)
plan.pm, plan.pn = 2, 2
plan.AC_rowptr = plan.B_rowptr = csr_row_partition(a.rowptr, 4)[::2].copy()
plan.BC_colptr = np.array([0, 8, 16])
plan.A0_rowptr = csr_row_partition(a.rowptr, 4)
eng = Para2dSpmm(a, plan, device="cpu", dtype=np.float32,
                 config=SpmmConfig(kernel="pallas", mxu_precision="x3"))
errs["2x2 pallas"] = rel_fro_err(ref, eng.exec(b))
loaded = [m for m in sys.modules if sys.modules[m] is not None]
assert not any(m == "jax" or m.startswith(("jax.", "ml_dtypes")) for m in loaded), \
    "jax got imported"
assert not any(m == "crp_tpu" or m.startswith("crp_tpu.") for m in loaded), \
    "crp_tpu got imported"
print(json.dumps(errs))
"""


def test_port_runs_without_jax_and_ml_dtypes():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    errs = json.loads(proc.stdout.strip().splitlines()[-1])
    for kernel in ("pallas", "ragged", "gather"):
        assert errs[f"{kernel} x3"] <= 1e-5 and errs[f"{kernel} default"] <= 5e-3
        assert errs[f"{kernel} highest"] <= 1e-6
    for kernel in ("dd", "dd_mxu"):  # fp64 class at every point
        assert max(errs[f"{kernel} {p}"] for p in ("x3", "default", "highest")) <= 1e-12
    assert max(errs["p4 pallas"], errs["2x2 pallas"]) <= 1e-5  # x3 class
    assert errs["p4 segsum"] <= 1e-6


_NO_JAX_TRAINING = r"""
import sys
sys.modules["jax"] = None
sys.modules["ml_dtypes"] = None
sys.modules["crp_tpu"] = None
import json
from crp_tpu_torch.engine.autodiff import DifferentiableSpmm
from crp_tpu_torch.engine.trainable import ValueParameterizedSpmm
from crp_tpu_torch.examples import common, gat_train, gcn_train
from crp_tpu_torch.kernels.spmm_segsum import segment_sum, spmm_segment_sum

runs = {ex.__name__.rsplit(".", 1)[1]: ex.train(nodes=300, hidden=8, steps=4, p=2,
                                                 device="cpu", log=None).losses
        for ex in (gcn_train, gat_train)}
loaded = [m for m in sys.modules if sys.modules[m] is not None]
assert not any(m == "jax" or m.startswith(("jax.", "ml_dtypes")) for m in loaded), \
    "jax got imported"
assert not any(m == "crp_tpu" or m.startswith("crp_tpu.") for m in loaded), \
    "crp_tpu got imported"
print(json.dumps(runs))
"""


def test_training_modules_run_without_jax():
    """The autodiff and trainable engines, the fixed-order sums and both
    trainers import and train with ``crp_tpu`` and jax blocked."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_TRAINING], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    runs = json.loads(proc.stdout.strip().splitlines()[-1])
    for losses in runs.values():
        assert len(losses) == 4 and losses[-1] < losses[0]


_NO_JAX_ANY_LAYOUT = r"""
import sys
sys.modules["jax"] = None
sys.modules["ml_dtypes"] = None
sys.modules["crp_tpu"] = None
import io, json
from contextlib import redirect_stdout
import numpy as np
from crp_tpu_torch import (
    CrpSpmm, Para2dSpmm, RowParaSpmm, SpmmConfig, banded_random_csr, csr_row_partition,
    fill_b, plan_from_csr, rel_fro_err,
)
from crp_tpu_torch.cli import calc_partition_cli, plan_cli
from crp_tpu_torch.comm import ring
from crp_tpu_torch.engine import crp
from crp_tpu_torch.plan import bandwidth
from crp_tpu_torch.shard import dist_a, redist
from crp_tpu_torch.shard.dist_a import DistCSR
from crp_tpu_torch.shard.redist import BlockDist
from crp_tpu_torch.utils.blocks import uniform_displs

a = banded_random_csr(1500, nnz_per_row=7, bandwidth=50, seed=4, dtype=np.float32)
n = 16
b = fill_b(0, a.ncol, 0, n, dtype=np.float32)
ref = a.spmm_ref(b.astype(np.float64))
ub = BlockDist.from_grid(uniform_displs(a.ncol, 4), [0, n])
uc = BlockDist.from_grid([0, a.nrow], uniform_displs(n, 4))
errs = {}
for name, cfg in (("crp", {}), ("crp fine", dict(a2a_b_finegrain=1)),
                  ("crp overlap", dict(overlap=1))):
    eng = CrpSpmm(a, n, ub, uc, nproc=4, device="cpu", dtype=np.float32,
                  config=SpmmConfig(kernel="pallas", mxu_precision="x3", **cfg))
    errs[name] = rel_fro_err(ref, eng.exec(b))
eng = CrpSpmm(DistCSR.from_global(a, uniform_displs(a.nrow, 4), device="cpu"), n, ub, uc,
              nproc=4, device="cpu", dtype=np.float32)
errs["crp dist"] = rel_fro_err(ref, eng.exec(b))
d = csr_row_partition(a.rowptr, 4)
eng = RowParaSpmm(a, d, d, n, device="cpu", dtype=np.float32,
                  config=SpmmConfig(overlap=1, kernel="pallas", mxu_precision="x3"))
errs["rowpara overlap"] = rel_fro_err(ref, eng.exec(b))
eng = RowParaSpmm(a, d, d, n, device="cpu", dtype=np.float32, config=SpmmConfig(bc_layout=1))
errs["rowpara bc_layout"] = rel_fro_err(ref.T, eng.exec(np.ascontiguousarray(b.T)))
plan = plan_from_csr(a, n, 4)
eng = Para2dSpmm.from_dist_a(DistCSR.from_global(a, plan.A0_rowptr, device="cpu"), plan,
                             device="cpu", dtype=np.float32, config=SpmmConfig(overlap=1))
errs["para2d dist overlap"] = rel_fro_err(ref, eng.exec(b))
with redirect_stdout(io.StringIO()):
    assert calc_partition_cli.main(["synth:banded:2000:9:60", "16", "4"]) == 0
loaded = [m for m in sys.modules if sys.modules[m] is not None]
assert not any(m == "jax" or m.startswith(("jax.", "ml_dtypes")) for m in loaded), \
    "jax got imported"
assert not any(m == "crp_tpu" or m.startswith("crp_tpu.") for m in loaded), \
    "crp_tpu got imported"
print(json.dumps(errs))
"""


def test_any_layout_modules_run_without_jax():
    """The any-layout engine's modules (the v1 planner, the redistribution,
    distributed A, the ring, ``CrpSpmm``, the CLIs) import, and the engines
    run every new option, with ``crp_tpu``, jax and ml_dtypes blocked."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_ANY_LAYOUT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    errs = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(errs) == 7
    for name, err in errs.items():  # x3's class for the pallas runs, fp32 else
        assert err <= (1e-5 if name in ("crp", "crp fine", "crp overlap",
                                        "rowpara overlap") else 1e-6), (name, err)


def test_mesh_modules_run_without_jax():
    """Ranks of a mesh (``tests/torch_dist_ranks.py``: gloo processes with
    ``jax``, ``crp_tpu`` and ml_dtypes blocked) run the engines across
    ranks, and hold no module of either; the test process imports the new
    modules with the same modules blocked."""
    from crp_tpu_torch.plan.planner2d import plan_from_csr
    from crp_tpu_torch.sparse.synth import banded_random_csr, fill_b

    from tests.torch_dist_ranks import run_ranks

    code = ("import sys\nsys.modules['jax'] = None\nsys.modules['crp_tpu'] = None\n"
            "sys.modules['ml_dtypes'] = None\n"
            "from crp_tpu_torch.shard import layout, dist_a\n"
            "from crp_tpu_torch.comm import exchange, ring\n"
            "from crp_tpu_torch.kernels import spmm_halo\n"
            "from crp_tpu_torch.cli import _driver, bench_cli, suite_cli\n"
            "assert callable(layout.init_distributed) and spmm_halo.HaloPeers\n"
            "loaded = [m for m in sys.modules if sys.modules[m] is not None]\n"
            "assert not any(m.split('.')[0] in ('jax', 'crp_tpu', 'ml_dtypes') "
            "for m in loaded)\nprint('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]
    a = banded_random_csr(700, nnz_per_row=7, bandwidth=40, seed=5)
    plan = plan_from_csr(a, 12, 2)
    from crp_tpu_torch.plan.partition1d import csr_row_partition

    got = run_ranks(2, "loaded", dict(a=a, displs=csr_row_partition(a.rowptr, 2), plan=plan,
                                      b=np.asarray(fill_b(0, a.ncol, 0, 12))))
    for rank in got:
        assert not any(m.split(".")[0] in ("jax", "crp_tpu", "ml_dtypes")
                       for m in rank["modules"])
        assert "crp_tpu_torch.kernels.spmm_halo" in rank["modules"]
        assert len(rank["errs"]) == 5
        for name, err in rank["errs"].items():
            assert err <= 1e-12, (name, err)


def test_chip_smoke_loads_without_crp_tpu():
    """``chip_smoke.py`` imported with ``crp_tpu`` and jax blocked: its
    module and the port's engines and kernels load."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    code = (
        "import sys, importlib.util\n"
        "sys.modules['crp_tpu'] = None\nsys.modules['jax'] = None\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "smoke = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(smoke)\n"
        "from crp_tpu_torch import Para2dSpmm, RowParaSpmm\n"
        "assert len(smoke.all_kernels()) == len(smoke.KERNEL_INFO)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]


def _assert_no_result(proc):
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            assert json.loads(line).get("ok") is not True


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    cwd = REPO
    if alone:  # a directory that holds chip_smoke.py and nothing else
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    _assert_no_result(proc)


def test_chip_smoke_imports_only_the_port():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert "crp_tpu_torch" in roots
    assert roots <= {"__future__", "hashlib", "json", "os", "socket", "subprocess", "sys",
                     "tempfile", "time", "numpy", "torch", "crp_tpu_torch"}, roots


@pytest.mark.parametrize("seed,ncols", [(3, 1), (5, 32)])
def test_chip_smoke_reference_matches_spmm_ref(seed, ncols):
    from crp_tpu.sparse.csr import CSRMatrix
    from crp_tpu.sparse.synth import banded_random_csr, fill_b

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    band = banded_random_csr(700, nnz_per_row=6, bandwidth=50, seed=seed,
                             dtype=np.float32)
    rows = np.repeat(np.arange(band.nrow), np.diff(band.rowptr))
    keep = (rows < 300) | (rows >= 310)  # rows 300-309 empty: they come out zero
    a = CSRMatrix.from_coo(band.nrow, band.ncol, rows[keep], band.colidx[keep],
                           band.val[keep], dtype=np.float32)
    assert np.count_nonzero(np.diff(a.rowptr) == 0) >= 10
    b = fill_b(0, a.ncol, 0, ncols, dtype=np.float32)
    want = a.spmm_ref(b.astype(np.float64))
    got = smoke.spmm_ref_f64(a, b)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("prec,dtype,want", [
    ("highest", np.float32, (3, "tf32")),  # #6 on the 3xTF32 body
    ("default", np.float32, (1, "bf16")),  # #8
    ("x3", np.float32, (3, "bf16")),       # #7
    ("highest", np.float64, (1, "fp64_tc")),  # #6 on the FP64 tensor cores
])
def test_chip_smoke_prices_ragged_points(prec, dtype, want):
    """The smoke's ``op_point`` prices a ragged pack's products by the
    body that runs them: ``highest`` on fp32 as three TF32 passes, like the
    windowed kernels there; ``default`` one bf16 pass, x3 three; fp64 one
    pass on the FP64 tensor cores (#6 and #3 on #11's DMMA body)."""
    from crp_tpu_torch.kernels.dispatch import _pack_ragged, pack_local_kernel
    from crp_tpu_torch.sparse.synth import banded_random_csr, powerlaw_random_csr

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    a = powerlaw_random_csr(2000, avg_degree=12, seed=3, dtype=dtype)
    _, op = _pack_ragged([(a.rowptr, a.colidx.astype(np.int32), a.val)], a.nrow, dtype,
                         prec, torch.device("cpu"), geometry=(128, 256))
    assert op.variant == "ragged"
    assert smoke.op_point(op, torch.float64 if dtype == np.float64 else torch.float32) \
        == want
    band = banded_random_csr(900, nnz_per_row=6, bandwidth=40, seed=1, dtype=dtype)
    _, op = pack_local_kernel([(band.rowptr, band.colidx.astype(np.int32), band.val)],
                              band.nrow, dtype, "pallas", device="cpu",
                              mxu_precision=prec)
    assert op.variant == "uniform"  # the windowed kernels price alike
    assert smoke.op_point(op, torch.float64 if dtype == np.float64 else torch.float32) \
        == want


_NO_JAX_REORDER = r"""
import sys
sys.modules["jax"] = None
sys.modules["ml_dtypes"] = None
sys.modules["crp_tpu"] = None
import io, json, os, tempfile
from contextlib import redirect_stdout
import numpy as np
from crp_tpu_torch import (
    CSRMatrix, Para2dSpmm, SpmmConfig, cluster_reorder, fill_b, metis_row_partition,
    native, permute_symmetric, plan_from_csr, powerlaw_community_csr, rcm_reorder,
    rel_fro_err,
)
from crp_tpu_torch.cli import bench_cli, plan_cli, project_cli, suite_cli
from crp_tpu_torch.plan import project
from crp_tpu_torch.sparse import metis, mmio, reorder
from crp_tpu_torch.utils import debug, timers

a = powerlaw_community_csr(4096, 12, 256, seed=5, permute=True)
b = fill_b(0, a.ncol, 0, 16)
ref = a.spmm_ref(b)
errs = {}
for name, fn in (("cluster", cluster_reorder), ("rcm", rcm_reorder)):
    out, perm = fn(a)
    errs[name] = rel_fro_err(ref[perm], out.spmm_ref(b[perm]))
out, perm, displs = metis_row_partition(a, 4)
errs["metis"] = rel_fro_err(ref[perm], out.spmm_ref(b[perm]))
assert out.backend == reorder.partition_backend() == "native" and native.available()
assert displs[-1] == a.nrow
am = CSRMatrix(a.nrow, a.ncol, a.rowptr.copy(), a.colidx.copy(), a.val.copy())
plan = plan_from_csr(am, 16, 4, method="metis")
assert np.array_equal(am.colidx, out.colidx) and "Calculated 2D grid" in plan.describe()
eng = Para2dSpmm(am, plan, device="cpu", dtype=np.float64, config=SpmmConfig())
errs["para2d metis"] = rel_fro_err(am.spmm_ref(b), eng.exec(b))
with redirect_stdout(io.StringIO()) as f:
    for method in ("0", "1", "2"):
        assert plan_cli.main(["synth:cplaw:2048:8:256:85:perm", "16", "4", method]) == 0
assert f.getvalue().count("Calculated 2D grid") == 3
with tempfile.TemporaryDirectory() as d:
    debug.dump_binary(b, os.path.join(d, "b.bin"))
    assert np.array_equal(debug.load_binary(os.path.join(d, "b.bin")), b)
assert not metis.available()
# the drivers, the projection and the .mtx reader and writer
with redirect_stdout(io.StringIO()) as f:
    assert bench_cli.main(["synth:banded:600:5:25", "8", "1", "0", "1", "--engine=crp",
                           "--dtype=float64", "--devices=4", "--device=cpu"]) == 0
    assert suite_cli.main(["vary_n", "synth:banded:600:5:25", "2", "--ns=8",
                           "--engine=rowpara", "--device=cpu", "--project=1"]) == 0
    assert project_cli.main(["synth:banded:600:5:25", "8", "--procs=1,2"]) == 0
lines = f.getvalue().splitlines()
errs["bench crp"] = float(lines[[i for i, l in enumerate(lines) if "C_ref" in l][0]]
                          .split("=")[-1])
rec = json.loads([l for l in lines if l.startswith('{"matrix"')][0])
assert rec["rel_fro_err"] <= 1e-5  # the suite's fp32 class
assert rec["projected"]["p"] == 2 and project.RATE_PROVENANCE
with tempfile.TemporaryDirectory() as d:
    mmio.write_mtx(os.path.join(d, "a.mtx"), a)
    back = mmio.mm_read_sparse(os.path.join(d, "a.mtx"))
    assert back.backend == "scipy" and np.array_equal(back.val, a.val)
    back = mmio.mm_read_sparse(os.path.join(d, "a.mtx"), backend="native")
    assert back.backend == "native" and np.array_equal(back.val, a.val)
assert timers.get_wtime_sec() > 0
loaded = [m for m in sys.modules if sys.modules[m] is not None]
assert not any(m == "jax" or m.startswith(("jax.", "ml_dtypes")) for m in loaded), \
    "jax got imported"
assert not any(m == "crp_tpu" or m.startswith("crp_tpu.") for m in loaded), \
    "crp_tpu got imported"
print(json.dumps(errs))
"""


def test_reorder_modules_run_without_jax():
    """The reordering layer (``cluster_reorder``, RCM, the METIS seam with
    its native partitioner), the planner's ``method="metis"`` under
    ``Para2dSpmm``, the planner CLI, the debug dumps, the drivers
    (``bench_cli``, ``suite_cli``, ``project_cli``), the projection and
    the ``.mtx`` reader and writer import and run with ``crp_tpu``, jax
    and ml_dtypes blocked."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_REORDER], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    errs = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(errs) == ["bench crp", "cluster", "metis", "para2d metis", "rcm"]
    for name, err in errs.items():
        assert err <= 1e-12, (name, err)
