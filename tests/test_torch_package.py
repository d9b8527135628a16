"""Package boundaries: the port runs without jax and ml_dtypes, and the
GPU smoke script imports only the port and refuses to run without a GPU."""

import ast
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]

_NO_JAX = r"""
import sys
sys.modules["jax"] = None
sys.modules["ml_dtypes"] = None
import json
import numpy as np
import crp_tpu_torch
from crp_tpu_torch import (
    RowParaSpmm, SpmmConfig, banded_random_csr, csr_row_partition, fill_b,
    rel_fro_err,
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
assert not any(m == "jax" or m.startswith(("jax.", "ml_dtypes")) for m in sys.modules
               if sys.modules[m] is not None), "jax got imported"
assert "crp_tpu.native" not in sys.modules, "crp_tpu.native got imported"
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
    assert roots <= {"__future__", "json", "subprocess", "sys", "time", "numpy",
                     "torch", "crp_tpu_torch"}, roots


@pytest.mark.parametrize("seed,ncols", [(3, 1), (5, 32)])
def test_chip_smoke_reference_matches_spmm_ref(seed, ncols):
    import numpy as np

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
