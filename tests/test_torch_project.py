"""The port's projected multi-GPU exec model (``crp_tpu_torch/plan/
project.py``) and ``project_cli``: the three tests of
``tests/test_project.py`` against the port, and the model's terms against
the JAX package's (``crp_tpu/plan/project.py``) on the same matrices.

The byte, FLOP and spill terms and the comm fields equal JAX's exactly at
x3 and default; with JAX's rates passed in, ``kernel_s`` and ``comm_s``
equal JAX's (JAX rounds to the microsecond, the port to the nanosecond:
the port's value rounded to the microsecond is compared); at highest the
port prices 3 TF32 passes where JAX prices 6.
"""

import json

import numpy as np
import pytest

from crp_tpu.plan import project as jproj
from crp_tpu.sparse import synth as js

from crp_tpu_torch.cli import project_cli
from crp_tpu_torch.plan import project as tproj
from crp_tpu_torch.plan.project import project_exec_1d, project_scaling
from crp_tpu_torch.sparse.synth import banded_random_csr, powerlaw_community_csr

# JAX's default rates (crp_tpu/plan/project.py:51-57), in the port's keys
JAX_RATES = dict(x3_tflops=165.0, default_tflops=165.0, highest_tflops=165.0,
                 hbm_gbps=623.0, link_gbps=90.0, spill_ns=21.0)
MATRICES = {
    "banded": dict(kind="banded", n=20000, nnz_per_row=9, bandwidth=300, seed=3),
    "cplaw": dict(kind="cplaw", n=8192, avg_degree=10, comm_size=512, seed=7),
}


@pytest.fixture(autouse=True)
def no_proj_env(monkeypatch):
    for k in ("CRP_PROJ_MXU_TFLOPS", "CRP_PROJ_HBM_GBPS", "CRP_PROJ_ICI_GBPS",
              "CRP_PROJ_SPILL_NS", "CRP_TPU_RAGGED_TM", "CRP_TPU_RAGGED_WC",
              "CRP_TPU_RAGGED_AUTO"):
        monkeypatch.delenv(k, raising=False)


def _pair(name):
    spec = dict(MATRICES[name])
    kind = spec.pop("kind")
    if kind == "banded":
        n = spec.pop("n")
        return banded_random_csr(n, **spec), js.banded_random_csr(n, **spec)
    n = spec.pop("n")
    return powerlaw_community_csr(n, **spec), js.powerlaw_community_csr(n, **spec)


def test_projection_terms_scale_down():
    a = banded_random_csr(20000, nnz_per_row=9, bandwidth=300, seed=3)
    rows = project_scaling(a, 64, [1, 2, 4], mxu_prec="x3")
    assert rows[0]["comm_s"] == 0.0
    assert rows[0]["kernel_s"] > rows[1]["kernel_s"] > rows[2]["kernel_s"]
    for r in rows:
        assert r["projected_s"] >= r["projected_overlap_s"] > 0


def test_projection_comm_matches_exchange_plan():
    from crp_tpu_torch.comm.exchange import build_b_exchange
    from crp_tpu_torch.plan.partition1d import csr_row_partition

    a = banded_random_csr(8000, nnz_per_row=7, bandwidth=200, seed=5)
    p, n = 4, 64
    rec = project_exec_1d(a, n, p, mxu_prec="x3")
    displs = csr_row_partition(a.rowptr, p)
    shards = [a.row_slice(int(displs[i]), int(displs[i + 1])) for i in range(p)]
    xp = build_b_exchange([s.colidx for s in shards], displs, reidx=True)
    assert rec["comm_rows_logical_max"] == int(xp.rB_recv_rows.max())
    assert rec["comm_bytes_per_chip"] == (p - 1) * xp.S * n * 4


def test_projection_calibration_scales_kernel():
    a = powerlaw_community_csr(8192, avg_degree=10, comm_size=512, seed=7)
    base = project_exec_1d(a, 64, 1, mxu_prec="default")
    cal = project_exec_1d(a, 64, 1, mxu_prec="default", calibration=2.0)
    # kernel_s is rounded to 9 decimals in the record
    assert abs(cal["kernel_s"] - 2 * base["kernel_s"]) < 2e-9


def _shard_terms(mod, a, n, p, prec):
    """Each live shard's (hbm_bytes, flops, spill_nnz) as ``project_exec_1d``
    computes them in package ``mod``."""
    from crp_tpu.kernels.spmm_ragged import resolve_ragged_geometry
    from crp_tpu.plan.partition1d import csr_row_partition

    displs = csr_row_partition(a.rowptr, p)
    shards = [a.row_slice(int(displs[i]), int(displs[i + 1])) for i in range(p)]
    big = max(shards, key=lambda sh: sh.nnz).localize()[0]
    geometry = resolve_ragged_geometry(big.rowptr, big.colidx, prec)
    n_pad = -(-n // 128) * 128
    return [mod._shard_kernel_terms(sh.localize()[0], n_pad, prec, 4, geometry=geometry)
            for sh in shards if sh.nnz]


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("prec", ["x3", "default"])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_terms_and_comm_equal_jax(name, prec, p):
    ta, ja = _pair(name)
    np.testing.assert_array_equal(ta.colidx, ja.colidx)
    n = 64
    assert _shard_terms(tproj, ta, n, p, prec) == _shard_terms(jproj, ja, n, p, prec)
    t = project_exec_1d(ta, n, p, mxu_prec=prec, rates=JAX_RATES)
    j = jproj.project_exec_1d(ja, n, p, mxu_prec=prec)
    for k in ("p", "comm_bytes_per_chip", "comm_rows_logical_max"):
        assert t[k] == j[k], k
    for k in ("kernel_s", "comm_s", "projected_s", "projected_overlap_s"):
        assert round(t[k], 6) == j[k], k
    assert t["passes"] == {"x3": 3, "default": 1}[prec] and t["peak"] == "bf16"


def test_highest_prices_three_tf32_passes():
    ta, ja = _pair("banded")
    t_terms = _shard_terms(tproj, ta, 64, 2, "highest")
    j_terms = _shard_terms(jproj, ja, 64, 2, "highest")
    for (tb, tf, ts), (jb, jf, js_) in zip(t_terms, j_terms):
        assert (tb, ts) == (jb, js_) and tf * 2 == jf
    rec = project_exec_1d(ta, 64, 2, mxu_prec="highest")
    assert (rec["passes"], rec["peak"]) == (3, "tf32")
    assert rec["rates"]["tensor_tflops"] == tproj.DEFAULT_RATES["highest_tflops"]


def test_rates_are_arguments_not_environment(monkeypatch):
    a = banded_random_csr(4000, nnz_per_row=9, bandwidth=300, seed=3)
    base = project_exec_1d(a, 64, 2)
    monkeypatch.setenv("CRP_PROJ_HBM_GBPS", "1")
    assert project_exec_1d(a, 64, 2) == base
    slow = project_exec_1d(a, 64, 2, rates=dict(hbm_gbps=1.0, x3_tflops=1.0))
    assert slow["kernel_s"] > base["kernel_s"]
    assert set(tproj.RATE_PROVENANCE) == set(tproj.DEFAULT_RATES)
    assert "UNMEASURED" in tproj.RATE_PROVENANCE["link_gbps"]


def test_project_cli(tmp_path, capsys):
    out = tmp_path / "proj.jsonl"
    rc = project_cli.main(["synth:banded:4000:9:300", "64", "--procs=1,2",
                           "--md", f"--out={out}", "--link-gbps=45",
                           "--calibrate-s=0.001"])
    text = capsys.readouterr().out
    assert rc == 0 and "| p | kernel (s)" in text
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["p"] for r in rows] == [1, 2]
    assert "rate_provenance" in rows[0] and "rate_provenance" not in rows[1]
    # the calibration divides by the p=1 kernel_s as recorded (rounded to
    # the nanosecond, a few microseconds here): within 1e-3 of the target
    assert rows[0]["kernel_s"] == pytest.approx(0.001, rel=1e-3)
    assert rows[1]["rates"]["link_gbps"] == 45.0
    assert project_cli.main([]) == 255
