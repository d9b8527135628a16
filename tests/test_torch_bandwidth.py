"""The port's v1 bandwidth planner (``crp_tpu_torch/plan/bandwidth.py``)
against the compiled reference's decisions (``tests/fixtures/
bandwidth_oracle.json``) and against ``crp_tpu.plan.bandwidth`` on the same
cases, field by field; the three ``CSRMatrix`` methods it and the
any-layout engine need against JAX's; the ``calc_partition_cli`` driver's
output against JAX's.  Every comparison is exact."""

import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

from crp_tpu.cli import calc_partition_cli as jax_cli
from crp_tpu.plan.bandwidth import calc_bandwidth_part2d as jax_plan
from crp_tpu.sparse.csr import CSRMatrix as JaxCSR
from crp_tpu.sparse.synth import banded_random_csr, powerlaw_random_csr
from tests.oracle.gen_bandwidth_oracle import interior_empty_matrix, oracle_cases

from crp_tpu_torch.cli import calc_partition_cli
from crp_tpu_torch.plan.bandwidth import calc_bandwidth_part2d
from crp_tpu_torch.sparse.csr import CSRMatrix

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "bandwidth_oracle.json")
FIELDS = ("nproc", "m", "n", "k", "np_row", "np_col", "copy_B_size")
ARRAYS = ("m_split_idx", "B_rd_row_displs", "BC_colptr", "B_windows")


def port(a) -> CSRMatrix:
    return CSRMatrix(a.nrow, a.ncol, a.rowptr, a.colidx, a.val)


@pytest.fixture(scope="module")
def fixture():
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.mark.parametrize("case", [c[0] for c in oracle_cases()])
def test_planner_matches_oracle_and_jax(case, fixture):
    name, a, n, nproc = next(c for c in oracle_cases() if c[0] == case)
    t = port(a)
    bp = calc_bandwidth_part2d(nproc, t.nrow, n, t.ncol, t.rowptr, t.row_col_ranges_v1())
    ref = fixture[name]
    assert (bp.np_row, bp.np_col) == (ref["pm"], ref["pn"])
    assert bp.m_split_idx.tolist() == ref["m_split_idx"]
    if ref["B_windows"] is not None:  # pm > 1: the reference printed its scan
        assert bp.B_windows.tolist() == ref["B_windows"]
        assert bp.copy_B_size == ref["copy_B_size"]
    jp = jax_plan(nproc, a.nrow, n, a.ncol, a.rowptr, a.row_col_ranges_v1())
    assert all(getattr(bp, f) == getattr(jp, f) for f in FIELDS)
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(bp, f), getattr(jp, f))


def test_trailing_nnz_degenerate_matches_jax():
    """nnz in the last row only: the M split is infeasible, the planner
    takes split N, and with no axis left it raises as JAX does."""
    rows, cols = np.full(10, 99), np.arange(10)
    a = CSRMatrix.from_coo(100, 100, rows, cols, np.ones(10))
    bp = calc_bandwidth_part2d(2, a.nrow, 8, a.ncol, a.rowptr, a.row_col_ranges_v1())
    assert (bp.np_row, bp.np_col) == (1, 2)
    with pytest.raises(ValueError, match="reduce nproc"):
        calc_bandwidth_part2d(2, a.nrow, 1, a.ncol, a.rowptr, a.row_col_ranges_v1())
    with pytest.raises(ValueError, match="reduce nproc"):
        jax_plan(2, a.nrow, 1, a.ncol, a.rowptr, a.row_col_ranges_v1())


def test_dbg_print_trace_matches_jax():
    a = banded_random_csr(3000, nnz_per_row=9, bandwidth=120, seed=21)
    t = port(a)
    outs = []
    for plan, m in ((jax_plan, a), (calc_bandwidth_part2d, t)):
        buf = io.StringIO()
        with redirect_stdout(buf):
            plan(12, m.nrow, 256, m.ncol, m.rowptr, m.row_col_ranges_v1(), dbg_print=True)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "split-M cost" in outs[1]


def _matrices():
    banded = banded_random_csr(500, nnz_per_row=9, bandwidth=40, seed=3)
    empties = interior_empty_matrix()
    # leading and trailing empty rows: the v1 reads that the port clips
    edge = JaxCSR.from_coo(50, 60, np.arange(10, 40), np.arange(5, 35), np.ones(30))
    none = JaxCSR(7, 9, np.zeros(8, np.int64), np.zeros(0, np.int32), np.zeros(0))
    return [banded, powerlaw_random_csr(400, avg_degree=6, seed=4), empties, edge, none]


@pytest.mark.parametrize("i", range(5))
def test_csr_methods_match_jax(i):
    a = _matrices()[i]
    t = port(a)
    np.testing.assert_array_equal(t.row_col_ranges_v1(), a.row_col_ranges_v1())
    np.testing.assert_array_equal(t.row_col_ranges(), a.row_col_ranges())
    (lt, st, wt), (lj, sj, wj) = t.localize(), a.localize()
    assert (st, wt, lt.nrow, lt.ncol) == (sj, wj, lj.nrow, lj.ncol)
    for f in ("rowptr", "colidx", "val"):
        got, want = getattr(lt, f), getattr(lj, f)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_calc_partition_cli_prints_what_jax_prints():
    """The driver's output line by line, the wall-time line aside."""
    outs = []
    for main in (jax_cli.main, calc_partition_cli.main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(["synth:banded:3000:9:120", "64", "8"]) == 0
        outs.append([ln for ln in buf.getvalue().splitlines()
                     if not ln.startswith("Calculate partitioning time")])
    assert outs[0] == outs[1] and outs[1][-1].startswith("Final grid")
    assert calc_partition_cli.main([]) == 255
