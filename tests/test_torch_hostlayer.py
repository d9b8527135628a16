"""The port's own host layer equals the ``crp_tpu`` originals it was copied
from (the port imports nothing of ``crp_tpu``): the synthetic generators
and ``fill_b`` bit for bit, the partitioner, comm counting and 2D planner
field by field, the reference planner's oracle replayed through the
port's planner, ``SpmmConfig``, the ``.mtx`` reader and the error norm."""

import json
import os

import numpy as np
import pytest

from crp_tpu import config as jcfg
from crp_tpu.plan import partition1d as jp1
from crp_tpu.plan import planner2d as jp2
from crp_tpu.sparse import mmio as jmm
from crp_tpu.sparse import synth as js
from crp_tpu.utils import blocks as jb
from crp_tpu.utils import norms as jn
from tests.oracle.gen_planner_oracle import oracle_cases

from crp_tpu_torch import config as tcfg
from crp_tpu_torch.plan import partition1d as tp1
from crp_tpu_torch.plan import planner2d as tp2
from crp_tpu_torch.sparse import mmio as tmm
from crp_tpu_torch.sparse import synth as ts
from crp_tpu_torch.sparse.csr import CSRMatrix
from crp_tpu_torch.utils import blocks as tb
from crp_tpu_torch.utils import norms as tn

ORACLE = os.path.join(os.path.dirname(__file__), "fixtures", "planner_oracle.json")

GENERATORS = [
    ("banded_random_csr", dict(n=3000, nnz_per_row=9, bandwidth=120, seed=3)),
    ("banded_random_csr", dict(n=12000, nnz_per_row=11, bandwidth=400, seed=5)),
    ("powerlaw_random_csr", dict(n=2500, avg_degree=13, seed=4)),
    ("powerlaw_community_csr", dict(n=6000, avg_degree=16, comm_size=512, seed=7)),
    ("powerlaw_community_csr", dict(n=6000, avg_degree=8, seed=9, permute=True)),
]


def _same_csr(t, j):
    assert (t.nrow, t.ncol) == (j.nrow, j.ncol)
    for f in ("rowptr", "colidx", "val"):
        x, y = getattr(t, f), getattr(j, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,kw", GENERATORS)
def test_generators_match(name, kw, dtype):
    """The second banded case holds over 100k nonzeros, where the original
    builds fp64 CSR natively: the numpy path gives the same arrays."""
    _same_csr(getattr(ts, name)(dtype=dtype, **kw), getattr(js, name)(dtype=dtype, **kw))


@pytest.mark.parametrize("args", [(0, 50, 0, 7), (13, 40, 5, 33), (0, 1, 0, 1)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fill_b_matches(args, dtype):
    t, j = ts.fill_b(*args, dtype=dtype), js.fill_b(*args, dtype=dtype)
    assert t.dtype == j.dtype
    np.testing.assert_array_equal(t, j)


def test_csr_methods_match():
    t = ts.powerlaw_random_csr(900, avg_degree=7, seed=2)
    j = js.powerlaw_random_csr(900, avg_degree=7, seed=2)
    _same_csr(t.row_slice(100, 700), j.row_slice(100, 700))
    _same_csr(t.transpose(), j.transpose())
    np.testing.assert_array_equal(t.to_dense(), j.to_dense())
    assert t.bandwidth() == j.bandwidth() and t.nnz == j.nnz
    b = js.fill_b(0, t.ncol, 0, 5)
    np.testing.assert_array_equal(t.spmm_ref(b), j.spmm_ref(b))
    rng = np.random.default_rng(0)
    r, c = rng.integers(0, 50, 400), rng.integers(0, 60, 400)  # duplicates kept
    v = rng.standard_normal(400)
    _same_csr(CSRMatrix.from_coo(50, 60, r, c, v), type(j).from_coo(50, 60, r, c, v))


@pytest.mark.parametrize("nblk", [1, 2, 3, 7, 8, 12])
@pytest.mark.parametrize("name,kw", GENERATORS[:3])
def test_partition_and_comm_size_match(name, kw, nblk):
    a = getattr(js, name)(**kw)
    rb = tp1.csr_row_partition(a.rowptr, nblk)
    np.testing.assert_array_equal(rb, jp1.csr_row_partition(a.rowptr, nblk))
    x_displs = tb.uniform_displs(a.ncol, nblk)
    got = tp1.csr_row_part_comm_size(a.ncol, a.rowptr, a.colidx, rb, x_displs)
    want = jp1.csr_row_part_comm_size(a.ncol, a.rowptr, a.colidx, rb, x_displs)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert tp1.prime_factorization(nblk * 30) == jp1.prime_factorization(nblk * 30)


@pytest.mark.parametrize("n,nproc", [(1, 4), (32, 8), (256, 4), (64, 12), (16, 6)])
@pytest.mark.parametrize("name,kw", GENERATORS[:4])
def test_plan_from_csr_matches(name, kw, n, nproc):
    a = getattr(js, name)(**kw)
    got, want = tp2.plan_from_csr(a, n, nproc), jp2.plan_from_csr(a, n, nproc)
    for f in ("nproc", "m", "n", "k", "pm", "pn", "comm_cost", "basic_1d_cost",
              "rA_cost", "rB_cost", "candidates"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("A0_rowptr", "B_rowptr", "AC_rowptr", "BC_colptr", "rB_comm_rows"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.device_coords(nproc - 1) == want.device_coords(nproc - 1)


def test_plan_from_csr_metis_is_not_ported():
    """``method="metis"`` raised before the reordering layer was ported;
    now it permutes ``a`` in place and plans as the JAX package does
    (``tests/test_torch_reorder.py`` holds it against JAX at length)."""
    a = ts.banded_random_csr(200, nnz_per_row=5, bandwidth=10, seed=1)
    aj = ts.banded_random_csr(200, nnz_per_row=5, bandwidth=10, seed=1)
    got = tp2.plan_from_csr(a, 8, 2, method="metis")
    want = jp2.plan_from_csr(aj, 8, 2, method="metis")
    assert (got.pm, got.pn, got.comm_cost) == (want.pm, want.pn, want.comm_cost)
    np.testing.assert_array_equal(a.colidx, aj.colidx)


@pytest.fixture(scope="module")
def oracle():
    with open(ORACLE) as f:
        return json.load(f)


@pytest.mark.parametrize("case", [c[0] for c in oracle_cases()])
def test_oracle_replays_through_the_port(case, oracle):
    """The compiled reference planner's output (``planner_oracle.json``):
    the port's partition and grid search give the same boundaries."""
    by_name = {c[0]: c for c in oracle_cases()}
    _, a, n, nproc, rA = by_name[case]
    expect = oracle[case]
    rb = tp1.csr_row_partition(a.rowptr, nproc)
    np.testing.assert_array_equal(rb, expect["rb_displs0"])
    plan = tp2.calc_spmm_part2d_from_1d(nproc, a.nrow, n, a.ncol, rb, a.rowptr,
                                        a.colidx, rA=rA)
    assert (plan.pm, plan.pn, plan.comm_cost) == (
        expect["pm"], expect["pn"], expect["comm_cost"])
    for f in ("A0_rowptr", "B_rowptr", "AC_rowptr", "BC_colptr"):
        np.testing.assert_array_equal(getattr(plan, f), expect[f])


@pytest.mark.parametrize("length,nblk", [(10, 3), (7, 7), (5, 8), (1000, 12)])
def test_blocks_match(length, nblk):
    np.testing.assert_array_equal(tb.uniform_displs(length, nblk),
                                  jb.uniform_displs(length, nblk))
    for i in range(-1, nblk + 2):
        assert tb.calc_block_spos_size(length, nblk, i) == \
            jb.calc_block_spos_size(length, nblk, i)


def test_spmm_config_matches(monkeypatch):
    assert tcfg.SpmmConfig() == tcfg.SpmmConfig(**vars(jcfg.SpmmConfig()))
    assert vars(tcfg.SpmmConfig()) == vars(jcfg.SpmmConfig())
    for env, val in (("RP_SPMM_P2P", "0"), ("CRP_TPU_MXU_PREC", "x3"),
                     ("CRP_TPU_OVERLAP", "7"), ("RP_SPMM_REIDX", "x")):
        monkeypatch.setenv(env, val)
    assert vars(tcfg.SpmmConfig.from_env()) == vars(jcfg.SpmmConfig.from_env())
    assert tcfg.get_env_int("RP_SPMM_P2P", 1, 0, 1) == jcfg.get_env_int("RP_SPMM_P2P", 1, 0, 1)


@pytest.mark.parametrize("symmetric", [False, True])
def test_read_mtx_csr_matches(tmp_path, symmetric):
    import scipy.io
    import scipy.sparse as sp

    a = js.banded_random_csr(300, nnz_per_row=6, bandwidth=20, seed=8).to_scipy()
    if symmetric:
        a = sp.triu(a + a.T)
    path = str(tmp_path / "a.mtx")
    scipy.io.mmwrite(path, a, symmetry="symmetric" if symmetric else "general")
    _same_csr(tmm.read_mtx_csr(path, quiet=True), jmm.read_mtx_csr(path, quiet=True))
    if not symmetric:
        with pytest.raises(ValueError, match="not symmetric"):
            tmm.read_mtx_csr(path, need_symm=True)


def test_rel_fro_err_matches():
    rng = np.random.default_rng(4)
    x, y = rng.standard_normal((30, 7)), rng.standard_normal((30, 7))
    assert tn.rel_fro_err(x, y) == jn.rel_fro_err(x, y)
    assert tn.rel_fro_err(np.zeros(3), y[0, :3]) == jn.rel_fro_err(np.zeros(3), y[0, :3])
    assert tn.calc_err_2norm(x, y) == jn.calc_err_2norm(x, y)
