"""The port's reordering layer (``crp_tpu_torch/sparse/reorder.py``), the
planner's ``method="metis"``, ``Plan2D.describe``, the planner CLI and the
debug dumps against the JAX package's, on the same seeded inputs: arrays
and permutations bit for bit, plans field by field, printed text line by
line, and ``Para2dSpmm`` on the METIS plan within 1e-12 in fp64."""

import io

import numpy as np
import pytest

import crp_tpu.native as jnative
from crp_tpu.cli import plan_cli as jcli
from crp_tpu.config import SpmmConfig as JaxConfig
from crp_tpu.engine.para2d import Para2dSpmm as JaxPara2d
from crp_tpu.kernels.spmm_ragged import pack_ragged_window
from crp_tpu.plan import planner2d as jp2
from crp_tpu.shard.layout import make_mesh_2d
from crp_tpu.sparse import reorder as jr
from crp_tpu.sparse import synth as js
from crp_tpu.sparse.csr import CSRMatrix as JaxCSR
from crp_tpu.utils import debug as jdebug

from crp_tpu_torch import Para2dSpmm, RowParaSpmm, SpmmConfig, native as tnative
from crp_tpu_torch.cli import plan_cli as tcli
from crp_tpu_torch.kernels import dispatch as td
from crp_tpu_torch.kernels.spmm_ragged import estimate_ragged
from crp_tpu_torch.plan import planner2d as tp2
from crp_tpu_torch.sparse import metis as tmetis
from crp_tpu_torch.sparse import reorder as tr
from crp_tpu_torch.sparse.csr import CSRMatrix
from crp_tpu_torch.utils import debug as tdebug
from crp_tpu_torch.utils.norms import rel_fro_err

PLAN_FIELDS = ("nproc", "m", "n", "k", "pm", "pn", "comm_cost", "basic_1d_cost",
               "rA_cost", "rB_cost", "candidates")
PLAN_ARRAYS = ("A0_rowptr", "B_rowptr", "AC_rowptr", "BC_colptr", "rB_comm_rows")


def symmetrize(a):
    s = (a.to_scipy() + a.to_scipy().T).tocsr()
    return JaxCSR.from_scipy(s)


def assert_same_csr(got, want):
    assert isinstance(got, CSRMatrix)
    assert (got.nrow, got.ncol) == (want.nrow, want.ncol)
    for f in ("rowptr", "colidx", "val"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def assert_same_plan(got, want):
    for f in PLAN_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    for f in PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.describe() == want.describe()


# the matrices of tests/test_reorder_cli.py, symmetrized there as here
CASES = {
    "plaw200": lambda: symmetrize(js.powerlaw_random_csr(200, avg_degree=6, seed=50)),
    "plaw400": lambda: symmetrize(js.powerlaw_random_csr(400, avg_degree=3, seed=51)),
    "banded600": lambda: symmetrize(js.banded_random_csr(600, nnz_per_row=5, bandwidth=8,
                                                         seed=52)),
    "plaw300": lambda: symmetrize(js.powerlaw_random_csr(300, avg_degree=5, seed=61)),
    "banded400": lambda: symmetrize(js.banded_random_csr(400, nnz_per_row=5, bandwidth=30,
                                                         seed=62)),
}


@pytest.mark.parametrize("name", ["plaw200", "banded600"])
def test_permute_symmetric_matches_jax(name):
    a = CASES[name]()
    perm = np.random.default_rng(0).permutation(a.nrow)
    got, want = tr.permute_symmetric(a, perm), jr.permute_symmetric(a, perm)
    assert_same_csr(got, want)
    b = np.asarray(js.fill_b(0, a.nrow, 0, 8))
    np.testing.assert_allclose(got.spmm_ref(b[perm]), a.spmm_ref(b)[perm], rtol=1e-12)


@pytest.mark.parametrize("name", ["plaw400", "banded600", "plaw300"])
def test_rcm_reorder_matches_jax(name):
    a = CASES[name]()
    if name == "banded600":  # the scrambled banded case of the JAX test
        a = jr.permute_symmetric(a, np.random.default_rng(1).permutation(a.nrow))
    (got, gperm), (want, wperm) = tr.rcm_reorder(a), jr.rcm_reorder(a)
    np.testing.assert_array_equal(gperm, wperm)
    assert gperm.dtype == np.int64
    assert_same_csr(got, want)
    assert got.bandwidth() <= a.bandwidth()


def test_rcm_shrinks_planner_windows_as_jax():
    base = CASES["banded600"]()
    scrambled = jr.permute_symmetric(base, np.random.default_rng(1).permutation(600))
    restored, _ = tr.rcm_reorder(scrambled)
    p_bad, p_good = tp2.plan_from_csr(scrambled, 64, 8), tp2.plan_from_csr(restored, 64, 8)
    assert p_good.comm_cost < p_bad.comm_cost
    assert p_good.comm_cost == jp2.plan_from_csr(jr.rcm_reorder(scrambled)[0], 64, 8).comm_cost


def test_rcm_refuses_rectangular():
    a = CSRMatrix(2, 3, np.array([0, 1, 2]), np.array([0, 2], np.int32), np.ones(2))
    with pytest.raises(ValueError, match="square"):
        tr.rcm_reorder(a)


@pytest.mark.parametrize("name,nparts", [("plaw300", 4), ("banded400", 8), ("plaw200", 3)])
def test_metis_row_partition_matches_jax(name, nparts):
    a = CASES[name]()
    got, gperm, gdispls = tr.metis_row_partition(a, nparts)
    want, wperm, wdispls = jr.metis_row_partition(a, nparts)
    assert got.backend == "native"
    np.testing.assert_array_equal(gperm, wperm)
    np.testing.assert_array_equal(gdispls, wdispls)
    assert gperm.dtype == gdispls.dtype == np.int64
    assert_same_csr(got, want)
    np.testing.assert_array_equal(tr.metis_partition_rows(a, nparts),
                                  jr.metis_partition_rows(a, nparts))


def test_metis_chain_without_a_compiler_takes_the_twins(monkeypatch):
    """Where the native build is unavailable, both packages take their
    numpy twins, and those decide alike."""
    monkeypatch.setattr(tnative, "_load", lambda: None)
    monkeypatch.setattr(jnative, "ggp_partition", lambda *args, **kw: None)
    a = CASES["plaw300"]()
    assert tr.partition_backend() == tr.bisect_backend() == "numpy"
    got, gperm, gdispls = tr.metis_row_partition(a, 4)
    want, wperm, wdispls = jr.metis_row_partition(a, 4)
    assert got.backend == "numpy"
    np.testing.assert_array_equal(gperm, wperm)
    np.testing.assert_array_equal(gdispls, wdispls)
    assert_same_csr(got, want)


def test_libmetis_is_absent_here_and_the_chain_takes_native():
    """With neither libmetis nor pymetis installed, the binding reports it
    as JAX's does, and the chain takes the native greedy graph growing."""
    from crp_tpu.sparse import metis as jmetis

    assert tmetis.available() is jmetis.available() is False
    assert tr._pymetis() is None
    assert tr.partition_backend() == "native"
    with pytest.raises(RuntimeError, match="not found"):
        tmetis.part_graph_kway(np.array([0, 1, 2]), np.array([1, 0]), 2)


def test_libmetis_comes_first_in_the_chain(monkeypatch):
    """Where a libmetis loads, the chain calls it with the reference's
    ubvec and returns its parts (a stand-in library here)."""
    calls = []

    def part_graph_kway(rowptr, colidx, nparts, imbalance=1.05):
        calls.append((nparts, imbalance))
        return np.arange(len(rowptr) - 1, dtype=np.int64) % nparts

    monkeypatch.setattr(tmetis, "available", lambda: True)
    monkeypatch.setattr(tmetis, "part_graph_kway", part_graph_kway)
    a = CASES["plaw200"]()
    assert tr.partition_backend() == "libmetis"
    out, perm, displs = tr.metis_row_partition(a, 4)
    assert out.backend == "libmetis" and calls == [(4, 1.05)]
    np.testing.assert_array_equal(displs, [0, 50, 100, 150, 200])
    np.testing.assert_array_equal(perm, np.argsort(np.arange(200) % 4, kind="stable"))


def test_refine_bisection_and_spectral_partition_match_jax():
    a = CASES["plaw400"]()
    rowptr, colidx = a.rowptr.astype(np.int64), a.colidx.astype(np.int64)
    parts = np.random.default_rng(3).integers(0, 2, a.nrow).astype(np.int64)
    for rounds in (0, 1, 8):
        np.testing.assert_array_equal(
            tr._refine_bisection(rowptr, colidx, parts, rounds, 1.10),
            jr._refine_bisection(rowptr, colidx, parts, rounds, 1.10))
    np.testing.assert_array_equal(tr.spectral_partition_rows(a, 5),
                                  jr.spectral_partition_rows(a, 5))


@pytest.fixture(scope="module")
def scrambled():
    """The scrambled community graph of the JAX package's
    ``test_cluster_reorder_recovers_scrambled_communities`` and its
    reorderings by both packages."""
    a = js.powerlaw_community_csr(32768, avg_degree=10, comm_size=1024, p_local=0.85,
                                  permute=True, seed=7)
    return a, tr.cluster_reorder(a, leaf_size=256), jr.cluster_reorder(a, leaf_size=256)


def test_cluster_reorder_matches_jax_on_scrambled_communities(scrambled):
    a, (out, perm), (jout, jperm) = scrambled
    np.testing.assert_array_equal(perm, jperm)
    assert_same_csr(out, jout)
    assert out.backend == "native"
    S0, spill0, _ = estimate_ragged(a.rowptr, a.colidx, 256, 128)
    S1, spill1, _ = estimate_ragged(out.rowptr, out.colidx, 256, 128)
    assert spill0 > 0.6 * a.nnz, (spill0, a.nnz)
    assert spill1 < 0.5 * a.nnz, (spill1, a.nnz)
    assert spill1 < 0.6 * spill0, (spill1, spill0)
    assert np.array_equal(np.sort(perm), np.arange(a.nrow))
    b = np.asarray(js.fill_b(0, a.ncol, 0, 8, dtype=np.float64))
    assert rel_fro_err(a.spmm_ref(b)[perm], out.spmm_ref(b[perm])) <= 1e-13


@pytest.mark.parametrize("geometry", [(512, 128), (256, 128)])
def test_ragged_fill_spill_on_the_reordered_graph_matches_jax(scrambled, geometry):
    """The ragged engine's pack on the reordered graph (what the card's
    engine reports as ``S`` and ``spill_nnz``: the exact fill on the
    columns its exchange plan compacts) equals the JAX pack's on the same
    columns; the cover's estimate on the global columns bounds it."""
    out = scrambled[1][0]
    val = out.val.astype(np.float32)
    d = np.array([0, out.nrow])
    eng = RowParaSpmm(out, d, d, 16, device="cpu", dtype=np.float32,
                      config=SpmmConfig(kernel="ragged", mxu_precision="x3"))
    rl = eng._local_op.roofline
    used = np.unique(out.colidx)
    cc = np.searchsorted(used, out.colidx).astype(np.int32)  # p = 1: the compaction
    rw = pack_ragged_window(out.rowptr, cc, val, len(used), rl["TM"], rl["W"],
                            dtype=np.float32)
    assert (rl["S"], rl["spill_nnz"]) == (rw.S, rw.spill_nnz)
    _, op = td._pack_ragged([(out.rowptr, out.colidx.astype(np.int32), val)], out.nrow,
                            np.float32, "x3", td.torch.device("cpu"), geometry=geometry)
    rw = pack_ragged_window(out.rowptr, out.colidx, val, out.ncol, *geometry,
                            dtype=np.float32)
    assert (op.roofline["spill_nnz"], op.roofline["S"]) == (rw.spill_nnz, rw.S)
    S, est, _ = estimate_ragged(out.rowptr, out.colidx, *geometry)
    assert rw.spill_nnz <= est and rw.S == S


def test_cluster_reorder_edges():
    a = CASES["plaw200"]()
    out, perm = tr.cluster_reorder(a, leaf_size=256)  # one leaf: the identity
    np.testing.assert_array_equal(perm, np.arange(200))
    assert_same_csr(out, jr.cluster_reorder(a, leaf_size=256)[0])
    rect = CSRMatrix(2, 3, np.array([0, 1, 2]), np.array([0, 2], np.int32), np.ones(2))
    with pytest.raises(ValueError, match="symmetric"):
        tr.cluster_reorder(rect)


@pytest.mark.parametrize("spec,n,nproc", [
    ("banded400", 8, 8),   # the JAX package's test_plan_from_csr_metis
    ("plaw300", 16, 4),
    ("cplaw_perm", 16, 4),  # the smoke's METIS path at a smaller size
])
def test_plan_from_csr_metis_matches_jax(spec, n, nproc):
    def make():
        if spec == "cplaw_perm":
            return js.powerlaw_community_csr(8192, 16, 512, seed=1234, permute=True,
                                             dtype=np.float32)
        return CASES[spec]()

    a, aj = make(), make()
    got = tp2.plan_from_csr(a, n, nproc, method="metis")
    want = jp2.plan_from_csr(aj, n, nproc, method="metis")
    assert_same_plan(got, want)
    for f in ("rowptr", "colidx", "val"):  # both permuted in place alike
        np.testing.assert_array_equal(getattr(a, f), getattr(aj, f), err_msg=f)
    ref = make()
    assert not np.array_equal(a.colidx, ref.colidx)
    assert_same_plan(tp2.plan_from_csr(ref, n, nproc), jp2.plan_from_csr(make(), n, nproc))


@pytest.mark.parametrize("nproc,n", [(8, 8), (4, 16)])
def test_para2d_on_the_metis_plan_matches_jax(devices8, nproc, n):
    a = CASES["banded400"]()
    plan = tp2.plan_from_csr(a, n, nproc, method="metis")
    mesh = make_mesh_2d(plan.pm, plan.pn, devices=devices8[:nproc])
    j = JaxPara2d(a, plan, mesh=mesh, config=JaxConfig(), dtype=np.float64)
    t = Para2dSpmm(a, plan, device="cpu", config=SpmmConfig(), dtype=np.float64)
    assert t.kernel_kind == j.kernel_kind
    assert (t.rA_cost, t.rB_recv_size) == (j.rA_cost, j.rB_recv_size)
    assert t.rB_recv_size * n == plan.rB_cost
    b = np.asarray(js.fill_b(0, a.ncol, 0, n))
    ct, cj = t.exec(b), j.exec(b)
    assert rel_fro_err(np.asarray(cj, np.float64), ct) <= 1e-12
    assert rel_fro_err(a.spmm_ref(b), ct) <= 1e-12


def test_describe_matches_jax():
    a = CASES["plaw300"]()
    for nproc, n in ((6, 32), (4, 256), (1, 8)):
        assert tp2.plan_from_csr(a, n, nproc).describe() \
            == jp2.plan_from_csr(a, n, nproc).describe()


def _untimed(text: str) -> list:
    return [ln for ln in text.splitlines() if " time = " not in ln]


@pytest.mark.parametrize("method", ["0", "1", "2"])
@pytest.mark.parametrize("spec,n,nproc", [("synth:banded:500:6:30", "64", "8"),
                                          ("synth:cplaw:4096:12:256:85:perm", "16", "4")])
def test_plan_cli_prints_what_jax_prints(capsys, spec, n, nproc, method):
    assert tcli.main([spec, n, nproc, method]) == 0
    got = capsys.readouterr().out
    assert jcli.main([spec, n, nproc, method]) == 0
    want = capsys.readouterr().out
    assert _untimed(got) == _untimed(want)
    assert "Calculated 2D grid" in got
    assert len(got.splitlines()) - len(_untimed(got)) == 3  # the timing lines


def test_plan_cli_usage(capsys):
    assert tcli.main([]) == 255
    got = capsys.readouterr().out
    assert jcli.main(["a", "b"]) == 255
    assert got == capsys.readouterr().out and got.startswith("Usage: crp-plan")


@pytest.mark.parametrize("arr", [
    np.arange(12, dtype=np.float64).reshape(3, 4) / 7,
    np.arange(10, dtype=np.int32),
    np.ones((2, 3, 4), dtype=np.float32),
    np.zeros((0, 5), dtype=np.int64),
])
def test_debug_dumps_cross_packages(tmp_path, arr):
    t_path, j_path = tmp_path / "t.bin", tmp_path / "j.bin"
    tdebug.dump_binary(arr, str(t_path))
    jdebug.dump_binary(arr, str(j_path))
    assert t_path.read_bytes() == j_path.read_bytes()
    for load in (tdebug.load_binary, jdebug.load_binary):
        for path in (t_path, j_path):
            got = load(str(path))
            assert got.dtype == arr.dtype and got.shape == arr.shape
            assert got.tobytes() == arr.tobytes()
    (tmp_path / "bad.bin").write_bytes(b"XXXX")
    with pytest.raises(ValueError, match="not a"):
        tdebug.load_binary(str(tmp_path / "bad.bin"))


@pytest.mark.parametrize("kw", [{}, {"name": "C", "fmt": "%8.3f"}])
def test_print_matrix_matches_jax(kw):
    mat = np.arange(-6, 6, dtype=np.float64).reshape(3, 4) / 3
    outs = []
    for mod in (tdebug, jdebug):
        buf = io.StringIO()
        mod.print_matrix(mat, file=buf, **kw)
        mod.print_matrix(mat[0], file=buf, **kw)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0].splitlines()[0].endswith("size = 3 * 4:")


def test_in_place_metis_permutation_reuses_no_stale_memo():
    """``plan_from_csr(method="metis")`` rewrites ``a``'s arrays in place;
    the engines' memos on the matrix (the pack memo, the transpose memo)
    are keyed by its arrays' contents, so an engine built after the
    permutation packs the permuted matrix."""
    from crp_tpu_torch.engine.autodiff import transposed

    j = CASES["banded400"]()
    a = CSRMatrix(j.nrow, j.ncol, j.rowptr.copy(), j.colidx.copy(), j.val.copy())
    d = np.array([0, a.nrow])
    b = np.asarray(js.fill_b(0, a.ncol, 0, 8))
    cfg = SpmmConfig(kernel="pallas", mxu_precision="highest")
    before = RowParaSpmm(a, d, d, 8, device="cpu", dtype=np.float64, config=cfg).exec(b)
    t_before = transposed(a)
    assert rel_fro_err(a.spmm_ref(b), before) <= 1e-12
    tp2.plan_from_csr(a, 8, 4, method="metis")
    after = RowParaSpmm(a, d, d, 8, device="cpu", dtype=np.float64, config=cfg).exec(b)
    assert rel_fro_err(a.spmm_ref(b), after) <= 1e-12
    assert not np.allclose(before, after)
    t_after = transposed(a)
    assert t_after is not t_before
    np.testing.assert_array_equal(t_after.colidx, a.transpose().colidx)
