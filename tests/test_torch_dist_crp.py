"""CrpSpmm, the any-layout engine, on a pm x pn mesh of 4 gloo ranks on
the CPU, one process each (``tests/torch_dist_ranks.py``, job ``crp``):
user block r, internal block (pi, pj) and panel pi's pack on rank
pi*pn + pj; ``rd_B`` / ``rd_C`` (and distributed A's ``rd_Ai`` /
``rd_Av``) on the world group, the B exchange on the column group, A's
Allgatherv on the row group.  Against the port's one-device engine (every
rank's user C block, global C and packed panel bit for bit, every
counter) and JAX's engine on 4 devices of the CPU mesh (every counter; C
within 1e-12 in fp64 and the point's class in fp32, and so of the fp64
reference).  And the pieces alone: ``RedistEngine`` on a mesh (int32,
fp64, empty blocks) and ``ingest_dist_a`` on a mesh, each against the
one-device call."""

import numpy as np
import pytest
import torch

from crp_tpu.config import SpmmConfig as JaxConfig
from crp_tpu.engine.crp import CrpSpmm as JaxCrp
from crp_tpu.shard.dist_a import DistCSR as JaxDistCSR
from crp_tpu.shard.layout import make_mesh_2d
from crp_tpu.shard.redist import BlockDist as JaxBlockDist

from crp_tpu_torch import CrpSpmm, SpmmConfig
from crp_tpu_torch.plan import bandwidth as tbw
from crp_tpu_torch.shard.dist_a import DistCSR, ingest_dist_a
from crp_tpu_torch.shard.redist import BlockDist, RedistEngine
from crp_tpu_torch.sparse.synth import banded_random_csr, fill_b, powerlaw_random_csr
from crp_tpu_torch.utils.blocks import uniform_displs
from crp_tpu_torch.utils.norms import rel_fro_err

from tests.torch_dist_ranks import CRP_COUNTERS, bits, run_ranks

GRIDS = ((4, 1), (2, 2), (1, 4))
TOL = {"x3": 1e-5, "default": 5e-3, "highest": 1e-6}  # fp32: the points' classes
RING_BLOCK_BYTES = 24000  # overlap's segment-sum chunks, as tests/test_torch_dist_rowpara.py
JAX_COUNTERS = CRP_COUNTERS[:-1]  # JAX's engine keeps no physical_rows

# id -> (matrix, config, dtype, n, user layouts, A distributed)
CASES = {
    "segsum-a2a": (lambda: banded_random_csr(600, 7, 40, seed=61),
                   dict(kernel="segsum"), np.float64, 20, "rows", False),
    "finegrain": (lambda: banded_random_csr(640, 9, 50, seed=62),
                  dict(kernel="segsum", a2a_b_finegrain=1), np.float64, 16, "rows", False),
    "ring": (lambda: powerlaw_random_csr(520, avg_degree=6, seed=63),
             dict(kernel="segsum", rb_p2p=1), np.float64, 16, "rows", False),
    "overlap": (lambda: banded_random_csr(700, 9, 50, seed=64),
                dict(kernel="segsum", overlap=1), np.float64, 12, "rows", False),
    "halo-fp64": (lambda: banded_random_csr(1100, 7, 60, seed=65),
                  dict(kernel="pallas_halo"), np.float64, 16, "rows", False),
    "pallas-x3": (lambda: banded_random_csr(900, 7, 60, seed=66, dtype=np.float32),
                  dict(kernel="pallas", mxu_precision="x3"), np.float32, 24, "rows", False),
    "dd": (lambda: banded_random_csr(600, 7, 50, seed=67), dict(kernel="dd"), np.float64,
           16, "rows", False),
    "dist-a": (lambda: banded_random_csr(650, 7, 40, seed=68),
               dict(kernel="segsum"), np.float64, 20, "rows", True),
    "dist-a-halo": (lambda: banded_random_csr(1150, 7, 60, seed=69),
                    dict(kernel="pallas_halo"), np.float64, 16, "rows", True),
    "gather-single": (lambda: banded_random_csr(500, 7, 30, seed=70),
                      dict(kernel="segsum"), np.float64, 8, "root", False),
    "nongrid-b": (lambda: powerlaw_random_csr(560, avg_degree=5, seed=71),
                  dict(kernel="segsum"), np.float64, 12, "nongrid", False),
}
# the fused kernel fuses an exchange along pm: not on the 1 x 4 grid
RUNS = [(g, cid) for g in GRIDS for cid in CASES
        if not (g[0] == 1 and CASES[cid][1].get("kernel") == "pallas_halo")]
PLANNED = "dist-a"  # also run with the engine's own plan, from every rank's row ranges


def force_bplan(a, n, pm, pn):
    """The v1 planner's plan with its grid forced to pm x pn (each field
    as ``calc_bandwidth_part2d`` derives it from the grid)."""
    idx = tbw._panel_boundaries(a.rowptr, a.nrow, pm)
    windows = tbw._panel_b_windows(a.row_col_ranges_v1(), idx)
    return tbw.BandwidthPlan(
        nproc=pm * pn, m=a.nrow, n=n, k=a.ncol, np_row=pm, np_col=pn, m_split_idx=idx,
        B_rd_row_displs=uniform_displs(a.ncol, pm), BC_colptr=uniform_displs(n, pn),
        B_windows=windows, copy_B_size=tbw._copy_b_size(windows, n))


def _grid(m, n, pr, pc):
    rd, cd = uniform_displs(m, pr), uniform_displs(n, pc)
    return np.array([[rd[i], cd[j], rd[i + 1] - rd[i], cd[j + 1] - cd[j]]
                     for i in range(pr) for j in range(pc)], dtype=np.int64)


def layouts(a, n, kind):
    """(user B blocks, user C blocks): B in 4 row slabs and C in 4 column
    slabs (the reference driver's), C on owner 0 alone (``root``), or B in
    4 blocks that are no grid (``nongrid``)."""
    ub, uc = _grid(a.ncol, n, 4, 1), _grid(a.nrow, n, 1, 4)
    if kind == "root":
        uc = BlockDist(uc).gather_single(a.nrow, n).blocks
    elif kind == "nongrid":
        k3, h = a.ncol // 3, n // 2
        ub = np.array([[0, 0, k3, n], [k3, 0, a.ncol - k3, h], [k3, h, k3, n - h],
                       [2 * k3, h, a.ncol - 2 * k3, n - h]], dtype=np.int64)
    return ub, uc


def _case(grid, cid, planned=False):
    gen, cfg, dtype, n, lay, dist = CASES[cid]
    a = gen()
    ub, uc = layouts(a, n, lay)
    bp = (tbw.calc_bandwidth_part2d(4, a.nrow, n, a.ncol, a.rowptr, a.row_col_ranges_v1())
          if planned else force_bplan(a, n, *grid))
    case = dict(id=(bp.np_row, bp.np_col, cid, planned), a=a, n=n, dtype=dtype, config=cfg,
                user_B=BlockDist(ub), user_C=BlockDist(uc), bplan=bp, plan_here=planned,
                dist=uniform_displs(a.nrow, 4) if dist else None,
                b=np.asarray(fill_b(0, a.ncol, 0, n, dtype=dtype)))
    if cfg.get("overlap"):
        case["ring_block_bytes"] = RING_BLOCK_BYTES
    return case


def _redist_cases():
    """int32 and fp64; blocks of size zero on either side."""
    rng = np.random.default_rng(72)
    m, n = 37, 11
    rows = np.array([[0, 0, 20, 6], [20, 0, 17, 6], [0, 6, 37, 5], [0, 0, 0, 0]])
    cols = _grid(m, n, 1, 4)
    root = BlockDist(cols).gather_single(m, n, root=2).blocks
    out = []
    for src, dst in ((rows, cols), (cols, root), (root, rows)):
        for dtype in (np.int32, np.float64):
            x = (rng.integers(-1000, 1000, (m, n)) if dtype == np.int32
                 else rng.standard_normal((m, n))).astype(dtype)
            out.append(dict(src=BlockDist(src), dst=BlockDist(dst), x=x))
    return out


def _ingest_cases():
    out = []
    for grid in GRIDS:
        a = powerlaw_random_csr(480, avg_degree=6, seed=73)
        out.append(dict(a=a, displs=uniform_displs(a.nrow, 4), grid=grid, dtype=np.float64,
                        m_split_idx=force_bplan(a, 8, *grid).m_split_idx))
    return out


@pytest.fixture(scope="module")
def ranks():
    cases = [_case(g, cid) for g, cid in RUNS] + [_case(None, PLANNED, planned=True)]
    redist, ingest = _redist_cases(), _ingest_cases()
    per_rank = run_ranks(4, "crp", dict(engines=cases, redist=redist, ingest=ingest),
                         timeout=400.0)
    return dict(
        refused=[r["refused"] for r in per_rank],
        engines={c["id"]: (c, [r["engines"][i] for r in per_rank])
                 for i, c in enumerate(cases)},
        redist=[(c, [r["redist"][i] for r in per_rank]) for i, c in enumerate(redist)],
        ingest=[(c, [r["ingest"][i] for r in per_rank]) for i, c in enumerate(ingest)])


def _one_device(case):
    a = case["a"]
    if case["dist"] is not None:
        a = DistCSR.from_global(a, case["dist"])
    return CrpSpmm(a, case["n"], case["user_B"], case["user_C"], nproc=4, device="cpu",
                   config=SpmmConfig(**case["config"]), dtype=case["dtype"],
                   bplan=None if case["plan_here"] else case["bplan"])


def _check(case, per_rank, monkeypatch, devices8):
    from crp_tpu_torch.comm import ring as tring

    monkeypatch.setattr(tring, "SEGSUM_BLOCK_BYTES",
                        case.get("ring_block_bytes", tring.SEGSUM_BLOCK_BYTES))
    a, b, n, dtype = case["a"], case["b"], case["n"], case["dtype"]
    one = _one_device(case)
    c1 = one.exec(b)
    blocks = one.exec_device(one.rd_B.shard_src(b))
    packed = [bits(x) for x in one.packed]
    pn = one.pn
    for r, got in enumerate(per_rank):
        pi, pj = divmod(r, pn)
        assert (got["pi"], got["pj"], got["grid"]) == (pi, pj, (one.pm, one.pn))
        assert (got["kernel_kind"], got["is_halo"]) == (one.kernel_kind, one.is_halo)
        assert got["counters"] == {k: getattr(one, k) for k in CRP_COUNTERS}
        assert np.array_equal(got["c"], c1) and np.array_equal(got["again"], c1)
        assert got["block"].shape == (1, *blocks.shape[1:])
        assert np.array_equal(got["block"][0], bits(blocks[r]))
        if one.is_halo:  # panel pi's windows and panels; the tables whole
            ws, ws_rel, *panels, push, chunk_src = packed
            mine = [ws[pi : pi + 1], ws_rel[pi : pi + 1], *(t[pi : pi + 1] for t in panels),
                    push, chunk_src]
        else:
            mine = [x[pi : pi + 1] for x in packed]
        assert len(got["packed"]) == len(mine)
        for x, y in zip(got["packed"], mine):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert not got["aliased"] and got["device"] == "cpu"
        assert f"Rank {r} of 4 (pi, pj) = ({pi}, {pj})" in got["stat"]
        assert got["stat"].split("Communicated")[1] == one.print_stat().split(
            "Communicated")[1]

    ja = case["a"]
    if case["dist"] is not None:
        ja = JaxDistCSR.from_global(case["a"], case["dist"])
    j = JaxCrp(ja, n, JaxBlockDist(case["user_B"].blocks), JaxBlockDist(case["user_C"].blocks),
               nproc=4, mesh=make_mesh_2d(one.pm, one.pn, devices=devices8[:4]),
               config=JaxConfig(**case["config"]), dtype=dtype,
               bplan=None if case["plan_here"] else case["bplan"])
    assert (j.pm, j.pn, j.kernel_kind, j.is_halo) == (one.pm, one.pn, one.kernel_kind,
                                                      one.is_halo)
    for k in JAX_COUNTERS:
        assert per_rank[0]["counters"][k] == getattr(j, k), k
    cj = np.asarray(j.exec(b), dtype=np.float64)
    tol = 1e-12 if np.dtype(dtype) == np.float64 else TOL[case["config"]["mxu_precision"]]
    assert rel_fro_err(cj, per_rank[0]["c"]) <= tol
    assert rel_fro_err(a.spmm_ref(b.astype(np.float64)), per_rank[0]["c"]) <= max(tol, 1e-12)


@pytest.mark.parametrize("grid,cid", RUNS, ids=[f"{g[0]}x{g[1]}-{c}" for g, c in RUNS])
def test_crp_on_ranks(ranks, devices8, monkeypatch, grid, cid):
    case, per_rank = ranks["engines"][(*grid, cid, False)]
    _check(case, per_rank, monkeypatch, devices8)


def test_crp_on_ranks_plans_itself(ranks, devices8, monkeypatch):
    """Distributed A and no plan given: each rank reads its own block's
    row ranges alone, and the ranks all_gather them for the planner (the
    reference's ``A_cidx_se`` allgather)."""
    (key,) = [k for k in ranks["engines"] if k[3]]
    case, per_rank = ranks["engines"][key]
    assert key[:2] == (case["bplan"].np_row, case["bplan"].np_col)
    _check(case, per_rank, monkeypatch, devices8)


@pytest.mark.parametrize("i", range(6), ids=[f"{s}-{d}" for s in ("rows>cols", "cols>root",
                                                                   "root>rows")
                                             for d in ("int32", "fp64")])
def test_redist_on_ranks(ranks, i):
    """Each rank's destination block equals block r of the one-device
    engine's bit for bit, blocks of size zero included; ``unshard_dst``
    gives every rank the global matrix."""
    case, per_rank = ranks["redist"][i]
    one = RedistEngine(case["src"], case["dst"], device="cpu", dtype=case["x"].dtype)
    want = one.exec_device(one.shard_src(case["x"]))
    glob = one.unshard_dst(want, *case["x"].shape)
    assert np.array_equal(glob, np.where(_covered(case["dst"], case["x"].shape),
                                         case["x"], 0))
    for r, got in enumerate(per_rank):
        assert got["shape"] == (1, case["src"].max_h, case["src"].max_w)
        assert got["block"].dtype == want.numpy().dtype
        assert np.array_equal(got["block"][0], want[r].numpy())
        assert np.array_equal(got["glob"], glob) and got["glob"].dtype == glob.dtype
        assert got["nelem"] == (one.nelem_dst, one.nelem_moved, one.nelem_physical)


def _covered(bd, shape) -> np.ndarray:
    out = np.zeros(shape, dtype=bool)
    for r, c, h, w in bd.blocks:
        out[r : r + h, c : c + w] = True
    return out


@pytest.mark.parametrize("i", range(len(GRIDS)), ids=[f"{g[0]}x{g[1]}" for g in GRIDS])
def test_ingest_dist_a_on_ranks(ranks, i):
    """``ingest_dist_a`` on a mesh, each rank holding block r alone: the
    panels and both counters equal the one-device call's bit for bit."""
    case, per_rank = ranks["ingest"][i]
    pm, pn = case["grid"]
    panels, rd, agv = ingest_dist_a(DistCSR.from_global(case["a"], case["displs"]),
                                    case["m_split_idx"], pm, pn, torch.device("cpu"),
                                    val_dtype=case["dtype"])
    for got in per_rank:
        assert got["counters"] == (rd, agv)
        assert len(got["panels"]) == pm
        for (nrow, ncol, rowptr, colidx, val), w in zip(got["panels"], panels):
            assert (nrow, ncol) == (w.nrow, w.ncol)
            for x, y in ((rowptr, w.rowptr), (colidx, w.colidx), (val, w.val)):
                assert x.dtype == y.dtype and np.array_equal(x, y)


def test_crp_refuses_a_mesh_that_is_not_its_grid(ranks):
    """The planner's 4 x 1 grid on a 1 x 4 mesh raises on every rank, as
    the other engines do."""
    assert RUNS[0][0] == (4, 1)  # the first case's plan, the one the ranks misplace
    for got in ranks["refused"]:
        assert got is not None and "a 1 x 4 mesh for a 4 x 1 grid" in got
