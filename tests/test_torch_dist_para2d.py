"""Para2dSpmm on a pm x pn mesh of 4 gloo ranks on the CPU, one process
each (``tests/torch_dist_ranks.py``): block (pi, pj) on rank pi*pn + pj,
the B exchange along pm inside each column group, ``from_dist_a``'s
all_gather on the row group.  Against the port's one-device engine
(every rank's C, C block and packed panel bit for bit) and the JAX engine
on 4 devices of the CPU mesh (C within 1e-12 in fp64 and the point's
class in fp32; the comm lines of ``print_stat`` equal)."""

import numpy as np
import pytest

from crp_tpu.config import SpmmConfig as JaxConfig
from crp_tpu.engine.para2d import Para2dSpmm as JaxPara2d
from crp_tpu.shard.layout import make_mesh_2d

from crp_tpu_torch import Para2dSpmm
from crp_tpu_torch.config import SpmmConfig
from crp_tpu_torch.shard.dist_a import DistCSR
from crp_tpu_torch.sparse.synth import banded_random_csr, fill_b, powerlaw_random_csr
from crp_tpu_torch.utils.norms import rel_fro_err

from tests.test_torch_para2d import _comm_lines, force_plan
from tests.torch_dist_ranks import bits, run_ranks

GRIDS = ((2, 2), (1, 4), (4, 1))
# id -> (matrix, config, dtype, n, engine)
CASES = {
    "segsum-a2a": (lambda: banded_random_csr(600, 7, 40, seed=51),
                   dict(kernel="segsum", rb_p2p=0), np.float64, 20, "para2d"),
    "segsum-ring-plaw": (lambda: powerlaw_random_csr(500, avg_degree=6, seed=52),
                         dict(kernel="segsum", rb_p2p=1), np.float64, 16, "para2d"),
    "pallas-ring-x3": (lambda: banded_random_csr(900, 7, 60, seed=53, dtype=np.float32),
                       dict(kernel="pallas", mxu_precision="x3", rb_p2p=1), np.float32,
                       24, "para2d"),
    "overlap-segsum": (lambda: banded_random_csr(700, 9, 50, seed=54),
                       dict(kernel="segsum", overlap=1), np.float64, 12, "para2d"),
    "halo-fp64": (lambda: banded_random_csr(1100, 7, 60, seed=55),
                  dict(kernel="pallas_halo"), np.float64, 16, "para2d"),
    "from_dist_a": (lambda: banded_random_csr(650, 7, 40, seed=56),
                    dict(kernel="segsum", rb_p2p=0), np.float64, 20, "para2d_dist"),
    "from_dist_a-ring": (lambda: powerlaw_random_csr(520, avg_degree=5, seed=57),
                         dict(kernel="segsum", rb_p2p=1), np.float64, 16, "para2d_dist"),
}
TOL = {"x3": 1e-5, "default": 5e-3, "highest": 1e-6}


# the fused kernel fuses an exchange along pm: not on the 1 x 4 grid
RUNS = [(g, cid) for g in GRIDS for cid in CASES if not (cid == "halo-fp64" and g[0] == 1)]


def _cases():
    out = []
    for (pm, pn), cid in RUNS:
        gen, cfg, dtype, n, engine = CASES[cid]
        a = gen()
        out.append(dict(id=(pm, pn, cid), engine=engine, a=a, dtype=dtype,
                        plan=force_plan(a, n, pm, pn), config=cfg,
                        b=np.asarray(fill_b(0, a.ncol, 0, n, dtype=dtype))))
    return out


@pytest.fixture(scope="module")
def ranks():
    cases = _cases()
    per_rank = run_ranks(4, "engines", cases)
    return {c["id"]: (c, [r[i] for r in per_rank]) for i, c in enumerate(cases)}


def _one_device(case):
    cfg = SpmmConfig(**case["config"])
    if case["engine"] == "para2d":
        return Para2dSpmm(case["a"], case["plan"], device="cpu", config=cfg,
                          dtype=case["dtype"])
    return Para2dSpmm.from_dist_a(DistCSR.from_global(case["a"], case["plan"].A0_rowptr),
                                  case["plan"], device="cpu", config=cfg,
                                  dtype=case["dtype"])


@pytest.mark.parametrize("grid,cid", RUNS, ids=[f"{g[0]}x{g[1]}-{c}" for g, c in RUNS])
def test_para2d_on_ranks(ranks, devices8, grid, cid):
    pm, pn = grid
    case, per_rank = ranks[(pm, pn, cid)]
    a, plan, b, dtype = case["a"], case["plan"], case["b"], case["dtype"]
    one = _one_device(case)
    c1 = one.exec(b)
    blocks = one.exec_device(one.shard_b(b)).numpy()
    packed = [bits(x) for x in one.packed]
    for r, got in enumerate(per_rank):
        pi, pj = divmod(r, pn)
        assert (got["pi"], got["pj"]) == (pi, pj)
        assert got["kernel_kind"] == one.kernel_kind
        assert np.array_equal(got["c"], c1) and np.array_equal(got["again"], c1)
        assert got["shard"].shape == (1, 1, *blocks.shape[2:])
        assert np.array_equal(got["shard"][0, 0], blocks[pi, pj])
        if one.is_halo:
            ws, ws_rel, *panels, push, chunk_src = packed
            mine = [ws[pi : pi + 1], ws_rel[pi : pi + 1],
                    *(t[pi : pi + 1] for t in panels), push, chunk_src]
        else:
            mine = [x[pi : pi + 1] for x in packed]
        for x, y in zip(got["packed"], mine, strict=True):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert (got["rB_recv_size"], got["physical_rows"]) == (one.rB_recv_size,
                                                               one.physical_rows)
        assert f"(pi, pj) = ({pi}, {pj})" in got["stat"]
        assert not got["aliased"]
        assert _comm_lines(got["stat"]) == _comm_lines(one.print_stat())

    j = JaxPara2d(a, plan, mesh=make_mesh_2d(pm, pn, devices=devices8[:4]),
                  config=JaxConfig(**case["config"]), dtype=dtype)
    assert j.kernel_kind == one.kernel_kind
    assert (j.rA_cost, j.rB_recv_size) == (one.rA_cost, per_rank[0]["rB_recv_size"])
    cj = j.exec(b)
    lines, jlines = _comm_lines(per_rank[0]["stat"]), _comm_lines(j.print_stat())
    if one.is_halo:  # JAX's 2D engine prints the unfused plan's rows, the port the pushes
        lines, jlines = lines[:-1], jlines[:-1]
    assert lines == jlines
    tol = 1e-12 if np.dtype(dtype) == np.float64 else TOL[case["config"]["mxu_precision"]]
    assert rel_fro_err(np.asarray(cj, np.float64), per_rank[0]["c"]) <= tol
    assert rel_fro_err(a.spmm_ref(b.astype(np.float64)), per_rank[0]["c"]) <= max(tol, 1e-12)
