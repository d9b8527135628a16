"""RowParaSpmm on a mesh of ranks: p gloo ranks on the CPU, one process
each (``tests/torch_dist_ranks.py``), against the port's one-device
engine (every rank's C, C shard and packed arrays bit for bit) and the
JAX engine on p devices of the CPU mesh (C within 1e-12 in fp64 and the
point's class in fp32; the exchanged and physical rows equal)."""

import numpy as np
import pytest
import torch

from crp_tpu.config import SpmmConfig as JaxConfig
from crp_tpu.engine.rowpara import RowParaSpmm as JaxRowPara
from crp_tpu.shard.layout import make_mesh_1d

from crp_tpu_torch.comm import ring as tring
from crp_tpu_torch.config import SpmmConfig
from crp_tpu_torch.engine.rowpara import RowParaSpmm
from crp_tpu_torch.kernels import dispatch as td
from crp_tpu_torch.plan.partition1d import csr_row_partition
from crp_tpu_torch.sparse.synth import banded_random_csr, fill_b, powerlaw_random_csr
from crp_tpu_torch.utils.norms import rel_fro_err

from tests.torch_dist_ranks import bits, run_ranks

TOL = {"x3": 1e-5, "default": 5e-3, "highest": 1e-6}  # fp32 against JAX, the points' classes
RING_BLOCK_BYTES = 24000  # overlap's segment-sum chunks: a few hundred entries (more than
# a 128-slot piece), so that ranks' runs start inside the stacked pack's chunks and
# their pieces must be cut where the stacked pack's are

# id -> (matrix, config, dtype, n)
CASES = {
    "segsum-a2a": (lambda: banded_random_csr(900, 7, 50, seed=41),
                   dict(kernel="segsum", rb_p2p=0), np.float64, 16),
    "segsum-ring-plaw": (lambda: powerlaw_random_csr(700, avg_degree=6, seed=42),
                         dict(kernel="segsum", rb_p2p=1), np.float64, 12),
    "pallas-ring-x3": (lambda: banded_random_csr(1100, 7, 60, seed=43, dtype=np.float32),
                       dict(kernel="pallas", mxu_precision="x3", rb_p2p=1), np.float32, 24),
    "pallas-a2a-default": (lambda: banded_random_csr(1000, 7, 60, seed=44,
                                                     dtype=np.float32),
                           dict(kernel="pallas", mxu_precision="default", rb_p2p=0),
                           np.float32, 16),
    "overlap-highest": (lambda: banded_random_csr(1000, 9, 70, seed=45, dtype=np.float32),
                        dict(kernel="pallas", mxu_precision="highest", overlap=1),
                        np.float32, 20),
    "overlap-segsum": (lambda: powerlaw_random_csr(800, avg_degree=5, seed=46),
                       dict(kernel="segsum", overlap=1), np.float64, 8),
    "halo-fp64": (lambda: banded_random_csr(1200, 7, 60, seed=47),
                  dict(kernel="pallas_halo"), np.float64, 16),
    "halo-x3": (lambda: banded_random_csr(1300, 7, 60, seed=48, dtype=np.float32),
                dict(kernel="pallas_halo", mxu_precision="x3"), np.float32, 16),
    "dd": (lambda: banded_random_csr(900, 7, 50, seed=49), dict(kernel="dd"),
           np.float64, 16),
}
PS = (2, 3, 4)


def _case(cid, p):
    gen, cfg, dtype, n = CASES[cid]
    a = gen()
    d = csr_row_partition(a.rowptr, p)
    case = dict(engine="rowpara", a=a, displs=d, n=n, dtype=dtype, config=cfg,
                b=np.asarray(fill_b(0, a.ncol, 0, n, dtype=dtype)))
    if cfg.get("overlap"):
        case["ring_block_bytes"] = RING_BLOCK_BYTES
    return case


@pytest.fixture(scope="module")
def ranks():
    """Every case at each p, one set of p rank processes per p."""
    out = {}
    for p in PS:
        cases = [_case(cid, p) for cid in CASES]
        out[p] = dict(zip(CASES, zip(cases, zip(*run_ranks(p, "engines", cases)))))
    return out


def _jax_physical(j):
    if j.is_halo:
        return j.hplan.halo_rows_pushed
    if j.overlap or j.config.rb_p2p:
        return j.xplan.physical_rows_ring
    return j.xplan.physical_rows


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("cid", sorted(CASES))
def test_rowpara_on_ranks(ranks, devices8, monkeypatch, cid, p):
    case, per_rank = ranks[p][cid]
    monkeypatch.setattr(tring, "SEGSUM_BLOCK_BYTES",
                        case.get("ring_block_bytes", tring.SEGSUM_BLOCK_BYTES))
    a, d, n, b, dtype = case["a"], case["displs"], case["n"], case["b"], case["dtype"]
    one = RowParaSpmm(a, d, d, n, device="cpu", config=SpmmConfig(**case["config"]),
                      dtype=dtype)
    c1 = one.exec(b)
    shards = one.exec_device(one.shard_b(b)).numpy()
    packed = [bits(x) for x in one.packed]
    for r, got in enumerate(per_rank):
        assert got["pi"] == r and got["kernel_kind"] == one.kernel_kind
        assert np.array_equal(got["c"], c1) and np.array_equal(got["again"], c1)
        assert got["shard"].shape == (1, *shards.shape[1:])
        assert np.array_equal(got["shard"][0], shards[r])
        if one.is_halo:  # the rank's shard of the panels and windows; the tables whole
            ws, ws_rel, *panels, push, chunk_src = packed
            mine = [ws[r : r + 1], ws_rel[r : r + 1], *(t[r : r + 1] for t in panels),
                    push, chunk_src]
        else:
            mine = [x[r : r + 1] for x in packed]
        assert len(got["packed"]) == len(mine)
        for x, y in zip(got["packed"], mine):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert (got["rB_recv_size"], got["physical_rows"]) == (one.rB_recv_size,
                                                               one.physical_rows)
        assert f"Rank {r} of {p}" in got["stat"]
        assert not got["aliased"]

    jcfg = {k: v for k, v in case["config"].items()}
    j = JaxRowPara(a, d, d, n, mesh=make_mesh_1d(p, devices=devices8[:p]),
                   config=JaxConfig(**jcfg), dtype=dtype)
    assert j.kernel_kind == one.kernel_kind
    assert (j.rB_recv_size, _jax_physical(j)) == (per_rank[0]["rB_recv_size"],
                                                  per_rank[0]["physical_rows"])
    if j.is_halo:
        assert per_rank[0]["halo_rows_pushed"] == j.hplan.halo_rows_pushed
    cj = j.exec(b)
    tol = 1e-12 if np.dtype(dtype) == np.float64 else TOL[case["config"]["mxu_precision"]]
    assert rel_fro_err(np.asarray(cj, np.float64), per_rank[0]["c"]) <= tol
    assert rel_fro_err(a.spmm_ref(b.astype(np.float64)), per_rank[0]["c"]) <= max(tol, 1e-12)


def _rank_pack_shards(gen, p, dtype, empty=None):
    """p row shards of ``gen()``'s matrix as (rowptr, columns, values); shard
    ``empty`` has no nonzero."""
    a = gen()
    d = np.linspace(0, a.nrow, p + 1).astype(np.int64)
    out = []
    for i in range(p):
        sh = a.row_slice(int(d[i]), int(d[i + 1]))
        keep = 0 if i == empty else sh.nnz
        out.append((sh.rowptr if keep else np.zeros(sh.nrow + 1, np.int64),
                    sh.colidx[:keep].astype(np.int32), sh.val[:keep].astype(dtype)))
    return out, int(np.diff(d).max())


_BAND = lambda: banded_random_csr(1200, 7, 60, seed=51)  # noqa: E731
_PLAW = lambda: powerlaw_random_csr(900, avg_degree=8, seed=52)  # noqa: E731
# id -> (matrix, dtype, empty shard, pack(shards, max_m, dtype, rank))
RANK_PACKS = {
    "segsum": (_PLAW, np.float64, 1, lambda s, m, dt, r: td.pack_local_kernel(
        s, m, dt, "segsum", device="cpu", rank=r)),
    "ell": (_BAND, np.float64, None, lambda s, m, dt, r: td.pack_local_kernel(
        s, m, dt, "ell", device="cpu", rank=r)),
    "window-x3": (_BAND, np.float32, None, lambda s, m, dt, r: td.pack_local_kernel(
        s, m, dt, "pallas", device="cpu", mxu_precision="x3", rank=r)),
    "window-highest": (_BAND, np.float32, 2, lambda s, m, dt, r: td.pack_local_kernel(
        s, m, dt, "pallas", device="cpu", mxu_precision="highest", rank=r)),
    "ragged-segsum-spill": (_PLAW, np.float32, 1, lambda s, m, dt, r: td._pack_ragged(
        s, m, dt, "x3", CPU, geometry=(128, 256), min_chunk_nnz=40, spill_impl="segsum",
        rank=r)),
    "ragged-twopass-spill": (_PLAW, np.float64, 1, lambda s, m, dt, r: td._pack_ragged(
        s, m, dt, "highest", CPU, geometry=(128, 256), min_chunk_nnz=40,
        spill_impl="twopass", rank=r)),
    "ragged-clip-spill": (_PLAW, np.float32, 2, lambda s, m, dt, r: td._pack_ragged(
        s, m, dt, "x3", CPU, geometry=(128, 256), min_chunk_nnz=40, spill_impl="clip",
        rank=r)),
    "ragged-pallas-spill": (_PLAW, np.float32, 1, lambda s, m, dt, r: td._pack_ragged(
        s, m, dt, "default", CPU, geometry=(128, 256), min_chunk_nnz=40,
        spill_impl="pallas", rank=r)),
    "ragged-highest": (_PLAW, np.float32, 1, lambda s, m, dt, r: td._pack_ragged(
        s, m, dt, "highest", CPU, geometry=(128, 256), min_chunk_nnz=40,
        spill_impl="pallas", rank=r)),
    "gather": (_PLAW, np.float32, 2, lambda s, m, dt, r: td.pack_local_kernel(
        s, m, dt, "gather", device="cpu", rank=r)),
    "dd": (_PLAW, np.float64, None, lambda s, m, dt, r: td.pack_local_kernel(
        s, m, dt, "dd", device="cpu", rank=r)),
    "dd_mxu": (_BAND, np.float64, 1, lambda s, m, dt, r: td.pack_local_kernel(
        s, m, dt, "dd_mxu", device="cpu", rank=r)),
}
CPU = torch.device("cpu")


@pytest.mark.parametrize("kind", sorted(RANK_PACKS))
def test_rank_pack_is_the_stacked_slice(kind):
    """A mesh rank's pack (``rank=``) is slice [rank] of the stacked pack,
    array by array and bit for bit, with the same op (its geometry and
    counts from every shard), though only that shard's arrays are made on
    the device: the other shards' spills and row views are made one at a
    time."""
    gen, dtype, empty, pack = RANK_PACKS[kind]
    p = 3
    shards, max_m = _rank_pack_shards(gen, p, dtype, empty)
    full, op = pack(shards, max_m + 40, dtype, None)
    for r in range(p):
        mine, op_r = pack(shards, max_m + 40, dtype, r)
        assert type(op_r) is type(op) and op_r.min_b_rows == op.min_b_rows
        assert getattr(op_r, "roofline", None) == getattr(op, "roofline", None)
        assert len(mine) == len(full)
        for x, y in zip(mine, full):
            assert x.shape == (1, *y.shape[1:]) and x.dtype == y.dtype
            assert np.array_equal(bits(x), bits(y[r : r + 1]))
