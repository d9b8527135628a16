"""The port's numpy copies of the JAX package's packing and exchange
helpers equal their originals.  The port imports nothing of crp_tpu (its
own host layer is pinned in ``tests/test_torch_hostlayer.py``), so it
carries these copies of helpers whose JAX modules import jax."""

import numpy as np
import pytest

from crp_tpu.comm import exchange as jx
from crp_tpu.engine import stats as jstats
from crp_tpu.kernels import dispatch as jd
from crp_tpu.kernels import spmm_jnp as jjnp
from crp_tpu.kernels import spmm_pallas as jsp
from crp_tpu.shard import layout as jlay
from crp_tpu.sparse.csr import CSRMatrix
from crp_tpu.sparse.synth import banded_random_csr
from crp_tpu.utils.timers import Timer as JTimer

from crp_tpu_torch.comm import exchange as tx
from crp_tpu_torch.engine import stats as tstats
from crp_tpu_torch.kernels import dispatch as td
from crp_tpu_torch.kernels import spmm_pallas as tsp
from crp_tpu_torch.kernels import spmm_segsum as tseg
from crp_tpu_torch.shard import layout as tlay
from crp_tpu_torch.utils.timers import Timer as TTimer

# (nrow, nnz_per_row, bandwidth, seed): banded matrices of 2 to 12 groups
CORPUS = [
    (3000, 7, 80, 91),
    (2500, 6, 60, 92),
    (1000, 5, 300, 3),
    (700, 9, 20, 4),
    (257, 4, 10, 5),
    (2048, 11, 700, 6),
]


def _banded(nrow, k, bw, seed, dtype=np.float32):
    return banded_random_csr(nrow, nnz_per_row=k, bandwidth=bw, seed=seed,
                             dtype=dtype)


def _anti_banded(nrow=1500, seed=7):
    """Band along the anti-diagonal: window starts fall group by group."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(nrow), 5)
    cols = np.clip(nrow - 1 - rows + rng.integers(-30, 31, rows.size), 0, nrow - 1)
    key = np.unique(rows * nrow + cols)
    return CSRMatrix.from_coo(nrow, nrow, key // nrow, key % nrow,
                              rng.standard_normal(key.size), dtype=np.float32)


def _ws(a, TM=256):
    min_t, W0 = jsp.window_extents(a.rowptr.astype(np.int64), a.colidx, TM)
    W, _, _ = jsp.choose_chunks(W0)
    return (min_t * jsp.TK).astype(np.int32), W


@pytest.mark.parametrize("W0", [128, 256, 1408, 1536, 1664, 3072, 5376, 9999, 16384])
def test_choose_chunks_matches(W0):
    assert tsp.choose_chunks(W0) == jsp.choose_chunks(W0)


@pytest.mark.parametrize("spec", CORPUS)
@pytest.mark.parametrize("TM", [128, 256])
def test_window_extents_matches(spec, TM):
    a = _banded(*spec)
    rp = a.rowptr.astype(np.int64)
    t_min, t_w0 = tsp.window_extents(rp, a.colidx, TM)
    j_min, j_w0 = jsp.window_extents(rp, a.colidx, TM)
    assert t_w0 == j_w0
    np.testing.assert_array_equal(t_min, j_min)


def test_sg_budget_is_the_tpu_default(monkeypatch):
    monkeypatch.delenv("CRP_TPU_SG_BUDGET", raising=False)
    assert tsp.SG_BUDGET == jsp.default_sg_budget()


@pytest.mark.parametrize("spec", CORPUS)
@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("budget", [None, 4 << 20])
def test_plan_supergroups_matches(monkeypatch, spec, itemsize, budget):
    monkeypatch.delenv("CRP_TPU_SG_BUDGET", raising=False)
    ws, W = _ws(_banded(*spec))
    kw = {} if budget is None else dict(vmem_budget=budget)
    got = tsp.plan_supergroups(ws, W, 256, itemsize, **kw)
    want = jsp.plan_supergroups(ws, W, 256, itemsize, **kw)
    assert (got is None) == (want is None)
    if want is not None:
        assert got[:2] == want[:2]
        np.testing.assert_array_equal(got[2], want[2])
        assert got[2].dtype == want[2].dtype


def test_plan_supergroups_non_monotone_is_none():
    ws, W = _ws(_anti_banded())
    assert np.any(np.diff(ws) < 0)
    assert jsp.plan_supergroups(ws, W, 256, 4) is None
    assert tsp.plan_supergroups(ws, W, 256, 4) is None


@pytest.mark.parametrize("spec", CORPUS + ["anti"])
@pytest.mark.parametrize("small_budget", [True, False])
@pytest.mark.parametrize("itemsize,extra_groups", [(4, 0), (2, 3), (8, 1)])
def test_sg_geometry_matches(monkeypatch, spec, small_budget, itemsize, extra_groups):
    """The JAX plan minus its k-chunk Wc_sg, which the port does not keep."""
    monkeypatch.delenv("CRP_TPU_SG_BUDGET", raising=False)
    a = _anti_banded() if spec == "anti" else _banded(*spec)
    ws, W = _ws(a)
    G = len(ws) + extra_groups
    got = td._sg_geometry(ws, W, itemsize, small_budget, G)
    want = jd._sg_geometry(ws, W, 256, itemsize, small_budget, G)
    assert (got is None) == (want is None)
    if want is not None:
        SG, Wsg, bases, _wc_sg, sgc, G_sg = want
        assert len(got) == 5
        for g, w in zip(got, (SG, Wsg, bases, sgc, G_sg)):
            np.testing.assert_array_equal(g, w)


def _shard_cols(a, displs):
    return [a.colidx[a.rowptr[s]:a.rowptr[e]] for s, e in zip(displs[:-1], displs[1:])]


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("reidx", [True, False])
@pytest.mark.parametrize("spec", CORPUS[:3])
def test_build_b_exchange_matches(p, reidx, spec):
    from crp_tpu.plan.partition1d import csr_row_partition

    a = _banded(*spec)
    displs = csr_row_partition(a.rowptr, p)
    bdispls = displs.copy()
    bdispls[-1] = a.ncol
    got = tx.build_b_exchange(_shard_cols(a, displs), bdispls, reidx=reidx)
    want = jx.build_b_exchange(_shard_cols(a, displs), bdispls, reidx=reidx)
    for f in ("p", "glb_n_axis", "rB_nrow_max", "S", "self_max",
              "total_recv_rows", "physical_rows", "physical_rows_ring"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("rB_nrow", "rB_recv_rows", "send_idx", "recv_dst", "self_src",
              "self_dst"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for g, w in zip(got.rowmap, want.rowmap):
        np.testing.assert_array_equal(g, w)
    for gi, wi in zip(got.pair_rows, want.pair_rows):
        for g, w in zip(gi, wi):
            np.testing.assert_array_equal(g, w)


def test_build_b_exchange_rejects_unowned_rows():
    a = _banded(300, 5, 20, 1)
    with pytest.raises(ValueError, match="outside the ownership range"):
        tx.build_b_exchange([a.colidx], np.array([0, 100]))


@pytest.mark.parametrize("displs", [[0, 7, 7, 20], [0, 20], [0, 3, 11, 12, 20]])
@pytest.mark.parametrize("pad_rows", [None, 30])
def test_shard_unshard_dense_rows_match(displs, pad_rows):
    rng = np.random.default_rng(11)
    b = rng.standard_normal((20, 5))
    got = tlay.shard_dense_rows(b, displs, pad_rows=pad_rows)
    want = jlay.shard_dense_rows(b, displs, pad_rows=pad_rows)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tlay.unshard_dense_rows(got, displs), jlay.unshard_dense_rows(want, displs)
    )
    np.testing.assert_array_equal(tlay.unshard_dense_rows(got, displs), b)


def test_stack_padded_matches():
    arrs = [np.arange(3), np.arange(5), np.arange(0)]
    np.testing.assert_array_equal(
        tlay.stack_padded(arrs, pad_value=-1), jlay.stack_padded(arrs, pad_value=-1)
    )


@pytest.mark.parametrize("physical", [0, 96])
def test_format_stat_table_matches(physical):
    tables = []
    for timer in (TTimer(), JTimer()):
        for name, secs in (("pack", 0.5), ("a2a", 0.25), ("spmm", 1.5),
                           ("spmm", 0.75), ("unpack", 0.125)):
            timer.add(name, secs)
        timer.n_exec = 2
        mod = tstats if isinstance(timer, TTimer) else jstats
        tables.append(mod.format_stat_table("rp_spmm", 3.25, timer, 1234, 256,
                                            physical_rows=physical))
    assert tables[0] == tables[1]


@pytest.mark.parametrize("nnz_pad_extra", [0, 17])
def test_pack_device_csr_matches(nnz_pad_extra):
    a = _banded(400, 6, 25, 8, dtype=np.float64)
    got = tseg.pack_device_csr(a.rowptr, a.colidx, a.val, a.nnz + nnz_pad_extra, nrow=450)
    want = jjnp.pack_device_csr(a.rowptr, a.colidx, a.val, a.nnz + nnz_pad_extra, nrow=450)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
