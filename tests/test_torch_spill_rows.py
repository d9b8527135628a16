"""The row-ordered view that the spill (#9) and gather (#10) kernels read,
and the emulation of their fixed sum order, against the JAX package on the
CPU.

The view (``spill_row_view``) must hold exactly a block-step pack's live
slots, row by row in the pack's order, cut into items of at most L slots
that cover every row; the emulation (``spill_rows_ordered``, the order the
CUDA kernel sums in, bit for bit, as the card tests check) must agree with
JAX's ``spmm_spill_pallas`` and ``spmm_gather_chunked`` in interpret mode,
and with the port's plain versions, within 1e-6 relative Frobenius: the
same rounded products, summed in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crp_tpu.kernels import dispatch as jd
from crp_tpu.kernels import spmm_ragged as js
from crp_tpu.sparse.synth import powerlaw_community_csr, powerlaw_random_csr
from crp_tpu.utils.norms import rel_fro_err

from crp_tpu_torch.kernels import dispatch as td
from crp_tpu_torch.kernels import spmm_ragged as ts

CPU = torch.device("cpu")
TOL = 1e-6  # relative Frobenius: one set of rounded products, two sum orders


@pytest.fixture
def no_knobs(monkeypatch):
    for k in ("CRP_TPU_RAGGED_TM", "CRP_TPU_RAGGED_WC", "CRP_TPU_RAGGED_MIN_NNZ",
              "CRP_TPU_SPILL_IMPL", "CRP_TPU_SPILL_TMO", "CRP_TPU_SPILL_Q",
              "CRP_TPU_GATHER_GB", "CRP_TPU_FALLBACK"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _spill_pack(TMo, Q=128, seed=0, hub=300):
    """A fused-spill pack over 5 blocks of TMo rows: spilled nonzeros in
    blocks 0-2 only (blocks 3 and 4 trailing and empty: one all-pad step
    each), more than Q in some block (several steps), ``hub`` of them in
    one row of block 2, and two trailing all-pad steps past the pack's own."""
    rng = np.random.default_rng(seed)
    M, z = 5 * TMo, 900
    rows = rng.integers(0, 3 * TMo, z)
    rows = np.sort(np.concatenate([rows, np.full(hub, 2 * TMo + 7)])).astype(np.int32)
    cols = rng.integers(1, 400, rows.size).astype(np.int32)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    counts = np.bincount(rows // TMo, minlength=M // TMo)
    ns = int(np.maximum(-(-counts // Q), 1).sum())
    pack = js.pack_spill_blocks((rows, cols, vals), ns + 2, M, np.float32, TMo=TMo, Q=Q)
    return pack, M, (rows, cols, vals)


def _host(x):
    """A JAX array as numpy, bf16 as its bits (``local_op_from_jax_pack``)."""
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _np_view(rel, cols, vals, blk, TMo):
    """(rows, cols, vals) of the live slots, stably sorted by row."""
    r = np.asarray(rel).reshape(np.shape(cols))
    live = r < TMo
    rows = (np.asarray(blk)[:, None].astype(np.int64) * TMo + r)[live]
    order = np.argsort(rows, kind="stable")
    return rows[order], np.asarray(cols)[live][order], np.asarray(vals)[live][order]


def _check_view(view, rel, cols, vals, blk, M, TMo, L, run=16):
    """The view holds exactly the pack's live slots in the pack's order
    within each row; its items cover every row once and in order, a row
    with slots in items of at most L slots (the partials of a row of
    several numbered in item order), rows with none in runs of at most
    ``run``."""
    vcols, vvals, items, parts = (x.numpy() for x in view)
    rows, c, v = _np_view(rel, cols, vals, blk, TMo)
    Z = len(rows)
    np.testing.assert_array_equal(vcols, c)
    np.testing.assert_array_equal(vvals.view(np.int32), v.view(np.int32))
    assert vcols.dtype == np.int32 and vvals.dtype == np.float32
    assert items.dtype == parts.dtype == np.int32 and items.shape[1] == 4
    np.testing.assert_array_equal(items[-1], [-1, Z, -1, -1])
    row, first, part, part0 = items[:-1].T.astype(np.int64)
    length = np.diff(items[:, 1].astype(np.int64))
    assert np.all(np.diff(row) >= 0) and first[0] == 0
    assert np.all((length >= 0) & (length <= L))
    count = np.bincount(rows, minlength=M)
    np.testing.assert_array_equal(rows, np.repeat(row, length))  # each slot its row
    runs = length == 0
    span = np.where(runs, -part0, 1)
    assert np.all(part[runs] == -1) and np.all((span >= 1) & (span <= run))
    covered = np.bincount(np.repeat(row[runs], span[runs])
                          + np.concatenate([np.arange(k) for k in span[runs]] or [[]])
                          .astype(np.int64), minlength=M)
    np.testing.assert_array_equal(covered, (count == 0).astype(np.int64))
    n_items = np.bincount(row[~runs], minlength=M)
    np.testing.assert_array_equal(n_items, -(-count // L))
    slot_row = row[~runs]
    hub = n_items[slot_row] > 1
    sp, sp0 = part[~runs], part0[~runs]
    assert np.all(sp[~hub] == -1) and np.all(sp0[~hub] == -1)
    np.testing.assert_array_equal(sp[hub], np.arange(hub.sum()))
    rank = np.arange(len(slot_row)) - np.searchsorted(slot_row, slot_row)
    np.testing.assert_array_equal(sp0[hub], sp[hub] - rank[hub])
    np.testing.assert_array_equal(parts, n_items[slot_row[hub]])
    # only a row's last item may be shorter than L
    last = np.r_[slot_row[1:] != slot_row[:-1], True]
    assert np.all(length[~runs][~last] == L)
    return Z


@pytest.mark.parametrize("L", [256, 16])
@pytest.mark.parametrize("TMo", [128, 256, 512])
def test_view_holds_the_live_slots_in_row_order(TMo, L):
    """Pad slots (an all-pad step per empty block, trailing pad steps,
    padded tails of steps) never appear; a hub row of 300 slots is split
    into several items; the trailing empty blocks' rows come in runs of
    at most 16."""
    (rel, cols, vals, first, blk), M, (rows, _, _) = _spill_pack(TMo)
    view = ts.spill_row_view(_t(rel), _t(cols), _t(vals), _t(blk), M, TMo, L=L)
    Z = _check_view(view, rel, cols, vals, blk, M, TMo, L)
    assert Z == len(rows)
    items = view[2].numpy()
    tail = items[:-1][items[:-1, 0] >= 3 * TMo]  # the trailing empty blocks: runs
    assert np.all(np.diff(items[:, 1])[items[:-1, 0] >= 3 * TMo] == 0)
    assert len(tail) >= 2 * TMo // 16 and np.all((tail[:, 3] >= -16) & (tail[:, 3] <= -1))
    assert view[3].shape[0] >= -(-300 // L)  # the hub's partials
    assert not np.any(view[1].numpy() == 0.0)  # no pad slot (val 0) survived


def test_view_of_a_pack_with_no_empty_row():
    """Every row holds a slot: no run, one item a row or more."""
    TMo, M = 128, 256
    rng = np.random.default_rng(7)
    rows = np.sort(np.r_[np.arange(M), rng.integers(0, M, 300)]).astype(np.int32)
    cols = rng.integers(1, 400, rows.size).astype(np.int32)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    rel, pc, pv, _, blk = js.pack_spill_blocks((rows, cols, vals), 8, M, np.float32,
                                               TMo=TMo, Q=128)
    view = ts.spill_row_view(_t(rel), _t(pc), _t(pv), _t(blk), M, TMo, L=2)
    _check_view(view, rel, pc, pv, blk, M, TMo, 2)
    assert not np.any(np.diff(view[2].numpy()[:, 1]) == 0)


def test_stacked_two_shard_view_pads_with_empty_items():
    """Two shards' views stacked: each shard's part is its own view, the
    shorter padded with items that repeat its sentinel (row -1, no slot);
    the hub row sits in the last block of shard 0, right before its pads."""
    TMo = 128
    (rel0, cols0, vals0, _, blk0), M, _ = _spill_pack(TMo, seed=1, hub=40)
    rng = np.random.default_rng(2)
    rows = np.sort(np.r_[rng.integers(0, M, 50), np.full(70, M - 1)]).astype(np.int32)
    cols = rng.integers(1, 400, rows.size).astype(np.int32)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    rel1, cols1, vals1, _, blk1 = js.pack_spill_blocks((rows, cols, vals), 6, M,
                                                       np.float32, TMo=TMo, Q=128)
    views = [ts.spill_row_view(_t(r), _t(c), _t(v), _t(b), M, TMo, L=16)
             for r, c, v, b in ((rel0, cols0, vals0, blk0), (rel1, cols1, vals1, blk1))]
    stacked = ts.stack_row_views(views)
    for k in range(4):
        assert stacked[k].shape[0] == 2
        assert stacked[k].shape[1] == max(v[k].shape[0] for v in views)
    for i, v in enumerate(views):
        for k in range(4):
            np.testing.assert_array_equal(stacked[k][i, : v[k].shape[0]].numpy(),
                                          v[k].numpy())
        pad = stacked[2][i, v[2].shape[0]:].numpy()
        assert np.all(pad == v[2][-1].numpy())  # the sentinel, repeated
    # the hub of shard 1 is the last row (5 items), its items the last real ones
    # (70 slots at L = 16)
    items1 = views[1][2].numpy()
    assert np.all(items1[-6:-1, 0] == M - 1) and np.all(items1[-6:-1, 2] >= 0)
    b = _t(np.random.default_rng(3).standard_normal((400, 24)).astype(np.float32))
    for i, v in enumerate(views):
        one = ts.spill_rows_ordered(None, v, b, M, "x3")
        both = ts.spill_rows_ordered(None, tuple(x[i] for x in stacked), b, M, "x3")
        assert torch.equal(one, both)


@pytest.mark.parametrize("prec", ["highest", "x3", "default"])
def test_spill_emulation_matches_pallas_and_plain(prec):
    """The kernel's order emulated on a TMo = 256 pack (dummy blocks,
    multi-step blocks, a hub row of 3 items at L = 256, of 19 at L = 16),
    against ``spmm_spill_pallas(interpret=True)`` and the plain version;
    rows with no slot are C bit for bit."""
    TMo, Q = 256, 128
    (rel, cols, vals, first, blk), M, _ = _spill_pack(TMo, Q, seed=4, hub=600)
    n = 40
    rng = np.random.default_rng(5)
    b = rng.standard_normal((400, n)).astype(np.float32)
    b_nan = b.copy()
    b_nan[0] = np.nan  # pad slots carry column 0 (JAX's one-hot product reads it)
    c0 = rng.standard_normal((M, n)).astype(np.float32)
    want = np.asarray(js.spmm_spill_pallas(jnp.asarray(c0), rel, cols, vals, first, blk,
                                           jnp.asarray(b), TMo=TMo, Q=Q,
                                           mxu_precision=prec, interpret=True))
    plain = ts.spmm_spill_plain(_t(c0), _t(rel), _t(cols), _t(vals), _t(blk), TMo,
                                _t(b), prec)
    for L in (256, 16):
        view = ts.spill_row_view(_t(rel), _t(cols), _t(vals), _t(blk), M, TMo, L=L)
        assert view[3].shape[0] == -(-600 // L)
        got = ts.spill_rows_ordered(_t(c0), view, _t(b), M, prec)
        assert torch.equal(got, ts.spill_rows_ordered(_t(c0), view, _t(b_nan), M, prec))
        assert rel_fro_err(want.astype(np.float64), got.numpy()) <= TOL
        assert float((got - plain).double().norm() / plain.double().norm()) <= TOL
        np.testing.assert_array_equal(got[3 * TMo:].numpy().view(np.int32),
                                      c0[3 * TMo:].view(np.int32))


@pytest.mark.parametrize("prec", ["highest", "x3", "default"])
def test_gather_emulation_matches_chunked_and_plain(prec):
    """The gather kind: the emulation on the port's own pack's view (the
    op's arguments) against ``spmm_gather_chunked(interpret=True)`` and
    the plain version; trailing blocks with no nonzero come out zero."""
    a = powerlaw_random_csr(1500, avg_degree=13, seed=4, dtype=np.float32)
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    max_m = a.nrow + 600
    arrays, op = td._pack_gather(shard, max_m, np.float32, prec, CPU, TMo=128, Q=128)
    arrs = tuple(x[0] for x in arrays)
    b = np.random.default_rng(1).standard_normal((a.ncol, 40)).astype(np.float32)
    args = op.kernel_args(arrs, _t(b))
    rel, cols, vals, first, blk = (x.numpy() for x in arrs[:5])
    _check_view(args[-1], rel, cols, vals, blk, op.M, 128, ts.ROW_ITEM_SLOTS)
    step_base = np.r_[np.flatnonzero(first), len(first)]
    want = np.asarray(js.spmm_gather_chunked(rel, cols, vals, first, blk, jnp.asarray(b),
                                             step_base=step_base, TMo=128, Q=128,
                                             mxu_precision=prec, interpret=True))
    got = ts.spill_rows_ordered(None, args[-1], _t(b), op.M, prec)
    assert got.shape == want.shape == (op.M, 40)
    assert rel_fro_err(want.astype(np.float64), got.numpy()) <= TOL
    plain = op.plain(*args)
    assert float((got - plain).double().norm() / plain.double().norm()) <= TOL
    assert not torch.any(got[a.nrow:])


def test_views_of_carried_over_jax_packs(no_knobs):
    """A JAX pack carried over by ``local_op_from_jax_pack`` gets the same
    view as the port's own pack: the gather kind, and the ragged pack's
    fused spill over two shards (the second shard's view padded), whose
    emulated spill on each shard agrees with the plain one."""
    a = powerlaw_random_csr(1500, avg_degree=13, seed=4, dtype=np.float32)
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    j_arrays, j_fn = jd.pack_local_kernel(shard, a.nrow + 300, np.float32, "gather",
                                          mxu_precision="x3")
    t_arrays, _ = td.pack_local_kernel(shard, a.nrow + 300, np.float32, "gather",
                                       device="cpu", mxu_precision="x3")
    c_arrays, _ = td.local_op_from_jax_pack([np.asarray(x) for x in j_arrays],
                                            j_fn.min_b_rows, device="cpu",
                                            roofline=j_fn.roofline, variant="gather")
    assert len(t_arrays) == len(c_arrays) == len(j_arrays) + 4
    for x, y in zip(c_arrays[-4:], t_arrays[-4:]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())

    for k, v in (("TM", "128"), ("WC", "256"), ("MIN_NNZ", "120")):
        no_knobs.setenv(f"CRP_TPU_RAGGED_{k}", v)
    no_knobs.setenv("CRP_TPU_SPILL_IMPL", "pallas")
    c = powerlaw_community_csr(6000, 16, 1024, seed=5, dtype=np.float32)
    shards = [(s.rowptr, s.colidx.astype(np.int32), s.val)
              for s in (c.row_slice(0, 3500), c.row_slice(3500, 6000))]
    j_arrays, j_fn = jd.pack_local_kernel(shards, 3500, np.float32, "ragged",
                                          mxu_precision="x3")
    t_arrays, op = td._pack_ragged(shards, 3500, np.float32, "x3", CPU,
                                   geometry=(128, 256), min_chunk_nnz=120,
                                   spill_impl="pallas")
    c_arrays, c_op = td.local_op_from_jax_pack([_host(x) for x in j_arrays],
                                               j_fn.min_b_rows, device="cpu",
                                               roofline=j_fn.roofline, variant="ragged")
    assert op.spill_impl == c_op.spill_impl == "pallas"
    assert op.spill_tmo == c_op.spill_tmo
    assert len(t_arrays) == len(c_arrays) == len(j_arrays) + 5
    # the JAX pack's arrays and the view (the step ranges' last entries differ:
    # the port's own end at each shard's steps)
    for x, y in zip((*c_arrays[:len(j_arrays)], *c_arrays[-4:]),
                    (*t_arrays[:len(j_arrays)], *t_arrays[-4:])):
        assert x.dtype == y.dtype and torch.equal(x, y)
    M = op.roofline["G"] * op.roofline["TM"]
    b = _t(np.random.default_rng(6).standard_normal((op.min_b_rows, 24)).astype(np.float32))
    for i in range(2):
        arrs = tuple(x[i] for x in t_arrays)
        c_main = op.plain(*op.kernel_args(arrs, b))
        s_args = op.spill_args(arrs, c_main, b)
        rel, cols, vals, blk = (x.numpy() for x in s_args[1:5])
        TMo = s_args[5]
        assert TMo == op.spill_tmo and M % TMo == 0
        view = tuple(x[: len(v)] for x, v in zip(
            s_args[-1], ts.spill_row_view(*s_args[1:5], M, TMo)))
        _check_view(view, rel, cols, vals, blk, M, TMo, ts.ROW_ITEM_SLOTS)
        got = ts.spill_rows_ordered(c_main, s_args[-1], b, M, "x3")
        plain = op.spill_plain(*s_args)
        assert float((got - plain).double().norm() / plain.double().norm()) <= TOL


def test_spill_split_edits_apply_to_the_body():
    """``crp_tpu_torch.cli.spill_split`` times copies of ``spill.cu`` with
    parts edited: each variant's anchors are in the body as often as the
    edit says, and each variant but ``full`` changes it."""
    from crp_tpu_torch.cli import spill_split
    from crp_tpu_torch.kernels import _build

    body = (_build.CSRC / "spill.cu").read_text()
    texts = spill_split.edited_sources()
    assert set(texts) == {"full", "no_b_loads", "wide", "plain_cache"}
    assert texts["full"] == body
    assert len({t for v, t in texts.items() if v != "full"} - {body}) == len(texts) - 1


def _hub_matrix():
    """A power-law matrix with hub rows of over ``ROW_ITEM_SLOTS`` nonzeros
    and a run of empty rows longer than ``ROW_RUN``: items of several
    partials and runs of several empty-row items."""
    from crp_tpu_torch.sparse.csr import CSRMatrix
    from crp_tpu_torch.sparse.synth import powerlaw_random_csr as tplaw

    a = tplaw(900, avg_degree=6, seed=77)
    rows = np.repeat(np.arange(a.nrow), np.diff(a.rowptr))
    keep = (rows < 300) | (rows >= 340)  # 40 empty rows
    hub_rows = np.repeat([5, 420, 421], 600)
    hub_cols = np.random.default_rng(78).integers(0, a.ncol, hub_rows.size)
    rows = np.concatenate([rows[keep], hub_rows])
    cols = np.concatenate([a.colidx[keep], hub_cols])
    return CSRMatrix.from_coo(a.nrow, a.ncol, rows, cols, np.ones(rows.size, np.float32))


@pytest.mark.parametrize("p", [2, 3, 4])
def test_rank_gather_pack_is_its_slice(p):
    """A mesh rank's ``gather`` pack (its own shard packed alone, the other
    shards' views sized from their rows' counts, ``row_view_sizes_of_counts``)
    equals slice [rank] of the stacked pack bit for bit; the sizes from the
    counts equal the views' own lengths."""
    from crp_tpu_torch.plan.partition1d import csr_row_partition

    a = _hub_matrix()
    d = csr_row_partition(a.rowptr, p)
    shards = [a.row_slice(int(d[i]), int(d[i + 1])) for i in range(p)]
    host = [(s.rowptr, s.colidx, s.val) for s in shards]
    max_m = max(s.nrow for s in shards)
    whole, op = td.pack_local_kernel(host, max_m, np.float32, "gather", device=CPU)
    M = op.M
    hubs = 0
    for i, (rowptr, _, _) in enumerate(host):
        view = ts.spill_row_view(*(x[i] for x in whole[:3]), whole[4][i], M, ts.SPILL_TMO)
        assert ts.row_view_sizes_of_counts(np.diff(rowptr), M) == ts.row_view_sizes([view])
        hubs += view[3].shape[0]
    assert hubs > 0 and np.diff(a.rowptr).max() > ts.ROW_ITEM_SLOTS
    for r in range(p):
        mine, op_r = td.pack_local_kernel(host, max_m, np.float32, "gather", device=CPU,
                                          rank=r)
        assert op_r.roofline == op.roofline and len(mine) == len(whole)
        for x, y in zip(mine, whole):
            assert x.dtype == y.dtype and torch.equal(x, y[r : r + 1])
