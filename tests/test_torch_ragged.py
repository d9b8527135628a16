"""The port's ragged slice against the JAX package on the CPU: every copied
host helper equal to its original, the vectorized cover equal to the numpy
and native covers, the ragged packs bit for bit, and each plain version
against the JAX Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crp_tpu import native
from crp_tpu.kernels import dispatch as jd
from crp_tpu.kernels import spmm_ragged as js
from crp_tpu.sparse.csr import CSRMatrix
from crp_tpu.sparse.synth import (
    banded_random_csr, powerlaw_community_csr, powerlaw_random_csr,
)
from crp_tpu.utils.norms import rel_fro_err

from crp_tpu_torch.kernels import dispatch as td
from crp_tpu_torch.kernels import spmm_ragged as ts
from crp_tpu_torch.kernels.spmm_pallas import UnsupportedSparsity, tf32_panels

GRID = [(tm, wc) for tm in (128, 256, 512) for wc in (128, 256, 512)]
CPU = torch.device("cpu")


def _multiband(n, seed=5):
    """Two diagonal bands: disjoint chunks per group."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), 6)
    off = rng.integers(-60, 61, size=(n, 3))
    c1 = np.clip(np.arange(n)[:, None] + off, 0, n - 1)
    c2 = np.clip((np.arange(n)[:, None] + n // 2 + off) % n, 0, n - 1)
    cols = np.concatenate([c1, c2], axis=1).ravel()
    return CSRMatrix.from_coo(n, n, rows, cols, rng.standard_normal(len(rows)))


def _trailing_empty():
    """nnz only in the first 100 of 700 rows: empty groups at the end."""
    rows = np.repeat(np.arange(100, dtype=np.int64), 3)
    cols = np.tile(np.array([5, 60, 900], dtype=np.int64), 100)
    return CSRMatrix.from_coo(700, 1000, rows, cols, np.ones(300))


def _empty_groups():
    """Rows 128-639 empty: whole groups with no nonzero in the middle."""
    a = powerlaw_random_csr(1200, avg_degree=9, seed=6)
    rows = np.repeat(np.arange(a.nrow), np.diff(a.rowptr))
    keep = (rows < 128) | (rows >= 640)
    return CSRMatrix.from_coo(a.nrow, a.ncol, rows[keep], a.colidx[keep],
                              a.val[keep])


CORPUS = {
    "banded": lambda: banded_random_csr(3000, nnz_per_row=9, bandwidth=300, seed=7),
    "multiband": lambda: _multiband(2000),
    "plaw": lambda: powerlaw_random_csr(2000, avg_degree=12, seed=3),
    "cplaw": lambda: powerlaw_community_csr(12000, 16, 1024, seed=5),
    "trailing_empty": _trailing_empty,
    "empty_groups": _empty_groups,
}


@pytest.fixture(params=sorted(CORPUS), scope="module")
def mat(request):
    return CORPUS[request.param]()


@pytest.fixture
def no_knobs(monkeypatch):
    for k in ("CRP_TPU_RAGGED_TM", "CRP_TPU_RAGGED_WC", "CRP_TPU_RAGGED_AUTO",
              "CRP_TPU_RAGGED_MIN_NNZ", "CRP_TPU_RAGGED_PANEL_GB",
              "CRP_TPU_RAGGED_MIN_PCT", "CRP_TPU_SPILL_IMPL",
              "CRP_TPU_SPILL_TMO", "CRP_TPU_SPILL_Q", "CRP_PROJ_HBM_GBPS",
              "CRP_PROJ_SPILL_NS", "CRP_PROJ_MXU_TFLOPS"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


# ------------------------------------------------------------ host helpers


def test_defaults_match(no_knobs):
    assert ts.default_panel_cap_bytes() == js.default_panel_cap_bytes()
    assert ts.ragged_params() == js.ragged_params()
    for tm, wc in GRID:
        assert ts.default_min_chunk_nnz(tm, wc) == js.default_min_chunk_nnz(tm, wc)


@pytest.mark.parametrize("TM,Wc", GRID)
def test_cover_matches_numpy_and_native(mat, TM, Wc):
    rowptr = np.asarray(mat.rowptr, np.int64)
    colidx = np.asarray(mat.colidx, np.int32)
    G = max(-(-mat.nrow // TM), 1)
    for mn in (1, 20, js.default_min_chunk_nnz(TM, Wc)):
        want = js.ragged_cover_np(rowptr, colidx, TM, Wc, mn)
        got = ts.ragged_cover(rowptr, colidx, TM, Wc, mn)
        twin = ts.ragged_cover_np(rowptr, colidx, TM, Wc, mn)
        nat = native.ragged_cover(rowptr, colidx, TM, 128, Wc, mn, G)
        for w, g, t, n_ in zip(want, got, twin, nat):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(t, w)
            np.testing.assert_array_equal(n_, w)
        assert got[0].dtype == np.int32 and got[1].dtype == np.int64
        assert ts.estimate_ragged(rowptr, colidx, TM, Wc, mn) == \
            js.estimate_ragged(rowptr, colidx, TM, Wc, mn)


@pytest.mark.parametrize("prec", ["x3", "default", "highest"])
@pytest.mark.parametrize("small", [False, True])
def test_geometry_choice_matches(no_knobs, mat, prec, small):
    want = js.choose_ragged_geometry(mat.rowptr, mat.colidx, prec, interpret=small)
    assert ts.choose_ragged_geometry(mat.rowptr, mat.colidx, prec, small=small) == want
    assert ts.resolve_ragged_geometry(mat.rowptr, mat.colidx, prec, small=small) == \
        js.resolve_ragged_geometry(mat.rowptr, mat.colidx, prec, interpret=small)


@pytest.mark.parametrize("small", [False, True])
def test_resolve_empty_shard_matches(no_knobs, small):
    for rowptr in (np.zeros(1, np.int64), np.zeros(5, np.int64)):
        assert ts.resolve_ragged_geometry(rowptr, np.zeros(0, np.int32), small=small) \
            == js.resolve_ragged_geometry(rowptr, np.zeros(0, np.int32), interpret=small)


@pytest.mark.parametrize("itemsize", [2, 4, 8])
def test_cover_cap_escalation_matches(itemsize):
    a = powerlaw_random_csr(3000, avg_degree=14, seed=9)
    rowptr = np.asarray(a.rowptr, np.int64)
    colidx = np.asarray(a.colidx, np.int32)
    full = js.ragged_cover_np(rowptr, colidx, 128, 256, 2)
    G = len(full[1]) - 1
    for cap in (len(full[0]) * 128 * 256 * itemsize, len(full[0]) * 128 * 256 * itemsize // 3,
                G * 128 * 256 * itemsize):
        want = js._cover_with_cap(rowptr, colidx, 128, 256, 2, G, cap, itemsize)
        got = ts.cover_with_cap(rowptr, colidx, 128, 256, 2, G, cap, itemsize)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(UnsupportedSparsity, match="cap"):
        ts.cover_with_cap(rowptr, colidx, 128, 256, 2, G, G * 128 * 256 * itemsize - 1,
                          itemsize)


def test_ragged_window_properties_match():
    rw = js.pack_ragged_window(*(_multiband(1500).__dict__[k] for k in
                                 ("rowptr", "colidx", "val")), 1500, TM=128, Wc=256,
                               min_chunk_nnz=40, dtype=np.float32)
    fields = {f: getattr(rw, f) for f in ts.RaggedWindow.__dataclass_fields__}
    tw = ts.RaggedWindow(**fields)
    for prop in ("S", "step_g", "step_first", "min_b_rows"):
        np.testing.assert_array_equal(getattr(tw, prop), getattr(rw, prop))
    np.testing.assert_array_equal(ts.first_ptr(rw.step_first),
                                  rw.group_ptr.astype(np.int32))


@pytest.mark.parametrize("seed", range(4))
def test_spill_packs_match(seed):
    rng = np.random.default_rng(seed)
    TMo, Q = [(128, 128), (256, 128), (512, 512), (128, 256)][seed]
    nrow = int(rng.integers(1, 1500))
    M = -(-nrow // TMo) * TMo
    z = int(rng.integers(0, 4000)) if seed else 0
    rows = np.sort(rng.integers(0, nrow, z)).astype(np.int32)
    cols = rng.integers(0, 3000, z).astype(np.int32)
    vals = rng.standard_normal(z).astype(np.float32)
    spill = (rows, cols, vals) if z else None
    for a, b in zip(ts.pack_spill(spill, z + 7, M, np.float32),
                    js.pack_spill(spill, z + 7, M, np.float32)):
        np.testing.assert_array_equal(a, b)
    counts = np.bincount(rows // TMo, minlength=M // TMo)
    ns = int(np.maximum(-(-counts // Q), 1).sum())
    got = ts.pack_spill_blocks(spill, ns + 3, M, np.float32, TMo=TMo, Q=Q)
    want = js.pack_spill_blocks(spill, ns + 3, M, np.float32, TMo=TMo, Q=Q)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ptr = ts.first_ptr(got[3])
    assert len(ptr) == M // TMo + 1 and ptr[-1] == ns + 3
    np.testing.assert_array_equal(np.repeat(np.arange(M // TMo), np.diff(ptr)), got[4])


def test_stacking_and_uniform_estimate_match():
    G = 9
    steps = [None, (np.array([0, 128, 0], np.int32), np.array([0, 0, 1], np.int32),
                    np.array([1, 0, 1], np.int32), 2)]
    for a, b in zip(td._extend_and_stack_steps(steps, G),
                    jd._extend_and_stack_steps(steps, G)):
        np.testing.assert_array_equal(a, b)
    for gen in CORPUS.values():
        a = gen()
        shard = [(a.rowptr, a.colidx, a.val)]
        assert td._uniform_cost_estimate(shard, a.nrow + 100) == \
            jd._uniform_cost_estimate(shard, a.nrow + 100)


# ------------------------------------------------------------------- packs


def _as_jax_pack(t_arrays, op):
    """The port's ragged pack as JAX's: at ``highest`` on fp32 the port
    holds the TF32 planes (big, small), from whose big plane JAX's fp32
    panels come back exactly (``tests/test_torch_tf32_planes_halo_ragged.py``
    holds them to the split), and counts their bytes; other packs as
    they are."""
    if op.scheme != "tf32":
        return t_arrays, op.roofline
    roofline = dict(op.roofline, a_bytes=op.roofline["a_bytes"] // 2)
    return (*t_arrays[:3], tf32_panels(t_arrays[3:5]), *t_arrays[5:]), roofline


def _assert_same_ragged_pack(j_arrays, j_fn, t_arrays, op):
    t_arrays, roofline = _as_jax_pack(t_arrays, op)
    j_arrays, j_roofline = _jax_as_segsum(j_arrays, j_fn)
    # group_ptr; for the fused spill its row-ordered view (4)
    n_extra = 5 if op.spill_impl == "pallas" else 1
    assert len(t_arrays) == len(j_arrays) + n_extra
    for t, j in zip(t_arrays, j_arrays):
        tb, jb = _bits(t), _bits(j)
        assert tb.dtype == jb.dtype and tb.shape == jb.shape
        np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(t_arrays[len(j_arrays)][0].numpy(),
                                  ts.first_ptr(np.asarray(j_arrays[1][0])))
    if n_extra == 5:  # the spill's TMo: one first step a block
        M = op.roofline["G"] * op.roofline["TM"]
        assert op.spill_tmo == M // int(np.asarray(j_arrays[-2][0]).sum())
    assert op.min_b_rows == j_fn.min_b_rows
    assert roofline == j_roofline
    assert op.variant == j_fn.variant == "ragged"


POINTS = [("x3", np.float32), ("default", np.float32), ("highest", np.float32),
          ("highest", np.float64)]


SPILLS = ["segsum", "pallas", "clip", "twopass"]


def _resolved(spill, dtype):
    """The spill form a pack of ``dtype`` takes for ``spill``: ``clip`` and
    ``twopass`` are ``segsum`` in the port, the fused spill is fp32-only,
    and fp64 ``pallas`` falls back to ``segsum``."""
    return "pallas" if spill == "pallas" and dtype == np.float32 else "segsum"


def _jax_as_segsum(j_arrays, j_fn):
    """A JAX ragged pack whose spill is ``clip`` or ``twopass`` as the
    ``segsum`` pack the port makes for it: ``clip`` holds segsum's arrays,
    ``twopass`` (rows, inv, vals, uniq), from which ``uniq[inv]`` gives
    the columns back (segsum's pads are column 0)."""
    roofline = dict(j_fn.roofline)
    if roofline["spill_impl"] not in ("clip", "twopass"):
        return list(j_arrays), roofline
    j_arrays = list(j_arrays)
    if roofline["spill_impl"] == "twopass":
        rows, inv, vals, uniq = (np.asarray(x) for x in j_arrays[-4:])
        cols = np.take_along_axis(uniq, inv, axis=1)
        cols[rows >= roofline["G"] * roofline["TM"]] = 0
        j_arrays[-4:] = [rows, cols, vals]
    roofline["spill_impl"] = "segsum"
    return j_arrays, roofline


@pytest.mark.parametrize("prec,dtype", POINTS)
@pytest.mark.parametrize("spill", SPILLS)
@pytest.mark.parametrize("gen", ["plaw", "multiband", "trailing_empty"])
def test_ragged_pack_matches_jax(no_knobs, prec, dtype, spill, gen):
    """The port's pack equals JAX's pack_local_kernel(..., "ragged") bit for
    bit, with the spill forced by the geometry and break-even arguments
    (environment knobs on the JAX side)."""
    no_knobs.setenv("CRP_TPU_RAGGED_TM", "128")
    no_knobs.setenv("CRP_TPU_RAGGED_WC", "256")
    no_knobs.setenv("CRP_TPU_RAGGED_MIN_NNZ", "120")
    no_knobs.setenv("CRP_TPU_SPILL_IMPL", spill)
    a = CORPUS[gen]()
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val.astype(dtype))]
    j_arrays, j_fn = jd.pack_local_kernel(shard, a.nrow + 300, dtype, "ragged",
                                          mxu_precision=prec)
    t_arrays, op = td._pack_ragged(shard, a.nrow + 300, dtype, prec, CPU,
                                   geometry=(128, 256), min_chunk_nnz=120,
                                   spill_impl=spill)
    assert op.roofline["spill_nnz"] > 0
    _assert_same_ragged_pack(j_arrays, j_fn, t_arrays, op)
    assert op.spill_impl == op.roofline["spill_impl"] == _resolved(spill, dtype)


@pytest.mark.parametrize("prec,dtype", POINTS)
@pytest.mark.parametrize("spill", SPILLS)
@pytest.mark.parametrize("p", [2, 4])
def test_multi_shard_ragged_pack_matches_jax(no_knobs, prec, dtype, spill, p):
    """p shards (one empty) pack as JAX's multi-shard ragged pack, bit for
    bit: a common S with trailing no-op steps, spill arrays padded to the
    largest shard's.  Each shard's step ranges are its own, the last one
    ending at its own steps (the no-op steps past it stay zero)."""
    no_knobs.setenv("CRP_TPU_RAGGED_TM", "128")
    no_knobs.setenv("CRP_TPU_RAGGED_WC", "256")
    no_knobs.setenv("CRP_TPU_RAGGED_MIN_NNZ", "120")
    no_knobs.setenv("CRP_TPU_SPILL_IMPL", spill)
    a = CORPUS["cplaw"]()
    d = np.linspace(0, a.nrow, p + 1).astype(np.int64)
    shards = []
    for i in range(p):
        sh = a.row_slice(int(d[i]), int(d[i + 1]))
        keep = sh.nnz if i != 1 else 0
        shards.append((sh.rowptr if keep else np.zeros(sh.nrow + 1, np.int64),
                       sh.colidx[:keep].astype(np.int32), sh.val[:keep].astype(dtype)))
    max_m = int(np.diff(d).max()) + 300
    j_arrays, j_fn = jd.pack_local_kernel(shards, max_m, dtype, "ragged",
                                          mxu_precision=prec)
    t_arrays, op = td._pack_ragged(shards, max_m, dtype, prec, CPU,
                                   geometry=(128, 256), min_chunk_nnz=120,
                                   spill_impl=spill)
    t_arrays, roofline = _as_jax_pack(t_arrays, op)
    j_arrays, j_roofline = _jax_as_segsum(j_arrays, j_fn)
    n_extra = 5 if op.spill_impl == "pallas" else 1  # + the spill's view
    assert len(t_arrays) == len(j_arrays) + n_extra
    for t, j in zip(t_arrays, j_arrays):
        tb, jb = _bits(t), _bits(j)
        assert tb.dtype == jb.dtype and tb.shape == jb.shape
        np.testing.assert_array_equal(tb, jb)
    assert (op.min_b_rows, roofline) == (j_fn.min_b_rows, j_roofline)
    S = j_arrays[0].shape[1]
    if n_extra == 5:  # the spill's TMo: one first step a block, in every shard
        M = op.roofline["G"] * op.roofline["TM"]
        assert {M // int(f.sum()) for f in np.asarray(j_arrays[-2])} == {op.spill_tmo}
    first = np.asarray(j_arrays[1])
    for i in range(p):
        want = ts.first_ptr(first[i])
        got = t_arrays[len(j_arrays)][i].numpy()
        np.testing.assert_array_equal(got[:-1], want[:-1])
        assert got[-2] < got[-1] <= want[-1]
    ends = t_arrays[len(j_arrays)][:, -1].numpy()
    for i in range(p):  # no-op steps past a shard's own: zero panels
        assert not np.any(_bits(t_arrays[3])[i, ends[i]:])
    assert ends.max() == S and ends.min() < S


@pytest.mark.parametrize("TMo,Q", [(256, 256), (128, 512)])
def test_spill_step_geometry_matches_jax(no_knobs, TMo, Q):
    """The fused spill's step geometry arguments pack as the JAX knobs do."""
    for k, v in (("TM", "128"), ("WC", "256"), ("MIN_NNZ", "120")):
        no_knobs.setenv(f"CRP_TPU_RAGGED_{k}", v)
    no_knobs.setenv("CRP_TPU_SPILL_IMPL", "pallas")
    no_knobs.setenv("CRP_TPU_SPILL_TMO", str(TMo))
    no_knobs.setenv("CRP_TPU_SPILL_Q", str(Q))
    a = CORPUS["plaw"]()
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val.astype(np.float32))]
    j_arrays, j_fn = jd.pack_local_kernel(shard, a.nrow, np.float32, "ragged",
                                          mxu_precision="x3")
    t_arrays, op = td._pack_ragged(shard, a.nrow, np.float32, "x3", CPU,
                                   geometry=(128, 256), min_chunk_nnz=120,
                                   spill_impl="pallas", TMo=TMo, Q=Q)
    _assert_same_ragged_pack(j_arrays, j_fn, t_arrays, op)
    assert t_arrays[6].shape[-1] == Q  # cols (1, ns, Q)


@pytest.mark.parametrize("prec,dtype", POINTS)
def test_pallas_gate_ragged_pack_matches_jax(no_knobs, prec, dtype):
    """Wide windows (> 16384 rows): both gates take the ragged pack, at the
    geometry the model picks with the CPU's Wc <= 256, and pack the same
    arrays."""
    a = powerlaw_community_csr(20000, 8, 1024, seed=11, dtype=dtype)
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    j_arrays, j_fn = jd.pack_local_kernel(shard, a.nrow, dtype, "pallas",
                                          mxu_precision=prec)
    t_arrays, op = td.pack_local_kernel(shard, a.nrow, dtype, "pallas",
                                        device="cpu", mxu_precision=prec)
    _assert_same_ragged_pack(j_arrays, j_fn, t_arrays, op)
    assert op.roofline["W"] <= 256


def test_ragged_refuses_thin_covers():
    a = powerlaw_random_csr(1500, avg_degree=9, seed=2, dtype=np.float32)
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    with pytest.raises(UnsupportedSparsity, match="30%"):
        td._pack_ragged(shard, a.nrow, np.float32, "x3", CPU,
                        geometry=(128, 128), min_chunk_nnz=10_000)
    with pytest.raises(ValueError, match="spill_impl"):  # a typo must raise
        td._pack_ragged(shard, a.nrow, np.float32, "x3", CPU, spill_impl="palas")


@pytest.mark.parametrize("TM,Wc", [(128, 256), (256, 128), (512, 512)])
def test_cover_spill_count_equals_fill(mat, TM, Wc):
    """The cover's spill count is the fill's wherever a group keeps a chunk
    (the thresholds the packs use); a group that keeps none gets a dummy
    chunk over [0, Wc), which takes back its nonzeros there, so the fill's
    count lies between the cover's less the nonzeros below Wc and the
    cover's: the bound the pack's keep-share check reads before the fill."""
    from crp_tpu_torch.kernels import device_pack

    rowptr = np.asarray(mat.rowptr, np.int64)
    colidx = np.asarray(mat.colidx, np.int32)
    G = max(-(-mat.nrow // TM), 1)
    for mn in (1, 20, ts.default_min_chunk_nnz(TM, Wc), 10_000):
        starts, group_ptr, spill = ts.cover_with_cap(rowptr, colidx, TM, Wc, mn, G,
                                                     ts.PANEL_CAP_BYTES, 4)
        Z = len(device_pack.ragged_fill(rowptr, colidx, mat.val, TM, Wc, starts,
                                        group_ptr, "f32", CPU)[2][0])
        if mn < 10_000:
            assert Z == spill
        assert spill - np.count_nonzero(colidx < Wc) <= Z <= spill


def test_thin_cover_refuses_before_the_fill(monkeypatch):
    """A scrambled power-law graph: the ragged pack refuses on the cover's
    own count, with no panel filled, where the JAX pack refuses after its
    fill."""
    from crp_tpu.kernels.spmm_pallas import UnsupportedSparsity as JaxUnsupported

    from crp_tpu_torch.kernels import device_pack

    def no_fill(*args, **kw):
        raise AssertionError("the fill ran")

    a = powerlaw_community_csr(20000, 4, 1024, seed=3, permute=True, dtype=np.float32)
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    with pytest.raises(JaxUnsupported, match="30%"):
        jd.pack_local_kernel(shard, a.nrow, np.float32, "ragged", mxu_precision="x3")
    monkeypatch.setattr(device_pack, "ragged_fill", no_fill)
    for prec in ("x3", "default", "highest"):
        with pytest.raises(UnsupportedSparsity, match="30%"):
            td._pack_ragged(shard, a.nrow, np.float32, prec, CPU)


def test_local_op_from_jax_pack_feeds_both(no_knobs):
    no_knobs.setenv("CRP_TPU_RAGGED_TM", "128")
    no_knobs.setenv("CRP_TPU_RAGGED_WC", "256")
    no_knobs.setenv("CRP_TPU_RAGGED_MIN_NNZ", "120")
    no_knobs.setenv("CRP_TPU_SPILL_IMPL", "pallas")
    a = powerlaw_random_csr(2000, avg_degree=12, seed=3, dtype=np.float32)
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    j_arrays, j_fn = jd.pack_local_kernel(shard, a.nrow, np.float32, "ragged",
                                          mxu_precision="x3")
    tensors, op = td.local_op_from_jax_pack(
        [np.asarray(x).view(np.uint16) if np.asarray(x).dtype.name == "bfloat16"
         else np.asarray(x) for x in j_arrays],
        j_fn.min_b_rows, device="cpu", roofline=j_fn.roofline, variant="ragged")
    assert (op.scheme, op.spill_impl, op.mxu_precision) == ("x3", "pallas", "x3")
    t_arrays, t_op = td._pack_ragged(shard, a.nrow, np.float32, "x3", CPU,
                                     geometry=(128, 256), min_chunk_nnz=120,
                                     spill_impl="pallas")
    for x, y in zip(tensors, t_arrays):
        np.testing.assert_array_equal(_bits(x), _bits(y))
    b = np.random.default_rng(1).standard_normal((op.min_b_rows, 16)).astype(np.float32)
    c = op(tuple(x[0] for x in tensors), torch.from_numpy(b)).numpy()
    cj = np.asarray(j_fn(tuple(jnp.asarray(x[0]) for x in j_arrays), jnp.asarray(b)))
    assert rel_fro_err(cj.astype(np.float64), c) <= 1e-6


def _jax_arrays(j_arrays):
    """A JAX pack's arrays as numpy, bf16 ones as their bits."""
    return [np.asarray(x).view(np.uint16) if np.asarray(x).dtype.name == "bfloat16"
            else np.asarray(x) for x in j_arrays]


@pytest.mark.parametrize("spill", ["clip", "twopass"])
@pytest.mark.parametrize("prec,dtype", [("x3", np.float32), ("highest", np.float64)])
def test_local_op_from_jax_pack_spill_forms(no_knobs, spill, prec, dtype):
    """A JAX ragged pack built with the ``clip`` or ``twopass`` spill
    uploads (a ``twopass`` pack's four spill arrays once raised ``KeyError:
    4``) as the ``segsum`` pack the port makes for the same form, bit for
    bit, and gives JAX's C, with or without the roofline's form."""
    for k, v in (("TM", "128"), ("WC", "256"), ("MIN_NNZ", "120")):
        no_knobs.setenv(f"CRP_TPU_RAGGED_{k}", v)
    no_knobs.setenv("CRP_TPU_SPILL_IMPL", spill)
    a = powerlaw_random_csr(2000, avg_degree=12, seed=3, dtype=dtype)
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    j_arrays, j_fn = jd.pack_local_kernel(shard, a.nrow, dtype, "ragged",
                                          mxu_precision=prec)
    assert j_fn.roofline["spill_impl"] == spill and j_fn.roofline["spill_nnz"] > 0
    b = np.random.default_rng(1).standard_normal((j_fn.min_b_rows, 16)).astype(dtype)
    cj = np.asarray(j_fn(tuple(jnp.asarray(x[0]) for x in j_arrays), jnp.asarray(b)))
    uploads, c = [], None
    for roofline in (j_fn.roofline,
                     {k: v for k, v in j_fn.roofline.items() if k != "spill_impl"}):
        tensors, op = td.local_op_from_jax_pack(_jax_arrays(j_arrays), j_fn.min_b_rows,
                                                device="cpu", roofline=roofline,
                                                variant="ragged")
        assert (op.spill_impl, op.roofline["spill_impl"], op.mxu_precision) == (
            "segsum", "segsum", prec)
        got = op(tuple(x[0] for x in tensors), torch.from_numpy(b))
        assert c is None or torch.equal(got, c)
        uploads.append(tensors)
        c = got
    assert rel_fro_err(cj.astype(np.float64), c.numpy()) <= (
        1e-12 if dtype == np.float64 else 1e-6)
    t_arrays, t_op = td._pack_ragged(shard, a.nrow, dtype, prec, CPU,
                                     geometry=(128, 256), min_chunk_nnz=120,
                                     spill_impl=spill)
    assert t_op.spill_impl == t_op.roofline["spill_impl"] == "segsum"
    for tensors in uploads:
        assert len(tensors) == len(t_arrays)
        for x, y in zip(tensors, t_arrays):
            np.testing.assert_array_equal(_bits(x), _bits(y))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("p", [1, 3])
def test_spill_forms_give_segsum_bits(dtype, p):
    """The ``clip`` and ``twopass`` packs are the ``segsum`` pack bit for
    bit and give its C, at p = 1 and on three shards of which the middle
    one is empty, each shard's C within its class of the reference."""
    a = CORPUS["cplaw"]()
    a = CSRMatrix(a.nrow, a.ncol, a.rowptr, a.colidx, a.val.astype(dtype))
    d = np.linspace(0, a.nrow, p + 1).astype(np.int64)
    shards = []
    for i in range(p):
        sh = a.row_slice(int(d[i]), int(d[i + 1]))
        keep = sh.nnz if (p == 1 or i != 1) else 0
        shards.append((sh.rowptr if keep else np.zeros(sh.nrow + 1, np.int64),
                       sh.colidx[:keep].astype(np.int32), sh.val[:keep].astype(dtype)))
    max_m = int(np.diff(d).max()) + 300
    b = np.random.default_rng(4).standard_normal((a.ncol + 256, 24)).astype(dtype)
    packs, got = {}, {}
    for spill in ("segsum", "clip", "twopass"):
        arrays, op = td._pack_ragged(shards, max_m, dtype, "highest", CPU,
                                     geometry=(128, 256), min_chunk_nnz=120,
                                     spill_impl=spill)
        assert op.spill_impl == op.roofline["spill_impl"] == "segsum"
        assert op.roofline["spill_nnz"] > 0
        rB = torch.from_numpy(b[: max(op.min_b_rows, a.ncol)])
        packs[spill] = arrays
        got[spill] = [op(tuple(x[i] for x in arrays), rB) for i in range(p)]
    for spill in ("clip", "twopass"):
        assert len(packs[spill]) == len(packs["segsum"])
        for x, y in zip(packs[spill], packs["segsum"]):
            np.testing.assert_array_equal(_bits(x), _bits(y))
        for x, y in zip(got[spill], got["segsum"]):
            assert torch.equal(x, y)
    ref = a.spmm_ref(b[: a.ncol].astype(np.float64))
    for i, x in enumerate(got["segsum"]):
        c = x[: int(d[i + 1] - d[i])].numpy()
        if shards[i][1].size:
            assert rel_fro_err(ref[d[i] : d[i + 1]], c) <= (
                1e-12 if dtype == np.float64 else 1e-6)
        else:  # the empty shard: dummy chunks of zero panels, no spill
            assert not c.any()


@pytest.mark.parametrize("impl,dtype,tol", [
    ("segsum", np.float64, 1e-12),
    ("clip", np.float64, 1e-12),
    ("twopass", np.float64, 1e-12),
    ("pallas", np.float32, 1e-5),
])
def test_spill_impl_variants_match_jax(no_knobs, devices8, monkeypatch, impl, dtype, tol):
    """JAX's ``test_spill_impl_variants`` (``tests/test_ragged.py``) for
    the port: every spill form through ``RowParaSpmm`` at p = 3 (the
    port's ragged pack patched to the knobs' geometry, break-even and
    form), against JAX's engine under the same environment knobs: the
    same spilled nonzeros and C (1e-12 in fp64, 1e-6 in fp32), each
    within its class of the reference."""
    from crp_tpu.config import SpmmConfig as JaxConfig
    from crp_tpu.engine.rowpara import RowParaSpmm as JaxRowPara
    from crp_tpu.plan.partition1d import csr_row_partition
    from crp_tpu.shard.layout import make_mesh_1d

    from crp_tpu_torch.config import SpmmConfig
    from crp_tpu_torch.engine.rowpara import RowParaSpmm

    no_knobs.setenv("CRP_TPU_SPILL_IMPL", impl)
    for k, v in (("TM", "128"), ("WC", "256"), ("MIN_NNZ", "40")):
        no_knobs.setenv(f"CRP_TPU_RAGGED_{k}", v)
    orig = td._pack_ragged
    monkeypatch.setattr(td, "_pack_ragged", lambda *args, **k: orig(
        *args, **{**k, "geometry": (128, 256), "min_chunk_nnz": 40, "spill_impl": impl}))
    a = powerlaw_random_csr(2500, avg_degree=13, seed=4)
    displs = csr_row_partition(a.rowptr, 3)
    j = JaxRowPara(a, displs, displs, 24, mesh=make_mesh_1d(3, devices=devices8[:3]),
                   config=JaxConfig(kernel="ragged"), dtype=dtype)
    t = RowParaSpmm(a, displs, displs, 24, device="cpu",
                    config=SpmmConfig(kernel="ragged"), dtype=dtype)
    op = t._local_op
    assert j._local_fn.roofline["spill_impl"] == impl
    assert op.spill_impl == op.roofline["spill_impl"] == _resolved(impl, dtype)
    assert op.roofline["spill_nnz"] == j._local_fn.roofline["spill_nnz"] > 0
    b = np.random.default_rng(3).standard_normal((a.ncol, 24)).astype(dtype)
    cj, ct = j.exec(b), t.exec(b)
    assert rel_fro_err(a.spmm_ref(b), ct) <= tol
    assert rel_fro_err(cj.astype(np.float64), ct) <= (
        1e-12 if dtype == np.float64 else 1e-6)


# --------------------------------------------- plain versions vs Pallas


def _rw(dtype, gen="plaw", TM=128, Wc=256):
    a = CORPUS[gen]()
    return a, js.pack_ragged_window(a.rowptr, a.colidx, a.val.astype(dtype), a.ncol,
                                    TM=TM, Wc=Wc, min_chunk_nnz=25, dtype=dtype)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("gen", ["plaw", "banded", "trailing_empty"])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), (np.float64, 1e-12)])
def test_ragged_plain_matches_pallas(gen, dtype, tol):
    a, rw = _rw(dtype, gen)
    b = np.random.default_rng(0).standard_normal((rw.min_b_rows, 40)).astype(dtype)
    want = np.asarray(js.spmm_ragged(rw.step_g, rw.step_first, rw.starts, rw.panels,
                                     jnp.asarray(b), G=rw.G, TM=rw.TM, Wc=rw.Wc,
                                     interpret=True))
    got = ts.spmm_ragged(_t(rw.step_g), _t(ts.first_ptr(rw.step_first)),
                         _t(rw.starts), _t(rw.panels), _t(b),
                         min_b_rows=rw.min_b_rows).numpy()
    assert got.dtype == dtype and got.shape == want.shape
    assert rel_fro_err(want.astype(np.float64), got) <= tol


def test_ragged_bf16_plains_match_pallas():
    from crp_tpu.kernels.spmm_pallas import np_split_bf16

    a, rw = _rw(np.float32, "multiband")
    b = np.random.default_rng(2).standard_normal((rw.min_b_rows, 32)).astype(np.float32)
    ah, al = np_split_bf16(rw.panels)
    args = (rw.step_g, rw.step_first, rw.starts)
    targs = (_t(rw.step_g), _t(ts.first_ptr(rw.step_first)), _t(rw.starts))
    kw = dict(G=rw.G, TM=rw.TM, Wc=rw.Wc, interpret=True)
    th = torch.from_numpy(ah.view(np.int16)).view(torch.bfloat16)
    tl = torch.from_numpy(al.view(np.int16)).view(torch.bfloat16)
    want3 = np.asarray(js.spmm_ragged_presplit(*args, jnp.asarray(ah), jnp.asarray(al),
                                               jnp.asarray(b), **kw))
    got3 = ts.spmm_ragged_presplit(*targs, th, tl, _t(b), min_b_rows=rw.min_b_rows)
    assert rel_fro_err(want3.astype(np.float64), got3.numpy()) <= 1e-6
    bh = jnp.asarray(b).astype(jnp.bfloat16)
    want1 = np.asarray(js.spmm_ragged_bf16(*args, jnp.asarray(ah), bh, **kw))
    got1 = ts.spmm_ragged_bf16(*targs, th, _t(b).to(torch.bfloat16),
                               min_b_rows=rw.min_b_rows)
    assert rel_fro_err(want1.astype(np.float64), got1.numpy()) <= 1e-6


@pytest.mark.parametrize("prec", ["highest", "x3", "default"])
@pytest.mark.parametrize("TMo,Q", [(128, 128), (256, 128)])
def test_spill_plain_matches_pallas(prec, TMo, Q):
    """Dummy blocks (no spill) and multi-step blocks (more than Q spills)."""
    rng = np.random.default_rng(11)
    M, n, z = 4 * TMo, 40, 700
    rows = np.sort(rng.integers(0, 2 * TMo + 5, z)).astype(np.int32)
    cols = rng.integers(0, 300, z).astype(np.int32)
    vals = rng.standard_normal(z).astype(np.float32)
    b = rng.standard_normal((300, n)).astype(np.float32)
    c0 = rng.standard_normal((M, n)).astype(np.float32)
    counts = np.bincount(rows // TMo, minlength=M // TMo)
    ns = int(np.maximum(-(-counts // Q), 1).sum())
    rel, pc, pv, first, blk = js.pack_spill_blocks((rows, cols, vals), ns + 2, M,
                                                   np.float32, TMo=TMo, Q=Q)
    assert counts.max() > Q and counts.min() == 0
    want = np.asarray(js.spmm_spill_pallas(jnp.asarray(c0), rel, pc, pv, first, blk,
                                           jnp.asarray(b), TMo=TMo, Q=Q,
                                           mxu_precision=prec, interpret=True))
    got = ts.spmm_spill(_t(c0), _t(rel), _t(pc), _t(pv), _t(blk), TMo, _t(b),
                        prec).numpy()
    np.testing.assert_array_equal(got[3 * TMo:], c0[3 * TMo:])
    assert rel_fro_err(want.astype(np.float64), got) <= 1e-6


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), (np.float64, 1e-12)])
def test_spill_chunked_matches_jax(dtype, tol):
    rng = np.random.default_rng(11)
    m, k, n, z = 300, 400, 32, 5000
    rows = np.sort(rng.integers(0, m, z)).astype(np.int32)
    cols = rng.integers(0, k, z).astype(np.int32)
    vals = rng.standard_normal(z).astype(dtype)
    b = rng.standard_normal((k, n)).astype(dtype)
    pr, pc, pv = js.pack_spill((rows, cols, vals), z + 37, m, dtype)
    want = np.asarray(js.spmm_spill_chunked(jnp.asarray(pr), jnp.asarray(pc),
                                            jnp.asarray(pv), jnp.asarray(b), m))
    got = ts.spmm_spill_chunked(_t(pr), _t(pc), _t(pv), _t(b), m).numpy()
    assert got.dtype == dtype
    assert rel_fro_err(want.astype(np.float64), got) <= tol


def test_wrappers_refuse_bad_arguments():
    _, rw = _rw(np.float32)
    args = [_t(rw.step_g), _t(ts.first_ptr(rw.step_first)), _t(rw.starts),
            _t(rw.panels), _t(np.zeros((rw.min_b_rows, 8), np.float32))]
    with pytest.raises(ValueError, match="several devices"):
        ts.spmm_ragged(*args[:4], args[4].to("meta"), min_b_rows=rw.min_b_rows)
    with pytest.raises(ValueError, match="mxu_precision"):
        ts.spmm_spill(*[torch.zeros(1)] * 7, "bf16")
    with pytest.raises(ValueError, match="mxu_precision"):
        ts.spmm_gather(*[torch.zeros(1)] * 6, 512, "bf16")
    assert [k.__name__ for k in ts.KERNELS] == [
        "spmm_ragged_presplit", "spmm_ragged_bf16", "spmm_ragged", "spmm_spill",
        "spmm_gather"]


def test_geometry_chooser_prices_each_sparsity_once(monkeypatch):
    """The chooser's cover memo: a second call on the same sparsity (at
    another point, or with values changed) prices no cover again and picks
    what a fresh chooser and JAX's pick; another sparsity is priced anew."""
    a = powerlaw_community_csr(6000, 12, 512, seed=7, permute=True)
    b = powerlaw_community_csr(6000, 12, 512, seed=8, permute=True)
    ts._COVER_MEMO.clear()
    priced = []
    raw = ts._raw_cover
    monkeypatch.setattr(ts, "_raw_cover", lambda gc, wc: priced.append(wc) or raw(gc, wc))
    for prec in ("x3", "default", "highest"):
        got = ts.choose_ragged_geometry(a.rowptr, a.colidx, prec)
        assert got == js.choose_ragged_geometry(a.rowptr, a.colidx, prec, interpret=False)
    assert len(priced) == 9
    assert ts.choose_ragged_geometry(b.rowptr, b.colidx, "x3") \
        == js.choose_ragged_geometry(b.rowptr, b.colidx, "x3", interpret=False)
    assert len(priced) == 18 and len(ts._COVER_MEMO) == 2
    ts._COVER_MEMO.clear()
    fresh = ts.choose_ragged_geometry(a.rowptr, a.colidx, "highest", small=True)
    assert fresh == js.choose_ragged_geometry(a.rowptr, a.colidx, "highest", interpret=True)
