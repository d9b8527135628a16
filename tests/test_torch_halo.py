"""The fused halo kernel (#12, ``pallas_halo``) of the multi-shard engines:
the port's plan against JAX's ``build_halo_plan`` (the same panels bit for
bit, the same push lists), its refusals, the plain version against the
direct product, and the port's engines with ``kernel="pallas_halo"`` on
the CPU against the JAX engines on the CPU mesh, whose kernel runs in
interpret mode (remote DMA emulated; at most 7 devices, as
``tests/test_halo.py`` notes)."""

import jax
import numpy as np
import pytest
import torch

from crp_tpu.config import SpmmConfig as JaxConfig
from crp_tpu.engine.para2d import Para2dSpmm as JaxPara2d
from crp_tpu.engine.rowpara import RowParaSpmm as JaxRowPara
from crp_tpu.kernels import spmm_halo as jh
from crp_tpu.kernels.spmm_pallas import UnsupportedSparsity as JaxUnsupported
from crp_tpu.shard.layout import make_mesh_1d, make_mesh_2d

from crp_tpu_torch import Para2dSpmm
from crp_tpu_torch.config import SpmmConfig
from crp_tpu_torch.engine.rowpara import RowParaSpmm
from crp_tpu_torch.kernels import dispatch as td
from crp_tpu_torch.kernels import spmm_halo as th
from crp_tpu_torch.kernels.spmm_pallas import UnsupportedSparsity, tf32_panels
from crp_tpu_torch.plan.partition1d import csr_row_partition
from crp_tpu_torch.sparse.csr import CSRMatrix
from crp_tpu_torch.sparse.synth import banded_random_csr, fill_b, powerlaw_random_csr
from crp_tpu_torch.utils.norms import rel_fro_err
from tests.test_torch_para2d import force_plan

CPU = torch.device("cpu")
POINTS = [("x3", np.float32), ("default", np.float32), ("highest", np.float32),
          ("highest", np.float64)]
TOL = {np.float32: 1e-6, np.float64: 1e-12}


def _bf16_exact(x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16).to(
        torch.float32).numpy()


def _banded(dtype, seed=60, bf16_values=False, nrow=2048):
    a = banded_random_csr(nrow, nnz_per_row=7, bandwidth=60, seed=seed, dtype=dtype)
    if bf16_values:
        a = CSRMatrix(a.nrow, a.ncol, a.rowptr, a.colidx, _bf16_exact(a.val))
    return a


def _shards(a, p):
    d = csr_row_partition(a.rowptr, p)
    aligned = th.align_displs(d, a.ncol)
    return [a.row_slice(int(d[i]), int(d[i + 1])) for i in range(p)], aligned


def _by_owner(push, p):
    """The port's push rows as JAX's per-owner lists of (src, dev, dst)."""
    return [[tuple(r[1:]) for r in push if r[0] == j] for j in range(p)]


def test_align_displs_matches_jax():
    d = np.array([0, 100, 190, 700, 701, 1000])
    np.testing.assert_array_equal(th.align_displs(d, 1000), jh.align_displs(d, 1000))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("p", [2, 3, 4, 7])
def test_halo_plan_matches_jax(p, dtype):
    """Panels (densified on the device) bit for bit, window starts, buffer
    and B geometry, and every owner's push list in JAX's order.  On fp32
    (``highest``) the plan holds the panels' TF32 planes, from whose big
    plane JAX's fp32 panels come back exactly."""
    a = _banded(dtype, seed=60 + p, nrow=1800 + 97 * p)
    shards, aligned = _shards(a, p)
    jp = jh.build_halo_plan(shards, aligned, dtype=dtype)
    arrays, op = th.build_halo_plan(shards, aligned, device=CPU, dtype=dtype)
    if dtype == np.float32:  # (ws, ws_rel, big, small, push, chunk_src)
        arrays = (*arrays[:2], tf32_panels(arrays[2:4]), *arrays[4:])
    ws, ws_rel, panels, push, chunk_src = (x.numpy() for x in arrays)
    assert (op.G, op.W, op.buf_rows, op.min_b_rows) == (jp.G, jp.W, jp.buf_rows, jp.max_k)
    assert panels.dtype == jp.a_panels.dtype
    np.testing.assert_array_equal(panels, jp.a_panels)
    np.testing.assert_array_equal(ws_rel, jp.ws_rel)
    np.testing.assert_array_equal(ws, jp.lo[:, None] + jp.ws_rel)
    np.testing.assert_array_equal(op.B_displs, jp.B_displs)
    assert op.halo_rows_pushed == jp.halo_rows_pushed
    want = [list(zip(jp.push_src[j, :n], jp.push_dev[j, :n], jp.push_dst[j, :n]))
            for j, n in enumerate(jp.npush[:, 0])]
    assert _by_owner(push, p) == [[tuple(map(int, t)) for t in w] for w in want]
    # the chunk table points every global chunk at its owner and its row
    # in the owner's shard
    assert chunk_src.shape[1] == 2 and op.p == p
    for c, (owner, src) in enumerate(chunk_src):
        row = c * 128
        if row >= a.ncol:
            assert owner == -1
            continue
        j = int(np.searchsorted(aligned, row, side="right") - 1)
        assert (owner, src) == (j, row - aligned[j])
        assert src + 128 <= op.min_b_rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("p", [1, 3])
def test_chunk_pointers_address_the_owners_rows(p, dtype):
    """The kernel's chunk pointers: on one card (``stacked_chunk_rows``,
    made at each launch from B's address) and from owners held apart
    (``chunk_rows`` on their bases, as ``HaloPeers`` makes them once), each
    chunk's pointer is the address of its first row in its owner's shard,
    0 past the matrix."""
    a = _banded(np.float64, seed=70 + p, nrow=1500)
    shards, aligned = _shards(a, p)
    arrays, op = th.build_halo_plan(shards, aligned, device=CPU, dtype=np.float64)
    chunk_src = arrays[-1]
    n = 24
    bs = torch.zeros((p, op.min_b_rows, n), dtype=dtype)
    owners = [torch.zeros((op.min_b_rows, n), dtype=dtype) for _ in range(p)]
    stacked, s16 = th.stacked_chunk_rows(chunk_src, bs)
    apart, a16 = th.chunk_rows(chunk_src, [t.data_ptr() for t in owners], n,
                               bs.element_size())
    assert stacked.dtype == apart.dtype == torch.int64
    for c, (owner, row) in enumerate(chunk_src.tolist()):
        if owner < 0:
            assert int(stacked[c]) == int(apart[c]) == 0
            continue
        assert int(stacked[c]) == bs[owner, row].data_ptr()
        assert int(apart[c]) == owners[owner][row].data_ptr()
    assert s16 == (bs.data_ptr() % 16 == 0)
    assert a16 == all(t.data_ptr() % 16 == 0 for t in owners)


def _anti_banded(nrow=1500, seed=7):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(nrow), 5)
    cols = np.clip(nrow - 1 - rows + rng.integers(-30, 31, rows.size), 0, nrow - 1)
    key = np.unique(rows * nrow + cols)
    return CSRMatrix.from_coo(nrow, nrow, key // nrow, key % nrow,
                              rng.standard_normal(key.size))


@pytest.mark.parametrize("case", ["power-law", "falling windows", "empty shard",
                                  "unaligned"])
def test_halo_plan_refuses_where_jax_does(case):
    if case == "power-law":
        a = powerlaw_random_csr(3000, avg_degree=5, seed=63)
        shards, aligned = _shards(a, 4)
        kw = dict(max_window=512)
    elif case == "falling windows":
        shards, aligned = _shards(_anti_banded(), 2)
        kw = {}
    elif case == "empty shard":
        a = _banded(np.float64)
        shards, aligned = _shards(a, 3)
        s = shards[1]
        shards[1] = CSRMatrix(s.nrow, s.ncol, np.zeros(s.nrow + 1, np.int64),
                              np.zeros(0, np.int64), np.zeros(0))
        kw = {}
    else:
        a = _banded(np.float64)
        shards, aligned = _shards(a, 2)
        aligned = aligned.copy()
        aligned[1] += 1
        kw = {}
    with pytest.raises(JaxUnsupported):
        jh.build_halo_plan(shards, aligned, dtype=np.float64, **kw)
    with pytest.raises(UnsupportedSparsity):
        th.build_halo_plan(shards, aligned, device=CPU, dtype=np.float64, **kw)


@pytest.mark.parametrize("n", [13, 100])
@pytest.mark.parametrize("prec,dtype", POINTS)
def test_plain_matches_direct_product(prec, dtype, n):
    """The plain version (pushes into window buffers, then the windowed
    product) against A @ B in fp64: the class of each point."""
    a = _banded(dtype, seed=70)
    shards, aligned = _shards(a, 4)
    arrays, op = th.build_halo_plan(shards, aligned, device=CPU, dtype=dtype,
                                    precision=prec)
    b = np.random.default_rng(n).standard_normal((a.ncol, n))
    bs = np.zeros((4, op.min_b_rows, n), dtype)
    for i in range(4):
        bs[i, : aligned[i + 1] - aligned[i]] = b[aligned[i]:aligned[i + 1]]
    c = th.spmm_halo(*op.kernel_args(arrays, torch.from_numpy(bs)),
                     min_b_rows=op.min_b_rows).numpy()
    assert c.shape == (4, op.G * op.TM, n) and c.dtype == dtype
    d = csr_row_partition(a.rowptr, 4)
    got = np.concatenate([c[i, : d[i + 1] - d[i]] for i in range(4)])
    tol = {"x3": 1e-5, "default": 5e-3, "highest": 1e-6}[prec] if dtype == np.float32 else 1e-12
    assert rel_fro_err(a.spmm_ref(b), got) <= tol
    for i in range(4):
        assert not np.any(c[i, d[i + 1] - d[i]:])  # pad rows and groups


def _jax_rowpara(a, p, n, dtype, prec, devices8):
    displs = csr_row_partition(a.rowptr, p)
    j = JaxRowPara(a, displs, displs, n, mesh=make_mesh_1d(p, devices=devices8),
                   config=JaxConfig(kernel="pallas_halo", mxu_precision=prec),
                   dtype=dtype)
    return displs, j


@pytest.mark.parametrize("p", [2, 4, 7])
@pytest.mark.parametrize("prec,dtype", POINTS)
def test_halo_engine_matches_jax(devices8, prec, dtype, p):
    """RowParaSpmm(kernel="pallas_halo") against the JAX engine: the same
    kind, received and pushed rows, and C (1e-6 in fp32, 1e-12 in fp64).
    At ``default`` A and B are bf16-exact: the TPU's bf16 pass rounds
    them, which the interpreter on the CPU does not."""
    default = prec == "default"
    a = _banded(dtype, seed=80 + p, bf16_values=default)
    n = 24
    b = fill_b(0, a.ncol, 0, n, dtype=dtype)
    if default:
        b = _bf16_exact(b)
    displs, j = _jax_rowpara(a, p, n, dtype, prec, devices8)
    t = RowParaSpmm(a, displs, displs, n, device="cpu", dtype=dtype,
                    config=SpmmConfig(kernel="pallas_halo", mxu_precision=prec))
    assert t.kernel_kind == j.kernel_kind == "pallas_halo"
    assert t._local_op.variant == "halo" and not t._identity_exchange
    np.testing.assert_array_equal(t.B_row_displs, j.B_row_displs)
    assert (t.max_k, t.max_m) == (j.max_k, j.max_m)
    assert t.rB_recv_size == j.rB_recv_size
    assert t.physical_rows == j.hplan.halo_rows_pushed
    cj, ct = j.exec(b), t.exec(b)
    assert ct.shape == cj.shape and ct.dtype == cj.dtype
    assert rel_fro_err(cj.astype(np.float64), ct) <= TOL[dtype]
    # repeatable, and exec_timed times one fused phase
    np.testing.assert_array_equal(t.unshard_c(t.exec_timed(t.shard_b(b))), ct)
    assert "exec" in t.timer.t and "a2a" not in t.timer.t
    assert "Physical exchanged rows" in t.print_stat()


def test_halo_falls_back_to_pallas(devices8, caplog):
    """A power-law matrix: the halo plan refuses and both engines land on
    the unfused pallas path with the exchange plan's ownership."""
    # columns span > 16384 rows: the uniform window pack refuses
    a = powerlaw_random_csr(20000, avg_degree=4, seed=49, dtype=np.float32)
    displs, j = _jax_rowpara(a, 4, 16, np.float32, "highest", devices8)
    t = RowParaSpmm(a, displs, displs, 16, device="cpu", dtype=np.float32,
                    config=SpmmConfig(kernel="pallas_halo"))
    assert not j.is_halo and not t.is_halo
    assert t.kernel_kind == j.kernel_kind and "pallas_halo unavailable" in caplog.text
    np.testing.assert_array_equal(t.B_row_displs, j.B_row_displs)
    b = fill_b(0, a.ncol, 0, 16, dtype=np.float32)
    assert rel_fro_err(j.exec(b).astype(np.float64), t.exec(b)) <= 1e-6


@pytest.mark.parametrize("pm,pn,dtype", [(3, 2, np.float64), (2, 2, np.float32),
                                         (2, 3, np.float64)])
def test_halo_para2d_matches_jax(devices8, pm, pn, dtype):
    """Para2dSpmm(kernel="pallas_halo") on forced grids: the fused kernel
    over the pm panels of every column group, against the JAX engine."""
    a = _banded(dtype, seed=65)
    n = 20
    plan = force_plan(a, n, pm, pn)
    cfg = dict(kernel="pallas_halo", mxu_precision="highest")
    j = JaxPara2d(a, plan, mesh=make_mesh_2d(pm, pn, devices=devices8),
                  config=JaxConfig(**cfg), dtype=dtype)
    t = Para2dSpmm(a, plan, device="cpu", config=SpmmConfig(**cfg), dtype=dtype)
    assert t.kernel_kind == j.kernel_kind == "pallas_halo" and t.is_halo
    assert (t.rA_cost, t.rB_recv_size) == (j.rA_cost, j.rB_recv_size)
    assert t.physical_rows == j.hplan.halo_rows_pushed * pn
    b = fill_b(0, a.ncol, 0, n, dtype=dtype)
    cj, ct = j.exec(b), t.exec(b)
    assert ct.shape == cj.shape and ct.dtype == cj.dtype
    assert rel_fro_err(cj.astype(np.float64), ct) <= TOL[dtype]
    head = t.print_stat().splitlines()[:3]
    assert head == j.print_stat().splitlines()[:3]


def test_auto_picks_the_fused_kernel_on_the_card():
    """``auto`` on a CUDA device: the fused kernel for several shards, as
    the JAX package picks on a TPU; the windowed family for one."""
    from crp_tpu.kernels import dispatch as jd

    cuda = torch.device("cuda", 0)
    assert td.resolve_auto_kernel(cuda, 4) == "pallas_halo"
    assert td.resolve_auto_kernel(cuda, 1) == "pallas"
    assert td.resolve_auto_kernel("cpu", 4) == "segsum"
    # JAX's choice on a TPU (mocked backend)
    orig = jax.default_backend
    try:
        jax.default_backend = lambda: "tpu"
        assert jd.resolve_auto_kernel(np.float32, 4) == "pallas_halo"
        assert jd.resolve_auto_kernel(np.float32, 1) == "pallas"
    finally:
        jax.default_backend = orig
