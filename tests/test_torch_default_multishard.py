"""The multi-shard ``default`` packs on the bf16 hi plane: kernel #4's
(``_pack_window``, scheme ``"window_bf16"``) and the fused halo kernel
#12's (``build_halo_plan``).

The JAX package keeps fp32 panels at every operating point and its TPU
kernels round them to bf16 in VMEM on every read (``Precision.DEFAULT``).
The port's one-pass ``wgmma`` body is fed by TMA, which copies and cannot
round, so at ``default`` the port densifies straight to the RNE hi plane,
once, and casts B to bf16 beside it.  Here: the plane equals
``split_bf16`` of JAX's fp32 panels bit for bit, every other array and the
geometry are the ``highest`` plan's; the plain versions on the plane
equal the plain versions on the fp32 panels at ``default`` bit for bit; a
JAX multi-shard ``default`` pack is rounded on upload; the wrappers refuse
what has no kernel; and the engines hold only the plane.  The CUDA kernels
are held against these plain versions in ``test_torch_cuda.py``.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from crp_tpu.kernels import dispatch as jd
from crp_tpu.kernels import spmm_halo as jh

from crp_tpu_torch.config import SpmmConfig
from crp_tpu_torch.engine.rowpara import RowParaSpmm
from crp_tpu_torch.kernels import dispatch as td
from crp_tpu_torch.kernels import spmm_halo as th
from crp_tpu_torch.kernels import spmm_pallas as tsp
from crp_tpu_torch.kernels.device_pack import split_bf16
from crp_tpu_torch.plan.partition1d import csr_row_partition
from crp_tpu_torch.sparse.synth import banded_random_csr, fill_b
from tests.test_torch_window import _bits, _fp32_panels_engine, _highest_fp32, _shards
from tests.test_torch_x3_multishard import _halo_case, _highest_fp32_halo

CPU = torch.device("cpu")
REPO = pathlib.Path(__file__).resolve().parent.parent


def _hi(panels: np.ndarray) -> torch.Tensor:
    """The RNE bf16 hi plane of JAX's fp32 panels."""
    return split_bf16(torch.from_numpy(panels), with_lo=False)[0]


def _int_view(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


@pytest.mark.parametrize("p", [2, 3, 4, 7])
def test_window_default_plane_is_rounding_of_jax_panels(p):
    """``_pack_window`` at ``default`` on fp32 (p shards, one empty, pad
    groups): (ws, ah) with ah the RNE hi plane of JAX's fp32 panels bit
    for bit, ws and min_b_rows JAX's, the geometry the ``highest`` pack's,
    ``a_bytes`` the plane's bytes and B counted in bf16."""
    _, shards, max_m = _shards(p, np.float32)
    arrays, op = td._pack_window(shards, max_m + 300, np.float32, "default", CPU)
    f_arrays, f_op = _highest_fp32(shards, max_m + 300)
    (j_ws, j_tiles), j_fn = jd._pack_pallas_uniform(shards, max_m + 300, np.float32,
                                                    "default")
    assert (op.scheme, op.variant, op.precision) == ("window_bf16", "window", "default")
    assert len(arrays) == 2
    ws, ah = arrays
    assert ah.dtype == torch.bfloat16 and ah.shape == j_tiles.shape
    assert torch.equal(_bits(ah), _bits(_hi(j_tiles)))
    np.testing.assert_array_equal(ws.numpy(), j_ws)
    assert torch.equal(ws, f_arrays[0])
    assert op.min_b_rows == f_op.min_b_rows == j_fn.min_b_rows
    assert not ah[p - 2].any()  # the empty shard
    rl, frl = op.roofline, f_op.roofline
    assert {k: v for k, v in rl.items() if k not in ("a_bytes", "b_itemsize", "passes")} \
        == {k: v for k, v in frl.items() if k not in ("a_bytes", "b_itemsize", "passes")}
    assert (rl["a_bytes"], rl["b_itemsize"], rl["passes"]) == (
        ah.numel() * 2, 2, 1)
    assert rl["a_bytes"] * 2 == j_tiles.nbytes  # highest holds their TF32 planes, twice them
    assert frl["a_bytes"] == 2 * j_tiles.nbytes


@pytest.mark.parametrize("p", [2, 3, 4, 7])
def test_halo_default_plane_is_rounding_of_jax_panels(p):
    """``build_halo_plan`` at ``default`` on fp32: (ws, ws_rel, ah, push,
    chunk_src), ah the RNE hi plane of JAX's fp32 panels bit for bit,
    every other array and the geometry the plan's at ``highest``,
    ``a_bytes`` half the fp32 panels' bytes."""
    _, _, aligned, shards = _halo_case(p)
    jp = jh.build_halo_plan(shards, aligned, dtype=np.float32)
    arrays, op = th.build_halo_plan(shards, aligned, device=CPU, dtype=np.float32,
                                    precision="default")
    f_arrays, f_op = _highest_fp32_halo(shards, aligned)
    assert len(arrays) == len(f_arrays) == 5
    ws, ws_rel, ah, push, chunk_src = arrays
    assert ah.dtype == torch.bfloat16 and ah.shape == jp.a_panels.shape
    assert torch.equal(_bits(ah), _bits(_hi(jp.a_panels)))
    for t, f in zip((ws, ws_rel, push, chunk_src), f_arrays[:2] + f_arrays[3:]):
        assert torch.equal(t, f)
    assert (op.G, op.W, op.buf_rows, op.min_b_rows, op.halo_rows_pushed) == (
        f_op.G, f_op.W, f_op.buf_rows, f_op.min_b_rows, f_op.halo_rows_pushed)
    assert op.roofline["a_bytes"] * 2 == jp.a_panels.nbytes == f_op.roofline["a_bytes"]
    assert (op.roofline["b_itemsize"], op.roofline["passes"]) == (2, 1)
    b = torch.ones((p, op.min_b_rows, 3))
    args = op.kernel_args(arrays, b)
    assert args[2] is ah and args[5].dtype == torch.bfloat16 and args[6] == "default"


@pytest.mark.parametrize("n", [16, 37])
@pytest.mark.parametrize("p", [2, 4])
def test_window_plane_plain_equals_fp32_plain(p, n):
    """Per shard, the op's plain version on the hi plane (#2's
    ``spmm_window_sg_bf16_plain`` on B cast to bf16) equals
    ``spmm_window_plain(..., "default")`` on the fp32 panels the plane was
    rounded from, bit for bit (an empty shard and pad groups included)."""
    _, shards, max_m = _shards(p, np.float32)
    arrays, op = td._pack_window(shards, max_m + 300, np.float32, "default", CPU)
    f_arrays, _ = _highest_fp32(shards, max_m + 300)
    b = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (op.min_b_rows, n)).astype(np.float32))
    for i in range(p):
        ws, ah = (x[i] for x in arrays)
        args = op.kernel_args((ws, ah), b)
        assert args[2].dtype == torch.bfloat16
        got = op.plain(*args)
        fp32 = tsp.spmm_window_plain(f_arrays[0][i], f_arrays[1][i], b, "default")
        one = tsp.spmm_window_sg_bf16_plain(ws, ah, b.to(torch.bfloat16))
        assert got.dtype == torch.float32 and got.shape == fp32.shape
        assert torch.equal(_int_view(got), _int_view(fp32))
        assert torch.equal(_int_view(got), _int_view(one))
        assert torch.equal(op((ws, ah), b), got)


@pytest.mark.parametrize("n", [13, 64])
@pytest.mark.parametrize("p", [2, 4])
def test_halo_plane_plain_equals_fp32_plain(p, n):
    """The fused kernel's plain version on the hi plane and bf16 B shards
    equals it on the fp32 panels at ``default`` bit for bit, and each
    shard equals #4's plain version on the plane with its pushed window
    buffer."""
    a, _, aligned, shards = _halo_case(p, seed=70)
    arrays, op = th.build_halo_plan(shards, aligned, device=CPU, dtype=np.float32,
                                    precision="default")
    f_arrays, _ = _highest_fp32_halo(shards, aligned)
    b = fill_b(0, a.ncol, 0, n, dtype=np.float32)
    bs = np.zeros((p, op.min_b_rows, n), np.float32)
    for i in range(p):
        bs[i, : aligned[i + 1] - aligned[i]] = b[aligned[i]:aligned[i + 1]]
    bs = torch.from_numpy(bs)
    args = op.kernel_args(arrays, bs)
    got = th.spmm_halo_plain(*args)
    want = th.spmm_halo_plain(*f_arrays[:2], f_arrays[2], *f_arrays[3:], bs, "default",
                              op.buf_rows)
    assert got.shape == (p, op.G * op.TM, n) and got.dtype == torch.float32
    assert torch.equal(_int_view(got), _int_view(want))
    assert torch.equal(op(arrays, bs), got)
    buf = th.halo_buffers(arrays[3], args[5], op.buf_rows)
    for i in range(p):
        one = tsp.spmm_window_plain(arrays[1][i], arrays[2][i], buf[i], "default")
        assert torch.equal(_int_view(one), _int_view(got[i]))


def test_jax_default_pack_feeds_the_port():
    """A JAX multi-shard ``default`` pack handed to the port
    (``local_op_from_jax_pack``) is rounded to the hi plane on upload and
    gives the port's own pack's C, bit for bit."""
    _, shards, max_m = _shards(3, np.float32)
    j_arrays, j_fn = jd._pack_pallas_uniform(shards, max_m, np.float32, "default")
    tensors, op = td.local_op_from_jax_pack(j_arrays, j_fn.min_b_rows, device="cpu",
                                            roofline=j_fn.roofline)
    assert (op.variant, op.scheme, op.precision) == ("window", "window_bf16", "default")
    t_arrays, t_op = td._pack_window(shards, max_m, np.float32, "default", CPU)
    b = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (op.min_b_rows, 16)).astype(np.float32))
    for i in range(3):
        got = op(tuple(x[i] for x in tensors), b)
        want = t_op(tuple(x[i] for x in t_arrays), b)
        assert torch.equal(_int_view(got), _int_view(want))


def test_wrappers_take_the_plane_only_at_default():
    """On the CPU the wrappers run their plain versions: the plane at
    ``default`` with an fp32 or a bf16 B gives the fp32 panels' C; a plane
    at another point has no function and raises."""
    _, shards, max_m = _shards(2, np.float32, empty=False)
    arrays, op = td._pack_window(shards, max_m, np.float32, "default", CPU)
    f_arrays, _ = _highest_fp32(shards, max_m)
    ws, ah = (x[0] for x in arrays)
    b = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (op.min_b_rows, 8)).astype(np.float32))
    c32 = tsp.spmm_window(ws, f_arrays[1][0], b, "default", min_b_rows=op.min_b_rows)
    for bb in (b, b.to(torch.bfloat16)):
        c = tsp.spmm_window(ws, ah, bb, "default", min_b_rows=op.min_b_rows)
        assert torch.equal(_int_view(c), _int_view(c32))
    for prec in ("x3", "highest"):
        with pytest.raises(ValueError, match="plane"):
            tsp.spmm_window(ws, ah, b, prec, min_b_rows=op.min_b_rows)


@pytest.mark.parametrize("name,panels,prec,want", [
    ("spmm_window", ("bf16", "bf16"), "x3",
     ("crp_window_x3", torch.bfloat16, torch.float32)),
    ("spmm_window", ("bf16",), "default",
     ("crp_window_bf16", torch.bfloat16, torch.bfloat16)),
    ("spmm_window", ("f32",), "highest",
     ("crp_window_f32", torch.float32, torch.float32)),
    ("spmm_window", ("f64",), "highest",
     ("crp_window_f64", torch.float64, torch.float64)),
    ("spmm_halo", ("bf16",), "default",
     ("crp_halo_bf16", torch.bfloat16, torch.bfloat16)),
    ("spmm_halo", ("bf16", "bf16"), "x3",
     ("crp_halo_x3", torch.bfloat16, torch.float32)),
    ("spmm_halo", ("f32", "f32"), "highest",
     ("crp_halo_f32", torch.float32, torch.float32)),
    ("spmm_halo", ("f32",), "default", None),
    ("spmm_halo", ("f32",), "highest", None),
    ("spmm_window", ("f32", "f32"), "highest", None),
    ("spmm_window", ("f32",), "x3", None),
    ("spmm_window", ("bf16",), "highest", None),
])
def test_window_entry_picks_the_kernel_or_refuses(name, panels, prec, want):
    """The entry #4's and #12's wrappers launch on CUDA tensors: the x3
    pair, the default hi plane (with a bf16 B), fp32 at ``highest`` and
    fp64; fp32 panels at ``default`` or ``x3`` and a plane at another
    point have none, and raise before any launch."""
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32, "f64": torch.float64}
    ts = tuple(torch.zeros(1, dtype=dtypes[d]) for d in panels)
    if want is None:
        with pytest.raises(ValueError, match=f"{name}: no kernel"):
            tsp.window_entry(name, ts, prec)
    else:
        assert tsp.window_entry(name, ts, prec) == want


@pytest.mark.parametrize("kernel", ["pallas", "pallas_halo"])
def test_engines_hold_the_plane(kernel):
    """``RowParaSpmm`` at p = 4 and ``default`` holds only the bf16 hi
    plane (half the fp32 panels' bytes, ``a_bytes`` its own), and its C
    equals that of the fp32 panels' plain version at ``default``, bit for
    bit."""
    a = banded_random_csr(2400, nnz_per_row=7, bandwidth=60, seed=23, dtype=np.float32)
    d = csr_row_partition(a.rowptr, 4)
    eng = RowParaSpmm(a, d, d, 24, device="cpu", dtype=np.float32,
                      config=SpmmConfig(kernel=kernel, mxu_precision="default"))
    panels = [x for x in eng.packed if x.dim() >= 3]
    assert [x.dtype for x in panels] == [torch.bfloat16]
    panel_bytes = panels[0].numel() * panels[0].element_size()
    assert eng._local_op.roofline["a_bytes"] == panel_bytes
    b = fill_b(0, a.ncol, 0, 24, dtype=np.float32)
    a.__dict__.pop("_torch_pack_cache", None)
    ref = RowParaSpmm(a, d, d, 24, device="cpu", dtype=np.float32,
                      config=SpmmConfig(kernel=kernel, mxu_precision="highest"))
    ref_panels = [x for x in _fp32_panels_engine(ref).packed if x.dim() >= 3]
    assert [x.dtype for x in ref_panels] == [torch.float32]
    assert 2 * panel_bytes == ref_panels[0].numel() * 4
    ref._local_op.precision = "default"  # the fp32 panels through the default plain version
    np.testing.assert_array_equal(eng.exec(b), ref.exec(b))


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("kind", ["window", "halo"])
def test_chip_smoke_bounds_the_plane(kind):
    """The smoke prices #4 and #12 at ``default`` as one bf16 pass, and
    their design bound reads the plane's bytes and B in bf16: the same
    bound as on the fp32 panels less half the panels' bytes and half B's."""
    smoke = _smoke()
    if kind == "window":
        _, shards, max_m = _shards(2, np.float32, empty=False)
        got = [td._pack_window(shards, max_m, np.float32, "default", CPU),
               _highest_fp32(shards, max_m)]
        arrs = [tuple(x[0] for x in arrays) for arrays, _ in got]
        b = torch.ones((got[0][1].min_b_rows, 16))
    else:
        _, _, aligned, shards = _halo_case(3)
        got = [th.build_halo_plan(shards, aligned, device=CPU, dtype=np.float32,
                                  precision="default"), _highest_fp32_halo(shards, aligned)]
        arrs = [arrays for arrays, _ in got]
        b = torch.ones((3, got[0][1].min_b_rows, 16))
    (_, op), (_, f_op) = got
    assert smoke.op_point(op, torch.bfloat16) == (1, "bf16")
    ms, by = smoke.panel_bound(op, arrs[0], b)
    f_args = f_op.kernel_args(arrs[1], b)
    panel = next(t for t in smoke.flat(f_args) if isinstance(t, torch.Tensor) and t.dim() >= 3)
    rows = f_op.roofline["c_rows"]
    want = (smoke.nbytes(*f_args) - panel.numel() * 2 - b.numel() * 2 + rows * 16 * 4)
    assert by == "bytes"
    assert ms == pytest.approx(want / smoke.HBM_BYTES_PER_S * 1e3, rel=1e-12)
