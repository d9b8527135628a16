"""Kernel #4, the non-super-grouped windowed SpMM: the port's multi-shard
uniform pack against JAX's ``_pack_pallas_uniform`` (bit for bit; on fp32
the port holds at x3 the bf16 hi/lo pair of JAX's fp32 panels, and at
``default`` their bf16 hi plane, split or rounded once at pack time), its
plain version ``spmm_window_plain`` against
``spmm_window_pallas`` in interpret mode, and the single-shard packs with
no super-group plan, which both packages now send to this kernel."""

import jax
import numpy as np
import pytest
import torch

from crp_tpu.config import SpmmConfig as JaxConfig
from crp_tpu.engine.rowpara import RowParaSpmm as JaxRowPara
from crp_tpu.kernels import dispatch as jd
from crp_tpu.kernels.spmm_pallas import WindowDense, spmm_window_pallas
from crp_tpu.shard.layout import make_mesh_1d

from crp_tpu_torch.config import SpmmConfig
from crp_tpu_torch.engine.rowpara import RowParaSpmm
from crp_tpu_torch.kernels import dispatch as td
from crp_tpu_torch.kernels.device_pack import split_bf16
from crp_tpu_torch.kernels.spmm_pallas import spmm_window_plain, tf32_panels
from crp_tpu_torch.plan.partition1d import csr_row_partition
from crp_tpu_torch.sparse.csr import CSRMatrix
from crp_tpu_torch.sparse.synth import banded_random_csr
from crp_tpu_torch.utils.norms import rel_fro_err

CPU = torch.device("cpu")
POINTS = [("x3", np.float32), ("default", np.float32), ("highest", np.float32),
          ("highest", np.float64)]


def _bf16_exact(x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16).to(
        torch.float32).numpy()


def _shards(p, dtype, empty=True, bf16_values=False, seed=31):
    """``banded_random_csr`` cut into p nnz-balanced row shards (columns
    global), one emptied when ``empty``; values rounded to bf16 when
    ``bf16_values``."""
    a = banded_random_csr(2600, nnz_per_row=7, bandwidth=70, seed=seed, dtype=dtype)
    if bf16_values:
        a = CSRMatrix(a.nrow, a.ncol, a.rowptr, a.colidx, _bf16_exact(a.val))
    d = csr_row_partition(a.rowptr, p)
    out = []
    for i in range(p):
        s = a.row_slice(int(d[i]), int(d[i + 1]))
        if empty and i == p - 2:
            out.append((np.zeros(s.nrow + 1, np.int64), np.zeros(0, np.int32),
                        np.zeros(0, dtype)))
        else:
            out.append((s.rowptr, s.colidx.astype(np.int32), s.val))
    return a, out, int(np.diff(d).max())


def _anti_banded(nrow=1500, seed=7, dtype=np.float32):
    """Band along the anti-diagonal: window starts fall group by group."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(nrow), 5)
    cols = np.clip(nrow - 1 - rows + rng.integers(-30, 31, rows.size), 0, nrow - 1)
    key = np.unique(rows * nrow + cols)
    return CSRMatrix.from_coo(nrow, nrow, key // nrow, key % nrow,
                              rng.standard_normal(key.size), dtype=dtype)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _highest_fp32(shards, max_m):
    """#4's pack at ``highest`` with its TF32 planes turned back into the
    fp32 panels they were split from (JAX's panels, bit for bit), and its
    op: the fp32 panels that the other points are held against."""
    (ws, planes), op = td._pack_window(shards, max_m, np.float32, "highest", CPU)
    return (ws, tf32_panels(planes.transpose(0, 1))), op


def _fp32_panels_engine(eng):
    """An engine at ``highest`` whose #4 or #12 holds TF32 planes, made to
    hold the fp32 panels they were split from instead (so that its op's
    plain version runs them at another point); returns it."""
    op = eng._local_op
    if getattr(op, "scheme", None) == "window_tf32":
        eng.packed_1 = tf32_panels(eng.packed_1.transpose(0, 1))
        op.scheme = "window"
    if op.variant == "halo" and eng.packed_2.dtype == torch.float32:
        # (ws, ws_rel, big, small, push, chunk_src) -> (ws, ws_rel, panels, ...)
        packed = list(eng.packed)
        packed[2:4] = [tf32_panels(packed[2:4])]
        for i, x in enumerate(packed):
            setattr(eng, f"packed_{i}", x)
        delattr(eng, f"packed_{len(packed)}")
        eng._n_packed = len(packed)
    return eng


def assert_pack_is_jax(arrays, op, j_arrays, prec, dtype):
    """The port's (ws, tiles) equal to JAX's (ws, tiles) bit for bit, or on
    fp32 at x3 its (ws, ah, al) with (ah, al) ``split_bf16`` of JAX's fp32
    panels bit for bit (scheme ``"window_x3"``), at ``default`` its (ws,
    ah) with ah their RNE bf16 hi plane (scheme ``"window_bf16"``), at
    ``highest`` its (ws, planes) with planes their TF32 operand planes, from
    which JAX's panels come back bit for bit (scheme ``"window_tf32"``)."""
    assert op.variant == "window" and len(j_arrays) == 2
    np.testing.assert_array_equal(arrays[0].numpy(), j_arrays[0])
    j_tiles = torch.from_numpy(j_arrays[1])
    if prec == "highest" and dtype == np.float32:
        assert op.scheme == "window_tf32" and len(arrays) == 2
        planes = arrays[1]
        assert planes.shape == (j_tiles.shape[0], 2, *j_tiles.shape[1:])
        back = tf32_panels(planes.transpose(0, 1))
        assert torch.equal(back.view(torch.int32), j_tiles.view(torch.int32))
        return
    if prec == "x3" and dtype == np.float32:
        assert op.scheme == "window_x3" and len(arrays) == 3
        want = split_bf16(j_tiles, with_lo=True)
    elif prec == "default" and dtype == np.float32:
        assert op.scheme == "window_bf16" and len(arrays) == 2
        want = split_bf16(j_tiles, with_lo=False)[:1]
    else:
        assert op.scheme == "window" and len(arrays) == 2
        want = (j_tiles,)
    for t, w in zip(arrays[1:], want):
        assert t.dtype == w.dtype and t.shape == w.shape
        assert torch.equal(_bits(t), _bits(w))


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("prec,dtype", POINTS)
def test_multi_shard_pack_matches_jax(prec, dtype, p):
    """(ws, tiles) of p shards, one empty, with pad groups past the largest
    shard's: the JAX pack bit for bit (at x3 the bf16 pair of its fp32
    panels, at ``default`` their hi plane, at ``highest`` their TF32
    planes), the same min_b_rows and roofline, but for the hi plane's bytes
    at ``default`` on fp32: half the fp32 panels', with B read in bf16 (as
    JAX's #2 pack counts it), and the TF32 planes' at ``highest``: twice
    them."""
    _, shards, max_m = _shards(p, dtype)
    arrays, op = td._pack_pallas_uniform(shards, max_m + 700, dtype, prec, CPU)
    j_arrays, j_fn = jd._pack_pallas_uniform(shards, max_m + 700, dtype, prec)
    assert_pack_is_jax(arrays, op, j_arrays, prec, dtype)
    want = dict(j_fn.roofline)
    if prec == "default" and dtype == np.float32:
        want.update(a_bytes=want["a_bytes"] // 2, b_itemsize=2)
    if prec == "highest" and dtype == np.float32:
        want.update(a_bytes=want["a_bytes"] * 2)
    assert (op.min_b_rows, op.roofline) == (j_fn.min_b_rows, want)
    empty = [t[p - 2] for t in arrays]
    if op.scheme == "window_tf32":  # the planes of zero panels: zeros come back
        empty[1] = tf32_panels(empty[1])
    assert not any(t.any() for t in empty)


def _jax_precision(prec, dtype):
    if dtype == np.float64 or prec == "highest":
        return None
    return "x3" if prec == "x3" else jax.lax.Precision.DEFAULT


@pytest.mark.parametrize("n", [16, 100])
@pytest.mark.parametrize("prec,dtype", POINTS)
def test_plain_matches_pallas_interpret(prec, dtype, n):
    """``spmm_window_plain`` within 1e-6 relative Frobenius (1e-12 in fp64)
    of ``spmm_window_pallas(interpret=True)`` on every shard of a 3-shard
    pack with an empty shard and pad groups: the same products summed in
    another order.  JAX's kernel runs on JAX's own pack, the port's plain
    version on the port's (at x3 the bf16 pair).  At ``default`` the
    values are bf16-exact: the TPU's one bf16 pass rounds them, which the
    interpreter on the CPU does not, so only on such values do both
    compute the same function."""
    default = prec == "default"
    _, shards, max_m = _shards(3, dtype, bf16_values=default)
    arrays, op = td._pack_window(shards, max_m + 300, dtype, prec, CPU)
    ws, tiles = jd._pack_pallas_uniform(shards, max_m + 300, dtype, prec)[0]
    rng = np.random.default_rng(n)
    b = rng.standard_normal((op.min_b_rows, n)).astype(dtype)
    if default:
        b = _bf16_exact(b)
    G, TM, W = tiles.shape[1:]
    for i in range(len(shards)):
        packed = WindowDense(nrow=G * TM, ncol=b.shape[0], TM=TM, G=G, W=W,
                             ws=ws[i], tiles=tiles[i])
        want = np.asarray(spmm_window_pallas(
            packed, b, precision=_jax_precision(prec, dtype), interpret=True))
        args = op.kernel_args(tuple(x[i] for x in arrays), torch.from_numpy(b))
        assert op.plain is spmm_window_plain
        got = spmm_window_plain(*args).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape == (G * TM, n)
        assert rel_fro_err(want.astype(np.float64), got) <= (
            1e-12 if dtype == np.float64 else 1e-6)
        nrow = len(shards[i][0]) - 1 if len(shards[i][1]) else 0
        assert not np.any(got[nrow:])  # pad groups and the empty shard


@pytest.mark.parametrize("prec,dtype", POINTS)
def test_non_monotone_single_shard_takes_the_window_kernel(prec, dtype):
    """One shard whose windows fall group by group has no super-group plan:
    JAX packs it for ``spmm_window_pallas`` and so does the port (variant
    ``"window"``, no longer the ragged pack), the same arrays (at x3 the
    bf16 pair of JAX's fp32 panels, at ``default`` their hi plane)."""
    a = _anti_banded(dtype=dtype)
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    j_arrays, j_fn, j_kind = jd.pack_with_fallback(shard, a.nrow + 300, dtype,
                                                   "pallas", mxu_precision=prec)
    arrays, op, kind = td.pack_with_fallback(shard, a.nrow + 300, dtype, "pallas",
                                             device=CPU, mxu_precision=prec)
    assert kind == j_kind == "pallas" and len(j_arrays) == 2
    assert (op.variant, op.precision) == ("window", prec)
    assert_pack_is_jax(arrays, op, j_arrays, prec, dtype)
    assert op.min_b_rows == j_fn.min_b_rows


@pytest.mark.parametrize("prec", ["x3", "highest"])
def test_engine_on_non_monotone_matches_jax(prec):
    """The p = 1 engine on the anti-banded matrix: the JAX engine's kind and
    C to 1e-6 (JAX runs its kernel in interpret mode)."""
    a = _anti_banded()
    displs = csr_row_partition(a.rowptr, 1)
    b = np.random.default_rng(2).standard_normal((a.ncol, 24)).astype(np.float32)
    j = JaxRowPara(a, displs, displs, 24, mesh=make_mesh_1d(1),
                   config=JaxConfig(kernel="pallas", mxu_precision=prec),
                   dtype=np.float32)
    t = RowParaSpmm(a, displs, displs, 24, device="cpu", dtype=np.float32,
                    config=SpmmConfig(kernel="pallas", mxu_precision=prec))
    assert t.kernel_kind == j.kernel_kind == "pallas"
    assert t._local_op.variant == "window" and t._rb_rows == j._rb_rows
    assert rel_fro_err(j.exec(b).astype(np.float64), t.exec(b)) <= 1e-6


def test_jax_multi_shard_pack_feeds_the_port():
    """A JAX multi-shard windowed pack, handed to the port
    (``local_op_from_jax_pack``), gives the port's own pack's product: its
    fp32 x3 panels are split to the bf16 pair on upload."""
    _, shards, max_m = _shards(3, np.float32)
    j_arrays, j_fn = jd._pack_pallas_uniform(shards, max_m, np.float32, "x3")
    tensors, op = td.local_op_from_jax_pack(j_arrays, j_fn.min_b_rows, device="cpu",
                                            roofline=j_fn.roofline)
    assert (op.variant, op.scheme, op.precision) == ("window", "window_x3", "x3")
    t_arrays, t_op = td._pack_window(shards, max_m, np.float32, "x3", CPU)
    b = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (op.min_b_rows, 16)).astype(np.float32))
    for i in range(3):
        got = op(tuple(x[i] for x in tensors), b)
        want = t_op(tuple(x[i] for x in t_arrays), b)
        assert torch.equal(got, want)
