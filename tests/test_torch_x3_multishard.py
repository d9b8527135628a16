"""The multi-shard x3 packs on the bf16 hi/lo pair: kernel #4's
(``_pack_window``, scheme ``"window_x3"``) and the fused halo kernel #12's
(``build_halo_plan``).

The JAX package keeps fp32 panels at every operating point and its TPU
kernels split them to bf16 hi/lo in VMEM on every read.  The port's
``wgmma`` body is fed by TMA, which copies and cannot split, so at x3 the
port densifies straight to the pair, once, with the same RNE split.  Here:
the pair equals ``split_bf16`` of JAX's fp32 panels bit for bit; the plain
versions on the pair (``spmm_window_sg_presplit_plain`` per shard, and its
halo counterpart on the pushed window buffers) equal the plain versions on
the fp32 panels bit for bit; a JAX multi-shard x3 pack is split on upload;
the wrappers refuse what has no kernel; and the engines hold the pair.
The CUDA kernels are held against these plain versions in
``test_torch_cuda.py``.
"""

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
from crp_tpu_torch.kernels.spmm_pallas import tf32_panels
from crp_tpu_torch.plan.partition1d import csr_row_partition
from crp_tpu_torch.sparse.synth import banded_random_csr, fill_b
from tests.test_torch_window import _bits, _fp32_panels_engine, _highest_fp32, _shards

CPU = torch.device("cpu")


def _halo_case(p, seed=60):
    a = banded_random_csr(1800 + 97 * p, nnz_per_row=7, bandwidth=60, seed=seed + p,
                          dtype=np.float32)
    d = csr_row_partition(a.rowptr, p)
    aligned = th.align_displs(d, a.ncol)
    shards = [a.row_slice(int(d[i]), int(d[i + 1])) for i in range(p)]
    return a, d, aligned, shards


def _highest_fp32_halo(shards, aligned):
    """#12's plan at ``highest`` with its TF32 planes turned back into the
    fp32 panels they were split from (JAX's ``a_panels``, bit for bit),
    ``(ws, ws_rel, panels, push, chunk_src)``, and its op, ``a_bytes``
    those panels' bytes: the fp32 panels that the other points are held
    against."""
    arrays, op = th.build_halo_plan(shards, aligned, device=CPU, dtype=np.float32)
    op.roofline["a_bytes"] //= 2
    return (*arrays[:2], tf32_panels(arrays[2:4]), *arrays[4:]), op


@pytest.mark.parametrize("p", [2, 3, 4, 7])
def test_halo_x3_pair_is_split_of_jax_panels(p):
    """``build_halo_plan`` at x3: (ws, ws_rel, ah, al, push, chunk_src),
    the pair ``split_bf16`` of JAX's fp32 panels bit for bit, every other
    array and the geometry the plan's at ``highest``, ``a_bytes`` the fp32
    panels' bytes."""
    _, _, aligned, shards = _halo_case(p)
    jp = jh.build_halo_plan(shards, aligned, dtype=np.float32)
    arrays, op = th.build_halo_plan(shards, aligned, device=CPU, dtype=np.float32,
                                    precision="x3")
    f_arrays, f_op = _highest_fp32_halo(shards, aligned)
    assert len(arrays) == 6 and len(f_arrays) == 5
    ws, ws_rel, ah, al, push, chunk_src = arrays
    want = split_bf16(torch.from_numpy(jp.a_panels), with_lo=True)
    for t, w in zip((ah, al), want):
        assert t.dtype == torch.bfloat16 and t.shape == jp.a_panels.shape
        assert torch.equal(_bits(t), _bits(w))
    for t, f in zip((ws, ws_rel, push, chunk_src), f_arrays[:2] + f_arrays[3:]):
        assert torch.equal(t, f)
    assert (op.G, op.W, op.buf_rows, op.min_b_rows, op.halo_rows_pushed) == (
        f_op.G, f_op.W, f_op.buf_rows, f_op.min_b_rows, f_op.halo_rows_pushed)
    assert op.roofline["a_bytes"] == jp.a_panels.nbytes == f_op.roofline["a_bytes"]
    assert op.kernel_args(arrays, None)[2] == (ah, al)


@pytest.mark.parametrize("n", [16, 37])
@pytest.mark.parametrize("p", [2, 4])
def test_window_pair_plain_equals_fp32_plain(p, n):
    """Per shard, ``spmm_window_sg_presplit_plain`` on the x3 pair equals
    ``spmm_window_plain(..., "x3")`` on the fp32 panels it was split from,
    bit for bit (an empty shard and pad groups included); the op's plain
    version on the pair is the former."""
    _, shards, max_m = _shards(p, np.float32)
    arrays, op = td._pack_window(shards, max_m + 300, np.float32, "x3", CPU)
    f_arrays, _ = _highest_fp32(shards, max_m + 300)
    assert op.scheme == "window_x3" and len(arrays) == 3
    b = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (op.min_b_rows, n)).astype(np.float32))
    for i in range(p):
        ws, ah, al = (x[i] for x in arrays)
        pair = tsp.spmm_window_sg_presplit_plain(ws, ah, al, b)
        fp32 = tsp.spmm_window_plain(f_arrays[0][i], f_arrays[1][i], b, "x3")
        assert torch.equal(pair.view(torch.int32), fp32.view(torch.int32))
        got = op.plain(*op.kernel_args((ws, ah, al), b))
        assert torch.equal(got.view(torch.int32), pair.view(torch.int32))


@pytest.mark.parametrize("n", [13, 64])
@pytest.mark.parametrize("p", [2, 4])
def test_halo_pair_plain_equals_fp32_plain(p, n):
    """The fused kernel's plain version on the x3 pair (each shard's
    ``spmm_window_sg_presplit_plain`` on its pushed window buffer) equals
    it on the fp32 panels at x3, bit for bit."""
    a, _, aligned, shards = _halo_case(p, seed=70)
    arrays, op = th.build_halo_plan(shards, aligned, device=CPU, dtype=np.float32,
                                    precision="x3")
    f_arrays, _ = _highest_fp32_halo(shards, aligned)
    b = fill_b(0, a.ncol, 0, n, dtype=np.float32)
    bs = np.zeros((p, op.min_b_rows, n), np.float32)
    for i in range(p):
        bs[i, : aligned[i + 1] - aligned[i]] = b[aligned[i]:aligned[i + 1]]
    bs = torch.from_numpy(bs)
    got = th.spmm_halo_plain(*op.kernel_args(arrays, bs))
    want = th.spmm_halo_plain(*f_arrays[:2], f_arrays[2], *f_arrays[3:], bs, "x3",
                              op.buf_rows)
    assert got.shape == (p, op.G * op.TM, n)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    buf = th.halo_buffers(arrays[4], bs, op.buf_rows)
    for i in range(p):
        one = tsp.spmm_window_sg_presplit_plain(arrays[1][i], arrays[2][i], arrays[3][i],
                                                buf[i])
        assert torch.equal(one.view(torch.int32), got[i].view(torch.int32))


@pytest.mark.parametrize("prec", ["x3", "default", "highest"])
def test_local_op_from_jax_pack_splits_multi_shard_x3(prec):
    """A JAX multi-shard pack (fp32 (ws, tiles)) handed to the port: at x3
    it is split to the pair on upload (scheme ``"window_x3"``), at
    ``default`` rounded to the bf16 hi plane (``"window_bf16"``), at
    ``highest`` split to the TF32 planes (``"window_tf32"``), each the
    port's own pack bit for bit, roofline included."""
    _, shards, max_m = _shards(3, np.float32)
    j_arrays, j_fn = jd._pack_pallas_uniform(shards, max_m, np.float32, prec)
    tensors, op = td.local_op_from_jax_pack(j_arrays, j_fn.min_b_rows, device="cpu",
                                            roofline=j_fn.roofline)
    t_arrays, t_op = td._pack_window(shards, max_m, np.float32, prec, CPU)
    assert (op.variant, op.precision, op.min_b_rows) == ("window", prec, t_op.min_b_rows)
    assert op.scheme == t_op.scheme == {"x3": "window_x3", "default": "window_bf16",
                                        "highest": "window_tf32"}[prec]
    assert len(tensors) == len(t_arrays) == (3 if prec == "x3" else 2)
    for t, w in zip(tensors, t_arrays):
        assert t.dtype == w.dtype and torch.equal(_bits(t), _bits(w))
    assert op.roofline == t_op.roofline


def test_wrappers_refuse_what_has_no_kernel():
    """On the CPU the wrappers run their plain versions: the x3 pair and
    fp32 panels at x3 both work there; a bf16 pair at another point has no
    function and raises."""
    _, shards, max_m = _shards(2, np.float32, empty=False)
    arrays, op = td._pack_window(shards, max_m, np.float32, "x3", CPU)
    f_arrays, _ = _highest_fp32(shards, max_m)
    ws, ah, al = (x[0] for x in arrays)
    b = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (op.min_b_rows, 8)).astype(np.float32))
    c = tsp.spmm_window(ws, (ah, al), b, "x3", min_b_rows=op.min_b_rows)
    c32 = tsp.spmm_window(ws, f_arrays[1][0], b, "x3", min_b_rows=op.min_b_rows)
    assert torch.equal(c.view(torch.int32), c32.view(torch.int32))
    with pytest.raises(ValueError, match="pair"):
        tsp.spmm_window(ws, (ah, al), b, "highest", min_b_rows=op.min_b_rows)


@pytest.mark.parametrize("kernel", ["pallas", "pallas_halo"])
def test_engines_hold_the_pair(kernel):
    """``RowParaSpmm`` at p = 4 and x3 holds the bf16 pair in its buffers
    (no fp32 panel), of the bytes the fp32 panels had, and its C equals
    that of the fp32 panels' plain version at x3."""
    a = banded_random_csr(2400, nnz_per_row=7, bandwidth=60, seed=22, dtype=np.float32)
    d = csr_row_partition(a.rowptr, 4)
    eng = RowParaSpmm(a, d, d, 24, device="cpu", dtype=np.float32,
                      config=SpmmConfig(kernel=kernel, mxu_precision="x3"))
    dtypes = [x.dtype for x in eng.packed if x.dim() >= 3]
    assert dtypes == [torch.bfloat16, torch.bfloat16]
    panel_bytes = sum(x.numel() * x.element_size() for x in eng.packed if x.dim() >= 3)
    assert eng._local_op.roofline["a_bytes"] == panel_bytes
    b = fill_b(0, a.ncol, 0, 24, dtype=np.float32)
    a.__dict__.pop("_torch_pack_cache", None)
    ref = _fp32_panels_engine(RowParaSpmm(a, d, d, 24, device="cpu", dtype=np.float32,
                                          config=SpmmConfig(kernel=kernel,
                                                            mxu_precision="highest")))
    ref._local_op.precision = "x3"  # the fp32 panels through the x3 plain version
    np.testing.assert_array_equal(eng.exec(b), ref.exec(b))
