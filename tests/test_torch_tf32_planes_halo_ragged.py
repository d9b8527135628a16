"""#12's and #6's ``highest`` packs hold the TF32 big/small planes, split
once at init, as #3's and #4's do (``tests/test_torch_tf32_pair.py``).

The ``wgmma`` body's TF32 mode (``csrc/x3_wgmma.cuh``, ``TF32X3``) takes
the chunked walk of #12 and the ragged walk of #6: its panels come by TMA,
which copies bytes, and the tensor cores read the top 19 bits of an fp32
operand.  So #12's halo plan and #6's ragged pack densify fp32 at
``highest`` straight to two planes of the operand bits the 3xTF32 split
hands the tensor cores (``device_pack.tf32_operands``), two tensors of the
panels' shape, where JAX keeps fp32 panels.  Here: the planes' top 19 bits
are ``split_tf32`` of JAX's fp32 panels and the panels come back from the
big plane exactly, several shards and pad steps included; the plain
versions on the planes equal those on the fp32 panels bit for bit; both
caps still price fp32; a JAX ragged pack is split on upload.  The kernels
are held against the plain versions in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from crp_tpu.kernels import dispatch as jd
from crp_tpu.kernels import spmm_halo as jh

from crp_tpu_torch.kernels import device_pack
from crp_tpu_torch.kernels import dispatch as td
from crp_tpu_torch.kernels import spmm_halo as th
from crp_tpu_torch.kernels import spmm_pallas as tsp
from crp_tpu_torch.kernels import spmm_ragged as tr
from crp_tpu_torch.sparse.synth import fill_b
from tests.test_torch_x3_multishard import _halo_case
from tests.tf32x3_emulation import RAGGED_MIN_NNZ, _ragged_case

CPU = torch.device("cpu")
MASK = -0x2000  # the 19 bits the tensor cores read


def _bits(t) -> torch.Tensor:
    return torch.as_tensor(t).view(torch.int32)


def _assert_planes_of(big, small, panels):
    """``big`` and ``small`` (fp32, the panels' shape) hold the TF32
    operand bits of fp32 ``panels``: their top 19 bits are ``split_tf32``'s,
    and the panels come back from the big plane exactly."""
    panels = torch.as_tensor(np.asarray(panels))
    assert big.dtype == small.dtype == torch.float32
    assert big.shape == small.shape == panels.shape
    want_big, want_small = (_bits(x) for x in tsp.split_tf32(panels))
    assert torch.equal(_bits(big) & MASK, want_big)
    assert torch.equal(_bits(small) & MASK, want_small)
    assert torch.equal(_bits(tsp.tf32_panels((big, small))), _bits(panels))


def _b_shards(a, aligned, op, n):
    b = fill_b(0, a.ncol, 0, n, dtype=np.float32)
    p = len(aligned) - 1
    bs = np.zeros((p, op.min_b_rows, n), np.float32)
    for i in range(p):
        bs[i, : aligned[i + 1] - aligned[i]] = b[aligned[i]:aligned[i + 1]]
    return torch.from_numpy(bs)


@pytest.mark.parametrize("p", [2, 3, 4, 7])
def test_halo_highest_plan_holds_tf32_planes_of_jax_panels(p):
    """``build_halo_plan`` at ``highest`` on fp32: (ws, ws_rel, big, small,
    push, chunk_src), the planes those of JAX's ``a_panels`` (pad groups
    included), each ``(p, G, TM, W)``; ``a_bytes`` twice the fp32 panels',
    JAX's 6 passes; the op hands the kernel the pair, and #12's entry takes
    it; a rank's plan is its slice of the whole one."""
    _, _, aligned, shards = _halo_case(p)
    jp = jh.build_halo_plan(shards, aligned, dtype=np.float32)
    arrays, op = th.build_halo_plan(shards, aligned, device=CPU, dtype=np.float32)
    assert len(arrays) == 6
    ws, ws_rel, big, small, push, chunk_src = arrays
    _assert_planes_of(big, small, jp.a_panels)
    np.testing.assert_array_equal(ws_rel.numpy(), jp.ws_rel)
    assert op.roofline["a_bytes"] == 2 * jp.a_panels.nbytes
    assert op.roofline["passes"] == 6 and op.roofline["b_itemsize"] == 4
    args = op.kernel_args(arrays, torch.zeros((p, op.min_b_rows, 3)))
    assert args[2] == (big, small) and args[5].dtype == torch.float32
    assert tsp.window_entry("spmm_halo", args[2], "highest") == (
        "crp_halo_f32", torch.float32, torch.float32)
    for r in (0, p - 1):
        mine, _ = th.build_halo_plan(shards, aligned, device=CPU, dtype=np.float32,
                                     ranks=[r])
        for x, y in zip(mine, arrays):
            if y.dim() >= 2 and y.shape[0] == p and x.shape[0] == 1:
                assert torch.equal(_bits(x), _bits(y[r : r + 1]))


@pytest.mark.parametrize("n", [13, 64])
@pytest.mark.parametrize("p", [2, 4])
def test_halo_plain_on_planes_equals_plain_on_fp32_panels(p, n):
    """The fused kernel's plain version on the TF32 planes equals it on
    the fp32 panels they were split from, bit for bit, and each shard
    equals #4's plain version on the same planes with its pushed window
    buffer (as #12's kernel equals #4's on the card)."""
    a, _, aligned, shards = _halo_case(p, seed=70)
    arrays, op = th.build_halo_plan(shards, aligned, device=CPU, dtype=np.float32)
    bs = _b_shards(a, aligned, op, n)
    got = th.spmm_halo_plain(*op.kernel_args(arrays, bs))
    fp32 = tsp.tf32_panels(arrays[2:4])
    want = th.spmm_halo_plain(*arrays[:2], fp32, *arrays[4:], bs, "highest", op.buf_rows)
    assert got.shape == (p, op.G * op.TM, n) and got.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(op(arrays, bs), got)
    buf = th.halo_buffers(arrays[4], bs, op.buf_rows)
    for i in range(p):
        planes = torch.stack((arrays[2][i], arrays[3][i]))  # #4's (2, G, TM, W)
        one = tsp.spmm_window_plain(arrays[1][i], planes, buf[i], "highest")
        assert torch.equal(_bits(one), _bits(got[i]))


def _knobs(monkeypatch, TM, Wc, spill):
    for k, v in (("CRP_TPU_RAGGED_TM", TM), ("CRP_TPU_RAGGED_WC", Wc),
                 ("CRP_TPU_RAGGED_MIN_NNZ", RAGGED_MIN_NNZ), ("CRP_TPU_SPILL_IMPL", spill)):
        monkeypatch.setenv(k, str(v))
    for k in ("CRP_TPU_RAGGED_AUTO", "CRP_TPU_RAGGED_PANEL_GB", "CRP_TPU_RAGGED_MIN_PCT",
              "CRP_TPU_SPILL_TMO", "CRP_TPU_SPILL_Q"):
        monkeypatch.delenv(k, raising=False)


def _ragged_packs(monkeypatch, TM, Wc, spill="segsum"):
    """The two-shard ragged case packed at ``highest`` by JAX (its knobs)
    and by the port: ``(a, j_arrays, j_fn, arrays, op)``."""
    _knobs(monkeypatch, TM, Wc, spill)
    a, shards, max_m = _ragged_case(TM)
    j_arrays, j_fn = jd.pack_local_kernel(shards, max_m, np.float32, "ragged",
                                          mxu_precision="highest")
    arrays, op = td._pack_ragged(shards, max_m, np.float32, "highest", CPU,
                                 geometry=(TM, Wc), min_chunk_nnz=RAGGED_MIN_NNZ,
                                 spill_impl=spill)
    return a, j_arrays, j_fn, arrays, op


@pytest.mark.parametrize("spill", ["segsum", "pallas"])
@pytest.mark.parametrize("TM,Wc", [(128, 256), (256, 128)])
def test_ragged_highest_pack_holds_tf32_planes_of_jax_panels(monkeypatch, TM, Wc, spill):
    """#6's pack at ``highest`` (two shards, dummy chunks, the first
    shard's trailing no-op steps, pad groups): scheme ``"tf32"``, (step_g,
    step_first, starts, big, small, *spill, group_ptr, ...), the planes
    those of JAX's fp32 panels, each ``(p, S, TM, Wc)``, every other array
    JAX's; ``a_bytes`` twice the fp32 panels', the roofline else JAX's;
    the op hands the kernel the pair as one argument."""
    _, j_arrays, j_fn, arrays, op = _ragged_packs(monkeypatch, TM, Wc, spill)
    assert (op.scheme, op.variant, op.n_panels) == ("tf32", "ragged", 2)
    _assert_planes_of(arrays[3], arrays[4], j_arrays[3])
    for t, j in zip(arrays[:3] + arrays[5:], j_arrays[:3] + j_arrays[4:]):
        assert np.array_equal(t.numpy(), np.asarray(j))
    assert op.roofline == dict(j_fn.roofline, a_bytes=2 * j_arrays[3].nbytes)
    assert op.min_b_rows == j_fn.min_b_rows
    args = op.kernel_args(tuple(x[0] for x in arrays), torch.zeros((op.min_b_rows, 3)))
    assert len(args) == 5 and [x.data_ptr() for x in args[3]] == [
        arrays[3][0].data_ptr(), arrays[4][0].data_ptr()]
    assert op.kernel is tr.spmm_ragged and op.plain is tr.spmm_ragged_plain


@pytest.mark.parametrize("n", [16, 37])
def test_ragged_plain_on_planes_equals_plain_on_fp32_panels(monkeypatch, n):
    """Per shard, #6's plain version on the TF32 planes equals it on the
    fp32 panels they were split from, bit for bit, and so does the op with
    its spill."""
    _, _, _, arrays, op = _ragged_packs(monkeypatch, 256, 128)
    b = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (op.min_b_rows, n)).astype(np.float32))
    fp32 = tsp.tf32_panels(arrays[3:5])
    for i in range(2):
        arrs = tuple(x[i] for x in arrays)
        step_g, _, starts = arrs[:3]
        group_ptr = op._ptrs(arrs)[0]
        got = op.plain(*op.kernel_args(arrs, b))
        want = tr.spmm_ragged_plain(step_g, group_ptr, starts, fp32[i], b)
        assert torch.equal(_bits(got), _bits(want))
        assert torch.equal(_bits(tr.spmm_ragged(step_g, group_ptr, starts, fp32[i], b,
                                                min_b_rows=op.min_b_rows)), _bits(want))
    assert op(tuple(x[0] for x in arrays), b).shape[1] == n


def test_halo_and_ragged_caps_price_fp32(monkeypatch):
    """Both caps price ``highest``'s fp32 panels, as JAX's packs do, not the
    planes' twice that: with each cap lowered under the planes' bytes and
    over the fp32 panels', #12's plan and #6's pack are still accepted, the
    same arrays bit for bit as uncapped."""
    _, _, aligned, shards = _halo_case(3)
    whole, op = th.build_halo_plan(shards, aligned, device=CPU, dtype=np.float32)
    shard_planes = 2 * op.G * op.TM * op.W * 4  # one shard's planes at the shared G, W
    monkeypatch.setattr(th, "PANEL_CAP_BYTES", shard_planes - 1)
    capped, c_op = th.build_halo_plan(shards, aligned, device=CPU, dtype=np.float32)
    assert shard_planes // 2 <= th.PANEL_CAP_BYTES < shard_planes
    assert all(torch.equal(_bits(x) if x.dtype == torch.float32 else x,
                           _bits(y) if y.dtype == torch.float32 else y)
               for x, y in zip(capped, whole))
    assert c_op.roofline == op.roofline
    a, shards, max_m = _ragged_case(256)
    one = shards[1:]
    kw = dict(geometry=(256, 128), min_chunk_nnz=RAGGED_MIN_NNZ, spill_impl="segsum")
    arrays, r_op = td._pack_ragged(one, max_m, np.float32, "highest", CPU, **kw)
    fp32 = arrays[3].numel() * 4
    monkeypatch.setattr(td, "PANEL_CAP_BYTES", fp32 * 3 // 2)
    got, g_op = td._pack_ragged(one, max_m, np.float32, "highest", CPU, **kw)
    assert r_op.roofline["a_bytes"] == 2 * fp32 > td.PANEL_CAP_BYTES
    assert g_op.roofline == r_op.roofline and len(got) == len(arrays)
    assert all(torch.equal(x, y) for x, y in zip(got, arrays))


def test_jax_ragged_highest_pack_split_on_upload(monkeypatch):
    """``local_op_from_jax_pack(variant="ragged")`` splits a JAX fp32
    ``highest`` ragged pack to its TF32 planes on upload: the pack's
    arrays and planes the port's own pack has, bit for bit, its spill and
    ``a_bytes`` (the planes') the same."""
    _, j_arrays, j_fn, arrays, op = _ragged_packs(monkeypatch, 256, 128, "pallas")
    up, u_op = td.local_op_from_jax_pack(j_arrays, j_fn.min_b_rows, device="cpu",
                                         roofline=dict(j_fn.roofline), variant="ragged")
    assert (u_op.scheme, u_op.spill_impl, u_op.spill_tmo) == ("tf32", op.spill_impl,
                                                              op.spill_tmo)
    assert u_op.roofline["a_bytes"] == op.roofline["a_bytes"] == 2 * j_arrays[3].nbytes
    k = len(j_arrays) + 1  # the pack's arrays, the two planes in the panels' place
    for x, y in zip(up[:k], arrays[:k]):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))


def test_tf32_pair_splits_as_the_packs():
    """``device_pack.tf32_pair`` (the upload's split) writes the bits the
    slab densify writes, and the stacked ``tf32_planes`` of #3 and #4 hold
    the same planes side by side."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 128, 64)).astype(np.float32))
    big, small = device_pack.tf32_pair(x)
    stacked = device_pack.tf32_planes(x[None])[0]
    assert torch.equal(_bits(big), _bits(stacked[0]))
    assert torch.equal(_bits(small), _bits(stacked[1]))
    _assert_planes_of(big, small, x)
