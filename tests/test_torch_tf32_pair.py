"""Every fp32 ``highest`` panel pack holds the TF32 big/small planes, split
once at init: #3's and #4's here, #12's and #6's also in
``test_torch_tf32_planes_halo_ragged.py``.

The ``wgmma`` body's TF32 mode (``csrc/x3_wgmma.cuh``, ``TF32X3``) is fed
by TMA, which copies bytes, and the tensor cores read the top 19 bits of
an fp32 shared-memory operand, a truncation.  So at ``highest`` the packs
densify fp32 straight to two planes of the operand bits the 3xTF32 split
hands the tensor cores (``device_pack.tf32_operands``), where JAX keeps
fp32 panels and splits on every read.  Here: the planes, whose top 19 bits
are ``split_tf32`` of JAX's fp32 panels and from which those panels come
back exactly; the plain versions on the planes equal those on the fp32
panels bit for bit; the 8 GiB cap still prices fp32; a JAX pack is split
on upload; #6's and #12's packs hold the planes too; the A/B tool's
cases, edits and arguments; and which entries the TF32 mode serves (all
four: no ``mma.sync`` body is left).  The CUDA kernels are held against
the plain versions in ``test_torch_cuda.py``.
"""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from crp_tpu.kernels import dispatch as jd
from crp_tpu.kernels import spmm_halo as jh

from crp_tpu_torch.cli import f64_ab, x3_feed_split
from crp_tpu_torch.kernels import _build, device_pack
from crp_tpu_torch.kernels import dispatch as td
from crp_tpu_torch.kernels import spmm_halo as th
from crp_tpu_torch.kernels import spmm_pallas as tsp
from crp_tpu_torch.sparse.synth import banded_random_csr
from tests.test_torch_window import _shards
from tests.test_torch_x3_multishard import _halo_case

CPU = torch.device("cpu")
REPO = pathlib.Path(__file__).resolve().parent.parent
MASK = -0x2000  # the 19 bits the tensor cores read


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def _assert_planes_of(planes, panels):
    """``planes`` (p, 2, G, TM, W) hold the TF32 operand bits of fp32
    ``panels`` (p, G, TM, W): their top 19 bits are ``split_tf32``'s, and
    the panels come back from the big plane exactly."""
    panels = torch.as_tensor(panels)
    big, small = (_bits(x) for x in tsp.split_tf32(panels))
    assert torch.equal(_bits(planes[:, 0]) & MASK, big)
    assert torch.equal(_bits(planes[:, 1]) & MASK, small)
    assert torch.equal(_bits(tsp.tf32_panels(planes.transpose(0, 1))), _bits(panels))


def test_uniform_highest_pack_holds_tf32_planes_of_jax_panels():
    """#3's pack at ``highest`` (one shard, a super-group plan): scheme
    ``"tf32"``, (ws, planes, bases) with planes ``(1, 2, G, TM, W)`` the
    TF32 operand bits of JAX's fp32 panels, ws and bases JAX's; the
    geometry priced at fp32 (JAX's 6 passes), ``a_bytes`` the planes'."""
    a = banded_random_csr(1800, nnz_per_row=7, bandwidth=90, seed=21, dtype=np.float32)
    one = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    arrays, op = td.pack_local_kernel(one, a.nrow + 300, np.float32, "pallas", device=CPU,
                                      mxu_precision="highest")
    (j_ws, j_tiles, j_bases), j_fn = jd.pack_local_kernel(one, a.nrow + 300, np.float32,
                                                          "pallas", mxu_precision="highest")
    assert (op.scheme, op.variant, op.precision) == ("tf32", "uniform", "highest")
    ws, planes, bases = arrays
    assert planes.dtype == torch.float32 and planes.shape == (1, 2, *j_tiles.shape[1:])
    _assert_planes_of(planes, j_tiles)
    np.testing.assert_array_equal(ws.numpy(), j_ws)
    np.testing.assert_array_equal(bases.numpy(), j_bases)
    assert op.min_b_rows == j_fn.min_b_rows
    assert op.roofline["a_bytes"] == planes.numel() * 4 == 2 * j_tiles.nbytes
    assert op.roofline["passes"] == 6
    assert op.kernel is tsp.spmm_window_sg and op.plain is tsp.spmm_window_sg_plain


@pytest.mark.parametrize("p", [2, 4])
def test_window_highest_pack_holds_tf32_planes_of_jax_panels(p):
    """#4's pack at ``highest`` (p shards, one empty, pad groups): scheme
    ``"window_tf32"``, (ws, planes) with planes ``(p, 2, G, TM, W)`` the
    TF32 operand bits of JAX's fp32 panels shard by shard, ws and
    min_b_rows JAX's, ``a_bytes`` the planes' (twice the fp32 panels')."""
    _, shards, max_m = _shards(p, np.float32)
    arrays, op = td._pack_window(shards, max_m + 300, np.float32, "highest", CPU)
    (j_ws, j_tiles), j_fn = jd._pack_pallas_uniform(shards, max_m + 300, np.float32,
                                                    "highest")
    assert (op.scheme, op.variant, op.precision) == ("window_tf32", "window", "highest")
    ws, planes = arrays
    assert planes.shape == (p, 2, *j_tiles.shape[1:])
    _assert_planes_of(planes, j_tiles)
    np.testing.assert_array_equal(ws.numpy(), j_ws)
    assert op.min_b_rows == j_fn.min_b_rows
    assert op.roofline["a_bytes"] == 2 * j_tiles.nbytes and op.roofline["passes"] == 6


def test_tf32_planes_of_specials_and_a_mesh_rank():
    """The split on zeros, subnormals, values that round to inf, and on
    inf and NaN (the card's canonical 0x7fffffff, a negative payload): the
    top 19 bits are ``split_tf32``'s wherever x is finite (on a NaN the
    card's own subtraction makes the canonical NaN, so the packs split
    there, and ``test_torch_cuda.py`` holds C NaN), and the panels come
    back from the planes exactly everywhere; a mesh rank's pack
    (``rank=``) holds its own shard's planes, the same bits."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 128, 96)) * 2.0 ** rng.integers(-60, 60, (2, 128, 96))
         ).astype(np.float32)
    x.reshape(-1)[:6] = [0.0, -0.0, 1e-40, -3e-39, 3.4e38, -3.3e38]
    x[1, 5, :3] = [np.inf, -np.inf, np.nan]
    t = torch.from_numpy(x)
    t.view(torch.int32)[1, 6, :2] = torch.tensor([0x7FFFFFFF, -1], dtype=torch.int32)
    planes = device_pack.tf32_planes(t[None])[0]
    fin = torch.isfinite(t)
    assert int((~fin).sum()) == 5
    for got, want in zip(planes, tsp.split_tf32(t)):
        assert torch.equal(_bits(got)[fin] & MASK, _bits(want)[fin])
    assert torch.equal(_bits(tsp.tf32_panels(planes)), _bits(t))
    _, shards, max_m = _shards(3, np.float32)
    every, _ = td._pack_window(shards, max_m, np.float32, "highest", CPU)
    mine, op = td._pack_window(shards, max_m, np.float32, "highest", CPU, rank=1)
    assert mine[1].shape == (1, *every[1].shape[1:])
    assert torch.equal(_bits(mine[1][0]), _bits(every[1][1]))
    assert op.roofline["a_bytes"] == every[1].numel() * 4


@pytest.mark.parametrize("n", [16, 37])
@pytest.mark.parametrize("p", [2, 3])
def test_plain_on_planes_equals_plain_on_fp32_panels(p, n):
    """Per shard, #3's and #4's plain versions on the TF32 planes equal
    their plain versions on the fp32 panels the planes were split from, bit
    for bit (an empty shard and pad groups included)."""
    _, shards, max_m = _shards(p, np.float32)
    arrays, op = td._pack_window(shards, max_m + 300, np.float32, "highest", CPU)
    _, j_tiles = jd._pack_pallas_uniform(shards, max_m + 300, np.float32, "highest")[0]
    b = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (op.min_b_rows, n)).astype(np.float32))
    for i in range(p):
        ws, planes = (x[i] for x in arrays)
        tiles = torch.from_numpy(j_tiles[i])
        want = tsp.spmm_window_plain(ws, tiles, b, "highest")
        assert torch.equal(_bits(op.plain(*op.kernel_args((ws, planes), b))), _bits(want))
        assert torch.equal(_bits(tsp.spmm_window_sg_plain(ws, planes, b)), _bits(want))
        assert torch.equal(_bits(tsp.spmm_window_sg_plain(ws, tiles, b)), _bits(want))


def test_shard_window_prices_fp32_bytes(monkeypatch):
    """The 8 GiB cap prices ``highest``'s fp32 panels (itemsize 4), as
    JAX's pack does, not the planes' twice that: with the cap lowered to
    1.5x a shard's fp32 panels, the pack is still accepted and holds planes
    over that cap."""
    _, shards, max_m = _shards(2, np.float32, empty=False)
    real = td._shard_window
    fp32 = max(G * W * 256 * 4 for _, W, G in (real(s, 256, 4) for s in shards))
    priced = []

    def capped(shard, TM, tile_itemsize):
        priced.append(tile_itemsize)
        got = real(shard, TM, tile_itemsize)
        _, W, G = got
        if G * W * TM * tile_itemsize > fp32 * 3 // 2:
            raise td.UnsupportedSparsity("over the lowered cap")
        return got

    monkeypatch.setattr(td, "_shard_window", capped)
    arrays, op = td._pack_window(shards, max_m, np.float32, "highest", CPU)
    assert priced == [4, 4] and op.scheme == "window_tf32"
    assert arrays[1][0].numel() * 4 > fp32 * 3 // 2


def test_jax_highest_packs_split_on_upload():
    """``local_op_from_jax_pack`` splits a JAX fp32 ``highest`` pack to
    its TF32 planes on upload, the multi-shard one (``"window_tf32"``) and
    the uniform sg pack (``"tf32"``), the bits the port's own packs hold;
    fp64 packs stay as they are."""
    _, shards, max_m = _shards(2, np.float32)
    (j_ws, j_tiles), j_fn = jd._pack_pallas_uniform(shards, max_m + 300, np.float32,
                                                    "highest")
    arrays, op = td.local_op_from_jax_pack((j_ws, j_tiles), j_fn.min_b_rows, device="cpu",
                                           roofline=dict(j_fn.roofline))
    own, _ = td._pack_window(shards, max_m + 300, np.float32, "highest", CPU)
    assert op.scheme == "window_tf32" and arrays[1].shape == own[1].shape
    assert torch.equal(_bits(arrays[1]), _bits(own[1]))
    assert op.roofline["a_bytes"] == own[1].numel() * 4
    a = banded_random_csr(1800, nnz_per_row=7, bandwidth=90, seed=21, dtype=np.float32)
    one = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    j_arrays, j_fn = jd.pack_local_kernel(one, a.nrow + 300, np.float32, "pallas",
                                          mxu_precision="highest")
    arrays, op = td.local_op_from_jax_pack(j_arrays, j_fn.min_b_rows, device="cpu",
                                           roofline=dict(j_fn.roofline))
    own, _ = td.pack_local_kernel(one, a.nrow + 300, np.float32, "pallas", device=CPU,
                                  mxu_precision="highest")
    assert op.scheme == "tf32" and torch.equal(_bits(arrays[1]), _bits(own[1]))
    one64 = [(a.rowptr, a.colidx.astype(np.int32), a.val.astype(np.float64))]
    j64, f64 = jd.pack_local_kernel(one64, a.nrow + 300, np.float64, "pallas",
                                    mxu_precision="highest")
    arrays, op = td.local_op_from_jax_pack(j64, f64.min_b_rows, device="cpu",
                                           roofline=dict(f64.roofline))
    assert op.scheme == "full" and arrays[1].dtype == torch.float64


def test_ragged_and_halo_highest_packs_stay_fp32():
    """#6's ragged pack and #12's halo plan at ``highest`` hold the TF32
    planes too, no fp32 panel: two fp32 tensors of the panels' shape, big
    and small (as #12's and #6's entries take them), from whose big plane
    JAX's fp32 panels come back exactly; ``a_bytes`` twice those panels'."""
    from tests.tf32x3_emulation import _ragged_pack

    _, _, arrays, op = _ragged_pack(256, 128)
    assert op.scheme == "tf32" and op.n_panels == 2
    big, small = arrays[3:5]
    assert big.dtype == small.dtype == torch.float32 and big.shape == small.shape  # (p, S, TM, Wc)
    assert op.roofline["a_bytes"] == 2 * big.numel() * 4
    _, _, aligned, shards = _halo_case(4)
    jp = jh.build_halo_plan(shards, aligned, dtype=np.float32)
    h_arrays, h_op = th.build_halo_plan(shards, aligned, device=CPU, dtype=np.float32)
    assert [t.shape for t in h_arrays[2:4]] == [jp.a_panels.shape] * 2
    assert torch.equal(_bits(tsp.tf32_panels(h_arrays[2:4])),
                       _bits(torch.from_numpy(jp.a_panels)))
    assert h_op.roofline["a_bytes"] == 2 * jp.a_panels.nbytes


def test_tf32_plane_views_refuse_other_fp32_panels():
    """#3's and #4's wrappers take fp32 ``highest`` panels on the card only
    as their contiguous TF32 planes ``(2, G, TM, W)``: the check they make
    before any launch raises on anything else."""
    planes = torch.zeros((2, 3, 128, 64))
    assert [t.shape for t in tsp._tf32_plane_views("x", planes)] == [(3, 128, 64)] * 2
    for bad in (torch.zeros((3, 128, 64)), torch.zeros((3, 2, 128, 64)),
                planes.transpose(2, 3)):
        with pytest.raises(ValueError, match="TF32 planes"):
            tsp._tf32_plane_views("x", bad)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_highest_ab_times_the_smoke_headline_and_edits_the_body():
    """``f64_ab --point highest`` packs the smoke's fp32 headline (#3 at p
    = 1 ``auto``, #4 at p = 4 ``pallas``, #12 at p = 4 ``auto``) and its
    cplaw (#6 at p = 1 ``auto``); its split copies put the TF32 consumers'
    products under ``TF32_NO_PRODUCTS`` and reuse ``x3_feed_split``'s
    producer edits; its ring copy (the other design, #3 and #4 alone)
    loads one fp32 tile a stage, splits it in three splitter warps, and
    passes the fp32 panels as both planes, so it takes the panels where
    this tree takes the planes; this tree's four entries all take the
    planes, and the smoke prints the previous body's time of each."""
    smoke = _smoke()
    gen, kw = f64_ab.HIGHEST_MATRICES["headline"]
    assert gen == "banded_random_csr"
    assert kw == dict(n=smoke.NROW, nnz_per_row=smoke.NNZ_PER_ROW,
                      bandwidth=smoke.BANDWIDTH, seed=smoke.SEED, dtype=np.float32)
    gen, kw = f64_ab.HIGHEST_MATRICES["cplaw"]
    assert gen == "powerlaw_community_csr" and kw == dict(smoke.CPLAW, dtype=np.float32)
    assert f64_ab.HIGHEST_CASES == {("headline", 1, "auto"): "crp_window_sg_f32",
                                    ("headline", smoke.MULTIRANK_P, "pallas"):
                                        "crp_window_f32",
                                    ("headline", smoke.MULTIRANK_P, "auto"): "crp_halo_f32",
                                    ("cplaw", 1, "auto"): "crp_ragged_f32"}
    assert {"headline highest", "headline p=4 highest", "headline p=4 fused highest",
            "cplaw highest"} <= set(smoke.PREVIOUS_MS)
    assert f64_ab.takes_planes(_build.CSRC, {}) == set(f64_ab.HIGHEST_CASES.values())
    assert f64_ab.HIGHEST_TOL == smoke.TOL_PLAIN_FRO
    header = (_build.CSRC / "x3_wgmma.cuh").read_text()
    text = f64_ab.edited(header, f64_ab.X3_EDITS + f64_ab.TF32_EDITS, "test")
    macros = {m for ms in f64_ab.HIGHEST_SPLITS.values() for m in ms}
    assert all(m in text and m not in header for m in macros)
    assert x3_feed_split.edited_header() != header
    assert set(f64_ab.RING_EDITS) == {"x3_wgmma.cuh", "window_sg.cu", "window.cu"}
    for name, edits in f64_ab.RING_EDITS.items():
        src = (_build.CSRC / name).read_text()
        new = f64_ab.edited(src, edits, "test")
        if name.endswith(".cu"):
            assert f64_ab.PLANES_ENTRY in src and f64_ab.PLANES_ENTRY not in new
        else:
            assert "tf32_split_stage" in new and "mbar_wait(ready0" in new
            assert "(MODE == WgMode::TF32X3 ? 96 : 0)" in new


def test_highest_ab_runner_passes_planes_or_panels():
    """``f64_ab.runner`` calls #3's and #4's fp32 entries with (ws, planes
    or the fp32 panels, b, c), #12's with (rows, ws, big, small or the fp32
    panels, c) and rows16, #6's with (group_ptr, starts, big, small or the
    fp32 panels, b, c), and the panels' G (all shards' for #12), TM, W and
    n; C in fp32."""
    class Fn:
        def __call__(self, *args):
            self.args = args
            return 0

    a = banded_random_csr(1200, nnz_per_row=7, bandwidth=60, seed=2, dtype=np.float32)
    one = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    rB = torch.zeros((4096, 24))
    _, shards, max_m = _shards(2, np.float32)
    packs = {"crp_window_sg_f32": td.pack_local_kernel(one, a.nrow, np.float32, "pallas",
                                                       device=CPU, mxu_precision="highest"),
             "crp_window_f32": td._pack_window(shards, max_m, np.float32, "highest", CPU)}
    for name, (arrays, op) in packs.items():
        args = op.kernel_args(tuple(x[0] for x in arrays), rB)
        planes = args[1]
        fp32 = tsp.tf32_panels(planes)
        for given in (None, fp32):
            fn = Fn()
            c = f64_ab.runner(fn, op, args, 7, given)()
            _, nptr, scalars = _build._ENTRIES[name]
            assert len(fn.args) == nptr + len(scalars) + 1 and fn.args[-1] == 7
            assert fn.args[1] == (planes if given is None else fp32).data_ptr()
            assert fn.args[nptr:nptr + 4] == (*fp32.shape, 24)
            assert c.dtype == torch.float32 and c.shape == (fp32.shape[0] * fp32.shape[1], 24)
    from tests.tf32x3_emulation import _ragged_pack

    _, _, aligned, h_shards = _halo_case(2)
    h_arrays, h_op = th.build_halo_plan(h_shards, aligned, device=CPU, dtype=np.float32)
    bs = torch.zeros((2, h_op.min_b_rows, 24))
    _, _, r_arrays, r_op = _ragged_pack(256, 128)
    cases = {"crp_halo_f32": (h_op, h_op.kernel_args(h_arrays, bs)),
             "crp_ragged_f32": (r_op, r_op.kernel_args(tuple(x[0] for x in r_arrays),
                                                       torch.zeros((r_op.min_b_rows, 24))))}
    for name, (op, args) in cases.items():
        big, small = f64_ab.planes_of(args)
        fp32 = tsp.tf32_panels((big, small))
        _, nptr, scalars = _build._ENTRIES[name]
        for given, ptrs in ((None, (big, small)), (fp32, (fp32,))):
            fn = Fn()
            c = f64_ab.runner(fn, op, args, 7, given)()
            assert fn.args[-1] == 7 and c.dtype == torch.float32
            n_ptr = nptr - (given is not None)  # the fp32 panels: one pointer
            assert len(fn.args) == n_ptr + len(scalars) + 1
            k = 2  # after (rows, ws) or (group_ptr, starts)
            assert fn.args[k:k + len(ptrs)] == tuple(t.data_ptr() for t in ptrs)
            G = big.shape[0] * big.shape[1] if name == "crp_halo_f32" else args[1].shape[0] - 1
            assert fn.args[n_ptr:n_ptr + 4] == (G, *big.shape[-2:], 24)


def test_tf32_mode_serves_3_and_4_and_mma_sync_6_and_12():
    """The ``wgmma`` body's TF32 mode serves all four fp32 ``highest``
    entries: #3's and #4's (one instantiation) on the planes, the small one
    G*TM*W floats past the big one; #12's (the chunked walk, and with the
    flags across processes) and #6's (the ragged walk) on the two planes
    apart; every library with a TF32 entry reports its TF32 kernels, and
    no ``mma.sync`` 3xTF32 body (``panel_tf32x3_kernel``,
    ``launch_tf32x3``) is left anywhere under ``csrc/``."""
    def body(src, name):
        m = re.search(rf"\nint {name}\(.*?\n\{{\n(.*?)\n\}}\n", src, re.S)
        assert m is not None, name
        return " ".join(m.group(1).split())

    for stem, name in (("window_sg", "crp_window_sg_f32"), ("window", "crp_window_f32")):
        src = (_build.CSRC / f"{stem}.cu").read_text()
        assert ("launch_wgmma<crp::WgMode::TF32X3>(ws, big, big + G * TM * W, b, nullptr, c"
                in body(src, name))
        assert ", false, true>(out, len)" in src  # x3_layout with the TF32 ring
    halo = (_build.CSRC / "halo.cu").read_text()
    assert ("launch_wgmma<crp::WgMode::TF32X3, true>(ws, big, small, rows, nullptr, c,"
            in body(halo, "crp_halo_f32"))
    assert ("launch_wgmma<crp::WgMode::TF32X3, true, false, true>( ws, big, small, rows,"
            in body(halo, "crp_halo_f32_flags"))
    assert "x3_layout<false, true, false, true>(out, len)" in halo
    ragged = (_build.CSRC / "ragged.cu").read_text()
    assert ("launch_wgmma<crp::WgMode::TF32X3, false, true>( starts, big, small, b, nullptr,"
            in body(ragged, "crp_ragged_f32"))
    assert "x3_layout<false, false, true, true>(out, len)" in ragged
    for src in _build.CSRC.iterdir():
        text = src.read_text()
        for gone in ("panel_tf32x3_kernel", "launch_tf32x3", "tf32x3_layout",
                     "mma.sync.aligned.m16n8k8.row.col.f32.tf32"):
            assert gone not in text, (src.name, gone)
    header = (_build.CSRC / "x3_wgmma.cuh").read_text()
    assert "enum class WgMode { SPLIT_B, PAIR_B, ONE_PASS, TF32X3 };" in header
    assert "Ring::TF32 && (CHUNKED || RAGGED)" not in header
    assert not hasattr(_build, "tf32x3_layout")
    assert [_build._ENTRIES[e][1] for e in ("crp_halo_f32", "crp_halo_f32_flags",
                                            "crp_ragged_f32")] == [5, 6, 6]
