"""The fp64 entries of #3, #4, #6 and #12 on #11's DMMA body
(``kernels/csrc/dd_tc.cu``) on the CPU: what can be checked without a card.

The kernels run only on the card (``tests/test_torch_cuda.py``, ``-k
f64``).  Here every fp64 pack that the dispatch builds for them is held to
the tile the body declares (its ``constexpr``s, read from the source), the
five fp64 entries to the one kernel template, their products to the FP64
tensor cores' peak, the windowed pack re-expressed as a ragged pack (as
the body walks it) to JAX's windowed kernel in interpret mode, the walk
with B through the chunk table (as the producers copy it) to JAX's halo
kernel in interpret mode, and the tools that time and compare the body to
what they read.
"""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from crp_tpu_torch.kernels import _build, points, spmm_pallas, spmm_ragged
from crp_tpu_torch.kernels.dispatch import (
    _pack_dd_mxu, _pack_ragged, _pack_window, pack_local_kernel,
)
from crp_tpu_torch.kernels.spmm_halo import (
    align_displs, build_halo_plan, stacked_chunk_rows,
)
from crp_tpu_torch.plan.partition1d import csr_row_partition
from crp_tpu_torch.sparse.csr import CSRMatrix
from crp_tpu_torch.sparse.synth import (
    banded_random_csr, fill_b, powerlaw_community_csr,
)

CPU = torch.device("cpu")
REPO = pathlib.Path(__file__).resolve().parent.parent
# entry -> the dd_entry<...> it launches: the ragged walk, the windowed
# walk, with B through the chunk table, and with the flags' waits
F64_ENTRIES = {"crp_ragged_dd_f64tc": "false", "crp_ragged_f64": "false",
               "crp_window_sg_f64": "true", "crp_window_f64": "true",
               "crp_halo_f64": "true, true", "crp_halo_f64_flags": "true, true, true"}


def _source(stem: str) -> str:
    return (_build.CSRC / f"{stem}.cu").read_text()


def _constexpr(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _source("dd_tc")).group(1))


# the block rows and the k slice dd_tc.cu declares: its entries refuse a TM
# or a W that they do not divide
BM, BK = _constexpr("DD_BM"), _constexpr("DD_BK")
# the (TM, Wc) grid of the ragged geometry chooser (spmm_ragged.py
# choose_ragged_geometry), and its candidates on the CPU (Wc <= 256)
GRID = [(tm, wc) for tm in (128, 256, 512) for wc in (128, 256, 512)]
SMALL_GRID = [(tm, wc) for tm, wc in GRID if wc <= 256]


def _fits(TM: int, W: int) -> bool:
    return TM % BM == 0 and W % BK == 0


def _shards(a, p):
    """``a`` cut into p row shards of (rowptr, colidx, val)."""
    d = csr_row_partition(a.rowptr, p)
    out = []
    for i in range(p):
        s = a.row_slice(int(d[i]), int(d[i + 1]))
        out.append((s.rowptr, s.colidx.astype(np.int32), s.val))
    return out, int(np.diff(d).max())


def test_body_declares_a_tile_every_pack_geometry_fits():
    """The body's block rows and k slice divide every TM and Wc of the
    ragged geometry grid (and so the CPU's), and the uniform pack's TM
    (256) and window unit (TK = 128)."""
    assert (BM, BK) == (128, 32)
    assert all(_fits(tm, wc) for tm, wc in GRID)
    assert _fits(256, spmm_pallas.TK)


@pytest.mark.parametrize("bandwidth", [20, 100, 200])
def test_uniform_f64_pack_fits_the_tile(bandwidth):
    """fp64 ``kernel="pallas"`` on one shard with monotone windows takes
    the super-grouped uniform pack (#3): its TM and W fit the body's tile,
    its panels are contiguous fp64 of (G, TM, W) with one window start a
    group."""
    a = banded_random_csr(2500, nnz_per_row=9, bandwidth=bandwidth, seed=3)
    arrays, op = pack_local_kernel([(a.rowptr, a.colidx.astype(np.int32), a.val)],
                                   a.nrow + 300, np.float64, "pallas", device=CPU)
    assert (op.variant, op.scheme) == ("uniform", "full")
    ws, tiles, rB = op.kernel_args(tuple(x[0] for x in arrays), None)
    G, TM, W = tiles.shape
    assert _fits(TM, W) and tiles.dtype == torch.float64 and tiles.is_contiguous()
    assert ws.shape == (G,) and int(ws.max()) + W <= op.min_b_rows


@pytest.mark.parametrize("p", [1, 2, 3, 4])
@pytest.mark.parametrize("geometry", GRID)
def test_ragged_f64_pack_fits_the_tile(geometry, p):
    """The fp64 ragged pack (#6) at every (TM, Wc) of the chooser's grid,
    on one shard and on 2-4 shards (one of them empty at p = 3): its TM
    and Wc fit the body's tile, and every shard's group ranges lie within
    its S chunks."""
    a = powerlaw_community_csr(6000, 12, 512, seed=5)
    shards, max_m = _shards(a, p)
    if p == 3:
        nrow = len(shards[1][0]) - 1
        shards[1] = (np.zeros(nrow + 1, np.int64), np.zeros(0, np.int32), np.zeros(0))
    arrays, op = _pack_ragged(shards, max_m + 100, np.float64, "highest", CPU,
                              geometry=geometry)
    rl = op.roofline
    assert (rl["TM"], rl["W"]) == geometry and _fits(*geometry)
    for i in range(p):
        _, group_ptr, _, panels, _ = op.kernel_args(tuple(x[i] for x in arrays), None)
        assert panels.shape == (rl["S"], *geometry) and panels.dtype == torch.float64
        assert group_ptr.shape == (rl["G"] + 1,)
        assert bool((group_ptr[1:] >= group_ptr[:-1]).all()) and int(group_ptr[-1]) <= rl["S"]


@pytest.mark.parametrize("small", [True, False])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_dispatched_ragged_f64_geometry_fits_the_tile(small, p):
    """The geometry the chooser resolves (on the CPU's ``small`` grid and
    on the card's) lies in its grid, so the pack ``kernel="pallas"`` and
    ``"ragged"`` build in fp64 over p shards fits the body's tile."""
    from crp_tpu_torch.kernels.spmm_ragged import resolve_ragged_geometry

    a = powerlaw_community_csr(6000, 12, 512, seed=6)
    shards, max_m = _shards(a, p)
    big = max(shards, key=lambda s: int(s[0][-1]) - int(s[0][0]))
    geometry = resolve_ragged_geometry(big[0], big[1], "highest", small=small)
    assert geometry in (SMALL_GRID if small else GRID) and _fits(*geometry)
    if small:  # the CPU's own pack
        _, op = pack_local_kernel(shards, max_m, np.float64, "ragged", device=CPU)
        assert (op.roofline["TM"], op.roofline["W"]) == geometry


def test_f64_ops_priced_by_the_body_that_runs_them():
    """``op_point`` prices the fp64 products of #3, #4, #6, #11 and #12
    (every one on the DMMA body) at the FP64 tensor cores' peak, and fp32
    as before; the projection prices fp64 on the tensor cores at one card
    (#3 or #6) and over several (#12)."""
    from crp_tpu_torch.plan.project import project_exec_1d

    a = banded_random_csr(2000, nnz_per_row=9, bandwidth=120, seed=4)
    one = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    two, max_m = _shards(a, 2)
    ops = {
        "#3": pack_local_kernel(one, a.nrow, np.float64, "pallas", device=CPU)[1],
        "#6": _pack_ragged(one, a.nrow, np.float64, "highest", CPU,
                           geometry=(128, 256))[1],
        "#11": _pack_dd_mxu(one, a.nrow, CPU)[1],
        "#4": _pack_window(two, max_m, np.float64, "highest", CPU)[1],
    }
    d = csr_row_partition(a.rowptr, 2)
    halo = [a.row_slice(int(d[i]), int(d[i + 1])) for i in range(2)]
    ops["#12"] = build_halo_plan(halo, align_displs(d, a.ncol), device=CPU,
                                 dtype=np.float64)[1]
    assert [ops[k].variant for k in ops] == ["uniform", "ragged", "dd_mxu", "window", "halo"]
    for k, op in ops.items():
        assert points.op_point(op, torch.float64) == (1, "fp64_tc"), k
        assert points.op_point(op, np.dtype(np.float64)) == (1, "fp64_tc"), k
    assert points.op_point(ops["#3"], torch.float32) == (3, "tf32")
    assert points.op_point(ops["#4"], torch.float32) == (3, "tf32")
    assert points.precision_point("highest", np.float64) == (1, "fp64")
    for p in (1, 2, 4):
        got = project_exec_1d(a, 64, p, mxu_prec="highest", dtype=np.float64)
        assert (got["passes"], got["peak"]) == (1, "fp64_tc"), p


def test_three_fp64_entries_instantiate_one_kernel():
    """All five fp64 entries, #11, #6, #3, #4 and #12 (one card and across
    processes), are entries of ``dd_tc.cu``, each launching the one DMMA
    template through ``dd_entry`` (the ragged walk; the windowed one for #3
    and #4; with B through the chunk table for #12, and the flags' waits
    across processes); no other source keeps an fp64 entry, and nothing in
    ``csrc/`` is left of the FMA tile body."""
    body = _source("dd_tc")
    assert re.findall(r"__global__[^;{]*?\n(\w+)\(", body) == ["ragged_dd_kernel"]
    assert len(re.findall(r"^template <bool B_VEC, bool WINDOW, bool CHUNKED = false, "
                          r"bool FLAGS = false>\n__global__", body, re.M)) == 1
    walk = {}
    for name in F64_ENTRIES:
        assert _build._ENTRIES[name][0] == "dd_tc"
        m = re.search(rf"\nint {name}\(.*?\n\{{\n(.*?)\n\}}\n", body, re.S)
        assert m is not None, name
        calls = re.findall(r"dd_entry<([a-z, ]+)>\(", m.group(1))
        assert len(calls) == 1, name
        walk[name] = calls[0]
    assert walk == F64_ENTRIES
    for stem in ("ragged", "window_sg", "window", "halo"):
        assert "_f64(" not in _source(stem), stem
    for path in _build.CSRC.iterdir():
        text = path.read_text()
        for gone in ("panel_fma_kernel", "launch_fma", "fma_rn"):
            assert gone not in text, (path.name, gone)
    # the windowed entries pass no group_ptr: the windowed walk never reads it
    assert body.count("dd_entry<true>(nullptr, ws, tiles, b, c") == 2
    assert "dd_entry<true, true>(nullptr, ws, tiles, rows, c" in body


@pytest.mark.parametrize("n", [16, 37])
def test_window_pack_as_ragged_matches_jax_window_kernel(n):
    """The uniform fp64 pack written as the ragged pack that the windowed
    walk amounts to (one chunk a group: group_ptr = arange(G + 1), starts
    = ws) gives JAX's super-grouped kernel's C (interpret mode) on the
    JAX pack's own panels, within 1e-12, and pad groups zero."""
    from crp_tpu.kernels.dispatch import pack_local_kernel as jax_pack
    from crp_tpu_torch.utils.norms import rel_fro_err

    a = banded_random_csr(1500, nnz_per_row=7, bandwidth=80, seed=12)
    arrays, fn = jax_pack([(a.rowptr, a.colidx.astype(np.int32), a.val)], a.nrow + 300,
                          np.float64, "pallas", mxu_precision="highest")
    ws, tiles = (torch.from_numpy(np.asarray(x[0])) for x in arrays[:2])
    b = np.zeros((fn.min_b_rows, n))
    b[: a.ncol] = fill_b(0, a.ncol, 0, n)
    c_jax = np.asarray(fn(tuple(x[0] for x in arrays), b))
    G = ws.shape[0]
    seq = torch.arange(G + 1, dtype=torch.int32)
    c = spmm_ragged.spmm_ragged(seq[:-1], seq, ws, tiles, torch.from_numpy(b),
                                min_b_rows=fn.min_b_rows).numpy()
    assert c.shape == c_jax.shape
    assert rel_fro_err(c_jax, c) <= 1e-12
    assert not np.any(c[a.nrow:])
    c3 = spmm_pallas.spmm_window_sg(ws, tiles, torch.from_numpy(b), min_b_rows=fn.min_b_rows)
    assert rel_fro_err(c_jax, c3.numpy()) <= 1e-12


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_f64_ab_times_the_smoke_matrices_and_passes_the_entries_args():
    """``cli/f64_ab.py`` packs the smoke's three fp64 matrices (the
    headline also at p = 4), and calls each entry with the pointers and
    scalars ``_build`` declares for it: (ws, tiles, b, c) for #3 and #4,
    (group_ptr, starts, panels, b, c) for #6, then G, TM, W, n and the
    stream; (rows, ws, panels, c) for #12, the chunk table's row pointers
    made from the stacked B, then the shards' G, TM, W, n, rows16 and the
    stream; its split copies edit the body."""
    from crp_tpu_torch.cli import f64_ab

    smoke = _smoke()
    want = {"fp64 banded": dict(n=smoke.NROW, nnz_per_row=smoke.NNZ_PER_ROW,
                                bandwidth=smoke.DD_BAND),
            "fp64 cplaw": smoke.CPLAW,
            "fp64 headline": dict(n=smoke.NROW, nnz_per_row=smoke.NNZ_PER_ROW,
                                  bandwidth=smoke.BANDWIDTH, seed=smoke.SEED)}
    assert {k: v[1] for k, v in f64_ab.MATRICES.items()} == want
    assert f64_ab.N == smoke.N
    assert set(smoke.PREVIOUS_MS) >= set(f64_ab.MATRICES)
    assert {m for m, _, _ in f64_ab.CASES} == set(f64_ab.MATRICES)
    assert {(p, e) for (_, p, _), e in f64_ab.CASES.items() if p > 1} == {
        (smoke.MULTIRANK_P, "crp_window_f64"), (smoke.MULTIRANK_P, "crp_halo_f64")}
    assert all(e in F64_ENTRIES for e in f64_ab.CASES.values())

    class Fn:
        def __call__(self, *args):
            self.args = args
            return 0

    a = banded_random_csr(1200, nnz_per_row=7, bandwidth=60, seed=2)
    one = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    rB = torch.zeros((4096, 24), dtype=torch.float64)
    packs = {"crp_window_sg_f64": pack_local_kernel(one, a.nrow, np.float64, "pallas",
                                                    device=CPU),
             "crp_ragged_f64": _pack_ragged(one, a.nrow, np.float64, "highest", CPU,
                                            geometry=(256, 128))}
    two, max_m = _shards(a, 2)
    packs["crp_window_f64"] = _pack_window(two, max_m, np.float64, "highest", CPU)
    for name, (arrays, op) in packs.items():
        args = op.kernel_args(tuple(x[0] for x in arrays), rB)
        fn = Fn()
        c = f64_ab.runner(fn, op, args, 7)()
        _, nptr, scalars = _build._ENTRIES[name]
        assert len(fn.args) == nptr + len(scalars) + 1 and fn.args[-1] == 7
        panels = args[1] if op.variant == "window" else args[-2]
        G = args[1].shape[0] - 1 if name == "crp_ragged_f64" else panels.shape[0]
        assert fn.args[nptr:nptr + 4] == (G, *panels.shape[1:], 24)
        assert fn.args[nptr - 1] == c.data_ptr() and c.shape == (G * panels.shape[1], 24)
        assert fn.args[nptr - 2] == rB.data_ptr()
        assert fn.args[nptr - 3] == panels.data_ptr()
    # #12: the fused plan over both shards, on the stacked B
    d = csr_row_partition(a.rowptr, 2)
    halo = [a.row_slice(int(d[i]), int(d[i + 1])) for i in range(2)]
    arrays, op = build_halo_plan(halo, align_displs(d, a.ncol), device=CPU,
                                 dtype=np.float64)
    bs = torch.zeros((2, op.min_b_rows, 24), dtype=torch.float64)
    args = op.kernel_args(arrays, bs)
    fn = Fn()
    run = f64_ab.runner(fn, op, args, 7)
    c = run()
    _, nptr, scalars = _build._ENTRIES["crp_halo_f64"]
    assert len(fn.args) == nptr + len(scalars) + 1 and fn.args[-1] == 7
    ws, _, panels = args[:3]
    rows, rows16 = stacked_chunk_rows(args[4], bs)
    assert torch.equal(run.inputs[0], rows) and fn.args[0] == run.inputs[0].data_ptr()
    assert fn.args[1:nptr] == (ws.data_ptr(), panels.data_ptr(), c.data_ptr())
    assert c.shape == (2, op.G * op.TM, 24)
    assert fn.args[nptr:] == (2 * op.G, op.TM, op.W, 24, int(rows16), 7)
    body = _source("dd_tc")
    for variant, edits in f64_ab.SPLITS.items():
        assert f64_ab.edited(body, edits, "test") != body, variant


def test_sass_diff_finds_kernels_that_moved_between_sources(monkeypatch, capsys):
    """``scripts/csrc_sass_diff.py`` finds an old kernel whose body now
    lives in another source (an instantiation that ``window_sg.cu`` no
    longer builds but ``window.cu`` still does) and passes, and fails on a
    body that changed."""
    spec = importlib.util.spec_from_file_location("csrc_sass_diff",
                                                  REPO / "scripts" / "csrc_sass_diff.py")
    diff = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(diff)
    trees = {
        ("window_sg", "old"): {"k3_f32": ("A",), "fma_f64": ("F",)},
        ("window", "old"): {"k4_f64": ("F",)},
        ("dd_tc", "old"): {"dd<true>": ("D",)},
        ("window_sg", "new"): {"k3_f32": ("A",)},
        ("window", "new"): {"k4_f64": ("F",)},
        ("dd_tc", "new"): {"dd<true,false>": ("D",), "dd<true,true>": ("W",)},
    }
    def cubin(src, out):  # the tree and the source, for sass() to read
        out.write_text(f"{src.parent.name} {src.stem}")
        return ""

    def sass(path):
        tree, stem = path.read_text().split()
        return trees[stem, tree]

    monkeypatch.setattr(diff, "cubin", cubin)
    monkeypatch.setattr(diff, "sass", sass)
    monkeypatch.setattr(diff, "demangle", lambda names: {k: k for k in names})
    old, new = REPO / "old", REPO / "new"
    assert diff.main([str(old), str(new), "window_sg", "window", "dd_tc"]) == 0
    out = capsys.readouterr().out
    assert "identical     1 instructions  fma_f64 (now in window)" in out
    assert "new kernel     1 instructions  dd<true,true>" in out
    trees["dd_tc", "new"]["dd<true,false>"] = ("D2",)
    assert diff.main([str(old), str(new), "window_sg", "window", "dd_tc"]) == 1
    assert "DIFFERS" in capsys.readouterr().out


@pytest.mark.parametrize("p", [2, 3, 4])
def test_multishard_f64_packs_fit_the_tile(p):
    """The fp64 packs of #4 (``_pack_window``, one shard empty at p = 3)
    and #12 (``build_halo_plan``) over p shards, pad groups included: one
    contiguous (p, G, TM, W) fp64 panel tensor whose TM and W fit the
    body's tile (W a multiple of the 128-row window unit, so also of the k
    slice), each shard's panels starting on 16 bytes, and #12's window
    starts on the chunk table's 128-row chunks."""
    a = banded_random_csr(3000, nnz_per_row=7, bandwidth=150, seed=20 + p)
    shards, max_m = _shards(a, p)
    if p == 3:
        nrow = len(shards[1][0]) - 1
        shards[1] = (np.zeros(nrow + 1, np.int64), np.zeros(0, np.int32), np.zeros(0))
    arrays, op = _pack_window(shards, max_m, np.float64, "highest", CPU)
    d = csr_row_partition(a.rowptr, p)
    halo = [a.row_slice(int(d[i]), int(d[i + 1])) for i in range(p)]
    h_arrays, h_op = build_halo_plan(halo, align_displs(d, a.ncol), device=CPU,
                                     dtype=np.float64)
    for label, panels, ws in (("#4", arrays[1], arrays[0]), ("#12", h_arrays[2], h_arrays[0])):
        assert panels.dtype == torch.float64 and panels.is_contiguous(), label
        s_, G, TM, W = panels.shape
        assert s_ == p and _fits(TM, W) and W % spmm_pallas.TK == 0, (label, TM, W)
        assert G * TM >= int(np.diff(d).max()), label  # every shard's rows, then pad groups
        assert all(panels[i].data_ptr() % 16 == 0 for i in range(p)), label
    assert bool((h_arrays[0] % 128 == 0).all()) and (op.variant, h_op.variant) == (
        "window", "halo")


def _chunked_walk(ws, panels, chunk_src, owners, n):
    """C of the DMMA body's windowed walk with B through the chunk table,
    as its producers copy B: slice k0 of group g's window (BK rows from
    global row r = ws[g] + k0) is the rows from r % 128 on of those that
    chunk r // 128 of the table points at, owner ``owners[o]`` row ``row``,
    or zeros past the matrix (owner -1); each C element sums the slices k
    upward."""
    G, TM, W = panels.shape
    c = torch.zeros((G * TM, n), dtype=torch.float64)
    for g in range(G):
        for k0 in range(0, W, BK):
            r = int(ws[g]) + k0
            owner, row = (int(x) for x in chunk_src[r // 128])
            if owner >= 0:
                lo = row + r % 128
                c[g * TM:(g + 1) * TM] += panels[g, :, k0:k0 + BK] @ owners[owner][lo:lo + BK]
    return c


@pytest.mark.parametrize("p", [2, 4])
def test_chunked_walk_matches_jax_halo_kernel(devices8, p):
    """The windowed walk re-expressed as the chunked one: on an identity
    chunk table (chunk c at row 128 c of one B) it gives the windowed
    product's C (``spmm_window_plain``) within 1e-12; on the fused plan's
    table over the engine's stacked B shards it gives JAX's fused kernel
    (``_halo_kernel``, interpret mode on the CPU mesh) within 1e-12, shard
    by shard, pad rows zero."""
    from tests.test_torch_halo import _jax_rowpara
    from crp_tpu_torch.config import SpmmConfig
    from crp_tpu_torch.engine.rowpara import RowParaSpmm
    from crp_tpu_torch.utils.norms import rel_fro_err

    a = banded_random_csr(1500, nnz_per_row=7, bandwidth=90, seed=40 + p)
    n = 24
    b = fill_b(0, a.ncol, 0, n)
    eng = RowParaSpmm(a, *[csr_row_partition(a.rowptr, p)] * 2, n, device="cpu",
                      dtype=np.float64, config=SpmmConfig(kernel="pallas_halo"))
    op = eng._local_op
    ws, _, panels, _, chunk_src = eng.packed
    bs = eng.shard_b(b)

    # identity table: one owner holding all of B
    rows = int((ws.max() + op.W + 127) // 128 * 128)
    whole = torch.zeros((rows, n), dtype=torch.float64)
    whole[: a.ncol] = torch.from_numpy(np.asarray(b))
    chunks = torch.arange(rows // 128, dtype=torch.int64) * 128
    ident = torch.stack([torch.where(chunks < a.ncol, 0, -1), chunks], 1)
    for i in range(p):
        got = _chunked_walk(ws[i], panels[i], ident, [whole], n)
        want = spmm_pallas.spmm_window_plain(ws[i], panels[i], whole, "highest")
        assert rel_fro_err(want.numpy(), got.numpy()) <= 1e-12, i

    displs, j = _jax_rowpara(a, p, n, np.float64, "highest", devices8)
    assert j.kernel_kind == "pallas_halo"
    c_jax = np.asarray(j.exec(np.asarray(b)))
    got = []
    for i in range(p):
        c = _chunked_walk(ws[i], panels[i], chunk_src, list(bs), n)
        m = int(displs[i + 1] - displs[i])
        assert not bool(torch.any(c[m:])), i
        got.append(c[:m].numpy())
    assert rel_fro_err(c_jax, np.concatenate(got)) <= 1e-12
