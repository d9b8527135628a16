"""The fp64 entries of #3 and #6 on #11's DMMA body (``kernels/csrc/
dd_tc.cu``) on the CPU: what can be checked without a card.

The kernels run only on the card (``tests/test_torch_cuda.py``, ``-k
f64``).  Here every fp64 pack that the dispatch builds for them is held to
the tile the body declares (its ``constexpr``s, read from the source), the
three fp64 entries to the one kernel template, their products to the FP64
tensor cores' peak, the windowed pack re-expressed as a ragged pack (as
the body walks it) to JAX's windowed kernel in interpret mode, and the
tools that time and compare the body to what they read.
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
from crp_tpu_torch.kernels.spmm_halo import align_displs, build_halo_plan
from crp_tpu_torch.plan.partition1d import csr_row_partition
from crp_tpu_torch.sparse.csr import CSRMatrix
from crp_tpu_torch.sparse.synth import (
    banded_random_csr, fill_b, powerlaw_community_csr,
)

CPU = torch.device("cpu")
REPO = pathlib.Path(__file__).resolve().parent.parent
F64_ENTRIES = ("crp_ragged_dd_f64tc", "crp_ragged_f64", "crp_window_sg_f64")


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
    """``op_point`` prices #3's and #6's fp64 products (and #11's) at the
    FP64 tensor cores' peak, #4's and #12's (still the FMA body) at the FMA
    units', and fp32 as before; the projection prices fp64 at one card
    (#3 or #6) on the tensor cores and over several (#12) on the FMA
    units."""
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
    want = {"#3": "fp64_tc", "#6": "fp64_tc", "#11": "fp64_tc", "#4": "fp64", "#12": "fp64"}
    for k, op in ops.items():
        assert points.op_point(op, torch.float64) == (1, want[k]), k
        assert points.op_point(op, np.dtype(np.float64)) == (1, want[k]), k
    assert points.op_point(ops["#3"], torch.float32) == (3, "tf32")
    assert points.precision_point("highest", np.float64) == (1, "fp64")
    for p, peak in ((1, "fp64_tc"), (2, "fp64")):
        got = project_exec_1d(a, 64, p, mxu_prec="highest", dtype=np.float64)
        assert (got["passes"], got["peak"]) == (1, peak)


def test_three_fp64_entries_instantiate_one_kernel():
    """#11, #6 on fp64 and #3 on fp64 are entries of ``dd_tc.cu``, each
    launching the one DMMA template (the ragged walk, or the windowed one
    for #3) through ``dd_entry``; ``ragged.cu`` and ``window_sg.cu`` keep
    no fp64 entry, and only #4's and #12's sources still launch the FMA
    tile body."""
    body = _source("dd_tc")
    assert re.findall(r"__global__[^;{]*?\n(\w+)\(", body) == ["ragged_dd_kernel"]
    assert len(re.findall(r"^template <bool B_VEC, bool WINDOW>\n__global__", body,
                          re.M)) == 1
    walk = {}
    for name in F64_ENTRIES:
        assert _build._ENTRIES[name][0] == "dd_tc"
        m = re.search(rf"\nint {name}\(.*?\n\{{\n(.*?)\n\}}\n", body, re.S)
        assert m is not None, name
        calls = re.findall(r"dd_entry<(true|false)>\(", m.group(1))
        assert len(calls) == 1, name
        walk[name] = calls[0]
    assert walk == {"crp_ragged_dd_f64tc": "false", "crp_ragged_f64": "false",
                    "crp_window_sg_f64": "true"}
    for stem in ("ragged", "window_sg"):
        text = _source(stem)
        assert "_f64(" not in text and "launch_fma" not in text, stem
    for stem in ("window", "halo"):
        assert "launch_fma<double" in _source(stem), stem
    # the window entry passes no group_ptr: the windowed walk never reads it
    assert "dd_entry<true>(nullptr, ws, tiles" in body


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
    """``cli/f64_ab.py`` packs the smoke's three fp64 matrices, and calls
    each entry with the pointers and scalars ``_build`` declares for it:
    (ws, tiles, b, c) for #3, (group_ptr, starts, panels, b, c) for #6,
    then G, TM, W, n and the stream; its split copies edit the body."""
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
    for name, (arrays, op) in packs.items():
        args = op.kernel_args(tuple(x[0] for x in arrays), rB)
        fn = Fn()
        c = f64_ab.runner(fn, op, args, 7)()
        _, nptr, scalars = _build._ENTRIES[name]
        assert len(fn.args) == nptr + len(scalars) + 1 and fn.args[-1] == 7
        panels = args[-2]
        G = panels.shape[0] if name == "crp_window_sg_f64" else args[1].shape[0] - 1
        assert fn.args[nptr:nptr + 4] == (G, *panels.shape[1:], 24)
        assert fn.args[nptr - 1] == c.data_ptr() and c.shape == (G * panels.shape[1], 24)
        assert fn.args[nptr - 2] == rB.data_ptr()
        assert fn.args[nptr - 3] == panels.data_ptr()
    body = _source("dd_tc")
    for variant, edits in f64_ab.SPLITS.items():
        assert f64_ab.edited(body, edits, "test") != body, variant


def test_sass_diff_finds_kernels_that_moved_between_sources(monkeypatch, capsys):
    """``scripts/csrc_sass_diff.py`` finds an old kernel whose body now
    lives in another source (the FMA body's fp64 instantiation, no longer
    built by ``window_sg.cu`` but still by ``window.cu``) and passes, and
    fails on a body that changed."""
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
