"""The port's on-device densify and RNE bf16 split give the JAX packs bit
for bit: ws, panels, bases, min_b_rows and roofline (#3's and #4's fp32
packs at ``highest`` hold the TF32 planes of JAX's panels, from which the
panels come back bit for bit, at twice their bytes)."""

import numpy as np
import pytest
import torch

from crp_tpu.kernels import dispatch as jd
from crp_tpu.kernels.spmm_pallas import np_split_bf16
from crp_tpu.sparse.csr import CSRMatrix
from crp_tpu.sparse.synth import banded_random_csr

from crp_tpu_torch.kernels import device_pack
from crp_tpu_torch.kernels import dispatch as td
from crp_tpu_torch.kernels.spmm_pallas import UnsupportedSparsity, tf32_panels

CORPUS = [(3000, 7, 80, 91), (2500, 6, 60, 92), (1000, 5, 300, 3), (700, 9, 20, 4)]


def _bits(x):
    """Comparable numpy view: bf16 as uint16 bits, everything else as is."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _jax_pack(shard, max_m, dtype, prec):
    """The JAX pallas pack on the CPU: for x3/default the direct-bf16 pack
    (native) when it takes the shard, else the generic path it falls back
    to with identical results."""
    if np.dtype(dtype) == np.float32 and prec in ("x3", "default"):
        got = jd._pack_uniform_single_bf16(shard[0], max_m, prec)
        if got is not None:
            return got
    return jd.pack_local_kernel(shard, max_m, dtype, "pallas", mxu_precision=prec)


def _assert_same_pack(shard, max_m, dtype, prec):
    j_arrays, j_fn = _jax_pack(shard, max_m, dtype, prec)
    t_arrays, op = td.pack_local_kernel(shard, max_m, dtype, "pallas",
                                        device="cpu", mxu_precision=prec)
    assert len(t_arrays) == len(j_arrays)
    planes = op.scheme in ("tf32", "window_tf32")  # (p, 2, G, TM, W): back to the panels
    for i, (t, j) in enumerate(zip(t_arrays, j_arrays)):
        if planes and i == 1:
            t = tf32_panels(t.transpose(0, 1))
        tb, jb = _bits(t), _bits(j)
        assert tb.dtype == jb.dtype and tb.shape == jb.shape
        np.testing.assert_array_equal(tb.view(np.uint8), jb.view(np.uint8))
    assert op.min_b_rows == j_fn.min_b_rows
    want = dict(j_fn.roofline)
    if planes:
        want.update(a_bytes=2 * want["a_bytes"])
    assert op.roofline == want
    return t_arrays, op


@pytest.mark.parametrize("spec", CORPUS)
@pytest.mark.parametrize("prec", ["x3", "default"])
@pytest.mark.parametrize("extra_rows", [0, 700])
def test_bf16_pack_matches_jax(spec, prec, extra_rows):
    nrow, k, bw, seed = spec
    a = banded_random_csr(nrow, nnz_per_row=k, bandwidth=bw, seed=seed,
                          dtype=np.float32)
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    _, op = _assert_same_pack(shard, a.nrow + extra_rows, np.float32, prec)
    assert op.scheme == ("x3" if prec == "x3" else "bf16")


@pytest.mark.parametrize("spec", CORPUS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_full_pack_matches_jax(spec, dtype):
    nrow, k, bw, seed = spec
    a = banded_random_csr(nrow, nnz_per_row=k, bandwidth=bw, seed=seed,
                          dtype=dtype)
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    j_arrays, _ = jd.pack_local_kernel(shard, a.nrow + 300, dtype, "pallas")
    _, op = _assert_same_pack(shard, a.nrow + 300, dtype, "highest")
    # no super-group plan (8-byte windows over the CPU's 4 MB budget): both
    # packages pack (ws, tiles) for the non-super-grouped kernel #4; on fp32
    # the port's holds the TF32 planes
    if dtype == np.float32:
        assert op.scheme == ("window_tf32" if len(j_arrays) == 2 else "tf32")
    else:
        assert op.scheme == ("window" if len(j_arrays) == 2 else "full")


def _with_duplicates(seed=12):
    """Banded CSR with every 5th nonzero repeated (sorted, adjacent)."""
    a = banded_random_csr(1500, nnz_per_row=6, bandwidth=50, seed=seed,
                          dtype=np.float32)
    rows = np.repeat(np.arange(a.nrow), np.diff(a.rowptr))
    dup = np.arange(0, a.nnz, 5)
    rng = np.random.default_rng(seed)
    r = np.concatenate([rows, rows[dup]])
    c = np.concatenate([a.colidx, a.colidx[dup]])
    v = np.concatenate([a.val, rng.standard_normal(dup.size).astype(np.float32)])
    order = np.lexsort((c, r))
    rowptr = np.zeros(a.nrow + 1, np.int64)
    np.add.at(rowptr, r + 1, 1)
    return CSRMatrix(a.nrow, a.ncol, np.cumsum(rowptr), c[order].astype(np.int32),
                     v[order])


@pytest.mark.parametrize("prec", ["x3", "default", "highest"])
def test_duplicate_entries_add_like_jax(prec):
    a = _with_duplicates()
    assert np.any(np.diff(a.colidx) == 0)
    shard = [(a.rowptr, a.colidx, a.val)]
    _assert_same_pack(shard, a.nrow, np.float32, prec)


def test_split_matches_native_rne():
    """torch's RNE hi and lo = bf16(x - hi) equal the native split bit for
    bit, subnormals and huge values included."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.standard_normal(200_000),
        rng.standard_normal(50_000) * 1e-40,   # subnormals
        rng.standard_normal(50_000) * 1e30,
        np.float32(1.0) + np.arange(-4096, 4096) * np.float32(2.0 ** -23),
        [0.0, -0.0, 1.0, -1.0, 3.4e38, -3.4e38],
    ]).astype(np.float32)
    ah, al = device_pack.split_bf16(torch.from_numpy(x), with_lo=True)
    nh, nl = np_split_bf16(x)
    np.testing.assert_array_equal(_bits(ah), _bits(nh))
    np.testing.assert_array_equal(_bits(al), _bits(nl))


@pytest.mark.parametrize("mode", device_pack.MODES)
def test_uniform_fill_modes(mode):
    from crp_tpu_torch.kernels.spmm_pallas import TK, choose_chunks, window_extents

    a = banded_random_csr(600, nnz_per_row=5, bandwidth=30, seed=2,
                          dtype=np.float64 if mode == "f64" else np.float32)
    rp = a.rowptr.astype(np.int64)
    min_t, W0 = window_extents(rp, a.colidx, 256)
    W, _, _ = choose_chunks(W0)
    ws = (min_t * TK).astype(np.int32)
    ws_full, ah, al = device_pack.uniform_fill(
        rp, a.colidx, a.val, a.nrow, 256, W, 4, ws, mode, torch.device("cpu"))
    np.testing.assert_array_equal(ws_full, np.r_[ws, np.zeros(4 - len(ws), np.int32)])
    want = {"pair": torch.bfloat16, "bf16": torch.bfloat16, "tf32": torch.float32,
            "f32": torch.float32, "f64": torch.float64}[mode]
    assert ah.dtype == want and ah.shape == ((2,) if mode == "tf32" else ()) + (4, 256, W)
    assert (al is not None) == (mode == "pair")
    if mode == "tf32":  # the planes: the fp32 panels come back from them exactly
        ah = tf32_panels(ah)
    # scatter the panels back into a dense matrix and compare with A
    dense = torch.zeros(4 * 256, int(ws_full.max()) + W, dtype=torch.float64)
    full = ah.double() + (al.double() if al is not None else 0)
    for g in range(4):
        dense[g * 256:(g + 1) * 256, ws_full[g]:ws_full[g] + W] += full[g]
    err = np.abs(dense[: a.nrow, : a.ncol].numpy() - a.to_dense()).max()
    scale = np.abs(a.val).max()
    assert err <= {"pair": 2 ** -16, "bf16": 2 ** -8, "tf32": 0, "f32": 0, "f64": 0}[
        mode] * scale


def _with_reversed_row():
    """Banded CSR whose row 3 holds columns [5, 890] in descending order."""
    a = banded_random_csr(900, nnz_per_row=6, bandwidth=30, seed=4,
                          dtype=np.float32)
    rows = np.repeat(np.arange(a.nrow), np.diff(a.rowptr))
    keep = rows != 3
    r = np.r_[rows[keep], 3, 3]
    c = np.r_[a.colidx[keep], 890, 5]
    v = np.r_[a.val[keep], 1.5, -2.0].astype(np.float32)
    order = np.argsort(r, kind="stable")  # rows sorted, row 3 stays 890, 5
    rowptr = np.zeros(a.nrow + 1, np.int64)
    np.add.at(rowptr, r + 1, 1)
    return CSRMatrix(a.nrow, a.ncol, np.cumsum(rowptr), c[order].astype(np.int32),
                     v[order])


def test_unsorted_rows_land_on_the_ragged_pack():
    """The uniform pack refuses a per-row-unsorted CSR; the gate sends it to
    the ragged pack (its cover sorts each group's columns), as JAX's
    ``dispatch.py:389-392`` does."""
    a = _with_reversed_row()
    shard = [(a.rowptr, a.colidx, a.val)]
    with pytest.raises(UnsupportedSparsity, match="not sorted"):
        td._pack_pallas_uniform(shard, a.nrow, np.float32, "x3",
                                torch.device("cpu"))
    arrays, op, kind = td.pack_with_fallback(shard, a.nrow, np.float32, "pallas",
                                             device="cpu", mxu_precision="x3")
    assert (kind, op.variant) == ("pallas", "ragged")
    b = np.random.default_rng(0).standard_normal((op.min_b_rows, 8)).astype(np.float32)
    c = op(tuple(x[0] for x in arrays), torch.from_numpy(b)).numpy()[: a.nrow]
    np.testing.assert_allclose(c, a.to_dense() @ b[: a.ncol], rtol=1e-4, atol=1e-4)


# ---------------------------------------------- the slab-by-slab densify


def _one_shot(flat, vals, shape, mode, apart=False):
    """The panels scattered whole, then split: what the slabs stand for
    (``apart``: the TF32 planes as two tensors, big and small)."""
    t = torch.zeros(int(np.prod(shape)),
                    dtype=torch.float64 if mode == "f64" else torch.float32)
    t.index_put_((torch.from_numpy(flat),), torch.from_numpy(vals), accumulate=True)
    t = t.view(shape)
    if mode in ("f32", "f64"):
        return t, None
    if mode == "tf32":
        return device_pack.tf32_pair(t) if apart else (device_pack.tf32_planes(t), None)
    return device_pack.split_bf16(t, with_lo=mode == "pair")


def _spy_densify(monkeypatch, panels_per_slab):
    """Slabs of about ``panels_per_slab`` panels, and every ``_densify``
    call recorded with its inputs and planes."""
    real, calls = device_pack._densify, []

    def spy(flat, vals, shape, mode, device, cuts=None, out=None):
        got = real(flat, vals, shape, mode, device, cuts, out)
        calls.append((flat, vals, shape, mode, cuts, got))
        return got

    monkeypatch.setattr(device_pack, "_densify", spy)
    return calls


def _assert_slabs_equal_one_shot(calls, mode, min_slabs):
    assert calls
    for flat, vals, shape, m, cuts, (ah, al) in calls:
        assert m == mode
        wh, wl = _one_shot(flat, vals, shape, mode, apart=al is not None)
        assert ah.dtype == wh.dtype and ah.shape == wh.shape
        np.testing.assert_array_equal(_bits(ah), _bits(wh))
        assert (al is None) == (wl is None)
        if al is not None:
            np.testing.assert_array_equal(_bits(al), _bits(wl))
        if mode in ("pair", "bf16", "tf32"):
            per = int(np.prod(shape[-2:]))
            cuts = np.arange(int(np.prod(shape[:-2])) + 1) if cuts is None else cuts
            assert len(device_pack._slabs(np.asarray(cuts), per)) - 1 >= min_slabs


def _dup_shards(p, dtype):
    """``_with_duplicates`` in p row shards, shard 1 empty when p > 2."""
    a = _with_duplicates()
    d = np.linspace(0, a.nrow, p + 1).astype(np.int64)
    shards = []
    for i in range(p):
        sh = a.row_slice(int(d[i]), int(d[i + 1]))
        if p > 2 and i == 1:
            shards.append((np.zeros(sh.nrow + 1, np.int64), np.zeros(0, np.int32),
                           np.zeros(0, dtype)))
        else:
            shards.append((sh.rowptr, sh.colidx.astype(np.int32), sh.val.astype(dtype)))
    return shards


@pytest.mark.parametrize("mode", device_pack.MODES)
@pytest.mark.parametrize("p", [1, 3])
def test_uniform_slabs_equal_one_shot(monkeypatch, mode, p):
    """The uniform fill with slabs of two panels (duplicate entries, pad
    groups, an empty shard at p = 3) gives the one-shot scatter and split
    bit for bit, in every mode."""
    from crp_tpu_torch.kernels.spmm_pallas import TK, choose_chunks, window_extents

    dtype = np.float64 if mode == "f64" else np.float32
    shards = _dup_shards(p, dtype)
    TM, ext = 256, []
    for rp, cc, _ in shards:
        ext.append(window_extents(np.asarray(rp, np.int64), cc, TM) if len(cc) else None)
    W, _, _ = choose_chunks(max(e[1] for e in ext if e is not None))
    G = max(len(e[0]) for e in ext if e is not None) + 2  # pad groups
    monkeypatch.setattr(device_pack, "_SLAB", 2 * TM * W + 1)
    calls = _spy_densify(monkeypatch, 2)
    ws, ah, al = device_pack.uniform_fill_stacked(
        shards, [None if e is None else (e[0] * TK).astype(np.int32) for e in ext],
        TM, W, G, mode, torch.device("cpu"))
    assert len(calls) == 1
    assert ah.shape == ((p, 2, G, TM, W) if mode == "tf32" else (p, G, TM, W))
    _assert_slabs_equal_one_shot(calls, mode, min_slabs=3)


@pytest.mark.parametrize("mode,prec", [("pair", "x3"), ("bf16", "default"),
                                       ("f32", "highest"), ("f64", "highest")])
def test_ragged_slabs_equal_one_shot(monkeypatch, mode, prec):
    """The ragged pack of two shards (a power-law matrix with duplicate
    entries: hub groups of many chunks, dummy chunks, the shorter shard's
    trailing no-op steps, pad groups) with slabs of about two chunks, whole
    groups each: every shard's planes equal the one-shot scatter and split
    of its nonzeros bit for bit, and the stacked pack holds them (fp32 at
    ``highest``: its TF32 planes, big and small apart)."""
    from crp_tpu.sparse.synth import powerlaw_random_csr

    dtype = np.float64 if mode == "f64" else np.float32
    base = powerlaw_random_csr(2000, avg_degree=12, seed=3, dtype=dtype)
    rows = np.repeat(np.arange(base.nrow), np.diff(base.rowptr))
    dup = np.arange(0, base.nnz, 7)
    r = np.concatenate([rows, rows[dup]])
    c = np.concatenate([base.colidx, base.colidx[dup]])
    v = np.concatenate([base.val, base.val[dup] * 0.5]).astype(dtype)
    order = np.lexsort((c, r))
    rowptr = np.r_[0, np.cumsum(np.bincount(r, minlength=base.nrow))]
    cc, vv = c[order].astype(np.int32), v[order]
    cut = 600  # shard 0 has fewer steps: trailing no-op steps
    shards = [(rowptr[: cut + 1], cc[: rowptr[cut]], vv[: rowptr[cut]]),
              (rowptr[cut:] - rowptr[cut], cc[rowptr[cut]:], vv[rowptr[cut]:])]
    TM, Wc = 128, 256
    monkeypatch.setattr(device_pack, "_SLAB", 2 * TM * Wc + 1)
    calls = _spy_densify(monkeypatch, 2)
    arrays, op = td._pack_ragged(shards, base.nrow - cut + 300, dtype, prec,
                                 torch.device("cpu"), geometry=(TM, Wc),
                                 min_chunk_nnz=12, spill_impl="segsum")
    assert len(calls) == 2
    _assert_slabs_equal_one_shot(calls, device_pack.panel_mode(dtype, prec), min_slabs=4)
    for i, (*_, (ah, al)) in enumerate(calls):
        np.testing.assert_array_equal(_bits(arrays[3][i]), _bits(ah))
        if al is not None:
            np.testing.assert_array_equal(_bits(arrays[4][i]), _bits(al))
