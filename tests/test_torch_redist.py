"""The port's block redistribution (``crp_tpu_torch/shard/redist.py``)
against ``crp_tpu.shard.redist`` on the CPU mesh: the seven cases of
``tests/test_redist.py``, each with the same source and destination
layouts and the same seeded matrix.  The destination blocks must equal
JAX's bit for bit (the exec only copies), and the audit volumes
(``nelem_dst``, ``nelem_moved``, ``nelem_physical``) and pair tables must
be equal."""

import numpy as np
import pytest
import torch

from crp_tpu.shard.layout import make_mesh_1d, make_mesh_2d
from crp_tpu.shard.redist import BlockDist as JaxBlockDist
from crp_tpu.shard.redist import RedistEngine as JaxRedist

from crp_tpu_torch.shard.redist import BlockDist, RedistEngine
from crp_tpu_torch.utils.blocks import uniform_displs


def rand(m, n, seed=0):
    return np.random.default_rng(seed).standard_normal((m, n))


def cols_dist(m, n, p):
    cd = uniform_displs(n, p)
    return np.stack([np.zeros(p), cd[:-1], np.full(p, m), np.diff(cd)], axis=1)


def row_vec(displs):
    p = len(displs) - 1
    return np.stack([np.zeros(p), displs[:-1], np.ones(p), np.diff(displs)], axis=1)


def _rolled(m, n, p):
    d = BlockDist.from_row_slabs(uniform_displs(m, p), n)
    return np.roll(d.blocks, 1, axis=0)


# name -> (x, src blocks, dst blocks, mesh shape), as tests/test_redist.py
CASES = {
    "row_slabs_to_col_slabs": lambda: (
        rand(53, 37), BlockDist.from_row_slabs(uniform_displs(53, 4), 37).blocks,
        cols_dist(53, 37, 4), (4,)),
    "grid_to_grid_2d_mesh": lambda: (
        rand(61, 45, seed=1),
        BlockDist.from_grid(uniform_displs(61, 4), uniform_displs(45, 2)).blocks,
        BlockDist.from_grid(np.array([0, 10, 61]), np.array([0, 7, 20, 33, 45])).blocks,
        (4, 2)),
    "gather_to_root": lambda: (
        rand(40, 24, seed=2), BlockDist.from_row_slabs(uniform_displs(40, 8), 24).blocks,
        BlockDist.from_row_slabs(uniform_displs(40, 8), 24).gather_single(40, 24).blocks,
        (8,)),
    "scatter_from_root": lambda: (
        rand(30, 16, seed=3),
        BlockDist.from_row_slabs(uniform_displs(30, 4), 16).gather_single(30, 16, root=2).blocks,
        BlockDist.from_row_slabs(uniform_displs(30, 4), 16).blocks, (4,)),
    "nnz_vector_redistribution": lambda: (
        rand(1, 997, seed=4), row_vec(uniform_displs(997, 4)),
        row_vec(np.array([0, 137, 400, 800, 997])), (4,)),
    "volume_audit": lambda: (
        rand(32, 8, seed=5), BlockDist.from_row_slabs(uniform_displs(32, 4), 8).blocks,
        _rolled(32, 8, 4), (4,)),
    "identity_redistribution_moves_nothing": lambda: (
        rand(24, 12, seed=6), BlockDist.from_row_slabs(uniform_displs(24, 4), 12).blocks,
        BlockDist.from_row_slabs(uniform_displs(24, 4), 12).blocks, (4,)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_redist_matches_jax(devices8, case):
    x, src, dst, shape = CASES[case]()
    mesh = (make_mesh_1d(shape[0], devices=devices8) if len(shape) == 1
            else make_mesh_2d(*shape, devices=devices8))
    j = JaxRedist(JaxBlockDist(src), JaxBlockDist(dst), mesh)
    t = RedistEngine(BlockDist(src), BlockDist(dst), device="cpu")
    for f in ("max_h", "max_w", "nelem_dst", "nelem_moved", "nelem_physical"):
        assert getattr(t, f) == getattr(j, f), f
    for f in ("s_start", "d_start", "hw"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    xs_j, xs_t = j.shard_src(x), t.shard_src(x)
    np.testing.assert_array_equal(xs_t.numpy(), np.asarray(xs_j))
    out_j, out_t = np.asarray(j.exec_device(xs_j)), t.exec_device(xs_t)
    assert out_t.dtype == torch.float64 and out_t.shape == out_j.shape
    np.testing.assert_array_equal(out_t.numpy(), out_j)
    y = t.unshard_dst(out_t, x.shape[0], x.shape[1])
    np.testing.assert_array_equal(y, j.unshard_dst(out_j, x.shape[0], x.shape[1]))
    if case == "gather_to_root":
        np.testing.assert_array_equal(out_t[0].numpy(), x)
    else:
        np.testing.assert_array_equal(y, x)
    if case == "volume_audit":
        assert t.nelem_moved == x.size and t.nelem_physical >= t.nelem_moved
    if case == "identity_redistribution_moves_nothing":
        assert t.nelem_moved == 0


def test_redist_int32_and_default_device():
    """int32 payloads (the nnz vectors of ``dist_a``) move unchanged; with
    no card the default device raises rather than fall back."""
    src = BlockDist(row_vec(uniform_displs(50, 2)))
    dst = BlockDist(row_vec(np.array([0, 7, 50])))
    t = RedistEngine(src, dst, device="cpu", dtype=np.int32)
    x = np.arange(50, dtype=np.int32)[None]
    out = t.exec_device(t.shard_src(x))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(t.unshard_dst(out, 1, 50), x)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RedistEngine(src, dst)
