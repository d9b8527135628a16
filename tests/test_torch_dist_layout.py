"""The port's meshes of ranks (``crp_tpu_torch/shard/layout.py``):
``init_distributed`` from a ``torchrun``-style env, ``make_mesh_2d``'s
rank -> (pi, pj) against JAX's device grid, the row and column groups,
and the refusals.  The ranks are gloo processes on the CPU
(``tests/torch_dist_ranks.py``)."""

import numpy as np
import pytest

from crp_tpu.shard.layout import make_mesh_2d as jax_mesh_2d

from crp_tpu_torch.shard import layout

from tests.torch_dist_ranks import run_ranks

WORLDS = (3, 4)
GRIDS = [(w, pm, w // pm) for w in WORLDS for pm in range(1, w + 1) if w % pm == 0]


@pytest.fixture(scope="module")
def ranks():
    return {w: run_ranks(w, "mesh_layout", None) for w in WORLDS}


@pytest.mark.parametrize("world,pm,pn", GRIDS, ids=[f"{w}:{m}x{n}" for w, m, n in GRIDS])
def test_mesh_places_ranks_as_jax_grid(ranks, devices8, world, pm, pn):
    """Rank r sits where JAX's ``make_mesh_2d`` puts device r (row-major,
    ``devices[i*pn + j]``); its row group is its grid row, its column
    group its grid column, each in axis order, None where the axis has one
    rank of several; the backend is gloo and the device the CPU."""
    grid = jax_mesh_2d(pm, pn, devices=devices8[:world]).devices
    ids = np.vectorize(lambda d: d.id)(grid)
    for r, got in enumerate(ranks[world]):
        assert (got["rank"], got["world"]) == (r, world)
        g = got["grids"][(pm, pn)]
        (pi, pj), = np.argwhere(ids == devices8[r].id)
        assert (g["pi"], g["pj"]) == (pi, pj)
        assert g["row_ranks"] == tuple(int(devices8.index(d)) for d in grid[pi])
        assert g["col_ranks"] == tuple(int(devices8.index(d)) for d in grid[:, pj])
        assert g["row_size"] == (None if pn == 1 else pn)
        assert g["col_size"] == (None if pm == 1 else pm)
        assert (g["backend"], g["device"]) == ("gloo", "cpu")
        # GPU hosts have no slices: the auto mesh is the row-major grid
        assert g["auto"] == (g["pi"], g["pj"], g["row_ranks"], g["col_ranks"])


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_refuses_another_world_size(ranks, world):
    for got in ranks[world]:
        assert got["refused"] == (f"a {world + 1} x 1 mesh needs {world + 1} ranks, "
                                  f"the world has {world}")


def test_init_distributed_needs_the_launcher_env(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        layout.init_distributed(device="cpu")


def test_init_distributed_runs_on_the_card_by_default(monkeypatch):
    """No device named: ``cuda:LOCAL_RANK``, which raises without a card
    (nothing falls back to the CPU)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        layout.init_distributed()


def test_mesh_over_a_group_joined_directly_defaults_to_the_card():
    """Ranks that joined through ``dist.init_process_group`` alone get a
    mesh on ``cuda:LOCAL_RANK``, or a refusal where there is no card: never
    the CPU unless it is asked for."""
    import torch

    for got in run_ranks(2, "direct_group", None):
        if torch.cuda.is_available():
            assert got["default"] == "cuda:0"
        else:
            assert got["default"].startswith("refused: no CUDA device")
        assert got["asked"] == "cpu"


def test_meshes_need_a_process_group():
    with pytest.raises(RuntimeError, match="init_distributed"):
        layout.make_mesh_2d(2, 2)
    with pytest.raises(RuntimeError, match="init_distributed"):
        layout.make_mesh_1d(2)
    with pytest.raises(RuntimeError, match="init_distributed"):
        layout.make_mesh_auto(1, 2)
