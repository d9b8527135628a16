"""Plan -> padded stacked layout, and the meshes of ranks
(``crp_tpu/shard/layout.py``).

Shards are stacked along a leading axis and padded to the largest block;
these numpy helpers move between the user's global row-major matrices and
that layout: row blocks ``(p, rows, n)`` for ``RowParaSpmm`` and 2D blocks
``(pm, pn, rows, cols)`` for ``Para2dSpmm`` (``crp_tpu/engine/para2d.py:
399-453``).

Without a mesh the port's engines hold every shard on their one device.
With one (:class:`RankMesh`, from :func:`make_mesh_1d` / :func:`make_mesh_2d`
after :func:`init_distributed`) each process, one rank a device, holds its
own shard: PyTorch's counterpart of JAX's device mesh and ``shard_map``,
with ``torch.distributed`` (NCCL on the card, gloo on the CPU) where JAX
has its collectives, and one rank per process as the reference's MPI.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


def stack_padded(arrays: list[np.ndarray], pad_value=0, dtype=None) -> np.ndarray:
    """Stack 1D/2D arrays along a new leading axis, padding dim 0 to the max."""
    n = max((a.shape[0] for a in arrays), default=0)
    n = max(n, 1)
    rest = arrays[0].shape[1:] if arrays else ()
    dtype = dtype or arrays[0].dtype
    out = np.full((len(arrays), n) + rest, pad_value, dtype=dtype)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a
    return out


def shard_dense_rows(
    b: np.ndarray, displs: np.ndarray, pad_rows: int | None = None
) -> np.ndarray:
    """Global (k, n) -> stacked padded shards (p, max_rows, n) by row blocks."""
    displs = np.asarray(displs)
    blocks = [b[displs[i] : displs[i + 1]] for i in range(len(displs) - 1)]
    out = stack_padded(blocks, pad_value=0, dtype=b.dtype)
    if pad_rows is not None and out.shape[1] < pad_rows:
        pad = np.zeros((out.shape[0], pad_rows - out.shape[1], out.shape[2]), out.dtype)
        out = np.concatenate([out, pad], axis=1)
    return out


def unshard_dense_rows(c_shards: np.ndarray, displs: np.ndarray) -> np.ndarray:
    """Stacked padded shards (p, max_rows, n) -> global (m, n)."""
    displs = np.asarray(displs)
    c_shards = np.asarray(c_shards)
    return np.concatenate(
        [c_shards[i, : displs[i + 1] - displs[i]] for i in range(len(displs) - 1)],
        axis=0,
    )


def shard_dense_2d(b: np.ndarray, row_displs, col_displs, rows: int,
                   cols: int) -> np.ndarray:
    """Global (k, n) -> (pm, pn, rows, cols) blocks: block (i, j) holds
    ``b[row_displs[i]:row_displs[i+1], col_displs[j]:col_displs[j+1]]``,
    zero-padded."""
    pm, pn = len(row_displs) - 1, len(col_displs) - 1
    out = np.zeros((pm, pn, rows, cols), dtype=b.dtype)
    for i in range(pm):
        r0, r1 = int(row_displs[i]), int(row_displs[i + 1])
        for j in range(pn):
            c0, c1 = int(col_displs[j]), int(col_displs[j + 1])
            out[i, j, : r1 - r0, : c1 - c0] = b[r0:r1, c0:c1]
    return out


def unshard_dense_2d(c_blocks: np.ndarray, row_displs, col_displs, m: int,
                     n: int) -> np.ndarray:
    """(pm, pn, rows, cols) blocks -> global (m, n); rows past the last
    block are zero."""
    out = np.zeros((m, n), dtype=c_blocks.dtype)
    for i in range(len(row_displs) - 1):
        r0, r1 = int(row_displs[i]), int(row_displs[i + 1])
        for j in range(len(col_displs) - 1):
            c0, c1 = int(col_displs[j]), int(col_displs[j + 1])
            out[r0:r1, c0:c1] = c_blocks[i, j, : r1 - r0, : c1 - c0]
    return out


# ------------------------------------------------------------------ ranks


def init_distributed(backend: str | None = None, device=None) -> torch.device:
    """Join the launcher's process group and return this rank's device
    (``crp_tpu/shard/layout.py:71-82``; the reference's ``MPI_Init``).

    Reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` (default 0) and
    ``MASTER_ADDR`` / ``MASTER_PORT`` as ``torchrun`` sets them.  The
    device is ``cuda:LOCAL_RANK`` (made current) unless ``device`` names
    another (``"cpu"`` for the plain versions); a CUDA device with no card
    raises, as the engines do.  ``backend`` defaults to ``nccl`` on a CUDA
    device and ``gloo`` on the CPU; a run may pass ``gloo`` for the control
    plane of several ranks on one card, which NCCL refuses.  Call once per
    process before building meshes; a second call returns the device."""
    import torch.distributed as dist

    from ..engine.rowpara import engine_device

    local = int(os.environ.get("LOCAL_RANK", "0"))
    device = engine_device(device if device is not None else f"cuda:{local}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(f"init_distributed: the launcher's env lacks {missing} "
                               "(run under torchrun, or set them)")
        dist.init_process_group(
            backend or ("nccl" if device.type == "cuda" else "gloo"),
            init_method="env://", rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]))
    _RANK_DEVICE["device"] = device
    return device


_RANK_DEVICE: dict = {}


@dataclasses.dataclass
class RankMesh:
    """One rank's view of a row-major pm x pn grid of processes, the
    counterpart of a JAX ``Mesh`` over axes ("pm", "pn"): rank
    ``pi * pn + pj`` holds block (pi, pj) (``src/para2d_spmm.c:38-40``).

    ``group`` is the grid's process group (the world); ``row_group`` the
    pn ranks of this rank's grid row (the "pn" axis: A's replication),
    ``col_group`` the pm ranks of its grid column (the "pm" axis: the B
    exchange), None where that axis has one rank of several; ``row_ranks`` and
    ``col_ranks`` their global ranks in axis order; ``device`` this
    rank's device."""

    pm: int
    pn: int
    rank: int
    group: object
    row_group: object
    col_group: object
    row_ranks: tuple
    col_ranks: tuple
    device: torch.device

    @property
    def pi(self) -> int:
        return self.rank // self.pn

    @property
    def pj(self) -> int:
        return self.rank % self.pn

    @property
    def size(self) -> int:
        return self.pm * self.pn


def _subgroup(ranks: list, world: int):
    """A process group of ``ranks``: the world's where they are all of it
    (a world of one rank included), None for one rank of several;
    ``dist.new_group`` otherwise (every rank makes every group, in one
    order)."""
    import torch.distributed as dist

    if len(ranks) == world:
        return dist.group.WORLD
    if len(ranks) == 1:
        return None
    return dist.new_group(ranks)


def make_mesh_2d(pm: int, pn: int, device=None) -> RankMesh:
    """The row-major pm x pn grid over the world's ranks (``layout.py:
    59-68``: block (i, j) on rank ``i*pn + j``); raises unless the world
    has pm * pn ranks.  ``device``: this rank's; by default the one
    :func:`init_distributed` returned, else (a group joined through
    ``dist.init_process_group`` itself) ``cuda:LOCAL_RANK``, which raises
    without a card, as the engines do: the CPU only where it is asked for."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_mesh_2d: call init_distributed() first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != pm * pn:
        raise ValueError(f"a {pm} x {pn} mesh needs {pm * pn} ranks, the world has {world}")
    from ..engine.rowpara import engine_device

    device = engine_device(device if device is not None else _RANK_DEVICE.get(
        "device", f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"))
    rows = [[i * pn + j for j in range(pn)] for i in range(pm)]
    cols = [[i * pn + j for i in range(pm)] for j in range(pn)]
    # every rank makes every subgroup, in this one order
    row_groups = [_subgroup(r, world) for r in rows]
    col_groups = [_subgroup(c, world) for c in cols]
    pi, pj = divmod(rank, pn)
    return RankMesh(pm, pn, rank, dist.group.WORLD, row_groups[pi], col_groups[pj],
                    tuple(rows[pi]), tuple(cols[pj]), device)


def make_mesh_1d(p: int, device=None) -> RankMesh:
    """p ranks along "pm" (``layout.py:52-56``): :func:`make_mesh_2d` (p, 1)."""
    return make_mesh_2d(p, 1, device=device)


def make_mesh_auto(pm: int, pn: int, device=None) -> RankMesh:
    """The mesh for a pm x pn run (``layout.py:85-118``).  On TPU pods JAX
    keeps the per-exec B exchange (``pm``) inside a slice and splits ``pn``
    across slices; GPU hosts here have no slices, so this is the plain
    row-major grid of :func:`make_mesh_2d`.  A launcher that places the
    ranks of a column group on one NVLink domain gives that layout."""
    return make_mesh_2d(pm, pn, device=device)
