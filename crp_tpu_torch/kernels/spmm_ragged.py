"""Ragged gathered-window SpMM and the fused spill, for power-law and
variable-bandwidth packs.

Counterpart of ``crp_tpu/kernels/spmm_ragged.py``.  A ragged pack covers
each TM-row group of A with a list of TK-aligned ``Wc``-wide column chunks
(*steps*); step s holds a dense (TM, Wc) panel over the B rows
``[starts[s], starts[s] + Wc)`` and belongs to group ``step_g[s]``, so

    C[g*TM + r, j] = sum_{s: step_g[s] = g} sum_{k < Wc} A[s, r, k] * B[starts[s] + k, j].

Chunks whose nonzero count cannot pay for their panel are dropped and their
nonzeros *spill* to a COO list, added to C by the spill path.

The host half (cover, geometry model, spill packs) is a numpy copy of the
JAX package's; ``tests/test_torch_ragged.py`` pins each piece equal to its
original.  The JAX environment knobs (``CRP_TPU_RAGGED_*``,
``CRP_TPU_SPILL_*``) are keyword arguments here, defaulting to the JAX
defaults.  The cover is vectorized over groups (:func:`ragged_cover`); the
per-group loop :func:`ragged_cover_np` stays as its test twin.

The ``gather`` kind packs every nonzero of a shard the way the fused spill
packs the spilled ones (:func:`pack_gather_blocks`): it serves any CSR,
scrambled power-law graphs included, where the ragged cover refuses.

The kernels are CUDA kernels for Hopper, one per operating point, one for
the spill and one for the gather kind:

  * :func:`spmm_ragged_presplit` — ``x3`` (``csrc/ragged.cu``);
  * :func:`spmm_ragged_bf16` — ``default`` (``csrc/ragged.cu``);
  * :func:`spmm_ragged` — ``highest`` fp32 and fp64 (``csrc/ragged.cu``);
  * :func:`spmm_spill` — C plus the spilled nonzeros, fp32
    (``csrc/spill.cu``);
  * :func:`spmm_gather` — the same block body with no C, fp32
    (``csrc/spill.cu``).  The JAX wrapper ``spmm_gather_chunked`` splits
    its steps into chunks under ``CRP_TPU_GATHER_GB`` because XLA
    materializes ``take(b, cols)`` as a (steps * Q, n) stream; the CUDA
    kernel reads ``B[cols[q]]`` itself, so nothing is materialized and
    one launch takes every step.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
its ``launches`` attribute; for CPU tensors it runs its plain PyTorch
version (``*_plain``), which is also what the kernel is checked against on
the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .spmm_pallas import (
    PLAIN_BLOCK_BYTES, TK, UnsupportedSparsity, _placement, bf16_product,
    full_product, plain_blocks, presplit_product,
)

# the JAX defaults of the environment knobs this module turns into arguments
PANEL_CAP_BYTES = 8 << 30         # CRP_TPU_RAGGED_PANEL_GB = 8
RAGGED_TM, RAGGED_WC = 128, 512   # CRP_TPU_RAGGED_TM / _WC
SPILL_TMO, SPILL_Q = 512, 512     # CRP_TPU_SPILL_TMO / _Q
# rates of the geometry model (CRP_PROJ_HBM_GBPS / _SPILL_NS / _MXU_TFLOPS):
# measured on the TPU and kept so the port picks the JAX package's geometry
HBM_BYTES_PER_S = 623e9
SPILL_S_PER_NNZ = 21e-9
MXU_FLOP_PER_S = 165e12
N_REF = 256


@dataclasses.dataclass
class RaggedWindow:
    """Host-side packed form of one shard for the ragged kernel
    (``spmm_ragged.py:44-80``)."""

    nrow: int              # rows covered (G * TM >= nrow)
    ncol: int              # rB rows (gather space)
    TM: int
    G: int                 # row groups
    Wc: int                # chunk width (rows of B per chunk, TK-aligned)
    starts: np.ndarray     # (S,) int32 B-row start per chunk (TK-aligned)
    group_ptr: np.ndarray  # (G+1,) int64 chunk range per group (>=1 each)
    panels: np.ndarray     # (S, TM, Wc) dense A chunk panels
    # spilled nonzeros (rows relative to the shard, cols in rB space);
    # None when every nnz landed in a kept chunk
    spill: tuple[np.ndarray, np.ndarray, np.ndarray] | None
    mxu_nnz: int
    spill_nnz: int

    @property
    def S(self) -> int:
        return len(self.starts)

    @property
    def step_g(self) -> np.ndarray:
        return np.repeat(
            np.arange(self.G, dtype=np.int32), np.diff(self.group_ptr)
        )

    @property
    def step_first(self) -> np.ndarray:
        first = np.zeros(self.S, dtype=np.int32)
        first[self.group_ptr[:-1]] = 1
        return first

    @property
    def min_b_rows(self) -> int:
        return int(self.starts.max()) + self.Wc if self.S else self.Wc


def default_panel_cap_bytes() -> int:
    """Cap on a shard's kept dense panels (``spmm_ragged.py:83-92``)."""
    return PANEL_CAP_BYTES


def ragged_params() -> tuple[int, int]:
    """(TM, Wc) defaults of the ragged pack (``spmm_ragged.py:95-103``)."""
    return RAGGED_TM, RAGGED_WC


def default_min_chunk_nnz(TM: int, Wc: int) -> int:
    """Break-even nnz for keeping a chunk dense (``spmm_ragged.py:106-130``):
    a kept chunk streams its A panel and its B chunk at the n = 256
    reference width, a spilled nnz costs a fixed time."""
    chunk_s = (TM * Wc + Wc * N_REF) * 4.0 / HBM_BYTES_PER_S
    return max(8, int(np.ceil(chunk_s / SPILL_S_PER_NNZ)))


def _model_time(S, spill, G, tm, wc, mxu_precision, n_ref):
    passes = {"x3": 3, "highest": 6, "default": 1}.get(mxu_precision, 1)
    a_itemsize = {"x3": 4, "default": 2}.get(mxu_precision, 4)
    b_itemsize = 2 if mxu_precision == "default" else 4
    a_b = S * tm * wc * a_itemsize
    b_b = S * wc * n_ref * b_itemsize
    c_b = G * tm * n_ref * 4
    t_hbm = (a_b + b_b + c_b) / HBM_BYTES_PER_S
    t_mxu = passes * 2.0 * S * tm * wc * n_ref / MXU_FLOP_PER_S
    return max(t_hbm, t_mxu) + spill * SPILL_S_PER_NNZ


def choose_ragged_geometry(
    rowptr: np.ndarray,
    colidx: np.ndarray,
    mxu_precision: str = "highest",
    n_ref: int = N_REF,
    small: bool = False,
) -> tuple[int, int]:
    """Model-based (TM, Wc) per matrix (``spmm_ragged.py:133-181``): the
    candidate with the least modelled time over the {128, 256, 512}^2
    grid.  ``small`` is the JAX ``interpret`` (Wc <= 256): the port passes
    True on the CPU, so its CPU packs equal the JAX CPU packs.  The
    TPU-measured rates are kept on purpose so both packages pick the same
    geometry."""
    nnz = int(rowptr[-1]) - int(rowptr[0])
    cands = [(tm, wc) for tm in (128, 256, 512) for wc in (128, 256, 512)]
    if nnz > 30_000_000:  # bound the host-side cover sweep on huge shards
        cands = [(128, 512), (256, 256), (512, 128), (512, 256)]
    if small:
        cands = [(tm, wc) for tm, wc in cands if wc <= 256]
    best, best_t = cands[0], float("inf")
    sorted_by_tm = {}
    for tm, wc in cands:
        if tm not in sorted_by_tm:  # one sort per TM serves every Wc
            sorted_by_tm[tm] = _GroupCols(rowptr, colidx, tm)
        chunks = _raw_cover(sorted_by_tm[tm], wc)
        S, spill = _apply_threshold(chunks, default_min_chunk_nnz(tm, wc))[::2]
        t = _model_time(S, spill, sorted_by_tm[tm].G, tm, wc, mxu_precision,
                        n_ref)
        if t < best_t:
            best, best_t = (tm, wc), t
    return best


def resolve_ragged_geometry(
    rowptr: np.ndarray,
    colidx: np.ndarray,
    mxu_precision: str = "highest",
    small: bool = False,
) -> tuple[int, int]:
    """(TM, Wc) the pack uses (``spmm_ragged.py:184-209`` with no knob
    set): the fixed defaults for an empty shard, else the model's pick."""
    nnz = (int(rowptr[-1]) - int(rowptr[0])) if len(rowptr) > 1 else 0
    if nnz == 0:
        TM, Wc = ragged_params()
        return TM, (min(Wc, 256) if small else Wc)
    return choose_ragged_geometry(rowptr, colidx, mxu_precision, small=small)


# -------------------------------------------------------------------- cover


def _cover_group_np(cols_sorted: np.ndarray, Wc: int) -> list[int]:
    """Greedy fixed-width interval cover of sorted distinct columns
    (``spmm_ragged.py:212-224``)."""
    starts = []
    i = 0
    n = len(cols_sorted)
    while i < n:
        s = (int(cols_sorted[i]) // TK) * TK
        starts.append(s)
        i = int(np.searchsorted(cols_sorted, s + Wc, side="left"))
    return starts


def ragged_cover_np(
    rowptr: np.ndarray,
    colidx: np.ndarray,
    TM: int,
    Wc: int,
    min_chunk_nnz: int,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Per-group loop twin of :func:`ragged_cover` (``spmm_ragged.py:227-261``):
    (starts, group_ptr, spill_nnz)."""
    nrow = len(rowptr) - 1
    G = max(-(-nrow // TM), 1)
    all_starts: list[int] = []
    group_ptr = np.zeros(G + 1, dtype=np.int64)
    spill_nnz = 0
    for g in range(G):
        j0 = int(rowptr[min(g * TM, nrow)])
        j1 = int(rowptr[min((g + 1) * TM, nrow)])
        kept: list[int] = []
        if j1 > j0:
            cols = np.unique(colidx[j0:j1])
            starts = np.asarray(_cover_group_np(cols, Wc), dtype=np.int64)
            ch = np.searchsorted(starts, colidx[j0:j1], side="right") - 1
            cnt = np.bincount(ch, minlength=len(starts))
            keep = cnt >= min_chunk_nnz
            kept = [int(s) for s, k in zip(starts, keep) if k]
            spill_nnz += int(cnt[~keep].sum())
        if not kept:
            kept = [0]
        all_starts.extend(kept)
        group_ptr[g + 1] = len(all_starts)
    return np.asarray(all_starts, dtype=np.int32), group_ptr, spill_nnz


class _GroupCols:
    """A shard's columns sorted within each TM-row group, as the keys
    ``g * span + col``, and the group's distinct nonempty TK tiles as the
    keys ``g * (span // TK) + col // TK`` (``span`` is TK-aligned and
    exceeds every column, so the groups' key ranges are disjoint and
    ordered).  Independent of Wc: one serves every chunk width."""

    def __init__(self, rowptr, colidx, TM):
        rowptr = np.asarray(rowptr, dtype=np.int64)
        nrow = len(rowptr) - 1
        self.G = max(-(-nrow // TM), 1)
        bounds = rowptr[np.minimum(np.arange(self.G + 1) * TM, nrow)]
        j0, j1 = int(bounds[0]), int(bounds[-1])
        cols = np.asarray(colidx[j0:j1], dtype=np.int64)
        self.span = (int(cols.max(initial=0)) // TK + 1) * TK
        self.ptr = bounds - j0                    # (G+1,) per-group ranges
        g = np.repeat(np.arange(self.G, dtype=np.int64), np.diff(self.ptr))
        self.keys = np.sort(g * self.span + cols)
        tiles = self.keys // TK
        self.tiles = tiles[np.r_[True, tiles[1:] != tiles[:-1]]] if len(tiles) else tiles


def _raw_cover(gc: _GroupCols, Wc: int):
    """Every group's greedy chunks before the keep threshold, in (group,
    start) order: (G, group, start, nnz count).

    Over a group's distinct nonempty tiles the greedy cover is a chain:
    from the group's first tile, the next chunk starts at the first tile
    at or past ``start + Wc``.  The chains of all groups are walked at once
    by pointer doubling (jump tables ``next^(2^k)``), so the host cost is
    O(tiles * log(chunks per group)) numpy work with no per-chunk loop."""
    if Wc % TK:
        raise ValueError(f"Wc={Wc} is not a multiple of {TK}")
    tiles = gc.tiles
    U = len(tiles)
    if U == 0:
        z = np.zeros(0, np.int64)
        return gc.G, z, z, z
    tspan = gc.span // TK
    grp = tiles // tspan
    nxt = np.searchsorted(tiles, tiles + Wc // TK, side="left")
    nxt = np.where(np.append(grp, -1)[nxt] == grp, nxt, U)  # U: past the group
    jump = np.append(nxt, U)
    nodes = np.flatnonzero(np.r_[True, grp[1:] != grp[:-1]])  # chain roots
    frontier = nodes
    while True:
        frontier = jump[frontier]            # depths [2^k, 2^(k+1))
        frontier = frontier[frontier < U]
        if not frontier.size:
            break
        nodes = np.concatenate([nodes, frontier])
        jump = jump[jump]
        frontier = nodes
    nodes.sort()
    g = grp[nodes]
    start = (tiles[nodes] - g * tspan) * TK
    lo = np.searchsorted(gc.keys, g * gc.span + start, side="left")
    # a chunk end past the group's last column lands in the next group
    hi = np.minimum(
        np.searchsorted(gc.keys, g * gc.span + start + Wc, side="left"),
        gc.ptr[g + 1],
    )
    return gc.G, g, start, hi - lo


def _apply_threshold(chunks, min_chunk_nnz):
    """(S, (starts, group_ptr), spill_nnz) of a raw cover kept at
    ``min_chunk_nnz``; a group that keeps nothing gets one dummy chunk at
    start 0."""
    G, g, s, cnt = chunks
    keep = cnt >= min_chunk_nnz
    spill_nnz = int(cnt[~keep].sum())
    gk, sk = g[keep], s[keep]
    n_kept = np.bincount(gk, minlength=G)
    group_ptr = np.zeros(G + 1, dtype=np.int64)
    np.cumsum(np.maximum(n_kept, 1), out=group_ptr[1:])
    starts = np.zeros(int(group_ptr[-1]), dtype=np.int32)
    first_kept = np.zeros(G + 1, dtype=np.int64)
    np.cumsum(n_kept, out=first_kept[1:])
    rank = np.arange(len(gk), dtype=np.int64) - first_kept[gk]
    starts[group_ptr[gk] + rank] = sk
    return len(starts), (starts, group_ptr), spill_nnz


def ragged_cover(
    rowptr: np.ndarray,
    colidx: np.ndarray,
    TM: int,
    Wc: int,
    min_chunk_nnz: int,
) -> tuple[np.ndarray, np.ndarray, int]:
    """(starts, group_ptr, spill_nnz) of the ragged cover, equal to
    ``ragged_cover_np`` and the JAX package's native cover: each group's
    sorted columns are covered greedily by TK-aligned ``Wc``-wide chunks,
    chunks under ``min_chunk_nnz`` nonzeros are dropped (their nonzeros
    spill), and every group keeps at least one chunk."""
    chunks = _raw_cover(_GroupCols(rowptr, colidx, TM), Wc)
    _, (starts, group_ptr), spill_nnz = _apply_threshold(chunks, min_chunk_nnz)
    return starts, group_ptr, spill_nnz


def cover_with_cap(
    rowptr: np.ndarray,
    colidx: np.ndarray,
    TM: int,
    Wc: int,
    min_chunk_nnz: int,
    G: int,
    max_panel_bytes: int,
    itemsize: int,
) -> tuple[np.ndarray, np.ndarray, int]:
    """The cover, with ``min_chunk_nnz`` escalated x4 per step while the
    kept panels exceed ``max_panel_bytes`` (``spmm_ragged.py:264-298``).
    Raises UnsupportedSparsity when even the all-dummy floor does not fit.
    One raw cover serves every step."""
    chunks = _raw_cover(_GroupCols(rowptr, colidx, TM), Wc)
    mn = min_chunk_nnz
    for _ in range(12):
        S, (starts, group_ptr), spill_nnz = _apply_threshold(chunks, mn)
        panel_bytes = S * TM * Wc * itemsize
        if panel_bytes <= max_panel_bytes:
            return starts, group_ptr, spill_nnz
        if S <= G:  # already all-dummy: escalation is exhausted
            break
        mn *= 4
    raise UnsupportedSparsity(
        f"ragged panels {panel_bytes >> 20} MiB > cap even at "
        f"min_chunk_nnz={mn}"
    )


def estimate_ragged(
    rowptr: np.ndarray,
    colidx: np.ndarray,
    TM: int = RAGGED_TM,
    Wc: int = RAGGED_WC,
    min_chunk_nnz: int | None = None,
) -> tuple[int, int, int]:
    """Cover-only pass for the dispatch cost model: (S, spill_nnz, G)
    (``spmm_ragged.py:474-494``)."""
    if min_chunk_nnz is None:
        min_chunk_nnz = default_min_chunk_nnz(TM, Wc)
    chunks = _raw_cover(_GroupCols(rowptr, colidx, TM), Wc)
    S, _, spill = _apply_threshold(chunks, min_chunk_nnz)
    return S, spill, chunks[0]


# -------------------------------------------------------------- spill packs


def pack_spill(
    spill: tuple[np.ndarray, np.ndarray, np.ndarray] | None,
    nnz_pad: int,
    nrow: int,
    dtype,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Spill COO padded to ``nnz_pad``; pad rows = ``nrow``, dropped by
    the scatter (``spmm_ragged.py:941-957``)."""
    rows = np.full(nnz_pad, nrow, dtype=np.int32)
    cols = np.zeros(nnz_pad, dtype=np.int32)
    vals = np.zeros(nnz_pad, dtype=dtype)
    if spill is not None:
        r, c, v = spill
        rows[: len(r)] = r
        cols[: len(r)] = c
        vals[: len(r)] = v.astype(dtype)
    return rows, cols, vals


def pack_spill_blocks(
    spill: tuple[np.ndarray, np.ndarray, np.ndarray] | None,
    ns_pad: int,
    M: int,
    dtype,
    TMo: int = 128,
    Q: int = 128,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host pack of the fused spill (``spmm_ragged.py:984-1044``).

    Spilled nonzeros, sorted by output block, go into steps of ``Q`` slots,
    each step inside one ``TMo``-row block of the (M, n) output; every
    block gets at least one (maybe all-pad) step.  Returns (rel (ns_pad, 1,
    Q), cols (ns_pad, Q), vals (ns_pad, Q), first (ns_pad,), blk
    (ns_pad,)); pad slots carry rel == TMo and val 0.
    """
    assert M % TMo == 0, (M, TMo)
    nblk = M // TMo
    if spill is not None:
        r, c, v = spill
        assert bool(np.all(np.diff(r // TMo) >= 0)), \
            "spill must be sorted by output block"
        z = len(r)
    else:
        r = c = v = None
        z = 0
    counts = (
        np.bincount(r // TMo, minlength=nblk)
        if z
        else np.zeros(nblk, dtype=np.int64)
    )
    steps_per_blk = np.maximum(-(-counts // Q), 1)
    step_base = np.zeros(nblk + 1, dtype=np.int64)
    np.cumsum(steps_per_blk, out=step_base[1:])
    ns = int(step_base[-1])
    assert ns <= ns_pad, (ns, ns_pad)
    rel = np.full((ns_pad, Q), TMo, dtype=np.int32)
    cols = np.zeros((ns_pad, Q), dtype=np.int32)
    vals = np.zeros((ns_pad, Q), dtype=np.float32)
    blk = np.full(ns_pad, nblk - 1, dtype=np.int32)
    blk[:ns] = np.repeat(
        np.arange(nblk, dtype=np.int32), steps_per_blk.astype(np.int64)
    )
    first = np.zeros(ns_pad, dtype=np.int32)
    first[step_base[:-1]] = 1
    if z:
        blk_of = (r // TMo).astype(np.int64)
        starts = np.zeros(nblk + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        k = np.arange(z, dtype=np.int64) - starts[blk_of]
        step_of = step_base[blk_of] + k // Q
        slot = k % Q
        rel[step_of, slot] = (r - blk_of * TMo).astype(np.int32)
        cols[step_of, slot] = c
        vals[step_of, slot] = v.astype(np.float32)
    return rel[:, None, :], cols, vals, first, blk


def first_ptr(first: np.ndarray) -> np.ndarray:
    """(count + 1,) int32 step ranges from a 0/1 ``first`` array: entry i
    is the index of the i-th first step, the last is ``len(first)``.  The
    CUDA kernels read a group's (or an output block's) steps as one range;
    trailing no-op steps fall into the last range."""
    return np.concatenate(
        [np.flatnonzero(np.asarray(first)), [len(first)]]
    ).astype(np.int32)


# ------------------------------------------------------------- gather packs


def gather_step_layout(
    blk_counts_list: list[np.ndarray], Q: int
) -> np.ndarray:
    """Step layout of the ``gather`` kind shared by all shards
    (``spmm_ragged.py:1186-1199``): per output block, the most steps any
    shard needs (``ceil(count / Q)``, at least 1); returns the (nblk + 1,)
    int64 step offsets."""
    steps = np.maximum.reduce(
        [-(-c // Q) for c in blk_counts_list]
    )
    steps = np.maximum(steps, 1)
    step_base = np.zeros(len(steps) + 1, dtype=np.int64)
    np.cumsum(steps, out=step_base[1:])
    return step_base


def pack_gather_blocks(
    rowptr: np.ndarray,
    colidx: np.ndarray,
    val: np.ndarray,
    step_base: np.ndarray,
    M: int,
    TMo: int = 128,
    Q: int = 128,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """A whole CSR shard as gather steps (``spmm_ragged.py:1202-1251``):
    every nonzero, ordered by (output block, column), in the slots of its
    block's steps of :func:`gather_step_layout`.  Returns (rel (ns, 1, Q),
    cols (ns, Q), vals (ns, Q), first (ns,), blk (ns,)); pad slots carry
    rel == TMo and val 0."""
    nblk = M // TMo
    ns = int(step_base[-1])
    nrow = len(rowptr) - 1
    counts = np.diff(rowptr)
    base = int(rowptr[0]) if nrow >= 0 and len(rowptr) else 0
    nnz = int(rowptr[-1]) - base if len(rowptr) > 1 else 0
    r = np.repeat(np.arange(nrow, dtype=np.int64), counts)
    c = np.asarray(colidx)[base : base + nnz]
    v = np.asarray(val, dtype=np.float32)[base : base + nnz]
    order = np.lexsort((c, r // TMo))
    r, c, v = r[order], c[order], v[order]
    rel = np.full((ns, Q), TMo, dtype=np.int32)
    cols = np.zeros((ns, Q), dtype=np.int32)
    vals = np.zeros((ns, Q), dtype=np.float32)
    blk = np.repeat(
        np.arange(nblk, dtype=np.int32), np.diff(step_base).astype(np.int64)
    )
    first = np.zeros(ns, dtype=np.int32)
    first[step_base[:-1]] = 1
    z = len(r)
    if z:
        blk_of = r // TMo
        bcnt = np.bincount(blk_of, minlength=nblk)
        starts = np.zeros(nblk + 1, dtype=np.int64)
        np.cumsum(bcnt, out=starts[1:])
        k = np.arange(z, dtype=np.int64) - starts[blk_of]
        step_of = step_base[blk_of] + k // Q
        slot = k % Q
        rel[step_of, slot] = (r - blk_of * TMo).astype(np.int32)
        cols[step_of, slot] = c
        vals[step_of, slot] = v
    return rel[:, None, :], cols, vals, first, blk



# ------------------------------------------------------------ plain versions


def spmm_ragged_presplit_plain(step_g, group_ptr, starts, ah, al, b):
    """x3 ragged SpMM in plain PyTorch: each step's three bf16 products,
    added into its group's rows."""
    return plain_blocks(step_g, starts, ah, b, group_ptr.shape[0] - 1,
                        torch.float32, presplit_product(ah, al))


def spmm_ragged_bf16_plain(step_g, group_ptr, starts, ah, bh):
    """One-pass bf16 ragged SpMM in plain PyTorch (``bh`` is the bf16 B)."""
    return plain_blocks(step_g, starts, ah, bh, group_ptr.shape[0] - 1,
                        torch.float32, bf16_product(ah))


def spmm_ragged_plain(step_g, group_ptr, starts, panels, b):
    """fp32 / fp64 ragged SpMM in plain PyTorch (no TF32)."""
    return plain_blocks(step_g, starts, panels, b, group_ptr.shape[0] - 1,
                        panels.dtype, full_product(panels))


def spill_contrib(vals, brows, mxu_precision):
    """Each spilled nonzero's ``val * B[col]`` rounded as the JAX fused
    spill rounds it at each operating point (``spmm_ragged.py:1075-1094``):
    the fp32 product at ``highest``, its bf16 hi + lo pair at ``x3``, its
    bf16 rounding at ``default``."""
    cb = vals[:, None] * brows
    if mxu_precision == "x3":
        hi = cb.to(torch.bfloat16).float()
        return hi + (cb - hi).to(torch.bfloat16).float()
    if mxu_precision == "default":
        return cb.to(torch.bfloat16).float()
    return cb


def spmm_spill_plain(c, rel, cols, vals, blk, blk_ptr, b, mxu_precision="highest"):
    """C plus the spilled nonzeros in plain PyTorch: every live slot
    (``rel < TMo``) adds its rounded ``val * B[col]`` to row
    ``blk * TMo + rel`` of a copy of ``c``, in bounded blocks of steps."""
    M, n = c.shape
    ns, _, Q = rel.shape
    TMo = M // (blk_ptr.shape[0] - 1)
    out = c.clone()
    step = max(1, PLAIN_BLOCK_BYTES // max(1, Q * n * 4))
    for s0 in range(0, ns, step):
        r = rel[s0 : s0 + step, 0]
        live = r < TMo
        rows = (blk[s0 : s0 + step, None].long() * TMo + r)[live]
        contrib = spill_contrib(
            vals[s0 : s0 + step][live], b[cols[s0 : s0 + step][live].long()],
            mxu_precision,
        )
        out.index_add_(0, rows, contrib)
    return out


def spmm_gather_plain(rel, cols, vals, blk, blk_ptr, b, M, mxu_precision="highest"):
    """Every packed nonzero as an (M, n) fp32 product in plain PyTorch:
    :func:`spmm_spill_plain` onto a zero C."""
    c = torch.zeros((M, b.shape[1]), dtype=torch.float32, device=b.device)
    return spmm_spill_plain(c, rel, cols, vals, blk, blk_ptr, b, mxu_precision)


def spmm_spill_chunked(rows, cols, vals, b, nrow: int):
    """The spilled nonzeros as an (nrow, n) product in plain PyTorch,
    ``index_add_`` of ``vals * B[cols]`` (``spmm_ragged.py:1311-1371``, an
    XLA op there too).  Rows are sorted; pad rows == ``nrow`` are dropped.
    Serves fp64 packs and sparse spills, where the fused kernel does not
    run."""
    n = b.shape[1]
    out = torch.zeros((nrow + 1, n), dtype=b.dtype, device=b.device)
    step = max(1, PLAIN_BLOCK_BYTES // max(1, n * b.element_size()))
    for i in range(0, rows.shape[0], step):
        contrib = vals[i : i + step, None].to(b.dtype) * b[cols[i : i + step].long()]
        out.index_add_(0, rows[i : i + step].long(), contrib)
    return out[:nrow]


# ----------------------------------------------------------------- wrappers


def _check_ragged_args(name, step_g, group_ptr, starts, panels, b, min_b_rows,
                       panel_dtype, b_dtype):
    S, TM, Wc = panels[0].shape
    for p in panels:
        if p.dtype != panel_dtype or p.shape != (S, TM, Wc) or not p.is_contiguous():
            raise ValueError(
                f"{name}: panels must be contiguous {panel_dtype} of one "
                f"shape (S, TM, Wc); got {p.dtype} {tuple(p.shape)}"
            )
    for arr, label, size in ((step_g, "step_g", S), (starts, "starts", S),
                             (group_ptr, "group_ptr", None)):
        if arr.dtype != torch.int32 or arr.dim() != 1 or not arr.is_contiguous() \
                or (size is not None and arr.shape[0] != size):
            raise ValueError(f"{name}: {label} must be contiguous 1-D int32"
                             + (f" of length {size}" if size is not None else ""))
    if group_ptr.shape[0] < 2:
        raise ValueError(f"{name}: group_ptr needs G + 1 >= 2 entries")
    if b.dtype != b_dtype or b.dim() != 2 or not b.is_contiguous():
        raise ValueError(f"{name}: B must be a contiguous 2-D {b_dtype} tensor")
    if b.shape[0] < min_b_rows:
        raise ValueError(
            f"{name}: B has {b.shape[0]} rows < min_b_rows {min_b_rows}"
        )
    if TM % 128 or Wc % 32:
        raise ValueError(f"{name}: TM % 128 and Wc % 32 must be 0 (TM={TM}, Wc={Wc})")
    return group_ptr.shape[0] - 1, TM, Wc, b.shape[1]


def _launch(name, ptrs, ints, device):
    from . import _build

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _build.entry(name)(*ptrs, *ints, stream)
    _build.check(rc, name)


def _ragged(name, entry, step_g, group_ptr, starts, panels, b, min_b_rows,
            panel_dtype, b_dtype, out_dtype):
    G, TM, Wc, n = _check_ragged_args(
        name, step_g, group_ptr, starts, panels, b, min_b_rows, panel_dtype,
        b_dtype,
    )
    c = torch.empty((G * TM, n), dtype=out_dtype, device=b.device)
    _launch(
        entry,
        (group_ptr.data_ptr(), starts.data_ptr(),
         *(p.data_ptr() for p in panels), b.data_ptr(), c.data_ptr()),
        (G, TM, Wc, n), b.device,
    )
    return c


def spmm_ragged_presplit(step_g, group_ptr, starts, ah, al, b, *, min_b_rows: int):
    """x3 ragged SpMM: (G*TM, n) fp32 from bf16 ``ah``/``al`` chunk panels
    and fp32 ``b``.  Replaces ``spmm_ragged_presplit``
    (``spmm_ragged.py:859``, kernel ``_ragged_kernel_presplit`` ``:684``)."""
    if _placement("spmm_ragged_presplit", step_g, group_ptr, starts, ah, al, b) == "cpu":
        return spmm_ragged_presplit_plain(step_g, group_ptr, starts, ah, al, b)
    c = _ragged("spmm_ragged_presplit", "crp_ragged_presplit", step_g, group_ptr,
                starts, (ah, al), b, min_b_rows, torch.bfloat16, torch.float32,
                torch.float32)
    spmm_ragged_presplit.launches += 1
    return c


spmm_ragged_presplit.launches = 0


def spmm_ragged_bf16(step_g, group_ptr, starts, ah, bh, *, min_b_rows: int):
    """One-pass bf16 ragged SpMM: (G*TM, n) fp32 from bf16 ``ah`` and bf16
    ``bh``.  Replaces ``spmm_ragged_bf16`` (``spmm_ragged.py:888``, kernel
    ``_ragged_kernel_bf16`` ``:727``)."""
    if _placement("spmm_ragged_bf16", step_g, group_ptr, starts, ah, bh) == "cpu":
        return spmm_ragged_bf16_plain(step_g, group_ptr, starts, ah, bh)
    c = _ragged("spmm_ragged_bf16", "crp_ragged_bf16", step_g, group_ptr, starts,
                (ah,), bh, min_b_rows, torch.bfloat16, torch.bfloat16,
                torch.float32)
    spmm_ragged_bf16.launches += 1
    return c


spmm_ragged_bf16.launches = 0


def spmm_ragged(step_g, group_ptr, starts, panels, b, *, min_b_rows: int):
    """fp32 or fp64 ragged SpMM (FMA, no TF32): (G*TM, n) in the panels'
    dtype.  Replaces ``spmm_ragged`` (``spmm_ragged.py:817``, kernel
    ``_ragged_kernel`` ``:633``)."""
    if _placement("spmm_ragged", step_g, group_ptr, starts, panels, b) == "cpu":
        return spmm_ragged_plain(step_g, group_ptr, starts, panels, b)
    if panels.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"spmm_ragged: panels must be fp32 or fp64, not {panels.dtype}")
    entry = "crp_ragged_f32" if panels.dtype == torch.float32 else "crp_ragged_f64"
    c = _ragged("spmm_ragged", entry, step_g, group_ptr, starts, (panels,), b,
                min_b_rows, panels.dtype, panels.dtype, panels.dtype)
    spmm_ragged.launches += 1
    return c


spmm_ragged.launches = 0

SPILL_MODES = {"highest": 0, "x3": 1, "default": 2}


def _check_block_args(name, M, rel, cols, vals, blk, blk_ptr, b, c=None):
    """Validate the block-step arrays of the spill and gather kernels;
    returns (nblk, TMo, Q, n)."""
    n = b.shape[1]
    ns, _, Q = rel.shape
    nblk = blk_ptr.shape[0] - 1
    checks = [
        (rel, "rel", (ns, 1, Q), torch.int32), (cols, "cols", (ns, Q), torch.int32),
        (vals, "vals", (ns, Q), torch.float32), (blk, "blk", (ns,), torch.int32),
        (blk_ptr, "blk_ptr", (nblk + 1,), torch.int32),
        (b, "b", (b.shape[0], n), torch.float32),
    ]
    if c is not None:
        checks.append((c, "c", (M, n), torch.float32))
    for arr, label, shape, dt in checks:
        if arr.dtype != dt or tuple(arr.shape) != shape or not arr.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous {dt} of shape "
                             f"{shape}; got {arr.dtype} {tuple(arr.shape)}")
    if nblk < 1 or M % nblk or M // nblk > 1024:
        raise ValueError(f"{name}: M={M} is not {nblk} blocks of at most 1024 rows")
    return nblk, M // nblk, Q, n


def spmm_spill(c, rel, cols, vals, blk, blk_ptr, b, mxu_precision="highest"):
    """C plus the spilled nonzeros, fp32: for each TMo-row output block and
    its consecutive steps, ``C[blk*TMo + rel[q]] += vals[q] * B[cols[q]]``
    over the live slots (``rel < TMo``), rounded as at ``mxu_precision``.
    Returns a new (M, n) tensor.  The kernel's sum order within a row varies
    from run to run (shared-memory atomics).  Replaces ``spmm_spill_pallas``
    (``spmm_ragged.py:1107``, kernel ``_spill_block_kernel`` ``:1047``)."""
    name = "spmm_spill"
    if mxu_precision not in SPILL_MODES:
        raise ValueError(f"{name}: unknown mxu_precision {mxu_precision!r}")
    if _placement(name, c, rel, cols, vals, blk, blk_ptr, b) == "cpu":
        return spmm_spill_plain(c, rel, cols, vals, blk, blk_ptr, b, mxu_precision)
    nblk, TMo, Q, n = _check_block_args(name, c.shape[0], rel, cols, vals, blk,
                                        blk_ptr, b, c)
    out = torch.empty_like(c)
    _launch(
        "crp_spill_blocks",
        (rel.data_ptr(), cols.data_ptr(), vals.data_ptr(), blk_ptr.data_ptr(),
         c.data_ptr(), b.data_ptr(), out.data_ptr()),
        (nblk, TMo, Q, n, SPILL_MODES[mxu_precision]), b.device,
    )
    spmm_spill.launches += 1
    return out


spmm_spill.launches = 0


def spmm_gather(rel, cols, vals, blk, blk_ptr, b, M, mxu_precision="highest"):
    """Every packed nonzero as a new (M, n) fp32 product: for each TMo-row
    output block, ``C[blk*TMo + rel[q]] = sum of vals[q] * B[cols[q]]`` over
    its live slots, rounded as at ``mxu_precision``; a block with no live
    slot comes out zero.  The spill kernel with no C operand; its sum order
    within a row varies from run to run.  Replaces ``spmm_gather_chunked``
    (``spmm_ragged.py:1254``, kernel ``_spill_block_kernel`` ``:1047`` with
    ``has_c=False``)."""
    name = "spmm_gather"
    if mxu_precision not in SPILL_MODES:
        raise ValueError(f"{name}: unknown mxu_precision {mxu_precision!r}")
    if _placement(name, rel, cols, vals, blk, blk_ptr, b) == "cpu":
        return spmm_gather_plain(rel, cols, vals, blk, blk_ptr, b, M, mxu_precision)
    nblk, TMo, Q, n = _check_block_args(name, M, rel, cols, vals, blk, blk_ptr, b)
    out = torch.empty((M, n), dtype=torch.float32, device=b.device)
    _launch(
        "crp_gather_blocks",
        (rel.data_ptr(), cols.data_ptr(), vals.data_ptr(), blk_ptr.data_ptr(),
         b.data_ptr(), out.data_ptr()),
        (nblk, TMo, Q, n, SPILL_MODES[mxu_precision]), b.device,
    )
    spmm_gather.launches += 1
    return out


spmm_gather.launches = 0

KERNELS = (spmm_ragged_presplit, spmm_ragged_bf16, spmm_ragged, spmm_spill,
           spmm_gather)
