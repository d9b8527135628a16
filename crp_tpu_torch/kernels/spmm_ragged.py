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

  * :func:`spmm_ragged_presplit` — ``x3`` on the ``wgmma`` body fed by TMA
    (``csrc/ragged.cu``, ``csrc/x3_wgmma.cuh``), each group walking its
    chunks;
  * :func:`spmm_ragged_bf16` — ``default``, the same body's one-pass mode
    (``csrc/ragged.cu``);
  * :func:`spmm_ragged` — ``highest``: on fp32 the panels' TF32 planes
    (split once when they are packed) as three TF32 tensor-core products,
    the ``wgmma`` body's TF32 mode with the same walk
    (``csrc/ragged.cu``), fp64 panels on the FP64 tensor cores (#11's DMMA
    body with its ragged walk, ``csrc/dd_tc.cu``);
  * :func:`spmm_spill` — C plus the spilled nonzeros, fp32
    (``csrc/spill.cu``), on a row-ordered view of the pack
    (:func:`spill_row_view`, built at init) in a fixed sum order;
  * :func:`spmm_gather` — the same row body with no C, fp32
    (``csrc/spill.cu``).  The JAX wrapper ``spmm_gather_chunked`` splits
    its steps into chunks under ``CRP_TPU_GATHER_GB`` because XLA
    materializes ``take(b, cols)`` as a (steps * Q, n) stream; the CUDA
    kernel reads ``B[cols[q]]`` itself, so nothing is materialized and
    one launch takes every row.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
its ``launches`` attribute; for CPU tensors it runs its plain PyTorch
version (``*_plain``), which is also what the kernel is checked against on
the card.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading

import numpy as np
import torch

from .spmm_pallas import (
    PLAIN_BLOCK_BYTES, TK, UnsupportedSparsity, _check_aligned, _placement,
    bf16_product, full_product, plain_blocks, presplit_product, tf32_product,
)
from .spmm_segsum import spmm_segment_sum

# the JAX defaults of the environment knobs this module turns into arguments
PANEL_CAP_BYTES = 8 << 30         # CRP_TPU_RAGGED_PANEL_GB = 8
RAGGED_TM, RAGGED_WC = 128, 512   # CRP_TPU_RAGGED_TM / _WC
SPILL_TMO, SPILL_Q = 512, 512     # CRP_TPU_SPILL_TMO / _Q
# the most slots of one row that one warp of the spill and gather kernels
# takes (an item of spill_row_view); a longer row is split into items whose
# partials are added in item order
ROW_ITEM_SLOTS = 256
# the most rows with no slot that one item of spill_row_view covers (their
# C rows copied, or zeros written, a few at a time)
ROW_RUN = 16
# the columns of one unit of work of those kernels (spill.cu RW_TILE)
ROW_TILE = 128
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


# (S, spill, G) of each (TM, Wc) candidate cover the geometry chooser has
# priced, by a digest of the shard's rowptr and colidx: an engine init at
# another operating point, or another engine on the same matrix, prices the
# same covers again (about 30 s on a scrambled 10.8M-nnz graph).  The
# values are a pure function of the key, so the memo changes no decision.
_COVER_MEMO: collections.OrderedDict = collections.OrderedDict()
_COVER_MEMO_SIZE = 16
_COVER_MEMO_LOCK = threading.Lock()


def _sparsity_key(rowptr: np.ndarray, colidx: np.ndarray) -> tuple:
    rowptr = np.ascontiguousarray(rowptr, dtype=np.int64)
    nnz = int(rowptr[-1]) - int(rowptr[0])
    h = hashlib.blake2b(digest_size=16)
    h.update(rowptr.view(np.uint8))
    h.update(np.ascontiguousarray(colidx[int(rowptr[0]):int(rowptr[-1])],
                                  dtype=np.int64).view(np.uint8))
    return len(rowptr), nnz, h.digest()


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
    geometry.  Each candidate's cover is priced once per sparsity pattern
    (``_COVER_MEMO``)."""
    nnz = int(rowptr[-1]) - int(rowptr[0])
    cands = [(tm, wc) for tm in (128, 256, 512) for wc in (128, 256, 512)]
    if nnz > 30_000_000:  # bound the host-side cover sweep on huge shards
        cands = [(128, 512), (256, 256), (512, 128), (512, 256)]
    if small:
        cands = [(tm, wc) for tm, wc in cands if wc <= 256]
    key = _sparsity_key(rowptr, colidx)
    with _COVER_MEMO_LOCK:
        priced = dict(_COVER_MEMO.get(key, {}))
    sorted_by_tm = {}
    for tm, wc in cands:
        if (tm, wc) in priced:
            continue
        if tm not in sorted_by_tm:  # one sort per TM serves every Wc
            sorted_by_tm[tm] = _GroupCols(rowptr, colidx, tm)
        chunks = _raw_cover(sorted_by_tm[tm], wc)
        S, spill = _apply_threshold(chunks, default_min_chunk_nnz(tm, wc))[::2]
        priced[(tm, wc)] = (S, spill, sorted_by_tm[tm].G)
    with _COVER_MEMO_LOCK:
        _COVER_MEMO[key] = priced
        _COVER_MEMO.move_to_end(key)
        while len(_COVER_MEMO) > _COVER_MEMO_SIZE:
            _COVER_MEMO.popitem(last=False)
    best, best_t = cands[0], float("inf")
    for tm, wc in cands:
        S, spill, G = priced[(tm, wc)]
        t = _model_time(S, spill, G, tm, wc, mxu_precision, n_ref)
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


# ---------------------------------------------------- the row-ordered view


def spill_row_view(rel, cols, vals, blk, M: int, TMo: int, L: int = ROW_ITEM_SLOTS,
                   run: int = ROW_RUN):
    """The row-ordered view of one shard's block-step pack (the fused
    spill's or the gather kind's), which the spill and gather kernels read
    in its place; built with torch ops on the pack's device.

    The live slots (``rel < TMo``; pad slots never appear) go to output row
    ``blk * TMo + rel``, stably sorted by row, so that within a row they
    keep the pack's order.  Returns ``(vcols (Z,) int32, vvals (Z,) fp32,
    items (I + 1, 4) int32, parts (P,) int32)``.  Item i is ``(row, first
    slot, part, part0)`` and holds the slots ``[items[i, 1], items[i + 1,
    1])``, at most ``L``, all of ``row``; the items are in row order and
    cover the ``M`` rows once: a row with slots has one item (``part`` and
    ``part0`` -1) or several, which number their partials ``part0, part0 +
    1, ...`` (``part`` the item's own); rows with no slot come in runs of
    at most ``run``, an item with no slot for the ``-part0`` rows from
    ``row`` on (``part`` -1).  The last item is a sentinel ``(-1, Z, -1,
    -1)``.  ``parts[p]`` is how many partials the row of partial p has."""
    dev = cols.device
    r = rel.reshape(cols.shape)
    live = r < TMo
    key = (blk.long()[:, None] * TMo + r.long())[live]
    key, order = torch.sort(key, stable=True)
    vcols = cols[live][order].to(torch.int32).contiguous()
    vvals = vals[live][order].to(torch.float32).contiguous()
    Z = key.numel()
    cnt = torch.bincount(key, minlength=M)[:M]
    row_ptr = torch.zeros(M + 1, dtype=torch.int64, device=dev)
    torch.cumsum(cnt, 0, out=row_ptr[1:])
    # runs of rows with no slot: a run starts where a row with none follows
    # one with slots (or row 0), and again every `run` rows
    rows = torch.arange(M, device=dev)
    empty = cnt == 0
    starts = empty & ~torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), empty[:-1]])
    seg = (torch.cumsum(starts.long(), 0) - 1).clamp(min=0)  # rows with slots: any
    pad = torch.zeros(1, dtype=torch.int64, device=dev)  # where no row is empty
    seg_first = torch.cat([rows[starts], pad])
    seg_end = seg_first + torch.bincount(seg[empty], minlength=seg_first.numel())
    head = empty & ((rows - seg_first[seg]) % run == 0)
    run_len = torch.clamp(seg_end[seg] - rows, max=run)
    n_items = torch.where(empty, head.long(), (cnt + L - 1) // L)
    item0 = torch.zeros(M + 1, dtype=torch.int64, device=dev)
    torch.cumsum(n_items, 0, out=item0[1:])
    row = torch.repeat_interleave(rows, n_items)
    rank = torch.arange(row.numel(), device=dev) - item0[row]
    first = row_ptr[row] + rank * L
    hub = n_items[row] > 1
    part = torch.where(hub, torch.cumsum(hub.long(), 0) - 1, -1)
    part0 = torch.where(hub, part - rank, torch.where(empty[row], -run_len[row], -1))
    items = torch.stack([row, first, part, part0], 1)
    sentinel = torch.tensor([[-1, Z, -1, -1]], dtype=torch.int64, device=dev)
    items = torch.cat([items, sentinel]).to(torch.int32).contiguous()
    parts = n_items[row[hub]].to(torch.int32).contiguous()
    return vcols, vvals, items, parts


def row_view_sizes(views) -> list:
    """The longest of each of the views' four arrays."""
    return [max(v[k].shape[0] for v in views) for k in range(4)]


def row_view_sizes_of_counts(cnt: np.ndarray, M: int, L: int = ROW_ITEM_SLOTS,
                             run: int = ROW_RUN) -> list:
    """The lengths of :func:`spill_row_view`'s four arrays from the live
    slots of each of its first rows alone (``cnt``, rows past it none),
    without the pack: Z slots, an item per ``L`` slots of a row and per
    ``run`` rows of each run of rows with no slot, the sentinel, and the
    items of the rows of several."""
    cnt = np.zeros(M, np.int64) if cnt.size == 0 else np.asarray(cnt, np.int64)
    cnt = np.concatenate([cnt, np.zeros(M - cnt.size, np.int64)])
    n_items = -(-cnt // L)
    empty = cnt == 0
    # runs of rows with no slot: their lengths from where each starts and ends
    edges = np.diff(np.concatenate([[0], empty.astype(np.int8), [0]]))
    runs = np.flatnonzero(edges == -1) - np.flatnonzero(edges == 1)
    n_run_items = int((-(-runs // run)).sum())
    return [int(cnt.sum()), int(cnt.sum()), int(n_items.sum()) + n_run_items + 1,
            int(n_items[n_items > 1].sum())]


def stack_row_views(views, sizes=None) -> tuple:
    """Per-shard views of :func:`spill_row_view` with a leading shard axis,
    each padded to the longest (or to ``sizes``, the longest of a stacked
    pack whose other shards are held elsewhere): slots with column 0 and
    value 0 (no item reaches them), items that repeat the shard's sentinel
    (row -1, no slot), partials of count 1 (none is referenced)."""
    if sizes is None:
        if len(views) == 1:
            return tuple(x[None] for x in views[0])
        sizes = row_view_sizes(views)
    out = []
    for k, fill in enumerate((0, 0.0, None, 1)):
        size = sizes[k]
        rows = []
        for v in views:
            x = v[k]
            if fill is None:  # items: the sentinel row repeated
                pad = x[-1:].expand(size - x.shape[0], 4)
            else:
                pad = torch.full((size - x.shape[0],), fill, dtype=x.dtype, device=x.device)
            rows.append(torch.cat([x, pad]))
        out.append(torch.stack(rows).contiguous())
    return tuple(out)


def spill_rows_ordered(c, view, b, M: int, mxu_precision: str = "highest"):
    """The spill (``c`` given) or the gather (``c`` None) summed in the
    order of the CUDA kernels, on any device, bit for bit their result:
    each item's partial is ``0 + contrib(first slot) + contrib(next) +
    ...`` in fp32; a row of one item is ``C + partial`` (the gather: the
    partial), a row of several ``C + (0 + p0 + p1 + ...)``, its partials in
    item order; a row with no slot C itself (the gather: zero)."""
    vcols, vvals, items, parts = view
    n = b.shape[1]
    it = items.long()
    row, first, part, part0 = it[:-1].unbind(1)
    length = it[1:, 1] - first
    real = row >= 0
    acc = torch.zeros((row.numel(), n), dtype=torch.float32, device=b.device)
    for k in range(int(length.max()) if length.numel() else 0):
        sel = torch.nonzero(length > k).squeeze(1)
        q = first[sel] + k
        acc[sel] = acc[sel] + spill_contrib(vvals[q], b[vcols[q].long()], mxu_precision)
    out = (c.clone() if c is not None
           else torch.zeros((M, n), dtype=torch.float32, device=b.device))
    one = torch.nonzero(real & (part < 0) & (length > 0)).squeeze(1)
    if c is not None:
        out[row[one]] = out[row[one]] + acc[one]
    else:
        out[row[one]] = acc[one]
    heads = torch.nonzero(real & (part >= 0) & (part == part0)).squeeze(1)
    if heads.numel():
        np_ = parts.long()[part0[heads]]
        tot = torch.zeros((heads.numel(), n), dtype=torch.float32, device=b.device)
        for q in range(int(np_.max())):
            sel = torch.nonzero(np_ > q).squeeze(1)
            tot[sel] = tot[sel] + acc[heads[sel] + q]
        rows = row[heads]
        out[rows] = (out[rows] + tot) if c is not None else tot
    return out


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
    """fp32 / fp64 ragged SpMM in plain PyTorch (no TF32), on the panels
    or, fp32 at ``highest``, on their TF32 planes ``(big, small)`` (the
    same function: the fp32 panels rebuilt a block at a time, bit for
    bit)."""
    G = group_ptr.shape[0] - 1
    if isinstance(panels, tuple):
        return plain_blocks(step_g, starts, panels[0], b, G, torch.float32,
                            tf32_product(panels[0]))
    return plain_blocks(step_g, starts, panels, b, G, panels.dtype, full_product(panels))


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


def spmm_spill_plain(c, rel, cols, vals, blk, TMo, b, mxu_precision="highest",
                     view=None):
    """C plus the spilled nonzeros in plain PyTorch: every live slot
    (``rel < TMo``) adds its rounded ``val * B[col]`` to row
    ``blk * TMo + rel`` of a copy of ``c``, in bounded blocks of steps, by
    ``index_add_``, whose order of adds is its own: the kernel is held to
    it at 1e-6 relative Frobenius, and to :func:`spill_rows_ordered` bit
    for bit.  ``view`` (the kernel's) is not read."""
    n = c.shape[1]
    ns, _, Q = rel.shape
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


def spmm_gather_plain(rel, cols, vals, blk, TMo, b, M, mxu_precision="highest",
                      view=None):
    """Every packed nonzero as an (M, n) fp32 product in plain PyTorch:
    :func:`spmm_spill_plain` onto a zero C."""
    c = torch.zeros((M, b.shape[1]), dtype=torch.float32, device=b.device)
    return spmm_spill_plain(c, rel, cols, vals, blk, TMo, b, mxu_precision)


def spmm_spill_chunked(rows, cols, vals, b, nrow: int):
    """The spilled nonzeros as an (nrow, n) product in plain PyTorch
    (``spmm_ragged.py:1311-1371``, an XLA op there too): the ``segsum``
    kind's fixed-order sum, :func:`~.spmm_segsum.spmm_segment_sum`.  Rows
    are sorted; pad rows == ``nrow`` are dropped.  Serves fp64 packs and
    sparse spills, where the fused kernel does not run."""
    return spmm_segment_sum(rows, cols, vals, nrow, b)


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
    and fp32 ``b``, on the ``wgmma`` body of :func:`spmm_window_sg_presplit`
    walking each group's chunks (the panels must start on 16 bytes: TMA).
    Replaces ``spmm_ragged_presplit`` (``spmm_ragged.py:859``, kernel
    ``_ragged_kernel_presplit`` ``:684``)."""
    if _placement("spmm_ragged_presplit", step_g, group_ptr, starts, ah, al, b) == "cpu":
        return spmm_ragged_presplit_plain(step_g, group_ptr, starts, ah, al, b)
    _check_aligned("spmm_ragged_presplit", ah=ah, al=al)
    c = _ragged("spmm_ragged_presplit", "crp_ragged_presplit", step_g, group_ptr,
                starts, (ah, al), b, min_b_rows, torch.bfloat16, torch.float32,
                torch.float32)
    spmm_ragged_presplit.launches += 1
    return c


spmm_ragged_presplit.launches = 0


def spmm_ragged_bf16(step_g, group_ptr, starts, ah, bh, *, min_b_rows: int):
    """One-pass bf16 ragged SpMM: (G*TM, n) fp32 from bf16 ``ah`` and bf16
    ``bh``, on the ``wgmma`` body's one-pass mode (:func:`spmm_window_sg_bf16`'s)
    walking each group's chunks (``ah`` must start on 16 bytes: TMA).
    Replaces ``spmm_ragged_bf16`` (``spmm_ragged.py:888``, kernel
    ``_ragged_kernel_bf16`` ``:727``)."""
    if _placement("spmm_ragged_bf16", step_g, group_ptr, starts, ah, bh) == "cpu":
        return spmm_ragged_bf16_plain(step_g, group_ptr, starts, ah, bh)
    _check_aligned("spmm_ragged_bf16", ah=ah)
    c = _ragged("spmm_ragged_bf16", "crp_ragged_bf16", step_g, group_ptr, starts,
                (ah,), bh, min_b_rows, torch.bfloat16, torch.bfloat16,
                torch.float32)
    spmm_ragged_bf16.launches += 1
    return c


spmm_ragged_bf16.launches = 0


def spmm_ragged(step_g, group_ptr, starts, panels, b, *, min_b_rows: int):
    """fp32 or fp64 ragged SpMM: (G*TM, n) in the panels' dtype.  On fp32
    ``panels`` are the TF32 planes ``(big, small)`` of the ``highest`` pack
    (each ``(S, TM, Wc)``; on the CPU the fp32 panels too), and run as
    three TF32 tensor-core products on the ``wgmma`` body's TF32 mode with
    the ragged walk (:func:`spmm_window`'s at ``highest``: on a uniform
    pack written as a ragged pack, one chunk a group, the two equal each
    other bit for bit), held to the fp32 plain version; fp64 on the FP64
    tensor cores, the DMMA body of
    :func:`~crp_tpu_torch.kernels.spmm_dd_mxu.spmm_ragged_dd` (#11) walking
    each group's chunks in ``group_ptr`` order, k upward: a launch equals
    the next bit for bit, and on a ``dd_mxu`` pack equals #11.  Both bodies
    copy the panels in 16-byte pieces (TMA for the planes), so they must
    start on 16 bytes; TM % 128 and Wc % 32 must be 0.  Bound by the
    products (fp32: 3 x 2 S TM Wc n at 495 TFLOP/s; fp64: 2 S TM Wc n at 67
    TFLOP/s).  Replaces ``spmm_ragged`` (``spmm_ragged.py:817``, kernel
    ``_ragged_kernel`` ``:633``)."""
    planes = panels if isinstance(panels, tuple) else (panels,)
    if _placement("spmm_ragged", step_g, group_ptr, starts, *planes, b) == "cpu":
        return spmm_ragged_plain(step_g, group_ptr, starts, panels, b)
    dtype = planes[0].dtype
    if (dtype, len(planes)) not in ((torch.float32, 2), (torch.float64, 1)):
        raise ValueError(f"spmm_ragged: the panels must be fp64, or on fp32 the TF32 "
                         f"planes (big, small) of the highest pack, each (S, TM, Wc) "
                         f"(device_pack.tf32_pair); got {len(planes)} x {dtype}")
    _check_aligned("spmm_ragged", **dict(zip(("big", "small") if len(planes) == 2
                                              else ("panels",), planes)))
    entry = "crp_ragged_f32" if dtype == torch.float32 else "crp_ragged_f64"
    c = _ragged("spmm_ragged", entry, step_g, group_ptr, starts, planes, b,
                min_b_rows, dtype, dtype, dtype)
    spmm_ragged.launches += 1
    return c


spmm_ragged.launches = 0

SPILL_MODES = {"highest": 0, "x3": 1, "default": 2}


def _check_block_args(name, M, TMo, rel, cols, vals, blk, b, c=None):
    """Validate the block-step pack that the spill and gather wrappers take
    (their plain versions read it, their kernels its view), B and C;
    returns the pack's slot count."""
    n = b.shape[1]
    ns, _, Q = rel.shape
    checks = [
        (rel, "rel", (ns, 1, Q), torch.int32), (cols, "cols", (ns, Q), torch.int32),
        (vals, "vals", (ns, Q), torch.float32), (blk, "blk", (ns,), torch.int32),
        (b, "b", (b.shape[0], n), torch.float32),
    ]
    if c is not None:
        checks.append((c, "c", (M, n), torch.float32))
    for arr, label, shape, dt in checks:
        if arr.dtype != dt or tuple(arr.shape) != shape or not arr.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous {dt} of shape "
                             f"{shape}; got {arr.dtype} {tuple(arr.shape)}")
    if TMo < 1 or M % TMo:
        raise ValueError(f"{name}: M={M} is not a whole number of {TMo}-row blocks")
    return ns * Q


def _check_view(name, view, M, slots):
    """Validate the row-ordered view (:func:`spill_row_view`) the spill and
    gather kernels read against the pack of ``slots`` slots it was built
    from; returns (item count, partial count).  Its contents are not read
    back from the card: the kernel skips an item whose row is not below M,
    and stops a run of rows at M."""
    if view is None or len(view) != 4:
        raise ValueError(f"{name}: on the card it reads the pack's row-ordered "
                         f"view (spill_row_view), which was not given")
    vcols, vvals, items, parts = view
    z = vcols.shape[0] if vcols.dim() == 1 else -1
    checks = ((vcols, "vcols", (z,), torch.int32), (vvals, "vvals", (z,), torch.float32),
              (items, "items", (items.shape[0], 4), torch.int32),
              (parts, "parts", (parts.shape[0],), torch.int32))
    for arr, label, shape, dt in checks:
        if arr.dtype != dt or tuple(arr.shape) != shape or not arr.is_contiguous():
            raise ValueError(f"{name}: view {label} must be contiguous {dt} of shape "
                             f"{shape}; got {arr.dtype} {tuple(arr.shape)}")
    if z > slots:
        raise ValueError(f"{name}: the view has {z} slots, its pack only {slots}")
    if items.shape[0] - 1 < -(-M // ROW_RUN):
        raise ValueError(f"{name}: the view has {items.shape[0] - 1} items for {M} "
                         f"rows; an item covers at most {ROW_RUN}")
    if items.data_ptr() % 16:
        raise ValueError(f"{name}: view items must start on 16 bytes")
    return items.shape[0] - 1, parts.shape[0]


def _rows(name, entry, c, view, b, M, slots, mode):
    """Launch ``entry`` on the view of a pack of ``slots`` slots; returns
    the new (M, n) output."""
    n_items, P = _check_view(name, view, M, slots)
    n = b.shape[1]
    vcols, vvals, items, parts = view
    out = torch.empty((M, n), dtype=torch.float32, device=b.device)
    work = torch.empty((P, n), dtype=torch.float32, device=b.device)
    # one arrival count a hub row and column tile, zero at every launch
    counters = torch.zeros(P * -(-n // ROW_TILE), dtype=torch.int32, device=b.device)
    c_ptr = () if c is None else (c.data_ptr(),)
    _launch(
        entry,
        (vcols.data_ptr(), vvals.data_ptr(), items.data_ptr(), parts.data_ptr(), *c_ptr,
         b.data_ptr(), out.data_ptr(), work.data_ptr(), counters.data_ptr()),
        (n_items, M, n, mode), b.device,
    )
    return out


def spmm_spill(c, rel, cols, vals, blk, TMo, b, mxu_precision="highest", view=None):
    """C plus the spilled nonzeros, fp32: for each TMo-row output block and
    its consecutive steps, ``C[blk*TMo + rel[q]] += vals[q] * B[cols[q]]``
    over the live slots (``rel < TMo``), rounded as at ``mxu_precision``.
    Returns a new (M, n) tensor.  On the card the kernel reads the pack's
    row-ordered ``view`` (:func:`spill_row_view`, required there) and sums
    in a fixed order, the same at every launch (:func:`spill_rows_ordered`
    emulates it).  Replaces ``spmm_spill_pallas`` (``spmm_ragged.py:1107``,
    kernel ``_spill_block_kernel`` ``:1047``)."""
    name = "spmm_spill"
    if mxu_precision not in SPILL_MODES:
        raise ValueError(f"{name}: unknown mxu_precision {mxu_precision!r}")
    view_t = tuple(view) if view is not None else ()
    if _placement(name, c, rel, cols, vals, blk, b, *view_t) == "cpu":
        return spmm_spill_plain(c, rel, cols, vals, blk, TMo, b, mxu_precision)
    slots = _check_block_args(name, c.shape[0], TMo, rel, cols, vals, blk, b, c)
    out = _rows(name, "crp_spill_blocks", c, view, b, c.shape[0], slots,
                SPILL_MODES[mxu_precision])
    spmm_spill.launches += 1
    return out


spmm_spill.launches = 0


def spmm_gather(rel, cols, vals, blk, TMo, b, M, mxu_precision="highest", view=None):
    """Every packed nonzero as a new (M, n) fp32 product: for each TMo-row
    output block, ``C[blk*TMo + rel[q]] = sum of vals[q] * B[cols[q]]`` over
    its live slots, rounded as at ``mxu_precision``; a row with no live slot
    comes out zero.  The spill kernel with no C operand, on the pack's
    row-ordered ``view`` (required on the card), in the same fixed order.
    Replaces ``spmm_gather_chunked`` (``spmm_ragged.py:1254``, kernel
    ``_spill_block_kernel`` ``:1047`` with ``has_c=False``)."""
    name = "spmm_gather"
    if mxu_precision not in SPILL_MODES:
        raise ValueError(f"{name}: unknown mxu_precision {mxu_precision!r}")
    view_t = tuple(view) if view is not None else ()
    if _placement(name, rel, cols, vals, blk, b, *view_t) == "cpu":
        return spmm_gather_plain(rel, cols, vals, blk, TMo, b, M, mxu_precision)
    slots = _check_block_args(name, M, TMo, rel, cols, vals, blk, b)
    out = _rows(name, "crp_gather_blocks", None, view, b, M, slots,
                SPILL_MODES[mxu_precision])
    spmm_gather.launches += 1
    return out


spmm_gather.launches = 0

KERNELS = (spmm_ragged_presplit, spmm_ragged_bf16, spmm_ragged, spmm_spill,
           spmm_gather)
