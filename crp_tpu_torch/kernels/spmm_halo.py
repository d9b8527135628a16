"""Fused halo exchange + windowed SpMM for the multi-shard engines.

Counterpart of ``crp_tpu/kernels/spmm_halo.py``.  On a TPU every shard is
a chip, and one kernel per shard pushes each owned 128-row chunk of B into
the window buffers of the shards that read it (remote DMA) while it runs
the windowed product, gated on per-owner arrival semaphores.  The port's
kernel (``csrc/halo.cu``) pulls instead: each row group reads its window
straight from the owner shards' rows, through the plan's chunk table of
(owner, row) pairs resolved against the p owners' base pointers into one
row pointer a chunk (:func:`chunk_rows`; on one card
:func:`stacked_chunk_rows`, each launch).  No receive buffer is built and
nothing is copied.

On one card (an engine without a mesh) the p owners are the shards of the
stacked B, one launch runs every shard's groups, and stream order stands
where the TPU kernel has its barrier and semaphores.  Across processes (an
engine on a :class:`~crp_tpu_torch.shard.layout.RankMesh`, one rank a
shard) each rank owns one B buffer and two flag words, allocated once and
mapped into every peer by CUDA IPC (:class:`HaloPeers`); a rank's launch
runs its own shard's groups over the p mapped buffers, and flags in peer
memory order the ranks where the TPU kernel has its semaphores, with no
host barrier and no stream drain between launches:

* the barrier before the pushes (``spmm_halo.py:215-226``): before a rank
  overwrites its B (:meth:`HaloPeers.load`) a one-thread kernel waits on
  the stream until every rank that reads its rows (the plan's
  ``readers``, JAX's ``exp_from > 0``) has finished as many launches as
  it has;
* the arrival semaphores (``:228-296``): once B is written, a one-thread
  kernel sets the rank's arrive word to its load count with a
  system-scope release, and the kernel waits, a block at a time, for each
  owner's arrive word before its first read of that owner's rows;
* the send drain (``:336-346``): a trailing one-block kernel on the same
  stream sets the rank's done word to its launch count once every block
  has read its owners' rows.  It trails the launch rather than counting
  blocks in the kernel (a last-block pattern): the shared tile bodies keep
  their blocks free of an atomic and a fence, and only a kernel after
  every block can turn all of C into NaN when a wait gave up.

Every wait is bounded in wall time (``HaloPeers.bound_s``); one that gives
up writes the rank's status word, C comes out NaN, and the next host sync
point (the engine's ``exec`` or ``unshard_c``, the next load, ``close``)
raises :class:`HaloTimeout`.  The one-card and the cross-process kernels
are one body and one build; the waits are a template flag.

The plan is the JAX plan: the B ownership boundaries rounded to 128 rows
(:func:`align_displs`), one uniform window pack per shard over the global
columns with non-decreasing window starts (else
:class:`UnsupportedSparsity`, and the engines take the unfused ``pallas``
path), panels at a shared chunk-exact W, and the push lists, which the
plain version replays and the audit counts.  The panels are densified on
the device: on fp32 at ``x3`` straight to the bf16 hi/lo pair, and at
``default`` to the hi plane alone, the RNE split and rounding the TPU
kernel makes of its fp32 panels on every read (TMA, which feeds the
``wgmma`` body, can do neither; two bf16 planes are the bytes of one fp32
plane, the hi plane half of them); at ``highest`` to the TF32 big and
small planes, two fp32 tensors (``device_pack.tf32_operands``: the
tensor cores read the top 19 bits of an fp32 operand, so the split the
TPU kernel makes on every read is made once here, at twice the fp32
panels' bytes); fp64 panels stay fp64.

:func:`spmm_halo` launches the kernel for CUDA tensors and counts the
launch in its ``launches`` attribute; for CPU tensors it runs
:func:`spmm_halo_plain`: the pushes as one gather into per-shard window
buffers, then the windowed product of :func:`spmm_window_plain` (across
processes the owners' rows come first by an ``all_gather`` on the group).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import device_pack
from .spmm_pallas import (
    TK, UnsupportedSparsity, _check_aligned, _placement, choose_chunks,
    spmm_window_plain, window_entry, window_extents,
)


# the JAX plan's cap on one shard's dense window panels (pack_window_dense's),
# priced in the data's dtype whatever the plan holds
PANEL_CAP_BYTES = 8 << 30


def align_displs(displs: np.ndarray, k: int) -> np.ndarray:
    """Round interior ownership boundaries to TK multiples (monotone)
    (``spmm_halo.py:94-99``)."""
    d = (np.asarray(displs, dtype=np.int64) + TK // 2) // TK * TK
    d[0] = 0
    d[-1] = k
    return np.maximum.accumulate(d)


@dataclasses.dataclass
class HaloOp:
    """The ``pallas_halo`` kind's op over every shard at once.

    Its arrays are ``(ws, ws_rel, panels, push, chunk_src)``: the global
    window starts (s, G) int32 the kernel reads; the starts relative to
    each shard's window base, and the push list (P, 4) int32 of (owner,
    owner row, consumer, buffer row), which the plain version reads; the
    (s, G, TM, W) panels, on fp32 at ``x3`` the two bf16 planes ``ah,
    al`` in their place, at ``default`` the bf16 hi plane ``ah`` and at
    ``highest`` the two fp32 TF32 planes ``big, small``; and
    the chunk table (nchunks, 2) int32: each global 128-row chunk's
    (owner, row in the owner's shard), owner -1 past the matrix.  s is
    the shards packed here: all p, or one rank's (``ranks``).  ``p``: the
    owners; ``ranks``: the shards the arrays hold; ``buf_rows``: rows of
    the plain version's window buffers; ``min_b_rows``: rows each shard
    of B must have (``max_k``); ``B_displs``: the aligned ownership the
    engine shards B by; ``halo_rows_pushed``: the physical rows one exec
    moves, every push including a shard's own (``spmm_halo.py:75-78``);
    ``readers`` (p, p) bool: shard i's windows read owner j's rows (JAX's
    ``exp_from > 0``), which owner j waits on before it overwrites its B
    across processes.
    """

    precision: str
    TM: int
    G: int
    W: int
    buf_rows: int
    min_b_rows: int
    B_displs: np.ndarray
    halo_rows_pushed: int
    p: int
    ranks: tuple
    roofline: dict = dataclasses.field(default_factory=dict)
    readers: np.ndarray = None
    variant = "halo"

    @property
    def kernel(self):
        return spmm_halo

    @property
    def plain(self):
        return spmm_halo_plain

    @property
    def b_dtype(self):
        """The element type the kernel reads B in: bf16 on the hi plane
        (``default``), else the panels' own."""
        return torch.bfloat16 if self.roofline.get("b_itemsize") == 2 else None

    def kernel_args(self, arrs, b_shards) -> tuple:
        """Positional args of :attr:`kernel` and :attr:`plain` for the
        packed ``arrs`` and the stacked B shards (p, max_k, n): on the bf16
        hi plane, B cast to bf16 (RNE) once, as ``WindowOp`` casts it."""
        ws, ws_rel, *panels, push, chunk_src = arrs
        panels = tuple(panels) if len(panels) == 2 else panels[0]
        if not isinstance(panels, tuple) and panels.dtype == torch.bfloat16:
            b_shards = b_shards.to(torch.bfloat16)
        return (ws, ws_rel, panels, push, chunk_src, b_shards, self.precision,
                self.buf_rows)

    def __call__(self, arrs, b_shards, peers=None, dtype=None):
        """(s, G*TM, n) C shards; rows past a shard's own are zero.  With
        ``peers`` (across processes) ``b_shards`` is their buffer and C
        comes in ``dtype``."""
        c = self.kernel(*self.kernel_args(arrs, b_shards),
                        min_b_rows=self.min_b_rows, peers=peers)
        return c.to(dtype or b_shards.dtype)


def build_halo_plan(shards: list, B_displs: np.ndarray, *, device, dtype,
                    precision: str = "highest", TM: int = 256,
                    max_window: int = 16384, ranks=None) -> tuple:
    """Pack the panels and the exchange tables of the fused kernel
    (``build_halo_plan``, ``spmm_halo.py:102-182``) from per-shard CSR
    views with global column indices.  Returns ``(arrays, HaloOp)``;
    raises :class:`UnsupportedSparsity` where the JAX plan refuses: B
    boundaries not TK-aligned, an empty shard, a window over
    ``max_window`` rows, panels over 8 GiB, or window starts that fall.
    On fp32 at ``x3`` the panels are the bf16 pair (the arrays' ``ah,
    al``; ``roofline["a_bytes"]`` the same bytes as fp32 panels), at
    ``default`` the bf16 hi plane (half the bytes, and B counted in bf16),
    at ``highest`` the TF32 planes (``big, small``, twice the bytes); the 8
    GiB cap prices fp32 panels all the same, as JAX's plan does.
    ``ranks``: the shards whose window starts and panels are densified
    (one rank's across processes), all by default; the plan, the push
    list and the chunk table are always every shard's, and a rank's
    arrays equal its slice of the whole pack bit for bit."""
    B_displs = np.asarray(B_displs, dtype=np.int64)
    if np.any(B_displs[:-1] % TK):
        raise UnsupportedSparsity("halo kernel needs TK-aligned B displs")
    dt = np.dtype(dtype)
    if dt not in (np.float32, np.float64):
        raise UnsupportedSparsity(f"no halo kernel for dtype {dt}")
    k_glb = int(B_displs[-1])
    p = len(shards)
    ws_own, los, Ws, Gs = [], [], [], []
    for sh in shards:
        rowptr = np.ascontiguousarray(sh.rowptr, dtype=np.int64)
        if int(rowptr[-1]) == 0:
            raise UnsupportedSparsity("empty shard")
        min_t, W0 = window_extents(rowptr, sh.colidx, TM)
        if W0 > max_window:
            raise UnsupportedSparsity(f"window {W0} rows > cap {max_window}")
        W_i, _, _ = choose_chunks(W0)
        G_i = -(-(len(rowptr) - 1) // TM)
        if G_i * W_i * TM * dt.itemsize > PANEL_CAP_BYTES:
            raise UnsupportedSparsity(
                f"dense window tiles {(G_i * W_i * TM * dt.itemsize) >> 20} MiB > cap"
            )
        ws_i = (min_t * TK).astype(np.int32)
        if np.any(np.diff(ws_i) < 0):
            raise UnsupportedSparsity("halo kernel needs non-decreasing group windows")
        ws_own.append(ws_i)
        los.append(int(ws_i.min()))
        Ws.append(W_i)
        Gs.append(G_i)

    G = max(Gs)
    W, _, _ = choose_chunks(max(Ws))
    ranks = tuple(range(p)) if ranks is None else tuple(int(r) for r in ranks)
    cols = [(shards[r].rowptr, shards[r].colidx, shards[r].val) for r in ranks]
    mode = device_pack.panel_mode(dt, precision)
    out = None
    if mode == "tf32":  # big and small apart, each (s, G, TM, W): the entry's two maps
        out = tuple(torch.empty((len(ranks), G, TM, W), dtype=torch.float32, device=device)
                    for _ in range(2))
    ws, ah, al = device_pack.uniform_fill_stacked(cols, [ws_own[r] for r in ranks], TM,
                                                  W, G, mode, device, out=out)
    panels = (ah, al) if mode in ("pair", "tf32") else (ah,)
    ws_rel = np.zeros((p, G), dtype=np.int32)
    for i, ws_i in enumerate(ws_own):
        ws_rel[i, : len(ws_i)] = ws_i - los[i]
    lo = np.asarray(los, dtype=np.int64)
    buf_rows = max(TK, int((ws_rel.max(axis=1) + W).max()))

    # push lists (spmm_halo.py:143-173): owner j sends each owned TK chunk
    # to every shard whose window extent covers it, within the matrix
    n_chunks_glb = -(-k_glb // TK)
    pushes = []
    for i in range(p):
        ext_tk = (int(ws_rel[i].max()) + W) // TK
        c = np.arange(los[i] // TK, min(n_chunks_glb, los[i] // TK + ext_tk))
        row = c * TK
        j = np.minimum(np.searchsorted(B_displs, row, side="right") - 1, p - 1)
        pushes.append(np.stack([j, row - B_displs[j], np.full_like(j, i),
                                row - los[i]], axis=1))
    push = np.concatenate(pushes).astype(np.int32)

    # the kernel's chunk table: global chunk -> (owner, row in the owner's
    # shard), over every row any window reads (pad groups read from their
    # shard's base); owner -1 past the matrix
    max_k = -(-int(np.diff(B_displs).max()) // TK) * TK
    span = int((lo[:, None] + ws_rel).max()) + W
    row = np.arange(-(-span // TK), dtype=np.int64) * TK
    j = np.minimum(np.searchsorted(B_displs, row, side="right") - 1, p - 1)
    live = row < k_glb
    chunk_src = np.stack([np.where(live, j, -1), np.where(live, row - B_displs[j], 0)],
                         axis=1)
    if int(chunk_src[:, 1].max()) + TK > max_k:
        raise AssertionError("halo chunk table reads past an owner's shard")

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(device)

    ws_full = (lo[:, None] + ws_rel)[list(ranks)]
    arrays = (put(ws_full), put(ws_rel[list(ranks)]), *panels, put(push),
              put(chunk_src))
    nnz = sum(int(s.rowptr[-1]) for s in shards)
    itemsize = 2 if mode in ("pair", "bf16") else dt.itemsize
    roofline = dict(
        G=G, TM=TM, W=W, p=p, nnz=nnz,
        a_bytes=(2 if mode in ("pair", "tf32") else 1) * p * G * TM * W * itemsize,
        b_rows_read=p * G * W, c_rows=p * G * TM,
        b_itemsize=2 if mode == "bf16" else dt.itemsize,
        passes={"x3": 3, "highest": 6, "default": 1}.get(precision, 1),
    )
    op = HaloOp(precision, TM, G, W, buf_rows, max_k, B_displs,
                len(push) * TK, p, ranks, roofline,
                readers_table(ws_own, W, chunk_src[:, 0], p))
    return arrays, op


def window_owners(ws, W: int, owner) -> tuple:
    """(first, last): per window start of ``ws``, the owners of the first
    and the last live chunk its window ``[ws, ws + W)`` reads; ``owner``
    the plan's per-chunk owner (column 0 of ``chunk_src``, -1 past the
    matrix).  Owners ascend along B's rows, so ``last + 1`` is JAX's
    ``wait_bound`` at the window's last chunk (``bound_for``,
    ``spmm_halo.py:281-286``): the owners that must have arrived before
    the window's last step."""
    owner = np.asarray(owner)
    ws = np.asarray(ws, dtype=np.int64)
    live = int((owner >= 0).sum())
    last = np.minimum((ws + W) // TK, live) - 1
    return owner[ws // TK], owner[last]


def readers_table(ws_own, W: int, owner, p: int) -> np.ndarray:
    """(p, p) bool: shard i's windows (its window starts ``ws_own[i]``, W
    rows each) read a live chunk of owner j; ``owner`` as in
    :func:`window_owners`.  A window reads every owner from its first to
    its last that holds rows (they ascend along B's rows).  JAX's
    ``exp_from > 0`` (``spmm_halo.py:143-162``)."""
    j = np.arange(p)
    has_rows = np.isin(j, owner)
    out = np.zeros((p, p), dtype=bool)
    for i, ws in enumerate(ws_own):
        first, last = window_owners(ws, W, owner)
        out[i] = has_rows & ((first[:, None] <= j) & (j <= last[:, None])).any(axis=0)
    return out


# ------------------------------------------------------------- plain version


def halo_buffers(push, b_shards, buf_rows: int, consumers=None) -> torch.Tensor:
    """The window buffers the TPU kernel's pushes fill: (p, buf_rows, n),
    zero where nothing is pushed; with ``consumers``, those shards' buffers
    alone, in that order."""
    p, _, n = b_shards.shape
    push = push.long()
    if consumers is not None:
        keep = torch.isin(push[:, 2], torch.as_tensor(consumers, device=push.device))
        push = push[keep].clone()
        push[:, 2] = torch.searchsorted(
            torch.as_tensor(consumers, device=push.device), push[:, 2])
        p = len(consumers)
    buf = torch.zeros((p, buf_rows, n), dtype=b_shards.dtype, device=b_shards.device)
    rows = torch.arange(TK, device=b_shards.device)
    src = b_shards[push[:, 0, None], push[:, 1, None] + rows]  # (P, TK, n)
    buf[push[:, 2, None], push[:, 3, None] + rows] = src
    return buf


def spmm_halo_plain(ws, ws_rel, panels, push, chunk_src, b_shards, precision,
                    buf_rows, consumers=None):
    """The fused kernel's function in plain PyTorch: the pushes into
    per-shard window buffers, then each shard's windowed product at
    ``precision`` (:func:`spmm_window_plain`; on the x3 pair ``panels =
    (ah, al)`` that is ``spmm_window_sg_presplit_plain``, on the default
    hi plane ``spmm_window_sg_bf16_plain``, on the TF32 planes ``(big,
    small)`` the fp32 panels' product, the panels rebuilt from the big
    plane bit for bit); ``ws`` and ``chunk_src`` are
    the kernel's and go unused.  ``b_shards`` holds every owner's rows;
    ``consumers``: the shards the panels are of (all by default).  Returns
    (shards, G*TM, n)."""
    buf = halo_buffers(push, b_shards, buf_rows, consumers)
    pair = isinstance(panels, tuple)
    return torch.stack([
        spmm_window_plain(ws_rel[i], tuple(t[i] for t in panels) if pair else panels[i],
                          buf[i], precision)
        for i in range(ws_rel.shape[0])
    ])


# ------------------------------------------------------------ across ranks


DEFAULT_BOUND_S = 30.0  # s a wait of #12 across processes spins before it gives up

# the kernels' status codes (csrc/panel_tiles.cuh HaloCode): kind | where << 8
_HALO_KINDS = {1: "owner {owner}'s B did not arrive (chunk {where})",
               2: "reader {reader} did not finish its launches",
               3: "a peer gave up first (its flag word carries the failure; chunk or "
                  "reader index {where})",
               4: "another wait of this rank gave up"}
HALO_FAILED = 1 << 62  # set in the flag words a rank writes once a wait of it gave up


class HaloTimeout(RuntimeError):
    """A wait of the fused kernel across processes gave up: an owner's B or
    a reader's launches did not come within the bound, or a peer gave up
    first.  This rank's C of that launch is NaN; the group is out of step
    and is only fit to be closed."""


class HaloPeers:
    """The fused kernel's B across processes: this rank's buffer and flag
    words, made once, and the p owners'.

    ``buf`` (1, max_k, n) is this rank's B shard, written only by
    :meth:`load` (a launch refuses a buffer written otherwise: its version
    counter).  On a CUDA device every rank shares the CUDA IPC handles of
    ``buf`` and of ``flags``, its two int64 words ``arrive`` (its loads so
    far) and ``done`` (its launches so far), once
    (``torch.multiprocessing.reductions.reduce_tensor``, which carries the
    caching allocator's offset, through ``dist.all_gather_object`` on
    ``group``), opens its peers' (their rebuild: ``cudaIpcOpenMemHandle``
    under torch's own reference counts), and keeps ``bases``, the p owners'
    base pointers, ``chunk_pairs``, the kernel's table of (row pointer,
    arrive word) pairs a chunk, made from them, the flag words and the
    plan's ``chunk_src`` once (:func:`chunk_rows`), ``ptrs16``, whether
    every row pointer is on 16 bytes, and ``done_ptrs``, the done words of
    ``readers`` (the group indices of the ranks whose windows read this
    rank's rows): nothing moves.  ``status`` is this rank's status word,
    in pinned host memory: the kernels write why a wait gave up, and
    :meth:`check` reads it with no sync.  No host barrier and no stream drain runs per exec
    (``barriers`` and ``drains`` count those :meth:`sync` makes: at init
    and at :meth:`close`).  Where a peer's buffer or flags cannot be mapped
    the constructor raises.

    Lockstep: the counts assume that every rank of the group loads and
    launches the same number of times, in the same order, as the SPMD
    engines do (``epoch`` and ``launches`` count them).  A rank that falls
    out of step makes its peers' waits give up after ``bound_s`` seconds
    (:class:`HaloTimeout`), never hang.

    On the CPU ``rows()`` gathers the owners' shards with ``all_gather``;
    the counts and the status word are kept all the same.  ``ranks`` are
    the group's global ranks, owner i's at index i; ``me`` this rank's
    index.  :meth:`close` drops the peers' mappings after a barrier, so
    that no owner frees a buffer a peer still holds."""

    def __init__(self, shape, dtype, device, group, ranks, me: int, chunk_src,
                 readers=(), bound_s: float = DEFAULT_BOUND_S) -> None:
        import torch.distributed as dist

        self.group, self.ranks, self.me = group, tuple(ranks), int(me)
        self.readers = tuple(int(i) for i in readers)
        self.bound_s = float(bound_s)
        self.epoch = self.launches = self.barriers = self.drains = 0
        self.flag_launches = dict(wait=0, signal=0, done=0)
        self.buf = torch.zeros((1, *shape), dtype=dtype, device=device)
        self.flags = torch.zeros(2, dtype=torch.int64, device=device)  # arrive, done
        self.status = torch.zeros(1, dtype=torch.int64, pin_memory=self.buf.is_cuda)
        self._owner = chunk_src[:, 0].cpu().numpy()
        self.views = self.bases = self.chunk_pairs = self.ptrs16 = None
        self.done_ptrs = self._words = None
        if self.buf.is_cuda:
            from torch.multiprocessing.reductions import reduce_tensor

            handles = [None] * len(self.ranks)
            if len(self.ranks) > 1:
                dist.all_gather_object(
                    handles, (reduce_tensor(self.buf[0]), reduce_tensor(self.flags)),
                    group=group)
            mapped = []
            for i, got in enumerate(handles):
                if i == self.me:
                    mapped.append((self.buf[0], self.flags))
                    continue
                (fn, args), (ffn, fargs) = got
                mapped.append((fn(*args), ffn(*fargs)))
            for i, (v, f) in enumerate(mapped):
                if (v.shape != self.buf.shape[1:] or v.dtype != dtype or not v.is_cuda
                        or f.shape != (2,) or f.dtype != torch.int64 or f.device != v.device):
                    raise RuntimeError(f"HaloPeers: owner {i}'s buffer maps as {v.dtype} "
                                       f"{tuple(v.shape)} on {v.device}, its flags as "
                                       f"{f.dtype} {tuple(f.shape)} on {f.device}")
                if v.device != self.buf.device:  # an owner on another GPU of the host
                    if not torch.cuda.can_device_access_peer(self.buf.device, v.device):
                        raise RuntimeError(f"HaloPeers: {self.buf.device} cannot read "
                                           f"{v.device}'s memory (no peer access)")
                    # a device-to-device copy makes torch enable peer access
                    self.buf.view(-1)[:1].copy_(v.view(-1)[:1])
                    self.buf.zero_()
            self.views = [v for v, _ in mapped]
            self._words = [f for _, f in mapped]  # held: the kernels read them
            self.bases = tuple(v.data_ptr() for v in self.views)
            rows, self.ptrs16 = chunk_rows(chunk_src, self.bases, shape[1],
                                           self.buf.element_size())
            words = [f.data_ptr() for f in self._words]
            self.chunk_pairs = torch.stack([rows, chunk_rows(chunk_src, words, 0, 1)[0]],
                                           dim=1).contiguous()
            self.done_ptrs = torch.tensor([words[i] + 8 for i in self.readers] or [0],
                                          dtype=torch.int64, device=self.buf.device)
            self.sync()
        self._version = self.buf._version

    @property
    def bound_ns(self) -> int:
        return int(self.bound_s * 1e9)

    def _flag_kernel(self, name: str, *args) -> None:
        from . import _build

        entry = f"crp_halo_{name}"
        with torch.cuda.device(self.buf.device):
            stream = torch.cuda.current_stream(self.buf.device).cuda_stream
            _build.check(_build.entry(entry)(*args, stream), entry)
        self.flag_launches[name] += 1

    def load(self, bs: torch.Tensor) -> None:
        """Write this rank's B shard ``bs`` (1, r, n), r <= max_k, into the
        first r rows of ``buf``, in the buffer's type (bf16 at
        ``default``); the rows past r are left as they are, and so is
        ``buf`` itself.  On the card, first wait (on the stream) until
        every reader has finished as many launches as this rank, and once
        B is written raise this rank's arrive word to the new ``epoch``.
        Raises :class:`HaloTimeout` if a wait of this rank gave up."""
        if (bs.dim() != 3 or bs.shape[0] != 1 or bs.shape[1] > self.buf.shape[1]
                or bs.shape[2] != self.buf.shape[2]):
            raise ValueError(f"B shard {tuple(bs.shape)}: the fused kernel's buffer "
                             f"across ranks is {tuple(self.buf.shape)}")
        self.check()
        if self.buf.is_cuda:
            self._flag_kernel("wait", self.done_ptrs.data_ptr(), self.status.data_ptr(),
                              len(self.readers), self.launches, self.bound_ns)
        self.epoch += 1
        if bs.data_ptr() != self.buf.data_ptr():
            self.buf[:, : bs.shape[1]].copy_(bs)
        self._version = self.buf._version
        if self.buf.is_cuda:
            self._flag_kernel("signal", self.flags.data_ptr(), self.status.data_ptr(),
                              self.epoch)

    def launched(self, c: torch.Tensor) -> None:
        """After a launch that wrote ``c``: count it and, on the card, raise
        this rank's done word to the count (``c`` NaN where a wait gave
        up)."""
        self.launches += 1
        if self.buf.is_cuda:
            self._flag_kernel("done", self.flags.data_ptr() + 8, self.status.data_ptr(),
                              c.data_ptr(), self.launches, c.numel() * c.element_size())

    def written(self) -> bool:
        """Whether ``buf`` holds what :meth:`load` last wrote (its version
        counter has not moved since)."""
        return self.buf._version == self._version

    def check(self) -> None:
        """Raise :class:`HaloTimeout` if a wait of this rank gave up (the
        status word, read without a sync)."""
        code = int(self.status[0])
        if not code:
            return
        kind, where = code & 0xFF, code >> 8
        owner = int(self._owner[where]) if kind == 1 and where < len(self._owner) else -1
        reader = self.readers[where] if kind == 2 and where < len(self.readers) else -1
        what = _HALO_KINDS.get(kind, "unknown status").format(
            owner=self.ranks[owner] if owner >= 0 else "?", where=where,
            reader=self.ranks[reader] if reader >= 0 else "?")
        raise HaloTimeout(f"rank {self.ranks[self.me]}: {what} within {self.bound_s} s "
                          f"(status {code:#x}, after {self.epoch} loads and "
                          f"{self.launches} launches)")

    def rows(self) -> torch.Tensor:
        """Every owner's rows, (p, max_k, n), by ``all_gather`` (CPU)."""
        import torch.distributed as dist

        if len(self.ranks) == 1:
            return self.buf
        out = [torch.empty_like(self.buf[0]) for _ in self.ranks]
        dist.all_gather(out, self.buf[0], group=self.group)
        return torch.stack(out)

    def sync(self) -> None:
        """A host barrier: this rank's stream drained, then every rank of
        the group.  At init (the handles exchanged) and at :meth:`close`;
        a caller that reads the peers' ``views`` itself calls it first."""
        import torch.distributed as dist

        if self.buf.is_cuda:
            torch.cuda.current_stream(self.buf.device).synchronize()
            self.drains += 1
        if len(self.ranks) > 1:
            dist.barrier(group=self.group)
            self.barriers += 1

    def close(self) -> None:
        """Drop the peers' mappings after a host barrier (collective: every
        rank calls it); then raise :class:`HaloTimeout` if a wait of this
        rank gave up."""
        if self.views is not None:
            self.views = self.bases = self.chunk_pairs = None
            self.done_ptrs = self._words = None
            self.sync()
        self.check()


# ------------------------------------------------------------------ wrapper

def chunk_rows(chunk_src, bases, n: int, itemsize: int) -> tuple:
    """The kernel's chunk pointers: for each (owner, row) pair of the
    plan's chunk table, the address of that row in the owner's shard,
    ``bases[owner] + row * n * itemsize``, 0 past the matrix; an int64
    tensor on the table's device, and whether every pointer is on 16
    bytes.  ``bases``: the p owners' base addresses (the mapped buffers
    across processes, made once by :class:`HaloPeers`; with ``n = 0`` their
    flag words, one per chunk)."""
    owner, row = chunk_src.long().unbind(1)
    base = torch.tensor(bases, dtype=torch.int64, device=chunk_src.device)
    rows = torch.where(owner >= 0, base[owner.clamp(min=0)] + row * (n * itemsize), 0)
    return rows, all(x % 16 == 0 for x in bases)


def stacked_chunk_rows(chunk_src, b_shards) -> tuple:
    """:func:`chunk_rows` for a stacked B (p, rows, n) on one card, whose
    owners are its shards at one stride: a few elementwise ops on the
    table, with B's address a scalar (no host-to-device copy, nothing
    kept between launches)."""
    step = b_shards.shape[2] * b_shards.element_size()
    owner, row = chunk_src.to(torch.int64).unbind(1)
    rows = owner * (b_shards.shape[1] * step)
    rows.add_(row, alpha=step).add_(b_shards.data_ptr()).masked_fill_(owner < 0, 0)
    shard_bytes = b_shards.shape[1] * step
    return rows, (b_shards.data_ptr() % 16 == 0
                  and (b_shards.shape[0] == 1 or shard_bytes % 16 == 0))


def spmm_halo(ws, ws_rel, panels, push, chunk_src, b_shards, precision, buf_rows,
              *, min_b_rows: int, peers: HaloPeers | None = None):
    """Fused halo exchange + windowed SpMM (``csrc/halo.cu``): (s, G*TM, n)
    from the (s, G, TM, W) panels of s shards: at ``x3`` the bf16 pair
    ``panels = (ah, al)`` and fp32 B (#4's ``wgmma`` body with the chunk
    lookup), at ``default`` the bf16 hi plane and bf16 B (its one-pass
    mode, fp32 C), at ``highest`` the TF32 planes ``panels = (big,
    small)`` and fp32 B (3xTF32 on the tensor cores: the same body's TF32
    mode, the chunk lookup once a 32-row stage; on a shard it equals
    ``spmm_window`` on the same planes bit for bit), or fp64 panels and B
    (on the FP64 tensor cores: #11's DMMA body, ``csrc/dd_tc.cu``, its
    windowed walk with B through the chunk table); the panels must start
    on 16 bytes.  fp32 panels have no kernel: the plans hold the pair, the
    plane or the planes.  Without ``peers`` (one card) ``b_shards`` is
    the stacked B (p, max_k, n) of every owner and s = p; with them
    (across processes) it is their ``buf``, this rank's shard, and the
    launch (the ``*_flags`` entry, on ``chunk_pairs``) waits for each
    owner's arrive word before it reads the owner's rows, then
    :meth:`HaloPeers.launched` sets this rank's done word: no host
    barrier, no stream drain.  Replaces
    ``halo_spmm_local`` (``spmm_halo.py:349``, kernel ``_halo_kernel``,
    its barrier, arrival semaphores and send drain included)."""
    pair = isinstance(panels, tuple)
    planes = panels if pair else (panels,)
    if peers is not None:
        if b_shards.data_ptr() != peers.buf.data_ptr():
            raise ValueError("spmm_halo: across processes B must be the peers' own buffer")
        if not peers.written():
            raise RuntimeError("spmm_halo: the peers' buffer was written outside "
                               "HaloPeers.load, which alone orders the writes with the "
                               "peers' reads")
    if _placement("spmm_halo", ws, *planes, chunk_src, b_shards) == "cpu":
        if peers is None:
            return spmm_halo_plain(ws, ws_rel, panels, push, chunk_src, b_shards,
                                   precision, buf_rows)
        c = spmm_halo_plain(ws, ws_rel, panels, push, chunk_src, peers.rows(),
                            precision, buf_rows, consumers=[peers.me])
        peers.launched(c)
        return c
    name, panel_dtype, b_dtype = window_entry("spmm_halo", planes, precision)
    s_, G, TM, W = planes[0].shape
    for t in planes:
        if (t.dtype != panel_dtype or t.shape != (s_, G, TM, W) or not t.is_contiguous()
                or TM % 128 or W % 32):
            raise ValueError(f"spmm_halo: panels must be contiguous {panel_dtype} of one "
                             f"shape with TM % 128 == 0 and W % 32 == 0; got {t.dtype} "
                             f"{tuple(t.shape)}")
    labels = {torch.bfloat16: ("ah", "al"), torch.float32: ("big", "small")}.get(
        panel_dtype, ("panels",))
    _check_aligned("spmm_halo", **dict(zip(labels, planes)))
    if ws.dtype != torch.int32 or ws.shape != (s_, G) or not ws.is_contiguous():
        raise ValueError(f"spmm_halo: ws must be contiguous int32 of shape ({s_}, {G})")
    if (chunk_src.dtype != torch.int32 or chunk_src.dim() != 2 or chunk_src.shape[1] != 2
            or not chunk_src.is_contiguous()):
        raise ValueError("spmm_halo: chunk_src must be a contiguous (chunks, 2) int32 "
                         "tensor of (owner, row) pairs")
    if (b_shards.dtype != b_dtype or b_shards.dim() != 3
            or b_shards.shape[0] != (1 if peers is not None else s_)
            or not b_shards.is_contiguous()):
        raise ValueError(f"spmm_halo: B must be contiguous {b_dtype} shards of "
                         f"shape ({s_}, rows, n)")
    if b_shards.shape[1] != min_b_rows:
        raise ValueError(f"spmm_halo: B shards have {b_shards.shape[1]} rows, the "
                         f"chunk table was built for {min_b_rows}")
    from . import _build

    n = b_shards.shape[2]
    if peers is None:
        rows, rows16 = stacked_chunk_rows(chunk_src, b_shards)
    elif peers.chunk_pairs.shape[0] != chunk_src.shape[0]:
        raise ValueError("spmm_halo: the peers' chunk pointers are of another plan")
    else:
        rows, rows16 = peers.chunk_pairs, peers.ptrs16
    c = torch.empty((s_, G * TM, n), dtype=torch.float64 if panel_dtype == torch.float64
                    else torch.float32, device=b_shards.device)
    ptrs = (rows.data_ptr(), ws.data_ptr(), *(t.data_ptr() for t in planes), c.data_ptr())
    with torch.cuda.device(b_shards.device):
        stream = torch.cuda.current_stream(b_shards.device).cuda_stream
        if peers is None:
            rc = _build.entry(name)(*ptrs, s_ * G, TM, W, n, int(rows16), stream)
        else:
            name = f"{name}_flags"
            rc = _build.entry(name)(*ptrs, peers.status.data_ptr(), s_ * G, TM, W, n,
                                    int(rows16), peers.epoch, peers.bound_ns, stream)
    _build.check(rc, name)
    spmm_halo.launches += 1
    if peers is not None:
        peers.launched(c)
    return c


spmm_halo.launches = 0

KERNELS = (spmm_halo,)
