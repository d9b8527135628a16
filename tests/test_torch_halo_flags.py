"""The flags that order the fused halo kernel (#12) across processes in
place of host barriers (``crp_tpu_torch.kernels.spmm_halo.HaloPeers``,
``csrc/halo.cu``): the readers table each owner waits on and the owners
each window waits for, against JAX's ``build_halo_plan`` (``exp_from``,
``wait_bound``); the counts, the buffer's writes and the bits of the C
shards on 2 and 4 gloo ranks on the CPU (``tests/torch_dist_ranks.py``,
job ``halo_flags``), against the one-device engines; and the status word,
which raises ``HaloTimeout`` at the next host sync point and at
``close``.  The waits themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from crp_tpu.kernels import spmm_halo as jh

from crp_tpu_torch import CrpSpmm, Para2dSpmm, SpmmConfig
from crp_tpu_torch.engine.rowpara import RowParaSpmm
from crp_tpu_torch.kernels import spmm_halo as th
from crp_tpu_torch.plan.partition1d import csr_row_partition
from crp_tpu_torch.shard.redist import BlockDist
from crp_tpu_torch.sparse.synth import banded_random_csr, fill_b, powerlaw_community_csr
from tests.test_torch_dist_crp import force_bplan, layouts
from tests.test_torch_para2d import force_plan
from tests.torch_dist_ranks import bits, run_ranks

CPU = torch.device("cpu")


def _matrix(kind, dtype, p):
    if kind == "banded":
        return banded_random_csr(1500 + 131 * p, nnz_per_row=7, bandwidth=300, seed=80 + p,
                                 dtype=dtype)
    return powerlaw_community_csr(1024 + 256 * p, avg_degree=6, comm_size=256, seed=90 + p,
                                  dtype=dtype)


def _shards(a, p):
    d = csr_row_partition(a.rowptr, p)
    aligned = th.align_displs(d, a.ncol)
    return [a.row_slice(int(d[i]), int(d[i + 1])) for i in range(p)], aligned


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("p", [2, 3, 4])
@pytest.mark.parametrize("kind", ["banded", "power-law"])
def test_readers_and_window_owners_match_jax(kind, p, dtype):
    """The readers table is JAX's ``exp_from > 0``; each group's last owner
    + 1 is JAX's ``wait_bound`` at the group's last chunk (``bound_for``
    at its window's last step); each group's first and last owner are
    owners its shard reads."""
    a = _matrix(kind, dtype, p)
    shards, aligned = _shards(a, p)
    jp = jh.build_halo_plan(shards, aligned, dtype=dtype)
    arrays, op = th.build_halo_plan(shards, aligned, device=CPU, dtype=dtype)
    assert op.readers.shape == (p, p) and op.readers.dtype == bool
    np.testing.assert_array_equal(op.readers, jp.exp_from > 0)
    ws, owner = arrays[0].numpy(), arrays[-1].numpy()[:, 0]
    c_tk = jp.wait_bound.shape[1]
    for i in range(p):
        first, last = th.window_owners(ws[i], op.W, owner)
        tk_last = (jp.ws_rel[i].astype(np.int64) + jp.W - 1) // 128
        np.testing.assert_array_equal(last + 1, jp.wait_bound[i, np.minimum(tk_last, c_tk - 1)])
        assert np.all(first <= last) and np.all(first >= 0)
        assert op.readers[i, first].all() and op.readers[i, last].all()
    if kind == "banded":  # a banded matrix's windows reach their neighbours alone
        assert not op.readers[0, p - 1] or p == 2


# ---------------------------------------------------------------- on ranks

N = 16
BS = 3  # distinct B a case runs, one exec each


def _bs(a, n, dtype):
    return [np.asarray(fill_b(0, a.ncol, 0, n, factor_i=0.19 + 0.07 * s, dtype=dtype))
            for s in range(BS)]


def _cases(world):
    """(engine, one-device engine, case) for the world's ranks: the fused
    kind forced, as the smoke's CPU rehearsal of ``multirank_crp`` forces
    it."""
    out = []
    a = banded_random_csr(1300, 7, 60, seed=101, dtype=np.float32)
    d = csr_row_partition(a.rowptr, world)
    cfg = dict(kernel="pallas_halo", mxu_precision="x3")
    out.append(dict(id=f"rowpara-x3-p{world}", engine="rowpara", a=a, displs=d, n=N,
                    dtype=np.float32, config=cfg, bs=_bs(a, N, np.float32)))
    a = banded_random_csr(1100, 7, 60, seed=102)
    plan = force_plan(a, N, world // 2 if world == 4 else world, 2 if world == 4 else 1)
    out.append(dict(id=f"para2d-fp64-{plan.pm}x{plan.pn}", engine="para2d", a=a, plan=plan,
                    n=N, dtype=np.float64, config=dict(kernel="pallas_halo"),
                    bs=_bs(a, N, np.float64)))
    if world == 4:
        a = banded_random_csr(1150, 7, 60, seed=103)
        ub, uc = layouts(a, N, "rows")
        out.append(dict(id="crp-fp64-4x1", a=a, n=N, dtype=np.float64,
                        config=dict(kernel="pallas_halo"), user_B=BlockDist(ub),
                        user_C=BlockDist(uc), bplan=force_bplan(a, N, 4, 1),
                        bs=_bs(a, N, np.float64)))
    return out


def _one_device(case, world):
    cfg = SpmmConfig(**case["config"])
    if "bplan" in case:
        one = CrpSpmm(case["a"], case["n"], case["user_B"], case["user_C"], nproc=world,
                      device="cpu", config=cfg, dtype=case["dtype"], bplan=case["bplan"])
        return one, one.rd_B.shard_src
    if case["engine"] == "rowpara":
        one = RowParaSpmm(case["a"], case["displs"], case["displs"], case["n"], device="cpu",
                          config=cfg, dtype=case["dtype"])
    else:
        one = Para2dSpmm(case["a"], case["plan"], device="cpu", config=cfg,
                         dtype=case["dtype"])
    return one, one.shard_b


@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def ranks(request):
    world = request.param
    cases = _cases(world)
    per_rank = run_ranks(world, "halo_flags", cases)
    return world, [(c, [r[i] for r in per_rank]) for i, c in enumerate(cases)]


def test_every_write_goes_through_load(ranks):
    """After k execs every rank has loaded and launched k times, its
    buffer holds what ``load`` wrote, and ``HaloPeers`` ran no host
    barrier and no stream drain; a write past ``load`` is refused at the
    next launch."""
    world, cases = ranks
    for case, per_rank in cases:
        for got in per_rank:
            assert got["kind"] == "pallas_halo", case["id"]
            for k, cnt in enumerate(got["counts"], start=1):
                assert cnt == dict(epoch=k, launches=k, written=True, barriers=0, drains=0), (
                    case["id"], cnt)
            assert "written outside HaloPeers.load" in got["bypass"]


def test_c_shards_keep_their_bits(ranks):
    """Each rank's C block for each of the distinct B equals the one-device
    engine's block r bit for bit."""
    world, cases = ranks
    for case, per_rank in cases:
        one, shard = _one_device(case, world)
        for s, b in enumerate(case["bs"]):
            want = bits(one.exec_device(shard(b)))
            for r, got in enumerate(per_rank):
                if case.get("engine") == "para2d":
                    pi, pj = divmod(r, case["plan"].pn)
                    mine = want[pi, pj]
                    theirs = got["blocks"][s][0, 0]
                else:
                    mine, theirs = want[r], got["blocks"][s][0]
                assert theirs.dtype == mine.dtype and np.array_equal(theirs, mine), (
                    case["id"], s, r)


def test_status_raises_at_the_sync_points(ranks):
    """A set status word: ``unshard_c`` (after its gather), the next
    ``exec`` (at its load) and ``close`` (after the teardown) raise
    ``HaloTimeout``, naming the owner that did not arrive."""
    world, cases = ranks
    for case, per_rank in cases:
        where = ["exec", "close"] + ([] if "bplan" in case else ["unshard_c"])
        for r, got in enumerate(per_rank):
            assert sorted(got["raised"]) == sorted(where), (case["id"], got["raised"])
            # chunk 0's owner: the first rank of this rank's column group
            owner = r % case["plan"].pn if case.get("engine") == "para2d" else 0
            for msg in got["raised"].values():
                assert f"rank {r}: owner {owner}'s B did not arrive (chunk 0)" in msg, msg
            assert got["closed"]


def test_status_word_on_one_process():
    """``HaloPeers`` alone (one owner, no group): a status word a kernel
    set raises at ``check``, at the next ``load`` (before it writes) and at
    ``close``; each kind names what did not come."""
    chunk_src = torch.tensor([[0, 0], [0, 128], [-1, 0]], dtype=torch.int32)
    peers = th.HaloPeers((256, 4), torch.float64, CPU, None, (5,), 0, chunk_src,
                         readers=(0,), bound_s=0.25)
    peers.load(torch.ones((1, 200, 4), dtype=torch.float64))
    assert (peers.epoch, peers.written(), peers.barriers, peers.drains) == (1, True, 0, 0)
    assert float(peers.buf[0, 199, 0]) == 1 and float(peers.buf[0, 200, 0]) == 0
    for code, text in ((1 | 1 << 8, "owner 5's B did not arrive (chunk 1)"),
                       (2, "reader 5 did not finish its launches"),
                       (3 | 2 << 8, "a peer gave up first"),
                       (4, "another wait of this rank gave up")):
        peers.status[0] = code
        with pytest.raises(th.HaloTimeout, match=r"rank 5: .*") as e:
            peers.check()
        assert text in str(e.value) and "0.25 s" in str(e.value)
        with pytest.raises(th.HaloTimeout):
            peers.load(torch.zeros((1, 256, 4), dtype=torch.float64))
        assert peers.epoch == 1 and float(peers.buf[0, 0, 0]) == 1  # nothing written
    with pytest.raises(th.HaloTimeout):
        peers.close()
    peers.status[0] = 0
    peers.close()
    with pytest.raises(ValueError):
        peers.load(torch.zeros((1, 257, 4), dtype=torch.float64))
