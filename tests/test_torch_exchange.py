"""The exec-time B exchange on stacked shards: the port's ``exchange_b`` and
``exchange_b_ring`` against the JAX ``exchange_b`` / ``exchange_b_ring``
under ``shard_map`` on the 8-device CPU mesh.  Every receive-buffer row
some A column references must be equal bit for bit."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from crp_tpu.comm import exchange as jx
from crp_tpu.shard.layout import make_mesh_1d
from crp_tpu.sparse.synth import banded_random_csr, powerlaw_random_csr

from crp_tpu_torch.comm import exchange as tx
from crp_tpu_torch.plan.partition1d import csr_row_partition
from crp_tpu_torch.shard.layout import shard_dense_rows

EXTRA_ROWS = 37  # receive buffers past the plan's rows, as the window kernels need


def _case(p, empty, gen):
    """Shards of ``a`` (one emptied when ``empty``) with B ownership by the
    same row blocks, the last extended to every column."""
    a = (banded_random_csr(480, nnz_per_row=6, bandwidth=35, seed=10) if gen == "banded"
         else powerlaw_random_csr(480, avg_degree=9, seed=11))
    displs = csr_row_partition(a.rowptr, p)
    cols = [a.colidx[a.rowptr[displs[i]]:a.rowptr[displs[i + 1]]] for i in range(p)]
    if empty:
        cols[p // 2] = cols[p // 2][:0]
    b_displs = displs.copy()
    b_displs[-1] = a.ncol
    return a, cols, b_displs


def _jax_exchange(plan, b_sh, rb_rows, impl, devices):
    fn = jx.exchange_b_ring if impl == "ring" else jx.exchange_b
    mesh = make_mesh_1d(plan.p, devices=devices[: plan.p])
    sh = NamedSharding(mesh, P("pm"))

    def local(send_idx, recv_dst, self_src, self_dst, b_loc):
        return fn(b_loc[0], send_idx[0], recv_dst[0], self_src[0], self_dst[0],
                  rb_rows, "pm")[None]

    run = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P("pm"),) * 5,
                                out_specs=P("pm"), check_vma=False))
    return np.asarray(run(*(jax.device_put(x, sh) for x in (
        plan.send_idx, plan.recv_dst, plan.self_src, plan.self_dst, b_sh))))


@pytest.mark.parametrize("impl", ["a2a", "ring"])
@pytest.mark.parametrize("reidx", [True, False])
@pytest.mark.parametrize("empty", [False, True], ids=["full", "empty_shard"])
@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_exchange_matches_jax(devices8, p, empty, reidx, impl):
    gen = "powerlaw" if p == 3 else "banded"
    a, cols, b_displs = _case(p, empty, gen)
    plan = tx.build_b_exchange(cols, b_displs, reidx=reidx)
    max_k = int(np.diff(b_displs).max())
    rb_rows = plan.rB_nrow_max + EXTRA_ROWS
    b = np.random.default_rng(p).standard_normal((a.ncol, 12))
    b_sh = shard_dense_rows(b, b_displs, pad_rows=max_k)
    want = _jax_exchange(jx.build_b_exchange(cols, b_displs, reidx=reidx), b_sh,
                         rb_rows, impl, devices8)
    tables = tx.exchange_tables(plan, max_k, rb_rows, "cpu", ring=impl == "ring")
    run = tx.exchange_b_ring if impl == "ring" else tx.exchange_b
    got = run(torch.from_numpy(b_sh), tables).numpy()
    assert got.shape == want.shape == (p, rb_rows, 12)
    for i in range(p):
        ref = np.unique(cols[i])
        dst = (np.searchsorted(plan.rowmap[i], ref) if reidx
               else ref - int(plan.rowmap[i]))
        np.testing.assert_array_equal(got[i, dst], want[i, dst])
        np.testing.assert_array_equal(got[i, dst], b[ref])
        # padded slots are stripped: no other row is written
        rest = np.ones(rb_rows, bool)
        rest[dst] = False
        assert not np.any(got[i, rest])
    recv = sum(len(np.setdiff1d(np.unique(cols[i]),
                                np.arange(b_displs[i], b_displs[i + 1])))
               for i in range(p))
    assert plan.total_recv_rows == recv


def test_tables_refuse_a_short_buffer():
    a, cols, b_displs = _case(2, False, "banded")
    plan = tx.build_b_exchange(cols, b_displs)
    with pytest.raises(ValueError, match="rb_rows"):
        tx.exchange_tables(plan, int(np.diff(b_displs).max()), plan.rB_nrow_max - 1,
                           "cpu")


def test_all_to_all_and_ring_shift_on_one_device():
    """The collectives on one device: the all_to_all swaps the source and
    destination axes; ring shift s hands shard i what shard i - s sent."""
    x = torch.arange(4 * 4 * 2 * 3).view(4, 4, 2, 3)
    y = tx.all_to_all(x)
    for i in range(4):
        for j in range(4):
            assert torch.equal(y[i, j], x[j, i])
    r = tx.ring_shift(x[:, 0], 3)
    for i in range(4):
        assert torch.equal(r[i], x[(i - 3) % 4, 0])
