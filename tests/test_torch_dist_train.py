"""Training across ranks: the training ops and both trainers on 2 and 4 gloo
ranks on the CPU, one process each (``tests/torch_dist_ranks.py``, job
``training``), against the port on one device (every shard there; each
rank's shards, value ranges, loss, gradients and weights bit for bit) and
the JAX package on its CPU mesh (ops, loss and weights within 1e-5, the
gradients within 1e-4).  The rank processes block jax: every JAX
reference runs here, from the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tests.torch_threads  # noqa: F401  (one torch thread, as in the ranks)
from crp_tpu.config import SpmmConfig as JaxConfig
from crp_tpu.engine.autodiff import DifferentiableSpmm as JaxDiff
from crp_tpu.engine.trainable import ValueParameterizedSpmm as JaxVps
from crp_tpu.shard.layout import make_mesh_1d, shard_dense_rows, unshard_dense_rows
from crp_tpu.utils.norms import rel_fro_err

from crp_tpu_torch.examples import gat_train, gcn_train
from crp_tpu_torch.examples.common import community_graph, community_task
from crp_tpu_torch.plan.partition1d import csr_row_partition
from crp_tpu_torch.sparse.synth import fill_b, powerlaw_random_csr

from tests.test_torch_train_examples import (
    CLASSES, HIDDEN, NODES, example_graph, jax_gat_step, jax_gcn_step, jax_params,
)
from tests.torch_dist_ranks import model_steps, op_results, run_ranks

TOL, TOL_GRAD = 1e-5, 1e-4  # against JAX: ops, loss and weights; gradients
N = 8
KINDS = ("segsum", "gather", "pallas", "ragged")
OPS = {f"{k}-{'ring' if ring else 'a2a'}": dict(op="diff", config=dict(kernel=k, rb_p2p=ring))
       for k in KINDS for ring in (0, 1)}
OPS.update({f"vps-{'ring' if ring else 'a2a'}": dict(op="vps", config=dict(
    kernel="segsum", rb_p2p=ring)) for ring in (0, 1)})
MODELS = ("gcn_train", "gat_train")
TRAIN = dict(nodes=800, steps=12, hidden=16)
TRAINERS = {"gcn_train": gcn_train, "gat_train": gat_train}


def _matrix():
    return powerlaw_random_csr(500, avg_degree=8, seed=21)


def _op_cases(p: int) -> dict:
    """Every op case at p shards, on one matrix and one set of seeded
    inputs."""
    a = _matrix()
    rng = np.random.default_rng(90)
    inputs = dict(a=a, displs=csr_row_partition(a.rowptr, p), n=N, dtype=np.float32,
                  b=np.asarray(fill_b(0, a.ncol, 0, N, dtype=np.float32)),
                  dc=rng.standard_normal((a.nrow, N)).astype(np.float32),
                  v=rng.standard_normal(a.nnz).astype(np.float32),
                  x=rng.standard_normal((a.nrow, 2)).astype(np.float32),
                  y=rng.standard_normal((a.ncol, 2)).astype(np.float32),
                  g=rng.standard_normal(a.nnz).astype(np.float32))
    return {cid: dict(inputs, **case) for cid, case in OPS.items()}


def _model_args(example: str, p: int) -> tuple:
    """``model_steps``' arguments: the port's graph (the ranks import no
    ``crp_tpu``), JAX's weights, the task."""
    ex = TRAINERS[example]
    g = community_graph(NODES, CLASSES)
    graph = ex.normalized_adjacency(g) if ex is gcn_train else ex.pattern_with_self_loops(g)
    x, labels = community_task(NODES, CLASSES)
    return graph, dict(jax_params(example), p=p), x, labels, ex.LR


@pytest.fixture(scope="module")
def ranks():
    """4 ranks: every op case and a step of each model; 2 ranks: every op
    case and ``train()`` of each example; then both trainers' ``main``
    under ``--distributed`` on 2 ranks."""
    four = run_ranks(4, "training", dict(
        ops=_op_cases(4), models={ex: _model_args(ex, 4) for ex in MODELS}))
    two = run_ranks(2, "training", dict(ops=_op_cases(2),
                                        train={ex: TRAIN for ex in MODELS}))
    args = [f"--nodes={TRAIN['nodes']}", f"--steps={TRAIN['steps']}",
            f"--hidden={TRAIN['hidden']}", "--p=2", "--device", "cpu", "--distributed"]
    mains = run_ranks(2, "cli", [[f"examples.{ex}", *args] for ex in MODELS])
    return {4: four, 2: two, "mains": mains}


def _slice(x, r):
    return x[r : r + 1]


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("cid", sorted(OPS))
def test_ops_on_ranks_equal_one_device(ranks, cid, p):
    """Each rank's C and dB shards, and for ``vps`` its value range, dvals,
    SDDMM and the SDDMM's gradients and index maps, equal the one-device
    op's slice bit for bit; every rank's host C and dB equal its."""
    case = _op_cases(p)[cid]
    one = op_results(case)
    assert one["kinds"] == (case["config"]["kernel"],) * 2
    for r, rank in enumerate(ranks[p]):
        got = rank["ops"][cid]
        assert got["kinds"] == one["kinds"]
        for key in ("c", "db") + (("dx", "dy", "fwd_idx", "bwd_idx")
                                  if case["op"] == "vps" else ()):
            assert got[key].dtype == one[key].dtype
            assert np.array_equal(got[key], _slice(one[key], r)), key
        for key in ("c_glob", "db_glob"):
            assert np.array_equal(got[key], one[key]), key
        if case["op"] == "vps":
            s, e = got["val_range"]
            a = case["a"]
            d = case["displs"]
            assert (s, e) == (a.rowptr[d[r]], a.rowptr[d[r + 1]])
            for key in ("dv", "sddmm"):
                assert got[key].shape == (e - s,)
                assert np.array_equal(got[key], one[key][s:e]), key
    # the ranks' value ranges cover A's nonzeros, in order
    if case["op"] == "vps":
        ends = [rank["ops"][cid]["val_range"] for rank in ranks[p]]
        assert ends[0][0] == 0 and ends[-1][1] == case["a"].nnz
        assert all(x[1] == y[0] for x, y in zip(ends, ends[1:]))


def _err(want, got):
    return rel_fro_err(np.asarray(want, np.float64).reshape(1, -1),
                       np.asarray(got, np.float64).reshape(1, -1))


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("op", ["diff", "vps"])
def test_ops_match_jax(devices8, op, p):
    """The one-device op (which every rank's slice equals) against JAX's on
    ``make_mesh_1d(p)`` (segsum): C, dB, and for ``vps`` dvals, the SDDMM
    and its two gradients, within 1e-5 for every kind."""
    cases = {cid: c for cid, c in _op_cases(p).items() if c["op"] == op}
    c0 = next(iter(cases.values()))
    a, d = c0["a"], c0["displs"]
    mesh = make_mesh_1d(p, devices=devices8)
    cfg = JaxConfig(kernel="segsum")
    if op == "vps":
        j = JaxVps(a, d, d, N, mesh=mesh, config=cfg, dtype=np.float32)
        fn = lambda bs, v: j.op(bs, v)  # noqa: E731
    else:
        j = JaxDiff(a, d, d, N, mesh=mesh, config=cfg, dtype=np.float32)
        fn = lambda bs, v: j.op(bs)  # noqa: E731
    bs, v = j.shard_b(c0["b"]), jnp.asarray(c0["v"])
    cj = fn(bs, v)
    dcs = jnp.asarray(shard_dense_rows(c0["dc"], j.fwd.A_row_displs,
                                       pad_rows=int(cj.shape[1])))
    gb, gv = jax.grad(lambda x, vv: jnp.sum(fn(x, vv) * dcs), argnums=(0, 1))(bs, v)
    want = dict(c_glob=j.unshard_c(cj), db_glob=j.unshard_db(gb))
    if op == "vps":
        md, kd = j.fwd.A_row_displs, j.fwd.B_row_displs
        xs = jnp.asarray(shard_dense_rows(c0["x"], md, pad_rows=int(j.fwd.max_m)))
        ys = jnp.asarray(shard_dense_rows(c0["y"], kd, pad_rows=int(j.fwd.max_k)))
        g = jnp.asarray(c0["g"])
        gx, gy = jax.grad(lambda x, y: jnp.sum(j.sddmm(x, y) * g), argnums=(0, 1))(xs, ys)
        want.update(dv=gv, sddmm=j.sddmm(xs, ys), dx=unshard_dense_rows(gx, md),
                    dy=unshard_dense_rows(gy, kd))
    for cid, case in cases.items():
        one = op_results(case)
        if op == "vps":
            one["dx"], one["dy"] = (unshard_dense_rows(one["dx"], md),
                                    unshard_dense_rows(one["dy"], kd))
        for key, w in want.items():
            assert np.shape(one[key]) == np.shape(w), (cid, key)
            assert _err(w, one[key]) <= TOL, (cid, key)


@pytest.mark.parametrize("example", MODELS)
def test_model_step_on_ranks(ranks, devices8, example):
    """One step of the model on 4 ranks from JAX's weights: every rank's
    loss and gradients, and its weights after two Adam steps, equal the
    one-device port's (4 shards) bit for bit; that run's loss is within
    1e-5 of JAX's step on its CPU mesh, its gradients within 1e-4, its
    weights within 1e-5 of optax's."""
    args = _model_args(example, 4)
    one = model_steps(example, *args)
    for rank in ranks[4]:
        got = rank["models"][example]
        assert np.array_equal(got["loss"], one["loss"])
        for part in ("grads", "params"):
            assert sorted(got[part]) == sorted(one[part])
            for k, w in one[part].items():
                assert np.array_equal(got[part][k], w), (part, k)
    _, params, x, labels, _ = args
    step = jax_gcn_step if example == "gcn_train" else jax_gat_step
    loss_j, grads_j, params_j = step(example_graph(example), 4,
                                     {k: v for k, v in params.items() if k != "p"},
                                     x, labels, devices8)
    assert abs(float(one["loss"]) - loss_j) <= TOL * abs(loss_j)
    for k, g in one["grads"].items():
        assert _err(grads_j[k], g) <= TOL_GRAD, k
    for k, w in one["params"].items():
        assert _err(params_j[k], w) <= TOL, k


@pytest.mark.parametrize("example", MODELS)
def test_train_on_ranks(ranks, example):
    """``train()`` on 2 ranks: the losses of every rank equal the one-device
    ``train(p=2)``'s bit for bit, and the accuracy passes 0.7."""
    one = TRAINERS[example].train(**TRAIN, p=2, device="cpu", log=None)
    for rank in ranks[2]:
        got = rank["train"][example]
        assert got["losses"] == one.losses
        assert got["accuracy"] == one.accuracy > 0.7


@pytest.mark.parametrize("example", MODELS)
def test_main_distributed(ranks, example):
    """``main([..., "--device", "cpu", "--distributed"])`` on 2 ranks exits 0
    on each, and rank 0 alone prints."""
    got = [rank[MODELS.index(example)] for rank in ranks["mains"]]
    assert [g["rc"] for g in got] == [0, 0]
    assert got[1]["out"] == ""
    assert "final accuracy" in got[0]["out"] and "2 shards" in got[0]["out"]
