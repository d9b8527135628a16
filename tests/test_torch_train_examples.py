"""The port's trainers (``crp_tpu_torch/examples``) against the JAX
package's examples (``examples/gcn_train.py``, ``examples/gat_train.py``)
on the CPU: from the same weights, carried across by
``gcn_params_from_jax`` / ``gat_params_from_jax``, one step's loss within
1e-5 (relative) and its gradients within 1e-4 (relative Frobenius) of
JAX's, and the weights after two Adam steps within 1e-5 of optax's.  Then
each port ``train()`` in-process: the loss falls and the accuracy passes
0.7."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from crp_tpu.config import SpmmConfig as JaxConfig
from crp_tpu.engine.autodiff import DifferentiableSpmm as JaxDiff
from crp_tpu.engine.trainable import ValueParameterizedSpmm as JaxVps
from crp_tpu.plan.partition1d import csr_row_partition
from crp_tpu.shard.layout import make_mesh_1d
from crp_tpu.sparse.synth import powerlaw_community_csr
from crp_tpu.utils.norms import rel_fro_err

from crp_tpu_torch.examples import common, gat_train, gcn_train
from crp_tpu_torch.examples.common import community_graph, community_task

REPO = pathlib.Path(__file__).resolve().parents[1]
NODES, CLASSES, HIDDEN, P = 400, 8, 16, 2
TOL_LOSS, TOL_GRAD, TOL_PARAMS = 1e-5, 1e-4, 1e-5


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _layout(displs, nn):
    """The JAX examples' (p, rows, w) <-> (nodes, w) maps."""
    p = len(displs) - 1

    def unpad(cs):
        out = jnp.concatenate([cs[i, : int(displs[i + 1] - displs[i])] for i in range(p)])
        return jnp.pad(out, ((0, nn - out.shape[0]), (0, 0)))

    def repad(xg, rows):
        parts = [xg[int(displs[i]): int(displs[i + 1])] for i in range(p)]
        return jnp.stack([jnp.pad(q, ((0, rows - q.shape[0]), (0, 0))) for q in parts])

    return unpad, repad


def _jax_adam(loss_fn, params, args, lr, steps=2):
    """(loss, grads) at ``params``, and the params after ``steps`` optax
    Adam steps (``examples/gcn_train.py:127-135``)."""
    loss, grads = jax.value_and_grad(loss_fn)(params, *args)
    opt = optax.adam(lr)
    state = opt.init(params)
    for _ in range(steps):
        g = jax.grad(loss_fn)(params, *args)
        updates, state = opt.update(g, state)
        params = optax.apply_updates(params, updates)
    return float(loss), grads, params


def _torch_adam(model, inputs, labels, lr, steps=2):
    """The port's (loss, grads) and ``steps`` Adam steps; the model takes
    and returns row shards, and its loss sums them in shard order."""
    ys = model.rows.take(labels, "cpu")
    loss = common.loss(model, inputs, ys)
    loss.backward()
    grads = {k: w.grad.clone() for k, w in model.named_parameters()}
    model.zero_grad()
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    for _ in range(steps):
        opt.zero_grad()
        common.loss(model, inputs, ys).backward()
        opt.step()
    return float(loss.detach()), grads


def _assert_step_matches(loss_j, grads_j, params_j, loss_t, grads_t, model):
    assert abs(loss_t - loss_j) <= TOL_LOSS * abs(loss_j)
    for k, g in grads_t.items():
        assert rel_fro_err(np.asarray(grads_j[k], np.float64).reshape(1, -1),
                           g.numpy().reshape(1, -1)) <= TOL_GRAD, k
    for k, w in model.named_parameters():
        assert rel_fro_err(np.asarray(params_j[k], np.float64).reshape(1, -1),
                           w.detach().numpy().reshape(1, -1)) <= TOL_PARAMS, k


def test_graph_and_task_match_the_jax_examples():
    g_j = powerlaw_community_csr(NODES, avg_degree=8, comm_size=NODES // CLASSES, seed=5)
    g_t = community_graph(NODES, CLASSES)
    for build_j, build_t in (
        (_jax_example("gcn_train").normalized_adjacency, gcn_train.normalized_adjacency),
        (_jax_example("gat_train").pattern_with_self_loops,
         gat_train.pattern_with_self_loops),
    ):
        a_j, a_t = build_j(g_j), build_t(g_t)
        assert np.array_equal(a_j.rowptr, a_t.rowptr)
        assert np.array_equal(a_j.colidx, a_t.colidx)
        np.testing.assert_allclose(a_t.val, a_j.val, rtol=1e-15)
    x, y = community_task(NODES, CLASSES)
    rng = np.random.default_rng(6)
    comm = np.minimum(np.arange(NODES) // (NODES // CLASSES), CLASSES - 1)
    want = np.eye(CLASSES, dtype=np.float32)[comm] + 0.5 * rng.standard_normal(
        (NODES, CLASSES)).astype(np.float32)
    assert np.array_equal(x, want) and np.array_equal(y, comm)


def example_graph(example: str, nodes: int = NODES, classes: int = CLASSES):
    """The JAX example's graph: A_hat for ``gcn_train``, A + I for
    ``gat_train``."""
    g = powerlaw_community_csr(nodes, avg_degree=8, comm_size=nodes // classes, seed=5)
    if example == "gcn_train":
        return _jax_example("gcn_train").normalized_adjacency(g)
    return _jax_example("gat_train").pattern_with_self_loops(g)


def jax_params(example: str, classes: int = CLASSES, hidden: int = HIDDEN) -> dict:
    """The JAX examples' weights, N(0, 1) x 0.3 from ``PRNGKey(i)``, as numpy."""
    shapes = {"w1": (classes, hidden), "w2": (hidden, classes)}
    if example == "gat_train":
        shapes = {"w1": (classes, hidden), "a1s": (hidden,), "a1d": (hidden,),
                  "w2": (hidden, classes), "a2s": (classes,), "a2d": (classes,)}
    return {k: np.asarray(jax.random.normal(jax.random.PRNGKey(i), s) * 0.3)
            for i, (k, s) in enumerate(shapes.items())}


def jax_gcn_step(ah, p, params, x, labels, devices):
    """The JAX GCN (``examples/gcn_train.py:113-125``) on ``make_mesh_1d(p)``:
    (loss, grads, the weights after two optax Adam steps)."""
    nodes, classes = x.shape
    hidden = params["w1"].shape[1]
    displs = csr_row_partition(ah.rowptr, p)
    mesh = make_mesh_1d(p, devices=devices)
    cfg = JaxConfig(kernel="segsum")
    prop_in = JaxDiff(ah, displs, displs, classes, mesh=mesh, config=cfg)
    prop_h = JaxDiff(ah, displs, displs, hidden, mesh=mesh, config=cfg)
    unpad, repad = _layout(displs, nodes)
    h_rows = int(prop_h.fwd.max_k)

    def loss_fn(params, xs_, y_):
        h = jax.nn.relu(unpad(prop_in.op(xs_)) @ params["w1"])
        logits = unpad(prop_h.op(repad(h, h_rows))) @ params["w2"]
        return optax.softmax_cross_entropy_with_integer_labels(logits, y_).mean()

    params = {k: jnp.asarray(v) for k, v in params.items()}
    return _jax_adam(loss_fn, params, (prop_in.shard_b(x), jnp.asarray(labels)),
                     gcn_train.LR)


def jax_gat_step(ah, p, params, x, labels, devices):
    """The JAX GAT (``examples/gat_train.py:107-147``) on ``make_mesh_1d(p)``:
    (loss, grads, the weights after two optax Adam steps)."""
    nodes, classes = x.shape
    hidden = params["w1"].shape[1]
    displs = csr_row_partition(ah.rowptr, p)
    mesh = make_mesh_1d(p, devices=devices)
    vps_h = JaxVps(ah, displs, displs, hidden, mesh=mesh)
    vps_o = JaxVps(ah, displs, displs, classes, mesh=mesh)
    unpad, repad = _layout(displs, nodes)
    m_pad, k_pad = int(vps_h.fwd.max_m), int(vps_h.fwd.max_k)
    rows_g = jnp.asarray(np.repeat(np.arange(nodes, dtype=np.int32), np.diff(ah.rowptr)))

    def gat_layer(vps, h, w, a_src, a_dst):
        hw = h @ w
        s, d = hw @ a_src, hw @ a_dst
        ones = jnp.ones_like(s)
        e = vps.sddmm(repad(jnp.stack([s, ones], 1), m_pad),
                      repad(jnp.stack([ones, d], 1), k_pad))
        e = jax.nn.leaky_relu(e, 0.2)
        emax = jax.ops.segment_max(e, rows_g, num_segments=nodes, indices_are_sorted=True)
        ex = jnp.exp(e - emax[rows_g])
        den = jax.ops.segment_sum(ex, rows_g, num_segments=nodes, indices_are_sorted=True)
        alpha = ex / jnp.maximum(den[rows_g], 1e-12)
        return unpad(vps.op(repad(hw, k_pad), alpha))

    def loss_fn(params, xg_, y_):
        h = jax.nn.elu(gat_layer(vps_h, xg_, params["w1"], params["a1s"], params["a1d"]))
        logits = gat_layer(vps_o, h, params["w2"], params["a2s"], params["a2d"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, y_).mean()

    params = {k: jnp.asarray(v) for k, v in params.items()}
    return _jax_adam(loss_fn, params, (jnp.asarray(x), jnp.asarray(labels)), gat_train.LR)


def test_gcn_step_matches_jax(devices8):
    ah = example_graph("gcn_train")
    x, labels = community_task(NODES, CLASSES)
    params = jax_params("gcn_train")
    loss_j, grads_j, params_j = jax_gcn_step(ah, P, params, x, labels, devices8)

    model = gcn_train.GCN(*gcn_train.gcn_ops(ah, P, CLASSES, HIDDEN, device="cpu"),
                          NODES, CLASSES, HIDDEN)
    model.load_state_dict(gcn_train.gcn_params_from_jax(params))
    loss_t, grads_t = _torch_adam(model, model.prop_in.shard_b(x), labels, gcn_train.LR)
    _assert_step_matches(loss_j, grads_j, params_j, loss_t, grads_t, model)


def test_gat_step_matches_jax(devices8):
    ah = example_graph("gat_train")
    x, labels = community_task(NODES, CLASSES)
    params = jax_params("gat_train")
    loss_j, grads_j, params_j = jax_gat_step(ah, P, params, x, labels, devices8)

    model = gat_train.GAT(*gat_train.gat_ops(ah, P, CLASSES, HIDDEN, device="cpu"),
                          ah.rowptr, CLASSES, HIDDEN)
    model.load_state_dict(gat_train.gat_params_from_jax(params))
    loss_t, grads_t = _torch_adam(model, model.vps_h.shard_b(x), labels, gat_train.LR)
    _assert_step_matches(loss_j, grads_j, params_j, loss_t, grads_t, model)


@pytest.mark.parametrize("example", [gcn_train, gat_train])
def test_train_learns_in_process(example):
    res = example.train(nodes=800, steps=12, p=2, hidden=16, device="cpu", log=None)
    assert len(res.losses) == len(res.step_s) == 12
    assert res.losses[-1] < res.losses[0]
    assert res.accuracy > 0.7
    assert all(e.fwd.device.type == "cpu" for e in res.engines)
    again = example.train(nodes=800, steps=3, p=2, hidden=16, device="cpu", log=None,
                          model=res.model)
    assert again.losses == res.losses[:3]  # the same seed, the same engines
