"""Run the port on a mesh of gloo ranks, one subprocess a rank: on the CPU,
or every rank on the one card (``engines_on_card``).

:func:`run_ranks` starts ``world`` copies of this file, each with the env
``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` / ``MASTER_PORT`` on localhost), hands each the same
pickled job, and returns every rank's pickled result.  A rank holds torch
to one thread (``torch_threads``), blocks ``jax`` and ``crp_tpu`` from
import (the port never needs them), joins the group through
``crp_tpu_torch.shard.layout.init_distributed(device="cpu")`` (gloo), and
runs one of the jobs below.  A rank that fails fails the run with its
stderr.
"""

from __future__ import annotations

import os
import pathlib
import pickle
import socket
import subprocess
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, job: str, payload, timeout: float = 240.0) -> list:
    """Each rank's result of ``job(payload)`` on ``world`` gloo ranks."""
    with tempfile.TemporaryDirectory(prefix="crp_ranks_") as d:
        d = pathlib.Path(d)
        (d / "in.pkl").write_bytes(pickle.dumps((job, payload)))
        port = free_port()
        procs = []
        for r in range(world):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK="0",
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]),
                       OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen(
                [sys.executable, __file__, str(d / "in.pkl"), str(d / f"out{r}.pkl")],
                env=env, cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        errors = []
        for r, proc in enumerate(procs):
            try:
                out, err = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            if proc.returncode:
                errors.append(f"rank {r} exited {proc.returncode}:\n{out}\n{err}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return [pickle.loads((d / f"out{r}.pkl").read_bytes()) for r in range(world)]


def bits(t) -> "np.ndarray":
    """A tensor's values as numpy, bf16 as its int16 bits (numpy has no
    bf16): equal arrays, equal bits."""
    import torch

    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).cpu().numpy()


# --------------------------------------------------------------- the jobs


def _engine(case, mesh):
    """The case's engine on ``mesh`` (or on one device, mesh None)."""
    from crp_tpu_torch.config import SpmmConfig
    from crp_tpu_torch.engine.para2d import Para2dSpmm
    from crp_tpu_torch.engine.rowpara import RowParaSpmm
    from crp_tpu_torch.shard.dist_a import DistCSR

    if "ring_block_bytes" in case:  # overlap's segment-sum chunks, as the test sets them
        from crp_tpu_torch.comm import ring

        ring.SEGSUM_BLOCK_BYTES = case["ring_block_bytes"]
    config = SpmmConfig(**case.get("config", {}))
    a, dtype, device = case["a"], case["dtype"], mesh.device
    if case["engine"] == "rowpara":
        return RowParaSpmm(a, case["displs"], case["displs"], case["n"], device=device,
                           config=config, dtype=dtype, mesh=mesh)
    if case["engine"] == "para2d":
        return Para2dSpmm(a, case["plan"], device=device, config=config, dtype=dtype,
                          mesh=mesh)
    dist_a = DistCSR.from_global(a, case["plan"].A0_rowptr)
    return Para2dSpmm.from_dist_a(dist_a, case["plan"], device=device, config=config,
                                  dtype=dtype, mesh=mesh)


def engines(cases) -> list:
    """Each case's engine on the world's mesh (1D for ``rowpara``, the
    plan's grid otherwise): the global C of ``exec`` (twice: a second exec
    repeats the first), this rank's C shard, its packed arrays, and the
    engine's counts and decisions."""
    import torch.distributed as dist

    from crp_tpu_torch.shard.layout import make_mesh_1d, make_mesh_2d

    world = dist.get_world_size()
    out = []
    for case in cases:
        if case["engine"] == "rowpara":
            mesh = make_mesh_1d(world)
        else:
            mesh = make_mesh_2d(case["plan"].pm, case["plan"].pn)
        eng = _engine(case, mesh)
        c = eng.exec(case["b"])
        again = eng.exec(case["b"])
        bs, again_bs = eng.shard_b(case["b"]), eng.shard_b(case["b"])
        shard = eng.exec_device(bs)
        # shard_b's results are new tensors: neither each other nor the engine's buffer
        held = {bs.data_ptr(), again_bs.data_ptr()}
        if getattr(eng, "peers", None) is not None:
            held.add(eng.peers.buf.data_ptr())
        stat = eng.print_stat()
        out.append(dict(
            c=c, again=again, shard=bits(shard), packed=[bits(x) for x in eng.packed],
            kernel_kind=eng.kernel_kind, rB_recv_size=eng.rB_recv_size,
            aliased=len(held) < 2 + (getattr(eng, "peers", None) is not None),
            physical_rows=eng.physical_rows, pi=mesh.pi, pj=mesh.pj, stat=stat,
            halo_rows_pushed=getattr(eng._local_op, "halo_rows_pushed", None),
        ))
        eng.close()
    return out


def crp_engines(cases) -> list:
    """Each case's ``CrpSpmm`` on the mesh of its plan's grid: the global C
    of ``exec`` (twice), this rank's user C block (``exec_device`` on its
    user B block), its packed arrays, the counters, decisions and stat
    table.  ``dist``: A as a ``DistCSR`` of which this rank holds block r
    alone (the other blocks' colidx and val are None, so that a read of
    them fails); ``plan_here``: the engine plans itself (from every
    rank's row ranges), else the case's plan is given."""
    from crp_tpu_torch.config import SpmmConfig
    from crp_tpu_torch.engine.crp import CrpSpmm
    from crp_tpu_torch.shard.dist_a import DistCSR
    from crp_tpu_torch.shard.layout import make_mesh_2d

    out = []
    for case in cases:
        if "ring_block_bytes" in case:
            from crp_tpu_torch.comm import ring

            ring.SEGSUM_BLOCK_BYTES = case["ring_block_bytes"]
        bp = case["bplan"]
        mesh = make_mesh_2d(bp.np_row, bp.np_col)
        a = case["a"]
        if case.get("dist") is not None:
            a = DistCSR.from_global(a, case["dist"])
            a.colidxs = [x if i == mesh.rank else None for i, x in enumerate(a.colidxs)]
            a.vals = [x if i == mesh.rank else None for i, x in enumerate(a.vals)]
        eng = CrpSpmm(a, case["n"], case["user_B"], case["user_C"], dtype=case["dtype"],
                      config=SpmmConfig(**case["config"]), mesh=mesh,
                      bplan=None if case.get("plan_here") else bp)
        c = eng.exec(case["b"])
        again = eng.exec(case["b"])
        bs, again_bs = eng.rd_B.shard_src(case["b"]), eng.rd_B.shard_src(case["b"])
        block = eng.exec_device(bs)
        held = {bs.data_ptr(), again_bs.data_ptr()}
        if eng.peers is not None:
            held.add(eng.peers.buf.data_ptr())
        out.append(dict(
            c=c, again=again, block=bits(block), packed=[bits(x) for x in eng.packed],
            kernel_kind=eng.kernel_kind, is_halo=eng.is_halo, grid=(eng.pm, eng.pn),
            counters={k: getattr(eng, k) for k in CRP_COUNTERS},
            aliased=len(held) < 2 + (eng.peers is not None), stat=eng.print_stat(),
            pi=mesh.pi, pj=mesh.pj, device=str(eng.device)))
        eng.close()
    return out


CRP_COUNTERS = ("nelem_A_rd", "nelem_A_agv", "nelem_B_rd", "nelem_B_a2av",
                "nelem_B_a2av_min", "physical_rows")


def _redist(cases, mesh) -> list:
    """Each case's ``RedistEngine`` on ``mesh``: this rank's destination
    block from its source block, the gathered global matrix, and the
    audit's volumes."""
    from crp_tpu_torch.shard.redist import RedistEngine

    out = []
    for case in cases:
        eng = RedistEngine(case["src"], case["dst"], dtype=case["x"].dtype, mesh=mesh)
        xs = eng.shard_src(case["x"])
        y = eng.exec_device(xs)
        out.append(dict(block=bits(y), shape=tuple(xs.shape),
                        glob=eng.unshard_dst(y, *case["x"].shape),
                        nelem=(eng.nelem_dst, eng.nelem_moved, eng.nelem_physical)))
    return out


def _ingest(cases, mesh) -> list:
    """Each case's ``ingest_dist_a`` on ``mesh`` (this rank holding block r
    alone): the panels' arrays and the two counters."""
    from crp_tpu_torch.shard.dist_a import DistCSR, ingest_dist_a

    out = []
    for case in cases:
        d = DistCSR.from_global(case["a"], case["displs"])
        d.colidxs = [x if i == mesh.rank else None for i, x in enumerate(d.colidxs)]
        d.vals = [x if i == mesh.rank else None for i, x in enumerate(d.vals)]
        panels, rd, agv = ingest_dist_a(d, case["m_split_idx"], mesh.pm, mesh.pn,
                                        mesh.device, val_dtype=case["dtype"], mesh=mesh)
        out.append(dict(panels=[(x.nrow, x.ncol, x.rowptr, x.colidx, x.val) for x in panels],
                        counters=(rd, agv)))
    return out


def crp(payload) -> dict:
    """The any-layout engine's pieces on the world's ranks:
    ``RedistEngine`` on the world's p x 1 mesh (``redist``),
    ``ingest_dist_a`` on each case's grid (``ingest``), and ``CrpSpmm``
    (``engines``, :func:`crp_engines`)."""
    import torch.distributed as dist

    from crp_tpu_torch.shard.layout import make_mesh_1d, make_mesh_2d

    refused = None
    try:  # a mesh that is not the planner's grid
        from crp_tpu_torch.engine.crp import CrpSpmm

        case = payload["engines"][0]
        CrpSpmm(case["a"], case["n"], case["user_B"], case["user_C"], bplan=case["bplan"],
                mesh=make_mesh_2d(1, dist.get_world_size()) if case["bplan"].np_row > 1
                else make_mesh_1d(dist.get_world_size()))
    except ValueError as e:
        refused = str(e)
    return dict(
        refused=refused,
        redist=_redist(payload["redist"], make_mesh_1d(dist.get_world_size())),
        ingest=[_ingest([c], make_mesh_2d(*c["grid"]))[0] for c in payload["ingest"]],
        engines=crp_engines(payload["engines"]))


def mesh_layout(_) -> dict:
    """This rank's device, and its place on every grid of the world."""
    import torch.distributed as dist

    from crp_tpu_torch.shard.layout import make_mesh_2d, make_mesh_auto

    world = dist.get_world_size()
    grids = {}
    for pm in range(1, world + 1):
        if world % pm == 0:
            m = make_mesh_2d(pm, world // pm)
            auto = make_mesh_auto(pm, world // pm)
            grids[(pm, world // pm)] = dict(
                auto=(auto.pi, auto.pj, auto.row_ranks, auto.col_ranks),
                pi=m.pi, pj=m.pj, row_ranks=m.row_ranks, col_ranks=m.col_ranks,
                backend=str(dist.get_backend(m.group)), device=str(m.device),
                row_size=None if m.row_group is None else dist.get_world_size(m.row_group),
                col_size=None if m.col_group is None else dist.get_world_size(m.col_group))
    refused = None
    try:
        make_mesh_2d(world + 1, 1)
    except ValueError as e:
        refused = str(e)
    return dict(rank=dist.get_rank(), world=world, grids=grids, refused=refused)


def direct_group(_) -> dict:
    """A mesh over a group the rank joined through ``dist.init_process_group``
    itself (not ``init_distributed``): its default device, or the refusal,
    and the device when the CPU is asked for."""
    from crp_tpu_torch.shard.layout import make_mesh_1d

    import torch.distributed as dist

    world = dist.get_world_size()
    try:
        default = str(make_mesh_1d(world).device)
    except RuntimeError as e:
        default = f"refused: {e}"
    return dict(default=default, asked=str(make_mesh_1d(world, device="cpu").device))


def refusals(case) -> dict:
    """What the port refuses on the world's 1D mesh: an engine on a mesh
    that is not its grid, and the training ops' stateful kinds (each
    refusal's message; ``case["kinds"]`` maps a case id to (op, config))."""
    from crp_tpu_torch.config import SpmmConfig
    from crp_tpu_torch.engine.autodiff import DifferentiableSpmm
    from crp_tpu_torch.engine.rowpara import RowParaSpmm
    from crp_tpu_torch.engine.trainable import ValueParameterizedSpmm
    from crp_tpu_torch.shard.layout import make_mesh_1d

    import torch.distributed as dist

    world = dist.get_world_size()
    mesh = make_mesh_1d(world)
    got = {}
    d = case["displs"]
    try:
        RowParaSpmm(case["a"], d[:2] if len(d) > 2 else d, d[:2] if len(d) > 2 else d,
                    case["n"], device="cpu", mesh=mesh)
    except ValueError as e:
        got["grid"] = str(e)
    ops = dict(autodiff=DifferentiableSpmm, trainable=ValueParameterizedSpmm)
    for cid, (op, config) in case["kinds"].items():
        try:
            ops[op](case["a"], d, d, case["n"], config=SpmmConfig(**config), mesh=mesh)
        except ValueError as e:
            got[cid] = str(e)
    return got


# --------------------------------------------------------------- training


def _train_op(case, mesh):
    """The case's training op (``DifferentiableSpmm``, or
    ``ValueParameterizedSpmm`` for ``op="vps"``) on ``mesh``, or on the CPU
    with every shard (mesh None)."""
    from crp_tpu_torch.config import SpmmConfig
    from crp_tpu_torch.engine.autodiff import DifferentiableSpmm
    from crp_tpu_torch.engine.trainable import ValueParameterizedSpmm

    cls = ValueParameterizedSpmm if case["op"] == "vps" else DifferentiableSpmm
    d = case["displs"]
    return cls(case["a"], d, d, case["n"], device=None if mesh else "cpu",
               config=SpmmConfig(**case["config"]), dtype=case["dtype"], mesh=mesh)


def op_results(case, mesh=None) -> dict:
    """The case's op on its inputs, for the shards it holds (every shard on
    one device, mesh None): C and dB (from ``dc``) shards, and for ``vps``
    the values' range, dvals, the SDDMM of X (C's rows) and Y (B's rows)
    and its two gradients (from ``g``), the index maps; each as its bits,
    and the global C and dB the op's host calls return."""
    import torch

    from crp_tpu_torch.shard.layout import shard_dense_rows

    op = _train_op(case, mesh)
    held = [op.fwd.rank] if mesh is not None else list(range(op.fwd.p))

    def shards(x, displs, rows):
        return torch.from_numpy(shard_dense_rows(x, displs, pad_rows=rows)[held])

    bs = op.shard_b(case["b"]).requires_grad_(True)
    out = dict(kinds=(op.fwd.kernel_kind, op.bwd.kernel_kind))
    if case["op"] == "vps":
        s, e = op.val_range
        v = torch.from_numpy(case["v"][s:e]).requires_grad_(True)
        cs = op(bs, v)
        dcs = shards(case["dc"], op.fwd.A_row_displs, cs.shape[1])
        db, dv = torch.autograd.grad(cs, (bs, v), dcs)
        xs = shards(case["x"], op.fwd.A_row_displs, op.fwd.max_m).requires_grad_(True)
        ys = shards(case["y"], op.fwd.B_row_displs, op.fwd.max_k).requires_grad_(True)
        sd = op.sddmm(xs, ys)
        dx, dy = torch.autograd.grad(sd, (xs, ys), torch.from_numpy(case["g"][s:e]))
        out.update(val_range=(s, e), dv=bits(dv), sddmm=bits(sd), dx=bits(dx),
                   dy=bits(dy), fwd_idx=bits(op.fwd_idx), bwd_idx=bits(op.bwd_idx))
    else:
        cs = op(bs)
        dcs = shards(case["dc"], op.fwd.A_row_displs, cs.shape[1])
        (db,) = torch.autograd.grad(cs, bs, dcs)
    out.update(c=bits(cs), db=bits(db), c_glob=op.unshard_c(cs), db_glob=op.unshard_db(db))
    return out


def model_steps(example: str, graph, params: dict, x, labels, lr: float,
                mesh=None, steps: int = 2) -> dict:
    """The example's model on ``graph`` (``gcn_train``: A_hat, ``gat_train``:
    A + I) at p shards (the mesh's, else ``params["p"]``), from ``params``
    (the JAX example's weights): one step's loss and every weight's
    gradient, then the weights after ``steps`` Adam steps; as bits."""
    import importlib

    import torch

    from crp_tpu_torch.examples import common

    ex = importlib.import_module(f"crp_tpu_torch.examples.{example}")
    p = mesh.pm if mesh is not None else params["p"]
    kw = dict(device=None if mesh else "cpu", mesh=mesh)
    classes, hidden = params["w1"].shape
    if example == "gcn_train":
        model = ex.GCN(*ex.gcn_ops(graph, p, classes, hidden, **kw), graph.nrow, classes,
                       hidden)
        model.load_state_dict(ex.gcn_params_from_jax(params))
    else:
        model = ex.GAT(*ex.gat_ops(graph, p, classes, hidden, **kw), graph.rowptr,
                       classes, hidden)
        model.load_state_dict(ex.gat_params_from_jax(params))
    xs = model.engines[0].shard_b(x)
    ys = model.rows.take(labels, xs.device)
    loss = common.loss(model, xs, ys)
    loss.backward()
    grads = {k: bits(w.grad) for k, w in model.named_parameters()}
    model.zero_grad()
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    for _ in range(steps):
        opt.zero_grad()
        common.loss(model, xs, ys).backward()
        opt.step()
    return dict(loss=bits(loss.detach()), grads=grads,
                params={k: bits(w.detach()) for k, w in model.named_parameters()})


def training(payload) -> dict:
    """Training across the world's ranks on its 1D mesh: each op case
    (:func:`op_results`), each model's steps (:func:`model_steps`), and
    ``train()`` of each example (its losses and accuracy)."""
    import importlib

    import torch.distributed as dist

    from crp_tpu_torch.shard.layout import make_mesh_1d

    mesh = make_mesh_1d(dist.get_world_size())
    out = dict(ops={cid: op_results(case, mesh) for cid, case in payload.get("ops", {}).items()},
               models={name: model_steps(name, *args, mesh=mesh)
                       for name, args in payload.get("models", {}).items()})
    out["train"] = {}
    for name, kw in payload.get("train", {}).items():
        res = importlib.import_module(f"crp_tpu_torch.examples.{name}").train(
            **kw, p=mesh.pm, mesh=mesh, log=None)
        out["train"][name] = dict(losses=res.losses, accuracy=res.accuracy)
    return out


def cli(argv) -> dict:
    """A driver's ``main(argv)`` under the world's ranks: its exit code and
    what it printed.  ``module`` names ``crp_tpu_torch.cli.<module>``, or,
    dotted, ``crp_tpu_torch.<module>`` (a trainer); a list of argvs runs
    each in turn, in one process, and returns their results."""
    import contextlib
    import importlib
    import io

    if isinstance(argv[0], list):
        return [cli(one) for one in argv]
    module, *args = argv
    main = importlib.import_module(
        f"crp_tpu_torch.{module}" if "." in module else f"crp_tpu_torch.cli.{module}").main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    return dict(rc=rc, out=buf.getvalue())


def loaded(case) -> dict:
    """The mesh modules at work on this rank (both engines, the fused
    kernel's plain version across ranks, both exchanges, the ring), and
    every module the rank then holds."""
    from crp_tpu_torch import Para2dSpmm, RowParaSpmm, SpmmConfig, rel_fro_err
    from crp_tpu_torch.shard.layout import make_mesh_1d, make_mesh_2d

    a, d, b, plan = case["a"], case["displs"], case["b"], case["plan"]
    ref = a.spmm_ref(b)
    errs = {}
    for kw in (dict(kernel="segsum"), dict(kernel="segsum", rb_p2p=1),
               dict(kernel="pallas_halo"), dict(kernel="segsum", overlap=1)):
        eng = RowParaSpmm(a, d, d, b.shape[1], device="cpu", config=SpmmConfig(**kw),
                          mesh=make_mesh_1d(len(d) - 1))
        errs[f"rowpara {kw}"] = rel_fro_err(ref, eng.exec(b))
        eng.close()
    eng = Para2dSpmm(a, plan, device="cpu", mesh=make_mesh_2d(plan.pm, plan.pn))
    errs["para2d"] = rel_fro_err(ref, eng.exec(b))
    return dict(errs=errs, modules=sorted(m for m, v in sys.modules.items() if v is not None))


def halo_flags(cases) -> list:
    """The fused kernel's counts across the world's ranks: each case's
    engine (``_engine``'s, or ``CrpSpmm`` where the case has a ``bplan``)
    on its mesh runs one ``exec_device`` for each B of ``case["bs"]``
    (this rank's C block as bits, and the peers' load and launch counts,
    whether the buffer holds what ``load`` wrote, and the host barriers
    and stream drains ``HaloPeers`` made, after each); then a write into
    the buffer outside ``load`` (every rank: the next launch refuses it),
    then a status word set on every rank: ``unshard_c`` (after its gather)
    and the next ``exec`` raise ``HaloTimeout``, and so does ``close``,
    after its teardown.  Each refusal's message."""
    import torch

    from crp_tpu_torch.config import SpmmConfig
    from crp_tpu_torch.engine.crp import CrpSpmm
    from crp_tpu_torch.kernels.spmm_halo import HaloTimeout
    from crp_tpu_torch.shard.layout import make_mesh_1d, make_mesh_2d

    import torch.distributed as dist

    out = []
    for case in cases:
        if "bplan" in case:
            bp = case["bplan"]
            eng = CrpSpmm(case["a"], case["n"], case["user_B"], case["user_C"],
                          dtype=case["dtype"], config=SpmmConfig(**case["config"]),
                          mesh=make_mesh_2d(bp.np_row, bp.np_col), bplan=bp)
            shard = eng.rd_B.shard_src
        else:
            mesh = (make_mesh_1d(dist.get_world_size()) if case["engine"] == "rowpara"
                    else make_mesh_2d(case["plan"].pm, case["plan"].pn))
            eng = _engine(case, mesh)
            shard = eng.shard_b
        peers = eng.peers
        got = dict(kind=eng.kernel_kind, blocks=[], counts=[])
        for b in case["bs"]:
            got["blocks"].append(bits(eng.exec_device(shard(b))))
            got["counts"].append(dict(epoch=peers.epoch, launches=peers.launches,
                                      written=peers.written(), barriers=peers.barriers,
                                      drains=peers.drains))
        with torch.no_grad():
            peers.buf.add_(1)  # a write that bypasses load
        try:
            eng._local_op(eng.packed, peers.buf, peers=peers)
        except RuntimeError as e:
            got["bypass"] = str(e)
        b = case["bs"][0]
        c = eng.exec_device(shard(b))
        peers.status[0] = 1  # as a kernel sets it: chunk 0's owner did not arrive
        raised = got["raised"] = {}
        if "bplan" not in case:
            try:
                eng.unshard_c(c)
            except HaloTimeout as e:
                raised["unshard_c"] = str(e)
        for where, fn in (("exec", lambda: eng.exec(b)), ("close", eng.close)):
            try:
                fn()
            except HaloTimeout as e:
                raised[where] = str(e)
        got["closed"] = peers.views is None
        out.append(got)
    return out


JOBS = dict(engines=engines, engines_on_card=engines, crp=crp, halo_flags=halo_flags,
            mesh_layout=mesh_layout, training=training,
            refusals=refusals, cli=cli, loaded=loaded, direct_group=direct_group)


def _main(inp: str, out: str) -> None:
    sys.modules["jax"] = None
    sys.modules["crp_tpu"] = None
    import torch_threads  # noqa: F401  one intra-op thread

    import torch.distributed as dist

    from crp_tpu_torch.shard.layout import init_distributed

    job, payload = pickle.loads(pathlib.Path(inp).read_bytes())
    if job == "engines_on_card":  # every rank on the one card: gloo for the control
        init_distributed(backend="gloo")  # plane (NCCL refuses two ranks on a device)
    elif job == "direct_group":  # as a user who calls torch.distributed alone
        dist.init_process_group("gloo", init_method="env://")
    elif job != "cli":  # a driver joins the group itself (--distributed)
        init_distributed(device="cpu")
    result = JOBS[job](payload)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    pathlib.Path(out).write_bytes(pickle.dumps(result))


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2])
