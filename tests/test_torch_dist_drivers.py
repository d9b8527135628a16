"""The drivers under ``--distributed`` on 4 gloo ranks on the CPU
(``tests/torch_dist_ranks.py``; each rank runs ``main(argv)``, which joins
the group itself): rank 0 prints the record, the other ranks nothing, and
the record's host fields equal the one-process record's (every shard on
the one device), for every engine (``--engine=crp`` on the v1 planner's
grid).  And what stays refused across ranks: a mesh that is not the
engine's grid, and the training ops' stateful kinds, refused on a mesh as
without one."""

import json

import numpy as np
import pytest

from crp_tpu_torch.cli import bench_cli, suite_cli
from crp_tpu_torch.config import SpmmConfig
from crp_tpu_torch.engine.autodiff import DifferentiableSpmm
from crp_tpu_torch.engine.trainable import ValueParameterizedSpmm
from crp_tpu_torch.plan.partition1d import csr_row_partition
from crp_tpu_torch.sparse.synth import banded_random_csr

from tests.torch_dist_ranks import run_ranks

SPEC = "synth:banded:900:7:50"
BENCH = {
    "rowpara": ["bench_cli", SPEC, "16", "2", "0", "1", "--engine=rowpara",
                "--dtype=float64"],
    "para2d": ["bench_cli", SPEC, "24", "2", "0", "1", "--dtype=float64"],
    "crp": ["bench_cli", SPEC, "16", "2", "0", "1", "--engine=crp", "--dtype=float64"],
}
SUITE = {engine: ["suite_cli", "modes", SPEC, "16", "4", f"--engine={engine}",
                  "--dtype=float64", "--ntest=1", "--inner=1"]
         for engine in ("rowpara", "crp")}
# the fields a run's clock sets, the note that says whose clock, and the
# error (C is equal bit for bit, tests/test_torch_dist_rowpara.py; numpy's
# norms here sum in an order that follows the BLAS threads of the process)
TIMED = ("exec_s", "gflops", "plan_s", "init_s", "init_breakdown", "exec_note",
         "rel_fro_err")


def _one_process(argv, capsys):
    main = dict(bench_cli=bench_cli.main, suite_cli=suite_cli.main)[argv[0]]
    capsys.readouterr()
    assert main(argv[1:] + ["--device=cpu", "--devices=4"]) == 0
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def ranks():
    runs = {k: v + ["--device=cpu", "--distributed"] for k, v in BENCH.items()}
    runs.update({f"suite {k}": v + ["--device=cpu", "--distributed"]
                 for k, v in SUITE.items()})
    return {k: run_ranks(4, "cli", argv) for k, argv in runs.items()}


def _record_lines(out: str) -> list:
    """The bench record's lines a run's clock does not set (``crp``'s
    communicated elements in place of the other engines' comm sizes)."""
    keep = ("2D process grid", "Total SpMM comm size", "Physical exchanged rows",
            "||C_ref - C||", "Redist A  ", "Allgatherv A  ", "Redist B  ", "Alltoallv B ")
    return [ln for ln in out.splitlines() if ln.startswith(keep)]


@pytest.mark.parametrize("engine", sorted(BENCH))
def test_bench_cli_distributed(ranks, capsys, engine):
    got = ranks[engine]
    assert [r["rc"] for r in got] == [0] * 4
    assert all(r["out"] == "" for r in got[1:])  # rank 0 alone prints
    out = got[0]["out"]
    assert "Rank 0 of 4" in out
    assert len(_record_lines(out)) == (7 if engine == "crp" else 4)
    one = _one_process(BENCH[engine], capsys)
    assert _record_lines(out) == _record_lines(one)
    err = float(_record_lines(out)[-1].split("=")[-1])
    assert err <= 1e-12


@pytest.mark.parametrize("engine", sorted(SUITE))
def test_suite_cli_distributed(ranks, capsys, engine):
    got = ranks[f"suite {engine}"]
    assert [r["rc"] for r in got] == [0] * 4
    assert all(r["out"] == "" for r in got[1:])
    recs = [json.loads(ln) for ln in got[0]["out"].splitlines() if ln.startswith("{")]
    one = [json.loads(ln) for ln in _one_process(SUITE[engine], capsys).splitlines()
           if ln.startswith("{")]
    assert [r["mode"] for r in recs] == ["a2a", "ring", "overlap"]
    assert len(recs) == len(one)
    for r, o in zip(recs, one):
        assert "error" not in r, r
        assert r["exec_note"].startswith("one shard on each of 4 ranks")
        assert {k: v for k, v in r.items() if k not in TIMED} == {
            k: v for k, v in o.items() if k not in TIMED}
        assert r["rel_fro_err"] == pytest.approx(o["rel_fro_err"], rel=1e-9, abs=1e-30)
        assert r["rel_fro_err"] <= 1e-12


# the training ops' kinds a mesh refuses, as one device does: (op, config)
STATEFUL = {
    "autodiff dd": ("autodiff", dict(kernel="dd")),
    "autodiff dd_mxu": ("autodiff", dict(kernel="dd_mxu")),
    "autodiff pallas_halo": ("autodiff", dict(kernel="pallas_halo")),
    "autodiff bc_layout": ("autodiff", dict(kernel="segsum", bc_layout=1)),
    "trainable overlap": ("trainable", dict(kernel="segsum", overlap=1)),
    "trainable pallas": ("trainable", dict(kernel="pallas")),
}
OPS = dict(autodiff=DifferentiableSpmm, trainable=ValueParameterizedSpmm)


@pytest.fixture(scope="module")
def refused():
    a = banded_random_csr(400, 5, 20, seed=58)
    return a, run_ranks(2, "refusals", dict(
        a=a, displs=csr_row_partition(a.rowptr, 2), n=8, spec="synth:banded:400:5:20",
        kinds=STATEFUL))


@pytest.mark.parametrize("what,match", [
    ("grid", "a 2 x 1 mesh for a 1 x 1 grid"), *((what, None) for what in STATEFUL)])
def test_refused_across_ranks(refused, what, match):
    a, got = refused
    if match is None:  # the message the op gives on one device
        op, config = STATEFUL[what]
        d = csr_row_partition(a.rowptr, 2)
        with pytest.raises(ValueError) as one:
            OPS[op](a, d, d, 8, device="cpu", config=SpmmConfig(**config))
        match = str(one.value)
    for rank in got:
        assert match in rank[what]
