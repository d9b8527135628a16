"""The port's drivers (``crp_tpu_torch/cli/bench_cli.py`` and
``suite_cli.py``) against the JAX package's, on the same argv: the JAX
CLI on the 8-device CPU mesh, as its own tests run it
(``tests/test_reorder_cli.py``), the port's with ``--device=cpu``.

Suite records are compared field by field in what the host decides
(``matrix``, ``n``, ``p``, ``pm``, ``pn``, ``mode``, ``comm``,
``kernel_resolved``, ``kernel_detail``, ``planner``); ``exec_s`` is a
time and is not compared.  The bench drivers' printed grid and comm
volumes are compared line by line.  Both packages' errors are held to the
class of the run: <= 1e-12 relative Frobenius in fp64, <= 1e-5 in fp32.
"""

import json
import re

import pytest

from crp_tpu.cli import bench_cli as jbench
from crp_tpu.cli import suite_cli as jsuite

from crp_tpu_torch.cli import bench_cli as tbench
from crp_tpu_torch.cli import suite_cli as tsuite

RECORD_FIELDS = ("matrix", "n", "p", "pm", "pn", "mode", "comm", "kernel_resolved",
                 "kernel_detail", "planner")
TOL_F64, TOL_F32 = 1e-12, 1e-5
# the printed lines that hold host decisions, not times: the grid and the
# integer counts (communicated elements, exchanged rows)
HOST_LINE = re.compile(r"^[^.]*\d\s*$")


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    assert rc == 0, out
    return out


def _records(out):
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def _bench_err(out):
    assert "||C_ref - C||_f" in out
    return float(out.strip().splitlines()[-1].split("=")[-1])


def _as_jax(rec, field):
    """The port's record ``field`` as JAX's: at ``highest`` on fp32 every
    panel pack holds the TF32 planes, and ``a_panel_bytes`` counts them,
    twice the fp32 panels' bytes that JAX's counts."""
    got = rec.get(field)
    if (field == "kernel_detail" and got and rec["config"]["mxu_precision"] == "highest"
            and rec["dtype"] == "float32" and got["variant"] in ("uniform", "window",
                                                                  "ragged", "halo")):
        got = dict(got, a_panel_bytes=got["a_panel_bytes"] // 2)
    return got


def _host_lines(out):
    return [line.strip() for line in out.splitlines() if HOST_LINE.match(line.strip())]


BENCH_CASES = {
    "rowpara": ["synth:banded:400:5:20", "8", "2", "0", "1", "--engine=rowpara",
                "--dtype=float64", "--devices=4"],
    "para2d": ["synth:banded:400:5:20", "8", "1", "0", "1", "--engine=para2d",
               "--dtype=float64", "--devices=8"],
    "crp": ["synth:banded:400:25:20", "8", "1", "0", "1", "--engine=crp",
            "--dtype=float64", "--devices=8"],
    "metis": ["synth:banded:400:5:20", "8", "1", "1", "1", "--engine=para2d",
              "--dtype=float64", "--devices=8"],
}


@pytest.mark.parametrize("case", sorted(BENCH_CASES))
def test_bench_cli_matches_jax(case, devices8, capsys):
    argv = BENCH_CASES[case]
    j_out = _run(jbench.main, argv, capsys)
    t_out = _run(tbench.main, argv + ["--device=cpu"], capsys)
    assert _host_lines(t_out) == _host_lines(j_out)
    assert "2D process grid" in t_out
    if case == "crp":
        assert "Alltoallv B necessary" in t_out
    assert _bench_err(j_out) <= TOL_F64 and _bench_err(t_out) <= TOL_F64


SUITE_CASES = {
    "modes": (["modes", "synth:banded:600:5:25", "8", "4", "--ntest=1"], TOL_F32),
    "vary_n": (["vary_n", "synth:banded:400:5:20", "4", "--ns=4,8", "--ntest=1",
                "--engine=rowpara", "--plan-procs=8"], TOL_F32),
    "crp_engine": (["scaling", "synth:banded:500:5:25", "8", "--procs=4",
                    "--engine=crp", "--ntest=1"], TOL_F32),
    "crp_dd": (["kernels", "synth:banded:500:5:25", "8", "4", "--engine=crp",
                "--list=dd", "--ntest=1"], TOL_F64),
    "reorder": (["kernels", "synth:cplaw:8192:12:512:85:perm", "16", "2",
                 "--engine=rowpara", "--list=ragged", "--ntest=1", "--inner=2",
                 "--reorder=metis"], TOL_F32),
}


@pytest.mark.parametrize("case", sorted(SUITE_CASES))
def test_suite_cli_matches_jax(case, devices8, capsys):
    argv, tol = SUITE_CASES[case]
    j_recs = _records(_run(jsuite.main, argv, capsys))
    t_recs = _records(_run(tsuite.main, argv + ["--device=cpu"], capsys))
    assert len(t_recs) == len(j_recs) > 0
    for j, t in zip(j_recs, t_recs):
        assert "error" not in j and "error" not in t, (j, t)
        for field in RECORD_FIELDS:
            assert _as_jax(t, field) == j.get(field), field
        assert j["rel_fro_err"] <= tol and t["rel_fro_err"] <= tol
        assert t["backend"] == "cpu" and t["config"]["kernel"] == t["kernel"]
        if t["p"] > 1:
            assert "exec_note" in t
    if case == "modes":
        assert [r["mode"] for r in t_recs] == ["a2a", "ring", "overlap"]
    if case == "reorder":
        assert t_recs[0]["reorder"]["method"] == "metis"
        assert t_recs[0]["reorder"]["bandwidth_after"] == j_recs[0]["reorder"][
            "bandwidth_after"]
        assert t_recs[0]["kernel_resolved"] == "ragged"


def test_suite_cli_project_and_roofline(capsys):
    """``--project=1`` attaches the port's projection at the parsed
    config's point; a panel kind's roofline names the peak it is taken
    against (3 TF32 passes at highest on fp32)."""
    recs = _records(_run(tsuite.main, [
        "kernels", "synth:banded:3000:7:80", "16", "1", "--engine=rowpara",
        "--list=pallas", "--ntest=1", "--inner=1", "--project=1", "--device=cpu",
        "--hbm-gbps=1000"], capsys))
    (rec,) = recs
    assert rec["kernel_resolved"] == "pallas" and rec["rel_fro_err"] <= TOL_F32
    assert (rec["roofline"]["passes"], rec["roofline"]["peak"]) == (3, "tf32")
    assert rec["roofline"]["peak_tflops"] == 495.0
    proj = rec["projected"]
    assert proj["p"] == 1 and proj["passes"] == 3 and proj["rates"]["hbm_gbps"] == 1000.0


@pytest.mark.parametrize("main,argv", [
    (tbench.main, ["synth:banded:400:5:20", "8", "1", "0", "--engine=crp",
                   "--device=cpu", "--distributed"]),
    (tsuite.main, ["vary_n", "synth:banded:400:5:20", "1", "--engine=crp",
                   "--device=cpu", "--distributed"]),
])
def test_distributed_raises_naming_a8(main, argv, monkeypatch):
    """``--distributed`` runs every engine across ranks, the any-layout one
    included (``tests/test_torch_dist_drivers.py``); outside a launcher
    ``--engine=crp --distributed`` raises naming the env the launcher
    sets (``init_distributed``'s message), before joining any group."""
    import torch.distributed as dist

    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match=r"the launcher's env lacks \['RANK', "
                       r"'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'\]"):
        main(argv)
    assert not dist.is_initialized()


def test_usage(capsys):
    assert tbench.main([]) == 255 and tsuite.main([]) == 255
    assert "Usage" in capsys.readouterr().out


def test_default_device_is_the_card(capsys):
    """Without ``--device=cpu`` the drivers take the engines' rule: the
    card, raising where there is none (the suite records the failure)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main(["synth:banded:400:5:20", "8", "1", "0", "--engine=rowpara",
                     "--devices=1"])
    (rec,) = _records(_run(tsuite.main, ["vary_n", "synth:banded:400:5:20", "1",
                                         "--ns=8", "--engine=rowpara"], capsys))
    assert rec["error"].startswith("RuntimeError: no CUDA device")


def test_suite_cli_trace(tmp_path, capsys):
    """``--trace=DIR`` writes a Chrome trace of the sweep."""
    out = _run(tsuite.main, ["kernels", "synth:banded:400:5:20", "8", "1",
                             "--engine=rowpara", "--list=segsum", "--ntest=1",
                             "--inner=1", "--device=cpu", f"--trace={tmp_path}"], capsys)
    trace = tmp_path / "suite_trace.json"
    assert f"Profiler trace written to {trace}" in out
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
