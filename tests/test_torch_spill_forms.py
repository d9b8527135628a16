"""The spill forms' A/B tool (``crp_tpu_torch/cli/spill_forms.py``) on the
CPU at a small size: the ``twopass`` arrays it makes from a ``segsum``
pack are JAX's ``twopass`` pack's, its ``clip`` and ``twopass`` give JAX's
forms' C and ``segsum``'s bit for bit, every form it times gives its
figures, and without a card it refuses to run."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crp_tpu.kernels import dispatch as jd
from crp_tpu.kernels import spmm_ragged as js

from crp_tpu_torch.cli import spill_forms
from crp_tpu_torch.sparse.synth import powerlaw_community_csr
from crp_tpu_torch.utils.norms import rel_fro_err

CPU = torch.device("cpu")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_twopass_arrays_are_jax_twopass_pack(monkeypatch, dtype):
    """From a single-shard ``segsum`` pack the tool makes the (inv, uniq)
    of JAX's ``twopass`` pack of the same matrix, pads included."""
    a = powerlaw_community_csr(20000, 16, 1024, seed=5, dtype=dtype)
    op, arrs = spill_forms.ragged_pack(a, dtype, "highest", CPU, "segsum")
    rows, cols, vals = op._spill_arrays(arrs)
    M = op.roofline["G"] * op.roofline["TM"]
    z = int((rows < M).sum())
    assert z == op.roofline["spill_nnz"] > 0
    inv, uniq = spill_forms.twopass_arrays(rows, cols, z)
    monkeypatch.setenv("CRP_TPU_RAGGED_TM", str(op.roofline["TM"]))
    monkeypatch.setenv("CRP_TPU_RAGGED_WC", str(op.roofline["W"]))
    monkeypatch.setenv("CRP_TPU_SPILL_IMPL", "twopass")
    shard = [(a.rowptr, a.colidx.astype(np.int32), a.val)]
    j_arrays, j_fn = jd.pack_local_kernel(shard, a.nrow, dtype, "ragged",
                                          mxu_precision="highest")
    assert j_fn.roofline["spill_impl"] == "twopass"
    j_rows, j_inv, j_vals, j_uniq = (np.asarray(x)[0] for x in j_arrays[-4:])
    np.testing.assert_array_equal(rows.numpy(), j_rows)
    np.testing.assert_array_equal(vals.numpy(), j_vals)
    np.testing.assert_array_equal(inv.numpy(), j_inv)
    np.testing.assert_array_equal(uniq.numpy(), j_uniq[: uniq.numel()])


@pytest.mark.parametrize("form", ["clip", "twopass"])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), (np.float64, 1e-12)])
def test_forms_match_jax_and_segsum(form, dtype, tol):
    """The tool's ``clip`` and ``twopass`` on a padded spill give JAX's
    forms' C within the dtype's class and ``segsum``'s bit for bit."""
    rng = np.random.default_rng(12)
    m, k, n, z = 300, 400, 32, 5000
    rows = np.sort(rng.integers(0, m, z)).astype(np.int32)
    cols = rng.integers(0, k, z).astype(np.int32)
    vals = rng.standard_normal(z).astype(dtype)
    b = rng.standard_normal((k, n)).astype(dtype)
    pr, pc, pv = js.pack_spill((rows, cols, vals), z + 37, m, dtype)

    class Op:  # a segsum pack's op as the tool reads it
        roofline = dict(G=1, TM=m)

        @staticmethod
        def _spill_arrays(arrs):
            return arrs

    calls, figures = spill_forms.forms(Op, tuple(torch.from_numpy(x) for x in (pr, pc, pv)),
                                       torch.from_numpy(b))
    assert (figures["spilled_nnz"], figures["unique_cols"]) == (z, len(np.unique(cols)))
    segsum, got = calls["segsum"][0](), calls[form][0]()
    assert got.dtype == segsum.dtype and torch.equal(got, segsum)
    if form == "clip":
        want = js.spmm_spill_chunked(jnp.asarray(pr), jnp.asarray(pc), jnp.asarray(pv),
                                     jnp.asarray(b), m, take_mode="clip")
    else:
        packed = js.pack_spill_twopass((rows, cols, vals), z + 37, m, dtype,
                                       len(np.unique(cols)))
        want = js.spmm_spill_twopass(*(jnp.asarray(x) for x in packed), jnp.asarray(b), m)
    assert rel_fro_err(np.asarray(want).astype(np.float64), got.numpy()) <= tol


@pytest.mark.parametrize("dtype,prec,with_pallas", [(np.float64, "highest", False),
                                                     (np.float32, "x3", True)])
def test_measure_records(dtype, prec, with_pallas):
    a = powerlaw_community_csr(20000, 16, 1024, seed=7, dtype=dtype)
    recs = spill_forms.measure("small", a, dtype, prec, CPU, with_pallas, n=16,
                               rounds=2, reps=1, inner=1, card="cpu")
    by = {r["form"]: r for r in recs}
    assert list(by) == ["segsum", "clip", "twopass"] + (["pallas"] if with_pallas
                                                         else []) + ["cusparse"]
    seg = by["segsum"]
    assert seg["spilled_nnz"] > 0 and 0 < seg["unique_cols"] <= seg["spilled_nnz"]
    for name in ("clip", "twopass"):
        assert by[name]["equal_segsum_bits"] and by[name]["max_abs_vs_segsum"] == 0.0
    isz = np.dtype(dtype).itemsize
    assert by["clip"]["bytes"] == seg["bytes"] + 8 * seg["spilled_nnz"]
    assert by["twopass"]["bytes"] == (seg["bytes"] + 4 * seg["unique_cols"]
                                      + 2 * seg["unique_cols"] * 16 * isz)
    least = (seg["spilled_nnz"] * (8 + isz) + seg["unique_cols"] * 16 * isz
             + seg["M"] * 16 * isz)
    for r in recs:
        assert len(r["rounds"]) == 2 and r["ms"] > 0 and r["bytes"] > 0
        assert r["bound_ms"] == least / spill_forms.HBM_BYTES_PER_S * 1e3
        assert (r["dtype"], r["point"], r["card"]) == (np.dtype(dtype).name, prec, "cpu")
    tol = 1e-9 if dtype == np.float64 else 1e-3
    assert by["cusparse"]["max_abs_vs_segsum"] <= tol
    if with_pallas:
        assert by["pallas"]["max_abs_vs_segsum"] <= tol


def test_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert spill_forms.main([]) == 2
