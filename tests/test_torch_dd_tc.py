"""The fp64-class kernel #11 (``kernels/csrc/dd_tc.cu``) on the CPU: what
can be checked without a card.

The kernel runs only on the card (``tests/test_torch_cuda.py``); here the
split tool's edits are held to the body, and the packs to the tile the
body declares, so that a pack the kernel refuses shows here."""

import re

import numpy as np
import pytest
import torch

from crp_tpu_torch.kernels import _build, spmm_dd_mxu
from crp_tpu_torch.kernels.dispatch import _pack_dd_mxu
from crp_tpu_torch.kernels.spmm_ragged import _check_ragged_args
from crp_tpu_torch.plan.partition1d import csr_row_partition
from crp_tpu_torch.sparse.synth import banded_random_csr

CPU = torch.device("cpu")


def _body() -> str:
    return (_build.CSRC / "dd_tc.cu").read_text()


def _constexpr(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _body()).group(1))


# the block rows and the k slice dd_tc.cu declares: the kernel refuses a TM
# or a Wc that they do not divide
BM, BK = _constexpr("DD_BM"), _constexpr("DD_BK")


def test_dd_split_edits_apply_to_the_body():
    """``crp_tpu_torch.cli.dd_split`` times copies of ``dd_tc.cu`` with its
    copies or its products cut out, or in another DMMA shape: each edit's
    anchor is in the body exactly once, every variant but ``full`` changes
    it, a shape variant declares its shape, and every shape the body does
    not use has a products-only and a full variant."""
    from crp_tpu_torch.cli import dd_split

    body = _body()
    texts = dd_split.edited_sources()
    used = dd_split.body_shape(body)
    others = [s for s in dd_split.SHAPES if s != used]
    assert len(others) == 3
    assert set(texts) == {"full", "products_only", "copies_only",
                          *(f"{kind}_{s}" for kind in ("products_only", "full")
                            for s in others)}
    assert texts["full"] == body
    assert len({t for v, t in texts.items() if v != "full"} - {body}) == len(texts) - 1
    for variant, text in texts.items():
        shape = variant.rsplit("_", 1)[-1]
        assert dd_split.body_shape(text) == (shape if shape in dd_split.SHAPES else used)
        assert ("cp_async<16>(a_dst" in text) == ("products_only" not in variant)
        assert ("compute_slice(st);" in text) == (variant != "copies_only")


def test_dd_kernel_takes_what_the_wrapper_takes():
    """Whatever TM and Wc the ragged wrappers accept (TM % 128, Wc % 32),
    the body's block rows and k slice divide."""
    z = torch.zeros(1, dtype=torch.int32)
    for TM, Wc in ((128, 32), (256, 96)):
        panels = torch.zeros((1, TM, Wc), dtype=torch.float64)
        b = torch.zeros((Wc, 8), dtype=torch.float64)
        _check_ragged_args("dd", z, torch.zeros(2, dtype=torch.int32), z, (panels,), b,
                           Wc, torch.float64, torch.float64)
        assert TM % BM == 0 and Wc % BK == 0


@pytest.mark.parametrize("small", [True, False])
def test_dd_geometry_fits_the_kernels_tile(small):
    """Both geometries of the dd_mxu pack (the card's, and the CPU's
    clamp) give TM and Wc divisible by the body's block rows and k slice."""
    TM, Wc = spmm_dd_mxu.dd_mxu_geometry(small)
    assert TM % BM == 0 and Wc % BK == 0
    assert Wc == (256 if small else 512)


@pytest.mark.parametrize("p", [1, 3])
def test_dd_multi_shard_pack_fits_the_kernels_tile(p):
    """The dd_mxu pack over p row shards (one empty where p > 1): its TM
    and Wc divisible by the body's tile, every group's chunks within S."""
    a = banded_random_csr(1700, nnz_per_row=7, bandwidth=150, seed=11)
    d = csr_row_partition(a.rowptr, p)
    shards = []
    for i in range(p):
        s = a.row_slice(int(d[i]), int(d[i + 1]))
        if i == 1:
            shards.append((np.zeros(s.nrow + 1, np.int64), np.zeros(0, np.int32),
                           np.zeros(0, s.val.dtype)))
        else:
            shards.append((s.rowptr, s.colidx.astype(np.int32), s.val))
    arrays, op = _pack_dd_mxu(shards, int(np.diff(d).max()) + 200, CPU)
    rl = op.roofline
    assert rl["TM"] % BM == 0
    assert rl["W"] % BK == 0
    for i in range(p):
        _, group_ptr, starts, panels, _ = op.kernel_args(tuple(x[i] for x in arrays), None)
        assert panels.shape == (rl["S"], rl["TM"], rl["W"])
        assert group_ptr.shape == (rl["G"] + 1,) and int(group_ptr[-1]) <= rl["S"]
        assert int(starts.max()) + rl["W"] <= op.min_b_rows
