"""#4's 3xTF32 body at ``highest`` (``crp_window_f32``) emulated on its
windowed packs and held against JAX's ``spmm_window_pallas`` at HIGHEST
in interpret mode (``tests/tf32x3_emulation.py`` holds the emulation;
``test_torch_tf32x3.py`` the split and the other packs)."""

import numpy as np
import pytest
import torch

from crp_tpu.kernels.spmm_pallas import WindowDense, spmm_window_pallas

from crp_tpu_torch.kernels import dispatch as td
from crp_tpu_torch.kernels.spmm_pallas import spmm_window_plain, tf32_panels
from tests.test_torch_window import _anti_banded
from tests.test_torch_window import _shards as _window_shards
from tests.tf32x3_emulation import (
    CPU, TOL_FRO, TOL_MAX, _errors, one_pass_tf32, tf32x3_windows,
)


@pytest.mark.parametrize("n", [16, 37, 100])
@pytest.mark.parametrize("case", ["3 shards", "non-monotone"])
def test_emulated_window_matches_jax_highest(case, n):
    """On #4's packs (3 shards, one empty, pad groups; one shard with
    falling windows), the emulated 3xTF32 product against
    ``spmm_window_pallas(interpret=True)`` at HIGHEST and against the
    port's plain version: within 1e-6 both ways; one TF32 pass is not."""
    if case == "3 shards":
        _, shards, max_m = _window_shards(3, np.float32)
    else:
        a = _anti_banded()
        shards, max_m = [(a.rowptr, a.colidx.astype(np.int32), a.val)], a.nrow
    arrays, op = td._pack_window(shards, max_m + 300, np.float32, "highest", CPU)
    ws, planes = arrays
    tiles = tf32_panels(planes.transpose(0, 1))  # the fp32 panels of the TF32 planes
    b = np.random.default_rng(n).standard_normal((op.min_b_rows, n)).astype(np.float32)
    bt = torch.from_numpy(b)
    G, TM, W = tiles.shape[1:]
    worst_one_pass = 0.0
    for i in range(len(shards)):
        packed = WindowDense(nrow=G * TM, ncol=b.shape[0], TM=TM, G=G, W=W,
                             ws=ws[i].numpy(), tiles=tiles[i].numpy())
        want = np.asarray(spmm_window_pallas(packed, b, precision=None, interpret=True))
        got = tf32x3_windows(ws[i], tiles[i], bt)
        nrow = len(shards[i][0]) - 1 if len(shards[i][1]) else 0
        assert not torch.any(got[nrow:])  # pad groups and the empty shard
        if not np.any(want):
            continue
        for ref in (want, spmm_window_plain(ws[i], tiles[i], bt, "highest").numpy()):
            max_rel, fro = _errors(ref, got.numpy())
            assert max_rel <= TOL_MAX and fro <= TOL_FRO, (i, max_rel, fro)
        worst_one_pass = max(worst_one_pass,
                             _errors(want, one_pass_tf32(ws[i], tiles[i], bt).numpy())[1])
    assert worst_one_pass > 10 * TOL_FRO
