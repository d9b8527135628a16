"""#6's 3xTF32 body at ``highest`` (``crp_ragged_f32``) emulated on the
two-shard ragged packs, each group walking its chunks, and held against
JAX's ``spmm_ragged`` at HIGHEST in interpret mode
(``tests/tf32x3_emulation.py`` holds the emulation and the pack)."""

import numpy as np
import pytest
import torch

from crp_tpu.kernels import spmm_ragged as js

from crp_tpu_torch.kernels.spmm_pallas import tf32_panels
from crp_tpu_torch.kernels.spmm_ragged import first_ptr, spmm_ragged_plain
from tests.tf32x3_emulation import (
    TOL_FRO, TOL_MAX, _errors, _ragged_pack, one_pass_tf32, tf32x3_windows,
)


@pytest.mark.parametrize("n", [16, 37, 100])
@pytest.mark.parametrize("TM,Wc", [(128, 256), (256, 128)])
def test_emulated_ragged_matches_jax_highest(TM, Wc, n):
    """#6 at highest: the emulated 3xTF32 product with each group walking
    its chunks (the port's ``group_ptr``, which stops short of a shard's
    trailing no-op steps, and JAX's whole step range, which walks them)
    against JAX's ``spmm_ragged(interpret=True)`` at HIGHEST and the port's
    plain version, shard by shard: within 1e-6 both ways; dummy chunks'
    groups and pad groups zero; one TF32 pass is not within it."""
    a, nrows, arrays, op = _ragged_pack(TM, Wc)
    step_g, step_first, starts = arrays[:3]
    panels = tf32_panels(arrays[3:5])  # the fp32 panels the pack's TF32 planes hold
    group_ptr = arrays[-1]
    S = panels.shape[1]
    assert int(group_ptr[0, -1]) < S  # the first shard's trailing no-op steps
    assert int(np.diff(group_ptr.numpy(), axis=1).max()) > 1  # multi-chunk groups
    G = group_ptr.shape[1] - 1
    b = np.random.default_rng(n).standard_normal((op.min_b_rows, n)).astype(np.float32)
    bt = torch.from_numpy(b)
    worst_one_pass = 0.0
    for i, nrow in enumerate(nrows):
        gp = group_ptr[i].numpy()
        want = np.asarray(js.spmm_ragged(step_g[i].numpy(), step_first[i].numpy(),
                                         starts[i].numpy(), panels[i].numpy(), b,
                                         G=G, TM=TM, Wc=Wc, interpret=True))
        got = tf32x3_windows(starts[i], panels[i], bt, gp)
        jax_walk = tf32x3_windows(starts[i], panels[i], bt, first_ptr(step_first[i].numpy()))
        assert torch.equal(got, jax_walk)  # the no-op steps add nothing
        assert not torch.any(got[nrow:])  # pad groups
        dummy = [g for g in range(G) if gp[g + 1] - gp[g] == 1 and int(starts[i][gp[g]]) == 0
                 and not torch.any(panels[i][gp[g]])]
        assert dummy and all(not torch.any(got[g * TM:(g + 1) * TM]) for g in dummy)
        plain = spmm_ragged_plain(step_g[i], group_ptr[i], starts[i], panels[i], bt)
        for ref in (want, plain.numpy()):
            max_rel, fro = _errors(ref, got.numpy())
            assert max_rel <= TOL_MAX and fro <= TOL_FRO, (i, max_rel, fro)
        worst_one_pass = max(worst_one_pass, _errors(
            want, one_pass_tf32(starts[i], panels[i], bt, gp).numpy())[1])
    assert worst_one_pass > 10 * TOL_FRO
