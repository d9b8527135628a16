"""#7 (x3) and #8 (default): the wgmma body's ragged walk emulated and
held against JAX's ragged kernels in interpret mode and the port's plain
versions at n = 16 (``tests/x3_order_emulation.py`` ``check_ragged_walk``;
the order and the 1e-6 tolerance are stated in
``test_torch_x3_order.py``)."""

import pytest

from tests.x3_order_emulation import check_ragged_walk


@pytest.mark.parametrize("n", [16])
@pytest.mark.parametrize("TM,Wc", [(128, 256), (256, 128)])
@pytest.mark.parametrize("prec", ["x3", "default"])
def test_wgmma_ragged_walk_matches_jax_and_plain(prec, TM, Wc, n):
    check_ragged_walk(prec, TM, Wc, n)
