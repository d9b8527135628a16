"""One torch intra-op thread in the CPU test processes.

The tier-1 run holds six test workers on eight cores.  torch's intra-op
threads in six processes at once oversubscribe the cores, and the
emulations of the kernels' summation orders (batched float64 products)
then run twentyfold slower: the three ``test_torch_x3_ragged_walk_n*.py``
files took 478 s on three workers, 36 s with one thread each.  The heavy
emulation helpers import this module; every worker imports every test
file while it collects, so the setting holds for the whole run.  It
changes no result a test checks: each comparison runs within one process.
"""

import torch

torch.set_num_threads(1)
