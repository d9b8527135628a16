"""Matrix loading for the port's drivers (``crp_tpu/cli/plan_cli.py:23``
``load_matrix``): a ``.mtx`` file or a ``synth:`` spec.  The rest of the
planner CLI is still to port (ROADMAP A7)."""

from __future__ import annotations


def load_matrix(spec: str, need_symm: bool = False):
    """Load .mtx, or generate 'synth:banded:<n>:<nnz>:<bw>' /
    'synth:plaw:<n>:<deg>' /
    'synth:cplaw:<n>:<deg>:<comm>[:<p_local_pct>[:perm]]'."""
    from ..sparse.mmio import read_mtx_csr
    from ..sparse.synth import (
        banded_random_csr, powerlaw_community_csr, powerlaw_random_csr,
    )

    if spec.startswith("synth:"):
        parts = spec.split(":")
        kind = parts[1]
        if kind == "banded":
            n, nnzr, bw = (int(x) for x in parts[2:5])
            return banded_random_csr(n, nnz_per_row=nnzr, bandwidth=bw)
        if kind == "plaw":
            n, deg = (int(x) for x in parts[2:4])
            return powerlaw_random_csr(n, avg_degree=deg)
        if kind == "cplaw":
            n, deg, comm = (int(x) for x in parts[2:5])
            pct = int(parts[5]) if len(parts) > 5 else 85
            perm = len(parts) > 6 and parts[6] == "perm"
            return powerlaw_community_csr(
                n, avg_degree=deg, comm_size=comm, p_local=pct / 100, permute=perm,
            )
        raise SystemExit(f"unknown synth spec {spec}")
    return read_mtx_csr(spec, need_symm=need_symm)
