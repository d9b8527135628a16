"""Statistics tables (``crp_tpu/engine/stats.py``): min/avg/max phase
times and communicated-element counts, as the reference's
``rp_spmm_print_stat`` prints them."""

from __future__ import annotations

from ..utils.timers import Timer


def format_stat_table(
    title: str,
    t_init: float,
    timer: Timer,
    comm_rows: int,
    glb_n: int,
    physical_rows: int = 0,
    rank: str | None = None,
) -> str:
    """``rank``: on a mesh of ranks, the line naming this rank (the times
    are its own; the comm sizes are the whole run's)."""
    n = max(timer.n_exec, 1)
    lines = [
        f"{title}_init() time = {t_init:.2f} s",
        f"Total SpMM comm size (logical elements) = {comm_rows * glb_n}",
    ]
    if rank:
        lines.insert(1, rank)
    if physical_rows:
        lines.append(
            f"Physical exchanged rows per exec (padded) = {physical_rows}"
        )
    lines.append("-------------------- Runtime (s) --------------------")
    lines.append("                                     min     avg     max")
    label = {
        "pack": "Pack B matrix for redistribution ",
        "a2a": "Redistribute B matrix            ",
        "unpack": "Unpack received C matrix data    ",
        "spmm": "Local SpMM                       ",
        "exec": "Total exec()                     ",
    }
    for key, text in label.items():
        if key in timer.t:
            lines.append(
                f"{text} {timer.min(key):6.3f}  {timer.t[key] / n:6.3f}"
                f"  {timer.max(key):6.3f}"
            )
    return "\n".join(lines)


def format_comm_head(rA_cost: int, rB_elems: int) -> str:
    """The three "Total comm size" lines of ``para2d_spmm_print_stat``
    (``src/para2d_spmm.c:150-198``): A replication, B exchange, their sum."""
    return "\n".join([
        f"Total comm size for replicating A = {rA_cost}",
        f"Total comm size for replicating B = {rB_elems}",
        f"Total comm size for SpMM          = {rA_cost + rB_elems}",
    ])
