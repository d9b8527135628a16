"""The card's peak rates and what each operating point's products cost.

One table of NVIDIA H100 SXM peaks (data sheet, dense, at 700 W) and one
function, :func:`precision_point`, that prices an operating point in
passes of a product type: the port's bodies take three bf16 products at
``x3``, one at ``default``, and three TF32 products at ``highest`` on fp32
data (3xTF32); fp64 runs one pass, every panel kernel's on the FP64
tensor cores in the DMMA body of ``csrc/dd_tc.cu`` (#3, #4, #6, #12 and
the ``dd_mxu`` panels of #11), the plain PyTorch tiers' (``segsum``,
``ell``) on the FMA units.  The JAX package prices ``highest`` at six passes
(``crp_tpu/plan/project.py:75``), which its packs' ``roofline["passes"]``
keep; the port's roofline audits, the projection and ``chip_smoke.py``
read this function instead.
"""

from __future__ import annotations

import numpy as np

# HBM3 bytes/s, and FLOP/s by the type the products run in
HBM_BYTES_PER_S = 3.35e12
PEAK = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "fp64": 34e12,
        "fp64_tc": 67e12}


# the op variants whose fp64 products run on the FP64 tensor cores: #3 on
# the uniform super-grouped pack, #4 on the multi-shard window pack, #6 on
# the ragged pack, #11 on dd_mxu, #12 on the halo plan
FP64_TC_VARIANTS = ("uniform", "window", "ragged", "dd_mxu", "halo")


def precision_point(prec: str, dtype=np.float32, fp64_tc: bool = False) -> tuple:
    """(passes, peak key) of the products at operating point ``prec`` on
    ``dtype`` data; fp64 on the FP64 tensor cores where ``fp64_tc``, else
    on the FMA units."""
    if np.dtype(dtype) == np.float64:
        return 1, ("fp64_tc" if fp64_tc else "fp64")
    if prec == "x3":
        return 3, "bf16"
    if prec == "default":
        return 1, "bf16"
    return 3, "tf32"


def op_point(op, dtype) -> tuple:
    """(passes, peak key) of a local op's products (``dtype`` a torch or
    numpy dtype): the gather kind's on the FMA units at every point; a
    panel scheme (``"x3"``, ``"bf16"``, ``"full"``, ``"tf32"``) names its point, else
    the op's precision does; fp64 products by the body its variant runs
    (:data:`FP64_TC_VARIANTS`)."""
    if op.variant == "gather":
        return 1, "fp32"
    scheme = getattr(op, "scheme", None)
    prec = getattr(op, "precision", getattr(op, "mxu_precision", None))
    points = {"x3": "x3", "bf16": "default", "full": "highest", "tf32": "highest"}
    prec = points.get(scheme, prec)
    is64 = str(dtype).endswith("float64")
    return precision_point(prec, np.float64 if is64 else np.float32,
                           op.variant in FP64_TC_VARIANTS)
