"""Debug dump helpers (``crp_tpu/utils/debug.py``).

Counterparts of the reference's debug utilities
(``src/utils.c:122-163``): ``print_matrix`` pretty-prints a row-major block
with a name banner, ``dump_binary``/``load_binary`` round-trip raw arrays to
disk.  The binary format carries a tiny header (dtype + shape) instead of
the reference's headerless stream, so loads need no out-of-band metadata —
the closest thing to checkpointing the reference has.  The format and its
magic are the JAX package's, so a dump written by either package loads in
the other.
"""

from __future__ import annotations

import sys

import numpy as np

_MAGIC = b"CRPT"


def print_matrix(
    mat: np.ndarray, name: str = "mat", fmt: str = "% .4e", file=None
) -> None:
    """Bannered row-major matrix print (reference ``print_matrix``)."""
    file = file or sys.stdout
    mat = np.atleast_2d(np.asarray(mat))
    print(f"{name}, size = {mat.shape[0]} * {mat.shape[1]}:", file=file)
    for row in mat:
        print(" ".join(fmt % x for x in row), file=file)


def dump_binary(arr: np.ndarray, path: str) -> None:
    """Write an array as magic | dtype-str | ndim | shape | raw bytes."""
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        dt = arr.dtype.str.encode()
        f.write(np.int32(len(dt)).tobytes())
        f.write(dt)
        f.write(np.int32(arr.ndim).tobytes())
        f.write(np.asarray(arr.shape, dtype=np.int64).tobytes())
        f.write(arr.tobytes())


def load_binary(path: str) -> np.ndarray:
    """Read an array written by :func:`dump_binary`."""
    with open(path, "rb") as f:
        if f.read(4) != _MAGIC:
            raise ValueError(f"{path}: not a crp_tpu binary dump")
        dt_len = int(np.frombuffer(f.read(4), np.int32)[0])
        dtype = np.dtype(f.read(dt_len).decode())
        ndim = int(np.frombuffer(f.read(4), np.int32)[0])
        shape = tuple(np.frombuffer(f.read(8 * ndim), np.int64))
        return np.frombuffer(f.read(), dtype=dtype).reshape(shape).copy()
