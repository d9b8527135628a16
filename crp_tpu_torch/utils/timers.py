"""Phase timers (counterpart of ``crp_tpu/utils/timers.py:21-75``).

CUDA work is asynchronous, so a phase that ends in device work fences on
it: ``Timer.phase(name, fence=x)`` synchronizes the device of every CUDA
tensor in ``x`` before reading the clock.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


def synchronize(x) -> None:
    """Wait for the devices of the CUDA tensors in ``x`` (a tensor or a
    sequence of them)."""
    tensors = x if isinstance(x, (list, tuple)) else (x,)
    for dev in {t.device for t in tensors if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


class Timer:
    """Accumulating named phase timer (seconds), keeping per-phase totals
    and samples for min/avg/max stat tables
    (``src/rowpara_spmm.c:425-464`` of the reference)."""

    def __init__(self) -> None:
        self.t = defaultdict(float)
        self.samples = defaultdict(list)
        self.n_exec = 0

    @contextmanager
    def phase(self, name: str, fence=None):
        st = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                synchronize(fence)
            dt = time.perf_counter() - st
            self.t[name] += dt
            self.samples[name].append(dt)

    def add(self, name: str, seconds: float) -> None:
        self.t[name] += seconds
        self.samples[name].append(seconds)

    def clear(self) -> None:
        self.t.clear()
        self.samples.clear()
        self.n_exec = 0

    def min(self, name: str) -> float:
        s = self.samples.get(name)
        return min(s) if s else 0.0

    def max(self, name: str) -> float:
        s = self.samples.get(name)
        return max(s) if s else 0.0
