"""Phase timers (counterpart of ``crp_tpu/utils/timers.py:21-75``).

CUDA work is asynchronous, so a phase that ends in device work fences on
it: ``Timer.phase(name, fence=x)`` synchronizes the device of every CUDA
tensor in ``x`` before reading the clock.
"""

from __future__ import annotations

import statistics
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


def median_ms(fn, device, reps: int = 5, inner: int = 20) -> float:
    """Median ms per call of ``fn`` over ``reps`` runs of ``inner`` calls,
    after one warm-up call: CUDA events around each run on a CUDA
    ``device`` (the kernels return before the card finishes), the host
    clock on the CPU."""
    fn()
    samples = []
    if torch.device(device).type != "cuda":
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            samples.append((time.perf_counter() - t0) * 1e3 / inner)
        return statistics.median(samples)
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(reps):
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)
