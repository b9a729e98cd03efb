"""Profiling and tracing helpers (port of
`manigaussian_tpu/utils/profiling.py`; reference `record_function` scopes,
`resnetfc.py:54,144`, and the step timing of
`offline_train_runner.py:190-219`): named ranges, a device trace, a step
timer and a timing loop.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace_annotation(name: str):
    """A named range in `torch.profiler` traces."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def capture_trace(logdir: str):
    """Profile the block on the CPU and, where there is one, the GPU, and
    write a Chrome trace (`trace_<pid>.json`, for Perfetto or
    chrome://tracing) into `logdir`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


class StepTimer:
    """Rolling wall-clock step timing over the last `window` steps."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []
        self._last: Optional[float] = None

    def tick(self) -> Dict[str, float]:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        if not self._times:
            return {}
        mean = sum(self._times) / len(self._times)
        return {"step_time_s": mean, "steps_per_s": 1.0 / max(mean, 1e-9)}


def _synchronize() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def benchmark_fn(fn, *args, iters: int = 20, warmup: int = 2) -> float:
    """Mean seconds a call after `warmup` calls; the device is synchronized
    before and after the timed loop."""
    for _ in range(warmup):
        fn(*args)
    _synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _synchronize()
    return (time.perf_counter() - t0) / iters
