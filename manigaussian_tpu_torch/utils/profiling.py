"""Profiling and tracing helpers (port of
`manigaussian_tpu/utils/profiling.py`; reference `record_function` scopes,
`resnetfc.py:54,144`): the port's named ranges and a device trace.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()


def trace_annotation(name: str):
    """A named range in `torch.profiler` traces, the port's only entry to
    one: while a profiler records on this thread, a function-scope record
    (`_RecordFunctionFast`) that holds the ops and kernels launched inside
    it; otherwise a context that does nothing, at the cost of one flag read
    (`record_function` costs microseconds a range with no profiler).

    Function scope and not `record_function`'s user scope: a user range also
    puts an annotation spanning its kernels on the device's timeline, which
    a trace reduction that counts device events as work would count as a
    kernel, and as busy across every idle gap inside the range."""
    return _RecordFunctionFast(name) if _profiler_enabled() else _OFF


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
