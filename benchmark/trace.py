"""The traced stretch: torch.profiler (CPU + CUDA) over a few steady steps
after the timed window, reduced to a record the per-layer readers read.

Record keys: `window_s` (the traced stretch's wall length), `busy_s` (the
union of the device's kernel, copy and fill intervals), `calls` (steps or
acts traced), `kernels` (kernel launches), `kernel_s_by_name`,
`range_device_s` (device time of the kernels launched inside each of the
program's named ranges by the range's own thread, by name), `idle_gaps` (the idle intervals between
device work, by what the main thread was doing), `host_spans` (the
harness's own host timings of the untraced window, filled by the entry).
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Tuple

# the program's named ranges (agents/bc_agent.update, ops/rasterizer): on
# the device timeline annotation events that span their kernels
RANGE_PREFIXES = ("update/", "rasterize/")
# the harness's own range around each traced call
CALL_RANGE = "benchmark/call"
_NOT_KERNELS = ("Memcpy", "Memset")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def profile_calls(torch, call: Callable[[], None], calls: int,
                  sync: Callable[[], None]) -> Dict:
    """Profile `calls` calls of `call` (each ending where the caller's loop
    ends it), then `sync`, and reduce the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=activities) as prof:
        for _ in range(calls):
            with record_function(CALL_RANGE):
                call()
        sync()
    events = prof.events()
    named = lambda n: n.startswith(RANGE_PREFIXES) or n == CALL_RANGE
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    work = [e for e in dev if not named(e.name)]
    calls_cpu = [e for e in events if e.device_type == DeviceType.CPU
                 and e.name == CALL_RANGE]
    if not work or not calls_cpu:
        return {"calls": calls, "kernels": 0, "busy_s": 0.0, "window_s": 0.0}
    t0 = min(e.time_range.start for e in calls_cpu)
    t1 = max(e.time_range.end for e in calls_cpu)
    main = calls_cpu[0].thread
    busy = _union([(e.time_range.start, e.time_range.end) for e in work])
    by_name: Dict[str, float] = {}
    kernels = 0
    for e in work:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-6
        kernels += not e.name.startswith(_NOT_KERNELS)
    ranges: Dict[str, float] = {}
    for e in events:   # a CPU range's kernels and its children's, one thread
        if e.device_type == DeviceType.CPU and e.name.startswith(RANGE_PREFIXES):
            ranges[e.name] = ranges.get(e.name, 0.0) + e.device_time_total * 1e-6
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.device_type == DeviceType.CPU
                  and e.thread == main and e.name != CALL_RANGE
                  and not e.name.startswith("cuda"))
    host_starts = [h[0] for h in host]
    edges = [(t0, t0)] + busy + [(t1, t1)]
    idle: Dict[str, float] = {}
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b <= a:
            continue
        what = "(between the program's ops)"
        i = bisect.bisect_right(host_starts, a) - 1
        for j in range(i, max(i - 400, -1), -1):   # the innermost op holding a
            if host[j][1] > a:
                what = host[j][2]
                break
        idle[what] = idle.get(what, 0.0) + (b - a) * 1e-6
    clip = lambda s, e: max(0.0, min(e, t1) - max(s, t0))
    return {"calls": calls, "kernels": kernels,
            "window_s": (t1 - t0) * 1e-6,
            "busy_s": sum(clip(s, e) for s, e in busy) * 1e-6,
            "kernel_s_by_name": by_name, "range_device_s": ranges,
            "idle_gaps": idle}


def breakdown(record: Dict, n: int = 10) -> Dict:
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:n]]
    return {"device_ops": top(record.get("kernel_s_by_name", {})),
            "idle_gaps": top(record.get("idle_gaps", {}))}
