"""The device trace of a traced stretch: torch.profiler's CUDA activity
over a stretch of frames, read back from its Chrome trace.

Only CUDA activity is recorded, so the host runs at its own pace; the
program is not instrumented.  A marker launched on an idle device just
before the stretch ties the trace's clock to the host clock, so the
device's idle gaps can be named by the benchmark's own host spans
(process_frame, snapshot_for_meshing, drain) that they fall in.  The
summary holds the stretch's length on the host clock, the device's busy
seconds (the union of kernel, copy and fill intervals), time and
launches by kernel name, and the longest idle gaps.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import warnings
from collections import defaultdict

import torch

from . import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profiler(cuda: bool = True):
    """A profiler of CUDA activity (of host ops on a CPU run), not
    started."""
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    activity = torch.profiler.ProfilerActivity
    return torch.profiler.profile(
        activities=[activity.CUDA if cuda else activity.CPU])


def mark(device) -> float:
    """Launch the marker on an idle device: -> the host time just before
    its launch."""
    t = time.perf_counter()
    torch.zeros(1, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return t


def read(prof, spans: list, t_mark: float, t0: float, t1: float) -> dict:
    """Summary of a stopped profiler whose first device event is the
    marker launched at host time t_mark; the stretch ran from t0 to t1
    (host clock) with the host spans (name, start, end)."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events, spans, t_mark, t0, t1)


def summarize(events: list, spans: list, t_mark: float, t0: float,
              t1: float) -> dict:
    """Summary of Chrome-trace events (timestamps in microseconds)."""
    device = []
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat", "") in DEVICE_CATS:
            s = float(ev["ts"])
            device.append((s, s + float(ev.get("dur", 0.0)), ev["name"]))
    device.sort()
    if not device:
        return {"window_s": t1 - t0, "busy_s": 0.0, "kernels": {},
                "device_ops": [], "idle_gaps": []}
    # Device microseconds -> host seconds, through the marker (the first
    # device event).
    offset = t_mark - device[0][0] * 1e-6
    lo, hi = (t0 - offset) * 1e6, (t1 - offset) * 1e6
    by_name = defaultdict(lambda: [0.0, 0])
    intervals = []
    for s, e, name in device[1:]:
        intervals.append((s, e))
        by_name[name][0] += (e - s) * 1e-6
        by_name[name][1] += 1
    gaps = []
    for gs, ge in stats.idle_gaps(intervals, lo, hi):
        mid = 0.5 * (gs + ge) * 1e-6 + offset
        inner = [sp for sp in spans if sp[1] <= mid <= sp[2]]
        label = min(inner, key=lambda sp: sp[2] - sp[1])[0] if inner \
            else "host_loop"
        gaps.append((label, (ge - gs) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(((n, v[0]) for n, v in by_name.items()),
                 key=lambda o: -o[1])
    return {
        "window_s": t1 - t0,
        "busy_s": stats.union_length(intervals, lo, hi) * 1e-6,
        "kernels": {n: (v[0], v[1]) for n, v in by_name.items()},
        "device_ops": [[n[:160], s] for n, s in ops[:10]],
        "idle_gaps": [[n, s] for n, s in gaps[:10]],
    }
