"""Timing registry and the port's tracer.

Timing replaces the reference's Timing singleton
(libvis/src/libvis/timing.h:47-164): per-tag total/mean/stddev/min/max
aggregation with a report sorted by total time, plus the per-frame
machine-readable log format written by --log_timings (main.cc:1531-1545).

Tracer (one process-wide instance, `tracer`) records spans and counters
inside the port while it is on; it is off unless a caller starts it
(the app does for --profile_dir and --log_timings, and logs
trace_report() of what it recorded when the run ends).  A span site reads
`tracer.on` and does nothing more while it is False: no clock read, no
object, no event, no synchronisation.  While it is on:

- host spans (name, start, end, parent, id, thread) on time.perf_counter,
  the clock of the benchmark's own spans, kept in a buffer allocated by
  start() (spans past its capacity are counted as dropped).  `id` is the
  frame a span serves (-1 for none); the parent is the innermost span
  open on the same thread.  Spans named wait.<site> are the host blocked
  on the card, and the only spans that cover such a wait: where a call
  would block inside (a copy from pageable memory, a size read), the
  site first waits on an event recorded on the stream, in that span.
  Where a Timing tag is timed over the same stretch as a span, the site
  reads the clock once and hands the reading to both (begin/end's `t`).
- device spans (thread "device"): the CUDA events of StageTimers handed
  over by the pipeline (preprocessing passes, fusion phases, chunk
  replays) and by the tiled route (dev.tiling.select, .writeback),
  placed on the host clock through one event synchronised at start().
  Those the device has passed are converted by poll(), which each frame
  span calls; the rest by stop().  On the CPU a StageTimer
  reads the host clock and its spans are host times of the ops.
- counters: host_waits by site, h2d_bytes.pageable / .pinned (input
  copies to the device), d2h_bytes (snapshot copies); the counters kept
  elsewhere (creations made and deferred and, under the auto active-set
  budget, tiles active, skipped and working rows as the count readbacks
  confirm them, graph captures and replays, bucket picks, snapshots and
  rows shipped, blending, preprocessing, association, integration and
  tile-selection launches, kernel builds) are read where they live, from
  every watched pipeline, and reported as their change.
- with start(profile=True) every host span is also a
  torch.profiler.record_function range, so a profiler trace shows the
  spans with the kernels they launched.
"""

from __future__ import annotations

import itertools
import math
import threading
import time
import weakref
from collections import OrderedDict
from typing import Callable, Dict, Optional

import torch


class _TagStats:
    __slots__ = ("count", "total", "sq_total", "min", "max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.sq_total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def add(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        self.sq_total += seconds * seconds
        self.min = min(self.min, seconds)
        self.max = max(self.max, seconds)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def stddev(self) -> float:
        if self.count < 2:
            return 0.0
        var = max(0.0, self.sq_total / self.count - self.mean ** 2)
        return math.sqrt(var)


class Timing:
    """Global-style timing registry (one instance per pipeline)."""

    def __init__(self):
        self._tags: "OrderedDict[str, _TagStats]" = OrderedDict()

    def add_time(self, tag: str, seconds: float) -> None:
        self._tags.setdefault(tag, _TagStats()).add(seconds)

    def stats(self, tag: str) -> Optional[_TagStats]:
        return self._tags.get(tag)

    def report(self, sort_by_total: bool = True,
               title: str = "Timing report (seconds):") -> str:
        items = self._tags.items()
        if sort_by_total:
            items = sorted(items, key=lambda kv: -kv[1].total)
        lines = [title]
        for tag, s in items:
            lines.append(
                f"  {tag}: total {s.total:.6f}  count {s.count}  "
                f"mean {s.mean:.6f}  std {s.stddev:.6f}  "
                f"min {s.min:.6f}  max {s.max:.6f}")
        return "\n".join(lines)


# Stage names in the reference's --log_timings per-frame log (main.cc:1531-1545).
FRAME_LOG_STAGES = (
    "preprocessing",
    "data_association",
    "surfel_merging",
    "measurement_blending",
    "integration",
    "neighbor_update",
    "new_surfel_creation",
    "regularization",
    "surfel_transfer",
)

# The seven fusion-phase columns of that line, in program order, which
# ops/fusion.StageTimer fills (the JAX package's utils/stage_trace.COLUMNS).
COLUMNS = FRAME_LOG_STAGES[1:-1]


def format_frame_timings_line(frame_index: int,
                              stage_ms: Dict[str, float],
                              surfel_count: int) -> str:
    """One line of the --log_timings file, reference format (main.cc:1531-1545)."""
    parts = [f"frame {frame_index}"]
    for stage in FRAME_LOG_STAGES:
        parts.append(f"{stage} {stage_ms.get(stage, 0.0):f}")
    parts.append(f"surfel_count {surfel_count}")
    return " ".join(parts)


_sync_events = {}             # device -> the event stream_sync records


def stream_sync(device) -> Optional[Callable[[], None]]:
    """A callable that blocks until `device`'s current stream has run the
    work queued on it now (an event recorded here, one per device, reused:
    call it before the next stream_sync); None on the CPU, where nothing is
    queued."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    event = _sync_events.get(device)
    if event is None:
        event = _sync_events[device] = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event.synchronize


class Tracer:
    """Spans and counters of the port (module docstring); the instance is
    `tracer`.  Sites call begin() and end() in nested pairs on one thread,
    only while `on` is True."""

    CAPACITY = 1 << 19
    BYTES = ("h2d_bytes.pageable", "h2d_bytes.pinned", "d2h_bytes")

    def __init__(self):
        self.on = False
        self._recording = 0
        self._cols = None
        self._slots = itertools.count()
        self._local = threading.local()
        self._sources = weakref.WeakSet()

    def watch(self, source) -> None:
        """Report source.trace_counters() (a dict of numbers read where
        they live) as their change from start() to stop()."""
        self._sources.add(source)

    # -- start and stop ---------------------------------------------------

    def start(self, profile: bool = False) -> None:
        """Switch on with empty records.  On an initialised CUDA device
        the device is synchronised once, for the clock reference."""
        if self.on:
            raise RuntimeError("the tracer is already on")
        cap = self.CAPACITY
        # (name, start, end, parent, id, thread) by slot; None while off,
        # so a site that began before stop() writes into the old buffer.
        self._cols = ([None] * cap, [0.0] * cap, [None] * cap, [-1] * cap,
                      [-1] * cap, [None] * cap)
        self._slots = itertools.count()
        self._recording += 1
        self._profile = profile
        self._pending = []        # (StageTimer, prefix, id) to convert
        self.host_waits = {}
        self.bytes = dict.fromkeys(self.BYTES, 0)
        self._ref = self._ref_device = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
            self._ref_device = torch.device("cuda",
                                            torch.cuda.current_device())
            self._ref = torch.cuda.Event(enable_timing=True)
            self._ref.record()
            self._ref.synchronize()
        self._t_ref = time.perf_counter()
        self._base = [(s, s.trace_counters()) for s in list(self._sources)]
        self.on = True

    def stop(self) -> dict:
        """Switch off and hand out the records: {"start", "stop" (host
        clock), "spans" (dicts of name, start, end, parent (an index into
        the list or -1), id, thread; spans still open are left out),
        "dropped", "host_waits", the byte counters and "pipelines" (the
        counter changes of each watched pipeline whose counters moved)}.
        Device spans the device has not passed yet wait for it: call
        after the caller's own synchronisation."""
        if not self.on:
            raise RuntimeError("the tracer is off")
        self.on = False
        t_stop = time.perf_counter()
        if self._pending:
            last = self._pending[-1][0]
            if not last.done():
                last.synchronize()
            self.poll()
        cols, self._cols = self._cols, None
        name, t0, t1, parent, ids, thread = cols
        total = next(self._slots)
        keep = [i for i in range(min(total, self.CAPACITY))
                if t1[i] is not None]
        index = {i: k for k, i in enumerate(keep)}
        spans = [{"name": name[i], "start": t0[i], "end": t1[i],
                  "parent": index.get(parent[i], -1), "id": ids[i],
                  "thread": thread[i]} for i in keep]
        changes = [{k: v - base[k] for k, v in s.trace_counters().items()}
                   for s, base in self._base]
        out = {"start": self._t_ref, "stop": t_stop, "spans": spans,
               "dropped": max(total - self.CAPACITY, 0),
               "host_waits": dict(self.host_waits), **self.bytes,
               "pipelines": [c for c in changes if any(c.values())]}
        self._pending = self._base = self._ref = None
        return out

    # -- host spans -------------------------------------------------------

    def begin(self, name: str, id: int = -1,
              t: Optional[float] = None) -> None:
        """Open a span on this thread (closed by the next end()), at host
        time `t` where the caller has read the clock for this boundary."""
        loc = self._local
        if getattr(loc, "recording", None) != self._recording:
            loc.recording, loc.stack = self._recording, []
            loc.thread = threading.current_thread().name
        stack = loc.stack
        rf = None
        if self._profile:
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        cols = self._cols
        i = next(self._slots)
        if t is None:
            t = time.perf_counter()
        if cols is not None and i < self.CAPACITY:
            cols[0][i], cols[1][i], cols[4][i], cols[5][i] = \
                name, t, id, loc.thread
            cols[3][i] = stack[-1][0] if stack else -1
        stack.append((i, t, rf))

    def end(self, t: Optional[float] = None) -> float:
        """Close this thread's innermost open span, at host time `t` as
        in begin(): -> its seconds (0.0 where the thread has none open, as
        after a restart)."""
        if t is None:
            t = time.perf_counter()
        loc = self._local
        stack = getattr(loc, "stack", None)
        if not stack:
            return 0.0
        i, t0, rf = stack.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        cols = self._cols
        if cols is not None and i < self.CAPACITY and \
                loc.recording == self._recording:
            cols[2][i] = t
        return t - t0

    def wait(self, site: str, id: int = -1,
             block: Optional[Callable[[], None]] = None) -> None:
        """The span wait.<site> around block() (the host blocked on the
        card; None: nothing to wait for, as on the CPU), counted in
        host_waits."""
        self.begin("wait." + site, id)
        if block is not None:
            block()
        self.end()
        self.host_waits[site] = self.host_waits.get(site, 0) + 1

    # -- counters ---------------------------------------------------------

    def h2d(self, host: torch.Tensor) -> None:
        """Count a host tensor copied to the device, by its memory."""
        key = "h2d_bytes.pinned" if host.is_pinned() else \
            "h2d_bytes.pageable"
        self.bytes[key] += host.numel() * host.element_size()

    def d2h(self, nbytes: int) -> None:
        self.bytes["d2h_bytes"] += nbytes

    # -- device spans -----------------------------------------------------

    def device(self, timer, prefix: str, id: int = -1) -> None:
        """Take a StageTimer's segments as device spans prefix + column,
        converted once the device has passed its last mark."""
        self._pending.append((timer, prefix, id))

    def poll(self) -> None:
        """Convert the device spans the device has passed (the stream runs
        them in order, so the first one not passed ends the scan)."""
        pend = self._pending
        k = 0
        while k < len(pend) and pend[k][0].done():
            k += 1
        for timer, prefix, id in pend[:k]:
            if timer.cuda:
                if timer.device != self._ref_device:
                    continue              # no clock reference there
                ref, base = self._ref, self._t_ref
            else:
                ref, base = 0.0, 0.0
            cols = self._cols
            for column, s, e in timer.segments(ref):
                i = next(self._slots)
                if i < self.CAPACITY:
                    cols[0][i], cols[1][i], cols[2][i] = \
                        prefix + column, base + s, base + e
                    cols[4][i], cols[5][i] = id, "device"
        del pend[:k]


tracer = Tracer()


def trace_report(records: dict) -> str:
    """Tracer.stop()'s records as the app logs them: the spans' seconds by
    name in a Timing report (host spans of the frame loop and the mesher,
    wait.* spans, device spans dev.*), then the counters, and the
    creations the watched pipelines made and deferred."""
    spans = Timing()
    for s in records["spans"]:
        spans.add_time(s["name"], s["end"] - s["start"])
    counters = {k: records[k] for k in ("dropped", "host_waits",
                                        *Tracer.BYTES, "pipelines")}
    creations = {k: sum(p.get(k, 0) for p in records["pipelines"])
                 for k in ("creations.made", "creations.deferred")}
    return spans.report(title="Traced spans (seconds):") + \
        f"\nTraced counters: {counters}\nTraced creations: {creations}"
