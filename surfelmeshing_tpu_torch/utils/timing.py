"""Timing registry.

Replaces the reference's Timer/ConditionalTimer/Timing singleton
(libvis/src/libvis/timing.h:47-164): per-tag total/mean/stddev/min/max
aggregation with a report sorted by total time, plus the per-frame
machine-readable log format written by --log_timings (main.cc:1531-1545).
"""

from __future__ import annotations

import math
import time
from collections import OrderedDict
from typing import Dict, Optional


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

    def timer(self, tag: str) -> "Timer":
        return Timer(self, tag)

    def stats(self, tag: str) -> Optional[_TagStats]:
        return self._tags.get(tag)

    def report(self, sort_by_total: bool = True) -> str:
        items = self._tags.items()
        if sort_by_total:
            items = sorted(items, key=lambda kv: -kv[1].total)
        lines = ["Timing report (seconds):"]
        for tag, s in items:
            lines.append(
                f"  {tag}: total {s.total:.6f}  count {s.count}  "
                f"mean {s.mean:.6f}  std {s.stddev:.6f}  "
                f"min {s.min:.6f}  max {s.max:.6f}")
        return "\n".join(lines)

    def reset(self) -> None:
        self._tags.clear()


class Timer:
    """Context-manager timer feeding a Timing registry."""

    def __init__(self, registry: Timing, tag: str):
        self._registry = registry
        self._tag = tag
        self._start = None

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def start(self):
        self._start = time.perf_counter()
        return self

    def stop(self, add: bool = True) -> float:
        elapsed = time.perf_counter() - self._start
        if add:
            self._registry.add_time(self._tag, elapsed)
        return elapsed


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
