"""The benchmark's arithmetic: rates, percentiles, interval unions and
roofline shares.  Plain Python and numpy, no device."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks() -> dict:
    """The table of device peaks (peaks.json)."""
    return json.loads(PEAKS.read_text())


def rate(count: int, seconds: float) -> float:
    """Work done over the seconds it took."""
    if seconds <= 0:
        raise ValueError("a rate needs a positive duration")
    return count / seconds


def p95(values) -> float:
    """95th percentile, numpy's linear interpolation between ranks."""
    v = np.asarray(list(values), np.float64)
    if v.size == 0:
        raise ValueError("a percentile needs samples")
    return float(np.percentile(v, 95))


def merge_intervals(intervals) -> list:
    """Sorted, merged [start, end] pairs of possibly overlapping ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of the intervals clipped to [lo, hi]."""
    total = 0.0
    for s, e in merge_intervals(intervals):
        s, e = max(s, lo), min(e, hi)
        if e > s:
            total += e - s
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """[start, end] of every stretch of [lo, hi] no interval covers."""
    gaps, at = [], lo
    for s, e in merge_intervals(intervals):
        if s > at:
            gaps.append([at, min(s, hi)])
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        gaps.append([at, hi])
    return [g for g in gaps if g[1] > g[0]]


def blend_bytes(height: int, width: int) -> int:
    """Bytes the blending kernel must move for one frame: its four (H, W)
    f32 input maps (depth, supported, valid, average) read once and its
    f32 output written once."""
    return 5 * 4 * height * width


# Bytes the regularisation kernel must move for a row it steps: the row's
# 18-word pack row read and written, its four neighbour slots read and
# written, its four slot distances written (f32 and int32 words).
REGULARIZE_ROW_BYTES = (2 * 18 + 2 * 4 + 4) * 4


def regularize_bytes(rows: int, iterations: int) -> int:
    """Bytes the regularisation kernel must move for a frame stepped over
    `rows` rows, one launch an iteration.  On the count-sized and
    full-shape routes the neighbours' gathered words lie in pack rows
    read already."""
    return REGULARIZE_ROW_BYTES * rows * iterations


def roofline_pct(bytes_moved: float, ops: float, seconds: float,
                 peak: dict) -> float:
    """A kernel's share of its roofline, in %: the least time its bytes
    and operations need at the device's peaks over the time it took."""
    if seconds <= 0:
        raise ValueError("a roofline share needs a positive time")
    least = max(bytes_moved / peak["hbm_bytes_per_s"],
                ops / peak["f32_flops_per_s"])
    return 100.0 * least / seconds
