"""Catmull-Rom camera-path playback.

Replaces the reference's vendored spline_library usage for keyframe-based
video recording (--record_keyframes / --playback_keyframes; uniform
Catmull-Rom over camera poses, main.cc:56,675-742,1395-1417).  Keyframe files
hold "frame_index tx ty tz qx qy qz qw" lines; playback interpolates position
with a uniform Catmull-Rom spline and orientation with piecewise slerp.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .se3 import SE3, quat_slerp


def catmull_rom(p0, p1, p2, p3, t: float) -> np.ndarray:
    """Uniform Catmull-Rom point for t in [0, 1] between p1 and p2."""
    t2 = t * t
    t3 = t2 * t
    return 0.5 * ((2.0 * p1) +
                  (-p0 + p2) * t +
                  (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * t2 +
                  (-p0 + 3.0 * p1 - 3.0 * p2 + p3) * t3)


class KeyframePath:
    """Spline over keyframe poses, sampled by a continuous parameter."""

    def __init__(self, poses: List[SE3]):
        if len(poses) < 2:
            raise ValueError("need at least 2 keyframes")
        self.poses = poses

    @property
    def max_parameter(self) -> float:
        return float(len(self.poses) - 1)

    def sample(self, s: float) -> SE3:
        n = len(self.poses)
        s = min(max(s, 0.0), n - 1 - 1e-9)
        i = int(s)
        t = s - i
        p0 = self.poses[max(i - 1, 0)].t
        p1 = self.poses[i].t
        p2 = self.poses[min(i + 1, n - 1)].t
        p3 = self.poses[min(i + 2, n - 1)].t
        pos = catmull_rom(p0, p1, p2, p3, t)
        q = quat_slerp(self.poses[i].q, self.poses[min(i + 1, n - 1)].q, t)
        return SE3(q, pos)


def write_keyframes(path: str, keyframes: List[Tuple[int, SE3]]) -> None:
    with open(path, "w") as f:
        for frame_index, pose in keyframes:
            f.write(f"{frame_index} "
                    f"{pose.t[0]} {pose.t[1]} {pose.t[2]} "
                    f"{pose.q[0]} {pose.q[1]} {pose.q[2]} {pose.q[3]}\n")


def read_keyframes(path: str) -> List[Tuple[int, SE3]]:
    out = []
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 8 or line.startswith("#"):
                continue
            frame_index = int(float(parts[0]))
            tx, ty, tz, qx, qy, qz, qw = (float(x) for x in parts[1:8])
            out.append((frame_index, SE3([qx, qy, qz, qw], [tx, ty, tz])))
    return out
