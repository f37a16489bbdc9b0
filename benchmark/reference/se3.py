"""Frozen, trimmed copy of surfelmeshing_tpu_torch/utils/se3.py, kept as
the benchmark's plain reference: it imports nothing of the port, so a
later change to the port is judged against this copy, never against
itself.

SE3 pose utilities (NumPy host side; JAX-compatible 3x4 matrices device side).

Replaces the reference's Sophus SE3f usage (libvis/third_party/sophus).  Poses
are stored as unit quaternion (x, y, z, w) + translation, matching the TUM
trajectory file convention "tx ty tz qx qy qz qw".
"""

from __future__ import annotations

import numpy as np


def quat_normalize(q: np.ndarray) -> np.ndarray:
    return q / np.linalg.norm(q)


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (x, y, z, w) -> 3x3 rotation matrix."""
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float64)


def quat_conjugate(q: np.ndarray) -> np.ndarray:
    return np.array([-q[0], -q[1], -q[2], q[3]], dtype=q.dtype)


def quat_multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dtype=np.float64)


class SE3:
    """Rigid transform: x_out = R @ x + t.  Quaternion is (x, y, z, w)."""

    __slots__ = ("q", "t")

    def __init__(self, q=None, t=None):
        self.q = np.array([0.0, 0.0, 0.0, 1.0] if q is None else q,
                          dtype=np.float64)
        self.q = quat_normalize(self.q)
        self.t = np.array([0.0, 0.0, 0.0] if t is None else t, dtype=np.float64)

    @property
    def rotation_matrix(self) -> np.ndarray:
        return quat_to_rotmat(self.q)

    def matrix(self) -> np.ndarray:
        m = np.eye(4, dtype=np.float64)
        m[:3, :3] = self.rotation_matrix
        m[:3, 3] = self.t
        return m

    def matrix3x4(self) -> np.ndarray:
        return self.matrix()[:3, :]

    def inverse(self) -> "SE3":
        q_inv = quat_conjugate(self.q)
        R_inv = quat_to_rotmat(q_inv)
        return SE3(q_inv, -(R_inv @ self.t))

    def __mul__(self, other):
        if isinstance(other, SE3):
            return SE3(quat_multiply(self.q, other.q),
                       self.rotation_matrix @ other.t + self.t)
        other = np.asarray(other, dtype=np.float64)
        return self.rotation_matrix @ other + self.t

    def scaled_translation(self, scale: float) -> "SE3":
        """Copy with translation multiplied by `scale` (main.cc:1039-1040)."""
        return SE3(self.q.copy(), scale * self.t)

    def __repr__(self):
        return f"SE3(q={self.q}, t={self.t})"

