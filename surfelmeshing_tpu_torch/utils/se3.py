"""SE3 pose utilities (NumPy host side; JAX-compatible 3x4 matrices device side).

Replaces the reference's Sophus SE3f usage (libvis/third_party/sophus;
interpolation in libvis/src/libvis/rgbd_video_io_tum_dataset.h:43-82).  Poses
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


def quat_slerp(qa: np.ndarray, qb: np.ndarray, t: float) -> np.ndarray:
    """Spherical linear interpolation, shortest arc (Eigen slerp semantics)."""
    qa = np.asarray(qa, dtype=np.float64)
    qb = np.asarray(qb, dtype=np.float64)
    dot = float(np.dot(qa, qb))
    if dot < 0.0:
        qb = -qb
        dot = -dot
    if dot > 0.9995:
        out = qa + t * (qb - qa)
        return quat_normalize(out)
    theta0 = np.arccos(np.clip(dot, -1.0, 1.0))
    theta = theta0 * t
    sin_theta0 = np.sin(theta0)
    s0 = np.sin(theta0 - theta) / sin_theta0
    s1 = np.sin(theta) / sin_theta0
    return quat_normalize(s0 * qa + s1 * qb)


class SE3:
    """Rigid transform: x_out = R @ x + t.  Quaternion is (x, y, z, w)."""

    __slots__ = ("q", "t")

    def __init__(self, q=None, t=None):
        self.q = np.array([0.0, 0.0, 0.0, 1.0] if q is None else q,
                          dtype=np.float64)
        self.q = quat_normalize(self.q)
        self.t = np.array([0.0, 0.0, 0.0] if t is None else t, dtype=np.float64)

    @staticmethod
    def identity() -> "SE3":
        return SE3()

    @staticmethod
    def from_matrix(m: np.ndarray) -> "SE3":
        m = np.asarray(m, dtype=np.float64)
        R = m[:3, :3]
        # Shepperd's method for robustness.
        tr = np.trace(R)
        if tr > 0:
            s = np.sqrt(tr + 1.0) * 2
            w = 0.25 * s
            x = (R[2, 1] - R[1, 2]) / s
            y = (R[0, 2] - R[2, 0]) / s
            z = (R[1, 0] - R[0, 1]) / s
        elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
            s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
            w = (R[2, 1] - R[1, 2]) / s
            x = 0.25 * s
            y = (R[0, 1] + R[1, 0]) / s
            z = (R[0, 2] + R[2, 0]) / s
        elif R[1, 1] > R[2, 2]:
            s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
            w = (R[0, 2] - R[2, 0]) / s
            x = (R[0, 1] + R[1, 0]) / s
            y = 0.25 * s
            z = (R[1, 2] + R[2, 1]) / s
        else:
            s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
            w = (R[1, 0] - R[0, 1]) / s
            x = (R[0, 2] + R[2, 0]) / s
            y = (R[1, 2] + R[2, 1]) / s
            z = 0.25 * s
        return SE3(np.array([x, y, z, w]), m[:3, 3])

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


def interpolate_pose(timestamp: float,
                     pose_timestamps: np.ndarray,
                     poses: list,
                     max_interpolation_time_extent: float = np.inf):
    """Slerp-interpolate a pose at `timestamp`, or None if the gap is too big.

    Mirrors InterpolatePose (rgbd_video_io_tum_dataset.h:43-82): clamps to the
    first/last pose outside the trajectory time range, drops frames whose
    bracketing poses are further than max_interpolation_time_extent away.
    """
    n = len(pose_timestamps)
    assert n >= 2
    if timestamp <= pose_timestamps[0]:
        return poses[0]
    if timestamp >= pose_timestamps[-1]:
        return poses[-1]
    i = int(np.searchsorted(pose_timestamps, timestamp, side="right") - 1)
    i = max(0, min(i, n - 2))
    t0, t1 = pose_timestamps[i], pose_timestamps[i + 1]
    if (timestamp - t0) > max_interpolation_time_extent or \
       (t1 - timestamp) > max_interpolation_time_extent:
        return None
    factor = (timestamp - t0) / (t1 - t0)
    pa, pb = poses[i], poses[i + 1]
    q = quat_slerp(pa.q, pb.q, factor)
    t = pa.t + factor * (pb.t - pa.t)
    return SE3(q, t)
