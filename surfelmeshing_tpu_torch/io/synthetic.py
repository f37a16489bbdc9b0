"""Synthetic RGB-D sequence generator.

Produces deterministic raytraced depth + color frames of parametric scenes
with smooth camera trajectories and exact poses.  Used by tests and by
bench.py when no TUM RGB-D dataset is on disk; can also write a full
TUM-format dataset directory (calibration.txt, associated.txt,
groundtruth.txt, PNGs) so the dataset loader path is exercised end-to-end.

Besides the default scene (back wall + floor + sphere), a registry of
HOSTILE scenes exercises the failure modes real TUM sequences exhibit
(occlusion edges / depth shadows, thin structures, sharp creases,
look-away-and-return revisits, forward scale drift) so reconstruction
deviations can be A/B'd across geometry classes, not one data point.
Every scene provides an analytic exact distance-to-surface so mesh/cloud
accuracy is measurable without a ground-truth mesh file.

Geometry conventions match the reference pipeline: depth stored as
u16 = depth_scaling * meters (TUM convention, main.cc:279-282), camera model
is the pinhole camera of utils.camera with pixel-corner cx/cy.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Tuple

import numpy as np

from ..utils.camera import PinholeCamera
from ..utils.se3 import SE3


def default_camera(width: int = 640, height: int = 480) -> PinholeCamera:
    # fr1-like intrinsics; stored cx/cy use the pixel-corner convention.
    f = 525.0 * width / 640.0
    return PinholeCamera(width, height, f, f,
                         width / 2.0 + 0.5, height / 2.0 + 0.5)


def _ray_directions(camera: PinholeCamera) -> np.ndarray:
    """(H, W, 3) unit-z ray directions through pixel centers."""
    fx_inv, fy_inv, cx_inv, cy_inv = camera.unprojection
    xs = np.arange(camera.width, dtype=np.float64)
    ys = np.arange(camera.height, dtype=np.float64)
    dir_x = fx_inv * xs + cx_inv
    dir_y = fy_inv * ys + cy_inv
    dx, dy = np.meshgrid(dir_x, dir_y)
    return np.stack([dx, dy, np.ones_like(dx)], axis=-1)


def _yaw_pose(yaw: float, t) -> SE3:
    q = np.array([0.0, np.sin(yaw / 2), 0.0, np.cos(yaw / 2)])
    return SE3(q, t)


def _trajectory(num_frames: int) -> List[SE3]:
    """Smooth sideways arc with slight yaw; global_T_camera poses."""
    poses = []
    for i in range(num_frames):
        s = i / max(1, num_frames - 1)
        tx = 0.25 * np.sin(2 * np.pi * s * 0.5)
        ty = 0.05 * np.sin(2 * np.pi * s)
        tz = 0.1 * s
        yaw = 0.1 * np.sin(2 * np.pi * s * 0.5)
        poses.append(_yaw_pose(yaw, [tx, ty, tz]))
    return poses


def _trajectory_lookaway(num_frames: int) -> List[SE3]:
    """Pan hard to the side mid-sequence and come back: surfaces leave the
    view long enough to exit the integration active window and are then
    revisited — the loop-revisit / active-window re-entry phenomenon of
    real hand-held TUM sequences (surfel active window,
    cuda_surfel_reconstruction_kernels.cu:77-87)."""
    poses = []
    for i in range(num_frames):
        s = i / max(1, num_frames - 1)
        # Triangle profile: 0 -> 0.9 rad (~52deg) at midpoint -> 0.
        yaw = 0.9 * (1.0 - abs(2.0 * s - 1.0))
        tx = 0.1 * np.sin(np.pi * s)
        poses.append(_yaw_pose(yaw, [tx, 0.0, 0.0]))
    return poses


def _trajectory_push(num_frames: int) -> List[SE3]:
    """Forward dolly toward the scene: the apparent surfel radius shrinks
    ~2x over the run, driving scene-scale drift (exercises the meshing
    grid's cell-size rebuild and radius-dependent fusion thresholds)."""
    poses = []
    for i in range(num_frames):
        s = i / max(1, num_frames - 1)
        tz = 1.1 * s
        ty = 0.02 * np.sin(2 * np.pi * s)
        poses.append(_yaw_pose(0.0, [0.0, ty, tz]))
    return poses


TRAJECTORIES = {
    "arc": _trajectory,
    "lookaway": _trajectory_lookaway,
    "push": _trajectory_push,
}


# --------------------------------------------------------------------------
# Raytracing primitives (vectorized over an (..., 3) ray grid).  Each helper
# folds its hits into the running (t, mat) nearest-hit state.


def _isect_plane(origins, dirs, t, mat, axis, value, sign, m, bounds=()):
    """One-sided axis-aligned plane; optional rectangle bounds on the
    in-plane axes as ((axis, lo, hi), ...)."""
    d = dirs[..., axis]
    with np.errstate(divide="ignore", invalid="ignore"):
        tp = (value - origins[..., axis]) / d
    hit = (tp > 0.05) & (sign * d > 1e-9)
    for (b_axis, lo, hi) in bounds:
        coord = origins[..., b_axis] + tp * dirs[..., b_axis]
        hit = hit & (coord >= lo) & (coord <= hi)
    better = hit & (tp < t)
    return np.where(better, tp, t), np.where(better, m, mat)


def _isect_sphere(origins, dirs, t, mat, center, radius, m):
    oc = origins - np.asarray(center)
    dd = np.sum(dirs * dirs, axis=-1)
    b = np.sum(oc * dirs, axis=-1) / dd
    c = (np.sum(oc * oc, axis=-1) - radius ** 2) / dd
    disc = b * b - c
    ts = -b - np.sqrt(np.maximum(disc, 0.0))
    hit = (disc > 0) & (ts > 0.05)
    better = hit & (ts < t)
    return np.where(better, ts, t), np.where(better, m, mat)


def _isect_box(origins, dirs, t, mat, lo, hi, m):
    """Axis-aligned box via the slab method (entry face only — the camera
    is assumed outside)."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / dirs
        t0 = (lo - origins) * inv
        t1 = (hi - origins) * inv
    tmin = np.minimum(t0, t1).max(axis=-1)
    tmax = np.maximum(t0, t1).min(axis=-1)
    hit = (tmin <= tmax) & (tmin > 0.05)
    better = hit & (tmin < t)
    return np.where(better, tmin, t), np.where(better, m, mat)


# Exact point-to-surface distances for the same primitives (pts: (N, 3)).


def _dist_plane(pts, axis, value, bounds=()):
    d_axis = pts[:, axis] - value
    d_sq = d_axis * d_axis
    for (b_axis, lo, hi) in bounds:
        c = pts[:, b_axis]
        over = np.maximum(np.maximum(lo - c, c - hi), 0.0)
        d_sq = d_sq + over * over
    return np.sqrt(d_sq)


def _dist_sphere(pts, center, radius):
    return np.abs(np.linalg.norm(pts - np.asarray(center), axis=1) - radius)


def _dist_box(pts, lo, hi):
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    q = np.maximum(np.maximum(lo - pts, pts - hi), 0.0)
    outside = np.linalg.norm(q, axis=1)
    inside = np.minimum(np.min(pts - lo, axis=1), np.min(hi - pts, axis=1))
    return np.where(outside > 0, outside, np.maximum(inside, 0.0))


@dataclasses.dataclass(frozen=True)
class Scene:
    """A raytraceable scene with an analytic exact surface distance.

    `intersect(origins, dirs) -> (t, mat)` nearest-hit raytrace (t=inf for
    miss); `surface_distance(pts) -> (N,)` exact distance from world points
    to the scene surface (the accuracy denominator for A/B evals)."""

    name: str
    intersect: "callable"
    surface_distance: "callable"


def _intersect_scene(origins: np.ndarray, dirs: np.ndarray):
    """Raytrace the default scene in world space.

    Scene: back wall (z=2.5), floor (y=0.8, normal -y), sphere at
    (0, 0.3, 1.8) r=0.35.  Returns (t, material_id) with t=inf for miss.
    """
    t = np.full(dirs.shape[:-1], np.inf)
    mat = np.zeros(dirs.shape[:-1], dtype=np.int32)

    # Back wall: z = 2.5.
    dz = dirs[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_wall = (2.5 - origins[..., 2]) / dz
    hit = (t_wall > 0.05) & (dz > 1e-9)
    t = np.where(hit & (t_wall < t), t_wall, t)
    mat = np.where(hit & (t_wall <= t), 1, mat)

    # Floor: y = 0.8.
    dy = dirs[..., 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_floor = (0.8 - origins[..., 1]) / dy
    hit = (t_floor > 0.05) & (dy > 1e-9)
    better = hit & (t_floor < t)
    t = np.where(better, t_floor, t)
    mat = np.where(better, 2, mat)

    # Sphere.  NOTE: dirs are unnormalized (z=1 parameterization), so the
    # quadratic must be scaled by d.d — the first-round version omitted
    # that and produced phantom "hits" on rays passing near the sphere
    # (their depths were NOT on the sphere surface, so the scene's depth
    # maps disagreed with its analytic geometry).
    t, mat = _isect_sphere(origins, dirs, t, mat, [0.0, 0.3, 1.8], 0.35, 3)

    return t, mat


def _default_distance(pts):
    return np.minimum(
        np.minimum(_dist_plane(pts, 2, 2.5), _dist_plane(pts, 1, 0.8)),
        _dist_sphere(pts, [0.0, 0.3, 1.8], 0.35))


# Foreground slab of the occlusion scene (shadows the wall behind it; its
# silhouette sweeps across the background as the camera arcs, generating
# occlusion boundaries, depth shadows and support/conflict churn).
_OCC_BOX = ([-0.45, -0.10, 1.15], [0.05, 0.55, 1.35])
# Thin plate of the thin-structure scene: 2 cm thick at ~1.6 m depth —
# thinner than the sensor-noise conflict band (0.05 * 1.6 = 8 cm), so the
# front and back faces sit inside each other's occlusion/conflict zones.
_THIN_PLATE = ([-0.30, 0.00, 1.59], [0.30, 0.55, 1.61])
_THIN_BAR = ([-0.55, 0.26, 1.95], [0.55, 0.30, 1.99])
# Corner scene: side wall x = -0.7 meeting the back wall at a crease.
_CORNER_X = -0.7


def _intersect_occlusion(origins, dirs):
    t, mat = _intersect_scene(origins, dirs)
    return _isect_box(origins, dirs, t, mat, *_OCC_BOX, 4)


def _occlusion_distance(pts):
    return np.minimum(_default_distance(pts), _dist_box(pts, *_OCC_BOX))


def _intersect_thin(origins, dirs):
    t = np.full(dirs.shape[:-1], np.inf)
    mat = np.zeros(dirs.shape[:-1], dtype=np.int32)
    t, mat = _isect_plane(origins, dirs, t, mat, 2, 2.5, 1.0, 1)
    t, mat = _isect_plane(origins, dirs, t, mat, 1, 0.8, 1.0, 2)
    t, mat = _isect_box(origins, dirs, t, mat, *_THIN_PLATE, 3)
    t, mat = _isect_box(origins, dirs, t, mat, *_THIN_BAR, 4)
    return t, mat


def _thin_distance(pts):
    d = np.minimum(_dist_plane(pts, 2, 2.5), _dist_plane(pts, 1, 0.8))
    d = np.minimum(d, _dist_box(pts, *_THIN_PLATE))
    return np.minimum(d, _dist_box(pts, *_THIN_BAR))


def _intersect_corner(origins, dirs):
    t = np.full(dirs.shape[:-1], np.inf)
    mat = np.zeros(dirs.shape[:-1], dtype=np.int32)
    t, mat = _isect_plane(origins, dirs, t, mat, 2, 2.5, 1.0, 1,
                          bounds=((0, _CORNER_X, np.inf),))
    t, mat = _isect_plane(origins, dirs, t, mat, 0, _CORNER_X, -1.0, 4,
                          bounds=((2, 0.05, 2.5),))
    t, mat = _isect_plane(origins, dirs, t, mat, 1, 0.8, 1.0, 2)
    t, mat = _isect_sphere(origins, dirs, t, mat, [0.0, 0.3, 1.8], 0.35, 3)
    return t, mat


def _corner_distance(pts):
    d = np.minimum(
        _dist_plane(pts, 2, 2.5, bounds=((0, _CORNER_X, np.inf),)),
        _dist_plane(pts, 0, _CORNER_X, bounds=((2, 0.05, 2.5),)))
    d = np.minimum(d, _dist_plane(pts, 1, 0.8))
    return np.minimum(d, _dist_sphere(pts, [0.0, 0.3, 1.8], 0.35))


SCENES: Dict[str, Scene] = {
    "default": Scene("default", _intersect_scene, _default_distance),
    "occlusion": Scene("occlusion", _intersect_occlusion,
                       _occlusion_distance),
    "thin": Scene("thin", _intersect_thin, _thin_distance),
    "corner": Scene("corner", _intersect_corner, _corner_distance),
}


def render_frame(camera: PinholeCamera, global_T_camera: SE3,
                 depth_scaling: float = 5000.0,
                 noise_sigma: float = 0.0,
                 seed: int = 0,
                 scene: Scene = None) -> Tuple[np.ndarray, np.ndarray]:
    """-> (depth u16 (H,W), color u8 (H,W,3))."""
    if scene is None:
        scene = SCENES["default"]
    dirs_cam = _ray_directions(camera)
    R = global_T_camera.rotation_matrix
    dirs_world = dirs_cam @ R.T
    origin = np.broadcast_to(global_T_camera.t, dirs_world.shape)

    t, mat = scene.intersect(origin, dirs_world)
    # t is the parameter along a ray whose z-component in camera space is 1,
    # so camera-space depth z == t.
    depth_m = np.where(np.isfinite(t), t, 0.0)
    if noise_sigma > 0:
        rng = np.random.default_rng(seed)
        depth_m = np.where(
            depth_m > 0,
            depth_m * (1.0 + noise_sigma * rng.standard_normal(depth_m.shape)),
            0.0)
    depth_u16 = np.clip(depth_scaling * depth_m + 0.5, 0, 65535).astype(np.uint16)

    # Simple per-material shading with a distance falloff.
    base = np.array([[0, 0, 0], [200, 180, 160], [90, 130, 90],
                     [180, 60, 60], [70, 90, 170]], dtype=np.float64)
    shade = np.clip(1.0 - 0.18 * np.where(np.isfinite(t), t, 0.0), 0.3, 1.0)
    color = (base[mat] * shade[..., None]).astype(np.uint8)
    return depth_u16, color


class SyntheticRGBDSequence:
    """In-memory RGB-D sequence with exact poses."""

    def __init__(self, num_frames: int = 20, width: int = 640,
                 height: int = 480, depth_scaling: float = 5000.0,
                 noise_sigma: float = 0.0, scene: str = "default",
                 trajectory: str = "arc"):
        self.camera = default_camera(width, height)
        self.depth_scaling = depth_scaling
        self.scene = SCENES[scene]
        self.poses = TRAJECTORIES[trajectory](num_frames)  # global_T_frame
        self.noise_sigma = noise_sigma
        self._cache = {}

    def surface_distance(self, pts: np.ndarray) -> np.ndarray:
        """Exact distance from world points to the scene surface."""
        return self.scene.surface_distance(np.asarray(pts, np.float64))

    @property
    def frame_count(self) -> int:
        return len(self.poses)

    def depth_and_color(self, i: int):
        if i not in self._cache:
            self._cache[i] = render_frame(
                self.camera, self.poses[i], self.depth_scaling,
                self.noise_sigma, seed=i, scene=self.scene)
        return self._cache[i]


class ArrayImageFrame:
    """ImageFrame backed by an in-memory array (no file behind it).

    Matches the io.tum.ImageFrame interface the pipeline consumes;
    clear_image is a no-op so frames can be replayed (benchmark re-runs)."""

    __slots__ = ("timestamp", "global_T_frame", "_image")

    def __init__(self, image: np.ndarray, timestamp: float,
                 global_T_frame: SE3):
        self.timestamp = timestamp
        self.global_T_frame = global_T_frame
        self._image = image

    def get_image(self) -> np.ndarray:
        return self._image

    def clear_image(self) -> None:
        pass

    @property
    def frame_T_global(self) -> SE3:
        return self.global_T_frame.inverse()


def synthetic_rgbd_video(num_frames: int = 20, width: int = 640,
                         height: int = 480, depth_scaling: float = 5000.0,
                         noise_sigma: float = 0.0, scene: str = "default",
                         trajectory: str = "arc"):
    """-> (in-memory RGBDVideo, SyntheticRGBDSequence).

    Pre-renders every frame into ArrayImageFrames so the pipeline can be
    driven without disk I/O (the reference's first run is disk-bound,
    README.md:100-103; the bench excludes I/O like the reference's
    fusion-stage timings, main.cc:1531-1545)."""
    from .tum import RGBDVideo

    seq = SyntheticRGBDSequence(num_frames, width, height, depth_scaling,
                                noise_sigma=noise_sigma, scene=scene,
                                trajectory=trajectory)
    colors, depths = [], []
    for i in range(num_frames):
        d, c = seq.depth_and_color(i)
        ts = 1000.0 + 0.05 * i
        colors.append(ArrayImageFrame(c, ts, seq.poses[i]))
        depths.append(ArrayImageFrame(d, ts, seq.poses[i]))
    video = RGBDVideo(colors, depths, seq.camera, seq.camera)
    return video, seq


def write_tum_dataset(path: str, num_frames: int = 12, width: int = 160,
                      height: int = 120, depth_scaling: float = 5000.0,
                      scene: str = "default",
                      trajectory: str = "arc") -> str:
    """Write a TUM-format dataset directory for loader tests."""
    from PIL import Image as PILImage

    os.makedirs(os.path.join(path, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(path, "depth"), exist_ok=True)
    seq = SyntheticRGBDSequence(num_frames, width, height, depth_scaling,
                                scene=scene, trajectory=trajectory)
    cam = seq.camera

    with open(os.path.join(path, "calibration.txt"), "w") as f:
        # calibration.txt holds pixel-center cx/cy; loader adds +0.5.
        f.write(f"{cam.fx} {cam.fy} {cam.cx - 0.5} {cam.cy - 0.5}\n")

    assoc_lines = []
    traj_lines = ["# ground truth trajectory"]
    for i in range(num_frames):
        ts = 1000.0 + 0.05 * i
        depth, color = seq.depth_and_color(i)
        rgb_name = f"rgb/{ts:.6f}.png"
        depth_name = f"depth/{ts:.6f}.png"
        PILImage.fromarray(color).save(os.path.join(path, rgb_name))
        PILImage.fromarray(depth, mode="I;16").save(os.path.join(path, depth_name))
        assoc_lines.append(f"{ts:.6f} {rgb_name} {ts:.6f} {depth_name}")
        p = seq.poses[i]
        traj_lines.append(
            f"{ts:.6f} {p.t[0]} {p.t[1]} {p.t[2]} "
            f"{p.q[0]} {p.q[1]} {p.q[2]} {p.q[3]}")

    with open(os.path.join(path, "associated.txt"), "w") as f:
        f.write("\n".join(assoc_lines) + "\n")
    with open(os.path.join(path, "groundtruth.txt"), "w") as f:
        f.write("\n".join(traj_lines) + "\n")
    return path
