"""The plain reference, frame by frame, from the benchmark's own inputs.

It takes a deployment's settings (the configuration file's "settings"),
its camera, the generated frames and a surfel map, and computes what one
fused frame does: the depth window's upload, the five preprocessing
passes, the outlier window's transforms from the poses, and the 8 fusion
phases over the first n_eff rows of the map (the count-sized step; at
n_eff = capacity the full-shape one).  It runs eagerly on any device with
the plain blending, and works everything out again from the frames: no
tensor the program made enters it besides the map it is asked to step
from.

`low_precision` makes the control: after every frame the map's float
columns are rounded to bfloat16 (its int32 bit columns are kept), the
storage a later change might be tempted to use.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import fusion as fu
from . import preprocess as pp
from .se3 import SE3


# The fusion modes a deployment may state, under FusionParams's names; an
# absent one takes FusionParams's default.
MODES = ("symmetric_regularization", "exact_conflict_arbitration",
         "fast_neighbor_update")

# Settings the reference reads: fusion_params, preprocess_kwargs, capacity
# and ReferenceFusion here, adaptive_creation_bound in cell.Run.check
# (whether the program's bucket may defer creations).
READ = frozenset({
    "depth_scaling", "pyramid_level", "start_frame", "max_surfel_count",
    "sensor_noise_factor", "max_surfel_confidence", "regularizer_weight",
    "normal_compatibility_threshold_deg", "regularization_frame_window_size",
    "do_blending", "measurement_blending_radius",
    "regularization_iterations_per_integration_iteration",
    "radius_factor_for_regularization_neighbors",
    "surfel_integration_active_window_size", "max_creations_per_frame",
    "active_surfel_budget", "adaptive_creation_bound", "max_depth",
    "depth_valid_region_radius", "observation_angle_threshold_deg",
    "depth_erosion_radius", "median_filter_and_densify_iterations",
    "outlier_filtering_frame_count", "outlier_filtering_required_inliers",
    "bilateral_filter_sigma_xy", "bilateral_filter_radius_factor",
    "bilateral_filter_sigma_depth_factor",
    "outlier_filtering_depth_tolerance_factor",
    "point_radius_extension_factor", "point_radius_clamp_factor", *MODES})
# Settings the reference reads that it runs at one value only.
ONLY = {"pyramid_level": 0, "start_frame": 0}
# Settings that by design change no word of the map or of the mesher's
# view, so the reference has nothing to read in them: pacing
# (restrict_fps_to: the app's frame timer), dispatch (shape_bucket_step:
# the rows a frame runs over, held by the check's bucket test;
# max_inflight_dispatches: readbacks outstanding), the overflow abort (the
# app's), the transfer format (delta_surfel_transfer: delta or full
# snapshots rebuild the same view) and the mesher's triangulation
# thresholds and scheduling (meshing/driver.py, app/main.py).
UNCHECKED = frozenset({
    "restrict_fps_to", "shape_bucket_step", "max_inflight_dispatches",
    "abort_on_surfel_overflow", "delta_surfel_transfer",
    "max_angle_between_normals_deg", "min_triangle_angle_deg",
    "max_triangle_angle_deg", "max_neighbor_search_range_increase_factor",
    "long_edge_tolerance_factor", "max_surfels_per_node",
    "asynchronous_triangulation", "full_meshing_every_frame"})


def refuse_unchecked(settings: dict) -> None:
    """Raise ValueError naming every setting the reference can neither
    read nor leave aside, and every one it reads at a value it does not
    run: a check that ignored it would judge another deployment."""
    unknown = sorted(set(settings) - READ - UNCHECKED)
    if unknown:
        raise ValueError(f"settings the reference cannot check: {unknown}")
    for key, value in ONLY.items():
        if settings.get(key, value) != value:
            raise ValueError(f"the reference runs {key} {value} only, not "
                             f"{settings[key]!r}")


def capacity(settings: dict) -> int:
    """The map's capacity: max_surfel_count, rounded up to whole tiles
    when an active-surfel budget is set."""
    cap = int(settings["max_surfel_count"])
    if settings["active_surfel_budget"]:
        ts = fu.FusionParams(width=1, height=1, fx=1, fy=1, cx=0,
                             cy=0).tile_size
        cap = (cap + ts - 1) // ts * ts
    return cap


def fusion_params(settings: dict, camera: dict) -> fu.FusionParams:
    """FusionParams of the deployment, without an active-surfel budget:
    the tiled step equals the full-shape one when no tile is skipped.
    The fusion modes (MODES) the settings state are passed on."""
    s = settings
    return fu.FusionParams(
        width=camera["width"], height=camera["height"],
        fx=camera["fx"], fy=camera["fy"], cx=camera["cx"], cy=camera["cy"],
        depth_scaling=s["depth_scaling"],
        sensor_noise_factor=s["sensor_noise_factor"],
        max_surfel_confidence=s["max_surfel_confidence"],
        normal_compatibility_threshold_deg=(
            s["normal_compatibility_threshold_deg"]),
        regularizer_weight=s["regularizer_weight"],
        regularization_frame_window_size=(
            s["regularization_frame_window_size"]),
        do_blending=s["do_blending"],
        measurement_blending_radius=s["measurement_blending_radius"],
        regularization_iterations=(
            s["regularization_iterations_per_integration_iteration"]),
        radius_factor_for_regularization_neighbors=(
            s["radius_factor_for_regularization_neighbors"]),
        surfel_integration_active_window_size=(
            s["surfel_integration_active_window_size"]),
        active_surfel_budget=0,
        max_creations_per_frame=s["max_creations_per_frame"],
        **{k: s[k] for k in MODES if k in s})


def preprocess_kwargs(settings: dict, camera: dict) -> dict:
    s = settings
    required = s["outlier_filtering_required_inliers"]
    if required in (s["outlier_filtering_frame_count"], -1):
        required = None
    return dict(
        sigma_xy=s["bilateral_filter_sigma_xy"],
        sigma_value_factor=s["bilateral_filter_sigma_depth_factor"],
        radius_factor=s["bilateral_filter_radius_factor"],
        max_depth_u16=int(s["depth_scaling"] * s["max_depth"]),
        depth_valid_region_radius=s["depth_valid_region_radius"],
        tolerance=s["outlier_filtering_depth_tolerance_factor"],
        required_inliers=required,
        erosion_radius=s["depth_erosion_radius"],
        observation_angle_threshold_deg=(
            s["observation_angle_threshold_deg"]),
        depth_scaling=s["depth_scaling"],
        point_radius_extension_factor=s["point_radius_extension_factor"],
        point_radius_clamp_factor=float(s["point_radius_clamp_factor"]),
        fx=camera["fx"], fy=camera["fy"], cx=camera["cx"], cy=camera["cy"])


def empty_map(settings: dict, device) -> fu.SurfelState:
    return fu.create_surfel_state(capacity(settings), device)


def clone_map(state) -> fu.SurfelState:
    """A reference-side copy of a map (any object with SurfelState's
    fields), so the reference never writes the program's tensors."""
    return fu.SurfelState(**{f.name: getattr(state, f.name).clone()
                             for f in dataclasses.fields(fu.SurfelState)})


class ReferenceFusion:
    """Steps a map through frames of a generated video.

    `frames` is a traffic.generator.Frames; frame i shows image i mod
    period at pose i mod period."""

    def __init__(self, settings: dict, camera: dict, frames, device,
                 low_precision: bool = False):
        refuse_unchecked(settings)
        self.settings, self.camera = settings, camera
        self.frames = frames
        self.device = torch.device(device)
        self.params = fusion_params(settings, camera)
        self.pp_kwargs = preprocess_kwargs(settings, camera)
        self.low_precision = low_precision
        self.k = settings["outlier_filtering_frame_count"]

    def _pose(self, i: int) -> SE3:
        p = i % self.frames.period
        return SE3(self.frames.quat[p], self.frames.trans[p])

    def _depth(self, i: int) -> torch.Tensor:
        d = self.frames.depth[i % self.frames.period]
        t = torch.from_numpy(d.astype(np.int32)).to(self.device)
        for _ in range(self.settings["median_filter_and_densify_iterations"]):
            t = pp.median_filter_and_densify(t)
        return t

    def _offsets(self):
        half = self.k // 2
        return list(range(-half, 0)) + list(range(1, half + 1))

    def _transforms(self, i: int) -> np.ndarray:
        """(K, 3, 4) other_T_reference of frame i's outlier window, pose
        translations scaled to depth units."""
        scale = self.settings["depth_scaling"]
        ref = self._pose(i).scaled_translation(scale)
        out = [(ref.inverse() * self._pose(i + o).scaled_translation(scale))
               .inverse().matrix3x4() for o in self._offsets()]
        return np.stack(out).astype(np.float32)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
            .to(self.device)

    def frame_inputs(self, i: int) -> tuple:
        """What the fusion step of frame i takes: the preprocessed depth,
        normals and radii, the colour image and the pose both ways."""
        depth = self._depth(i)
        others = torch.stack([self._depth(i + o) for o in self._offsets()])
        d, nrm, rad = pp.preprocess_frame(
            depth, others, self._tensor(self._transforms(i)),
            **self.pp_kwargs)
        color = torch.from_numpy(np.ascontiguousarray(
            self.frames.color[i % self.frames.period].transpose(2, 0, 1))) \
            .to(self.device)
        pose = self._pose(i)
        return (d, nrm, rad, color, self._tensor(pose.matrix3x4()),
                self._tensor(pose.inverse().matrix3x4()))

    def step(self, state: fu.SurfelState, i: int, n_eff: int
             ) -> fu.SurfelState:
        """Frame i fused into `state` over its first n_eff rows; the
        input's tensors are written in place, as the count-sized step
        does."""
        out = fu.integrate_frame_bucketed(state, *self.frame_inputs(i), i,
                                          self.params, int(n_eff))
        if self.low_precision:
            round_to_bfloat16(out)
        return out

    def needed_rows(self, state: fu.SurfelState) -> int:
        """Rows a frame can touch: the live count plus a frame's
        creations (the count-sized step equals the full-shape one over
        them)."""
        return min(state.pack.shape[0], int(state.surfel_count) +
                   self.params.max_creations_per_frame)


def round_to_bfloat16(state: fu.SurfelState) -> None:
    """Round the map's float columns and slot distances to bfloat16 in
    place; the int32 bit columns (stamps) are kept."""
    pack = state.pack
    keep = pack[:, list(fu._INT_COLS)].clone()
    pack.copy_(pack.to(torch.bfloat16).to(torch.float32))
    pack[:, list(fu._INT_COLS)] = keep
    finite = torch.isfinite(state.nbr_dist)
    state.nbr_dist.copy_(torch.where(
        finite, state.nbr_dist.to(torch.bfloat16).to(torch.float32),
        state.nbr_dist))


def snapshot_rows(state: fu.SurfelState) -> tuple:
    """The meshing snapshot of the live rows as the mesher consumes it
    ((n, 3) smooth positions, (n,) squared radii, (n, 3) normals, (n,)
    int32 stamps) as host arrays."""
    n = int(state.surfel_count)
    smooth, rad, nrm, stamps, _ = fu.meshing_snapshot(state)
    return tuple(a[:n].cpu().numpy() for a in (smooth, rad, nrm, stamps))

