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
    the tiled step equals the full-shape one when no tile is skipped."""
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
        max_creations_per_frame=s["max_creations_per_frame"])


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
        if settings["pyramid_level"] != 0:
            raise ValueError("the reference runs pyramid level 0 only")
        self.settings = settings
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

    def step(self, state: fu.SurfelState, i: int, n_eff: int
             ) -> fu.SurfelState:
        """Frame i fused into `state` over its first n_eff rows; the
        input's tensors are written in place, as the count-sized step
        does."""
        depth = self._depth(i)
        others = torch.stack([self._depth(i + o) for o in self._offsets()])
        d, nrm, rad = pp.preprocess_frame(
            depth, others, self._tensor(self._transforms(i)),
            **self.pp_kwargs)
        color = torch.from_numpy(np.ascontiguousarray(
            self.frames.color[i % self.frames.period].transpose(2, 0, 1))) \
            .to(self.device)
        pose = self._pose(i)
        t_gl = self._tensor(pose.matrix3x4())
        t_lg = self._tensor(pose.inverse().matrix3x4())
        out = fu.integrate_frame_bucketed(state, d, nrm, rad, color, t_gl,
                                          t_lg, i, self.params, int(n_eff))
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

