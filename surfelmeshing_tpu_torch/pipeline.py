"""Per-frame reconstruction pipeline on one explicit torch device.

Counterpart of surfelmeshing_tpu/pipeline.py's per-frame step: keeps the
resident window of depth frames for outlier filtering, runs preprocessing
and fusion on the device, and exports results.  The JAX package's dispatch
machinery (shape buckets, chunked scans, deferral, precompiles) has no
counterpart: torch runs each frame eagerly, and the math is the same, so
config.frame_chunk, use_shape_buckets and the adaptive bound are ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from surfelmeshing_tpu.config import SurfelMeshingConfig
from surfelmeshing_tpu.io.tum import RGBDVideo
from surfelmeshing_tpu.utils.camera import PinholeCamera

from . import resolve_device
from .ops import preprocess as pp
from .ops.fusion import (RAD, FusionParams, SurfelState, create_surfel_state,
                         export_vertices, integrate_frame, normals,
                         smooth_positions, update_stamps)


@dataclasses.dataclass
class FrameResult:
    frame_index: int
    surfel_count: int
    merge_count: int


def fusion_params_from_config(config: SurfelMeshingConfig,
                              camera: PinholeCamera) -> FusionParams:
    return FusionParams(
        width=camera.width, height=camera.height,
        fx=camera.fx, fy=camera.fy, cx=camera.cx, cy=camera.cy,
        depth_scaling=config.depth_scaling,
        sensor_noise_factor=config.sensor_noise_factor,
        max_surfel_confidence=config.max_surfel_confidence,
        normal_compatibility_threshold_deg=(
            config.normal_compatibility_threshold_deg),
        regularizer_weight=config.regularizer_weight,
        regularization_frame_window_size=(
            config.regularization_frame_window_size),
        do_blending=config.do_blending,
        measurement_blending_radius=config.measurement_blending_radius,
        regularization_iterations=(
            config.regularization_iterations_per_integration_iteration),
        radius_factor_for_regularization_neighbors=(
            config.radius_factor_for_regularization_neighbors),
        surfel_integration_active_window_size=(
            config.surfel_integration_active_window_size),
        max_creations_per_frame=config.max_creations_per_frame,
    )


class ReconstructionPipeline:
    """Depth preprocessing + surfel fusion over an RGB-D stream."""

    def __init__(self, config: SurfelMeshingConfig, camera: PinholeCamera,
                 device):
        config.validate()
        for name, value in (
                ("pyramid_level", config.pyramid_level),
                ("median_filter_and_densify_iterations",
                 config.median_filter_and_densify_iterations),
                ("active_surfel_budget", config.active_surfel_budget)):
            if value:
                raise NotImplementedError(f"{name}={value} is not ported yet")
        self.config = config
        self.camera = camera
        self.device = resolve_device(device)
        self.fusion_params = fusion_params_from_config(config, camera)
        self.state: SurfelState = create_surfel_state(
            config.max_surfel_count, self.device)
        # Resident depth-frame window keyed by frame index, mirroring
        # frame_index_to_depth_buffer (main.cc:904-968).
        self._depth_buffers: Dict[int, torch.Tensor] = {}

    # -- frame window management -------------------------------------------

    def _upload_depth(self, video: RGBDVideo, frame_index: int) -> None:
        if frame_index in self._depth_buffers or \
           frame_index >= video.frame_count:
            return
        depth = np.asarray(video.depth_frames[frame_index].get_image())
        self._depth_buffers[frame_index] = torch.from_numpy(
            depth.astype(np.int32)).to(self.device)

    def _retire_depth(self, frame_index: int) -> None:
        """Frame retirement (main.cc:1656-1667)."""
        self._depth_buffers.pop(frame_index, None)

    # -- per-frame step -----------------------------------------------------

    def process_frame(self, video: RGBDVideo, frame_index: int,
                      taps: Optional[dict] = None) -> Optional[FrameResult]:
        """Preprocess and fuse one frame; None for frames lacking a full
        outlier window (main.cc:986-992).  `taps` is passed to
        integrate_frame."""
        cfg = self.config
        half_window = cfg.outlier_filtering_frame_count // 2
        for idx in range(max(0, frame_index - half_window),
                         min(video.frame_count,
                             frame_index + half_window + 2)):
            self._upload_depth(video, idx)
        if frame_index < cfg.start_frame + half_window or \
           frame_index >= video.frame_count - half_window:
            return None

        depth, others, transforms = self._frame_window(video, frame_index)
        d, nrm, rad = pp.preprocess_frame(
            depth, torch.stack(others), self._to_device(transforms),
            **self._pp_kwargs())
        color = torch.from_numpy(self._frame_color(video, frame_index)) \
            .to(self.device)
        t_gl, t_lg = self._frame_pose(video, frame_index)
        self.state = integrate_frame(
            self.state, d, nrm, rad, color, self._to_device(t_gl),
            self._to_device(t_lg), frame_index, self.fusion_params, taps)

        self._retire_depth(frame_index - half_window)
        video.color_frames[frame_index].clear_image()
        video.depth_frames[frame_index].clear_image()
        return FrameResult(frame_index=frame_index,
                           surfel_count=-1,  # fetched lazily: a host sync
                           merge_count=-1)

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array, np.float32)) \
            .to(self.device)

    def _frame_window(self, video: RGBDVideo, frame_index: int):
        """One frame's resident outlier-filtering window: (reference depth,
        [K other depths], (K,3,4) other_T_reference in depth-unit space —
        pose translations scaled by depth_scaling, main.cc:1038-1058)."""
        cfg = self.config
        half_window = cfg.outlier_filtering_frame_count // 2
        ref_pose_scaled = video.depth_frames[frame_index].global_T_frame \
            .scaled_translation(cfg.depth_scaling)
        others = []
        transforms = []
        for offset in list(range(-half_window, 0)) + \
                list(range(1, half_window + 1)):
            other_index = frame_index + offset
            others.append(self._depth_buffers[other_index])
            other_pose_scaled = video.depth_frames[other_index] \
                .global_T_frame.scaled_translation(cfg.depth_scaling)
            transforms.append(
                (ref_pose_scaled.inverse() * other_pose_scaled)
                .inverse().matrix3x4())
        return (self._depth_buffers[frame_index], others,
                np.stack(transforms).astype(np.float32))

    def _frame_color(self, video: RGBDVideo, frame_index: int) -> np.ndarray:
        """This frame's color image as plane-major (3, H, W) u8."""
        color = np.asarray(video.color_frames[frame_index].get_image())
        if color.ndim == 2:
            color = np.stack([color] * 3, axis=-1)
        color = color[..., :3].astype(np.uint8)
        return np.ascontiguousarray(color.transpose(2, 0, 1))

    def _frame_pose(self, video: RGBDVideo, frame_index: int):
        """(global_T_local, local_T_global) 3x4 f32 for the frame."""
        pose = video.depth_frames[frame_index].global_T_frame
        return (pose.matrix3x4().astype(np.float32),
                pose.inverse().matrix3x4().astype(np.float32))

    def _required_inliers(self):
        cfg = self.config
        required = cfg.outlier_filtering_required_inliers
        if required in (cfg.outlier_filtering_frame_count, -1):
            return None   # the all-inlier kernel variant
        return required

    def _pp_kwargs(self) -> dict:
        """preprocess_frame keyword arguments from the config."""
        cfg, cam = self.config, self.camera
        return dict(
            sigma_xy=cfg.bilateral_filter_sigma_xy,
            sigma_value_factor=cfg.bilateral_filter_sigma_depth_factor,
            radius_factor=cfg.bilateral_filter_radius_factor,
            max_depth_u16=int(cfg.depth_scaling * cfg.max_depth),
            depth_valid_region_radius=cfg.depth_valid_region_radius,
            tolerance=cfg.outlier_filtering_depth_tolerance_factor,
            required_inliers=self._required_inliers(),
            erosion_radius=cfg.depth_erosion_radius,
            observation_angle_threshold_deg=(
                cfg.observation_angle_threshold_deg),
            depth_scaling=cfg.depth_scaling,
            point_radius_extension_factor=cfg.point_radius_extension_factor,
            point_radius_clamp_factor=cfg.point_radius_clamp_factor,
            fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy)

    # -- outputs (each reads the device: a host synchronisation) ------------

    def surfel_count(self) -> int:
        return int(self.state.surfel_count)

    def snapshot(self):
        """SoA snapshot of the live rows for the meshing engine
        (TransferAllToCPU analog, cuda_surfel_reconstruction.cc:339-359):
        (smooth (n,3), radius_sq (n,), normal (n,3), stamps (n,), n)."""
        count = self.surfel_count()
        s = self.state
        return (smooth_positions(s)[:count].cpu().numpy(),
                s.pack[:count, RAD].cpu().numpy(),
                normals(s)[:count].cpu().numpy(),
                update_stamps(s)[:count].cpu().numpy(), count)

    def export_vertices(self):
        """Live rows of export_vertices: smoothed positions (NaN for merged
        surfels) and u8 colors, as numpy arrays."""
        count = self.surfel_count()
        pos, col = export_vertices(self.state)
        return pos[:count].cpu().numpy(), col[:count].cpu().numpy()
