"""TUM RGB-D dataset loader.

Replaces ReadTUMRGBDDatasetAssociatedAndCalibrated
(libvis/src/libvis/rgbd_video_io_tum_dataset.h:137-251):

- reads `calibration.txt` ("fx fy cx cy" on one line),
- reads the trajectory file ("timestamp tx ty tz qx qy qz qw" lines, '#'
  comments), slerp-interpolating a pose for every associated frame timestamp
  and dropping frames whose bracketing trajectory samples are further apart
  than max_interpolation_time_extent,
- reads `associated.txt` ("rgb_ts rgb_file depth_ts depth_file" lines),
- applies the +0.5 pixel-center -> pixel-corner convention shift to cx/cy
  (rgbd_video_io_tum_dataset.h:243-244).

Images are loaded lazily per frame with a small cache, mirroring the
reference's ImageCache (libvis/src/libvis/image_cache.h:103-148).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..utils.camera import PinholeCamera
from ..utils.se3 import SE3, interpolate_pose


def _load_image(path: str) -> np.ndarray:
    from PIL import Image as PILImage
    with PILImage.open(path) as im:
        arr = np.asarray(im)
    return arr


class ImageFrame:
    """Lazy-loading image frame with pose + timestamp (image_frame.h:41-120)."""

    __slots__ = ("path", "timestamp", "global_T_frame", "_image")

    def __init__(self, path: str, timestamp: float, global_T_frame: SE3):
        self.path = path
        self.timestamp = timestamp
        self.global_T_frame = global_T_frame
        self._image: Optional[np.ndarray] = None

    def get_image(self) -> np.ndarray:
        if self._image is None:
            self._image = _load_image(self.path)
        return self._image

    def clear_image(self) -> None:
        """Frame retirement (ClearImageAndDerivedData; main.cc:1656-1667)."""
        self._image = None

    @property
    def frame_T_global(self) -> SE3:
        return self.global_T_frame.inverse()


class RGBDVideo:
    """Paired color/depth frames + shared camera (rgbd_video.h:39-71)."""

    def __init__(self, color_frames: List[ImageFrame],
                 depth_frames: List[ImageFrame],
                 color_camera: PinholeCamera,
                 depth_camera: PinholeCamera):
        assert len(color_frames) == len(depth_frames)
        self.color_frames = color_frames
        self.depth_frames = depth_frames
        self.color_camera = color_camera
        self.depth_camera = depth_camera

    @property
    def frame_count(self) -> int:
        return len(self.color_frames)


def read_tum_trajectory(path: str):
    """-> (timestamps ndarray, [SE3 global_T_frame]); TUM format per line:
    "timestamp tx ty tz qx qy qz qw" (rgbd_video_io_tum_dataset.h:84-128)."""
    timestamps = []
    poses = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 8:
                raise ValueError(f"Cannot read pose line: {line!r}")
            ts = float(parts[0])
            tx, ty, tz, qx, qy, qz, qw = (float(v) for v in parts[1:8])
            timestamps.append(ts)
            poses.append(SE3([qx, qy, qz, qw], [tx, ty, tz]))
    return np.asarray(timestamps), poses


def read_tum_rgbd_dataset(dataset_folder_path: str,
                          trajectory_filename: Optional[str],
                          max_interpolation_time_extent: float = np.inf,
                          ) -> RGBDVideo:
    calibration_path = os.path.join(dataset_folder_path, "calibration.txt")
    with open(calibration_path, "r") as f:
        parts = f.readline().split()
    if len(parts) < 4:
        raise ValueError(f"Cannot read calibration from {calibration_path}")
    fx, fy, cx, cy = (float(v) for v in parts[:4])

    pose_timestamps = None
    poses = None
    if trajectory_filename:
        trajectory_path = os.path.join(dataset_folder_path, trajectory_filename)
        pose_timestamps, poses = read_tum_trajectory(trajectory_path)

    color_frames: List[ImageFrame] = []
    depth_frames: List[ImageFrame] = []
    width = height = 0

    associated_path = os.path.join(dataset_folder_path, "associated.txt")
    with open(associated_path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 4:
                raise ValueError(f"Cannot read association line: {line!r}")
            rgb_ts_str, rgb_file, depth_ts_str, depth_file = parts[:4]
            rgb_ts = float(rgb_ts_str)
            depth_ts = float(depth_ts_str)

            rgb_pose = SE3.identity()
            depth_pose = SE3.identity()
            if poses:
                rgb_pose = interpolate_pose(
                    rgb_ts, pose_timestamps, poses,
                    max_interpolation_time_extent)
                if rgb_pose is None:
                    continue
                depth_pose = interpolate_pose(
                    depth_ts, pose_timestamps, poses,
                    max_interpolation_time_extent)
                if depth_pose is None:
                    continue

            color_frames.append(ImageFrame(
                os.path.join(dataset_folder_path, rgb_file), rgb_ts, rgb_pose))
            depth_frames.append(ImageFrame(
                os.path.join(dataset_folder_path, depth_file), depth_ts,
                depth_pose))

            if width == 0:
                img = color_frames[-1].get_image()
                height, width = img.shape[:2]
                color_frames[-1].clear_image()

    # +0.5: stored principal point uses the pixel-corner convention
    # (rgbd_video_io_tum_dataset.h:243-244).
    camera = PinholeCamera(width, height, fx, fy, cx + 0.5, cy + 0.5)
    return RGBDVideo(color_frames, depth_frames, camera, camera)
