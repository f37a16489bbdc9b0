"""Batched multi-sequence reconstruction (BASELINE config 5).

Counterpart of surfelmeshing_tpu/app/multi_sequence.py: S TUM sequences
fused in lockstep, one surfel map each, on one explicit torch device
(parallel/batch.py).  The sequences share nothing; every lockstep frame
preprocesses and fuses each sequence in turn, while a host thread reads
the next frame's images.  The run stops at the shortest sequence.  Each
sequence's point cloud (smoothed positions of its live surfels) is
written as <output_dir>/<dataset folder name>.ply, equal byte for byte to
the cloud of that dataset run alone.

Usage:
    python -m surfelmeshing_tpu_torch.app.multi_sequence \
        <dataset_dir_1> ... <dataset_dir_S> --trajectory groundtruth.txt \
        --max_surfel_count 500000 --output_dir out/ [--device cuda|cpu]

`--device` defaults to cuda and fails without a GPU.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..config import SurfelMeshingConfig
from ..io.mesh_io import write_ply
from ..io.tum import RGBDVideo, read_tum_rgbd_dataset
from ..ops.fusion import RAD, SX, SZ
from ..parallel.batch import (create_batched_state, make_batched_preprocess,
                              make_batched_step)
from ..pipeline import fusion_params_from_config, preprocess_kwargs

logger = logging.getLogger("surfelmeshing_tpu_torch.multi")

LOG_INTERVAL = 50


class LockstepBatch:
    """S videos of one image size fused in lockstep with `config`'s
    settings, each into its own surfel map on `device` with its own
    camera's intrinsics (the JAX app applies the first sequence's to
    every sequence)."""

    def __init__(self, videos: Sequence[RGBDVideo],
                 config: SurfelMeshingConfig, device):
        cams = [v.depth_camera for v in videos]
        if len({(c.width, c.height) for c in cams}) != 1:
            raise ValueError("all sequences must share the image size")
        self.videos = list(videos)
        self.config = config
        self.device = resolve_device(device)
        self.params = [fusion_params_from_config(config, c) for c in cams]
        self.states = create_batched_state(len(videos),
                                           config.max_surfel_count,
                                           self.device)
        self.step = make_batched_step(self.params, self.device)
        self.preprocess = make_batched_preprocess(
            [preprocess_kwargs(config, c) for c in cams], self.device)
        half = config.outlier_filtering_frame_count // 2
        self.offsets = list(range(-half, 0)) + list(range(1, half + 1))

    def frame_range(self, max_frames: int = 0) -> range:
        """The lockstep frames with a full outlier window in every
        sequence, the first `max_frames` of them when it is set."""
        half = self.config.outlier_filtering_frame_count // 2
        end = min(v.frame_count for v in self.videos) - half
        if max_frames:
            end = min(end, max_frames + half)
        return range(half, end)

    def assemble(self, i: int):
        """Host I/O of lockstep frame i (numpy only): the (S, ...) stacks
        of depth, the outlier window's other depths and other_T_reference
        transforms (depth-unit space, main.cc:1038-1058), plane-major
        color and the two poses.  Retires the images no later frame
        reads."""
        cfg = self.config
        out = [[] for _ in range(6)]
        for v in self.videos:
            ref = v.depth_frames[i].global_T_frame \
                .scaled_translation(cfg.depth_scaling)
            pose = v.depth_frames[i].global_T_frame
            color = np.asarray(v.color_frames[i].get_image())[..., :3]
            for stack, value in zip(out, (
                    np.asarray(v.depth_frames[i].get_image()),
                    np.stack([np.asarray(v.depth_frames[i + o].get_image())
                              for o in self.offsets]),
                    np.stack([(ref.inverse() * v.depth_frames[i + o]
                               .global_T_frame
                               .scaled_translation(cfg.depth_scaling))
                              .inverse().matrix3x4()
                              for o in self.offsets]),
                    color.transpose(2, 0, 1),
                    pose.matrix3x4(), pose.inverse().matrix3x4())):
                stack.append(value)
            v.depth_frames[i - cfg.outlier_filtering_frame_count // 2] \
                .clear_image()
            v.color_frames[i].clear_image()
        return tuple(np.ascontiguousarray(np.stack(s), dtype) for s, dtype in
                     zip(out, (np.int32, np.int32, np.float32, np.uint8,
                               np.float32, np.float32)))

    def frame_inputs(self, stacks):
        """integrate_frame's inputs with a leading sequence axis, on the
        device, from assemble()'s stacks: (depth, normals_xy, radius_sq,
        color, T_gl, T_lg)."""
        depth, others, transforms, color, t_gl, t_lg = (
            torch.from_numpy(a) for a in stacks)
        d, nrm, rad = self.preprocess(depth, others, transforms)
        return (d, nrm, rad) + tuple(t.to(self.device)
                                     for t in (color, t_gl, t_lg))

    def run(self, frames: Sequence[int]) -> Optional[torch.Tensor]:
        """Fuse `frames` in order, reading the next frame's images on a
        host thread while the current one is fused; -> the last frame's
        surfel count total on the device (None for no frames)."""
        total = None
        if not frames:
            return total
        with ThreadPoolExecutor(max_workers=1) as io_pool:
            pending = io_pool.submit(self.assemble, frames[0])
            for n, i in enumerate(frames):
                stacks = pending.result()
                if n + 1 < len(frames):
                    pending = io_pool.submit(self.assemble, frames[n + 1])
                self.states, total = self.step(
                    self.states, *self.frame_inputs(stacks), i)
                if i % LOG_INTERVAL == 0:
                    logger.info("frame %d: %d surfels total", i, int(total))
        return total

    def write_point_clouds(self, names: Sequence[str],
                           output_dir: str) -> np.ndarray:
        """<output_dir>/<name>.ply per sequence; -> the surfel counts."""
        os.makedirs(output_dir, exist_ok=True)
        counts = []
        for state, name in zip(self.states, names):
            count = int(state.surfel_count)
            pack = state.pack[:count].cpu().numpy()
            alive = pack[:, RAD] >= 0
            out = os.path.join(output_dir, f"{name}.ply")
            write_ply(out, pack[alive][:, SX:SZ + 1])
            logger.info("wrote %s (%d points)", out, int(alive.sum()))
            counts.append(count)
        return np.asarray(counts, np.int32)


def run_batched(dataset_dirs: Sequence[str], trajectory_filename: str,
                max_surfel_count: int = 500_000,
                outlier_filtering_frame_count: int = 2,
                max_frames: int = 0, output_dir: str = ".",
                device="cuda") -> np.ndarray:
    """Fuse the TUM datasets in lockstep and write one PLY per dataset;
    -> the final surfel count of each sequence."""
    config = SurfelMeshingConfig(
        max_surfel_count=max_surfel_count,
        outlier_filtering_frame_count=outlier_filtering_frame_count)
    videos = [read_tum_rgbd_dataset(d, trajectory_filename,
                                    config.max_pose_interpolation_time_extent)
              for d in dataset_dirs]
    batch = LockstepBatch(videos, config, device)
    logger.info("batched reconstruction: %d sequences on %s", len(videos),
                batch.device)
    frames = batch.frame_range(max_frames)
    t0 = time.perf_counter()
    batch.run(frames)
    if batch.device.type == "cuda":
        torch.cuda.synchronize(batch.device)
    elapsed = time.perf_counter() - t0
    logger.info("%d sequences x %d frames in %.1fs (%.2f seq-frames/s)",
                len(videos), len(frames), elapsed,
                len(videos) * len(frames) / max(elapsed, 1e-9))
    names = [os.path.basename(os.path.normpath(d)) or f"seq{s}"
             for s, d in enumerate(dataset_dirs)]
    return batch.write_point_clouds(names, output_dir)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname).1s %(message)s")
    p = argparse.ArgumentParser()
    p.add_argument("datasets", nargs="+")
    p.add_argument("--trajectory", default="groundtruth.txt")
    p.add_argument("--max_surfel_count", type=int, default=500_000)
    p.add_argument("--outlier_filtering_frame_count", type=int, default=2)
    p.add_argument("--max_frames", type=int, default=0)
    p.add_argument("--output_dir", default=".")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run_batched(args.datasets, args.trajectory, args.max_surfel_count,
                args.outlier_filtering_frame_count, args.max_frames,
                args.output_dir, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
