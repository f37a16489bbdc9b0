"""Shared synthetic-sequence setup for the port's bench tools (the
counterpart of tools/bench_configs_common.py of the JAX package)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..dispatch import start_readback
from ..io.synthetic import SyntheticRGBDSequence
from ..ops import preprocess as pp
from ..ops.fusion import FusionParams, SurfelState, integrate_frame


def parse_size(s: str) -> int:
    """'500k' -> 500000, '20m' -> 20000000, '-1' -> -1."""
    s = s.lower()
    mult = 1
    if s.endswith("k"):
        mult, s = 1000, s[:-1]
    elif s.endswith("m"):
        mult, s = 1_000_000, s[:-1]
    return int(float(s) * mult)


def peak_mib(device: torch.device):
    """Peak device memory allocated since the last reset, MiB; None on
    the CPU."""
    if device.type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(device) / 2**20, 1)


class BenchEnv:
    """Pre-rendered synthetic 640x480 sequence resident on an explicit
    device, plus the per-frame preprocess+fusion step (bench.py's frame
    step, called without the pipeline)."""

    W, H = 640, 480
    SCALE = 5000.0
    K = 8
    NUM_FRAMES = 40

    def __init__(self, device, trajectory: str = "arc"):
        self.device = resolve_device(device)
        seq = SyntheticRGBDSequence(num_frames=self.NUM_FRAMES, width=self.W,
                                    height=self.H, noise_sigma=0.002,
                                    trajectory=trajectory)
        self.seq = seq
        self.cam = seq.camera
        self.depths, self.colors = [], []
        for i in range(self.NUM_FRAMES):
            d, c = seq.depth_and_color(i)
            self.depths.append(
                torch.from_numpy(d.astype(np.int32)).to(self.device))
            self.colors.append(torch.from_numpy(
                np.ascontiguousarray(c.transpose(2, 0, 1))).to(self.device))
        self.pp_kwargs = dict(
            sigma_xy=3.0, sigma_value_factor=0.05, radius_factor=2.0,
            max_depth_u16=int(self.SCALE * 3.0),
            depth_valid_region_radius=333.0,
            tolerance=0.02, required_inliers=None, erosion_radius=2,
            observation_angle_threshold_deg=85.0, depth_scaling=self.SCALE,
            point_radius_extension_factor=1.5,
            point_radius_clamp_factor=float("inf"),
            fx=self.cam.fx, fy=self.cam.fy, cx=self.cam.cx, cy=self.cam.cy)
        self.lo, self.hi = self.K // 2, self.NUM_FRAMES - self.K // 2

    def make_params(self, budget: int = 0, tile: int = 4096) -> FusionParams:
        cam = self.cam
        return FusionParams(
            width=self.W, height=self.H, fx=cam.fx, fy=cam.fy, cx=cam.cx,
            cy=cam.cy, depth_scaling=self.SCALE, do_blending=True,
            regularization_iterations=1, active_surfel_budget=budget,
            tile_size=tile)

    def _offsets(self):
        return list(range(-self.K // 2, 0)) + list(range(1, self.K // 2 + 1))

    def transforms_for(self, i: int) -> torch.Tensor:
        """(K,3,4) other_T_reference of frame i's window, depth units."""
        ref = self.seq.poses[i].scaled_translation(self.SCALE)
        mats = [(ref.inverse() *
                 self.seq.poses[i + off].scaled_translation(self.SCALE))
                .inverse().matrix3x4() for off in self._offsets()]
        return torch.from_numpy(np.stack(mats).astype(np.float32)) \
            .to(self.device)

    def step(self, state: SurfelState, i: int,
             params: FusionParams) -> SurfelState:
        """Preprocess frame i and fuse it into `state`."""
        others = torch.stack([self.depths[i + off] for off in self._offsets()])
        d, normals, radius = pp.preprocess_frame(
            self.depths[i], others, self.transforms_for(i), **self.pp_kwargs)
        pose = self.seq.poses[i]
        t_gl, t_lg = (torch.from_numpy(m.astype(np.float32)).to(self.device)
                      for m in (pose.matrix3x4(), pose.inverse().matrix3x4()))
        return integrate_frame(state, d, normals, radius, self.colors[i],
                               t_gl, t_lg, i, params)


class AutoBudgetPolicy:
    """The pipeline's --active_surfel_budget -1 policy for standalone
    tools: lagged (surfel_count, active_tile_count) readbacks size the
    next frame's tiling budget to 2x the visible-set tile demand on a
    power-of-2 tile ladder (dispatch.DispatchPolicy.auto_budget).  A
    readback is a non-blocking copy into pinned memory, read once its CUDA
    event has fired (dispatch.start_readback); on the CPU it is read at
    once."""

    def __init__(self, cap, tile, max_creations, width, height):
        self.cap, self.tile = cap, tile
        c_floor = min(max_creations, width * height)
        self.floor_tiles = c_floor // tile + 2
        self.max_creations = max_creations
        self.lag_count = 0
        self.lag_tiles = 0
        self.pending = []
        self.budgets_used = set()

    def params_for_frame(self, params: FusionParams) -> FusionParams:
        while self.pending and (self.pending[0][1] is None or
                                self.pending[0][1].query()):
            host, _ = self.pending.pop(0)
            self.lag_count, self.lag_tiles = host.tolist()
        if self.lag_tiles > 0:
            want = 2 * self.lag_tiles
        else:
            want = -(-2 * max(self.lag_count + 2 * self.max_creations, 1)
                     // self.tile)
        tiles = 1 << (max(self.floor_tiles, want) - 1).bit_length()
        b = int(min(tiles * self.tile, self.cap))
        self.budgets_used.add(b)
        return dataclasses.replace(params, active_surfel_budget=b)

    def observe(self, state: SurfelState) -> None:
        self.pending.append(start_readback(torch.stack(
            [state.surfel_count, state.active_tile_count])))
