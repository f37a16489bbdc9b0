"""Deviation A/B matrix of the port across hostile scenes and trajectories.

Counterpart of surfelmeshing_tpu/eval/ab_matrix.py: every fusion mode of
FusionParams (the defaults, each reference-parity switch alone, all three)
fuses every scene x trajectory of io/synthetic.py (occlusion edges, thin
structures, creases, look-away revisits, forward scale drift) on one torch
device, and each cell reports the mean distance of the live smoothed
surfels to the true scene surface.  A default deviation is bounded per
geometry class by its distance from the all-exact mode.

    python -m surfelmeshing_tpu_torch.eval.ab_matrix --device cuda \
        [--width 320 --height 240 --frames 60 --capacity N]

prints the markdown table (per-cell progress on stderr).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..io.synthetic import SCENES, TRAJECTORIES, SyntheticRGBDSequence
from ..ops import preprocess as pp
from ..ops.fusion import (FusionParams, SurfelState, create_surfel_state,
                          integrate_frame, meshing_snapshot)

# The defaults against each reference-exact switch alone and all of them.
MODES = (
    ("tpu_defaults", {}),
    ("exact_reg", dict(symmetric_regularization=False)),
    ("exact_conflict", dict(exact_conflict_arbitration=True)),
    ("exact_neighbors", dict(fast_neighbor_update=False)),
    ("exact_all", dict(symmetric_regularization=False,
                       exact_conflict_arbitration=True,
                       fast_neighbor_update=False)),
)


def preprocess_synthetic_frame(seq: SyntheticRGBDSequence, i: int, device):
    """Frame i of a synthetic sequence preprocessed on `device` with its
    neighbors i - 1 and i + 1 as the outlier window -> integrate_frame's
    (depth, normals_xy, radius, color (3, H, W), global_T_local,
    local_T_global)."""
    cam = seq.camera
    scale = seq.depth_scaling
    depth, color = seq.depth_and_color(i)
    others = np.stack([seq.depth_and_color(i - 1)[0],
                       seq.depth_and_color(i + 1)[0]])
    ref = seq.poses[i].scaled_translation(scale)
    T = np.stack([
        ((ref.inverse() * seq.poses[j].scaled_translation(scale))
         .inverse().matrix3x4())
        for j in (i - 1, i + 1)]).astype(np.float32)

    def dev(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    d, normals, radius = pp.preprocess_frame(
        dev(depth, np.int32), dev(others, np.int32), dev(T),
        sigma_xy=3.0, sigma_value_factor=0.05, radius_factor=2.0,
        max_depth_u16=int(scale * 3.5),
        depth_valid_region_radius=max(cam.width, cam.height),
        tolerance=0.02, required_inliers=None, erosion_radius=1,
        observation_angle_threshold_deg=85.0, depth_scaling=scale,
        point_radius_extension_factor=1.5,
        point_radius_clamp_factor=np.inf,
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy)
    return (d, normals, radius, dev(color.transpose(2, 0, 1)),
            dev(seq.poses[i].matrix3x4(), np.float32),
            dev(seq.poses[i].inverse().matrix3x4(), np.float32))


def _preprocessed(seq: SyntheticRGBDSequence, i: int, device):
    """preprocess_synthetic_frame, once per sequence, frame and device:
    preprocessing does not depend on the mode."""
    cache = seq.__dict__.setdefault("_torch_pp_cache", {})
    key = (str(device), i)
    if key not in cache:
        cache[key] = preprocess_synthetic_frame(seq, i, device)
    return cache[key]


def run_fusion_sequence(
    params: FusionParams,
    capacity: int,
    frames: int = 8,
    width: int = 160,
    height: int = 120,
    scene: str = "default",
    trajectory: str = "arc",
    noise_sigma: float = 0.0,
    seq: Optional[SyntheticRGBDSequence] = None,
    device="cuda",
) -> Tuple[SurfelState, SyntheticRGBDSequence]:
    """Preprocess and fuse frames 1..frames of a synthetic sequence on
    `device` (the app's loop without meshing or I/O); -> (final state,
    sequence).  Pass `seq` to reuse one rendered and preprocessed sequence
    across modes."""
    device = resolve_device(device)
    if seq is None:
        seq = SyntheticRGBDSequence(num_frames=frames + 2, width=width,
                                    height=height, scene=scene,
                                    trajectory=trajectory,
                                    noise_sigma=noise_sigma)
    cam = seq.camera
    params = dataclasses.replace(
        params, width=width, height=height, fx=cam.fx, fy=cam.fy,
        cx=cam.cx, cy=cam.cy, depth_scaling=seq.depth_scaling)
    state = create_surfel_state(capacity, device)
    for i in range(1, frames + 1):
        state = integrate_frame(state, *_preprocessed(seq, i, device), i,
                                params)
    return state, seq


def scene_error_mm(state: SurfelState, seq: SyntheticRGBDSequence) -> float:
    """Mean exact distance (mm) of the live smoothed surfels to the true
    scene surface."""
    smooth, radius_sq, _, _, count = meshing_snapshot(state)
    count = int(count)
    pts = smooth[:count].cpu().numpy()
    alive = radius_sq[:count].cpu().numpy() >= 0
    return float(seq.surface_distance(pts[alive]).mean() * 1000.0)


def deviation_matrix(
    frames: int = 8,
    width: int = 160,
    height: int = 120,
    capacity: int = 65536,
    scenes=None,
    trajectories=None,
    noise_sigma: float = 0.0,
    base_params: Optional[FusionParams] = None,
    modes=None,
    device="cuda",
) -> Dict[str, Dict[str, float]]:
    """-> {"scene/trajectory": {mode: error_mm}} for every combination.
    Raises when a run drops creations at capacity: a clamped map would
    bias the deviation bound."""
    if base_params is None:
        base_params = FusionParams(
            width=width, height=height, fx=1.0, fy=1.0, cx=0.0, cy=0.0,
            depth_scaling=5000.0, do_blending=True,
            regularization_iterations=1)
    out: Dict[str, Dict[str, float]] = {}
    for scene in (scenes or SCENES):
        for traj in (trajectories or TRAJECTORIES):
            row: Dict[str, float] = {}
            seq = SyntheticRGBDSequence(
                num_frames=frames + 2, width=width, height=height,
                scene=scene, trajectory=traj, noise_sigma=noise_sigma)
            for mode, kw in (modes or MODES):
                t0 = time.perf_counter()
                state, seq = run_fusion_sequence(
                    dataclasses.replace(base_params, **kw), capacity,
                    frames=frames, width=width, height=height, seq=seq,
                    device=device)
                overflow = int(state.overflow_count)
                if overflow > 0:
                    raise RuntimeError(
                        f"{scene}/{traj}/{mode}: surfel overflow "
                        f"({overflow}) — raise --capacity; a clamped run "
                        "would bias the deviation bound")
                row[mode] = scene_error_mm(state, seq)
                print(f"ab_matrix: {scene}/{traj}/{mode} = "
                      f"{row[mode]:.4f} mm  surfels="
                      f"{int(state.surfel_count)}  "
                      f"({time.perf_counter() - t0:.1f}s)",
                      file=sys.stderr, flush=True)
            out[f"{scene}/{traj}"] = row
    return out


def max_rel_deviation(row: Dict[str, float]) -> float:
    """Largest |mode - exact_all| / exact_all of one cell."""
    exact = row["exact_all"]
    return max(abs(err - exact) for err in row.values()) / max(exact, 1e-9)


def format_markdown(matrix: Dict[str, Dict[str, float]]) -> str:
    names = [m for m, _ in MODES]
    lines = ["| scene/trajectory | " + " | ".join(names) +
             " | max rel dev |",
             "|---|" + "---|" * (len(names) + 1)]
    for key, row in matrix.items():
        lines.append(
            f"| {key} | " +
            " | ".join(f"{row[m]:.4f}" for m in names) +
            f" | {100.0 * max_rel_deviation(row):.2f}% |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--height", type=int, default=120)
    ap.add_argument("--capacity", type=int, default=65536)
    ap.add_argument("--noise_sigma", type=float, default=0.0)
    ap.add_argument("--scenes", type=str, default=None,
                    help="comma-separated scene subset (default: all)")
    ap.add_argument("--trajectories", type=str, default=None,
                    help="comma-separated trajectory subset (default: all)")
    args = ap.parse_args(argv)
    matrix = deviation_matrix(
        frames=args.frames, width=args.width, height=args.height,
        capacity=args.capacity, noise_sigma=args.noise_sigma,
        scenes=args.scenes.split(",") if args.scenes else None,
        trajectories=(args.trajectories.split(",")
                      if args.trajectories else None),
        device=args.device)
    print(format_markdown(matrix))
    return 0


if __name__ == "__main__":
    sys.exit(main())
