"""Mesh-accuracy evaluation app of the port (ICL-NUIM protocol).

Counterpart of surfelmeshing_tpu/app/evaluate.py: reconstructs a
TUM/ICL-NUIM-format sequence with the port's pipeline on one torch device
and evaluates the surfel cloud against a ground-truth model (OBJ) or point
cloud (PLY) with the host-side metric of eval/mesh_accuracy.py (the
port's copy of the JAX package's):

    python -m surfelmeshing_tpu_torch.app.evaluate <dataset_dir> \
        <trajectory> --ground_truth model.obj [--device cuda] \
        [--max_frames N] [--tolerance 0.01]

Prints mean/median/RMS accuracy and completeness as JSON.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import numpy as np

from ..config import SurfelMeshingConfig
from ..eval.mesh_accuracy import (AccuracyResult, evaluate_accuracy,
                                  load_obj_vertices_triangles,
                                  sample_mesh_surface)
from ..io.mesh_io import read_ply
from ..io.tum import read_tum_rgbd_dataset
from ..pipeline import ReconstructionPipeline

logger = logging.getLogger("surfelmeshing_tpu_torch.eval")


def evaluate_sequence(dataset_dir: str, trajectory: str, ground_truth: str,
                      max_frames: int = 0, tolerance: float = 0.01,
                      max_surfel_count: int = 2_000_000,
                      outlier_filtering_frame_count: int = 2,
                      pyramid_level: int = 0,
                      device="cuda") -> AccuracyResult:
    video = read_tum_rgbd_dataset(dataset_dir, trajectory, 0.05)
    cfg = SurfelMeshingConfig(
        max_surfel_count=max_surfel_count,
        outlier_filtering_frame_count=outlier_filtering_frame_count,
        pyramid_level=pyramid_level)
    pipe = ReconstructionPipeline(cfg, video.depth_camera, device)

    end = video.frame_count
    if max_frames:
        end = min(end, max_frames)
    for i in range(end):
        pipe.process_frame(video, i)
    pipe.block_until_ready()
    logger.info("reconstructed %d surfels", pipe.surfel_count())
    rec, _ = pipe.export_vertices()

    if ground_truth.endswith(".obj"):
        v, t = load_obj_vertices_triangles(ground_truth)
        gt = sample_mesh_surface(v, t) if len(t) else v
    else:
        r = read_ply(ground_truth)
        gt = np.stack([r["x"], r["y"], r["z"]], axis=1)
    return evaluate_accuracy(rec, gt, completeness_tolerance=tolerance)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname).1s %(message)s")
    p = argparse.ArgumentParser()
    p.add_argument("dataset_dir")
    p.add_argument("trajectory")
    p.add_argument("--ground_truth", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("--max_frames", type=int, default=0)
    p.add_argument("--tolerance", type=float, default=0.01)
    p.add_argument("--max_surfel_count", type=int, default=2_000_000)
    p.add_argument("--outlier_filtering_frame_count", type=int, default=2)
    p.add_argument("--pyramid_level", type=int, default=0)
    args = p.parse_args(argv)
    result = evaluate_sequence(
        args.dataset_dir, args.trajectory, args.ground_truth,
        args.max_frames, args.tolerance, args.max_surfel_count,
        args.outlier_filtering_frame_count, args.pyramid_level, args.device)
    print(json.dumps(result.as_dict()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
