"""Demo image of the port: the full pipeline on a synthetic sequence, the
final mesh and its surfels rendered from an orbit viewpoint.

    python -m surfelmeshing_tpu_torch.tools.make_demo --out PATH
        [--device cuda|cpu]

Counterpart of tools/make_demo.py: 16 synthetic 160x120 frames fused on
`--device` (default cuda), meshed by the native mesher, rendered at
960x540 by the port's renderer on the same device and saved as a PNG at
PATH.  It never writes the JAX package's docs/demo.png.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..config import SurfelMeshingConfig
from ..io.synthetic import write_tum_dataset
from ..io.tum import read_tum_rgbd_dataset
from ..meshing import MeshingDriver
from ..ops.fusion import export_vertices
from ..pipeline import ReconstructionPipeline
from ..viewer.renderer import OrbitCamera, Renderer, save_png

RESERVED = Path(__file__).resolve().parents[2] / "docs" / "demo.png"


def make_demo(out: str, device) -> dict:
    """Fuse, mesh and render the demo into `out`; -> counts."""
    cfg = SurfelMeshingConfig(
        max_surfel_count=200_000, outlier_filtering_frame_count=2,
        depth_erosion_radius=1, depth_valid_region_radius=1000.0)
    mesher = MeshingDriver(cfg)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ds = write_tum_dataset(os.path.join(tmp, "ds"), num_frames=16,
                                   width=160, height=120)
            video = read_tum_rgbd_dataset(ds, "groundtruth.txt", 0.2)
            pipe = ReconstructionPipeline(cfg, video.depth_camera, device)
            for i in range(video.frame_count - 1):
                if pipe.process_frame(video, i) is not None and \
                        mesher.idle():
                    mesher.submit(*pipe.snapshot(), i)
        pipe.block_until_ready()
        mesher.drain()
        mesher.submit(*pipe.snapshot(), video.frame_count - 2)
        mesher.drain()
        tris = mesher.engine.get_triangles()
    finally:
        mesher.finish()

    positions, colors = export_vertices(pipe.state)
    count = pipe.surfel_count()
    positions, colors = positions[:count], colors[:count]
    renderer = Renderer(960, 540, background=(250, 250, 250),
                        device=pipe.device)
    cam = OrbitCamera(center=np.array([0.0, 0.2, 2.0]), radius=3.4,
                      yaw=0.3, pitch=-0.2, up=np.array([0.0, -1.0, 0.0]))
    img = renderer.render(
        cam.pose(), mesh_vertices=positions, mesh_colors=colors,
        mesh_triangles=torch.from_numpy(tris.astype(np.int64)).to(
            pipe.device),
        splat_points=positions, splat_colors=colors, splat_half_extent=1.0)
    save_png(out, img.cpu().numpy())
    return dict(surfels=count, triangles=len(tris))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="PNG path to write")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    if Path(args.out).resolve() == RESERVED:
        print(f"error: {RESERVED} is the JAX package's demo image",
              file=sys.stderr)
        return 2
    counts = make_demo(args.out, args.device)
    print(f"{counts['surfels']} surfels, {counts['triangles']} triangles; "
          f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
