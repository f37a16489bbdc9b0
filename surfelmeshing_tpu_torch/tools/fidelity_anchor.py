"""Fidelity anchor of the port: its fusion against the golden oracle.

    python -m surfelmeshing_tpu_torch.tools.fidelity_anchor [--device cuda]
        [--frames 50] [--width 160] [--height 120] [--capacity 200000]

Counterpart of tools/fidelity_anchor.py.  No output of the CUDA reference
exists here, so the golden NumPy fusion oracle (tests/golden_fusion.py, an
independent scalar re-implementation of the reference kernels' semantics,
loaded by path) stands in for it.  The port fuses a synthetic sequence on
the device; the oracle fuses the same preprocessed inputs on the host; the
native engine meshes both snapshots.  The metric is the mean distance from
points sampled on the port's mesh to the oracle's mesh, beside the
direct surfel-position deltas.  Prints one JSON line with the JAX tool's
keys plus "device".

The oracle's one import of the JAX package (the pack column map) is given
stand-ins for its whole dotted chain, backed by the port's fusion module
(make_oracle): no module of the JAX package is loaded.
"""

from __future__ import annotations

import argparse
import builtins
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

import numpy as np

from .. import resolve_device
from ..eval.ab_matrix import preprocess_synthetic_frame
from ..eval.mesh_accuracy import point_to_mesh_distance, sample_mesh_surface
from ..io.synthetic import SyntheticRGBDSequence
from ..meshing.engine import MeshingEngine
from ..ops import fusion as F

ORACLE_PATH = Path(__file__).resolve().parents[2] / "tests" / \
    "golden_fusion.py"


def _oracle_import(name, globals=None, locals=None, fromlist=(), level=0):
    """The oracle's `__import__`: its one import of the JAX package,
    `from surfelmeshing_tpu.ops import fusion` (for the pack column map),
    gets a stand-in for the dotted chain whose `fusion` is the port's
    fusion module (the same column map); every other import is the
    ordinary one."""
    if fromlist is not None and tuple(fromlist) == ("fusion",):
        return types.SimpleNamespace(fusion=F)
    return builtins.__import__(name, globals, locals, fromlist, level)


def make_oracle(state: F.SurfelState):
    """The golden oracle (tests/golden_fusion.py's Oracle) holding a host
    copy of `state`.  The oracle module runs with its own `__import__`
    (_oracle_import), so it reaches the column map through a stand-in for
    `surfelmeshing_tpu.ops`: no `surfelmeshing_tpu` module or package is
    imported or enters sys.modules, and the oracle runs without JAX."""
    spec = importlib.util.spec_from_file_location("golden_fusion",
                                                  ORACLE_PATH)
    module = importlib.util.module_from_spec(spec)
    module.__builtins__ = dict(vars(builtins), __import__=_oracle_import)
    spec.loader.exec_module(module)
    host = F.state_to_numpy(state)
    # The oracle keeps neighbors surfel-major (N, 4).
    return module.Oracle(host["pack"], host["neighbors"].T,
                         int(host["surfel_count"]),
                         nbr_dist=host["nbr_dist"].T)


def build_mesh(positions, radii_sq, normals, stamps, count):
    """Native advancing-front mesh of a surfel snapshot -> (verts, tris)."""
    eng = MeshingEngine()
    eng.integrate(0, positions[:count], radii_sq[:count], normals[:count],
                  stamps[:count])
    eng.check_remeshing()
    eng.triangulate()
    return positions[:count].copy(), eng.get_triangles()


def fuse_oracle(inputs, capacity: int, params: F.FusionParams,
                log: bool = False):
    """The oracle over host copies of the preprocessed frames 1, 2, ...
    (numpy tuples of integrate_frame's inputs); -> (pack, surfel count).
    A module-level function, so a worker process can run it."""
    oracle = make_oracle(F.create_surfel_state(capacity, "cpu"))
    t0 = time.perf_counter()
    for i, frame in enumerate(inputs, 1):
        oracle.run_frame(*frame, i, params)
        if log and i % 10 == 0:
            print(f"oracle: frame {i}, {oracle.count} surfels, "
                  f"{time.perf_counter() - t0:.0f} s", file=sys.stderr,
                  flush=True)
    return oracle.pack, oracle.count


def start_anchor(frames: int = 50, width: int = 160, height: int = 120,
                 capacity: int = 200_000, scene: str = "default",
                 trajectory: str = "arc", device="cuda", pool=None,
                 log: bool = False) -> dict:
    """Preprocess the sequence on `device`, start the oracle on the host
    copies (in `pool`, a multiprocessing pool, or here and now when None)
    and fuse the same inputs with the port on `device`; finish_anchor
    completes the record."""
    device = resolve_device(device)
    t_start = time.time()
    seq = SyntheticRGBDSequence(num_frames=frames + 2, width=width,
                                height=height, scene=scene,
                                trajectory=trajectory)
    cam = seq.camera
    params = F.FusionParams(
        width=width, height=height, fx=cam.fx, fy=cam.fy, cx=cam.cx,
        cy=cam.cy, depth_scaling=seq.depth_scaling, do_blending=True,
        regularization_iterations=1)
    inputs = [preprocess_synthetic_frame(seq, i, device)
              for i in range(1, frames + 1)]
    host = [tuple(t.cpu().numpy() for t in frame) for frame in inputs]
    args = (host, capacity, params, log)
    oracle = pool.apply_async(fuse_oracle, args) if pool is not None \
        else fuse_oracle(*args)
    state = F.create_surfel_state(capacity, device)
    for i, frame in enumerate(inputs, 1):
        state = F.integrate_frame(state, *frame, i, params)
    return dict(seq=seq, state=state, oracle=oracle, t_start=t_start,
                device=device, frames=frames, scene=scene,
                trajectory=trajectory)


def finish_anchor(run: dict) -> dict:
    """Wait for the oracle, mesh both maps and measure: the JSON record."""
    oracle = run["oracle"]
    pack, o_count = oracle if isinstance(oracle, tuple) else oracle.get()
    seq, state = run["seq"], run["state"]
    smooth, rad, nrm, stamps, count = (
        a.cpu().numpy() for a in F.meshing_snapshot(state))
    count = int(count)
    v_port, t_port = build_mesh(smooth, rad, nrm, stamps.astype(np.uint32),
                                count)
    o_smooth = np.ascontiguousarray(pack[:, F.SX:F.SZ + 1])
    o_rad = np.ascontiguousarray(pack[:, F.RAD])
    v_ref, t_ref = build_mesh(
        o_smooth, o_rad, np.ascontiguousarray(pack[:, F.NX:F.NZ + 1]),
        np.ascontiguousarray(pack[:, F.STAMP].view(np.int32)
                             .astype(np.uint32)), o_count)

    # Surfel-level fidelity: the same creation order gives the same rows.
    n_common = min(count, o_count)
    alive = (rad[:n_common] >= 0) & (o_rad[:n_common] >= 0)
    pos_delta = np.linalg.norm(
        smooth[:n_common][alive] - o_smooth[:n_common][alive], axis=1)
    # Sampled-point -> mesh-surface distances both ways (nearest-sample
    # distances would be floored by the sample spacing).
    d_rec = point_to_mesh_distance(
        sample_mesh_surface(v_port, t_port, max_samples=200000), v_ref,
        t_ref)
    d_gt = point_to_mesh_distance(
        sample_mesh_surface(v_ref, t_ref, max_samples=200000), v_port,
        t_port)
    cam = seq.camera
    return {
        "metric": "mesh_mean_distance_vs_golden_standin_mm",
        "value": round(float(d_rec.mean()) * 1000.0, 4),
        "unit": "mm",
        "frames": run["frames"],
        "shape": [cam.height, cam.width],
        "scene": run["scene"],
        "trajectory": run["trajectory"],
        "surfels_tpu": count,
        "surfels_oracle": o_count,
        "triangles_tpu": int(len(t_port)),
        "triangles_ref": int(len(t_ref)),
        "mesh_median_mm": round(float(np.median(d_rec)) * 1000.0, 4),
        "mesh_rms_mm": round(float(np.sqrt((d_rec ** 2).mean())) * 1000.0,
                             4),
        "completeness_1mm": round(float((d_gt <= 0.001).mean()), 4),
        "surfel_mean_delta_mm": round(float(pos_delta.mean()) * 1000.0, 4),
        "surfel_max_delta_mm": round(float(pos_delta.max()) * 1000.0, 4),
        "elapsed_s": round(time.time() - run["t_start"], 1),
        "device": str(run["device"]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the port's fusion (default: cuda)")
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--height", type=int, default=120)
    ap.add_argument("--capacity", type=int, default=200000)
    ap.add_argument("--scene", default="default")
    ap.add_argument("--trajectory", default="arc")
    args = ap.parse_args(argv)
    run = start_anchor(args.frames, args.width, args.height, args.capacity,
                       args.scene, args.trajectory, args.device, log=True)
    print(json.dumps(finish_anchor(run)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
