"""End-to-end bench of the port: preprocessing + fusion + asynchronous
meshing frames/sec (the counterpart of tools/bench_e2e.py of the JAX
package).

    python -m surfelmeshing_tpu_torch.tools.bench_e2e \
        [--device cuda|cpu] [CAP[:BUDGET] ...]

Default configs 500k 20m:-1 (SM_BENCH_SMOKE=1: 41k 41k:-1 on a 24-frame
160x120 video instead of 40 frames at 640x480).  BUDGET absent or 0 runs
count-sized (a 65,536-row bucket step, 4,096 in smoke mode), as the JAX
tool does with --use_shape_buckets; -1 the auto active-set budget, N a
fixed one.

Drives ReconstructionPipeline as the port's bench.py does (untimed
prefetch and warm-up, frame_chunk=CHUNK: on the card one CUDA-graph
replay a chunk) and adds the asynchronous meshing thread, paced the
reference's way: a snapshot is submitted at every 4th timed frame when
the mesher is idle (main.cc:1235-1254), full the first time and then only
the changed rows.  The timed region is the frame loop including snapshot
submission, ending when the device has finished; the mesher trails, and
its final drain is untimed.  A library built (ops/cuda_build.py) or a
CUDA graph captured inside the timed region invalidates the attempt: it
is re-run once from a snapshot of the dispatch state with a fresh mesher
seeded by an untimed full snapshot, as the JAX tool does for an XLA
compile.

Prints one JSON line per config with the JAX tool's keys;
compiles_in_timed_region counts nvcc / g++ builds.  Added counters of the
run: graph_captures (CUDA graphs captured in the reported timed region),
peak_mib (peak device memory allocated, null on the CPU),
skipped_tiles (tiles past the active budget in the final state),
fused_frames and blend_launches (launches of csrc/blend.cu; 0 on the
CPU, where blending runs its plain version) and, for BUDGET 0,
bucket_picks (the timed chunks' n_eff).  The device defaults to cuda and
the tool fails without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from .. import resolve_device
from ..config import SurfelMeshingConfig
from ..io.synthetic import synthetic_rgbd_video
from ..meshing import MeshingDriver
from ..ops import blend, cuda_build
from ..pipeline import ReconstructionPipeline
from .bench_configs_common import parse_size, peak_mib

CHUNK = 4
WARMUP = 8


def run_config(cfg_str: str, video, device, step: int = 65_536) -> dict:
    parts = cfg_str.split(":")
    cap = parse_size(parts[0])
    budget = parse_size(parts[1]) if len(parts) > 1 else 0

    cfg = SurfelMeshingConfig(
        max_surfel_count=cap,
        shape_bucket_step=step,
        max_creations_per_frame=2**15,
        active_surfel_budget=budget,
        frame_chunk=CHUNK,
        restrict_fps_to=0,
    )
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    pipe = ReconstructionPipeline(cfg, video.depth_camera, device)
    mesher = MeshingDriver(cfg)
    launches = blend.blend_core.launches

    half = cfg.outlier_filtering_frame_count // 2
    lo, hi = half, video.frame_count - half
    n_timed = (hi - lo - WARMUP) // CHUNK * CHUNK
    timed = list(range(lo + WARMUP, lo + WARMUP + n_timed))

    pipe.prefetch_inputs(video, lo, hi)

    # Warm-up: fills the map and walks the snapshot path (full once, then
    # a delta).
    fused = 0
    for i in range(lo, lo + WARMUP):
        fused += pipe.process_frame(video, i) is not None
        if (i - lo) % CHUNK == CHUNK - 1:
            mesher.submit_snapshot(pipe.snapshot_for_meshing(i), i)
            mesher.drain()
    pipe.drain()

    snap = pipe.snapshot_dispatch_state()
    snap_frame = pipe._last_snap_frame

    for attempt in range(2):
        builds_before = cuda_build.builds
        captures_before = pipe.graph_captures
        picks_before = len(pipe.bucket_pick_log)
        rows_before = pipe.snapshot_rows_shipped
        snaps = 0
        t0 = time.perf_counter()
        for k, i in enumerate(timed):
            fused += pipe.process_frame(video, i) is not None
            # Paced at every 4th frame, where the JAX tool's chunked
            # dispatch lets it read the state.
            if (k + 1) % CHUNK == 0 and mesher.idle():
                mesher.submit_snapshot(pipe.snapshot_for_meshing(i), i)
                snaps += 1
        pipe.drain()
        elapsed = time.perf_counter() - t0
        built = cuda_build.builds - builds_before
        captured = pipe.graph_captures - captures_before
        if built == 0 and captured == 0:
            break
        print(f"bench_e2e[{cfg_str}]: {built} build(s) and {captured} graph "
              f"capture(s) in the timed region (attempt {attempt + 1}); "
              f"re-running from snapshot", file=sys.stderr)
        pipe.restore_dispatch_state(snap)
        pipe.prefetch_inputs(video, timed[0], hi)
        mesher.finish()
        mesher = MeshingDriver(cfg)   # the engine's mesh can't roll back
        # Untimed full-snapshot re-seed so attempt 2's deltas have a base.
        pipe._last_snap_frame = None
        mesher.submit_snapshot(pipe.snapshot_for_meshing(snap_frame),
                               snap_frame)
        mesher.drain()
    else:
        print(f"bench_e2e[{cfg_str}]: WARNING: builds or graph captures "
              "persisted across the re-run; the number is polluted",
              file=sys.stderr)

    mesher.drain()
    tris = int(mesher.engine.triangle_count)
    mesher.finish()
    fps = len(timed) / elapsed
    return {
        "config": cfg_str, "capacity": cap, "budget": budget,
        "e2e_fps": round(fps, 2),
        "ms_per_frame": round(1000 * elapsed / len(timed), 1),
        "snapshots": snaps,
        "rows_shipped": int(pipe.snapshot_rows_shipped - rows_before),
        "triangles": tris,
        "surfels": pipe.surfel_count(),
        "compiles_in_timed_region": built,
        "graph_captures": captured,
        "peak_mib": peak_mib(device),
        "skipped_tiles": int(pipe.state.skipped_tile_count),
        "fused_frames": fused,
        "blend_launches": blend.blend_core.launches - launches,
        **({"bucket_picks": [n for _, n in
                             pipe.bucket_pick_log[picks_before:]]}
           if budget == 0 else {}),
    }


def main(argv=None) -> list:
    """Run the configs; prints and returns one result dict each."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("configs", nargs="*")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if os.environ.get("SM_BENCH_SMOKE") == "1":
        video, _ = synthetic_rgbd_video(24, 160, 120, noise_sigma=0.002)
        configs, step = args.configs or ["41k", "41k:-1"], 4_096
    else:
        video, _ = synthetic_rgbd_video(40, 640, 480, noise_sigma=0.002)
        configs, step = args.configs or ["500k", "20m:-1"], 65_536
    results = []
    for cfg_str in configs:
        results.append(run_config(cfg_str, video, device, step))
        print(json.dumps(results[-1]), flush=True)
    return results


if __name__ == "__main__":
    main()
