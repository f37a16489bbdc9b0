"""Benchmark of the port: RGB-D fusion frames/sec at 640x480 on one GPU
(the counterpart of the repository's bench.py, which measures the JAX
package).

    python -m surfelmeshing_tpu_torch.bench [--device cuda|cpu]

BASELINE config 1 (fusion only, 500k surfel capacity) on the synthetic
640x480 sequence: 40 frames, 8 warm-up frames, 24 timed.  The frame step
is the full depth preprocessing plus the 8-phase surfel fusion, as
ReconstructionPipeline runs it for a real dataset; disk I/O and meshing
are excluded, as in the reference's "fusion" stage timings
(main.cc:1531-1545).  As in the JAX bench (--use_shape_buckets), each
frame runs count-sized (shape_bucket_step 65,536, adaptive_creation_bound
2.0): its per-surfel passes cover the bucket above a bound on the surfel
count, not the 500k capacity.  As in the JAX bench (frame_chunk=CHUNK),
frames are deferred and run CHUNK at a time: on the card one CUDA-graph
replay a chunk (pipeline.py, chunk.py).  The bench stages every input on
the device without timing it (pipeline.prefetch_inputs,
main.cc:891-898), warms up, drains, snapshots the dispatch state and
times the frame loop on the host clock, ending when the device has
finished.  No library may be built (ops/cuda_build.py) and no CUDA graph
captured inside the timed region, the counterpart of the JAX bench's
compile rule; if one is, the attempt is discarded and re-run once from
the snapshot (the graphs captured stay), and a second build or capture
prints a warning.

Prints ONE JSON line on stdout: {"metric", "value", "unit",
"vs_baseline", "graph_captures"}, the baseline being the reference's
real-time target of 30 FPS (main.cc:304-307), graph_captures the
captures in the reported timed region.  stderr carries the diagnostics:
timed frames, ms/frame on the host clock and by CUDA events, surfels,
overflow, peak device memory, launches of the blending kernel in the
timed region (on the card one a frame, else the bench fails), builds and
graph captures there, the graphs captured in all, their replays and
capture seconds, and the timed chunks' bucket picks.

Environment:
- SM_BENCH_SMOKE=1: 160x120, 40,960 capacity, 24 frames, 4 warm-up,
  creation budget and bucket step 4,096; the metric gets the prefix
  SMOKE_.  The device stays the one asked for (the JAX bench moves smoke
  runs to the CPU).
- SM_BENCH_CHECK=1 (smoke mode only): replays every frame full-shape
  (a bucket step of the capacity) through a fresh pipeline on the CPU (the
  kernels' plain versions, no prefetch) and requires the surfel count and
  the pack to equal the run's bit for bit: the bucketed dispatch loses
  nothing; prints {"smoke_check": {...}} before the metric line.
- SM_BENCH_TRACE=DIR: a torch.profiler trace of the first timed attempt,
  written to DIR/bench_trace.json (diagnostic only).
The JAX bench's SM_BENCH_BUDGET_S and its bucket precompiles are not
carried: the port compiles nothing per shape.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from . import resolve_device
from .config import SurfelMeshingConfig
from .io.synthetic import synthetic_rgbd_video
from .ops import blend, cuda_build
from .pipeline import ReconstructionPipeline
from .tools.bench_configs_common import peak_mib

CHUNK = 4   # the JAX bench's chunk: the timed count is a multiple of it


def _timed_loop(pipe, video, timed, trace_dir):
    """One timed attempt: -> (host seconds, CUDA-event ms or None)."""
    cuda = pipe.device.type == "cuda"
    profiler = None
    if trace_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for i in timed:
        pipe.process_frame(video, i)
    if cuda:
        end.record()
    pipe.drain()
    elapsed = time.perf_counter() - t0
    if profiler is not None:
        profiler.stop()
        os.makedirs(trace_dir, exist_ok=True)
        profiler.export_chrome_trace(
            os.path.join(trace_dir, "bench_trace.json"))
    return elapsed, start.elapsed_time(end) if cuda else None


def _smoke_check(cfg, video, lo, last, pipe) -> None:
    """Replays frames lo..last full-shape through a fresh CPU pipeline and
    holds the run's state to it bit for bit."""
    ref_cfg = SurfelMeshingConfig(
        max_surfel_count=cfg.max_surfel_count,
        shape_bucket_step=cfg.max_surfel_count,
        max_creations_per_frame=cfg.max_creations_per_frame,
        restrict_fps_to=0)
    ref = ReconstructionPipeline(ref_cfg, video.depth_camera, "cpu")
    for i in range(lo, last + 1):
        ref.process_frame(video, i)
    got = pipe.state.pack.cpu()
    want = ref.state.pack
    count_equal = ref.surfel_count() == pipe.surfel_count()
    pack_equal = torch.equal(got.view(torch.int32), want.view(torch.int32))
    diff = torch.nan_to_num((got - want).abs(), nan=0.0)
    print(json.dumps({"smoke_check": {
        "count_equal": count_equal, "pack_equal": pack_equal,
        "max_abs_diff": float(diff.max())}}))
    if not (count_equal and pack_equal):
        raise RuntimeError("bench: the run's state differs from the CPU "
                           "replay")


def setup(smoke: bool) -> tuple:
    """The bench's (video, config, fused frame range lo..hi, timed
    frames)."""
    W, H = 640, 480
    CAP = 500_000
    NUM_FRAMES = 40
    WARMUP = 8
    STEP = 65_536
    CREATION_BUDGET = 2**15
    if smoke:
        W, H, CAP, NUM_FRAMES = 160, 120, 40_960, 24
        WARMUP, STEP, CREATION_BUDGET = 4, 4_096, 4_096

    video, _seq = synthetic_rgbd_video(NUM_FRAMES, W, H, noise_sigma=0.002)
    cfg = SurfelMeshingConfig(
        max_surfel_count=CAP,
        shape_bucket_step=STEP,
        max_creations_per_frame=CREATION_BUDGET,
        adaptive_creation_bound=2.0,
        frame_chunk=CHUNK,
        restrict_fps_to=0,
    )
    half = cfg.outlier_filtering_frame_count // 2
    lo, hi = half, NUM_FRAMES - half
    n_timed = (hi - lo - WARMUP) // CHUNK * CHUNK
    timed = list(range(lo + WARMUP, lo + WARMUP + n_timed))
    return video, cfg, lo, hi, timed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    smoke = os.environ.get("SM_BENCH_SMOKE") == "1"
    video, cfg, lo, hi, timed = setup(smoke)
    pipe = ReconstructionPipeline(cfg, video.depth_camera, device)

    # Untimed prefetch: depth windows, colors and poses on the device; the
    # timed loop copies nothing from the host.
    pipe.prefetch_inputs(video, lo, hi)
    for i in range(lo, timed[0]):
        pipe.process_frame(video, i)
    pipe.drain()

    snap = pipe.snapshot_dispatch_state()
    trace_dir = os.environ.get("SM_BENCH_TRACE")
    for attempt in range(2):
        builds_before = cuda_build.builds
        captures_before = pipe.graph_captures
        launches_before = blend.blend_core.launches
        picks_before = len(pipe.bucket_pick_log)
        elapsed, event_ms = _timed_loop(pipe, video, timed, trace_dir)
        trace_dir = None   # trace only the first attempt
        launches = blend.blend_core.launches - launches_before
        built = cuda_build.builds - builds_before
        captured = pipe.graph_captures - captures_before
        if built == 0 and captured == 0:
            break
        print(f"bench: {built} build(s) and {captured} graph capture(s) "
              f"inside the timed region (attempt {attempt + 1}); "
              f"re-running once from snapshot", file=sys.stderr)
        pipe.restore_dispatch_state(snap)
        pipe.prefetch_inputs(video, timed[0], hi)
    else:
        print("bench: WARNING: builds or graph captures persisted across "
              "the re-run; the reported number is polluted",
              file=sys.stderr)

    fps = len(timed) / elapsed
    count = pipe.surfel_count()
    overflow = int(pipe.state.overflow_count)
    events = "CUDA events not measured (CPU)" if event_ms is None else \
        f"{event_ms / len(timed):.3f} ms/frame CUDA events"
    peak = peak_mib(device)
    print(f"bench: {len(timed)} timed frames, "
          f"{1000 * elapsed / len(timed):.3f} ms/frame host wall, "
          f"{events}, surfels={count}, overflow={overflow}", file=sys.stderr)
    print(f"bench: peak device memory "
          f"{'not measured (CPU)' if peak is None else f'{peak} MiB'}; "
          f"blend launches in the timed region {launches}; builds in the "
          f"timed region {built}; graph captures in the timed region "
          f"{captured}", file=sys.stderr)
    print(f"bench: graphs captured {pipe.graph_captures} "
          f"{pipe.graph_keys} in {pipe.graph_capture_s:.3f} s, replays "
          f"{pipe.graph_replays}", file=sys.stderr)
    print(f"bench: timed bucket picks (frames, n_eff) "
          f"{pipe.bucket_pick_log[picks_before:]}", file=sys.stderr)
    if device.type == "cuda" and launches != len(timed):
        raise RuntimeError(f"bench: {launches} blending-kernel launches for "
                           f"{len(timed)} timed frames")

    if smoke and os.environ.get("SM_BENCH_CHECK") == "1":
        _smoke_check(cfg, video, lo, timed[-1], pipe)

    print(json.dumps({
        "metric": ("SMOKE_" if smoke else "") + "fusion_fps_640x480_500k",
        "value": round(fps, 2),
        "unit": "frames/sec",
        "vs_baseline": round(fps / 30.0, 3),
        "graph_captures": captured,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
