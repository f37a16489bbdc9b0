"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one or more lines:
  1. device: requires CUDA (exits non-zero otherwise), prints the card and
     its power limit, turns TF32 off;
  2. build: compiles csrc/blend.cu, blend_wide.cu (both with the shared
     header blend_common.cuh), gather.cu, l2_read.cu, preprocess.cu,
     association.cu, integration.cu and tiling.cu (one nvcc each)
     and the native mesher (g++), all started together;
  3. kernel: the one-launch blending kernel bit for bit against its plain
     PyTorch version on seeded maps at 640x480 with radii 1, 2, 3, 6, 12
     and MAX_RADIUS and at radius 12 on shapes that are not multiples of
     its tile (24x32, 481x641, 240x320, 120x160); the wide path (radius >
     MAX_RADIUS) bit for bit at 640x480 with radii 33, 48 and 64, at
     radius 257 on a 24x32 map with no border (the reference's sentinel
     collision: every eligible pixel +0.5) and at radius 300 on a 64x640
     map whose rings pass 255; launch counts show which path each radius
     took; at 640x480 radius 12 and 32 (one-launch) and 48 (wide) the
     device time (a CUDA graph of repeated launches replayed between CUDA
     events), the host-inclusive time (back-to-back calls between CUDA
     events) and the plain version's, beside the bound, and the kernels a
     call enqueued as the launchers count them; then the wide path at
     radius 48 for each (T ring iterations a launch, core rows) of
     WIDE_SWEEP, bit for bit and timed;
     preprocess: each csrc/preprocess.cu kernel (bilateral, outlier,
     erode, normals, radii) bit for bit against its plain pass on a
     seeded 640x480 frame at the default settings, one launch of its own
     kernel and none of the others a call, and
     its device, host-inclusive and plain times beside its bound
     (tools/kernel_timing.py::preprocess_times);
     association: csrc/association.cu's two kernels (the min-depth map;
     the support maps, and without sums the conflictor map) bit for bit
     against their plain scatters on a seeded Replica-sized map (7.5M
     rows, 1200x680), one launch of its own kernel a call, and their
     device, host-inclusive and plain times beside their bounds, with the
     plain scatters alone over all entries and over the in-image ones
     (tools/kernel_timing.py::association_times);
     integration: csrc/integration.cu's kernel bit for bit against its
     plain version on seeded 7.5M-row maps at 1200x680 and 640x480 with
     exact_conflict_arbitration off and on, every kind of row phase 5
     meets among them, one launch a call, and its device, host-inclusive
     and plain times beside its bound at both shapes
     (tools/kernel_timing.py::integration_times);
     tiling: csrc/tiling.cu's tile selection bit for bit against its
     plain version on seeded maps of the default capacity (20,000,768
     rows) with 0.5M and 1.8M live rows, every kind of row the selection
     meets among them, one launch a call, and its device, host-inclusive
     and plain times beside its bound (tools/kernel_timing.py::
     tiling_times);
  4. slice: ReconstructionPipeline at 640x480 with 500k surfel capacity and
     default settings over the 24-frame synthetic video, every frame with a
     full outlier window fused; launch counts, zeroed just before, prove
     the kernels ran: one blending launch and one of each preprocessing,
     association and integration kernel a fused frame;
  5. kernel on the slice's own blending inputs (captured through the taps
     on the last warm-up frame, the map holding surfels by then), bit for
     bit, and its device time on them; the same for the wide path at
     radius 48;
  6. the same port slice on the GPU and on the CPU (plain versions) at
     160x120 over 6 fused frames, held to the CPU tests' tolerance; then
     both again with --measurement_blending_radius 48, bit for bit, every
     GPU frame through the wide path (its chunk kernels counted);
  7. exact: the slice with each reference-parity fusion mode
     (symmetric_regularization=False, exact_conflict_arbitration=True,
     fast_neighbor_update=False) and with all three: surfels, no overflow,
     one blending launch per fused frame, ms/frame beside the slice's;
     all three twice, bit for bit; then each mode on the GPU and on the CPU
     at 160x120 over 6 fused frames, bit for bit;
  8. staged: the slice with --log_timings_staged at 500k and at the
     default 20M capacity with the auto active-set budget: the seven
     per-phase columns (mean of the timed frames) and their sum beside the
     CUDA-event time of the whole frame; each final state bit-identical to
     the slice's unstaged one;
     slice-r48: the slice with --measurement_blending_radius 48, every
     fused frame through the wide path (chunk kernels counted): ms/frame
     beside [slice]'s, then staged, its blending column beside [staged]'s;
  9. ab: the A/B matrix's hostile subset (occlusion and thin scenes on the
     look-away trajectory, default vs all-exact modes) at 160x120 over 8
     frames, each cell within 5%;
 10. gather: the gather probe (tools/gather_probe.py of the port) at its
     sizes, every variant (kernels, plain versions, torch.index_select)
     timed on the device and host-inclusive as in phase 3, launch counts
     proving the three kernels ran, gather_lane no slower than
     torch.index_select; the L2 read rate (csrc/l2_read.cu) and from it
     gather_lane's L2-level bounds: its two passes', and the sector bound
     of its (8, HW) layout read directly; then each kernel bit for bit
     against its plain version on sources with NaN-pattern, -0.0 and
     denormal rows and out-of-range indices, at the probe's sizes and at
     N = 1, 257 and 4099 (HW 97 and the probe's);
 11. e2e: preprocessing + fusion + asynchronous meshing at 640x480 / 500k
     over the 40-frame synthetic video (tools/bench_e2e.py's run_config;
     count-sized, as every run without an active-surfel budget):
     8 warm-up frames with a full and a delta snapshot drained, then every
     frame submits a snapshot when the mesher is idle; afterwards one delta
     snapshot is split into its device part and its copies to the host
     (slice and e2e also print their peak device memory);
 12. e2e-20m: the same loop at the default 20M capacity with the auto
     active-set budget (tools/bench_e2e.py's `20m:-1`): no tile may be
     skipped, every fused frame launches the blending kernel and the tile
     selection kernel once (e2e, count-sized, launches the latter not at
     all), and the final state equals e2e's bit for bit; then, for the
     record, 4 frames of the full-shape 20M path (budget 0 with a bucket
     step of the capacity: every pass over 20M rows) timed with CUDA
     events;
 13. bench: the port's bench entry points, chunked as the JAX tools
     ship them (frame_chunk 4: a CUDA-graph replay a chunk).  `python -m
     surfelmeshing_tpu_torch.bench` in a process of its own (rc 0, one
     JSON line with the JAX bench's keys and graph_captures, its stderr
     diagnostics printed, one blending launch a timed frame counted
     across replays, no build in the timed region),
     then its smoke mode with SM_BENCH_CHECK=1 on the card (the card's
     state equal to a CPU replay's, count and pack); then in-process
     through their main(argv) tools/bench_e2e.py (500k, 20m:-1: no build
     in the timed region, triangles, 0 skipped tiles at 20m:-1) and
     tools/bench_configs.py (500k, 2m:2m, 20m:2m, arc), each with its
     blending counts set to 0 just before and one launch a fused frame;
 14. app: the port's application on tests/fixtures/tum_micro at 640x480
     with async meshing, exporting mesh, point cloud and checkpoint;
 15. app-20m: the same at the default capacity with --active_surfel_budget
     -1: the log reports 0 skipped tiles and the point cloud is app's,
     byte for byte;
     buckets: count-sized dispatch (budget 0) against full shape (a
     bucket step of the capacity).  The same 4 20M frames count-sized,
     their state equal to e2e-20m's full-shape run bit for bit (ms/frame
     by CUDA events, peak memory, the picks); e2e's loop at 500k full
     shape, its final state equal to e2e's count-sized one; the app full
     shape (and --use_shape_buckets, accepted), its point cloud equal to
     app's byte for byte; bench.py's configuration per frame (frame_chunk
     1) and first 8 timed frames count-sized and full shape, the frame
     loop and its drain by CUDA events in turns (count-sized, full, full,
     count-sized) and each's device busy time from a torch.profiler
     trace; one blending launch a fused frame in every run;
     chunk: chunked dispatch (--frame_chunk K) against per-frame.
     bench.py's configuration and 24 timed frames at K = 4 and K = 1 in
     turns (K4, K1, K1, K4): final states bit-identical, the graphs
     captured (keys, host seconds) and replayed, ms/frame by CUDA events
     and host wall, device busy (torch.profiler) with the idle share,
     peak memory; bench_e2e's 20m:-1 loop at K = 4: 0 skipped tiles,
     state equal to [e2e]'s; the app with --frame_chunk 3: PLY equal to
     [app]'s; symmetric_regularization=False at K = 4 (eager on the card,
     reported graph false) bit-identical to K = 1; one blending launch a
     fused frame, replays included;
 16. batch: BASELINE config 5's count, 8 synthetic 640x480 sequences
     (distinct scene / trajectory pairs) at 500k capacity each, default
     settings, in lockstep over 12 fused frames through
     app/multi_sequence.py's LockstepBatch (parallel/batch.py): ms a
     lockstep frame (CUDA events), sequence-frames per second and peak
     device memory; the surfel total equals the sum of the counts, the
     blending kernel ran 8 times a lockstep frame, and sequences 0 and 7
     equal single-sequence ReconstructionPipeline runs bit for bit;
 17. multi-seq: the multi-sequence app with --device cuda on
     tests/fixtures/tum_micro and a 640x480 synthetic dataset, then on
     each alone: rc 0 and each PLY byte-identical to its one-dataset run;
 18. shard: one 500k map at 640x480 sharded over 2 gloo ranks spawned on
     the one card (parallel/shard.py; NCCL refuses two ranks on one GPU),
     6 fused frames of the slice video: the gathered state equals the
     single-device state bit for bit, each rank launched the blending
     kernel once a frame; ms a frame, recorded, not a target;
 19. video: the port's renderer (viewer/renderer.py) on the card against
     itself on the CPU at 1280x720, pixel for pixel: a seeded scene with
     every pass (the three mesh size classes and a triangle of extent >=
     192, NaN vertices, splats, the frustum, two debug line sets) in each
     colour mode and with normal shading, and app's final state with its
     mesh; the card's projection against numpy's on the host, float64
     bit for bit; then the time of a frame of e2e's final state with its
     last mesh (stream-elapsed between CUDA events, mean of 5 renders
     after one; device busy from a torch.profiler trace of one more; the
     idle share between them), its triangle and splat counts and the render's peak device
     memory, beside the CPU render of app's state (host wall);
     then the app with --create_video on tests/fixtures/tum_micro at
     640x480: rc, frame and input-image PNGs, wall beside app's, and one
     blending launch a fused frame;
 20. live-viewer: the app with --live_viewer PORT on tum_micro while a
     thread fetches /, /mesh and /version: a payload with vertices, the
     blending kernel launched, and the port free again after run returns;
 21. fidelity: the fidelity anchor at 160x120 over 50 frames, the port's
     mesh within 1 mm (mean) of the golden oracle's.  It starts after the
     build: the port fuses on the card and the host-side oracle runs in a
     worker process while phases 3-20 run; the phase ends last.
Phases 7-9, 13, buckets, chunk and 17-21 print their wall time.
Then one JSON line describing the kernels (per kernel: launches on its
path and per main-path frame, for the blending kernel also on the [batch],
[shard], [video] app, [live-viewer], [bench], [buckets] and [chunk] paths,
for each preprocessing kernel on the [batch], [bench] and [chunk] paths;
the tile selection kernel's path is [e2e-20m]'s tiled frames), max_abs_err
against the plain version, device / host-inclusive / plain times, the
bound with what sets it, and the one-call PyTorch yardstick or null)
and, last, the result line.
Any failed check ends the run with a non-zero exit code.
"""

import contextlib
import dataclasses
import io
import json
import logging
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from surfelmeshing_tpu_torch import bench
from surfelmeshing_tpu_torch import chunk as chunk_module
from surfelmeshing_tpu_torch.app import main as app_main
from surfelmeshing_tpu_torch.app import multi_sequence as MS
from surfelmeshing_tpu_torch.config import SurfelMeshingConfig
from surfelmeshing_tpu_torch.eval import ab_matrix as AB
from surfelmeshing_tpu_torch.io.checkpoint import load_checkpoint
from surfelmeshing_tpu_torch.io.synthetic import (default_camera,
                                                  synthetic_rgbd_video,
                                                  write_tum_dataset)
from surfelmeshing_tpu_torch.io.tum import read_tum_rgbd_dataset
from surfelmeshing_tpu_torch.meshing import MeshingDriver, engine
from surfelmeshing_tpu_torch.ops import association as A
from surfelmeshing_tpu_torch.ops import blend, cuda_build, launch_counts
from surfelmeshing_tpu_torch.ops import fusion as F
from surfelmeshing_tpu_torch.ops import gather as G
from surfelmeshing_tpu_torch.ops import integration as I
from surfelmeshing_tpu_torch.ops import preprocess as pp
from surfelmeshing_tpu_torch.ops import tiling
from surfelmeshing_tpu_torch.parallel import shard
from surfelmeshing_tpu_torch.pipeline import (ReconstructionPipeline,
                                              preprocess_kwargs)
from surfelmeshing_tpu_torch.tools import (bench_configs, bench_e2e,
                                           fidelity_anchor, gather_probe,
                                           kernel_timing)
from surfelmeshing_tpu_torch.tools.blend_timing import \
    seeded_maps as random_maps
from surfelmeshing_tpu_torch.utils.se3 import SE3
from surfelmeshing_tpu_torch.utils.timing import COLUMNS
from surfelmeshing_tpu_torch.viewer import renderer as R
from surfelmeshing_tpu_torch.viewer.probe import (MeshProbe, free_port,
                                                  port_is_free)

SCALE = 5000.0
WARMUP_FRAMES = 4
KERNEL_SOURCES = ("blend", "blend_wide", "gather", "l2_read",
                  "preprocess", "association", "integration", "tiling")
# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bytes/s and
# f32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
REPO = Path(__file__).resolve().parent
FIXTURE = REPO / "tests" / "fixtures" / "tum_micro"


class SmokeFailure(Exception):
    pass


def check(cond: bool, message: str) -> None:
    if not cond:
        raise SmokeFailure(message)


def phase_device() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {name}, {torch.cuda.device_count()} visible; torch "
          f"{torch.__version__} CUDA {torch.version.cuda}; TF32 off for "
          f"matmul and cuDNN")
    print(smi.strip().splitlines()[0])
    return name


def blend_counts() -> tuple:
    return blend.blend_core.launches, blend.blend_core.wide_launches


def zero_launch_counts() -> None:
    """Every kernel's launch counter to 0 (ops/launch_counts.py)."""
    launch_counts.zero()


def preprocess_counts(label: str) -> dict:
    """Each preprocessing kernel's launches since the counters were zeroed,
    checked to equal the blending calls counted over the same run: a fused
    frame launches one of each."""
    counts = pp.launches()
    calls = blend.blend_core.launches + blend.blend_core.wide_launches
    check(counts == dict.fromkeys(pp.KERNELS, calls), f"{label}: "
          f"preprocessing launches {counts} for {calls} blending calls")
    return counts


def add_counts(total: dict, counts: dict) -> dict:
    """`total` plus `counts`, key by key."""
    return {k: total.get(k, 0) + n for k, n in counts.items()}


def compare_kernel(maps, radius, label) -> float:
    """Kernel vs plain version on the same CUDA tensors, bit for bit, and
    the launch counts of the path the radius must take; returns the max
    absolute difference (0 when they agree)."""
    before = blend_counts()
    got = blend.blend_core(*maps, radius, SCALE)
    torch.cuda.synchronize()
    one, wide = (a - b for a, b in zip(blend_counts(), before))
    want = blend.blend_core_reference(*maps, radius, SCALE)
    exact = bits_equal(got, want)
    err = max_abs_err(got, want)
    changed = int((want != maps[0]).sum())
    path = "one-launch" if radius <= blend.MAX_RADIUS else "wide"
    print(f"[kernel] {label} {tuple(maps[0].shape)} radius {radius}: "
          f"bit-identical to the plain version {exact} (max |diff| {err}; "
          f"{changed} pixels blended); launches one-launch {one}, wide "
          f"path {wide}")
    check(exact, f"blending kernel differs from its plain version on "
          f"{label} at radius {radius}")
    check((one, wide) == ((1, 0) if path == "one-launch" else (0, 1)),
          f"radius {radius} did not take the {path} path once")
    return err


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes at HBM rate or operations
    at the f32 rate, whichever is longer."""
    bytes_ms = 1000.0 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1000.0 * ops / F32_OPS_PER_S
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def sentinel_maps(h, w, device):
    """Every pixel valid and supported: no border, so every eligible pixel
    stays at the reference's 'unknown' ring value 255 until iteration 256
    reads it as ring 255."""
    depth_f = torch.full((h, w), 5000.0)
    ones = torch.ones((h, w))
    avg = torch.full((h, w), np.float32(5000.0 / SCALE + 0.01))
    return [m.to(device) for m in (depth_f, ones, ones.clone(), avg)]


def long_ring_maps(h, w, seed, device):
    """Invalid left columns and an unsupported run in one row: rings grow
    along the rows past ring 255, and targets grow ndist rings."""
    rng = np.random.default_rng(seed)
    depth_f = (10000 + rng.integers(0, 300, (h, w))).astype(np.float32)
    depth_f[:, :3] = 0
    supported = np.ones((h, w), np.float32)
    supported[h // 2, w // 2:] = 0
    valid = (depth_f > 0).astype(np.float32)
    avg = (depth_f / SCALE +
           0.01 * rng.standard_normal((h, w))).astype(np.float32)
    return [torch.from_numpy(m).to(device)
            for m in (depth_f, supported, valid, avg)]


def blend_bound(h: int, w: int) -> dict:
    """Four f32 maps read and one written once.  Every pixel changes at
    most once (dist and ndist leave 255 / 0 once, on disjoint pixel sets),
    at most 18 f32 operations (init 5, then up to 8 ring adds, the max, the
    division and 3 for depth), so 18 a pixel bounds the operations from
    above; that bound is far below the bytes', which therefore set it for
    every input."""
    return bound(5 * 4 * h * w, 18 * h * w)


def time_blend(maps, radius, device, repeats, label) -> dict:
    """Device, host-inclusive and plain times of blend_core at `radius` on
    `maps`, beside the bound, and the kernels each call enqueued, counted
    over the timed calls; prints them."""
    zero_launch_counts()
    times = dict(
        device_ms=kernel_timing.device_ms(
            lambda: blend.blend_core(*maps, radius, SCALE), repeats),
        host_ms=kernel_timing.host_ms(
            lambda: blend.blend_core(*maps, radius, SCALE), device, repeats),
        plain_ms=kernel_timing.device_ms(
            lambda: blend.blend_core_reference(*maps, radius, SCALE), 3),
        plain_host_ms=kernel_timing.host_ms(
            lambda: blend.blend_core_reference(*maps, radius, SCALE), device,
            3),
        library_ms=None, **blend_bound(*maps[0].shape))
    core = blend.blend_core
    calls = core.launches + core.wide_launches
    times["kernel_launches_per_call"] = \
        (core.launches + core.wide_kernel_launches) / calls
    h, w = maps[0].shape
    print(f"[kernel] {w}x{h} radius {radius}, {label}, seeded maps: "
          f"{times['kernel_launches_per_call']:g} kernels a call (launcher "
          f"counts over {calls} calls); device "
          f"{times['device_ms']:.4f} ms (CUDA graph of {repeats} calls), "
          f"host-inclusive {times['host_ms']:.4f} ms; plain PyTorch device "
          f"{times['plain_ms']:.4f} ms, host-inclusive "
          f"{times['plain_host_ms']:.4f} ms; bound {times['bound_ms']:.5f} "
          f"ms ({times['bound_by']}), {100.0 * times['bound_ms'] / times['device_ms']:.1f}% "
          f"of it reached; no single PyTorch call computes it")
    return times


def phase_kernel(device):
    """-> the kernels-line numbers of the one-launch kernel and of the
    wide path."""
    err = wide_err = 0.0
    for radius in (1, 2, 3, 6, 12, blend.MAX_RADIUS):
        err = max(err, compare_kernel(random_maps(480, 640, radius, device),
                                      radius, "seeded maps"))
    for shape in ((24, 32), (481, 641), (240, 320), (120, 160)):
        err = max(err, compare_kernel(random_maps(*shape, 1, device), 12,
                                      "seeded maps"))
    for radius in (33, 48, 64):
        wide_err = max(wide_err, compare_kernel(
            random_maps(480, 640, radius, device), radius, "seeded maps"))
    maps = sentinel_maps(24, 32, device)
    wide_err = max(wide_err, compare_kernel(maps, 257, "no border (sentinel)"),
                   compare_kernel(long_ring_maps(64, 640, 1, device), 300,
                                  "rings past 255"))
    moved = torch.zeros((24, 32), device=device)
    moved[1:-1, 1:-1] = 0.5
    check(torch.equal(blend.blend_core(*maps, 257, SCALE) - maps[0], moved),
          "radius 257: the sentinel collision did not move every eligible "
          "pixel by +0.5")
    print("[kernel] radius 257 on the map with no border: every eligible "
          "pixel moved by +0.5 (the reference's ring-255 sentinel)")
    maps = random_maps(480, 640, 2, device)
    times = time_blend(maps, 12, device, 50, "one-launch kernel")
    worst = time_blend(maps, blend.MAX_RADIUS, device, 20,
                       "one-launch kernel at its largest radius")
    wide = time_blend(maps, 48, device, 30, "wide path")
    wide["sweep"], sweep_err = wide_sweep(maps, 48)
    return (dict(times, max_abs_err=err, radius32_device_ms=worst["device_ms"]),
            dict(wide, max_abs_err=max(wide_err, sweep_err)))


def phase_preprocess(device) -> list:
    """-> the kernels-line numbers of the five preprocessing kernels."""
    cfg = slice_config()
    kw = preprocess_kwargs(cfg, default_camera(640, 480))
    frame = [t.to(device) for t in kernel_timing.preprocess_inputs(
        7, 480, 640, cfg.outlier_filtering_frame_count)]
    for name, fn, args in kernel_timing.preprocess_pass_args(*frame, kw):
        got = getattr(pp, fn)(*args)
        want = getattr(pp, fn + "_reference")(*args)
        got, want = (x if isinstance(x, tuple) else (x,)
                     for x in (got, want))
        check(all(bits_equal(g, w) for g, w in zip(got, want)),
              f"preprocess {name} kernel differs from its plain pass")
    rows = kernel_timing.preprocess_times(*frame, kw)
    for r in rows:
        one = dict(dict.fromkeys(pp.KERNELS, 0), **{r["name"]: 1})
        check(r["call_launches"] == one, f"preprocess {r['name']}: "
              f"launches {r['call_launches']} in a call")
        print(f"[kernel] preprocess {r['name']} 640x480, seeded frame, "
              f"bit-identical to its plain pass, 1 launch a call; device "
              f"{r['device_ms']:.4f} ms (CUDA graph of "
              f"{kernel_timing.REPEATS} calls), host-inclusive "
              f"{r['host_ms']:.4f} ms; plain PyTorch device "
              f"{r['plain_ms']:.4f} ms, host-inclusive "
              f"{r['plain_host_ms']:.4f} ms; bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}: {r['bytes']} B, {r['f64_ops']} f64 "
              f"operations), {100.0 * r['bound_ms'] / r['device_ms']:.1f}% "
              f"of it reached")
    total = sum(r["device_ms"] for r in rows)
    print(f"[kernel] preprocess: five kernels {total:.4f} ms device, plain "
          f"passes {sum(r['plain_ms'] for r in rows):.4f} ms")
    return [dict(r, max_abs_err=0.0, library_ms=None) for r in rows]


REPLICA_ROWS = 7_500_000


def phase_association(device) -> list:
    """-> the kernels-line numbers of the two association kernels."""
    h, w, scale = 680, 1200, 6553.5
    rows = {k: v.to(device) for k, v in kernel_timing.association_inputs(
        7, REPLICA_ROWS, h, w, count=REPLICA_ROWS - 40_000).items()}
    hw = h * w
    other = [(rows[f"pix_{s}"] != A.INVALID_INDEX) & ~rows[f"support_{s}"]
             for s in "ab"]
    pairs = [((A.min_depth_map(hw, rows["pix_a"], rows["pix_b"],
                               rows["z"]),),
              (A.min_depth_map_reference(hw, rows["pix_a"], rows["pix_b"],
                                         rows["z"]),))]
    args = (hw, rows["pix_a"], rows["pix_b"], rows["support_a"],
            rows["support_b"], rows["idx"])
    pairs.append((A.support_maps(*args, rows["z"], scale),
                  A.support_maps_reference(*args, rows["z"], scale)))
    args = (hw, rows["pix_a"], rows["pix_b"], *other, rows["idx"])
    pairs.append(((A.min_index_map(*args),),
                  (A.min_index_map_reference(*args),)))
    for (got, want), name in zip(pairs, ("min-depth", "support",
                                         "min-index")):
        check(all(bits_equal(g, x) for g, x in zip(got, want)),
              f"association {name} map differs from its plain scatters")
    in_view = int(((rows["pix_a"] != A.INVALID_INDEX) |
                   (rows["pix_b"] != A.INVALID_INDEX)).sum())
    out = kernel_timing.association_times(rows, hw, scale)
    for r in out:
        one = dict(dict.fromkeys(A.launches(), 0), **{r["name"]: 1})
        check(r["call_launches"] == one, f"association {r['name']}: "
              f"launches {r['call_launches']} in a call")
        print(f"[kernel] association {r['name']} 1200x680, {REPLICA_ROWS} "
              f"seeded rows ({in_view} in view), bit-identical to its plain "
              f"scatters, 1 launch a call; device {r['device_ms']:.4f} ms "
              f"(maps' fill included), host-inclusive {r['host_ms']:.4f} "
              f"ms; plain PyTorch device {r['plain_ms']:.4f} ms, "
              f"host-inclusive {r['plain_host_ms']:.4f} ms; plain scatters "
              f"alone over all 2N entries {r['scatter_all_ms']:.4f} ms, "
              f"over the in-image ones {r['scatter_valid_ms']:.4f} ms; "
              f"bound {r['bound_ms']:.5f} ms (bytes: {r['bytes']} B), "
              f"{100.0 * r['bound_ms'] / r['device_ms']:.1f}% of it reached")
    return [dict(r, max_abs_err=0.0, library_ms=None, bound_by="bytes")
            for r in out]


def phase_integration(device) -> list:
    """-> the kernels-line numbers of the integration kernel at each
    shape."""
    out = []
    for label, (h, w, focal) in (("1200x680", (680, 1200, 600.0)),
                                 ("640x480", (480, 640, 525.0))):
        for exact in (False, True):
            inp = kernel_timing.integration_inputs(
                7, REPLICA_ROWS, h, w, focal, count=REPLICA_ROWS - 40_000,
                exact=exact, device=device)
            got = kernel_timing.integrate(inp)
            torch.cuda.synchronize()
            want = kernel_timing.integrate(inp, plain=True)
            check(all(bits_equal(g, x) for g, x in zip(got, want)),
                  f"integration {label} (exact conflicts {exact}) differs "
                  f"from its plain version")
            kinds = kernel_timing.integration_row_kinds(inp, got)
            check(all(kinds.values()), f"integration {label}: a kind of "
                  f"row is missing: {kinds}")
            del got, want
            if exact:
                continue
            r = kernel_timing.integration_times(inp)
            check(r["call_launches"] == 1, f"integration: "
                  f"{r['call_launches']} launches in a call")
            print(f"[kernel] integration {label}, {REPLICA_ROWS} seeded rows "
                  f"({kinds}), bit-identical to its plain version with "
                  f"exact_conflict_arbitration off and on, 1 launch a "
                  f"call; device {r['device_ms']:.4f} ms, host-inclusive "
                  f"{r['host_ms']:.4f} ms; plain PyTorch device "
                  f"{r['plain_ms']:.4f} ms, host-inclusive "
                  f"{r['plain_host_ms']:.4f} ms; bound {r['bound_ms']:.5f} "
                  f"ms (bytes: {r['bytes']} B), "
                  f"{100.0 * r['bound_ms'] / r['device_ms']:.1f}% of it "
                  f"reached")
            out.append(dict(r, name=f"integration_{label}", max_abs_err=0.0,
                            library_ms=None, bound_by="bytes"))
    return out


def phase_tiling(device) -> list:
    """-> the kernels-line numbers of the tile selection kernel at each
    live count."""
    out = []
    for live in (500_000, 1_800_000):
        inp = kernel_timing.tiling_inputs(7, 20_000_768, live, device=device)
        got = kernel_timing.tile_select(inp)
        torch.cuda.synchronize()
        want = kernel_timing.tile_select(inp, plain=True)
        check(torch.equal(got.cpu(), want.cpu()),
              f"tiling at {live} live rows differs from its plain version")
        kinds = kernel_timing.tiling_row_kinds(inp)
        check(all(kinds.values()), f"tiling: a kind of row is missing: "
              f"{kinds}")
        r = kernel_timing.tiling_times(inp)
        check(r["call_launches"] == 1, f"tiling: {r['call_launches']} "
              f"launches in a call")
        print(f"[kernel] tiling, 20,000,768 rows, {live} live ({kinds}), "
              f"{int(got.sum())} of {got.numel()} tiles flagged, "
              f"bit-identical to its plain version, 1 launch a call; "
              f"device {r['device_ms']:.4f} ms, host-inclusive "
              f"{r['host_ms']:.4f} ms; plain PyTorch device "
              f"{r['plain_ms']:.4f} ms, host-inclusive "
              f"{r['plain_host_ms']:.4f} ms; bound {r['bound_ms']:.5f} ms "
              f"(bytes: {r['bytes']} B), "
              f"{100.0 * r['bound_ms'] / r['device_ms']:.1f}% of it reached")
        out.append(dict(r, name=f"tiling_{live}", max_abs_err=0.0,
                        library_ms=None, bound_by="bytes"))
        del inp, got, want
        torch.cuda.empty_cache()
    return out


WIDE_SWEEP = ((8, 32), (8, 40), (12, 32), (12, 40), (16, 32), (16, 40),
              (16, 48), (20, 48), (24, 40), (24, 48))


def wide_sweep(maps, radius):
    """The wide path at `radius` with T ring iterations a launch and cores
    of core_h rows, for each (T, core_h) of WIDE_SWEEP: bit for bit against
    the plain version, and its device time; -> the sweep's entries and the
    largest difference."""
    want = blend.blend_core_reference(*maps, radius, SCALE)
    entries, err = [], 0.0
    for chunk, core_h in WIDE_SWEEP:
        def step():
            return blend.blend_wide(*maps, radius, SCALE, chunk, core_h)
        got = step()
        check(bits_equal(got, want), f"wide path with T {chunk}, core "
              f"{core_h} rows differs from its plain version")
        err = max(err, max_abs_err(got, want))
        ms = kernel_timing.device_ms(step, 20)
        entries.append(dict(chunk=chunk, core_h=core_h, device_ms=ms))
    print(f"[kernel] wide path at radius {radius}, {tuple(maps[0].shape)} "
          f"seeded maps, sweep of (T ring iterations a launch, core rows), "
          f"each bit-identical to the plain version; device ms (CUDA graph "
          f"of 20 calls): " + ", ".join(
              f"T {e['chunk']} x {e['core_h']}: {e['device_ms']:.4f}"
              for e in entries) + f"; default T {blend.WIDE_CHUNK} x "
          f"{blend.WIDE_CORE_H}")
    return entries, err


def live_pack(pipe) -> np.ndarray:
    count = pipe.surfel_count()
    return F.state_to_numpy(pipe.state)["pack"][:count]


def live_state(state: F.SurfelState) -> dict:
    """Host copy of the state's live rows and counters."""
    count = int(state.surfel_count)
    return F.state_to_numpy(dataclasses.replace(
        state, pack=state.pack[:count], neighbors=state.neighbors[:, :count],
        nbr_dist=state.nbr_dist[:, :count]))


STATE_FIELDS = ("pack", "neighbors", "nbr_dist", "surfel_count",
                "merge_count", "overflow_count")


def states_equal(a: dict, b: dict) -> bool:
    """Bit-for-bit equality of two live_state() copies: the surfel map and
    its counters (the tiling's own counters aside)."""
    return all(a[k].shape == b[k].shape and
               np.array_equal(a[k].view(np.int32), b[k].view(np.int32))
               for k in STATE_FIELDS)


SLICE_FRAMES = 24


def slice_config(**kw) -> SurfelMeshingConfig:
    return SurfelMeshingConfig(max_surfel_count=500_000, restrict_fps_to=0,
                               **kw)


def run_slice(device, video, cfg, modes=None, taps=None) -> dict:
    """ReconstructionPipeline over every frame of `video` with `cfg` and the
    fusion modes `modes`; blending-kernel launches counted over the run,
    CUDA events around each fused frame and over the frames after
    WARMUP_FRAMES fused.  Logs every fused frame's timings line when
    cfg.log_timings is set, as the app does."""
    pipe = ReconstructionPipeline(cfg, video.depth_camera, device)
    if modes:
        pipe.fusion_params = dataclasses.replace(pipe.fusion_params, **modes)
    half = cfg.outlier_filtering_frame_count // 2
    fused_frames = list(range(half, video.frame_count - half))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    frame_events = []
    zero_launch_counts()
    fused = 0
    for i in range(video.frame_count):
        if i == fused_frames[WARMUP_FRAMES]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        result = pipe.process_frame(video, i,
                                    taps=taps if fused == WARMUP_FRAMES - 1
                                    else None)
        events[1].record()
        if result is not None:
            fused += 1
            frame_events.append(events)
            if cfg.log_timings:
                pipe.log_frame_timings(i)
        if i == fused_frames[-1]:
            end.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    timed = len(fused_frames) - WARMUP_FRAMES
    check(fused == len(fused_frames), "not every full-window frame fused")
    if cfg.measurement_blending_radius <= blend.MAX_RADIUS:
        check(blend.blend_core.wide_launches == 0, "a radius <= "
              f"{blend.MAX_RADIUS} took the wide blending path")
    return dict(pipe=pipe, fused=fused, launches=blend.blend_core.launches,
                preprocess=preprocess_counts("run_slice"),
                association=A.launches(),
                integration=I.integrate_measurements.launches,
                wide_launches=blend.blend_core.wide_launches,
                wide_kernels=blend.blend_core.wide_kernel_launches,
                timed=timed, ms_frame=start.elapsed_time(end) / timed,
                wall_ms=1000.0 * wall / timed,
                frame_ms=[a.elapsed_time(b) for a, b in frame_events])


def phase_slice(device, video, seq) -> dict:
    taps = {}
    torch.cuda.reset_peak_memory_stats()
    run = run_slice(device, video, slice_config(), taps=taps)
    pipe, fused, launches = run["pipe"], run["fused"], run["launches"]
    count = pipe.surfel_count()
    pack = live_pack(pipe)
    cols = [F.PX, F.PY, F.PZ, F.SX, F.SY, F.SZ, F.NX, F.NY, F.NZ, F.CONF]
    alive = pack[pack[:, F.RAD] >= 0]
    dist = seq.surface_distance(alive[:, F.SX:F.SZ + 1])
    print(f"[slice] 640x480, 500k capacity: {fused} frames fused, "
          f"{launches} blend launches, preprocessing launches "
          f"{run['preprocess']}, association launches "
          f"{run['association']}, integration launches "
          f"{run['integration']}, surfel count {count}, overflow "
          f"{int(pipe.state.overflow_count)}, {run['ms_frame']:.3f} ms/frame "
          f"(CUDA events over {run['timed']} frames after {WARMUP_FRAMES} "
          f"warm-up; host wall {run['wall_ms']:.3f} ms/frame), median "
          f"surface distance {1000 * float(np.median(dist)):.3f} mm, "
          f"{peak_mib()} MiB peak device memory allocated")
    check(count > 0, "no surfels")
    check(int(pipe.state.overflow_count) == 0, "surfel overflow")
    check(np.isfinite(pack[:, cols]).all(), "NaN/inf in live surfel rows")
    check(launches == fused, f"{launches} kernel launches for {fused} "
          f"fused frames")
    check(run["association"] == {"min_depth": fused, "support": fused},
          f"association launches {run['association']} for {fused} fused "
          f"frames")
    check(run["integration"] == fused, f"integration launches "
          f"{run['integration']} for {fused} fused frames")
    check(float(np.median(dist)) < 0.005, "surfels off the scene surface")
    return dict(launches=launches, fused=fused, taps=taps,
                preprocess=run["preprocess"], association=run["association"],
                integration=run["integration"], ms_frame=run["ms_frame"],
                radius=pipe.fusion_params.measurement_blending_radius,
                state=live_state(pipe.state))


def phase_slice_inputs(taps, radius, wide_radius=48):
    """The blending kernel on the slice's own inputs at the slice's radius
    and the wide path on them at `wide_radius`: bit for bit and device
    times; -> (max |diff| of each, wide path's device ms)."""
    h, w = taps["depth"].shape
    maps = [m.contiguous() for m in F.blend_inputs(
        taps["depth"], taps["supporting_surfels"].reshape(h, w),
        taps["support_counts"].reshape(h, w),
        taps["support_depth_sums"].reshape(h, w))]
    label = f"slice blending inputs (fused frame {WARMUP_FRAMES})"
    err = compare_kernel(maps, radius, label)
    wide_err = compare_kernel(maps, wide_radius, label)
    ms, wide_ms = (kernel_timing.device_ms(
        lambda r=r: blend.blend_core(*maps, r, SCALE), 50)
        for r in (radius, wide_radius))
    print(f"[kernel] slice blending inputs: radius {radius} device {ms:.4f} "
          f"ms, wide path at radius {wide_radius} device {wide_ms:.4f} ms "
          f"(CUDA graphs of 50 calls)")
    return err, wide_err, wide_ms


def mean_nearest_distance(a: np.ndarray, b: np.ndarray, device) -> float:
    a = torch.from_numpy(a).to(device, torch.float64)
    b = torch.from_numpy(b).to(device, torch.float64)
    return float(torch.cat([torch.cdist(c, b).min(dim=1).values
                            for c in a.split(4096)]).mean())


def gpu_and_cpu_runs(device, modes=None, **config):
    """The port at 160x120 over 6 fused frames on the card and on the CPU
    (plain versions), fusion modes `modes`, config fields `config`; -> the
    two live states."""
    cfg = SurfelMeshingConfig(max_surfel_count=65_536, restrict_fps_to=0,
                              **config)
    half = cfg.outlier_filtering_frame_count // 2
    states = []
    for dev in (device, torch.device("cpu")):
        video, _ = synthetic_rgbd_video(6 + 2 * half, 160, 120,
                                        noise_sigma=0.002)
        pipe = ReconstructionPipeline(cfg, video.depth_camera, dev)
        if modes:
            pipe.fusion_params = dataclasses.replace(pipe.fusion_params,
                                                     **modes)
        fused = sum(pipe.process_frame(video, i) is not None
                    for i in range(video.frame_count))
        check(fused == 6, f"{fused} frames fused on {dev}")
        states.append(live_state(pipe.state))
    return states


def phase_gpu_vs_cpu(device):
    gpu_state, cpu_state = gpu_and_cpu_runs(device)
    gpu, cpu = gpu_state["pack"], cpu_state["pack"]
    count_ok = abs(len(gpu) - len(cpu)) <= 0.01 * len(cpu)
    exact = states_equal(gpu_state, cpu_state)
    close = len(gpu) == len(cpu) and np.allclose(gpu, cpu, rtol=3e-5,
                                                 atol=3e-6)
    alive_g = gpu[gpu[:, F.RAD] >= 0][:, F.SX:F.SZ + 1]
    alive_c = cpu[cpu[:, F.RAD] >= 0][:, F.SX:F.SZ + 1]
    dist = mean_nearest_distance(alive_g, alive_c, device)
    print(f"[gpu-vs-cpu] 160x120, 6 fused frames: surfels GPU {len(gpu)} "
          f"CPU {len(cpu)}; bit-identical {exact}; within rtol 3e-5 "
          f"atol 3e-6 {close}; mean nearest-surfel distance {dist:.3e} m")
    check(close or (count_ok and dist < 5e-4), "GPU and CPU slices disagree")
    zero_launch_counts()
    gpu_state, cpu_state = gpu_and_cpu_runs(device,
                                            measurement_blending_radius=48)
    one, wide = blend_counts()
    kernels = blend.blend_core.wide_kernel_launches
    exact = states_equal(gpu_state, cpu_state)
    print(f"[gpu-vs-cpu] 160x120, 6 fused frames, "
          f"--measurement_blending_radius 48: surfels GPU "
          f"{len(gpu_state['pack'])} CPU {len(cpu_state['pack'])}; "
          f"bit-identical {exact}; GPU blending calls: wide path {wide} "
          f"({kernels} kernel launches), one-launch kernel {one}")
    check(exact, "radius 48: GPU and CPU states differ")
    check((one, wide) == (0, 6), f"radius 48: {wide} wide-path and {one} "
          f"one-launch blending calls for 6 fused frames")
    chunks = wide_chunks(48)
    check(kernels == wide * chunks, f"radius 48: {kernels} wide-path "
          f"kernels for {wide} calls, not {chunks} chunk kernels each")
    return dict(calls=wide, kernels=kernels)


def wide_chunks(radius: int) -> int:
    """Chunk kernels a wide-path call enqueues: the first carries the
    border iteration and WIDE_CHUNK-1 ring iterations, each later one
    WIDE_CHUNK."""
    return -(-(radius - 1) // blend.WIDE_CHUNK)


# The reference-parity fusion modes: each switch alone, then all three.
EXACT_MODES = AB.MODES[1:]


def phase_exact(device, video, slice_run) -> None:
    """Each reference-parity mode, and all three, on the slice's frames at
    640x480 / 500k: surfels, no overflow, one blending launch per fused
    frame, ms/frame beside [slice]'s defaults; exact_all twice, bit for
    bit; then each mode on the card and on the CPU at 160x120, bit for
    bit."""
    t0 = time.perf_counter()
    states = {}
    for name, modes in EXACT_MODES + EXACT_MODES[-1:]:
        run = run_slice(device, video, slice_config(), modes=modes)
        pipe = run["pipe"]
        state = live_state(pipe.state)
        count = len(state["pack"])
        print(f"[exact] {name} at 640x480, 500k capacity: {run['fused']} "
              f"frames fused, {run['launches']} blend launches, {count} "
              f"surfels, {int(state['merge_count'])} merges, overflow "
              f"{int(state['overflow_count'])}; {run['ms_frame']:.3f} "
              f"ms/frame CUDA events (host wall {run['wall_ms']:.3f}) "
              f"against the defaults' {slice_run['ms_frame']:.3f} in "
              f"[slice]")
        check(count > 0, f"{name}: no surfels")
        check(int(state["overflow_count"]) == 0, f"{name}: surfel overflow")
        check(np.isfinite(state["pack"][:, F.SX:F.SZ + 1]).all(),
              f"{name}: NaN/inf smoothed positions")
        check(run["launches"] == run["fused"], f"{name}: {run['launches']} "
              f"blend launches for {run['fused']} fused frames")
        if name in states:
            check(states_equal(state, states[name]),
                  f"{name}: two runs differ")
            print(f"[exact] {name} run twice: final states bit-identical")
        states[name] = state
    for name, modes in EXACT_MODES:
        gpu_state, cpu_state = gpu_and_cpu_runs(device, modes)
        exact = states_equal(gpu_state, cpu_state)
        print(f"[exact] {name} at 160x120, 6 fused frames: surfels GPU "
              f"{len(gpu_state['pack'])} CPU {len(cpu_state['pack'])}; "
              f"bit-identical {exact}")
        check(exact, f"{name}: GPU and CPU states differ")
    print(f"[exact] phase wall {time.perf_counter() - t0:.1f} s")


def staged_means(run) -> dict:
    """Per-phase ms of a run with log_timings_staged: the mean of its timed
    frames' columns (preprocessing and COLUMNS)."""
    lines = run["pipe"].timings_log_lines[-run["timed"]:]
    cols = {name: [] for name in ("preprocessing",) + COLUMNS}
    for line in lines:
        words = line.split()
        values = dict(zip(words[0::2], words[1::2]))
        for name, ms in cols.items():
            ms.append(float(values[name]))
    return {name: sum(ms) / len(ms) for name, ms in cols.items()}


def phase_staged(device, video, slice_run) -> dict:
    """--log_timings_staged at 640x480 with 500k capacity and with the
    default capacity and the auto active-set budget: the seven fusion
    columns of the timings lines (mean over the timed frames) beside the
    CUDA-event time of the whole frame; each state equals [slice]'s
    unstaged 500k run bit for bit."""
    t0 = time.perf_counter()
    means = {}
    for label, capacity, budget in (
            ("500k", 500_000, 0),
            ("20M, --active_surfel_budget -1",
             SurfelMeshingConfig().max_surfel_count, -1)):
        cfg = dataclasses.replace(
            slice_config(log_timings="timings.txt", log_timings_staged=True),
            max_surfel_count=capacity, active_surfel_budget=budget)
        run = run_slice(device, video, cfg)
        pipe = run["pipe"]
        mean = staged_means(run)
        means.setdefault("500k", mean)
        fusion = sum(mean[name] for name in COLUMNS)
        frame = sum(run["frame_ms"][-run["timed"]:]) / run["timed"]
        skipped = int(pipe.state.skipped_tile_count)
        print(f"[staged] {label}: per-phase ms, mean of {run['timed']} "
              f"frames after {WARMUP_FRAMES} warm-up (CUDA events): " +
              ", ".join(f"{name} {mean[name]:.3f}" for name in COLUMNS) +
              f"; sum {fusion:.3f} against {frame:.3f} ms for the whole "
              f"frame (CUDA events, preprocessing included; "
              f"preprocessing {mean['preprocessing']:.3f} ms); "
              f"{skipped} skipped tiles")
        check(all(mean[name] > 0 for name in COLUMNS),
              f"[staged] {label}: a column is always zero")
        check(skipped == 0, f"[staged] {label}: {skipped} tiles skipped")
        check(states_equal(live_state(pipe.state), slice_run["state"]),
              f"[staged] {label}: state differs from [slice]'s unstaged run")
        print(f"[staged] {label}: final state bit-identical to [slice]'s "
              f"unstaged 500k run")
    print(f"[staged] phase wall {time.perf_counter() - t0:.1f} s")
    return means["500k"]


def phase_slice_wide(device, video, slice_run, staged) -> dict:
    """The slice at 640x480 / 500k with --measurement_blending_radius 48,
    every fused frame through the wide path: ms/frame beside [slice]'s,
    then staged, its blending column beside [staged]'s 500k one; -> the
    chunk kernels of the unstaged run."""
    t0 = time.perf_counter()
    run = run_slice(device, video,
                    slice_config(measurement_blending_radius=48))
    pipe, fused = run["pipe"], run["fused"]
    chunks = wide_chunks(48)
    print(f"[slice-r48] 640x480, 500k capacity, radius 48: {fused} frames "
          f"fused, wide-path calls {run['wide_launches']} ({run['wide_kernels']} "
          f"chunk kernels), one-launch {run['launches']}; surfel count "
          f"{pipe.surfel_count()}, {run['ms_frame']:.3f} ms/frame (CUDA "
          f"events over {run['timed']} frames) against [slice]'s "
          f"{slice_run['ms_frame']:.3f} at radius {slice_run['radius']}")
    check(pipe.surfel_count() > 0 and int(pipe.state.overflow_count) == 0,
          "[slice-r48] no surfels or an overflow")
    check(np.isfinite(live_pack(pipe)).all(), "[slice-r48] NaN/inf in live "
          "surfel rows")
    check((run["launches"], run["wide_launches"], run["wide_kernels"]) ==
          (0, fused, fused * chunks), f"[slice-r48] blending launches "
          f"{run['launches']} / {run['wide_launches']} / "
          f"{run['wide_kernels']} for {fused} frames")
    kernels = run["wide_kernels"]
    run = run_slice(device, video, slice_config(
        measurement_blending_radius=48, log_timings="timings.txt",
        log_timings_staged=True))
    mean = staged_means(run)
    print(f"[slice-r48] staged: blending column {mean['measurement_blending']:.3f} ms "
          f"(mean of {run['timed']} frames) against [staged] 500k's "
          f"{staged['measurement_blending']:.3f} at radius "
          f"{slice_run['radius']}; "
          f"phase wall {time.perf_counter() - t0:.1f} s")
    return dict(kernels=kernels, fused=fused, ms_frame=run["ms_frame"])


def phase_ab(device) -> None:
    """The A/B matrix's hostile subset on the card: occlusion and thin
    scenes on the look-away trajectory, the default and all-exact modes,
    160x120 over 8 frames; each cell within 5%."""
    t0 = time.perf_counter()
    matrix = AB.deviation_matrix(
        frames=8, width=160, height=120, capacity=65_536,
        scenes=("occlusion", "thin"), trajectories=("lookaway",),
        modes=(AB.MODES[0], AB.MODES[-1]), device=device)
    for key, row in matrix.items():
        rel = AB.max_rel_deviation(row)
        print(f"[ab] {key} at 160x120, 8 frames: tpu_defaults "
              f"{row['tpu_defaults']:.4f} mm, exact_all "
              f"{row['exact_all']:.4f} mm, max rel deviation "
              f"{100.0 * rel:.2f}%")
        check(rel <= 0.05, f"[ab] {key}: deviation {100.0 * rel:.2f}% > 5%")
    print(f"[ab] phase wall {time.perf_counter() - t0:.1f} s")


def start_fidelity(device, pool) -> dict:
    """The fidelity anchor at 160x120 over 50 frames, first part: the
    port's fusion on the card, the golden oracle started in `pool`."""
    t0 = time.perf_counter()
    run = fidelity_anchor.start_anchor(frames=50, width=160, height=120,
                                       capacity=65_536, device=device,
                                       pool=pool)
    run["wall_s"] = time.perf_counter() - t0
    return run


def phase_fidelity(run) -> None:
    """The fidelity anchor, last part: the port's mesh within 1 mm (mean)
    of the golden oracle's."""
    t0 = time.perf_counter()
    out = fidelity_anchor.finish_anchor(run)
    print(f"[fidelity] {json.dumps(out)}")
    print(f"[fidelity] 160x120, 50 frames: mesh mean distance "
          f"{out['value']} mm to the oracle's, completeness@1mm "
          f"{out['completeness_1mm']}; phase wall "
          f"{run['wall_s'] + time.perf_counter() - t0:.1f} s (the "
          f"oracle's host time ran beside the other phases)")
    check(out["value"] <= 1.0, f"[fidelity] mean distance {out['value']} mm")


def phase_build():
    t0 = time.perf_counter()
    builds = [lambda name=name: cuda_build.build(name)
              for name in KERNEL_SOURCES] + [engine.build_library]
    with ThreadPoolExecutor(len(builds)) as pool:
        paths = list(pool.map(lambda build: build(), builds))
    build_s = time.perf_counter() - t0
    blend.load_library()
    blend.load_wide_library()
    G.load_library()
    kernel_timing.load_l2_read_library()
    pp.load_library()
    A.load_library()
    I.load_library()
    engine.MeshingEngine()
    built = ", ".join(f"csrc/{name}.cu -> {path.name}"
                      for name, path in zip(KERNEL_SOURCES, paths))
    print(f"[build] {built} (nvcc, sm_90a), native/meshing_engine.cc -> "
          f"{paths[-1].name} (g++) in {build_s:.2f} s, one process per "
          f"source, started together")


GATHERS = (G.gather_rows, G.gather_rows3, G.gather_lane)


def bits_equal(a: torch.Tensor, b) -> bool:
    b = b if isinstance(b, torch.Tensor) else torch.from_numpy(b)
    return torch.equal(a.contiguous().cpu().view(torch.int32),
                       b.contiguous().cpu().view(torch.int32))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    both = torch.isfinite(a) & torch.isfinite(b)
    return float(torch.where(both, (a - b).abs(), 0.0).max())


def gather_bound(idx: torch.Tensor, sources: int) -> dict:
    """Each index read once, each gathered row of each source read once
    (the rows this run's indices touch) and each output row written
    once; no arithmetic."""
    n, rows = idx.numel(), torch.unique(idx).numel()
    return bound(4 * n + sources * G.COLS * 4 * (rows + n), 0)


def phase_gather(device):
    """-> {kernel name: its kernels-line numbers}."""
    for fn in GATHERS:
        fn.launches = 0
    probe = gather_probe.run_probe(device)
    launches = {fn.__name__: fn.launches for fn in GATHERS}
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched by the probe")
    src, _, _, idx = gather_probe.make_inputs(device)
    lane_src = src.t().contiguous().t()
    lane_plain = {
        "device_ms": kernel_timing.device_ms(
            lambda: G.gather_lane_reference(lane_src, idx)),
        "host_ms": kernel_timing.host_ms(
            lambda: G.gather_lane_reference(lane_src, idx), device)}
    print(f"[gather] probe at HW {gather_probe.HW} x {G.COLS}, N "
          f"{gather_probe.N}, ms a gather-step, device (CUDA graph of "
          f"{gather_probe.REPEATS}) / host-inclusive: " + ", ".join(
              f"{v} {t['device_ms']:.4f} / {t['host_ms']:.4f}"
              for v, t in probe.items()) +
          f", plain_lane {lane_plain['device_ms']:.4f} / "
          f"{lane_plain['host_ms']:.4f}; launches {launches}")

    errs = {fn.__name__: 0.0 for fn in GATHERS}
    for label, hw, n in (("probe sizes", gather_probe.HW, gather_probe.N),
                         ("N=1", 97, 1), ("N=257", 97, 257),
                         ("N=4099", 97, 4099),
                         ("N=4099", gather_probe.HW, 4099)):
        srcs, idx_np = gather_probe.special_inputs(hw, n, 7)
        want = [s[np.clip(idx_np, 0, hw - 1)] for s in srcs]
        srcs = [torch.from_numpy(s).to(device) for s in srcs]
        special = torch.from_numpy(idx_np).to(device)
        lane_srcs = [s.t().contiguous().t() for s in srcs]
        results = {
            "gather_rows": ([G.gather_rows(srcs[0], special)],
                            [G.gather_rows_reference(srcs[0], special)]),
            "gather_rows3": (list(G.gather_rows3(srcs, special)),
                             list(G.gather_rows3_reference(srcs, special))),
            "gather_lane": ([G.gather_lane(lane_srcs[0], special)],
                            [G.gather_lane_reference(lane_srcs[0],
                                                     special)]),
        }
        torch.cuda.synchronize()
        for name, (got, plain) in results.items():
            for g, p, w in zip(got, plain, want):
                check(bits_equal(p, w), f"{name} plain version differs from "
                      f"numpy src[clip(idx)] ({label})")
                check(bits_equal(g, p), f"{name} kernel differs from its "
                      f"plain version ({label})")
                errs[name] = max(errs[name], max_abs_err(g, p))
        print(f"[gather] {label} (HW {hw}, N {n}, special rows and "
              f"out-of-range indices): gather_rows, gather_rows3, "
              f"gather_lane bit-identical to their plain versions and to "
              f"numpy")
    lane, library_lane = (probe[v]["device_ms"]
                          for v in ("kernel_lane", "library_lane"))
    check(lane <= library_lane, f"gather_lane {lane:.4f} ms is slower than "
          f"torch.index_select(src_t, 1, idx) {library_lane:.4f} ms")
    l2_rate = kernel_timing.l2_read_bytes_per_s(device)
    n, hw = gather_probe.N, gather_probe.HW
    # The (8, HW) layout read directly: 8 sectors of 32 B for each index.
    direct_sectors = n * G.COLS * 32
    direct_ms = 1000.0 * direct_sectors / l2_rate
    # The committed two passes: the transpose reads and writes HW rows of
    # 32 B; the gather reads each index (4 B) and its row (one sector) and
    # writes 32 B of output.
    design_bytes = 2 * hw * 32 + n * (4 + 32 + 32)
    design_ms = 1000.0 * design_bytes / l2_rate
    print(f"[gather] L2 read rate {l2_rate / 1e12:.3f} TB/s (csrc/l2_read.cu, "
          f"16 MB L2-resident buffer read 8 times). gather_lane at the L2 "
          f"level: its two passes move {design_bytes} B through L2, bound "
          f"{design_ms:.5f} ms; the (8, HW) layout read directly would move "
          f"{direct_sectors} B of 32-B sectors, bound {direct_ms:.5f} ms "
          f"(the byte bound is at the device-memory level); gather_lane "
          f"{lane:.4f} ms against torch.index_select {library_lane:.4f} ms")
    variants = {"gather_rows": ("kernel", probe["plain"], "library", 1),
                "gather_rows3": ("kernel3", probe["plain3"], None, 3),
                "gather_lane": ("kernel_lane", lane_plain, "library_lane",
                                1)}
    out = {}
    for name, (kernel, plain, library, sources) in variants.items():
        times = probe[kernel]
        out[name] = dict(
            launches=launches[name], max_abs_err=errs[name],
            device_ms=times["device_ms"], host_ms=times["host_ms"],
            plain_ms=plain["device_ms"], plain_host_ms=plain["host_ms"],
            library_ms=probe[library]["device_ms"] if library else None,
            **gather_bound(idx, sources))
        print(f"[gather] {name}: device {times['device_ms']:.4f} ms against "
              f"bound {out[name]['bound_ms']:.5f} ms (bytes) and "
              + (f"torch.index_select {out[name]['library_ms']:.4f} ms"
                 if library else "no single PyTorch call"))
    out["gather_rows3"]["three_index_select_ms"] = \
        probe["library3"]["device_ms"]
    out["gather_lane"].update(
        l2_read_tb_per_s=l2_rate / 1e12, l2_bound_ms=design_ms,
        direct_layout_l2_sector_bound_ms=direct_ms)
    print(f"[gather] gather_rows3 beside three torch.index_select calls "
          f"(not one call, so no yardstick): "
          f"{probe['library3']['device_ms']:.4f} ms")
    return out


def peak_mib() -> str:
    return f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f}"


def snapshot_split(pipe, last_frame: int, window: int) -> str:
    """One delta snapshot taken apart: row selection and gather on the
    device, then the device-to-host copies, each timed on the host clock
    between synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    delta = F.meshing_snapshot_delta(pipe.state, last_frame, window)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for a in delta[:5]:
        a.cpu()
    t2 = time.perf_counter()
    return (f"one {delta[5]}-row delta: select + gather "
            f"{1000.0 * (t1 - t0):.3f} ms, device-to-host copies "
            f"{1000.0 * (t2 - t1):.3f} ms")


E2E_FRAMES = 40
E2E_CHUNK, E2E_WARMUP = 4, 8


def e2e_config(capacity: int, budget: int) -> SurfelMeshingConfig:
    return SurfelMeshingConfig(max_surfel_count=capacity,
                               max_creations_per_frame=2 ** 15,
                               active_surfel_budget=budget,
                               restrict_fps_to=0)


def run_e2e(device, cfg, label: str) -> dict:
    """tools/bench_e2e.py::run_config on the port (no XLA compile counter
    or rollback: nothing compiles inside the loop); blending- and
    tile-selection-kernel launches are counted over all its frames."""
    chunk, warmup = E2E_CHUNK, E2E_WARMUP
    video, _ = synthetic_rgbd_video(E2E_FRAMES, 640, 480, noise_sigma=0.002)
    torch.cuda.reset_peak_memory_stats()
    pipe = ReconstructionPipeline(cfg, video.depth_camera, device)
    mesher = MeshingDriver(cfg)
    half = cfg.outlier_filtering_frame_count // 2
    lo, hi = half, video.frame_count - half
    timed = range(lo + warmup, hi)
    tags, frames, budgets = [], [], []

    def submit(i):
        tagged = pipe.snapshot_for_meshing(i)
        tags.append(tagged[0])
        frames.append(i)
        mesher.submit_snapshot(tagged, i)

    def fuse(i):
        if pipe.process_frame(video, i) is None:
            return 0
        budgets.append(pipe.active_budget())
        return 1

    zero_launch_counts()
    fused = 0
    for i in range(lo, lo + warmup):
        fused += fuse(i)
        if (i - lo) % chunk == chunk - 1:
            submit(i)
            mesher.drain()
    pipe.block_until_ready()
    rows_before = pipe.snapshot_rows_shipped
    snaps_before = len(tags)
    captures_before = pipe.graph_captures
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in timed:
        fused += fuse(i)
        if mesher.idle():
            submit(i)
    end.record()
    pipe.block_until_ready()
    wall = time.perf_counter() - t0
    launches = blend.blend_core.launches
    tiled = tiling.tile_flags.launches
    preprocess = preprocess_counts(label)
    timed_captures = pipe.graph_captures - captures_before
    mesher.drain()
    tris = int(mesher.engine.triangle_count)
    last_mesh = mesher.peek_output()
    mesher.finish()
    peak = peak_mib()
    split = snapshot_split(pipe, frames[-1],
                           cfg.regularization_frame_window_size)
    snaps = len(tags) - snaps_before
    rows = pipe.snapshot_rows_shipped - rows_before
    surfels = pipe.surfel_count()
    ms_wall = 1000.0 * wall / len(timed)
    ms_events = start.elapsed_time(end) / len(timed)
    # A chunked run times preprocessing inside "integration".
    stages = ", ".join(
        f"{tag} " + ("in integration (chunked)" if st is None
                     else f"{1000.0 * st.mean:.3f}")
        for tag, st in (
            (tag, pipe.timing.stats(tag)) for tag in
            ("preprocessing", "integration", "surfel_transfer")))
    summary = (
        f"{len(timed)} timed frames after {warmup} warm-up; {ms_wall:.3f} "
        f"ms/frame host wall ({1000.0 / ms_wall:.2f} FPS), {ms_events:.3f} "
        f"ms/frame CUDA events; {snaps} snapshots in the timed frames "
        f"({tags.count('delta')} delta of {len(tags)} in all), {rows} rows "
        f"shipped, {tris} triangles, {surfels} surfels, overflow "
        f"{int(pipe.state.overflow_count)}; mean host ms per call over the "
        f"run: {stages}; {peak} MiB peak device memory allocated")
    check(tris > 0, f"{label}: no triangles")
    check("delta" in tags, f"{label}: no delta snapshot")
    check(rows < max(snaps, 1) * surfels,
          f"{label}: delta snapshots shipped as many rows as full ones")
    return dict(summary=summary, split=split, launches=launches, fused=fused,
                tiling=tiled, preprocess=preprocess,
                budgets=budgets, picks=[n for _, n in pipe.bucket_pick_log],
                chunks=[f for f, _ in pipe.bucket_pick_log],
                graph_captures=pipe.graph_captures,
                timed_captures=timed_captures,
                state=live_state(pipe.state),
                view=dict(mesh=last_mesh, camera=pipe.camera,
                          pose=video.depth_frames[frames[-1]].global_T_frame))


def phase_e2e(device) -> dict:
    """e2e at 500k, count-sized (budget 0): no tile selection."""
    run = run_e2e(device, e2e_config(500_000, 0), "e2e")
    print(f"[e2e] 640x480, 500k capacity, async meshing: {run['summary']}")
    print(f"[e2e] after the timed frames, {run['split']} (host clock); "
          f"{run['tiling']} tile selection launches")
    check(run["tiling"] == 0, f"e2e: {run['tiling']} tile selection "
          f"launches on the count-sized route")
    return run


def full_shape(cfg: SurfelMeshingConfig) -> SurfelMeshingConfig:
    """cfg with every frame over the whole capacity: a bucket step of
    max_surfel_count."""
    return dataclasses.replace(cfg, shape_bucket_step=cfg.max_surfel_count)


def run_20m(device, full: bool) -> dict:
    """4 frames of the 20M configuration without a budget after 1
    warm-up, no meshing, timed with CUDA events: count-sized, or over the
    whole capacity when `full`.  Blending counts are set to 0 just
    before."""
    cfg = e2e_config(SurfelMeshingConfig().max_surfel_count, 0)
    if full:
        cfg = full_shape(cfg)
    video, _ = synthetic_rgbd_video(E2E_FRAMES, 640, 480, noise_sigma=0.002)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    pipe = ReconstructionPipeline(cfg, video.depth_camera, device)
    lo = cfg.outlier_filtering_frame_count // 2
    pipe.process_frame(video, lo)                 # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    pipe.block_until_ready()
    t0 = time.perf_counter()
    start.record()
    for i in range(lo + 1, lo + 5):
        pipe.process_frame(video, i)
    end.record()
    pipe.block_until_ready()
    wall = time.perf_counter() - t0
    launches, wide = blend_counts()
    return dict(ms=start.elapsed_time(end) / 4, wall_ms=250.0 * wall,
                peak=peak_mib(), capacity=cfg.max_surfel_count,
                picks=[n for _, n in pipe.bucket_pick_log],
                launches=launches + wide, fused=5,
                count=pipe.surfel_count(), state=live_state(pipe.state))


def phase_e2e_20m(device, e2e) -> tuple:
    """e2e at the default 20M capacity with the auto active-set budget,
    held to e2e's final state; then 4 full-shape 20M frames (budget 0, a
    bucket step of the capacity), timed; -> (the tiled run, that
    full-shape run)."""
    capacity = SurfelMeshingConfig().max_surfel_count
    run = run_e2e(device, e2e_config(capacity, -1), "e2e-20m")
    state = run["state"]
    skipped = int(state["skipped_tile_count"])
    budgets = sorted(set(run["budgets"]))
    print(f"[e2e-20m] 640x480, {capacity} capacity, auto active-set budget "
          f"(-1), async meshing: {run['summary']}")
    print(f"[e2e-20m] budgets used {budgets}; final active tiles "
          f"{int(state['active_tile_count'])}, skipped tiles {skipped}; "
          f"{run['launches']} blend and {run['tiling']} tile selection "
          f"launches for {run['fused']} fused frames; {run['split']} (host "
          f"clock)")
    check(skipped == 0, f"e2e-20m: {skipped} tiles skipped")
    check(run["launches"] == run["fused"], f"e2e-20m: {run['launches']} "
          f"blend launches for {run['fused']} fused frames")
    check(run["tiling"] == run["fused"], f"e2e-20m: {run['tiling']} tile "
          f"selection launches for {run['fused']} fused frames")
    want = e2e["state"]
    check(states_equal(state, want), "e2e-20m: final state differs from "
          "e2e's")
    print(f"[e2e-20m] final pack, neighbors, nbr_dist and counters "
          f"bit-identical to e2e's 500k run ({int(want['surfel_count'])} "
          f"surfels)")

    # For the record: every pass over the 20M rows.
    full = run_20m(device, full=True)
    print(f"[e2e-20m] full shape (budget 0, bucket step {full['capacity']}) "
          f"at {full['capacity']} capacity, "
          f"no meshing: {full['ms']:.3f} ms/frame CUDA events over 4 frames "
          f"after 1 warm-up (host wall {full['wall_ms']:.3f} ms/frame), "
          f"{full['count']} surfels, {full['peak']} MiB peak device memory "
          f"allocated")
    return run, full


def run_bench(smoke: bool) -> tuple:
    """`python -m surfelmeshing_tpu_torch.bench` in a process of its own
    (SM_BENCH_SMOKE=1 SM_BENCH_CHECK=1 when `smoke`); -> (its JSON lines,
    the blending launches it reported for its timed region)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    if smoke:
        env.update(SM_BENCH_SMOKE="1", SM_BENCH_CHECK="1")
    run = subprocess.run(
        [sys.executable, "-m", "surfelmeshing_tpu_torch.bench", "--device",
         "cuda"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=600)
    label = "bench smoke" if smoke else "bench"
    check(run.returncode == 0, f"{label} exited with {run.returncode}: "
          f"{run.stderr[-2000:]}")
    lines = [json.loads(line) for line in run.stdout.splitlines()]
    err = run.stderr.splitlines()
    for line in lines:
        print(f"[bench] {label}: {json.dumps(line)}")
    for line in err:
        print(f"[bench] {label} stderr: {line}")
    timed = int(re.search(r"(\d+) timed frames", run.stderr).group(1))
    launches = int(re.search(r"blend launches in the timed region (\d+)",
                             run.stderr).group(1))
    preprocess = json.loads(re.search(
        r"preprocessing launches in the timed region (\{[^}]*\})",
        run.stderr).group(1))
    built = int(re.search(r"builds in the timed region (\d+)",
                          run.stderr).group(1))
    metric = lines[-1]
    check(set(metric) == {"metric", "value", "unit", "vs_baseline",
                          "graph_captures"},
          f"{label}: last stdout line {metric}")
    check(metric["metric"] == ("SMOKE_" if smoke else "") +
          "fusion_fps_640x480_500k" and metric["value"] > 0,
          f"{label}: metric line {metric}")
    check(launches == timed, f"{label}: {launches} blend launches for "
          f"{timed} timed frames")
    check(preprocess == dict.fromkeys(pp.KERNELS, timed), f"{label}: "
          f"preprocessing launches {preprocess} for {timed} timed frames")
    check(built == 0, f"{label}: {built} builds in the timed region")
    return lines, launches, preprocess


def bench_tool(main, argv) -> list:
    """One of the port's bench tools in-process through main(argv), its
    JSON lines printed with the phase's prefix; launch counts set to 0
    just before and checked just after: one blending launch and one of
    each preprocessing kernel a fused frame."""
    out = io.StringIO()
    zero_launch_counts()
    with contextlib.redirect_stdout(out):
        results = main(["--device", "cuda", *argv])
    launches = blend.blend_core.launches
    name = main.__module__.rsplit(".", 1)[1]
    for line in out.getvalue().splitlines():
        print(f"[bench] {name}: {line}")
    fused = sum(r["fused_frames"] for r in results)
    check(launches == fused == sum(r["blend_launches"] for r in results),
          f"{name}: {launches} blend launches for {fused} fused frames")
    preprocess, reported = preprocess_counts(name), {}
    for r in results:
        reported = add_counts(reported, r["preprocess_launches"])
    check(preprocess == reported, f"{name}: preprocessing launches "
          f"{preprocess}, {reported} in its results")
    return results


def phase_bench(device) -> dict:
    """The port's bench entry points: bench.py (a process of its own, then
    its smoke mode with the CPU audit), bench_e2e (500k, 20m:-1) and
    bench_configs (500k, 2m:2m, 20m:2m on the arc trajectory)
    in-process.  -> the blending launches and each preprocessing kernel's
    launches of each."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    _, bench_launches, bench_pp = run_bench(smoke=False)
    smoke, smoke_launches, smoke_pp = run_bench(smoke=True)
    audit = smoke[0]["smoke_check"]
    check(audit["count_equal"] and audit["pack_equal"],
          f"bench smoke: the card's state differs from the CPU replay "
          f"{audit}")
    e2e = bench_tool(bench_e2e.main, ["500k", "20m:-1"])
    for r in e2e:
        check(r["compiles_in_timed_region"] == 0,
              f"bench_e2e {r['config']}: builds in the timed region")
        check(r["triangles"] > 0, f"bench_e2e {r['config']}: no triangles")
    check(e2e[1]["skipped_tiles"] == 0,
          f"bench_e2e 20m:-1: {e2e[1]['skipped_tiles']} tiles skipped")
    sweep = bench_tool(bench_configs.main,
                       ["--trajectory", "arc", "500k", "2m:2m", "20m:2m"])
    launches = dict(bench=bench_launches, bench_smoke=smoke_launches,
                    bench_e2e=sum(r["blend_launches"] for r in e2e),
                    bench_configs=sum(r["blend_launches"] for r in sweep))
    preprocess = dict(bench=bench_pp, bench_smoke=smoke_pp)
    for tool, results in (("bench_e2e", e2e), ("bench_configs", sweep)):
        preprocess[tool] = {}
        for r in results:
            preprocess[tool] = add_counts(preprocess[tool],
                                          r["preprocess_launches"])
    print(f"[bench] blending-kernel launches, one a fused frame: "
          f"{launches}; preprocessing-kernel launches, one of each a fused "
          f"frame: {preprocess}; phase wall "
          f"{time.perf_counter() - t0:.1f} s")
    return dict(launches=launches, preprocess=preprocess)


class _LogLines(logging.Handler):
    """Collects the formatted records of one logger."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def run_app(device, flags, checkpoint: bool) -> dict:
    """The port's application over the real-format fixture at 640x480 with
    `flags`, from a temporary directory; -> outputs and log lines."""
    logger = logging.getLogger("surfelmeshing_tpu_torch")
    handler, level = _LogLines(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        cwd = os.getcwd()
        os.chdir(tmp)
        t0 = time.perf_counter()
        try:
            rc = app_main.main([
                "--device", str(device), *flags,
                "--pyramid_level", "0", "--outlier_filtering_frame_count",
                "2", "--depth_erosion_radius", "1", "--restrict_fps_to",
                "0", "--exit_after_processing",
                "--export_mesh", str(out / "mesh.obj"),
                "--export_point_cloud", str(out / "cloud.ply"),
                *(["--save_checkpoint", str(out / "ckpt.npz")]
                  if checkpoint else []),
                str(FIXTURE), "groundtruth.txt"])
        finally:
            os.chdir(cwd)
            logger.removeHandler(handler)
            logger.setLevel(level)
        seconds = time.perf_counter() - t0
        check(rc == 0, f"app exited with {rc}")
        obj = (out / "mesh.obj").read_text()
        ply = (out / "cloud.ply").read_bytes()
        state = load_checkpoint(str(out / "ckpt.npz"), "cpu") \
            if checkpoint else None
        frame_pngs = len(list(out.glob("frame*.png")))
        input_pngs = len(list(out.glob("input_images/*.png")))
    faces = [line.split()[1:] for line in obj.splitlines()
             if line.startswith("f ")]
    return dict(rc=rc, seconds=seconds, faces=len(faces),
                triangles=np.array(faces, np.int64).reshape(-1, 3) - 1,
                vertices=obj.count("\nv ") + obj.startswith("v "), ply=ply,
                points=int(ply.split(b"element vertex ")[1].split(b"\n")[0]),
                state=state, log=handler.lines, frame_pngs=frame_pngs,
                input_pngs=input_pngs)


def phase_app(device) -> dict:
    """The app at 500k capacity; -> its run (point cloud bytes, state)."""
    app = run_app(device, ["--max_surfel_count", "500000"], checkpoint=True)
    state, frame = app["state"]
    count = int(state.surfel_count)
    live = int((state.pack[:count, F.RAD] >= 0).sum())
    print(f"[app] tum_micro at 640x480, async meshing: rc {app['rc']} in "
          f"{app['seconds']:.2f} s; OBJ {app['faces']} faces, "
          f"{app['vertices']} vertices; PLY {app['points']} points; "
          f"checkpoint frame {frame}, {count} surfels ({live} live)")
    check(app["faces"] > 50, "app: OBJ has 50 faces or fewer")
    check(app["points"] > 0, "app: empty PLY")
    check(live == app["points"] == app["vertices"],
          "app: checkpoint, PLY and OBJ disagree on the live surfel count")
    return app


def phase_app_20m(device, ply: bytes) -> None:
    """The app at the default capacity with the auto active-set budget."""
    app = run_app(device, ["--active_surfel_budget", "-1"], checkpoint=False)
    tiling = [line for line in app["log"] if "active-set tiling" in line]
    print(f"[app-20m] tum_micro at 640x480, default capacity, "
          f"--active_surfel_budget -1, async meshing: rc {app['rc']} in "
          f"{app['seconds']:.2f} s; OBJ {app['faces']} faces (not compared: "
          f"meshing timing), PLY {app['points']} points, byte-identical to "
          f"app's: {app['ply'] == ply}; log: {tiling}")
    check(tiling == ["active-set tiling: 0 tiles skipped over the run"],
          "app-20m: the log does not report 0 skipped tiles")
    check(app["ply"] == ply, "app-20m: PLY differs from app's")


BUSY_FRAMES = 8


def bench_rounds(device, variants: dict, n_frames: int,
                 alone: str = None) -> dict:
    """bench.py's video (bench.setup) and its first `n_frames` timed
    frames under each named variant of bench.py's config (a function of
    it): one pipeline each after bench.py's
    untimed prefetch and warm-up and one untimed round (graphs captured
    there), then replayed from a dispatch-state snapshot, restored and
    prefetched outside each window: the frame loop and its drain between
    CUDA events and on the host clock in turns (the configs in order,
    then reversed), then once each under torch.profiler (busy_ms).  Peak
    memory allocated: each round's (every pipeline resident; a replay
    allocates nothing, so it leaves out the graphs' pool) and each
    setup's (warm-up, captures, untimed round; "resident": what earlier
    setups left).  The `alone` config is set up first and timed once more
    before the others exist.  Blending and preprocessing launches are
    counted per config over all its runs.  -> {name: dict(pipe, ms, wall,
    peak, setup_peak, busy, state, picks, launches, preprocess, fused,
    frames, timed_captures, alone)}."""
    video, cfg, lo, hi, timed = bench.setup(smoke=False)
    cfgs = {name: make(cfg) for name, make in variants.items()}
    frames = timed[:n_frames]
    runs = {}

    def prepare(name):
        pipe = runs[name]["pipe"]
        pipe.restore_dispatch_state(runs[name]["snap"])
        pipe.prefetch_inputs(video, frames[0], hi)
        torch.cuda.synchronize()

    def replay(name):
        pipe = runs[name]["pipe"]
        for i in frames:
            pipe.process_frame(video, i)
        pipe.drain()

    def counted(name, run):
        zero_launch_counts()
        run()
        runs[name]["launches"] += blend.blend_core.launches
        runs[name]["preprocess"] = add_counts(
            runs[name]["preprocess"], preprocess_counts(f"[{name}]"))
        runs[name]["fused"] += len(frames)

    def timed_round(name):
        prepare(name)
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        counted(name, lambda: replay(name))
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return (start.elapsed_time(end) / len(frames),
                1000.0 * wall / len(frames), peak_mib())

    for name in sorted(cfgs, key=lambda n: n != alone):
        resident = torch.cuda.memory_allocated() / 2 ** 20
        torch.cuda.reset_peak_memory_stats()
        pipe = ReconstructionPipeline(cfgs[name], video.depth_camera, device)
        pipe.prefetch_inputs(video, lo, hi)
        for i in range(lo, timed[0]):
            pipe.process_frame(video, i)
        runs[name] = dict(pipe=pipe, snap=pipe.snapshot_dispatch_state(),
                          ms=[], wall=[], peak=[], launches=0, fused=0,
                          preprocess={}, frames=len(frames))
        prepare(name)
        counted(name, lambda: replay(name))
        runs[name]["setup_peak"] = \
            f"{peak_mib()} ({resident:.1f} resident)"
        runs[name]["captures"] = pipe.graph_captures
        if name == alone:
            runs[name]["alone"] = timed_round(name)
    for name in list(cfgs) + list(cfgs)[::-1]:
        ms, wall, peak = timed_round(name)
        runs[name]["ms"].append(ms)
        runs[name]["wall"].append(wall)
        runs[name]["peak"].append(peak)
    for name, run in runs.items():
        run["timed_captures"] = run["pipe"].graph_captures - run["captures"]
        prepare(name)
        pipe = run["pipe"]
        picks = len(pipe.bucket_pick_log)
        busy = {}
        counted(name, lambda: busy.update(
            busy_ms({name: lambda: replay(name)})))
        run["busy"] = None if busy[name] is None else \
            busy[name] / len(frames)
        run["state"] = live_state(pipe.state)
        run["picks"] = pipe.bucket_pick_log[picks:]
    return runs


def phase_buckets(device, e2e, full, app) -> int:
    """Count-sized dispatch (budget 0) against full shape (a bucket step
    of the capacity): the 20M frames count-sized against [e2e-20m]'s full-
    shape ones, [e2e]'s loop (count-sized) full shape, the app full shape
    against [app]'s point cloud, and bench.py's frames' device-busy time
    in both; every fused frame launches the blending kernel once.  -> the
    blending launches of the phase's runs."""
    t0 = time.perf_counter()
    run = run_20m(device, full=False)
    equal = states_equal(run["state"], full["state"])
    print(f"[buckets] 20M budget 0 count-sized: {run['ms']:.3f} ms/frame "
          f"CUDA events over 4 frames after 1 warm-up (host wall "
          f"{run['wall_ms']:.3f}), {run['peak']} MiB peak device memory "
          f"allocated, picks {run['picks']}; full shape {full['ms']:.3f} "
          f"ms/frame, {full['peak']} MiB; states bit-identical: {equal}; "
          f"{run['launches']} blend launches for {run['fused']} fused "
          f"frames")
    check(equal, "[buckets] 20M count-sized state differs from the "
          "full-shape one")
    check(run["launches"] == run["fused"], f"[buckets] 20M: "
          f"{run['launches']} blend launches for {run['fused']} frames")
    check(max(run["picks"]) < run["capacity"],
          f"[buckets] 20M picks {run['picks']} reach the capacity")
    launches = run["launches"]

    e2e_f = run_e2e(device, full_shape(e2e_config(500_000, 0)),
                    "buckets-e2e-full")
    equal = states_equal(e2e_f["state"], e2e["state"])
    print(f"[buckets] e2e 500k full shape: {e2e_f['summary']}")
    print(f"[buckets] e2e picks, count-sized {e2e['picks']}, full shape "
          f"{sorted(set(e2e_f['picks']))}; final state bit-identical to "
          f"[e2e]'s: {equal}; {e2e_f['launches']} blend launches for "
          f"{e2e_f['fused']} fused frames")
    check(equal, "[buckets] e2e full-shape state differs from [e2e]'s")
    check(e2e_f["launches"] == e2e_f["fused"],
          f"[buckets] e2e: {e2e_f['launches']} blend launches for "
          f"{e2e_f['fused']} fused frames")
    check(max(e2e["picks"]) < 500_000,
          f"[buckets] [e2e]'s picks {e2e['picks']} reach the capacity")
    launches += e2e_f["launches"]

    zero_launch_counts()
    run_f = run_app(device, ["--max_surfel_count", "500000",
                             "--shape_bucket_step", "500000",
                             "--use_shape_buckets"], checkpoint=False)
    app_launches, wide = blend_counts()
    used = [[line for line in r["log"] if "shape buckets used" in line]
            for r in (app, run_f)]
    fused = int(re.search(r"integration: total \S+\s+count (\d+)",
                          "\n".join(run_f["log"])).group(1))
    print(f"[buckets] app full shape (--shape_bucket_step 500000; "
          f"--use_shape_buckets accepted) on tum_micro: rc {run_f['rc']} in "
          f"{run_f['seconds']:.2f} s; {used[1]}; [app]'s {used[0]}; PLY "
          f"byte-identical to [app]'s: {run_f['ply'] == app['ply']}; "
          f"{app_launches} blend launches for {fused} fused frames")
    check(run_f["ply"] == app["ply"], "[buckets] app PLY differs from "
          "[app]'s")
    check(used[1] == ["shape buckets used: [500000]"] and len(used[0]) == 1,
          "[buckets] app bucket log")
    check(app_launches == fused and wide == 0, f"[buckets] app: "
          f"{app_launches} blend launches for {fused} fused frames")
    launches += app_launches

    # Per-frame dispatch (frame_chunk 1), as this phase first measured it;
    # [chunk] runs bench.py's chunk.
    def per_frame(cfg):
        return dataclasses.replace(cfg, frame_chunk=1)

    busy = bench_rounds(device, {
        "count-sized": per_frame,
        "full shape": lambda cfg: full_shape(per_frame(cfg))}, BUSY_FRAMES)
    for (mode, b), rounds in zip(busy.items(), ("1 and 4", "2 and 3")):
        ms = sum(b["ms"]) / len(b["ms"])
        print(f"[buckets] bench.py frames, {mode}: "
              f"{' / '.join(f'{x:.3f}' for x in b['ms'])} ms/frame CUDA "
              f"events over the frame loop and its drain (rounds {rounds} "
              f"of 4), device busy {fmt_busy(b['busy'], ms)} a frame over "
              f"{BUSY_FRAMES} timed frames; picks "
              f"{[n for _, n in b['picks']]}")
        check(b["launches"] == b["fused"], f"[buckets] bench frames, "
              f"{mode}: {b['launches']} blend launches for {b['fused']} "
              f"fused frames")
        launches += b["launches"]
    print(f"[buckets] phase wall {time.perf_counter() - t0:.1f} s")
    return launches


CHUNK_FRAMES = 24     # bench.py's timed frames


def phase_chunk(device, video, e2e, app) -> dict:
    """Chunked dispatch (--frame_chunk K, one CUDA-graph replay a
    sub-chunk) against per-frame dispatch: bench.py's frames at K = 4 and
    1 in turns (states bit-identical, ms/frame, busy, idle share, peak
    memory); bench_e2e's 20m:-1 loop chunked (0 skipped tiles, state
    equal to [e2e]'s, which [e2e-20m] equals); the app with --frame_chunk
    3 (PLY equal to [app]'s); symmetric_regularization=False chunked on
    the slice video (eager on the card: no graph), bit-identical to
    per-frame.  One blending launch and one of each preprocessing kernel
    a fused frame, replays included.  -> the blending launches and each
    preprocessing kernel's launches of the chunked runs."""
    t0 = time.perf_counter()
    runs = bench_rounds(device, {
        "K4": lambda cfg: cfg,
        "K1": lambda cfg: dataclasses.replace(cfg, frame_chunk=1)},
        CHUNK_FRAMES, alone="K1")
    k4, k1 = runs["K4"], runs["K1"]
    pipe = k4["pipe"]
    check(pipe.config.frame_chunk == bench.CHUNK == 4,
          f"[chunk] bench.py runs frame_chunk {pipe.config.frame_chunk}")
    equal = states_equal(k4["state"], k1["state"])
    print(f"[chunk] bench.py's {k4['frames']} timed frames at 640x480 / "
          f"500k, K=4: "
          f"{pipe.graph_captures} graphs captured (frames, n_eff, budget) "
          f"{pipe.graph_keys} in {pipe.graph_capture_s:.3f} s host "
          f"(warm-ups included), {k4['timed_captures']} in the timed "
          f"rounds; {pipe.graph_replays} replays; final state bit-identical "
          f"to K=1's: {equal}")
    alone = k1["alone"]
    print(f"[chunk] K1 alone, before the K=4 pipeline existed: "
          f"{alone[0]:.3f} ms/frame CUDA events, {alone[1]:.3f} host wall, "
          f"peak {alone[2]} MiB allocated")
    for mode, rounds in (("K4", "1 and 4"), ("K1", "2 and 3")):
        r = runs[mode]
        ms = sum(r["ms"]) / len(r["ms"])
        events, wall = (" / ".join(f"{x:.3f}" for x in r[k])
                        for k in ("ms", "wall"))
        print(f"[chunk] {mode}: {events} ms/frame CUDA events, {wall} "
              f"host wall over the frame loop and its drain (rounds "
              f"{rounds} of 4); device busy {fmt_busy(r['busy'], ms)} a "
              f"frame; peak {' / '.join(r['peak'])} MiB allocated in the "
              f"rounds (both maps resident), {r['setup_peak']} MiB over "
              f"its setup; {r['launches']} blend launches for "
              f"{r['fused']} fused frames; picks (frames, n_eff) "
              f"{r['picks']}")
        check(r["launches"] == r["fused"], f"[chunk] {mode}: "
              f"{r['launches']} blend launches for {r['fused']} frames")
    check(equal, "[chunk] K=4 state differs from K=1's")
    check(pipe.graph_captures > 0 and pipe.graph_replays > 0,
          "[chunk] no CUDA graph captured or replayed")
    launches, preprocess = k4["launches"], k4["preprocess"]

    capacity = SurfelMeshingConfig().max_surfel_count
    run = run_e2e(device, dataclasses.replace(e2e_config(capacity, -1),
                                              frame_chunk=E2E_CHUNK),
                  "chunk-e2e-20m")
    skipped = int(run["state"]["skipped_tile_count"])
    equal = states_equal(run["state"], e2e["state"])
    print(f"[chunk] e2e 20m:-1 with frame_chunk {E2E_CHUNK}: "
          f"{run['summary']}; sub-chunks {run['chunks']}; graphs captured "
          f"{run['graph_captures']}, {run['timed_captures']} of them (each "
          f"with a warm-up on a copy of the map) in the timed frames; "
          f"skipped tiles {skipped}; "
          f"{run['launches']} blend launches for "
          f"{run['fused']} fused frames; final state bit-identical to "
          f"[e2e]'s (and so [e2e-20m]'s): {equal}")
    check(skipped == 0, f"[chunk] e2e 20m:-1: {skipped} tiles skipped")
    check(equal, "[chunk] e2e 20m:-1 chunked state differs from [e2e]'s")
    check(run["launches"] == run["fused"], f"[chunk] e2e 20m:-1: "
          f"{run['launches']} blend launches for {run['fused']} frames")
    launches += run["launches"]
    preprocess = add_counts(preprocess, run["preprocess"])

    sizes = []
    chunk_run = chunk_module.ChunkStep.run

    def counted_run(self, state, entries, params, n_eff):
        sizes.append(len(entries))
        return chunk_run(self, state, entries, params, n_eff)

    chunk_module.ChunkStep.run = counted_run
    zero_launch_counts()
    try:
        app3 = run_app(device, ["--max_surfel_count", "500000",
                                "--frame_chunk", "3"], checkpoint=False)
    finally:
        chunk_module.ChunkStep.run = chunk_run
    app_launches, _ = blend_counts()
    preprocess = add_counts(preprocess, preprocess_counts("[chunk] app"))
    print(f"[chunk] app --frame_chunk 3 on tum_micro: rc {app3['rc']} in "
          f"{app3['seconds']:.2f} s ([app] {app['seconds']:.2f} s); "
          f"sub-chunks {sizes}; PLY byte-identical to [app]'s: "
          f"{app3['ply'] == app['ply']}; {app_launches} blend launches for "
          f"{sum(sizes)} fused frames")
    check(app3["ply"] == app["ply"], "[chunk] app PLY differs from [app]'s")
    check(app_launches == sum(sizes) > 0,
          f"[chunk] app: {app_launches} blend launches, sub-chunks {sizes}")
    launches += app_launches

    modes = dict(symmetric_regularization=False)
    exact = {}
    for chunk in (4, 1):
        pipe = ReconstructionPipeline(slice_config(frame_chunk=chunk),
                                      video.depth_camera, device)
        pipe.fusion_params = dataclasses.replace(pipe.fusion_params, **modes)
        zero_launch_counts()
        for i in range(video.frame_count):
            pipe.process_frame(video, i)
        pipe.drain()
        exact[chunk] = dict(state=live_state(pipe.state),
                            launches=blend.blend_core.launches,
                            preprocess=preprocess_counts(
                                f"[chunk] exact K={chunk}"),
                            graphs=pipe.graph_captures,
                            graph=chunk > 1 and
                            pipe._chunk.graphs_for(pipe.fusion_params),
                            picks=[f for f, _ in pipe.bucket_pick_log])
    equal = states_equal(exact[4]["state"], exact[1]["state"])
    fused = sum(exact[4]["picks"])
    print(f"[chunk] slice with symmetric_regularization=False, K=4: graph "
          f"{str(exact[4]['graph']).lower()} (eager on the card), "
          f"{exact[4]['graphs']} captures, sub-chunks {exact[4]['picks']}; "
          f"{exact[4]['launches']} blend launches for {fused} fused frames; "
          f"state bit-identical to K=1's: {equal}")
    check(not exact[4]["graph"] and exact[4]["graphs"] == 0,
          "[chunk] symmetric_regularization=False was captured")
    check(equal, "[chunk] symmetric_regularization=False chunked state "
          "differs from per-frame")
    check(exact[4]["launches"] == fused, f"[chunk] exact regularization: "
          f"{exact[4]['launches']} blend launches for {fused} frames")
    launches += exact[4]["launches"]
    preprocess = add_counts(preprocess, exact[4]["preprocess"])
    print(f"[chunk] {launches} blend launches and preprocessing launches "
          f"{preprocess} over the chunked runs; phase wall "
          f"{time.perf_counter() - t0:.1f} s")
    return dict(launches=launches, preprocess=preprocess)


VIDEO_W, VIDEO_H = 1280, 720
COLOUR_MODES = ("color", "timestamp", "creation", "radius", "normals")


def video_scene(seed: int) -> dict:
    """A seeded scene for a 1280x720 render (772 pixels a metre at 1 m):
    triangles of each mesh size class (about 2, 12-48 and 48-192 pixels
    across at 2-4 m) and one of extent >= 192 that no pass draws, NaN
    vertices, splats with NaN points, two line sets, and per-vertex
    attributes for the colour modes; host arrays."""
    rng = np.random.default_rng(seed)

    def triangles(n, size):
        centres = np.stack([rng.uniform(-1.2, 1.2, n),
                            rng.uniform(-0.7, 0.7, n),
                            rng.uniform(2.0, 4.0, n)], 1)
        return (centres[:, None] + rng.uniform(-size, size, (n, 3, 3))
                ).reshape(-1, 3)

    vertices = np.concatenate([
        triangles(3000, 0.004), triangles(300, 0.05), triangles(30, 0.25),
        [[-6, -4, 2.5], [6, -4, 2.6], [0, 5, 2.4]]]).astype(np.float32)
    vertices[rng.choice(len(vertices), 50, replace=False)] = np.nan
    n = len(vertices)
    splats = np.stack([rng.uniform(-1.3, 1.3, 4000),
                       rng.uniform(-0.8, 0.8, 4000),
                       rng.uniform(1.5, 4.5, 4000)], 1).astype(np.float32)
    splats[rng.choice(4000, 40, replace=False), 0] = np.nan
    segments = np.stack([vertices[:600], vertices[600:1200]], 1)
    normals = rng.standard_normal((n, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return dict(
        vertices=vertices, triangles=np.arange(n).reshape(-1, 3),
        colors=rng.integers(0, 256, (n, 3)).astype(np.uint8),
        stamps=rng.integers(0, 40, n).astype(np.int32),
        creation=rng.integers(0, 40, n).astype(np.int32),
        radii_sq=rng.uniform(-1e-5, 2e-4, n).astype(np.float32),
        normals=normals, splats=splats,
        splat_colors=rng.integers(0, 256, (4000, 3)).astype(np.uint8),
        red=segments[~np.isnan(segments).any(axis=(1, 2))],
        blue=np.stack([splats[:500], splats[:500] + 0.05], 1))


def scene_renders(scene: dict, device):
    """The seeded scene on `device` in each colour mode and with normal
    shading; -> [(label, (H, W, 3) u8 image on the host)]."""
    t = {k: torch.from_numpy(v).to(device) for k, v in scene.items()}
    renderer = R.Renderer(VIDEO_W, VIDEO_H, device=device)
    camera = read_tum_rgbd_dataset(str(FIXTURE), "groundtruth.txt",
                                   0.05).depth_camera
    out = []
    for mode, shading in [(m, False) for m in COLOUR_MODES] + \
            [("color", True)]:
        cols = R.surfel_colors(mode, t["colors"], t["stamps"], t["creation"],
                               t["radii_sq"], t["normals"], 37,
                               active_window=20)
        img = renderer.render(
            SE3(q=[0.03, -0.05, 0.01, 0.998], t=[0.1, 0.05, -0.2]),
            mesh_vertices=t["vertices"], mesh_colors=cols,
            mesh_triangles=t["triangles"], triangle_normal_shading=shading,
            splat_points=t["splats"], splat_colors=t["splat_colors"],
            splat_half_extent=3.0, frustum_pose=SE3(t=[0.0, 0.0, 1.0]),
            frustum_camera=camera,
            line_sets=[(t["red"], (255, 0, 0)), (t["blue"], (0, 0, 255))])
        out.append((mode + (" + normal shading" if shading else ""),
                    img.cpu().numpy()))
    return out


def app_view(app: dict, device) -> dict:
    """app's final state (checkpoint) with its mesh (the OBJ's faces) as
    the video writer renders it, following the input camera: render
    arguments on `device` and the view pose."""
    state, frame = app["state"]
    count = int(state.surfel_count)
    positions, colors = F.export_vertices(state)
    alive = ~torch.isnan(positions[:count, 0])
    video = read_tum_rgbd_dataset(
        str(FIXTURE), "groundtruth.txt",
        SurfelMeshingConfig().max_pose_interpolation_time_extent)
    pose = video.depth_frames[frame].global_T_frame
    return dict(pose=pose, args=dict(
        mesh_vertices=positions[:count][alive].to(device),
        mesh_colors=colors[:count][alive].to(device),
        mesh_triangles=torch.from_numpy(app["triangles"]).to(device),
        splat_points=positions[count - 2000:count].to(device),
        splat_colors=colors[count - 2000:count].to(device),
        splat_half_extent=3.0, frustum_pose=pose,
        frustum_camera=video.depth_camera))


def elapsed_ms(render, repeats: int) -> float:
    """Mean stream time of `render()` between CUDA events around `repeats`
    calls after one: host dispatch and the renderer's host waits (index
    bounds, nonzero, boolean masks) included."""
    render()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        render()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def busy_ms(renders: dict) -> dict:
    """Device busy ms of one call of each named render: the union of the
    kernel, copy and set intervals in one torch.profiler trace, each
    render in a range of its name that ends after a synchronisation; None
    for a render whose range holds no device event.  One trace for all,
    read from its raw events: each trace and the profiler's own event
    list are slow to build."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for name, render in renders.items():
            with torch.profiler.record_function(name):
                render()
                torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    device = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
              if e.device_type() == cuda and not e.is_user_annotation()
              and e.name() not in renders]
    out = {}
    for name in renders:
        ranges = [(e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in events
                  if e.name() == name and e.device_type() != cuda]
        spans = sorted(r for r in device
                       if ranges and ranges[0][0] <= r[0] <= ranges[0][1])
        busy_ns, reach = 0, -1
        for lo, hi in spans:
            busy_ns += max(0, hi - max(lo, reach))
            reach = max(reach, hi)
        out[name] = busy_ns / 1e6 if spans else None
    return out


def fmt_busy(busy, elapsed: float) -> str:
    if busy is None:
        return "not measured (no device event in its trace range)"
    return f"{busy:.3f} ms (idle share {1 - busy / elapsed:.3f})"


def differing_pixels(a: np.ndarray, b: np.ndarray) -> int:
    return int((a != b).any(axis=2).sum())


def phase_video(device, e2e, app) -> dict:
    """The renderer on the card against the CPU, its time on e2e's state
    and the app with --create_video; -> the app's blending launches."""
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    scene = video_scene(9)
    diffs = [(label, differing_pixels(g, c)) for (label, g), (_, c) in zip(
        scene_renders(scene, device), scene_renders(scene, cpu))]
    points = torch.from_numpy(np.concatenate(
        [scene["vertices"], scene["splats"]])).to(torch.float64)
    rt = torch.from_numpy(SE3(q=[0.03, -0.05, 0.01, 0.998]).inverse()
                          .rotation_matrix.T.copy())
    card = R._fma_chain(points.to(device), rt.to(device)).cpu().numpy()
    host = points.numpy() @ rt.numpy()
    proj_diff = int((card.view(np.int64) != host.view(np.int64)).sum())
    print(f"[video] seeded scene at {VIDEO_W}x{VIDEO_H} "
          f"({len(scene['triangles'])} triangles in every size class, "
          f"{len(scene['splats'])} splats, frustum, two line sets): pixels "
          f"differing between the card and the CPU: " +
          ", ".join(f"{label} {n}" for label, n in diffs) +
          f"; projection float64 elements differing {proj_diff} of "
          f"{host.size} (the card's emulated FMA chain against numpy's "
          f"`points @ R.T` on the host)")
    check(all(n == 0 for _, n in diffs), "[video] GPU and CPU images of "
          "the seeded scene differ")

    renderer = R.Renderer(VIDEO_W, VIDEO_H, device=device)
    view = app_view(app, device)
    gpu = renderer.render(view["pose"], **view["args"]).cpu().numpy()
    renders = {"app": lambda: renderer.render(view["pose"], **view["args"])}
    elapsed = {"app": elapsed_ms(renders["app"], 3)}
    cpu_view = app_view(app, cpu)
    t1 = time.perf_counter()
    cpu_img = R.Renderer(VIDEO_W, VIDEO_H, device=cpu).render(
        cpu_view["pose"], **cpu_view["args"]).numpy()
    cpu_s = time.perf_counter() - t1
    diff = differing_pixels(gpu, cpu_img)
    drawn = int((gpu != 255).any(axis=2).sum())
    print(f"[video] app's final state at {VIDEO_W}x{VIDEO_H} "
          f"({len(app['triangles'])} triangles, 2000 splats, {drawn} pixels "
          f"drawn): {diff} pixels differ between the card and the CPU; "
          f"card {elapsed['app']:.3f} ms stream-elapsed (CUDA events, mean "
          f"of 3 after 1), CPU "
          f"render {cpu_s:.3f} s host wall ({torch.get_num_threads()} "
          f"threads)")
    check(diff == 0, "[video] GPU and CPU images of app's state differ")
    check(drawn > 10000, "[video] app's state drew 10000 pixels or fewer")

    v = e2e["view"]
    _, mesh_surfels, tris = v["mesh"]
    state = F.state_from_numpy(device=device, **e2e["state"])
    count = int(state.surfel_count)
    positions, colors = F.export_vertices(state)
    mesh = dict(mesh_vertices=positions, mesh_colors=colors,
                mesh_triangles=torch.from_numpy(tris.astype(np.int64)).to(
                    device))
    splats = dict(splat_points=positions[mesh_surfels:],
                  splat_colors=colors[mesh_surfels:], splat_half_extent=3.0)
    frustum = dict(frustum_pose=v["pose"], frustum_camera=v["camera"])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    renders.update(
        frame=lambda: renderer.render(v["pose"], **mesh, **splats,
                                      **frustum),
        mesh=lambda: renderer.render(v["pose"], **mesh),
        splats=lambda: renderer.render(
            v["pose"], splat_points=positions, splat_colors=colors,
            splat_half_extent=3.0))
    elapsed["frame"] = elapsed_ms(renders["frame"], 5)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    for name in ("mesh", "splats"):
        elapsed[name] = elapsed_ms(renders[name], 5)
    busy = busy_ms(renders)
    print(f"[video] e2e's final state ({count} surfels) with its last mesh "
          f"at {VIDEO_W}x{VIDEO_H}: {len(tris)} triangles, "
          f"{count - mesh_surfels} splats (surfels newer than the mesh); "
          f"{elapsed['frame']:.3f} ms a frame stream-elapsed (CUDA events, "
          f"mean of 5 after 1); mesh passes alone {elapsed['mesh']:.3f} ms; "
          f"all {count} surfels as splats alone {elapsed['splats']:.3f} ms; "
          f"{peak:.1f} MiB peak device memory above the "
          f"{base / 2 ** 20:.1f} MiB held")
    print("[video] device busy, one profiled render each (torch.profiler, "
          "union of device intervals), idle share of its stream-elapsed: "
          + "; ".join(f"{name} {fmt_busy(busy[name], elapsed[name])}"
                      for name in renders))

    zero_launch_counts()
    run = run_app(device, ["--max_surfel_count", "500000", "--create_video"],
                  checkpoint=False)
    launches, wide = blend_counts()
    print(f"[video] app --create_video on tum_micro at 640x480, frames "
          f"{VIDEO_W}x{VIDEO_H}: rc {run['rc']} in {run['seconds']:.2f} s "
          f"against [app]'s {app['seconds']:.2f} s without video; "
          f"{run['frame_pngs']} frame PNGs, {run['input_pngs']} input-image "
          f"PNGs; {launches} blend launches; PLY byte-identical to [app]'s: "
          f"{run['ply'] == app['ply']}; phase wall "
          f"{time.perf_counter() - t0:.1f} s")
    check(run["frame_pngs"] == launches > 0 and wide == 0,
          f"[video] {run['frame_pngs']} frames for {launches} blend "
          f"launches")
    check(run["input_pngs"] == 2 * (run["frame_pngs"] + 1),
          "[video] not one color and one depth PNG a played frame")
    check(run["ply"] == app["ply"], "[video] the PLY differs from [app]'s")
    return dict(launches=launches)


def phase_live_viewer(device) -> dict:
    """The app with --live_viewer on tum_micro while a thread fetches /,
    /mesh and /version; -> the run's blending launches."""
    t0 = time.perf_counter()
    port = free_port()
    zero_launch_counts()
    with MeshProbe(port) as probe:
        run = run_app(device, ["--max_surfel_count", "500000",
                               "--live_viewer", str(port)], checkpoint=False)
    launches, _ = blend_counts()
    header = probe.header()
    served = probe.served
    freed = port_is_free(port)
    print(f"[live-viewer] app --live_viewer {port} on tum_micro at 640x480: "
          f"rc {run['rc']} in {run['seconds']:.2f} s; served / "
          f"({len(served.get('html', b''))} B), /version "
          f"{served.get('version', b'').decode()}, /mesh version {header[0]} "
          f"with {header[1]} vertices and {header[2]} triangles; "
          f"{launches} blend launches; port free after the run: {freed}; "
          f"phase wall {time.perf_counter() - t0:.1f} s")
    check(not probe.alive(), "[live-viewer] the probe did not end")
    check(b"canvas" in served.get("html", b""), "[live-viewer] no page")
    check(header[1] > 0, "[live-viewer] no vertices served")
    check(launches > 0, "[live-viewer] the blending kernel was not launched")
    check(freed, f"[live-viewer] port {port} still bound after the run")
    return dict(launches=launches)


# BASELINE config 5's eight sequences: distinct (scene, trajectory) pairs.
BATCH_SEQUENCES = (("default", "arc"), ("occlusion", "arc"), ("thin", "arc"),
                   ("corner", "arc"), ("default", "lookaway"),
                   ("occlusion", "lookaway"), ("thin", "push"),
                   ("corner", "push"))
BATCH_FUSED = 12


def phase_batch(device) -> dict:
    """Eight 640x480 sequences at 500k capacity each, default settings, in
    lockstep over 12 fused frames (app/multi_sequence.py's LockstepBatch
    on in-memory videos): CUDA events over the lockstep frames after the
    first, the blending and preprocessing launches of the run, sequences 0 and 7 against
    single-sequence ReconstructionPipeline runs of their videos, bit for
    bit."""
    t0 = time.perf_counter()
    cfg = slice_config()
    half = cfg.outlier_filtering_frame_count // 2
    videos = [synthetic_rgbd_video(BATCH_FUSED + 2 * half, 640, 480,
                                   noise_sigma=0.002, scene=scene,
                                   trajectory=trajectory)[0]
              for scene, trajectory in BATCH_SEQUENCES]
    render_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    live_before = torch.cuda.memory_allocated() / 2 ** 20
    lock = MS.LockstepBatch(videos, cfg, device)
    frames = list(lock.frame_range())
    check(len(frames) == BATCH_FUSED, f"[batch] {len(frames)} lockstep frames")
    zero_launch_counts()
    lock.run(frames[:1])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    start.record()
    total = lock.run(frames[1:])
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches, wide = blend_counts()
    preprocess = preprocess_counts("[batch]")
    timed = len(frames) - 1
    states = [live_state(st) for st in lock.states]
    counts = [int(st["surfel_count"]) for st in states]
    n = len(videos)
    print(f"[batch] {n} sequences at 640x480, 500k capacity each, default "
          f"settings, {len(frames)} lockstep frames: "
          f"{start.elapsed_time(end) / timed:.3f} ms a lockstep frame (CUDA "
          f"events over {timed} frames after 1), {n * timed / wall:.2f} "
          f"sequence-frames/s (host wall), {peak_mib()} MiB peak device "
          f"memory allocated ({live_before:.1f} MiB of it held by earlier "
          f"phases); surfels {counts}, total {int(total)}; "
          f"{launches} blend launches, preprocessing launches {preprocess}; "
          f"rendering {render_s:.1f} s on the host")
    check(int(total) == sum(counts), "[batch] total is not the sum of the "
          "sequences' counts")
    check(all(c > 0 for c in counts), "[batch] a sequence has no surfels")
    check(all(int(st["overflow_count"]) == 0 for st in states),
          "[batch] surfel overflow")
    check((launches, wide) == (n * len(frames), 0), f"[batch] {launches} "
          f"blend launches (wide path {wide}) for {n} x {len(frames)} "
          f"sequence-frames")
    for s in (0, n - 1):
        run = run_slice(device, videos[s], cfg)
        check(states_equal(live_state(run["pipe"].state), states[s]),
              f"[batch] sequence {s} differs from its single-sequence run")
        print(f"[batch] sequence {s} ({'/'.join(BATCH_SEQUENCES[s])}): "
              f"bit-identical to a single-sequence ReconstructionPipeline "
              f"run ({counts[s]} surfels; {run['ms_frame']:.3f} ms/frame "
              f"alone, CUDA events)")
    return dict(launches=launches, preprocess=preprocess, fused=len(frames))


def phase_multi_seq(device) -> None:
    """The multi-sequence app on the card: tests/fixtures/tum_micro and a
    640x480 synthetic dataset together, then each alone; the PLYs equal
    byte for byte."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        synth = write_tum_dataset(str(tmp / "synthetic"), num_frames=12,
                                  width=640, height=480, scene="thin",
                                  trajectory="push")
        datasets = [str(FIXTURE), synth]
        # The app stops at the shorter sequence: cap each run at the
        # frames the pair fuses, so a dataset alone fuses the same ones.
        usable = min(read_tum_rgbd_dataset(d, "groundtruth.txt", 0.05)
                     .frame_count for d in datasets)
        flags = ["--max_surfel_count", "500000", "--max_frames",
                 str(usable - 2), "--device", str(device)]
        rc = MS.main([*datasets, "--output_dir", str(tmp / "both"), *flags])
        check(rc == 0, f"[multi-seq] exited with {rc}")
        sizes = []
        for d in datasets:
            name = Path(d).name
            alone = tmp / f"alone_{name}"
            check(MS.main([d, "--output_dir", str(alone), *flags]) == 0,
                  f"[multi-seq] {name} alone failed")
            both = (tmp / "both" / f"{name}.ply").read_bytes()
            check(both == (alone / f"{name}.ply").read_bytes(),
                  f"[multi-seq] {name}.ply differs from its one-dataset run")
            sizes.append(f"{name}.ply {len(both)} B")
    print(f"[multi-seq] app/multi_sequence.py --device {device} on tum_micro "
          f"and a 640x480 synthetic dataset, {usable - 2} lockstep frames: rc "
          f"0; {', '.join(sizes)}, each byte-identical to its one-dataset "
          f"run; phase wall {time.perf_counter() - t0:.1f} s")


SHARD_FUSED, SHARD_RANKS = 6, 2


def phase_shard(device, video) -> dict:
    """One 500k map sharded over 2 gloo ranks spawned on the one card,
    6 fused frames of the slice video at 640x480; the gathered state
    equals the single-device state bit for bit."""
    t0 = time.perf_counter()
    cfg = slice_config()
    lock = MS.LockstepBatch([video], cfg, device)
    frames = []
    for i in list(lock.frame_range())[:SHARD_FUSED]:
        inputs = lock.frame_inputs(lock.assemble(i))
        frames.append(tuple(t[0] for t in inputs) + (i,))
    ref = F.create_surfel_state(cfg.max_surfel_count, device)
    for f in frames:
        ref = F.integrate_frame(ref, *f[:6], f[6], lock.params[0])
    want = F.state_to_numpy(ref)
    got = shard.spawn_sharded(lock.params[0], cfg.max_surfel_count, frames,
                              SHARD_RANKS, device, timeout=600)
    launches = [int(n) for n in got["blend_launches"]]
    ms = 1000.0 * float(np.mean(got["frame_seconds"][1:]))
    exact = states_equal(got, want)
    print(f"[shard] one 640x480 map of {cfg.max_surfel_count} rows over "
          f"{SHARD_RANKS} gloo ranks on {torch.cuda.get_device_name(0)} "
          f"({cfg.max_surfel_count // SHARD_RANKS} rows a rank), "
          f"{SHARD_FUSED} fused frames of the slice video: "
          f"{int(got['surfel_count'])} surfels, {int(got['merge_count'])} "
          f"merges; gathered state bit-identical to the single-device state "
          f"{exact}; {ms:.3f} ms a frame on rank 0 (host clock, device "
          f"synchronised, frames after the first); blend launches per rank "
          f"{launches}; phase wall {time.perf_counter() - t0:.1f} s")
    check(exact, "[shard] sharded state differs from the single-device state")
    check(launches == [SHARD_FUSED] * SHARD_RANKS, f"[shard] blend launches "
          f"{launches} for {SHARD_FUSED} frames a rank")
    return dict(launches=launches, ms_frame=ms)


def kernel_entry(name, source, replaces, launches, per_frame, t) -> dict:
    extra = {k: t[k] for k in (
        "three_index_select_ms", "l2_read_tb_per_s", "l2_bound_ms",
        "direct_layout_l2_sector_bound_ms", "kernel_launches_per_call",
        "wrapper_calls", "batch_path_launches", "shard_path_launches",
        "video_path_launches", "live_viewer_path_launches",
        "bench_path_launches", "buckets_path_launches",
        "chunk_path_launches",
        "radius32_device_ms", "sweep", "slice_inputs_device_ms",
        "slice_r48_kernels_per_frame", "gpu_vs_cpu_launches")
        if k in t}
    return {"name": name, "route": "cuda",
            "source": f"surfelmeshing_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "main_path_launches_per_frame": per_frame,
            "max_abs_err": t["max_abs_err"], "ms": t["device_ms"],
            "device_ms": t["device_ms"], "host_ms": t["host_ms"],
            "plain_ms": t["plain_ms"], "plain_host_ms": t["plain_host_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], **extra}


def main() -> int:
    name = phase_device()
    device = torch.device("cuda")
    phase_build()
    # The fidelity anchor's host-side oracle runs in a worker process while
    # the other phases use the card; the pool is torn down on every exit.
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        anchor = start_fidelity(device, pool)
        kernels = run_phases(device, anchor)
    finally:
        pool.terminate()
        pool.join()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(device, anchor) -> list:
    """Phases 3-20 and the end of 21; -> the kernels line's entries."""
    blend_times, wide_times = phase_kernel(device)
    preprocess_rows = phase_preprocess(device)
    association_rows = phase_association(device)
    integration_rows = phase_integration(device)
    tiling_rows = phase_tiling(device)
    video, seq = synthetic_rgbd_video(SLICE_FRAMES, 640, 480,
                                      noise_sigma=0.002)
    slice_run = phase_slice(device, video, seq)
    err, wide_err, wide_times["slice_inputs_device_ms"] = \
        phase_slice_inputs(slice_run["taps"], slice_run["radius"])
    blend_times["max_abs_err"] = max(blend_times["max_abs_err"], err)
    wide_times["max_abs_err"] = max(wide_times["max_abs_err"], wide_err)
    wide_run = phase_gpu_vs_cpu(device)
    phase_exact(device, video, slice_run)
    staged = phase_staged(device, video, slice_run)
    wide_slice = phase_slice_wide(device, video, slice_run, staged)
    phase_ab(device)
    gathers = phase_gather(device)
    e2e = phase_e2e(device)
    tiled_20m, full_20m = phase_e2e_20m(device, e2e)
    bench_run = phase_bench(device)
    app = phase_app(device)
    phase_app_20m(device, app["ply"])
    buckets_launches = phase_buckets(device, e2e, full_20m, app)
    chunk_run = phase_chunk(device, video, e2e, app)
    video_run = phase_video(device, e2e, app)
    live_run = phase_live_viewer(device)
    batch_run = phase_batch(device)
    phase_multi_seq(device)
    shard_run = phase_shard(device, video)
    phase_fidelity(anchor)
    replaces = {"gather_rows": "tools/gather_probe.py:66",
                "gather_rows3": "tools/gather_probe.py:91",
                "gather_lane": "tools/gather_probe.py:113"}
    kernels = [kernel_entry("blend_core", "blend.cu",
                            "surfelmeshing_tpu/ops/fusion.py:1726",
                            slice_run["launches"],
                            slice_run["launches"] / slice_run["fused"],
                            dict(blend_times,
                                 batch_path_launches=batch_run["launches"],
                                 shard_path_launches=shard_run["launches"],
                                 video_path_launches=video_run["launches"],
                                 live_viewer_path_launches=live_run[
                                     "launches"],
                                 bench_path_launches=bench_run["launches"],
                                 buckets_path_launches=buckets_launches,
                                 chunk_path_launches=chunk_run["launches"])),
               kernel_entry("blend_wide", "blend_wide.cu",
                            "surfelmeshing_tpu/ops/fusion.py:1726",
                            wide_slice["kernels"], 0,
                            dict(wide_times,
                                 slice_r48_kernels_per_frame=wide_slice[
                                     "kernels"] / wide_slice["fused"],
                                 gpu_vs_cpu_launches=wide_run["kernels"],
                                 wrapper_calls=wide_run["calls"]))]
    kernels += [kernel_entry(k, "gather.cu", replaces[k], g["launches"], 0,
                             g) for k, g in gathers.items()]
    for r in preprocess_rows:
        k = r["name"]
        kernels.append(kernel_entry(
            f"preprocess_{k}", "preprocess.cu", None,
            slice_run["preprocess"][k],
            slice_run["preprocess"][k] / slice_run["fused"],
            dict(r, batch_path_launches=batch_run["preprocess"][k],
                 bench_path_launches={tool: counts[k] for tool, counts in
                                      bench_run["preprocess"].items()},
                 chunk_path_launches=chunk_run["preprocess"][k])))
    for r in association_rows:
        k = r["name"]
        kernels.append(kernel_entry(
            f"association_{k}", "association.cu", None,
            slice_run["association"][k],
            slice_run["association"][k] / slice_run["fused"], r))
    for r in integration_rows:
        kernels.append(kernel_entry(
            r["name"], "integration.cu", None, slice_run["integration"],
            slice_run["integration"] / slice_run["fused"], r))
    kernels += [kernel_entry(r["name"], "tiling.cu", None,
                             tiled_20m["tiling"],
                             tiled_20m["tiling"] / tiled_20m["fused"], r)
                for r in tiling_rows]
    return kernels


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
