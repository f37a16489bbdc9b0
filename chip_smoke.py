"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line:
  1. device: requires CUDA (exits non-zero otherwise), prints the card and
     its power limit, turns TF32 off;
  2. build: compiles the blending kernel from surfelmeshing_tpu_torch/csrc;
  3. kernel: the kernel vs its plain PyTorch version on seeded maps
     (640x480 radius 12, 24x32 radius 6), both timed at 640x480;
  4. slice: ReconstructionPipeline at 640x480 with 500k surfel capacity and
     default settings over the 24-frame synthetic video, every frame with a
     full outlier window fused; launch counts prove the kernel ran;
  5. kernel on the slice's own blending inputs (captured through the taps);
  6. the same port slice on the GPU and on the CPU (plain versions) at
     160x120 over 6 fused frames, held to the CPU tests' tolerance.
Then one JSON line describing the kernels and, last, the result line.
Any failed check ends the run with a non-zero exit code.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from surfelmeshing_tpu.config import SurfelMeshingConfig
from surfelmeshing_tpu.io.synthetic import synthetic_rgbd_video
from surfelmeshing_tpu_torch.ops import blend
from surfelmeshing_tpu_torch.ops import fusion as F
from surfelmeshing_tpu_torch.pipeline import ReconstructionPipeline

SCALE = 5000.0
KERNEL_TOL = 1.0          # depth units after the floor
WARMUP_FRAMES = 4


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


def random_maps(h, w, seed, device):
    rng = np.random.default_rng(seed)
    depth_f = (rng.integers(0, 3, (h, w)) * 5000 +
               rng.integers(0, 200, (h, w))).astype(np.float32)
    supported = (rng.random((h, w)) < 0.7).astype(np.float32)
    valid = (depth_f > 0).astype(np.float32)
    avg = (depth_f / SCALE +
           0.01 * rng.standard_normal((h, w))).astype(np.float32)
    return [torch.from_numpy(m).to(device)
            for m in (depth_f, supported, valid, avg)]


def compare_kernel(maps, radius, label) -> float:
    """Kernel vs plain version on the same CUDA tensors; returns the max
    absolute difference before the floor."""
    got = blend.blend_core(*maps, radius, SCALE)
    torch.cuda.synchronize()
    want = blend.blend_core_reference(*maps, radius, SCALE)
    floored = (torch.floor(got) - torch.floor(want)).abs()
    max_floor = floored.max().item()
    share = (floored > 0).float().mean().item()
    raw = (got - want).abs().max().item()
    print(f"[kernel] {label} radius {radius}: max |floor diff| {max_floor} "
          f"depth units, {share:.6f} of pixels differ, max |diff| {raw}")
    check(max_floor <= KERNEL_TOL, f"kernel disagrees on {label}")
    return raw


def time_ms(fn, repeats: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def phase_kernel(device):
    errs = [compare_kernel(random_maps(480, 640, 0, device), 12,
                           "640x480 seeded maps"),
            compare_kernel(random_maps(24, 32, 1, device), 6,
                           "24x32 seeded maps")]
    maps = random_maps(480, 640, 2, device)
    ms = time_ms(lambda: blend.blend_core(*maps, 12, SCALE), 50)
    plain_ms = time_ms(lambda: blend.blend_core_reference(*maps, 12, SCALE),
                       10)
    print(f"[kernel] 640x480 radius 12: kernel {ms:.4f} ms, plain PyTorch "
          f"{plain_ms:.4f} ms (CUDA events)")
    return max(errs), ms, plain_ms


def live_pack(pipe) -> np.ndarray:
    count = pipe.surfel_count()
    return F.state_to_numpy(pipe.state)["pack"][:count]


def phase_slice(device):
    cfg = SurfelMeshingConfig(max_surfel_count=500_000, restrict_fps_to=0)
    video, seq = synthetic_rgbd_video(24, 640, 480, noise_sigma=0.002)
    pipe = ReconstructionPipeline(cfg, video.depth_camera, device)
    half = cfg.outlier_filtering_frame_count // 2
    fused_frames = list(range(half, video.frame_count - half))
    taps = {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    blend.blend_core.launches = 0
    fused = 0
    for i in range(video.frame_count):
        if i == fused_frames[WARMUP_FRAMES]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
        result = pipe.process_frame(video, i,
                                    taps=taps if fused == 0 else None)
        fused += result is not None
        if i == fused_frames[-1]:
            end.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    launches = blend.blend_core.launches

    timed = len(fused_frames) - WARMUP_FRAMES
    ms_frame = start.elapsed_time(end) / timed
    count = pipe.surfel_count()
    pack = live_pack(pipe)
    cols = [F.PX, F.PY, F.PZ, F.SX, F.SY, F.SZ, F.NX, F.NY, F.NZ, F.CONF]
    alive = pack[pack[:, F.RAD] >= 0]
    dist = seq.surface_distance(alive[:, F.SX:F.SZ + 1])
    print(f"[slice] 640x480, 500k capacity: {fused} frames fused, "
          f"{launches} blend launches, surfel count {count}, overflow "
          f"{int(pipe.state.overflow_count)}, {ms_frame:.3f} ms/frame "
          f"(CUDA events over {timed} frames after {WARMUP_FRAMES} warm-up; "
          f"host wall {1000 * wall / timed:.3f} ms/frame), median surface "
          f"distance {1000 * float(np.median(dist)):.3f} mm")
    check(fused == len(fused_frames), "not every full-window frame fused")
    check(count > 0, "no surfels")
    check(int(pipe.state.overflow_count) == 0, "surfel overflow")
    check(np.isfinite(pack[:, cols]).all(), "NaN/inf in live surfel rows")
    check(launches == fused, f"{launches} kernel launches for {fused} "
          f"fused frames")
    check(float(np.median(dist)) < 0.005, "surfels off the scene surface")
    return launches, taps, pipe.fusion_params.measurement_blending_radius


def phase_slice_inputs(taps, radius) -> float:
    h, w = taps["depth"].shape
    maps = F.blend_inputs(
        taps["depth"], taps["supporting_surfels"].reshape(h, w),
        taps["support_counts"].reshape(h, w),
        taps["support_depth_sums"].reshape(h, w))
    return compare_kernel([m.contiguous() for m in maps], radius,
                          "slice blending inputs (first fused frame)")


def mean_nearest_distance(a: np.ndarray, b: np.ndarray, device) -> float:
    a = torch.from_numpy(a).to(device, torch.float64)
    b = torch.from_numpy(b).to(device, torch.float64)
    return float(torch.cat([torch.cdist(c, b).min(dim=1).values
                            for c in a.split(4096)]).mean())


def phase_gpu_vs_cpu(device):
    cfg = SurfelMeshingConfig(max_surfel_count=65_536, restrict_fps_to=0)
    half = cfg.outlier_filtering_frame_count // 2
    packs = []
    for dev in (device, torch.device("cpu")):
        video, _ = synthetic_rgbd_video(6 + 2 * half, 160, 120,
                                        noise_sigma=0.002)
        pipe = ReconstructionPipeline(cfg, video.depth_camera, dev)
        fused = sum(pipe.process_frame(video, i) is not None
                    for i in range(video.frame_count))
        check(fused == 6, f"{fused} frames fused on {dev}")
        packs.append(live_pack(pipe))
    gpu, cpu = packs
    count_ok = abs(len(gpu) - len(cpu)) <= 0.01 * len(cpu)
    exact = len(gpu) == len(cpu) and \
        np.array_equal(gpu.view(np.int32), cpu.view(np.int32))
    close = len(gpu) == len(cpu) and np.allclose(gpu, cpu, rtol=3e-5,
                                                 atol=3e-6)
    alive_g = gpu[gpu[:, F.RAD] >= 0][:, F.SX:F.SZ + 1]
    alive_c = cpu[cpu[:, F.RAD] >= 0][:, F.SX:F.SZ + 1]
    dist = mean_nearest_distance(alive_g, alive_c, device)
    print(f"[gpu-vs-cpu] 160x120, 6 fused frames: surfels GPU {len(gpu)} "
          f"CPU {len(cpu)}; bit-identical {exact}; within rtol 3e-5 "
          f"atol 3e-6 {close}; mean nearest-surfel distance {dist:.3e} m")
    check(close or (count_ok and dist < 5e-4), "GPU and CPU slices disagree")


def main() -> int:
    name = phase_device()
    device = torch.device("cuda")
    t0 = time.perf_counter()
    blend.load_library()
    build_s = time.perf_counter() - t0
    print(f"[build] csrc/blend.cu -> {blend.build_library().name} in "
          f"{build_s:.2f} s (nvcc, sm_90a)")
    err, ms, plain_ms = phase_kernel(device)
    launches, taps, radius = phase_slice(device)
    err = max(err, phase_slice_inputs(taps, radius))
    phase_gpu_vs_cpu(device)
    print(json.dumps({"kernels": [{
        "name": "blend_core", "route": "cuda",
        "source": "surfelmeshing_tpu_torch/csrc/blend.cu",
        "replaces": "surfelmeshing_tpu/ops/fusion.py:1715",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
