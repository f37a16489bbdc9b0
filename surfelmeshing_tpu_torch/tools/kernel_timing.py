"""Times of one call of a step on the card: its device time and its
host-inclusive time.

device_ms: the step is warmed up, R calls of it are captured in one
  torch.cuda.CUDAGraph, and the graph is replayed between two CUDA events;
  the elapsed time over R is the device time of one call, free of the
  host's checks, allocations and launch cost.
host_ms: R back-to-back Python calls between two CUDA events, as a caller
  that launches eagerly sees them (the host clock off the card).

Inputs stay where they are between calls, so a step finds them in the L2
cache when they fit, as the frame step does for the maps it has just
written.

l2_read_bytes_per_s: the card's L2-to-SM read rate, from csrc/l2_read.cu
  (a streaming read of an L2-resident buffer) timed by device_ms; the
  gathers' sector bounds divide by it.

preprocess_times: both times of each csrc/preprocess.cu kernel and of its
  plain pass (ops/preprocess.py) on one frame, beside the pass's bound;
  preprocess_inputs makes a seeded frame for it (and for the card tests).
"""

from __future__ import annotations

import ctypes
import functools
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import cuda_build
from ..ops import preprocess as pp

REPEATS = 30
WARMUP = 3


def host_ms(step, device, repeats: int = REPEATS,
            warmup: int = WARMUP) -> float:
    """ms per call over `repeats` back-to-back calls of `step` after
    `warmup`: CUDA events on the card, the host clock elsewhere."""
    for _ in range(warmup):
        step()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(repeats):
            step()
        return 1000.0 * (time.perf_counter() - t0) / repeats
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        step()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / repeats


def device_ms(step, repeats: int = REPEATS, warmup: int = WARMUP) -> float:
    """Device ms per call of `step` on the current CUDA device: `repeats`
    calls captured in one CUDA graph, replayed once to warm up and once
    between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(repeats):
            step()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / repeats


@functools.lru_cache(maxsize=None)
def load_l2_read_library() -> ctypes.CDLL:
    """csrc/l2_read.cu, built on first use and loaded once."""
    lib = ctypes.CDLL(str(cuda_build.build("l2_read")))
    lib.l2_read_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_void_p]
    lib.l2_read_launch.restype = ctypes.c_int
    return lib


def l2_read_bytes_per_s(device, megabytes: int = 16,
                        passes: int = 8) -> float:
    """Bytes/s of `passes` streaming reads of a `megabytes` buffer that
    stays in L2, 8 blocks an SM, timed by device_ms."""
    nvec = megabytes * 2 ** 20 // 16
    buf = torch.randint(0, 2 ** 30, (nvec * 4,), dtype=torch.int32,
                        device=device)
    sink = torch.zeros(4, dtype=torch.int32, device=device)
    blocks = 8 * torch.cuda.get_device_properties(device).multi_processor_count
    lib = load_l2_read_library()

    def step():
        err = lib.l2_read_launch(buf.data_ptr(), nvec, passes,
                                 sink.data_ptr(), blocks,
                                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"l2_read launch failed: CUDA error {err}")

    ms = device_ms(step, 20)
    return 16.0 * nvec * passes / (ms / 1000.0)


# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bytes/s, and
# f64 adds or multiplies a second outside the tensor cores (34 TFLOP/s
# counts an FMA as two operations; an add or a multiply takes the same
# slot).
HBM_BYTES_PER_S = 3.35e12
F64_ADD_MUL_PER_S = 17e12
# f64 adds and multiplies of one bilateral tap: exp_f32's eight _fma_f32.
BILATERAL_F64_OPS_PER_TAP = 16


def preprocess_inputs(seed: int, height: int, width: int, k: int = 8):
    """A seeded frame for the preprocessing passes: a depth map (int32, u16
    units) of a wavy wall at ~1.8 m with a box in front, sensor noise, a
    window beyond a 3 m max_depth, holes and scattered dropouts; K window
    maps of the same scene with their own noise, holes and dropouts; K
    near-identity transforms in depth-unit space.  -> (depth, others,
    transforms), CPU tensors."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    wall = 9000 + 1200 * np.sin(xs / (0.15 * width) + seed % 1000) * \
        np.cos(ys / (0.13 * height)) + 3.0 * xs
    box = (abs(xs - 0.3 * width) < 0.1 * width) & \
        (abs(ys - 0.6 * height) < 0.15 * height)
    wall[box] -= 3500
    window = (abs(xs - 0.75 * width) < 0.08 * width) & \
        (abs(ys - 0.3 * height) < 0.1 * height)
    wall[window] = 16000 + 20 * xs[window]

    def noisy():
        d = (wall + rng.normal(0, 15, wall.shape)).astype(np.int32)
        for _ in range(6):
            y0, x0 = rng.integers(0, height), rng.integers(0, width)
            d[y0:y0 + rng.integers(2, 12), x0:x0 + rng.integers(2, 12)] = 0
        d[rng.random(wall.shape) < 0.002] = 0
        return d

    depth = noisy()
    others = np.stack([noisy() for _ in range(k)])
    transforms = []
    for i in range(k):
        a = 0.002 * (i - k / 2)
        c, s = np.cos(a), np.sin(a)
        transforms.append(np.array(
            [[c, 0, s, rng.normal(0, 20)], [0, 1, 0, rng.normal(0, 20)],
             [-s, 0, c, rng.normal(0, 20)]], np.float32))
    return (torch.from_numpy(depth), torch.from_numpy(others),
            torch.from_numpy(np.stack(transforms)))


def preprocess_pass_args(depth, others, transforms, kw: dict) -> list:
    """(pass, function name in ops/preprocess.py, arguments) for each of
    preprocess_frame's five passes, each fed its input from the plain chain
    over the frame; `kw` holds preprocess_frame's keyword arguments."""
    cam = (kw["fx"], kw["fy"], kw["cx"], kw["cy"])
    d1 = pp.bilateral_filter_and_cutoff_reference(
        depth, kw["sigma_xy"], kw["sigma_value_factor"],
        kw["radius_factor"], kw["max_depth_u16"],
        kw["depth_valid_region_radius"])
    d2 = pp.outlier_depth_map_fusion_reference(
        d1, others, transforms, *cam, kw["tolerance"],
        kw["required_inliers"])
    d3 = pp.erode_depth_reference(d2, kw["erosion_radius"])
    d4, _ = pp.compute_normals_and_drop_bad_pixels_reference(
        d3, kw["observation_angle_threshold_deg"], kw["depth_scaling"],
        *cam)
    return [
        ("bilateral", "bilateral_filter_and_cutoff",
         (depth, kw["sigma_xy"], kw["sigma_value_factor"],
          kw["radius_factor"], kw["max_depth_u16"],
          kw["depth_valid_region_radius"])),
        ("outlier", "outlier_depth_map_fusion",
         (d1, others, transforms, *cam, kw["tolerance"],
          kw["required_inliers"])),
        ("erode", "erode_depth", (d2, kw["erosion_radius"])),
        ("normals", "compute_normals_and_drop_bad_pixels",
         (d3, kw["observation_angle_threshold_deg"], kw["depth_scaling"],
          *cam)),
        ("radii", "compute_point_radii_and_remove_isolated",
         (d4, kw["point_radius_extension_factor"],
          kw["point_radius_clamp_factor"], kw["depth_scaling"], *cam)),
    ]


def bilateral_taps(depth: torch.Tensor, kw: dict) -> int:
    """Taps the bilateral kernel evaluates on `depth`: for each pixel it
    filters (inside the valid-region circle, depth in 1 .. max_depth), its
    in-image non-zero samples inside the filter's circle."""
    h, w = depth.shape
    radius = int(kw["radius_factor"] * kw["sigma_xy"] + 0.5)
    r = torch.arange(-radius, radius + 1, device=depth.device)
    circle = ((r[:, None] ** 2 + r[None, :] ** 2) <= radius * radius)
    nonzero = (depth != 0).to(torch.float32)[None, None]
    per_pixel = F.conv2d(nonzero, circle.to(torch.float32)[None, None],
                         padding=radius)[0, 0]
    ys = torch.arange(h, device=depth.device)[:, None] - h // 2
    xs = torch.arange(w, device=depth.device)[None, :] - w // 2
    filtered = ((xs ** 2 + ys ** 2).to(torch.float32) <=
                kw["depth_valid_region_radius"] ** 2) & (depth != 0) & \
        (depth <= kw["max_depth_u16"])
    return int(torch.where(filtered, per_pixel, 0.0).sum())


def preprocess_bound(name: str, args, kw: dict) -> dict:
    """The least time the card could take for a pass: each input map read
    once and each output map written once at the HBM rate, and for the
    bilateral filter its f64 adds and multiplies (16 a tap evaluated) at
    the f64 rate; the larger."""
    plane = 4 * args[0].numel()
    ops = 0
    if name == "outlier":    # the depth map, K maps and transforms; out
        nbytes = (2 + len(args[1])) * plane + 4 * args[2].numel()
    else:   # one map in; out one map, normals two more, radii one more
        nbytes = {"normals": 4, "radii": 3}.get(name, 2) * plane
    if name == "bilateral":
        ops = BILATERAL_F64_OPS_PER_TAP * bilateral_taps(args[0], kw)
    bytes_ms = 1000.0 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1000.0 * ops / F64_ADD_MUL_PER_S
    return dict(bytes=nbytes, f64_ops=ops, bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="f64 operations" if ops_ms > bytes_ms else "bytes")


def preprocess_times(depth, others, transforms, kw: dict,
                     repeats: int = REPEATS) -> list:
    """For each pass on the frame (CUDA tensors): the kernel's device and
    host-inclusive ms, its plain pass's (`<pass>_reference`, 3 calls), the
    launches of each preprocessing kernel in one call (`call_launches`),
    and the pass's bound."""
    device = depth.device
    rows = []
    for name, fn, args in preprocess_pass_args(depth, others, transforms,
                                               kw):
        kernel = functools.partial(getattr(pp, fn), *args)
        plain = functools.partial(getattr(pp, fn + "_reference"), *args)
        before = pp.launches()
        kernel()
        rows.append(dict(
            name=name, call_launches={k: n - before[k]
                                      for k, n in pp.launches().items()},
            device_ms=device_ms(kernel, repeats),
            host_ms=host_ms(kernel, device, repeats),
            plain_ms=device_ms(plain, 3),
            plain_host_ms=host_ms(plain, device, 3),
            **preprocess_bound(name, args, kw)))
    return rows
