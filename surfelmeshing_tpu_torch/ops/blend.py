"""Measurement blending: the hand-written CUDA kernels, their wrapper and
their plain PyTorch version.

`blend_core` is the port of surfelmeshing_tpu/ops/fusion.py::_blend_pallas
(body `_blend_core`): observation-boundary feathering (reference
kernels.cu:563-738).  On a CUDA tensor it launches csrc/blend.cu, one
launch, for radius <= MAX_RADIUS, and csrc/blend_wide.cu, the wide path
(ceil((radius-1)/T) launches that each carry T ring iterations in shared
memory, the first the border iteration and T-1), for any larger radius;
on a CPU tensor it
runs `blend_core_reference`, a torch transcription of `_blend_core` with
the same shifts and order of operations.

The kernel libraries are compiled from csrc/ at first use
(ops/cuda_build.py).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build

# Largest ring radius the one-launch kernel takes (csrc/blend.cu
# kMaxRadius); larger radii take the wide path.  A
# block's region is 64 columns wide, one 64-bit mask a row, and must keep
# at least two core columns inside a halo of radius-1 on each side.  At 16
# bytes a pixel (depth and two deltas, f32; two u16 pixel lists) and 96
# bytes of masks a row, its largest region (94 x 64) takes 105,296 bytes
# of shared memory, well inside the 227 KB a block may use.
MAX_RADIUS = 32

# Scratch planes of H*W int32 words the wide path takes: two sets (read by
# one chunk launch, written by the other) of dist, ndist, delta, ndelta and
# depth (csrc/blend_wide.cu, 2 * kSetPlanes).  A word a chunk follows them
# (the device flags that let a chunk skip when nothing grows).
WIDE_SCRATCH_PLANES = 10

# Ring iterations the wide path carries a launch (T; its blocks' halo) and
# the rows of a block's core, chosen from chip_smoke.py's sweep at radius
# 48 and 640x480 (PERF.md section 6).  csrc/blend_wide.cu takes T in 1 ..
# WIDE_MAX_CHUNK (its kMaxChunk, which keeps two core columns in a
# 64-column region) and core rows + 2 T <= 128 (one thread a (row,
# 32-pixel half) unit of the region).
WIDE_CHUNK = 16
WIDE_MAX_CHUNK = 31
WIDE_CORE_H = 40


def _shifted(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """img[y+dy, x+dx] with zero fill outside the image."""
    h, w = img.shape
    padded = F.pad(img, (1, 1, 1, 1))
    return padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def blend_core_reference(depth_f: torch.Tensor, supported: torch.Tensor,
                         valid: torch.Tensor, avg: torch.Tensor,
                         radius: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version of the blending kernel.

    BFS feathering from measurement/surfel boundaries: raw depth is pulled
    toward the average supporting-surfel depth with a weight decaying over
    `radius` rings, as Jacobi iterations over the previous ring's snapshot.
    All maps (H, W) f32; `supported` / `valid` are 0/1 masks.  Returns the
    blended depth as f32 (callers floor and clip).
    """
    h, w = depth_f.shape
    scale = float(np.float32(scale))

    supported_b = supported > 0.5
    valid_b = valid > 0.5
    ys = torch.arange(h, device=depth_f.device)[:, None]
    xs = torch.arange(w, device=depth_f.device)[None, :]
    interior = (xs >= 1) & (ys >= 1) & (xs < w - 1) & (ys < h - 1)
    eligible = interior & valid_b & supported_b

    meas_border = torch.zeros((h, w), dtype=torch.bool, device=depth_f.device)
    surf_border = torch.zeros_like(meas_border)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nb_valid = _shifted(valid, dy, dx) > 0.5
            nb_supported = _shifted(supported, dy, dx) > 0.5
            meas_border |= ~nb_valid
            surf_border |= nb_valid & ~nb_supported
    meas_border &= eligible
    surf_border &= eligible

    # Divide by a device tensor, not a Python float: CUDA torch turns
    # division by a CPU scalar into multiplication by its reciprocal, which
    # is not the IEEE division the kernel and the JAX package perform.
    delta0 = avg - depth_f / torch.full_like(depth_f, scale)

    # distance rings: 0 = untouched, 1..radius-1 = ring, 255 = unknown.
    dist_map = torch.where(meas_border, 1.0,
                           torch.where(eligible, 255.0, 0.0))
    deltas = torch.where(meas_border, delta0, 0.0)
    new_dist = torch.where(surf_border, 1.0, 0.0)
    new_deltas = torch.where(surf_border, delta0, 0.0)

    depth_f = torch.where(meas_border, torch.floor(scale * avg + 0.5),
                          depth_f)

    unsupported_target = interior & valid_b & ~supported_b

    def ring_avg(dmap, dvals, ring):
        ssum = torch.zeros_like(depth_f)
        cnt = torch.zeros_like(depth_f)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                at_ring = _shifted(dmap, dy, dx) == ring
                ssum += torch.where(at_ring, _shifted(dvals, dy, dx), 0.0)
                cnt += at_ring.to(torch.float32)
        return ssum, cnt

    for it in range(2, radius):
        interp = (it - 1.0) / (radius - 1.0)
        blend_w = float(np.float32(scale) * np.float32(1.0 - interp))

        ssum, cnt = ring_avg(dist_map, deltas, it - 1)
        grow = (dist_map == 255.0) & (cnt > 0)
        avg_d = ssum / cnt.clamp_min(1.0)
        dist_map = torch.where(grow, float(it), dist_map)
        deltas = torch.where(grow, avg_d, deltas)
        depth_f = torch.where(grow, depth_f + blend_w * avg_d + 0.5, depth_f)

        nsum, ncnt = ring_avg(new_dist, new_deltas, it - 1)
        ngrow = unsupported_target & (new_dist == 0.0) & (ncnt > 0)
        navg = nsum / ncnt.clamp_min(1.0)
        new_dist = torch.where(ngrow, float(it), new_dist)
        new_deltas = torch.where(ngrow, navg, new_deltas)
        depth_f = torch.where(ngrow, depth_f + blend_w * navg + 0.5, depth_f)

    return depth_f


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once; its shared
    memory limit is raised here, once a process, so that no launch calls
    cudaFuncSetAttribute (a launch can then be captured in a CUDA graph)."""
    lib = ctypes.CDLL(str(cuda_build.build("blend")))
    lib.blend_core_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]
    lib.blend_core_launch.restype = ctypes.c_int
    lib.blend_configure.restype = ctypes.c_int
    lib.blend_max_radius.restype = ctypes.c_int
    if lib.blend_max_radius() != MAX_RADIUS:
        raise RuntimeError("csrc/blend.cu and ops/blend.py disagree on the "
                           "largest radius")
    err = lib.blend_configure()
    if err != 0:
        raise RuntimeError(f"blend_core: cudaFuncSetAttribute failed: CUDA "
                           f"error {err}")
    return lib


@functools.lru_cache(maxsize=None)
def load_wide_library() -> ctypes.CDLL:
    """The wide path's library (csrc/blend_wide.cu), built on first use and
    loaded once; its shared-memory limit is raised here, as for
    `load_library`."""
    lib = ctypes.CDLL(str(cuda_build.build("blend_wide")))
    lib.blend_wide_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.blend_wide_launch.restype = ctypes.c_int
    lib.blend_wide_configure.restype = ctypes.c_int
    lib.blend_wide_set_planes.restype = ctypes.c_int
    lib.blend_wide_max_chunk.restype = ctypes.c_int
    if 2 * lib.blend_wide_set_planes() != WIDE_SCRATCH_PLANES or \
            lib.blend_wide_max_chunk() != WIDE_MAX_CHUNK:
        raise RuntimeError("csrc/blend_wide.cu and ops/blend.py disagree on "
                           "the scratch planes or the largest chunk")
    err = lib.blend_wide_configure()
    if err != 0:
        raise RuntimeError(f"blend_core wide path: cudaFuncSetAttribute "
                           f"failed: CUDA error {err}")
    return lib


def _cuda_maps(name: str, maps, radius: int) -> torch.device:
    """The maps' CUDA device, after checking what the kernels take."""
    device = maps[0].device
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    for m in maps:
        if m.device != device or m.dtype != torch.float32 or \
                m.shape != maps[0].shape or m.dim() != 2 or \
                not m.is_contiguous():
            raise ValueError(
                f"{name}: the four maps must be contiguous (H, W) float32 "
                f"tensors on one CUDA device")
    if radius < 1:
        raise ValueError(f"{name}: radius {radius} < 1")
    return device


def blend_core(depth_f: torch.Tensor, supported: torch.Tensor,
               valid: torch.Tensor, avg: torch.Tensor,
               radius: int, scale: float) -> torch.Tensor:
    """Blended depth (f32, not yet floored) from the four (H, W) f32 maps.

    CPU tensors run the plain version; CUDA tensors launch the kernels on
    the current stream (no synchronisation) or raise.  Radius 1 ..
    MAX_RADIUS takes the one-launch kernel, counted in
    `blend_core.launches`; a larger radius takes `blend_wide`.
    """
    maps = (depth_f, supported, valid, avg)
    if all(m.device.type == "cpu" for m in maps):
        return blend_core_reference(*maps, radius, scale)
    if radius > MAX_RADIUS:
        return blend_wide(*maps, radius, scale)
    device = _cuda_maps("blend_core", maps, radius)
    height, width = depth_f.shape
    out = torch.empty_like(depth_f)
    with torch.cuda.device(device):
        err = load_library().blend_core_launch(
            *[m.data_ptr() for m in (*maps, out)], height, width, radius,
            float(scale), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"blend_core kernel launch failed: CUDA error "
                           f"{err}")
    blend_core.launches += 1
    return out


def blend_wide(depth_f: torch.Tensor, supported: torch.Tensor,
               valid: torch.Tensor, avg: torch.Tensor, radius: int,
               scale: float, chunk: int = WIDE_CHUNK,
               core_h: int = WIDE_CORE_H) -> torch.Tensor:
    """`blend_core` by the wide path (csrc/blend_wide.cu) at any radius:
    `chunk` ring iterations a launch on cores of `core_h` rows.
    `blend_core` takes it for radius > MAX_RADIUS.

    CPU tensors run the plain version; CUDA tensors launch the kernels on
    the current stream (no synchronisation) or raise.  Calls are counted
    in `blend_core.wide_launches`, the kernels they enqueue
    (ceil((radius-1)/chunk) chunk kernels, as the launcher reports them)
    in `blend_core.wide_kernel_launches`.
    """
    maps = (depth_f, supported, valid, avg)
    if all(m.device.type == "cpu" for m in maps):
        return blend_core_reference(*maps, radius, scale)
    device = _cuda_maps("blend_wide", maps, radius)
    if not (1 <= chunk <= WIDE_MAX_CHUNK and core_h >= 1 and
            core_h + 2 * chunk <= 128):
        raise ValueError(f"blend_wide: chunk {chunk} outside 1 .. "
                         f"{WIDE_MAX_CHUNK} or core_h {core_h} + 2 chunk "
                         f"above 128")
    height, width = depth_f.shape
    out = torch.empty_like(depth_f)
    kernels = ctypes.c_int(0)
    with torch.cuda.device(device):
        scratch = torch.empty(WIDE_SCRATCH_PLANES * height * width + radius,
                              dtype=torch.int32, device=device)
        err = load_wide_library().blend_wide_launch(
            *[m.data_ptr() for m in (*maps, out)], scratch.data_ptr(),
            height, width, radius, chunk, core_h, float(scale),
            torch.cuda.current_stream(device).cuda_stream,
            ctypes.byref(kernels))
    if err != 0:
        raise RuntimeError(f"blend_wide kernel launch failed: CUDA error "
                           f"{err}")
    blend_core.wide_launches += 1
    blend_core.wide_kernel_launches += kernels.value
    return out


blend_core.launches = 0
blend_core.wide_launches = 0
blend_core.wide_kernel_launches = 0


def launch_counts() -> tuple:
    """(blend_core.launches, .wide_launches, .wide_kernel_launches)."""
    return (blend_core.launches, blend_core.wide_launches,
            blend_core.wide_kernel_launches)


def set_launch_counts(counts) -> None:
    """Set the three counts of `launch_counts`.  A CUDA graph's capture
    runs the wrappers on the host without launching anything: the caller
    takes the counts the capture added as the graph's own, restores the
    counts from before it, and adds the graph's counts at each replay
    (chunk.py)."""
    (blend_core.launches, blend_core.wide_launches,
     blend_core.wide_kernel_launches) = counts
