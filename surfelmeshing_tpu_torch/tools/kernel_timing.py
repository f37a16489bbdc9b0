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

association_times: both times of each csrc/association.cu launch (the
  min-depth map; the support maps) and of its plain scatters
  (ops/association.py), beside its bound, and the plain scatters alone on
  prebuilt int64 indices with and without the entries of invalid pixels;
  association_inputs makes a seeded map's rows for it (and for the card
  tests).

integration_times: both times of csrc/integration.cu's launch and of its
  plain version (ops/integration.py::integrate_reference), beside its
  bound; integration_inputs makes a seeded map's phase-5 inputs for it
  (and for the card tests), integration_row_kinds counts the kinds of
  rows a run met.
"""

from __future__ import annotations

import ctypes
import functools
import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import association as assoc
from ..ops import cuda_build, fusion
from ..ops import integration as integ
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


# Replica's room as NICE-SLAM renders it (benchmark/configs/
# replica1200_20m.json): metres, and the camera's focal length in pixels.
ROOM = (6.0, 4.4, 2.7)
REPLICA_FOCAL = 600.0


def _room_view(rng, n: int, room) -> tuple:
    """n points on the walls, floor and ceiling of a room, in creation
    order (grouped by wall and patch), each with its wall's inward normal,
    and a camera near the room's centre at a seeded heading and tilt:
    -> (points (n, 3), normals (n, 3), camera centre, its (right, down,
    forward) axes), f64 arrays in metres."""
    areas = np.array([room[1] * room[2], room[1] * room[2],
                      room[0] * room[2], room[0] * room[2],
                      room[0] * room[1], room[0] * room[1]])
    face = rng.choice(6, size=n, p=areas / areas.sum())
    a, b = rng.random(n), rng.random(n)
    pts = np.empty((n, 3))
    normals = np.zeros((n, 3))
    axis = face // 2                        # the wall's normal axis
    for k, (i, j) in enumerate(((1, 2), (0, 2), (0, 1))):
        sel = axis == k
        low = face[sel] % 2 == 0
        pts[sel, k] = np.where(low, 0.0, room[k])
        normals[sel, k] = np.where(low, 1.0, -1.0)
        pts[sel, i] = a[sel] * room[i]
        pts[sel, j] = b[sel] * room[j]
    order = np.lexsort((np.floor(a * room[0] / 0.25),
                        np.floor(b * room[2] / 0.25), face))
    centre = np.array(room) / 2 + rng.normal(0, 0.2, 3)
    yaw, tilt = rng.uniform(0, 2 * np.pi), rng.uniform(-0.2, 0.2)
    fwd = np.array([np.cos(yaw) * np.cos(tilt), np.sin(yaw) * np.cos(tilt),
                    np.sin(tilt)])
    right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
    down = np.cross(fwd, right)
    return pts[order], normals[order], centre, (right, down, fwd)


def association_inputs(seed: int, n: int, height: int, width: int,
                       focal: float = REPLICA_FOCAL, count: int = None,
                       room=ROOM) -> dict:
    """A seeded map's association rows, as _integrate_body hands them to
    ops/association.py: n surfels on the walls, floor and ceiling of a
    room, in creation order (grouped by wall and patch), seen by a
    camera with a pixel-corner principal point at the image centre,
    standing near the room's centre at a seeded heading and tilt.  Rows
    at or past `count` (n by default) are unused; rows behind the camera
    or off the image project nowhere.  -> dict of CPU tensors: pix_a and
    pix_b (int32 flat pixels or INVALID_INDEX; pix_b the side pixel toward
    which the surfel leans, as fusion._side_pixel), z (f32 camera depth),
    support_a and support_b (bool: ~85% of the sides with a pixel) and idx
    (int32 row index)."""
    rng = np.random.default_rng(seed)
    count = n if count is None else count
    pts, _, centre, (right, down, fwd) = _room_view(rng, n, room)
    rel = pts - centre
    x, y, z = (rel @ axis_ for axis_ in (right, down, fwd))
    x, y, z = (torch.from_numpy(v.astype(np.float32)) for v in (x, y, z))
    safe = torch.where(z > 0, z, 1.0)
    u = focal * (x / safe) + width / 2
    v = focal * (y / safe) + height / 2
    px, py = pp.to_i32_trunc(u), pp.to_i32_trunc(v)
    live = torch.arange(n) < count
    on_a = live & (z > 0) & (u >= 0) & (v >= 0) & (px < width) & \
        (py < height)
    xf, yf = u - px.to(torch.float32), v - py.to(torch.float32)
    bl, near = xf < yf, xf < 1.0 - yf
    left, bottom, top, right_ = bl & near, bl & ~near, ~bl & near, \
        ~bl & ~near
    sxp = torch.where(left, px - 1, torch.where(right_, px + 1, px))
    syp = torch.where(top, py - 1, torch.where(bottom, py + 1, py))
    side_ok = torch.where(left, px > 1, torch.where(
        right_, px < width - 1, torch.where(top, py > 0, py < height - 1)))
    on_b = on_a & side_ok
    pix_a = torch.where(on_a, py * width + px, assoc.INVALID_INDEX)
    pix_b = torch.where(on_b, syp * width + sxp, assoc.INVALID_INDEX)
    keep = torch.from_numpy(rng.random((2, n)) < 0.85)
    return dict(pix_a=pix_a, pix_b=pix_b, z=z,
                support_a=on_a & keep[0], support_b=on_b & keep[1],
                idx=torch.arange(n, dtype=torch.int32))


def association_bound(rows: dict, hw: int) -> dict:
    """The least time the card could take for each launch: what these
    rows need read once and each map written once at the HBM rate.
    min_depth: both pixels of every row, z of each row with an in-image
    side; support: both flags of every row, both pixels, the index and z
    of each supporting row; maps 4 B a pixel each."""
    valid = ((rows["pix_a"] != assoc.INVALID_INDEX) |
             (rows["pix_b"] != assoc.INVALID_INDEX)).sum()
    supporting = (rows["support_a"] | rows["support_b"]).sum()
    n = rows["idx"].numel()
    nbytes = {"min_depth": 8 * n + 4 * int(valid) + 4 * hw,
              "support": 2 * n + 16 * int(supporting) + 8 * hw}
    return {k: dict(bytes=b, bound_ms=1000.0 * b / HBM_BYTES_PER_S)
            for k, b in nbytes.items()}


def association_times(rows: dict, hw: int, depth_scaling: float,
                      repeats: int = REPEATS) -> list:
    """For each launch on the rows (CUDA tensors): its wrapper's device and
    host-inclusive ms (the maps' fill included) and the launches of each
    association kernel in one call; its plain version's device and
    host-inclusive ms (`plain_ms`, `plain_host_ms`: ops/association.py's
    *_reference, the cat, where and int64 index over 2N entries
    included); and its plain scatters alone on
    prebuilt int64 indices, over all 2N entries, invalid pixels sent to
    the dropped slot (`scatter_all_ms`), and over the entries of in-image
    pixels only (`scatter_valid_ms`): their gap is the dropped slot's
    cost.  Beside each, its bound."""
    device = rows["z"].device
    r = rows
    bounds = association_bound(rows, hw)
    invalid = assoc.INVALID_INDEX
    sup_pix = torch.cat([torch.where(r["support_a"], r["pix_a"], invalid),
                         torch.where(r["support_b"], r["pix_b"], invalid)])
    unit = assoc.depth_units(r["z"], depth_scaling) + (1 << assoc.SUM_BITS)
    scatters = {
        "min_depth": [(torch.cat([r["pix_a"], r["pix_b"]]),
                       torch.cat([r["z"], r["z"]]), math.inf, "amin")],
        "support": [(sup_pix, torch.cat([r["idx"], r["idx"]]), invalid,
                     "amin"),
                    (sup_pix, torch.cat([torch.where(r["support_a"], unit, 0),
                                         torch.where(r["support_b"], unit,
                                                     0)]), 0, "sum")]}
    calls = {
        "min_depth": (assoc.min_depth_map, assoc.min_depth_map_reference,
                      (hw, r["pix_a"], r["pix_b"], r["z"])),
        "support": (assoc.support_maps, assoc.support_maps_reference,
                    (hw, r["pix_a"], r["pix_b"], r["support_a"],
                     r["support_b"], r["idx"], r["z"], depth_scaling))}
    out = []
    for name, (kernel_fn, plain_fn, args) in calls.items():
        kernel = functools.partial(kernel_fn, *args)
        plain = functools.partial(plain_fn, *args)

        def scatter_step(keep_invalid, entries=scatters[name]):
            prepared = []
            for pix, values, fill, reduce in entries:
                keep = slice(None) if keep_invalid else pix != invalid
                index = torch.where(pix == invalid, hw, pix)[keep].long()
                prepared.append((index, values[keep], fill, reduce))

            def step():
                for index, values, fill, reduce in prepared:
                    m = torch.full((hw + 1,), fill, dtype=values.dtype,
                                   device=device)
                    if reduce == "sum":
                        m.scatter_add_(0, index, values)
                    else:
                        m.scatter_reduce_(0, index, values, reduce)
            return step

        before = assoc.launches()
        kernel()
        out.append(dict(
            name=name, call_launches={k: v - before[k]
                                      for k, v in assoc.launches().items()},
            device_ms=device_ms(kernel, repeats),
            host_ms=host_ms(kernel, device, repeats),
            plain_ms=device_ms(plain, 3),
            plain_host_ms=host_ms(plain, device, 3),
            scatter_all_ms=device_ms(scatter_step(True), 3),
            scatter_valid_ms=device_ms(scatter_step(False), 3),
            **bounds[name]))
    return out


# Pixel factors of integration_inputs' measurements, by mode: on the
# surface, beyond it (the conflict zone), in front of it (occluding), no
# depth, on the surface with a pre-blend depth beyond it.
_MEAS_MODES = (0.5, 0.2, 0.1, 0.1, 0.1)
LAYOUTS = ("rows", "tiled", "shard", "bucket")


def integration_inputs(seed: int, n: int, height: int, width: int,
                       focal: float = REPLICA_FOCAL, count: int = None,
                       frame: int = 500, exact: bool = False,
                       layout: str = "rows", room=ROOM,
                       device="cpu") -> dict:
    """A seeded map's phase-5 inputs, as ops/fusion.py::_fuse hands them
    to ops/integration.py::integrate_measurements: n surfel rows on the
    walls of a room (association_inputs' layout; rows at or past `count`
    unused), seen by a camera near its centre, at frame `frame`.  The
    rows are the kinds phase 5 meets: confidences from 0.25 to 5 (a
    conflict re-initialises those at 1 or below, decrements the rest),
    merged-away rows (radius -1), rows created this frame, normals off
    their wall by a few degrees, and side pixels off the image.  Each
    pixel's measurement is on the surface of the nearest row there, beyond
    it (a conflict), in front of it (occluding it), missing, or on the
    surface with a pre-blend depth beyond it; the measurement normal faces
    the pixel's ray.  `exact` adds the conflictor map of
    exact_conflict_arbitration.  `layout`: "rows" (idx the row index),
    "tiled" (a working set's global indices in permuted tiles of 256, its
    last 1,024 rows unused: INVALID_INDEX, out of view), "shard" (idx
    offset by 3,000,000, a rank's rows) or "bucket" (the neighbour tensors
    the leading columns of wider ones).  -> dict: params (FusionParams),
    pack, neighbors, nbr_dist, rows (integration.Rows), maps
    (integration.Maps), local_T_global, global_T_local (3, 4) and frame
    (int), tensors on `device`."""
    F = fusion
    rng = np.random.default_rng(seed)
    count = n if count is None else count
    pts, normals, centre, axes = _room_view(rng, n, room)
    rot = np.stack(axes)                 # rows: right, down, forward
    poses = [torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [r, t[:, None]], 1), np.float32)).to(device)
        for r, t in ((rot, -(rot @ centre)), (rot.T, centre))]
    live = np.arange(n) < count
    if layout == "tiled":
        live &= np.arange(n) < n - 1024
    pack = np.zeros((n, F.PACK_WIDTH), np.float32)
    pack[:, F.PX:F.PZ + 1] = pts
    pack[:, F.SX:F.SZ + 1] = pts + rng.normal(0, 1e-3, (n, 3))
    nrm = normals + rng.normal(0, 0.05, (n, 3))
    pack[:, F.NX:F.NZ + 1] = nrm / np.linalg.norm(nrm, axis=1)[:, None]
    pack[:, F.RCNT] = rng.integers(0, 5, n)
    pack[:, F.DETACH] = rng.random(n) < 0.1
    pack[:, F.CONF] = rng.choice([0.25, 0.5, 1.0, 1.5, 2.0, 3.5, 5.0], n)
    kind = rng.random(n)
    pack[:, F.RAD] = np.where(kind < 0.04, -1.0, np.where(
        kind < 0.05, 0.0, rng.uniform(1e-6, 5e-5, n)))
    pack[:, F.CR:F.CB + 1] = rng.integers(0, 256, (n, 3))
    ints = pack.view(np.int32)
    ints[:, F.STAMP] = frame - rng.integers(1, 40, n)
    ints[:, F.CREATION] = np.where(rng.random(n) < 0.03, frame,
                                   frame - rng.integers(1, 400, n))
    pack[~live] = 0.0
    ints[~live, F.STAMP] = -(2 ** 30)
    slots = np.where(rng.random((4, n)) < 0.3, assoc.INVALID_INDEX,
                     rng.integers(0, max(count, 1), (4, n))).astype(np.int32)
    slot_dist = np.where(slots == assoc.INVALID_INDEX, np.inf,
                         rng.uniform(0, 1e-3, (4, n))).astype(np.float32)
    wide = 4096 if layout == "bucket" else 0
    neighbors, nbr_dist = (torch.from_numpy(np.pad(
        a, ((0, 0), (0, wide)), constant_values=fill)).to(device)[:, :n]
        for a, fill in ((slots, 7), (slot_dist, 0.5)))
    if layout == "tiled":
        tiles = rng.permutation(-(-n // 256))[:, None] * 256
        idx = (tiles + np.arange(256)).reshape(-1)[:n] + 3_000_000
        idx[~live] = assoc.INVALID_INDEX
    else:
        idx = np.arange(n) + (3_000_000 if layout == "shard" else 0)

    params = F.FusionParams(width=width, height=height, fx=focal, fy=focal,
                            cx=width / 2, cy=height / 2,
                            exact_conflict_arbitration=exact)
    pack_t = torch.from_numpy(pack).to(device)
    lx, ly, z = F._transform(poses[0], pack_t[:, F.PX], pack_t[:, F.PY],
                             pack_t[:, F.PZ])
    u, v, px, py, in_image = F._project(params, lx, ly, z)
    sx, sy, side_ok = F._side_pixel(params, u, v, px, py)
    on = torch.from_numpy(live).to(device) & in_image
    rows = integ.Rows(on, side_ok, torch.from_numpy(idx.astype(np.int32))
                      .to(device), lx, ly, z,
                      pp.sqrt_f32(lx * lx + ly * ly + z * z), px, py, sx, sy)

    hw = height * width
    invalid = assoc.INVALID_INDEX
    pix_a = torch.where(on, py * width + px, invalid)
    pix_b = torch.where(on & side_ok, sy * width + sx, invalid)
    first = assoc.min_depth_map_reference(hw, pix_a, pix_b, z)
    base = first.double().cpu().numpy()
    base = np.where(np.isfinite(base), base, rng.uniform(0.5, 3.0, hw))
    mode = rng.choice(5, hw, p=_MEAS_MODES)
    factor = np.choose(mode, [1 + rng.normal(0, 0.01, hw),
                              rng.uniform(1.08, 1.5, hw),
                              rng.uniform(0.6, 0.93, hw), np.zeros(hw),
                              1 + rng.normal(0, 0.01, hw)])
    meas = base * factor
    premeas = np.where(mode == 4, 1.2 * base, np.where(
        (mode == 1) & (rng.random(hw) < 0.3), base, meas))
    ys, xs = np.divmod(np.arange(hw), width)
    ray = np.stack([(xs + 0.5 - width / 2) / focal,
                    (ys + 0.5 - height / 2) / focal, np.ones(hw)], 1)
    mn = -ray / np.linalg.norm(ray, axis=1)[:, None] + \
        rng.normal(0, 0.1, (hw, 3))
    mn /= np.linalg.norm(mn, axis=1)[:, None]
    mnx, mny = (torch.from_numpy(mn[:, k].astype(np.float32)).to(device)
                for k in (0, 1))
    colour = torch.from_numpy(rng.integers(0, 256, (3, hw))
                              .astype(np.float32)).to(device)
    radius = np.where(rng.random(hw) < 0.03, 0.0,
                      rng.uniform(1e-6, 5e-5, hw))
    conflictor = None
    if exact:
        claims = torch.from_numpy(rng.random((2, n)) < 0.5).to(device)
        conflictor = assoc.min_index_map_reference(
            hw, pix_a, pix_b, (pix_a != invalid) & claims[0],
            (pix_b != invalid) & claims[1], rows.idx)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    maps = integ.Maps(
        f32(meas), f32(premeas), first,
        torch.from_numpy(rng.integers(0, 6, hw).astype(np.int32)).to(device),
        colour[0] + colour[1] * 256.0 + colour[2] * 65536.0, mnx, mny,
        -pp.sqrt_f32((1.0 - mnx * mnx - mny * mny).clamp_min(0.0)),
        f32(radius), conflictor)
    return dict(params=params, pack=pack_t, neighbors=neighbors,
                nbr_dist=nbr_dist, rows=rows, maps=maps,
                local_T_global=poses[0], global_T_local=poses[1],
                frame=frame)


def integrate(inputs: dict, plain: bool = False, pack=None):
    """One phase-5 call on `inputs` (integration_inputs'), on `pack` (a
    copy of theirs by default, which the card route updates in place):
    integrate_measurements, or with `plain` integrate_reference.  ->
    (pack, neighbors, nbr_dist)."""
    fn = integ.integrate_reference if plain else integ.integrate_measurements
    return fn(inputs["params"],
              inputs["pack"].clone() if pack is None else pack,
              inputs["neighbors"], inputs["nbr_dist"], inputs["rows"],
              inputs["maps"], inputs["local_T_global"],
              inputs["global_T_local"], inputs["frame"])


def integration_row_kinds(inputs: dict, out: tuple) -> dict:
    """How many rows of each kind a phase-5 run `out` on `inputs` met:
    in view, merged-away, created this frame, with no side pixel (on the
    inputs); re-initialised (creation stamp set this frame), decremented
    (confidence fell) and integrated (update stamp set this frame, not
    re-initialised; all three from the output)."""
    F = fusion
    frame = inputs["frame"]
    on = inputs["rows"].on
    before, after = inputs["pack"], out[0]
    created_b = before.view(torch.int32)[:, F.CREATION] == frame
    reinit = (after.view(torch.int32)[:, F.CREATION] == frame) & ~created_b
    kinds = dict(
        in_view=on, merged_away=on & (before[:, F.RAD] == -1.0),
        created_this_frame=on & created_b, no_side_pixel=on &
        ~inputs["rows"].side_ok, reinitialised=reinit,
        decremented=(after[:, F.CONF] < before[:, F.CONF]) & ~reinit,
        integrated=(after.view(torch.int32)[:, F.STAMP] == frame) & ~reinit)
    return {k: int(v.sum()) for k, v in kinds.items()}


def integration_bound(inputs: dict, out: tuple) -> dict:
    """The least time the card could take for the launch: what these
    inputs need read once and the outputs written once at the HBM rate.
    Every row: its flag and its 4 neighbour slots and slot distances in
    and out (65 B); a row in view and not merged away: its pack row, side
    flag, index, camera-space position, distance and pixel (101 B), and
    its side pixel (8 B) when it has one; a changed row: its pack row out
    (72 B); each pixel such a row reads, once, in each map read (10 maps
    with the conflictor, else 9)."""
    F = fusion
    rows, maps, params = inputs["rows"], inputs["maps"], inputs["params"]
    n = rows.on.numel()
    read = rows.on & (inputs["pack"][:, F.RAD] >= 0)
    side = read & rows.side_ok
    changed = (out[0].view(torch.int32) !=
               inputs["pack"].view(torch.int32)).any(dim=1)
    pixels = torch.cat([(rows.py * params.width + rows.px)[read],
                        (rows.sy * params.width + rows.sx)[side]])
    n_maps = sum(m is not None for m in maps) - 1   # premeas or conflictor
    nbytes = 65 * n + 101 * int(read.sum()) + 8 * int(side.sum()) + \
        72 * int(changed.sum()) + 4 * n_maps * int(pixels.unique().numel())
    return dict(bytes=nbytes, bound_ms=1000.0 * nbytes / HBM_BYTES_PER_S)


def integration_times(inputs: dict, repeats: int = REPEATS) -> dict:
    """The launch's device and host-inclusive ms on `inputs` (CUDA
    tensors; repeated calls update one copy of the pack in place) and the
    launches of one call, its plain version's device and host-inclusive ms
    (integrate_reference, 3 calls), and its bound."""
    device = inputs["pack"].device
    pack = inputs["pack"].clone()
    before = integ.integrate_measurements.launches
    out = integrate(inputs, pack=pack)
    launched = integ.integrate_measurements.launches - before
    bound = integration_bound(inputs, out)
    kernel = functools.partial(integrate, inputs, pack=pack)
    plain = functools.partial(integrate, inputs, plain=True,
                              pack=inputs["pack"])
    return dict(call_launches=launched,
                device_ms=device_ms(kernel, repeats),
                host_ms=host_ms(kernel, device, repeats),
                plain_ms=device_ms(plain, 3),
                plain_host_ms=host_ms(plain, device, 3), **bound)


# The explore mix's room (benchmark/traffic/explore.live.json): metres.
EXPLORE_ROOM = (10.0, 7.6, 2.6)


def tiling_inputs(seed: int, capacity: int, live: int, height: int = 480,
                  width: int = 640, focal: float = 525.0, frame: int = 900,
                  window: int = 30, tile_size: int = 4096, fast: bool = True,
                  room=EXPLORE_ROOM, device="cpu") -> dict:
    """A seeded map for the tile selection (ops/tiling.py): `capacity`
    rows, the first `live` of them surfels on the walls of a room in
    creation order (_room_view), seen at frame `frame` by a camera near
    its centre.  As in a capture, update stamps follow creation order: a
    quarter of the runs of 16,384 rows were updated within the window,
    the rest long before it.  Scattered among them, a few rows of each
    kind the selection meets: stamps at the window's edge (frame - window
    - 1, moved on the frame before), merge tombstones (stamp 0, radius
    -1), stored recent-neighbour counts left on stale rows, detach flags,
    neighbour slots anywhere in the map; the other slots point near in
    creation order, about a third INVALID_INDEX.  Rows from `live` on are
    unused (stamp -2^30, no slots).  -> dict: params (FusionParams), pack,
    neighbors, surfel_count (0-d int32), local_T_global (3, 4) and frame
    (int), tensors on `device`."""
    F = fusion
    rng = np.random.default_rng(seed)
    pts, _, centre, axes = _room_view(rng, live, room)
    rot = np.stack(axes)                 # rows: right, down, forward
    pose = np.concatenate([rot, -(rot @ centre)[:, None]], 1)
    pack = np.zeros((capacity, F.PACK_WIDTH), np.float32)
    ints = pack.view(np.int32)
    ints[:, F.STAMP] = -(2 ** 30)
    pack[:live, F.PX:F.PZ + 1] = pts
    recent = (rng.random(-(-live // 16384)) < 0.25)[np.arange(live) // 16384]
    stamp = np.where(recent, frame - rng.integers(0, window + 1, live),
                     frame - rng.integers(window + 2, 900, live))
    rare = 2e-4
    kind = rng.random(live)
    stamp = np.where(kind < rare, frame - window - 1, stamp)
    tomb = (kind >= rare) & (kind < 2 * rare)
    ints[:live, F.STAMP] = np.where(tomb, 0, stamp)
    pack[:live, F.RAD] = np.where(tomb, -1.0, 1e-5)
    pack[:live, F.RCNT] = np.where(
        (kind >= 2 * rare) & (kind < 3 * rare), rng.integers(1, 5, live), 0)
    pack[:live, F.DETACH] = (kind >= 3 * rare) & (kind < 4 * rare)
    slots = np.full((4, capacity), assoc.INVALID_INDEX, np.int32)
    near = np.clip(np.arange(live) + rng.integers(-300, 300, (4, live)), 0,
                   live - 1)
    pick = rng.random((4, live))
    slots[:, :live] = np.where(pick < 0.35, assoc.INVALID_INDEX, np.where(
        pick < 0.35 + rare, rng.integers(0, live, (4, live)), near))
    params = F.FusionParams(width=width, height=height, fx=focal, fy=focal,
                            cx=width / 2, cy=height / 2,
                            regularization_frame_window_size=window,
                            tile_size=tile_size, fast_neighbor_update=fast)
    return dict(params=params, pack=torch.from_numpy(pack).to(device),
                neighbors=torch.from_numpy(slots).to(device),
                surfel_count=torch.tensor(live, dtype=torch.int32,
                                          device=device),
                local_T_global=torch.from_numpy(pose.astype(np.float32))
                .to(device), frame=frame)


def tile_select(inputs: dict, plain: bool = False, **changes):
    """One tile selection on `inputs` (tiling_inputs', with `changes`
    replacing entries): tiling.tile_flags, or with `plain` its plain
    version.  -> (n // tile_size,) bool."""
    from ..ops import tiling
    a = dict(inputs, **changes)
    fn = tiling.tile_flags_reference if plain else tiling.tile_flags
    return fn(a["params"], a["pack"], a["neighbors"], a["surfel_count"],
              a["local_T_global"], a["frame"])


def tiling_row_kinds(inputs: dict) -> dict:
    """How many live rows of `inputs` each of the selection's tests flags
    (a row may count under several), and how many none does."""
    from ..ops import tiling
    F = fusion
    params, pack, nbr = inputs["params"], inputs["pack"], inputs["neighbors"]
    n = int(inputs["surfel_count"])
    pose, since = inputs["local_T_global"], \
        inputs["frame"] - params.regularization_frame_window_size - 1
    stamps = pack.view(torch.int32)[:, F.STAMP]
    slot = F._safe_idx(nbr, pack.shape[0]).long()
    valid = nbr != assoc.INVALID_INDEX
    ns = stamps[slot]
    kinds = dict(
        in_view=tiling._in_view(params, pose, *pack[:, :3].unbind(1)),
        in_window=stamps > since, window_edge=stamps == since,
        recent_count=pack[:, F.RCNT] != 0,
        neighbour_in_view=(valid & tiling._in_view(
            params, pose, *(pack[:, c][slot] for c in range(3)))).any(0),
        neighbour_in_window=(valid & (ns > since)).any(0),
        neighbour_at_edge=(valid & (ns == since)).any(0),
        neighbour_tombstone=(valid & (ns == 0)).any(0),
        neighbour_detached=(valid & (pack[:, F.DETACH][slot] > 0)).any(0))
    out = {k: int(v[:n].sum()) for k, v in kinds.items()}
    flagged = tiling.row_flags_reference(
        params, pack, nbr, inputs["surfel_count"], pose, inputs["frame"])
    out["none"] = int((~flagged[:n]).sum())
    return out


def tiling_bound(inputs: dict) -> dict:
    """The least time the card could take for the launch: the distinct
    words of these inputs that the kernel's tests read, each once, and
    the flag bytes it writes, at the HBM rate.  A live row's tests stop at
    the first that flags it (csrc/tiling.cu's order): its stamp, then its
    recent-neighbour count, then its position; then, slot by slot, the
    slot and, for a valid one, the neighbour's stamp, detach flag (without
    fast_neighbor_update) and position.  A word that several rows read
    (a neighbour's stamp, a row's own position) counts once; one byte a
    flagged tile."""
    from ..ops import tiling
    F = fusion
    params, pack = inputs["params"], inputs["pack"]
    nbr = inputs["neighbors"]
    n = pack.shape[0]
    live = torch.arange(n, device=pack.device) < inputs["surfel_count"]
    since = inputs["frame"] - params.regularization_frame_window_size - 1
    stamps = pack.view(torch.int32)[:, F.STAMP]
    in_view = tiling._in_view(params, inputs["local_T_global"],
                              *pack[:, :3].unbind(1))
    read = {c: torch.zeros(n, dtype=torch.bool, device=pack.device)
            for c in ("stamp", "rcnt", "pos", "detach")}
    read["stamp"] |= live
    flag = live & (stamps >= since)
    read["rcnt"] |= live & ~flag
    flag |= live & (pack[:, F.RCNT] != 0)
    read["pos"] |= live & ~flag
    flag |= live & in_view
    slot_words = 0
    for k in range(4):
        reading = live & ~flag
        slot_words += int(reading.sum())
        j = nbr[k]
        go = reading & (j != assoc.INVALID_INDEX)
        s = F._safe_idx(j, n).long()[go]
        read["stamp"][s] = True
        ns = stamps[s]
        hit = (ns >= since) | (ns == 0)
        if not params.fast_neighbor_update:
            read["detach"][s[~hit]] = True
            hit |= pack[:, F.DETACH][s] > 0
        read["pos"][s[~hit]] = True
        hit |= in_view[s]
        flag[go.nonzero().squeeze(1)[hit]] = True
    words = slot_words + sum(
        int(m.sum()) * (3 if c == "pos" else 1) for c, m in read.items())
    tiles = int(flag.view(-1, params.tile_size).any(dim=1).sum())
    nbytes = 4 * words + tiles
    return dict(bytes=nbytes, bound_ms=1000.0 * nbytes / HBM_BYTES_PER_S)


def tiling_times(inputs: dict, repeats: int = REPEATS) -> dict:
    """The launch's device and host-inclusive ms on `inputs` (CUDA
    tensors) and the launches of one call, its plain version's device and
    host-inclusive ms (tile_flags_reference, 3 calls), and its bound."""
    from ..ops import tiling
    device = inputs["pack"].device
    before = tiling.tile_flags.launches
    tile_select(inputs)
    launched = tiling.tile_flags.launches - before
    kernel = functools.partial(tile_select, inputs)
    plain = functools.partial(tile_select, inputs, plain=True)
    return dict(call_launches=launched,
                device_ms=device_ms(kernel, repeats),
                host_ms=host_ms(kernel, device, repeats),
                plain_ms=device_ms(plain, 3),
                plain_host_ms=host_ms(plain, device, 3),
                **tiling_bound(inputs))
