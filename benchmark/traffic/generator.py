"""The benchmark's one traffic generator: an RGB-D camera in a scene of
planes, boxes and spheres, rendered on the device from a seed.

A traffic mix is a JSON file beside this one (`<mix>.json`) whose
"scene", "trajectory" and "noise_relative" entries this module reads.
It is a rewrite in plain PyTorch of the port's analytic ray caster
(io/synthetic.py): nearest hit of pixel-centre rays whose camera-space z
is 1, so the hit parameter is the depth; depth stored as u16 =
depth_scaling * metres (TUM RGB-D), colour as u8 RGB.

The seed places a fixed set of objects (their sizes are the mix's, the
same for every seed) into the scene's slots in a seeded order, picks
their colours and draws the per-pixel relative depth noise.  Trajectories
are closed and periodic: `period` distinct frames, pose i mod period,
continuous across the wrap.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class Frames:
    """`period` distinct frames: depth (P, H, W) u16, color (P, H, W, 3)
    u8, poses as unit quaternions (P, 4) (x, y, z, w) and translations
    (P, 3), global_T_camera, all host numpy arrays."""
    depth: np.ndarray
    color: np.ndarray
    quat: np.ndarray
    trans: np.ndarray

    @property
    def period(self) -> int:
        return self.depth.shape[0]


# -- poses -------------------------------------------------------------------

def _quat_axis(axis: int, angle: np.ndarray) -> np.ndarray:
    q = np.zeros(angle.shape + (4,))
    q[..., axis] = np.sin(angle / 2)
    q[..., 3] = np.cos(angle / 2)
    return q


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = np.moveaxis(a, -1, 0)
    bx, by, bz, bw = np.moveaxis(b, -1, 0)
    return np.stack([aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw,
                     aw * bw - ax * bx - ay * by - az * bz], axis=-1)


def rotation_matrices(q: np.ndarray) -> np.ndarray:
    """(P, 4) unit quaternions (x, y, z, w) -> (P, 3, 3)."""
    x, y, z, w = np.moveaxis(q, -1, 0)
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)], -1)], axis=-2)


def _orientation(yaw, pitch, roll) -> np.ndarray:
    """Camera orientation: yaw about y, then pitch about x, then roll
    about z (camera x right, y down, z forward)."""
    return _quat_mul(_quat_mul(_quat_axis(1, yaw), _quat_axis(0, pitch)),
                     _quat_axis(2, roll))


def trajectory(spec: dict) -> tuple:
    """(quat (P, 4), trans (P, 3)) of a closed periodic trajectory.

    "oscillate": a hand-held back-and-forth about `center`; translation
    and rotation are sums of sines of whole harmonics of the period.
    "circuit": a walk around an ellipse (semi-axes `radii` in x and z),
    looking outward, pitched by `pitch_deg`, with a small sway."""
    p = int(spec["period"])
    s = 2 * np.pi * np.arange(p) / p
    deg = np.pi / 180
    if spec["kind"] == "oscillate":
        amp = np.asarray(spec["amplitude_m"], np.float64)
        harm = np.asarray(spec["harmonics"], np.float64)
        phase = np.asarray(spec["phase"], np.float64)
        trans = np.asarray(spec["center"], np.float64) + \
            amp * np.sin(harm * s[:, None] + phase)
        rot = np.asarray(spec["rotation_amplitude_deg"]) * deg * \
            np.sin(np.asarray(spec["rotation_harmonics"]) * s[:, None] +
                   np.asarray(spec["rotation_phase"]))
        quat = _orientation(rot[:, 0], spec["pitch_deg"] * deg + rot[:, 1],
                            rot[:, 2])
    elif spec["kind"] == "circuit":
        a, b = spec["radii"]
        trans = np.stack([a * np.cos(s), np.zeros(p), b * np.sin(s)], -1)
        # The outward normal of the ellipse at s: (cos s / a, sin s / b).
        yaw = np.arctan2(np.cos(s) / a, np.sin(s) / b)
        sway = spec["sway_deg"] * deg * np.sin(spec["sway_harmonic"] * s)
        quat = _orientation(yaw + sway, np.full(p, spec["pitch_deg"] * deg),
                            np.zeros(p))
    else:
        raise ValueError(f"unknown trajectory kind {spec['kind']!r}")
    return quat, trans


def path_speed_m_per_frame(trans: np.ndarray) -> np.ndarray:
    """Distance between consecutive poses, the wrap included."""
    return np.linalg.norm(np.roll(trans, -1, axis=0) - trans, axis=1)


# -- scenes ------------------------------------------------------------------

def scene(spec: dict, rng: np.random.Generator) -> dict:
    """Primitives of a scene spec: fixed "planes" and "boxes", plus the
    "objects" (their sizes fixed) placed into "slots" in a seeded order
    with a seeded jitter and seeded colours.  -> {"planes": [(axis,
    value, sign, bounds)], "boxes": [(lo, hi)], "spheres": [(center,
    r)], "colors": (M, 3) u8 by material id (0 = miss)}."""
    planes = [(p["axis"], p["value"], p["sign"],
               [tuple(b) for b in p.get("bounds", [])])
              for p in spec["planes"]]
    boxes = [(np.asarray(b[0], np.float64), np.asarray(b[1], np.float64))
             for b in spec.get("boxes", [])]
    spheres = []
    slots = np.asarray(spec["slots"], np.float64)
    order = rng.permutation(len(slots))
    jitter = spec.get("jitter_m", 0.0)
    for obj, slot in zip(spec["objects"], order):
        base = slots[slot] + rng.uniform(-jitter, jitter, 3) * \
            np.asarray([1.0, 0.0, 1.0])
        if obj["kind"] == "box":
            size = np.asarray(obj["size"], np.float64)
            # A slot is the centre of the object's resting face; y grows
            # downward, so the object extends to smaller y.
            lo = base - np.asarray([size[0] / 2, size[1], size[2] / 2])
            hi = base + np.asarray([size[0] / 2, 0.0, size[2] / 2])
            boxes.append((lo, hi))
        else:
            r = float(obj["radius"])
            spheres.append((base - np.asarray([0.0, r, 0.0]), r))
    n_mat = 1 + len(planes) + len(boxes) + len(spheres)
    colors = rng.integers(40, 230, size=(n_mat, 3)).astype(np.uint8)
    colors[0] = 0
    return {"planes": planes, "boxes": boxes, "spheres": spheres,
            "colors": colors}


def _isect_plane(o, d, t, mat, axis, value, sign, bounds, m):
    da = d[..., axis]
    tp = (value - o[..., axis]) / da
    hit = (tp > 0.05) & (sign * da > 1e-9)
    for b_axis, lo, hi in bounds:
        coord = o[..., b_axis] + tp * d[..., b_axis]
        hit = hit & (coord >= lo) & (coord <= hi)
    better = hit & (tp < t)
    return torch.where(better, tp, t), torch.where(better, m, mat)


def _isect_box(o, d, t, mat, lo, hi, m):
    """Slab method, entry face only (the camera is outside every box)."""
    inv = 1.0 / d
    t0 = (torch.as_tensor(lo, dtype=d.dtype, device=d.device) - o) * inv
    t1 = (torch.as_tensor(hi, dtype=d.dtype, device=d.device) - o) * inv
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    hit = (tmin <= tmax) & (tmin > 0.05)
    better = hit & (tmin < t)
    return torch.where(better, tmin, t), torch.where(better, m, mat)


def _isect_sphere(o, d, t, mat, center, r, m):
    oc = o - torch.as_tensor(center, dtype=d.dtype, device=d.device)
    dd = (d * d).sum(-1)
    b = (oc * d).sum(-1) / dd
    c = ((oc * oc).sum(-1) - r * r) / dd
    disc = b * b - c
    ts = -b - torch.sqrt(disc.clamp_min(0.0))
    hit = (disc > 0) & (ts > 0.05)
    better = hit & (ts < t)
    return torch.where(better, ts, t), torch.where(better, m, mat)


def _render_batch(prims, camera, rot, trans, noise, depth_scaling):
    """Depth u16 (B, H, W) and colour u8 (B, H, W, 3) on the device for
    poses rot (B, 3, 3), trans (B, 3) and unit normal noise (B, H, W)."""
    dev = rot.device
    w, h = camera["width"], camera["height"]
    xs = (torch.arange(w, dtype=torch.float64, device=dev) -
          (camera["cx"] - 0.5)) / camera["fx"]
    ys = (torch.arange(h, dtype=torch.float64, device=dev) -
          (camera["cy"] - 0.5)) / camera["fy"]
    dc = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w),
                      torch.ones(h, w, dtype=torch.float64, device=dev)], -1)
    # Rotate elementwise (no matmul, so no reduced-precision path).
    d = (rot[:, None, None, :, :] * dc[None, :, :, None, :]).sum(-1)
    o = trans[:, None, None, :].expand_as(d)
    t = torch.full(d.shape[:-1], math.inf, dtype=torch.float64, device=dev)
    mat = torch.zeros(d.shape[:-1], dtype=torch.int64, device=dev)
    m = 1
    for axis, value, sign, bounds in prims["planes"]:
        t, mat = _isect_plane(o, d, t, mat, axis, value, sign, bounds, m)
        m += 1
    for lo, hi in prims["boxes"]:
        t, mat = _isect_box(o, d, t, mat, lo, hi, m)
        m += 1
    for center, r in prims["spheres"]:
        t, mat = _isect_sphere(o, d, t, mat, center, r, m)
        m += 1
    hit = torch.isfinite(t)
    depth_m = torch.where(hit, t * (1.0 + noise), 0.0)
    depth = (depth_scaling * depth_m + 0.5).clamp(0, 65535).to(torch.int32)
    # Per-material colour, a distance falloff and a 10 cm checker on the
    # hit point, so colours vary across each surface.
    colors = torch.as_tensor(prims["colors"], device=dev).to(torch.float64)
    hitp = o + torch.where(hit, t, 0.0)[..., None] * d
    checker = (torch.floor(hitp / 0.1).to(torch.int64).sum(-1) % 2) \
        .to(torch.float64)
    shade = (1.0 - 0.18 * torch.where(hit, t, 0.0)).clamp(0.3, 1.0) * \
        (0.8 + 0.2 * checker)
    color = (colors[mat] * shade[..., None]).to(torch.uint8)
    return depth.to(torch.int16), color


def render(traffic: dict, camera: dict, depth_scaling: float, seed: int,
           device, batch: int = 16) -> Frames:
    """Every distinct frame of a mix, rendered on `device` in batches and
    kept on the host.  The same seed gives the same frames."""
    rng = np.random.default_rng(seed)
    prims = scene(traffic["scene"], rng)
    quat, trans = trajectory(traffic["trajectory"])
    rot = rotation_matrices(quat)
    p, h, w = len(quat), camera["height"], camera["width"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    depth = np.empty((p, h, w), np.uint16)
    color = np.empty((p, h, w, 3), np.uint8)
    sigma = float(traffic["noise_relative"])
    for s in range(0, p, batch):
        e = min(p, s + batch)
        noise = sigma * torch.randn((e - s, h, w), generator=gen,
                                    dtype=torch.float64, device=device)
        d, c = _render_batch(
            prims, camera,
            torch.as_tensor(rot[s:e], device=device),
            torch.as_tensor(trans[s:e], device=device), noise, depth_scaling)
        depth[s:e] = d.cpu().numpy().view(np.uint16)
        color[s:e] = c.cpu().numpy()
    return Frames(depth=depth, color=color, quat=quat, trans=trans)
