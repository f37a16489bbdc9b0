"""Plain PyTorch blending (a frozen copy of the port's ops/blend.py::
blend_core_reference, the plain version its CUDA kernel is held to)."""

import numpy as np
import torch
import torch.nn.functional as F


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
