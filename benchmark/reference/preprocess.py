"""Frozen, trimmed copy of surfelmeshing_tpu_torch/ops/preprocess.py, kept
as the benchmark's plain reference: it imports nothing of the port, so a
later change to the port is judged against this copy, never against
itself.

Depth preprocessing stack in PyTorch.

Counterpart of surfelmeshing_tpu/ops/preprocess.py: the reference's
per-pixel CUDA preprocessing kernels (cuda_depth_processing.cu) as
elementwise/stencil tensor code over (H, W) maps.  Stencils read static
shifted slices of a zero-padded image, which matches the reference's window
clamping because out-of-window samples carry the invalid value 0.

Depth maps hold u16 values (0 = invalid) but are kept as int32 tensors:
torch.uint16 supports few operations, so callers convert at the boundary.
Every function accepts any integer depth dtype and returns int32.

Numerical parity notes (same as the JAX package):
- the bilateral filter reproduces the reference's `(sum / weight + 0.5f)`
  u16 truncation (cuda_depth_processing.cu:116),
- unprojection uses the pixel-corner intrinsics fx_inv*x + cx_inv with
  cx_inv = -(cx - 0.5)/fx (cuda_depth_processing.cu:258-264),
- projection in outlier fusion truncates the pixel position toward zero
  like the C cast (cuda_depth_processing.cu:208-209).
"""

from __future__ import annotations

import functools
import math
import struct
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# Float pixel coordinates are clamped into this range before the int32
# cast: far outside any image, yet exactly representable in f32 and int32.
# torch's float->int32 cast of out-of-range values (and NaN) is undefined
# and in practice yields INT_MIN, which would pass `px < width` tests.
_CAST_LIMIT = float(2 ** 30)


def to_i32_trunc(x: torch.Tensor) -> torch.Tensor:
    """C-style truncating float->int32 cast that saturates instead of
    wrapping: out-of-range values land at +-2**30 and NaN at 0, so every
    image-bounds test sees them where the JAX package's saturating cast
    puts them (off-image)."""
    x = torch.nan_to_num(x, nan=0.0, posinf=_CAST_LIMIT, neginf=-_CAST_LIMIT)
    return x.clamp(-_CAST_LIMIT, _CAST_LIMIT).to(torch.int32)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt.  torch's vectorized CPU sqrt is a
    0.5001-ulp approximation; the f64 sqrt rounded to f32 is exact (f64
    carries more than twice f32's precision), on the CPU and the card."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _f32(value: float) -> float:
    """The f32 value nearest to `value`, as a Python float."""
    return struct.unpack("f", struct.pack("f", value))[0]


# XLA's f32 exp (its CPU backend's Cephes polynomial): range limits,
# log2(e), ln(2) in two parts, and the polynomial coefficients, all f32.
_EXP_LO, _EXP_HI = _f32(-87.8), _f32(88.8)
_LOG2E = _f32(1.44269504088896341)
_LN2_HI, _LN2_LO = _f32(0.693359375), _f32(-2.12194440e-4)
_EXP_POLY = tuple(_f32(c) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))
_F32_MIN_NORMAL = 2.0 ** -126


def _fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 a * b + c rounded once, as a fused multiply-add: the f64 product
    of two f32 values is exact, and the f64 sum is rounded to f32.  (The
    sum is rounded twice, to f64 and then to f32; that differs from one
    rounding only when the f64 sum lands exactly halfway between two f32
    values.)"""
    c = c.to(torch.float64) if isinstance(c, torch.Tensor) else c
    return (a.to(torch.float64) * b + c).to(torch.float32)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 exp with XLA's rounding, in IEEE operations that give the same
    bits on the CPU and the card.

    XLA's f32 exp is not correctly rounded (it differs from the exact
    result in the last bit for about 1 input in 10): x = n ln2 + r with
    n = floor(x log2(e) + 0.5), a degree-6 polynomial for e^r evaluated
    with fused multiply-adds, times 2^n built from its exponent bits; inputs
    are clamped to [-87.8, 88.8] and n to [-127, 127], and results below
    2^-126 flush to 0.  The bilateral filter's u16 truncation turns its last
    bit into a whole depth unit now and then, so the port reproduces it
    (tests/test_torch_preprocess.py holds it to XLA bit for bit)."""
    x = x.to(torch.float32).clamp(_EXP_LO, _EXP_HI)
    n = torch.floor(_fma_f32(x, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = _fma_f32(n, -_LN2_HI, x)
    r = _fma_f32(n, -_LN2_LO, r)
    y = _fma_f32(r, _EXP_POLY[0], _EXP_POLY[1])
    for coeff in _EXP_POLY[2:]:
        y = _fma_f32(y, r, coeff)
    y = 1.0 + _fma_f32(y, r * r, r)
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = y * pow2
    # XLA runs with denormals flushed: results below 2^-126 are 0.
    return torch.where(out < _F32_MIN_NORMAL, 0.0, out)


def _pixel_grid(height: int, width: int, device) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """(ys, xs) int32 pixel coordinate maps of shape (H, W)."""
    ys = torch.arange(height, dtype=torch.int32, device=device)
    xs = torch.arange(width, dtype=torch.int32, device=device)
    return (ys[:, None].expand(height, width),
            xs[None, :].expand(height, width))


def _shifted(padded: torch.Tensor, pad: int, dy: int, dx: int,
             height: int, width: int) -> torch.Tensor:
    """(H, W) view of a (H+2p, W+2p) padded image shifted by (dy, dx)."""
    return padded[pad + dy: pad + dy + height, pad + dx: pad + dx + width]


@functools.lru_cache(maxsize=None)
def _grid_term(radius: int, denom_xy: float, device) -> torch.Tensor:
    """(taps, 1, 1) f32 spatial exponents -(dx^2 + dy^2) / denom_xy of the
    bilateral filter's taps, built once a (radius, denom, device): the
    host-to-device copy that makes it cannot run inside a CUDA graph
    capture, so the chunk step's warm-up builds it first."""
    return torch.tensor([-(dx * dx + dy * dy) / denom_xy
                         for dy, dx in _bilateral_taps(radius)],
                        dtype=torch.float32, device=device)[:, None, None]


def _bilateral_taps(radius: int) -> list:
    """(dy, dx) of the taps inside the filter's circle, row-major."""
    return [(dy, dx) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)
            if dx * dx + dy * dy <= radius * radius]


def bilateral_filter_and_cutoff(
    depth: torch.Tensor,
    sigma_xy: float,
    sigma_value_factor: float,
    radius_factor: float,
    max_depth_u16: int,
    depth_valid_region_radius: float,
) -> torch.Tensor:
    """BilateralFilteringAndDepthCutoffCUDA (cuda_depth_processing.cu:50-158).

    Pixels outside the centered valid-region circle, zero pixels and pixels
    beyond max_depth_u16 become 0; all others get a depth-adaptive
    bilateral-filtered value.  The weights of all taps are computed in one
    pass over a (taps, H, W) stack; the taps then accumulate one by one in
    the JAX package's order, so the sums round as its sums do.
    """
    height, width = depth.shape
    radius = int(radius_factor * sigma_xy + 0.5)
    denom_xy = 2.0 * sigma_xy * sigma_xy
    taps = _bilateral_taps(radius)

    depth = depth.to(torch.int32)
    center = depth.to(torch.float32)

    ys, xs = _pixel_grid(height, width, depth.device)
    center_dist_sq = ((xs - width // 2) ** 2 +
                      (ys - height // 2) ** 2).to(torch.float32)
    in_circle = center_dist_sq <= depth_valid_region_radius ** 2
    valid_center = (depth != 0) & (depth <= max_depth_u16)

    adapted_sigma = center * sigma_value_factor
    adapted_denom = 2.0 * adapted_sigma * adapted_sigma

    padded = F.pad(center, (radius, radius, radius, radius))
    samples = torch.stack([_shifted(padded, radius, dy, dx, height, width)
                           for dy, dx in taps])
    grid_term = _grid_term(radius, denom_xy, depth.device)
    value_dist_sq = (center - samples) ** 2
    weights = exp_f32(grid_term - value_dist_sq / adapted_denom)
    weights = torch.where(samples != 0, weights, 0.0)
    weighted = weights * samples
    sum_acc = torch.zeros_like(center)
    weight_acc = torch.zeros_like(center)
    for t in range(len(taps)):
        sum_acc = sum_acc + weighted[t]
        weight_acc = weight_acc + weights[t]

    filtered = torch.where(
        weight_acc == 0, 0.0,
        sum_acc / weight_acc.clamp_min(1e-30) + 0.5)
    out = torch.where(in_circle & valid_center, filtered, 0.0)
    return out.to(torch.int32)


def outlier_depth_map_fusion(
    depth: torch.Tensor,
    other_depths: torch.Tensor,
    others_T_reference: torch.Tensor,
    fx: float, fy: float, cx: float, cy: float,
    tolerance: float,
    required_inliers: Optional[int] = None,
) -> torch.Tensor:
    """OutlierDepthMapFusionCUDA (cuda_depth_processing.cu:168-510).

    other_depths: (K, H, W) neighbor depth maps; others_T_reference:
    (K, 3, 4) f32 transforms in depth-unit space.  A pixel survives when
    projecting its point into the other frames finds >= required_inliers
    depth values within [1-tol, 1+tol] * projected depth; required_inliers
    None/-1 means all K (the all-inlier kernel variant, :168-334).
    """
    height, width = depth.shape
    k = other_depths.shape[0]
    if required_inliers is None or required_inliers < 0:
        required_inliers = k

    fx_inv = 1.0 / fx
    fy_inv = 1.0 / fy
    cx_inv = -(cx - 0.5) / fx
    cy_inv = -(cy - 0.5) / fy
    max_tol = 1.0 + tolerance
    min_tol = 1.0 - tolerance

    depth = depth.to(torch.int32)
    depth_f = depth.to(torch.float32)
    ys, xs = _pixel_grid(height, width, depth.device)
    px_ref = depth_f * (fx_inv * xs.to(torch.float32) + cx_inv)
    py_ref = depth_f * (fy_inv * ys.to(torch.float32) + cy_inv)
    pz_ref = depth_f

    others_flat = other_depths.reshape(k, -1).to(torch.float32)
    ok_count = torch.zeros((height, width), dtype=torch.int32,
                           device=depth.device)
    for i in range(k):
        T = others_T_reference[i]
        ox = T[0, 0] * px_ref + T[0, 1] * py_ref + T[0, 2] * pz_ref + T[0, 3]
        oy = T[1, 0] * px_ref + T[1, 1] * py_ref + T[1, 2] * pz_ref + T[1, 3]
        oz = T[2, 0] * px_ref + T[2, 1] * py_ref + T[2, 2] * pz_ref + T[2, 3]
        front = oz > 0
        safe_z = torch.where(front, oz, 1.0)
        u = fx * (ox / safe_z) + cx
        v = fy * (oy / safe_z) + cy
        ui = to_i32_trunc(u)
        vi = to_i32_trunc(v)
        in_image = (ui >= 0) & (vi >= 0) & (ui < width) & (vi < height)
        flat = (vi.clamp(0, height - 1) * width +
                ui.clamp(0, width - 1)).reshape(-1)
        sampled = others_flat[i][flat].reshape(height, width)
        ok = front & in_image & (sampled > 0) & \
            (sampled <= max_tol * oz) & (sampled >= min_tol * oz)
        ok_count += ok.to(torch.int32)
    keep = (depth != 0) & (ok_count >= required_inliers)
    return torch.where(keep, depth, 0)


def erode_depth(depth: torch.Tensor, radius: int) -> torch.Tensor:
    """ErodeDepthMapCUDA (cuda_depth_processing.cu:514-586).

    Zeroes a pixel unless every sample in its (2r+1)^2 box is valid; the
    radius-wide image border is always zeroed.
    """
    if radius == 0:
        return copy_without_border(depth)
    height, width = depth.shape
    depth = depth.to(torch.int32)
    padded = F.pad(depth, (radius, radius, radius, radius))
    all_valid = torch.ones(depth.shape, dtype=torch.bool, device=depth.device)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            all_valid &= _shifted(padded, radius, dy, dx, height, width) != 0
    ys, xs = _pixel_grid(height, width, depth.device)
    interior = (xs >= radius) & (ys >= radius) & \
        (xs < width - radius) & (ys < height - radius)
    return torch.where(all_valid & interior, depth, 0)


def copy_without_border(depth: torch.Tensor) -> torch.Tensor:
    """CopyWithoutBorderCUDA (cuda_depth_processing.cu:589-639): the
    1-pixel border becomes 0."""
    height, width = depth.shape
    ys, xs = _pixel_grid(height, width, depth.device)
    interior = (xs >= 1) & (ys >= 1) & (xs < width - 1) & (ys < height - 1)
    return torch.where(interior, depth.to(torch.int32), 0)


def compute_normals_and_drop_bad_pixels(
    depth: torch.Tensor,
    observation_angle_threshold_deg: float,
    depth_scaling: float,
    fx: float, fy: float, cx: float, cy: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ComputeNormalsAndDropBadPixelsCUDA (cuda_depth_processing.cu:642-762).

    Central-difference cross-product normals from the 4-neighborhood; drops
    pixels whose normal is observed at a grazing angle.  Returns
    (out_depth int32, normals_xy (2, H, W) f32); z is reconstructed
    downstream as -sqrt(max(0, 1 - x^2 - y^2)).
    """
    height, width = depth.shape
    fx_inv = 1.0 / fx
    fy_inv = 1.0 / fy
    cx_inv = -(cx - 0.5) / fx
    cy_inv = -(cy - 0.5) / fy
    inv_depth_scaling = 1.0 / depth_scaling
    normal_dot_threshold = -math.cos(
        math.pi / 180.0 * observation_angle_threshold_deg)

    center = depth.to(torch.int32)
    padded = F.pad(center, (1, 1, 1, 1))
    right = _shifted(padded, 1, 0, 1, height, width)
    left = _shifted(padded, 1, 0, -1, height, width)
    bottom = _shifted(padded, 1, 1, 0, height, width)
    top = _shifted(padded, 1, -1, 0, height, width)

    valid = (center != 0) & (right != 0) & (left != 0) & \
        (bottom != 0) & (top != 0)

    ys_i, xs_i = _pixel_grid(height, width, depth.device)
    xs = xs_i.to(torch.float32)
    ys = ys_i.to(torch.float32)

    def unproject(px, py, d_int):
        d = inv_depth_scaling * d_int.to(torch.float32)
        return (d * (fx_inv * px + cx_inv), d * (fy_inv * py + cy_inv), d)

    lx, ly, lz = unproject(xs - 1, ys, left)
    tx_, ty_, tz_ = unproject(xs, ys - 1, top)
    rx, ry, rz = unproject(xs + 1, ys, right)
    bx, by, bz = unproject(xs, ys + 1, bottom)

    # left_to_right x bottom_to_top (cuda_depth_processing.cu:685-695).
    ax, ay, az = rx - lx, ry - ly, rz - lz
    ux, uy, uz = tx_ - bx, ty_ - by, tz_ - bz
    nx = ay * uz - az * uy
    ny = az * ux - ax * uz
    nz = ax * uy - ay * ux
    length = sqrt_f32(nx * nx + ny * ny + nz * nz)
    degenerate = ~(length > 1e-6)
    # Negative-fy handling for ICL-NUIM data (cuda_depth_processing.cu:701).
    # sign is +-1, so Tensor.__rtruediv__'s reciprocal(x) * sign is the
    # exactly rounded sign / x.
    sign = -1.0 if fy_inv < 0 else 1.0
    inv_len = sign / torch.where(degenerate, 1.0, length)
    nx = torch.where(degenerate, 0.0, nx * inv_len)
    ny = torch.where(degenerate, 0.0, ny * inv_len)
    nz = torch.where(degenerate, -1.0, nz * inv_len)

    vx = fx_inv * xs + cx_inv
    vy = fy_inv * ys + cy_inv
    inv_dir_len = 1.0 / sqrt_f32(vx * vx + vy * vy + 1.0)
    dot = inv_dir_len * (vx * nx + vy * ny + nz)
    keep = valid & (dot < normal_dot_threshold)

    out_depth = torch.where(keep, center, 0)
    normals_xy = torch.stack([torch.where(valid, nx, 0.0),
                              torch.where(valid, ny, 0.0)])
    return out_depth, normals_xy


def compute_point_radii_and_remove_isolated(
    depth: torch.Tensor,
    point_radius_extension_factor: float,
    point_radius_clamp_factor: float,
    depth_scaling: float,
    fx: float, fy: float, cx: float, cy: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ComputePointRadiiAndRemoveIsolatedPixelsCUDA
    (cuda_depth_processing.cu:765-883).

    Per valid pixel: squared radius = max squared distance to the valid
    8-neighborhood points, times extension_factor^2, clamped to
    clamp_factor^2 * 2 * min squared neighbor distance; pixels with fewer than
    8 valid neighbors are culled.  Returns (out_depth int32, radius_sq f32).
    """
    height, width = depth.shape
    fx_inv = 1.0 / fx
    fy_inv = 1.0 / fy
    cx_inv = -(cx - 0.5) / fx
    cy_inv = -(cy - 0.5) / fy
    inv_depth_scaling = 1.0 / depth_scaling
    ext_sq = point_radius_extension_factor ** 2
    clamp_term = point_radius_clamp_factor ** 2 * 2.0  # sqrt(2)^2 (cu:873)

    depth = depth.to(torch.int32)
    ys_i, xs_i = _pixel_grid(height, width, depth.device)
    xs = xs_i.to(torch.float32)
    ys = ys_i.to(torch.float32)
    d_center = inv_depth_scaling * depth.to(torch.float32)
    px = d_center * (fx_inv * xs + cx_inv)
    py = d_center * (fy_inv * ys + cy_inv)
    pz = d_center

    padded = F.pad(depth, (1, 1, 1, 1))
    neighbor_count = torch.zeros(depth.shape, dtype=torch.int32,
                                 device=depth.device)
    max_dist_sq = torch.zeros(depth.shape, dtype=torch.float32,
                              device=depth.device)
    min_dist_sq = torch.full(depth.shape, math.inf, dtype=torch.float32,
                             device=depth.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nd = _shifted(padded, 1, dy, dx, height, width)
            nd_valid = nd != 0
            d_n = inv_depth_scaling * nd.to(torch.float32)
            ox = d_n * (fx_inv * (xs + dx) + cx_inv)
            oy = d_n * (fy_inv * (ys + dy) + cy_inv)
            oz = d_n
            dist_sq = (ox - px) ** 2 + (oy - py) ** 2 + (oz - pz) ** 2
            neighbor_count += nd_valid.to(torch.int32)
            max_dist_sq = torch.where(nd_valid & (dist_sq > max_dist_sq),
                                      dist_sq, max_dist_sq)
            min_dist_sq = torch.where(nd_valid & (dist_sq < min_dist_sq),
                                      dist_sq, min_dist_sq)

    radius_sq = max_dist_sq * ext_sq
    if math.isfinite(clamp_term):
        radius_sq = torch.minimum(radius_sq, clamp_term * min_dist_sq)
    valid_center = depth != 0
    radius_sq = torch.where(valid_center, radius_sq, 0.0)
    # >= 8 valid neighbors required (cuda_depth_processing.cu:832-835).
    out_depth = torch.where(valid_center & (neighbor_count >= 8), depth, 0)
    return out_depth, radius_sq


def _valid_median(samples: torch.Tensor, dim: int):
    """Median of the non-zero samples along `dim` and their count, as the
    JAX package computes it: invalid samples sort past the valid ones
    (as 65536); an odd count takes the middle value, an even count the
    one of the two middle values closer to the valid samples' average
    (the upper one on a tie).  -> (median int32, count int32)."""
    samples = samples.to(torch.int32)
    k = samples.shape[dim]
    valid = samples > 0
    count = valid.sum(dim, dtype=torch.int32)
    ordered = torch.sort(torch.where(valid, samples, 65536), dim=dim).values

    def at(pos):
        return ordered.gather(dim, pos.clamp(0, k - 1).long().unsqueeze(dim)) \
            .squeeze(dim)

    mid_hi = at(count // 2)
    mid_lo = at(count // 2 - 1)
    avg = torch.where(valid, samples, 0).sum(dim, dtype=torch.int32) \
        .to(torch.float32) / count.clamp_min(1).to(torch.float32)
    lo_closer = (mid_lo.to(torch.float32) - avg).abs() < \
        (mid_hi.to(torch.float32) - avg).abs()
    median = torch.where((count % 2 == 0) & lo_closer, mid_lo, mid_hi)
    return median, count


def median_filter_and_densify(depth: torch.Tensor) -> torch.Tensor:
    """MedianFilterAndDensifyDepthMap (main.cc:207-252): the median of the
    valid samples of each 3x3 window (center included) where at least 2
    are valid, else the input value.  Exact u16 values (as int32)."""
    height, width = depth.shape
    depth = depth.to(torch.int32)
    padded = F.pad(depth, (1, 1, 1, 1))
    stack = torch.stack([_shifted(padded, 1, dy, dx, height, width)
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    median, count = _valid_median(stack, 0)
    return torch.where(count >= 2, median, depth)


def preprocess_frame(
    depth: torch.Tensor,
    other_depths: torch.Tensor,
    others_T_reference: torch.Tensor,
    *,
    sigma_xy: float,
    sigma_value_factor: float,
    radius_factor: float,
    max_depth_u16: int,
    depth_valid_region_radius: float,
    tolerance: float,
    required_inliers: Optional[int],
    erosion_radius: int,
    observation_angle_threshold_deg: float,
    depth_scaling: float,
    point_radius_extension_factor: float,
    point_radius_clamp_factor: float,
    fx: float, fy: float, cx: float, cy: float,
):
    """Full preprocessing chain for one frame (main-loop order,
    main.cc:1014-1191).

    Returns (depth int32, normals_xy (2,H,W) f32, radius_sq (H,W) f32).
    """
    d = bilateral_filter_and_cutoff(
        depth, sigma_xy, sigma_value_factor, radius_factor,
        max_depth_u16, depth_valid_region_radius)
    d = outlier_depth_map_fusion(
        d, other_depths, others_T_reference, fx, fy, cx, cy,
        tolerance, required_inliers)
    d = erode_depth(d, erosion_radius)
    d, normals_xy = compute_normals_and_drop_bad_pixels(
        d, observation_angle_threshold_deg, depth_scaling, fx, fy, cx, cy)
    d, radius_sq = compute_point_radii_and_remove_isolated(
        d, point_radius_extension_factor, point_radius_clamp_factor,
        depth_scaling, fx, fy, cx, cy)
    return d, normals_xy, radius_sq
