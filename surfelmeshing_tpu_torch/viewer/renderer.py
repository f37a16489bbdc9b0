"""Headless 3D viewer of the port: the software rasterizer of
surfelmeshing_tpu/viewer/renderer.py as tensor passes on one torch device.

Replaces the reference's Qt/OpenGL render window
(surfel_meshing_render_window.{h,cc}): splat rendering of un-meshed surfels,
triangle-mesh rendering, camera frustum lines, orbit camera, screenshots, and
the debug color modes (last-update timestamp, creation timestamp, radius,
normals — UpdateSurfelVertexBufferCUDA variants,
cuda_surfel_reconstruction_kernels.cu:274-351).  Frames render to an
(H, W, 3) u8 tensor, which is what --create_video saves as PNG
(main.cc:1436-1440).

The passes, their order, filters and tolerances are the JAX renderer's, and
every pixel equals its image on the same inputs:
- float64 where numpy computes in float64 (projection, barycentrics,
  perspective-correct depth), a float32 z-buffer, and each expression in
  numpy's order of operations.  The projection `points @ R.T + t` is
  numpy's BLAS product, a fused multiply-add chain over the three
  coordinates; `_fma` computes that chain exactly from plain IEEE
  operations on every device, since no library product promises its
  order.  Division by a Python number is written as a division by a
  tensor (CUDA multiplies by the reciprocal).
- numpy's fancy-index assignments let the last of several writes to a
  pixel win.  Here each pixel's winner is picked explicitly (the largest
  candidate index among those that pass the depth test) and written once,
  so the image does not depend on the order of device writes.
- The far-to-near splat order is a stable sort; numpy's argsort is not,
  so the two can differ only where two splats of equal float64 depth and
  different colours land on one pixel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..ops.preprocess import sqrt_f32
from ..utils.se3 import SE3

# Candidates (triangle x patch pixel) of one mesh chunk: about 80 bytes of
# float64 / int64 temporaries each, so ~0.7 GB a chunk.
CHUNK_CANDIDATES = 1 << 23
MESH_PATCHES = (12, 48, 192)
LINE_SAMPLES = np.linspace(0.0, 1.0, 64)


@dataclasses.dataclass
class OrbitCamera:
    """Orbit camera like the reference viewer's mouse navigation
    (surfel_meshing_render_window.h:74-79)."""
    center: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    yaw: float = 0.0
    pitch: float = 0.0
    radius: float = 3.0
    up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, -1.0, 0.0]))

    def pose(self) -> SE3:
        """global_T_camera for a camera looking at `center`."""
        cp, sp = np.cos(self.pitch), np.sin(self.pitch)
        cy, sy = np.cos(self.yaw), np.sin(self.yaw)
        offset = self.radius * np.array([cp * sy, sp, -cp * cy])
        eye = self.center + offset
        forward = self.center - eye
        forward = forward / np.linalg.norm(forward)
        right = np.cross(forward, -self.up)
        nr = np.linalg.norm(right)
        if nr < 1e-9:
            right = np.array([1.0, 0.0, 0.0])
        else:
            right = right / nr
        down = np.cross(forward, right)
        R = np.stack([right, down, forward], axis=1)  # camera axes in world
        m = np.eye(4)
        m[:3, :3] = R
        m[:3, 3] = eye
        return SE3.from_matrix(m)


def _div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """x / divisor as an IEEE division in x's dtype (on CUDA, a tensor
    divided by a Python number is multiplied by the number's reciprocal)."""
    return x / torch.tensor(divisor, dtype=x.dtype, device=x.device)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    c = 134217729.0 * a                       # 2**27 + 1 (Veltkamp)
    hi = c - (c - a)
    return hi, a - hi


def _fma(a, b, c):
    """a * b + c rounded once, in float64, from plain IEEE operations
    (Boldo and Melquiond's emulated FMA: Dekker's exact product, an exact
    sum, and the low parts added with rounding to odd).  Exact unless a
    product underflows (|a * b| < 2**-969)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    pl = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, p)
    v, e = _two_sum(tl, pl)
    even = (v.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.inf, -torch.inf)
    v = torch.where((e != 0) & even, torch.nextafter(v, toward), v)
    return th + v


def _fma_chain(p: torch.Tensor, rt: torch.Tensor) -> torch.Tensor:
    """fma(p2, rt[2], fma(p1, rt[1], p0 * rt[0])) for each output: numpy's
    BLAS product p @ rt in float64."""
    out = p[:, 0:1] * rt[0]
    for k in (1, 2):
        out = _fma(p[:, k:k + 1], rt[k], out)
    return out



def surfel_colors(mode: str, colors_u8: torch.Tensor, stamps: torch.Tensor,
                  creation: torch.Tensor, radii_sq: torch.Tensor,
                  normals: torch.Tensor, frame_index: int,
                  active_window: int = 3000) -> torch.Tensor:
    """Debug color modes (kernels.cu:306-349), on the inputs' device."""
    n = len(colors_u8)
    if mode == "color":
        return colors_u8
    out = torch.empty((n, 3), dtype=torch.uint8, device=colors_u8.device)
    if mode in ("timestamp", "creation"):
        ref = creation if mode == "creation" else stamps
        max_age = 3000 if mode == "creation" else active_window
        age = frame_index - ref.to(torch.int64)
        blend = _div((age - 1).to(torch.float64),
                     max(1, max_age - 1)).clamp(0.0, 1.0)
        intensity = (255 - 255.99 * blend).clamp(0, 255).to(torch.uint8)
        out[:] = intensity[:, None]
        out[age < 1] = torch.tensor((255, 80, 80), dtype=torch.uint8,
                                    device=out.device)    # updated: red
        out[age > max_age] = torch.tensor((40, 40, 255), dtype=torch.uint8,
                                          device=out.device)  # old: blue
    elif mode == "radius":
        r = sqrt_f32(torch.clamp_min(radii_sq, 0.0))
        blend = _div(r - 0.0005, 0.01 - 0.0005).clamp(0.0, 1.0)
        out[:, 0] = (255.99 * blend).to(torch.uint8)
        out[:, 1] = 255 - out[:, 0]
        out[:, 2] = 80
    elif mode == "normals":
        out[:] = (255.99 / 2.0 * (normals + 1.0)).clamp(0, 255).to(
            torch.uint8)
    else:
        raise ValueError(f"unknown color mode {mode}")
    return out


class Renderer:
    """Z-buffered splat + triangle renderer to an RGB image on `device`."""

    def __init__(self, width: int = 1280, height: int = 720,
                 vertical_fov_deg: float = 50.0,
                 background=(255, 255, 255), *, device):
        self.width = width
        self.height = height
        f = 0.5 * height / np.tan(0.5 * np.deg2rad(vertical_fov_deg))
        self.fx = self.fy = float(f)
        self.cx = width / 2.0
        self.cy = height / 2.0
        self.device = resolve_device(device)
        self.background = torch.tensor(background, dtype=torch.uint8,
                                       device=self.device)

    def _check(self, name: str, t) -> None:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor on {self.device}")
        dev = self.device
        if t.device.type != dev.type or (
                dev.index is not None and t.device.index != dev.index):
            raise ValueError(f"{name} is on {t.device}, the renderer on "
                             f"{dev}")

    def _begin(self):
        """Flat color and depth buffers with one extra slot past the image
        (pixel index H * W), where masked-off candidates write and read
        without a host synchronisation to drop them first."""
        hw = self.height * self.width
        color = self.background.expand(hw + 1, 3).clone()
        zbuf = torch.full((hw + 1,), torch.inf, dtype=torch.float32,
                          device=self.device)
        return color, zbuf

    def _project(self, pose_w2c: SE3, points: torch.Tensor):
        """numpy's `points @ R.T + t` in float64, bit for bit."""
        rt = torch.from_numpy(pose_w2c.rotation_matrix.T.copy()).to(
            self.device)
        t = torch.from_numpy(np.asarray(pose_w2c.t, np.float64)).to(
            self.device)
        local = _fma_chain(points.to(torch.float64), rt) + t
        z = local[:, 2]
        safe = torch.where(z > 1e-6, z, 1.0)
        u = self.fx * local[:, 0] / safe + self.cx
        v = self.fy * local[:, 1] / safe + self.cy
        return u, v, z

    def render(self,
               camera_pose: SE3,                    # global_T_camera
               splat_points: Optional[torch.Tensor] = None,
               splat_colors: Optional[torch.Tensor] = None,
               splat_half_extent: float = 1.5,
               mesh_vertices: Optional[torch.Tensor] = None,
               mesh_colors: Optional[torch.Tensor] = None,
               mesh_triangles: Optional[torch.Tensor] = None,
               triangle_normal_shading: bool = False,
               frustum_pose: Optional[SE3] = None,
               frustum_camera=None,
               lines: Optional[torch.Tensor] = None,
               line_color=(255, 0, 0),
               line_sets=None) -> torch.Tensor:
        """Render one frame; returns an (H, W, 3) u8 tensor on the
        renderer's device.  Every tensor argument must be on that device.

        `line_sets` is an optional list of (segments, color) pairs for
        additional debug line passes (neighbor/normal rendering,
        reference surfel_meshing_render_window.cc:382-430)."""
        for name, t in (("splat_points", splat_points),
                        ("splat_colors", splat_colors),
                        ("mesh_vertices", mesh_vertices),
                        ("mesh_colors", mesh_colors),
                        ("mesh_triangles", mesh_triangles), ("lines", lines),
                        *((f"line_sets[{i}]", s) for i, (s, _) in
                          enumerate(line_sets or ()))):
            if t is not None:
                self._check(name, t)
        color, zbuf = self._begin()
        w2c = camera_pose.inverse()

        if mesh_vertices is not None and mesh_triangles is not None and \
                len(mesh_triangles):
            # Size-class passes: most surfel triangles are pixel-scale, the
            # small-patch pass handles them vectorized; rare big triangles
            # (close-ups) go through the larger-patch passes.
            tri = mesh_triangles.to(torch.int64)
            if int(tri.min()) < 0 or int(tri.max()) >= len(mesh_vertices):
                raise ValueError("mesh_triangles index past mesh_vertices")
            proj = self._project(w2c, mesh_vertices)
            for patch in MESH_PATCHES:
                self._raster_mesh(color, zbuf, proj, mesh_vertices,
                                  mesh_colors, tri, triangle_normal_shading,
                                  patch=patch,
                                  min_patch=patch // 4 if patch > 12 else 0)
        if splat_points is not None and len(splat_points):
            self._raster_splats(color, zbuf, w2c, splat_points, splat_colors,
                                splat_half_extent)
        if frustum_pose is not None and frustum_camera is not None:
            self._draw_frustum(color, zbuf, w2c, frustum_pose, frustum_camera)
        if lines is not None and len(lines):
            self._draw_lines(color, zbuf, w2c, lines, line_color)
        for segments, seg_color in (line_sets or ()):
            if segments is not None and len(segments):
                self._draw_lines(color, zbuf, w2c, segments, seg_color)
        return color[:-1].reshape(self.height, self.width, 3)

    def _last_wins(self, pixels: torch.Tensor,
                   order: torch.Tensor) -> torch.Tensor:
        """Mask of the candidates that win their pixel: the largest `order`
        (>= 0; -1 takes no part) among the candidates at each pixel
        (numpy's last write)."""
        best = torch.full((self.height * self.width + 1,), -1,
                          dtype=torch.int64, device=self.device)
        best.scatter_reduce_(0, pixels, order, "amax")
        return (order >= 0) & (order == best[pixels])

    # -- splats (point -> quad geometry shader analog, cc:948-1010) --------

    def _raster_splats(self, color, zbuf, w2c, points, colors, half_extent):
        finite = torch.isfinite(points).all(dim=1)
        u, v, z = self._project(w2c, points)
        ok = finite & (z > 1e-6) & (u > -8) & (v > -8) & \
            (u < self.width + 8) & (v < self.height + 8)
        u, v, z = u[ok], v[ok], z[ok]
        c = colors[ok] if colors is not None else torch.full(
            (len(u), 3), 128, dtype=torch.uint8, device=self.device)
        r = max(int(round(half_extent)), 0)
        # Far-to-near painter within the z-test: the nearest candidate of a
        # pixel is the last in this order, so it wins.
        order = torch.sort(-z, stable=True).indices
        u, v, z, c = u[order], v[order], z[order], c[order]
        ui = torch.round(u).to(torch.int64)
        vi = torch.round(v).to(torch.int64)
        position = torch.arange(len(z), device=self.device)
        z32 = z.to(torch.float32)
        discard = self.height * self.width
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                x = ui + dx
                y = vi + dy
                valid = (x >= 0) & (y >= 0) & (x < self.width) & \
                    (y < self.height)
                pix = torch.where(valid, y * self.width + x, discard)
                # Against the z-buffer as it was before this offset's writes.
                closer = valid & (z < zbuf[pix].to(torch.float64))
                win = self._last_wins(pix, torch.where(closer, position, -1))
                # One write a pixel; the losers all land in the discard slot.
                pix = torch.where(win, pix, discard)
                zbuf[pix] = z32
                color[pix] = c

    # -- triangles ----------------------------------------------------------

    def _raster_mesh(self, color, zbuf, proj, vertices, vcolors, tri,
                     normal_shading, patch: int = 12, min_patch: int = 0):
        u, v, z = proj
        tu, tv, tz = u[tri], v[tri], z[tri]           # (M, 3)
        ok = torch.isfinite(tu).all(dim=1) & torch.isfinite(tv).all(dim=1) & \
            (tz > 1e-6).all(dim=1)
        # This pass only rasters triangles in its size class.  Bounds stay
        # float64 (integral values) until they are known to be small.
        x0 = torch.floor(tu.amin(dim=1))
        y0 = torch.floor(tv.amin(dim=1))
        x1 = torch.ceil(tu.amax(dim=1))
        y1 = torch.ceil(tv.amax(dim=1))
        extent = torch.maximum(x1 - x0, y1 - y0)
        ok &= (extent < patch) & (extent >= min_patch)
        ok &= (x1 >= 0) & (y1 >= 0) & (x0 < self.width) & (y0 < self.height)
        keep = torch.nonzero(ok).squeeze(1)
        m = len(keep)
        if m == 0:
            return
        tri, tu, tv, tz = tri[keep], tu[keep], tv[keep], tz[keep]
        x0 = x0[keep].to(torch.int64)
        y0 = y0[keep].to(torch.int64)

        tri_color = None
        if normal_shading:
            a = vertices[tri[:, 0]]
            e1 = vertices[tri[:, 1]] - a
            e2 = vertices[tri[:, 2]] - a
            nrm = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                               e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                               e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]],
                              dim=1)
            sq = nrm * nrm
            nl = (sq[:, 0:1] + sq[:, 1:2]) + sq[:, 2:3]
            nl = sqrt_f32(nl) if nl.dtype == torch.float32 else \
                torch.sqrt(nl)
            nrm = torch.where(nl > 1e-12,
                              nrm / torch.clamp_min(nl, 1e-12), 0.0)
            tri_color = ((nrm + 1.0) * 0.5 * 255).to(torch.uint8)  # (M, 3)
        elif vcolors is None:
            vcolors = torch.full((len(vertices), 3), 180, dtype=torch.uint8,
                                 device=self.device)

        # Vectorized barycentric fill over a patch x patch window per
        # triangle, in chunks of triangles.  Pass 1 min-scatters every
        # chunk's depth; pass 2 takes each pixel's last winner in
        # (triangle, gy, gx) order and writes its color.
        per_chunk = max(1, CHUNK_CANDIDATES // (patch * patch))
        chunks = [slice(s, min(s + per_chunk, m))
                  for s in range(0, m, per_chunk)]
        geometry = (tu, tv, tz, x0, y0)
        for chunk in chunks:
            fi, zi, _, _ = self._mesh_candidates(geometry, chunk, patch)
            zbuf.scatter_reduce_(0, fi, zi, "amin")
        for chunk in chunks:
            fi, zi, index, w = self._mesh_candidates(geometry, chunk, patch)
            winners = zi <= zbuf[fi] * (1.0 + 1e-6)
            fi, index, w = fi[winners], index[winners], w[winners]
            win = self._last_wins(fi, index)
            fi, index, w = fi[win], index[win], w[win]
            ti = index // (patch * patch)
            if normal_shading:
                cols = tri_color[ti]
            else:
                vcs = vcolors[tri[ti]].to(torch.float64)      # (K, 3, 3)
                mix = (w[:, 0:1] * vcs[:, 0] + w[:, 1:2] * vcs[:, 1]) + \
                    w[:, 2:3] * vcs[:, 2]
                cols = mix.clamp(0, 255).to(torch.uint8)
            color[fi] = cols

    def _mesh_candidates(self, geometry, chunk: slice, patch: int):
        """The inside candidates of the triangles in `chunk`: flat pixel
        index, f32 depth, global candidate index (triangle * patch**2 +
        gy * patch + gx) and barycentrics (K, 3)."""
        tu, tv, tz, x0, y0 = (g[chunk] for g in geometry)
        g = torch.arange(patch * patch, device=self.device)
        gy, gx = g // patch, g % patch
        pxs = (x0[:, None] + gx[None, :]).to(torch.float64)
        pys = (y0[:, None] + gy[None, :]).to(torch.float64)
        ax, ay = tu[:, 0:1], tv[:, 0:1]
        bx, by = tu[:, 1:2], tv[:, 1:2]
        cx, cy = tu[:, 2:3], tv[:, 2:3]
        d = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
        d = torch.where(torch.abs(d) < 1e-12, 1e-12, d)
        w0 = ((by - cy) * (pxs - cx) + (cx - bx) * (pys - cy)) / d
        w1 = ((cy - ay) * (pxs - cx) + (ax - cx) * (pys - cy)) / d
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        pz = w0 / tz[:, 0:1] + w1 / tz[:, 1:2] + w2 / tz[:, 2:3]
        pz = 1.0 / torch.clamp_min(pz, 1e-12)  # perspective-correct depth

        pxi = pxs.to(torch.int64)
        pyi = pys.to(torch.int64)
        inside &= (pxi >= 0) & (pyi >= 0) & (pxi < self.width) & \
            (pyi < self.height)
        sel = torch.nonzero(inside.reshape(-1)).squeeze(1)
        fi = (pyi * self.width + pxi).reshape(-1)[sel]
        zi = pz.reshape(-1)[sel].to(torch.float32)
        index = sel + chunk.start * patch * patch
        w = torch.stack([w0.reshape(-1)[sel], w1.reshape(-1)[sel],
                         w2.reshape(-1)[sel]], dim=1)
        return fi, zi, index, w

    # -- lines / frustum -----------------------------------------------------

    def _draw_lines(self, color, zbuf, w2c, segments, line_color):
        """segments: (L, 2, 3) world-space endpoints; sampled point draw."""
        seg = segments.to(torch.float64)
        t = torch.from_numpy(LINE_SAMPLES).to(self.device)
        pts = seg[:, 0:1, :] + t[None, :, None] * (seg[:, 1:2, :] -
                                                   seg[:, 0:1, :])
        u, v, z = self._project(w2c, pts.reshape(-1, 3))
        ok = z > 1e-6
        # Rounded coordinates stay float64 until the bounds test has kept
        # only on-image pixels.
        ru = torch.round(u[ok])
        rv = torch.round(v[ok])
        zi = z[ok]
        inb = (ru >= 0) & (rv >= 0) & (ru < self.width) & (rv < self.height)
        pix = rv[inb].to(torch.int64) * self.width + ru[inb].to(torch.int64)
        closer = zi[inb] <= (zbuf[pix] + 1e-4).to(torch.float64)
        color[pix[closer]] = torch.tensor(line_color, dtype=torch.uint8,
                                          device=self.device)

    def _draw_frustum(self, color, zbuf, w2c, frustum_pose, cam,
                      depth: float = 0.2):
        """Input-camera frustum wireframe (cc:361-380); its corners are
        host pose math, as in the JAX renderer."""
        corners_px = np.array([[0, 0], [cam.width, 0],
                               [cam.width, cam.height], [0, cam.height]],
                              np.float64)
        dirs = np.stack([(corners_px[:, 0] - cam.cx) / cam.fx,
                         (corners_px[:, 1] - cam.cy) / cam.fy,
                         np.ones(4)], axis=1) * depth
        R = frustum_pose.rotation_matrix
        t = frustum_pose.t
        corners = dirs @ R.T + t
        apex = np.tile(t, (4, 1))
        segs = []
        for i in range(4):
            segs.append([apex[i], corners[i]])
            segs.append([corners[i], corners[(i + 1) % 4]])
        self._draw_lines(color, zbuf, w2c,
                         torch.from_numpy(np.asarray(segs)).to(self.device),
                         (80, 80, 255))


def save_png(path: str, image: np.ndarray) -> None:
    from PIL import Image as PILImage
    PILImage.fromarray(image).save(path)
