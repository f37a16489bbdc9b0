"""Phase 5 of the fusion step, "Integrate measurements" (the reference's
kernels.cu:741-1142; ops/fusion.py::_fuse calls it on every route).

Each surfel row that phase 1 found active and in the image meets the
measurement at its own pixel (side a), then at its side pixel (side b,
where that pixel is in the image), in that order: side b sees side a's
result.  At a side the row either counts a conflict (confidence - 1, and
at zero it is re-initialised from the measurement and its neighbour slots
cleared) or, when the measurement is on its surface, blends the
measurement into its position, normal, radius and colour.

Two routes, picked by the inputs' device alone (no flag, no fallback):
- CPU tensors run `integrate_reference`, the plain PyTorch version: two
  passes of ~100 elementwise ops over all rows, each rebuilding the pack
  from its 18 columns.  It is the tests' yardstick.
- CUDA tensors launch csrc/integration.cu once, on the current stream, with
  no host synchronisation, so a CUDA graph capture records it.  The kernel
  updates `pack` in place (the caller's pack is the copy phase 3 made for
  this frame) and writes the neighbour slots and slot distances into new
  tensors (the input state's are kept by snapshots and capture warm-ups).
  Its launches are counted in `integrate_measurements.launches`
  (registered in ops/launch_counts.py as `integration`).  Anything else
  raises.
The kernel equals the plain version as CUDA PyTorch runs it, bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

# fusion imports this module; its names are read at call time.
from . import cuda_build, fusion, launch_counts
from .association import INVALID_INDEX
from .preprocess import _on_card, sqrt_f32


class Rows(NamedTuple):
    """Phase 1's values of each working row, (n,) tensors."""
    on: torch.Tensor        # bool: active and in the image
    side_ok: torch.Tensor   # bool: the side pixel lies in the image
    idx: torch.Tensor       # int32: the row's global index
    lx: torch.Tensor        # f32: camera-space position of the raw position
    ly: torch.Tensor
    z: torch.Tensor         # f32: the depth the min-depth map was built from
    dist: torch.Tensor      # f32: sqrt_f32(lx^2 + ly^2 + z^2)
    px: torch.Tensor        # int32: the row's pixel
    py: torch.Tensor
    sx: torch.Tensor        # int32: its side pixel
    sy: torch.Tensor


class Maps(NamedTuple):
    """The frame's per-pixel maps, (hw,) tensors."""
    meas: torch.Tensor      # f32: blended depth in metres
    premeas: torch.Tensor   # f32: depth before blending, in metres
    first: torch.Tensor     # f32: the min-depth map (phase 1)
    counts: torch.Tensor    # int32: supporting surfels (phase 2)
    rgb: torch.Tensor       # f32: r + 256 g + 65536 b
    mnx: torch.Tensor       # f32: measurement normal, camera space
    mny: torch.Tensor
    mnz: torch.Tensor
    radius: torch.Tensor    # f32: squared measurement radius
    conflictor: Optional[torch.Tensor]  # int32 (exact_conflict_arbitration)


def _pixels(hw: int, w: int, on, px, py) -> torch.Tensor:
    """The gather index of each row: its pixel where `on`, else 0."""
    return torch.where(on, py * w + px, 0).clamp(0, hw - 1).long()


def integrate_reference(params, pack, neighbors, nbr_dist, rows: Rows,
                        maps: Maps, local_T_global, global_T_local,
                        frame_index):
    """The plain version of integrate_measurements (its arguments)."""
    F = fusion
    noise = params.sensor_noise_factor
    cos_compat = float(np.float32(params.cos_normal_compat))
    fx_inv, fy_inv, cx_inv, cy_inv = params.unprojection
    Tl, Tg = local_T_global, global_T_local
    lx, ly, z, idx = rows.lx, rows.ly, rows.z, rows.idx
    hw, w = maps.meas.shape[0], params.width

    def integrate_at(pack, neighbors, nbr_dist, pix, pxf, pyf, on):
        meas, counts, rgb = maps.meas[pix], \
            maps.counts[pix].to(torch.float32), maps.rgb[pix]
        p_mnx, p_mny, p_mnz = maps.mnx[pix], maps.mny[pix], maps.mnz[pix]
        p_rad, first = maps.radius[pix], maps.first[pix]
        on = on & (meas > 0)
        conflict_zone = first < (1.0 - noise) * meas
        conflicting = on & conflict_zone & (first == z)
        if maps.conflictor is not None:
            # exact_conflict_arbitration: only the pixel's conflictor.
            conflicting = conflicting & (maps.conflictor[pix] == idx)
        else:
            # Marker eligibility: the reference writes its conflictor map
            # in the association pass, from the PRE-blend depth
            # (kernels.cu:1610-1618), so a surfel may only decrement where
            # the pre-blend conflict zone also held.
            conflicting = conflicting & \
                (first < (1.0 - noise) * maps.premeas[pix])
        on = on & ~conflict_zone
        on = on & ~(z > (1.0 + noise) * meas)

        # The measurement at this surfel's pixel, unprojected and rotated
        # to global space.
        m_plx = meas * (fx_inv * pxf + cx_inv)
        m_ply = meas * (fy_inv * pyf + cy_inv)
        g_px, g_py, g_pz = F._transform(Tg, m_plx, m_ply, meas)
        g_nx, g_ny, g_nz = F._transform(Tg, p_mnx, p_mny, p_mnz,
                                        translate=False)
        m_cb = torch.floor(rgb * (1.0 / 65536.0))
        rem = rgb - m_cb * 65536.0
        m_cg = torch.floor(rem * (1.0 / 256.0))
        m_cr = rem - m_cg * 256.0

        # Conflict handling (kernels.cu:816-868): confidence - 1; at zero
        # the surfel is re-initialized from the measurement and flags
        # detach.
        conf0 = pack[:, F.CONF]
        new_conf = conf0 - 1.0
        reinit = conflicting & (new_conf <= 0)
        dec = conflicting & ~reinit

        cols = list(pack.unbind(1))
        reinit_cols = {
            F.PX: g_px, F.PY: g_py, F.PZ: g_pz,
            F.SX: g_px, F.SY: g_py, F.SZ: g_pz,
            F.NX: g_nx, F.NY: g_ny, F.NZ: g_nz,
            F.CR: m_cr, F.CG: m_cg, F.CB: m_cb,
            F.RAD: p_rad, F.CONF: 1.0, F.DETACH: 1.0,
        }
        for k, val in reinit_cols.items():
            cols[k] = torch.where(reinit, val, cols[k])
        for k in F._INT_COLS:
            cols[k] = torch.where(reinit, frame_index,
                                  cols[k].view(torch.int32)) \
                .view(torch.float32)
        cols[F.CONF] = torch.where(dec, new_conf, cols[F.CONF])
        neighbors = torch.where(reinit[None, :], INVALID_INDEX, neighbors)
        nbr_dist = torch.where(reinit[None, :], math.inf, nbr_dist)

        # Same-surface checks (kernels.cu:875-919) with the (possibly
        # reinitialized) attributes.
        lsnx, lsny, lsnz = F._transform(Tl, cols[F.NX], cols[F.NY],
                                        cols[F.NZ], translate=False)
        dot_view = (lx * lsnx + ly * lsny + z * lsnz) / \
            rows.dist.clamp_min(1e-30)
        on = on & (dot_view <= F.SURFEL_NORMAL_TO_VIEWING_DIR_THRESHOLD)
        compat_needed = meas < z
        compat = (lsnx * p_mnx + lsny * p_mny + lsnz * p_mnz) >= cos_compat
        on = on & (~compat_needed | compat)
        on = on & (cols[F.RAD] >= 0)
        # Surfels replaced this frame are not updated (kernels.cu:937-940).
        on = on & (cols[F.CREATION].view(torch.int32) < frame_index)

        weight = 1.0 / counts.clamp_min(1.0)
        conf = cols[F.CONF]
        norm_factor = 1.0 / (conf + weight)

        cols[F.CONF] = torch.where(
            on, torch.clamp_max(conf + weight, params.max_surfel_confidence),
            cols[F.CONF])
        for k, g in ((F.PX, g_px), (F.PY, g_py), (F.PZ, g_pz)):
            cols[k] = torch.where(on, (conf * cols[k] + weight * g) *
                                  norm_factor, cols[k])
        bnx = conf * cols[F.NX] + weight * g_nx
        bny = conf * cols[F.NY] + weight * g_ny
        bnz = conf * cols[F.NZ] + weight * g_nz
        bl = sqrt_f32(bnx * bnx + bny * bny + bnz * bnz).clamp_min(1e-30)
        cols[F.NX] = torch.where(on, bnx / bl, cols[F.NX])
        cols[F.NY] = torch.where(on, bny / bl, cols[F.NY])
        cols[F.NZ] = torch.where(on, bnz / bl, cols[F.NZ])
        cols[F.RAD] = torch.where(on, torch.minimum(cols[F.RAD], p_rad),
                                  cols[F.RAD])
        # u8 color blend with +0.5 truncation (kernels.cu:962-967); the
        # update also clears the detach flag.
        for k, g in ((F.CR, m_cr), (F.CG, m_cg), (F.CB, m_cb)):
            cols[k] = torch.where(
                on, torch.floor((conf * cols[k] + weight * g) * norm_factor
                                + 0.5), cols[k])
        cols[F.DETACH] = torch.where(on, 0.0, cols[F.DETACH])
        cols[F.STAMP] = torch.where(on, frame_index,
                                    cols[F.STAMP].view(torch.int32)) \
            .view(torch.float32)
        return torch.stack(cols, dim=1), neighbors, nbr_dist

    base_on = rows.on & (pack[:, F.RAD] >= 0)
    on_b = base_on & rows.side_ok
    for pix, (pxf, pyf), on in (
            (_pixels(hw, w, rows.on, rows.px, rows.py), (rows.px, rows.py),
             base_on),
            (_pixels(hw, w, rows.on & rows.side_ok, rows.sx, rows.sy),
             (rows.sx, rows.sy), on_b)):
        pack, neighbors, nbr_dist = integrate_at(
            pack, neighbors, nbr_dist, pix, pxf.to(torch.float32),
            pyf.to(torch.float32), on)
    return pack, neighbors, nbr_dist


class _Args(ctypes.Structure):
    """csrc/integration.cu's IntegrateArgs, field for field."""
    _fields_ = [(name, kind) for names, kind in (
        (("pack",), ctypes.c_void_p), (("n",), ctypes.c_longlong),
        (("nbr_in",), ctypes.c_void_p), (("nbr_stride",), ctypes.c_longlong),
        (("dist_in",), ctypes.c_void_p),
        (("dist_stride",), ctypes.c_longlong),
        (("nbr_out", "dist_out", "on", "side_ok", "idx", "lx", "ly", "z",
          "dist", "px", "py", "sx", "sy", "meas", "premeas", "first",
          "counts", "rgb", "mnx", "mny", "mnz", "radius", "conflictor",
          "local_T_global", "global_T_local", "frame"), ctypes.c_void_p),
        (("frame_value", "width", "hw"), ctypes.c_int),
        (("one_minus_noise", "one_plus_noise", "fx_inv", "fy_inv", "cx_inv",
          "cy_inv", "cos_compat", "max_confidence", "view_threshold"),
         ctypes.c_float)) for name in names]


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """csrc/integration.cu, built on first use (ops/cuda_build.py) and
    loaded once."""
    lib = ctypes.CDLL(str(cuda_build.build("integration")))
    lib.integrate_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    lib.integrate_launch.restype = ctypes.c_int
    return lib


def _launch(args: _Args, device) -> None:
    """Launch the kernel on the current stream of `device`."""
    with torch.cuda.device(device):
        err = load_library().integrate_launch(
            ctypes.byref(args), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"integration kernel launch failed: CUDA error "
                           f"{err}")


# The kernel's element types of the rows and maps that are not f32.
_ROW_TYPES = dict(on=torch.bool, side_ok=torch.bool, idx=torch.int32,
                  px=torch.int32, py=torch.int32, sx=torch.int32,
                  sy=torch.int32)
_MAP_TYPES = dict(counts=torch.int32, conflictor=torch.int32)


def _checked(key: str, t: torch.Tensor, shape: tuple,
             dtype: torch.dtype) -> torch.Tensor:
    """`t` as the kernel reads it (contiguous); raises on a wrong dtype or
    shape."""
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"integrate_measurements: {key} must be {shape} "
                         f"{dtype}, got {tuple(t.shape)} {t.dtype}")
    return t.contiguous()


def integrate_measurements(params, pack: torch.Tensor,
                           neighbors: torch.Tensor, nbr_dist: torch.Tensor,
                           rows: Rows, maps: Maps,
                           local_T_global: torch.Tensor,
                           global_T_local: torch.Tensor, frame_index):
    """Phase 5 over the working rows: `pack` (n, 18) f32 after phase 3,
    `neighbors` (4, n) int32 and `nbr_dist` (4, n) f32, phase 1's `rows`,
    the frame's `maps`, the two (3, 4) f32 poses and the frame index (an
    int or a 0-d int32 tensor).  -> (pack, neighbors, nbr_dist).

    integrate_reference on CPU tensors; one launch of
    csrc/integration.cu on CUDA tensors, which updates `pack` in place and
    returns it with new neighbour tensors."""
    tensors = [pack, neighbors, nbr_dist, *rows,
               *(m for m in maps if m is not None), local_T_global,
               global_T_local]
    if isinstance(frame_index, torch.Tensor):
        tensors.append(frame_index)
    if not _on_card("integrate_measurements", *tensors):
        return integrate_reference(params, pack, neighbors, nbr_dist, rows,
                                   maps, local_T_global, global_T_local,
                                   frame_index)
    n = pack.shape[0]
    hw = maps.meas.shape[0]
    if pack.shape != (n, fusion.PACK_WIDTH) or pack.dtype != torch.float32 \
            or not pack.is_contiguous():
        raise ValueError(f"integrate_measurements: pack must be a "
                         f"contiguous ({n}, {fusion.PACK_WIDTH}) f32 tensor "
                         f"(it is updated in place), got "
                         f"{tuple(pack.shape)} {pack.dtype}")
    slots = []
    for key, t, dtype in (("neighbors", neighbors, torch.int32),
                          ("nbr_dist", nbr_dist, torch.float32)):
        if t.dtype != dtype or tuple(t.shape) != (4, n):
            raise ValueError(f"integrate_measurements: {key} must be "
                             f"(4, {n}) {dtype}, got {tuple(t.shape)} "
                             f"{t.dtype}")
        slots.append(t if t.stride(1) == 1 else t.contiguous())
    rows = Rows(*(_checked(k, t, (n,), _ROW_TYPES.get(k, torch.float32))
                  for k, t in rows._asdict().items()))
    maps = Maps(*(None if t is None else _checked(
        k, t, (hw,), _MAP_TYPES.get(k, torch.float32))
        for k, t in maps._asdict().items()))
    poses = [_checked(k, t, (3, 4), torch.float32) for k, t in (
        ("local_T_global", local_T_global),
        ("global_T_local", global_T_local))]
    frame = None
    if isinstance(frame_index, torch.Tensor):
        if frame_index.dtype != torch.int32 or frame_index.numel() != 1:
            raise ValueError(f"integrate_measurements: frame_index must be "
                             f"a 0-d int32 tensor, got "
                             f"{tuple(frame_index.shape)} {frame_index.dtype}")
        frame = frame_index.reshape(()).contiguous()
    if hw != params.width * params.height:
        raise ValueError(f"integrate_measurements: maps of {hw} pixels for "
                         f"a {params.width}x{params.height} frame")
    out_nbr = torch.empty((4, n), dtype=torch.int32, device=pack.device)
    out_dist = torch.empty((4, n), dtype=torch.float32, device=pack.device)
    noise = params.sensor_noise_factor
    fx_inv, fy_inv, cx_inv, cy_inv = params.unprojection
    ptr = {k: t.data_ptr() for k, t in (*rows._asdict().items(),
                                        *maps._asdict().items())
           if t is not None}
    # Python floats become f32 in ctypes' c_float fields (rounded to
    # nearest), as torch rounds a scalar multiplying an f32 tensor.
    args = _Args(
        pack=pack.data_ptr(), n=n, nbr_in=slots[0].data_ptr(),
        nbr_stride=slots[0].stride(0), dist_in=slots[1].data_ptr(),
        dist_stride=slots[1].stride(0), nbr_out=out_nbr.data_ptr(),
        dist_out=out_dist.data_ptr(), **ptr,
        local_T_global=poses[0].data_ptr(),
        global_T_local=poses[1].data_ptr(),
        frame=None if frame is None else frame.data_ptr(),
        frame_value=0 if frame is not None else int(frame_index),
        width=params.width, hw=hw, one_minus_noise=1.0 - noise,
        one_plus_noise=1.0 + noise, fx_inv=fx_inv, fy_inv=fy_inv,
        cx_inv=cx_inv, cy_inv=cy_inv, cos_compat=params.cos_normal_compat,
        max_confidence=params.max_surfel_confidence,
        view_threshold=fusion.SURFEL_NORMAL_TO_VIEWING_DIR_THRESHOLD)
    _launch(args, pack.device)
    integrate_measurements.launches += 1
    return pack, out_nbr, out_dist


launch_counts.register("integration", integrate_measurements)
