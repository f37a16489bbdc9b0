"""Phase 8 of the fusion step, regularisation, in its symmetric form (the
reference's kernels.cu:2099-2308; ops/fusion.py::_regularize calls it on
every route when symmetric_regularization is on, once an iteration).

One gradient-descent denoising iteration: each surfel's cross-term
gradient is gathered over its own neighbour slots assuming mutual
adjacency, using the neighbour's RCNT column (its recent-neighbour count
from the previous iteration or frame), and RCNT is rewritten.  Slots whose
neighbour drifted out of range (and, with fast_neighbor_update, slots at
merge tombstones) are dropped; every recent surfel then steps its smoothed
position with a data term toward the raw position, the step clamped to
its radius.  Neighbour rows are read by global index from `gsrc`: the pack
itself on the full route, the full pack with the working set written in
on the tiled route (an out-of-set neighbour contributes its stored RCNT),
the all-gathered pack on the sharded route.

Two routes, picked by the inputs' device alone (no flag, no fallback):
- CPU tensors run `regularize_reference`, the plain PyTorch version: eight
  (4, N) column gathers and ~150 elementwise ops.  It is the tests'
  yardstick.
- CUDA tensors launch csrc/regularization.cu once, on the current stream,
  with no host synchronisation, so a CUDA graph capture records it.  The
  kernel writes a new pack, new neighbour slots and, with
  fast_neighbor_update, new slot distances (without it the input's pass
  through, as in the plain version).  Its launches are counted in
  `regularize.launches` (registered in ops/launch_counts.py as
  `regularization`).  Anything else raises.
The kernel equals the plain version as CUDA PyTorch runs it, bit for bit.
The exact form (symmetric_regularization=False) is another algorithm and
stays plain on every device (fusion._regularize_exact).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

# fusion imports this module; its names are read at call time.
from . import cuda_build, fusion, launch_counts
from .association import INVALID_INDEX
from .preprocess import _on_card, sqrt_f32


def regularize_reference(pack, gsrc, neighbors, nbr_dist, frame_index,
                         params):
    """The plain version of regularize (its arguments)."""
    F = fusion
    n = gsrc.shape[0]
    w_reg = float(np.float32(params.regularizer_weight))
    window = params.regularization_frame_window_size
    reg_factor_sq = float(np.float32(
        params.radius_factor_for_regularization_neighbors ** 2))

    sx, sy, sz = pack[:, F.SX], pack[:, F.SY], pack[:, F.SZ]
    nx_, ny_, nz_ = pack[:, F.NX], pack[:, F.NY], pack[:, F.NZ]
    stamps = pack.view(torch.int32)[:, F.STAMP]

    slot_valid = neighbors != INVALID_INDEX                  # (4, N)
    # The neighbours' columns this pass reads, each gathered as (4, N):
    # whole neighbour rows would be the step's largest temporary.
    slot_idx = F._safe_idx(neighbors, n).long()

    def slot_col(col, dtype=torch.float32):
        return gsrc.view(dtype)[:, col][slot_idx]

    dx = slot_col(F.SX) - sx[None, :]
    dy = slot_col(F.SY) - sy[None, :]
    dz = slot_col(F.SZ) - sz[None, :]
    slot_stamps = slot_col(F.STAMP, torch.int32)
    snx, sny, snz = slot_col(F.NX), slot_col(F.NY), slot_col(F.NZ)
    cnt_i = slot_col(F.RCNT)
    del slot_idx
    use = slot_valid & (slot_stamps >= frame_index - window)

    cnt = F._slot_sum(use.to(torch.float32))
    ndot = nx_[None, :] * dx + ny_[None, :] * dy + nz_[None, :] * dz
    nbr_dist_sq = dx * dx + dy * dy + dz * dz

    recent_self = stamps >= frame_index - window
    pack = pack.clone()
    # Cross terms: the term i contributes to j is factor_i * (n_i .
    # (p_j - p_i)) * n_i, evaluated by j from the gathered (n_i, cnt_i)
    # with its own recency gating the edge (kernels.cu:2154-2161).
    pack[:, F.RCNT] = cnt          # for the next iteration / frame
    factor_i = torch.where(cnt_i > 0,
                           F._div(2.0 * w_reg, cnt_i.clamp_min(1.0)), 0.0)
    wcnt_i = torch.where(cnt_i > 0, F._div(w_reg, cnt_i.clamp_min(1.0)),
                         0.0)
    edge_on = slot_valid & recent_self[None, :]
    in_dot = -(snx * dx + sny * dy + snz * dz)        # n_i.(p_j - p_i)
    contrib = torch.where(edge_on, factor_i * in_dot, 0.0)
    grad_x = F._slot_sum(contrib * snx)
    grad_y = F._slot_sum(contrib * sny)
    grad_z = F._slot_sum(contrib * snz)
    gcount = F._slot_sum(torch.where(edge_on, wcnt_i, 0.0))

    # Remove active neighbors that drifted out of range (kernels.cu:2184-
    # 2192).  With fast_neighbor_update, slots pointing at merge tombstones
    # (stamp 0) go too: they stand in for the skipped detach sweep.
    drop = use & (nbr_dist_sq > reg_factor_sq * pack[:, F.RAD][None, :])
    if params.fast_neighbor_update:
        tombstoned = (slot_stamps == 0) & (frame_index > 0)
        drop = drop | (slot_valid & tombstoned)
    neighbors = torch.where(drop, INVALID_INDEX, neighbors)

    # Per-surfel step (kernels.cu:2197-2308) over the updated neighbor list.
    valid2 = neighbors != INVALID_INDEX
    ndot2 = torch.where(valid2, ndot, 0.0)
    cnt2 = F._slot_sum(valid2.to(torch.float32))
    sum_ndot2 = F._slot_sum(ndot2)
    factor2 = torch.where(cnt2 > 0, F._div(2.0 * w_reg, cnt2.clamp_min(1.0)),
                          0.0)
    reg_x = -sum_ndot2 * nx_
    reg_y = -sum_ndot2 * ny_
    reg_z = -sum_ndot2 * nz_

    gx = 2.0 * (sx - pack[:, F.PX]) + grad_x + factor2 * reg_x
    gy = 2.0 * (sy - pack[:, F.PY]) + grad_y + factor2 * reg_y
    gz = 2.0 * (sz - pack[:, F.PZ]) + grad_z + factor2 * reg_z
    weight_sum = (1.0 + w_reg) + gcount
    step = F._div(0.5, weight_sum)
    max_step = sqrt_f32(pack[:, F.RAD])   # NaN for merged surfels, as in CUDA
    grad_len = step * sqrt_f32(gx * gx + gy * gy + gz * gz)
    step_factor = torch.where(grad_len > max_step,
                              max_step / grad_len.clamp_min(1e-30) * step,
                              step)
    pack[:, F.SX] = torch.where(recent_self, sx - step_factor * gx, sx)
    pack[:, F.SY] = torch.where(recent_self, sy - step_factor * gy, sy)
    pack[:, F.SZ] = torch.where(recent_self, sz - step_factor * gz, sz)
    if params.fast_neighbor_update:
        # The stored slot distances the next neighbor update replaces
        # against, from this pass's smoothed positions.
        nbr_dist = torch.where(valid2, nbr_dist_sq, math.inf)
    return pack, neighbors, nbr_dist


class _Args(ctypes.Structure):
    """csrc/regularization.cu's RegularizeArgs, field for field."""
    _fields_ = [(name, kind) for names, kind in (
        (("pack", "gsrc", "nbr_in"), ctypes.c_void_p),
        (("nbr_stride",), ctypes.c_longlong),
        (("pack_out", "nbr_out", "dist_out", "frame"), ctypes.c_void_p),
        (("n", "n_src"), ctypes.c_longlong),
        (("frame_value", "window"), ctypes.c_int),
        (("two_w", "w", "one_plus_w", "reg_factor_sq"), ctypes.c_float))
        for name in names]


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """csrc/regularization.cu, built on first use (ops/cuda_build.py) and
    loaded once."""
    lib = ctypes.CDLL(str(cuda_build.build("regularization")))
    lib.regularize_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    lib.regularize_launch.restype = ctypes.c_int
    return lib


def _launch(args: _Args, device) -> None:
    """Launch the kernel on the current stream of `device`."""
    with torch.cuda.device(device):
        err = load_library().regularize_launch(
            ctypes.byref(args), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"regularization kernel launch failed: CUDA "
                           f"error {err}")


def _pack_rows(key: str, t: torch.Tensor) -> torch.Tensor:
    """`t` as the kernel reads it, a contiguous (rows, 18) f32 pack;
    raises on a wrong dtype or shape."""
    if t.dtype != torch.float32 or t.dim() != 2 or \
            t.shape[1] != fusion.PACK_WIDTH:
        raise ValueError(f"regularize: {key} must be (rows, "
                         f"{fusion.PACK_WIDTH}) f32, got {tuple(t.shape)} "
                         f"{t.dtype}")
    return t.contiguous()


def regularize(pack: torch.Tensor, gsrc: torch.Tensor,
               neighbors: torch.Tensor, nbr_dist: torch.Tensor, frame_index,
               params):
    """One symmetric regularisation iteration over the working rows:
    `pack` (n, 18) f32, `gsrc` (n_src, 18) f32 (the rows the slots index;
    `pack` itself on the full route), `neighbors` (4, n) int32, `nbr_dist`
    (4, n) f32, the frame index (an int or a 0-d int32 tensor) and the
    fusion parameters.  -> (pack, neighbors, nbr_dist), new tensors but
    for nbr_dist without fast_neighbor_update (the input's).

    regularize_reference on CPU tensors; one launch of
    csrc/regularization.cu on CUDA tensors."""
    tensors = [pack, gsrc, neighbors, nbr_dist]
    if isinstance(frame_index, torch.Tensor):
        tensors.append(frame_index)
    if not _on_card("regularize", *tensors):
        return regularize_reference(pack, gsrc, neighbors, nbr_dist,
                                    frame_index, params)
    pack = _pack_rows("pack", pack)
    gsrc = _pack_rows("gsrc", gsrc)
    n = pack.shape[0]
    if n > 0 and gsrc.shape[0] == 0:
        raise ValueError("regularize: gsrc has no rows")
    for key, t, dtype in (("neighbors", neighbors, torch.int32),
                          ("nbr_dist", nbr_dist, torch.float32)):
        if t.dtype != dtype or tuple(t.shape) != (4, n):
            raise ValueError(f"regularize: {key} must be (4, {n}) {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if neighbors.stride(1) != 1:
        neighbors = neighbors.contiguous()
    frame = None
    if isinstance(frame_index, torch.Tensor):
        if frame_index.dtype != torch.int32 or frame_index.numel() != 1:
            raise ValueError(f"regularize: frame_index must be a 0-d int32 "
                             f"tensor, got {tuple(frame_index.shape)} "
                             f"{frame_index.dtype}")
        frame = frame_index.reshape(()).contiguous()
    out = torch.empty_like(pack)
    out_nbr = torch.empty((4, n), dtype=torch.int32, device=pack.device)
    out_dist = torch.empty((4, n), dtype=torch.float32, device=pack.device) \
        if params.fast_neighbor_update else nbr_dist
    w_reg = float(np.float32(params.regularizer_weight))
    # Python floats become f32 in ctypes' c_float fields (rounded to
    # nearest), as torch rounds a scalar combined with an f32 tensor.
    args = _Args(
        pack=pack.data_ptr(), gsrc=gsrc.data_ptr(),
        nbr_in=neighbors.data_ptr(), nbr_stride=neighbors.stride(0),
        pack_out=out.data_ptr(), nbr_out=out_nbr.data_ptr(),
        dist_out=out_dist.data_ptr() if params.fast_neighbor_update
        else None,
        frame=None if frame is None else frame.data_ptr(), n=n,
        n_src=gsrc.shape[0],
        frame_value=0 if frame is not None else int(frame_index),
        window=params.regularization_frame_window_size, two_w=2.0 * w_reg,
        w=w_reg, one_plus_w=1.0 + w_reg,
        reg_factor_sq=float(np.float32(
            params.radius_factor_for_regularization_neighbors ** 2)))
    _launch(args, pack.device)
    regularize.launches += 1
    return out, out_nbr, out_dist


launch_counts.register("regularization", regularize)
