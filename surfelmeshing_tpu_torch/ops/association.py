"""Data association's per-pixel maps: phases 1-2 of the fusion step
(ops/fusion.py::_integrate_body) as scatters of per-row candidates.

Each surfel row has two candidate pixels, its own (`pix_a`) and a side
pixel (`pix_b`), int32 flat indices into an (H*W,) map or INVALID_INDEX.
Three maps are built from them, each an order-independent reduction, so
deterministic:

  min_depth_map   first_depth: the least z at each pixel (+inf where none)
  support_maps    supporting_surfels: the least supporter index at each
                  pixel (INVALID_INDEX where none), and packed: the
                  supporters' count (above SUM_BITS) and depth sum (below,
                  in depth units) in one int32 sum
  min_index_map   a least-index map alone (the exact conflictor map)

Two routes, picked by the inputs' device alone (no flag, no fallback):
- CPU tensors run the plain versions, `pixel_map` scatters of the 2N
  entries cat([a, b]): the tests' yardstick.
- CUDA tensors launch csrc/association.cu on the current stream, with
  maps from torch.full and no host synchronisation, so a CUDA graph
  capture records them: one launch for the min-depth map and one for the
  support maps (or a min-index map), each counted in its wrapper's
  `launches` (registered in ops/launch_counts.py as association_min_depth
  and association_support).  Anything else raises.
The kernels skip every entry whose pixel is not in [0, H*W), where the
plain version sends INVALID_INDEX entries to a dropped slot (and raises
on other pixels out of range); they equal it bit for bit on what the step
gives them: every in-image entry of min_depth_map has z > 0.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from . import cuda_build, launch_counts
from .preprocess import _on_card

INVALID_INDEX = 2 ** 31 - 1
SUM_BITS = 25   # support count + depth sum share one int32 (see phase 2)
DEPTH_UNITS_MAX = (1 << 17) - 1


def pixel_map(hw: int, pix: torch.Tensor, values: torch.Tensor,
              fill, reduce: str) -> torch.Tensor:
    """Scatter-reduce `values` into an (hw,) map at `pix`; entries whose
    pixel is INVALID_INDEX land in a dropped extra slot."""
    out = torch.full((hw + 1,), fill, dtype=values.dtype, device=values.device)
    index = torch.where(pix == INVALID_INDEX, hw, pix).to(torch.int64)
    if reduce == "sum":
        out.scatter_add_(0, index, values)
    else:
        out.scatter_reduce_(0, index, values, reduce, include_self=True)
    return out[:hw]


def depth_units(z: torch.Tensor, depth_scaling: float) -> torch.Tensor:
    """z in depth units, rounded half to even and clamped to 17 bits."""
    return torch.round(z * depth_scaling) \
        .clamp(0, DEPTH_UNITS_MAX).to(torch.int32)


def min_depth_map_reference(hw: int, pix_a: torch.Tensor,
                            pix_b: torch.Tensor,
                            z: torch.Tensor) -> torch.Tensor:
    """Plain version of min_depth_map."""
    return pixel_map(hw, torch.cat([pix_a, pix_b]), torch.cat([z, z]),
                     math.inf, "amin")


def min_index_map_reference(hw: int, pix_a: torch.Tensor,
                            pix_b: torch.Tensor, on_a: torch.Tensor,
                            on_b: torch.Tensor,
                            idx: torch.Tensor) -> torch.Tensor:
    """Plain version of min_index_map."""
    return pixel_map(hw, torch.cat([pix_a, pix_b]),
                     torch.cat([torch.where(on_a, idx, INVALID_INDEX),
                                torch.where(on_b, idx, INVALID_INDEX)]),
                     INVALID_INDEX, "amin")


def support_maps_reference(hw: int, pix_a: torch.Tensor, pix_b: torch.Tensor,
                           support_a: torch.Tensor, support_b: torch.Tensor,
                           idx: torch.Tensor, z: torch.Tensor,
                           depth_scaling: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of support_maps."""
    sup_pix = torch.cat([torch.where(support_a, pix_a, INVALID_INDEX),
                         torch.where(support_b, pix_b, INVALID_INDEX)])
    supporting = pixel_map(hw, sup_pix, torch.cat([idx, idx]),
                           INVALID_INDEX, "amin")
    unit = depth_units(z, depth_scaling) + (1 << SUM_BITS)
    packed = pixel_map(hw, sup_pix,
                       torch.cat([torch.where(support_a, unit, 0),
                                  torch.where(support_b, unit, 0)]),
                       0, "sum")
    return supporting, packed


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """csrc/association.cu, built on first use (ops/cuda_build.py) and
    loaded once."""
    lib = ctypes.CDLL(str(cuda_build.build("association")))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.min_depth_launch.argtypes = [ptr, ptr, ptr, i64, ptr, i32, ptr]
    lib.support_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64,
                                   ctypes.c_double, ptr, ptr, i32, ptr]
    lib.min_depth_launch.restype = ctypes.c_int
    lib.support_launch.restype = ctypes.c_int
    return lib


def _rows(name: str, n: int, **arrays) -> list:
    """The row arrays as the kernels read them (contiguous, one dtype
    each); raises on a wrong dtype or length."""
    want = {"pix_a": torch.int32, "pix_b": torch.int32, "idx": torch.int32,
            "z": torch.float32, "on_a": torch.bool, "on_b": torch.bool}
    out = []
    for key, t in arrays.items():
        if t.dtype != want[key] or t.shape != (n,):
            raise ValueError(f"{name}: {key} must be ({n},) {want[key]}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        out.append(t.contiguous())
    return out


def _launch(kernel: str, device, *args) -> None:
    """Launch `kernel` on the current stream of `device`."""
    with torch.cuda.device(device):
        err = getattr(load_library(), f"{kernel}_launch")(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"association {kernel} kernel launch failed: "
                           f"CUDA error {err}")


def min_depth_map(hw: int, pix_a: torch.Tensor, pix_b: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
    """(hw,) f32 least z of the entries at each pixel, +inf where none:
    the plain scatter on CPU tensors, one launch of csrc/association.cu's
    min_depth_kernel on CUDA tensors."""
    name = "min_depth_map"
    if not _on_card(name, pix_a, pix_b, z):
        return min_depth_map_reference(hw, pix_a, pix_b, z)
    n = pix_a.shape[0]
    pix_a, pix_b, z = _rows(name, n, pix_a=pix_a, pix_b=pix_b, z=z)
    out = torch.full((hw,), math.inf, dtype=torch.float32, device=z.device)
    _launch("min_depth", z.device, pix_a.data_ptr(), pix_b.data_ptr(),
            z.data_ptr(), n, out.data_ptr(), hw)
    KERNELS["min_depth"].launches += 1
    return out


def _min_index(name: str, hw: int, pix_a, pix_b, on_a, on_b, idx, z,
               depth_scaling, sums: bool):
    """One launch of support_kernel: the min-index map and, with `sums`,
    the packed map."""
    n = pix_a.shape[0]
    tensors = dict(pix_a=pix_a, pix_b=pix_b, on_a=on_a, on_b=on_b, idx=idx)
    if sums:
        tensors["z"] = z
    rows = _rows(name, n, **tensors)
    dev = idx.device
    index = torch.full((hw,), INVALID_INDEX, dtype=torch.int32, device=dev)
    packed = torch.zeros((hw,), dtype=torch.int32, device=dev) \
        if sums else None
    _launch("support", dev, *(t.data_ptr() for t in rows[:5]),
            rows[5].data_ptr() if sums else None, n, float(depth_scaling),
            index.data_ptr(), packed.data_ptr() if sums else None, hw)
    KERNELS["support"].launches += 1
    return index, packed


def support_maps(hw: int, pix_a: torch.Tensor, pix_b: torch.Tensor,
                 support_a: torch.Tensor, support_b: torch.Tensor,
                 idx: torch.Tensor, z: torch.Tensor, depth_scaling: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The supporter maps of phase 2, from the sides that support (pix_a
    where `support_a`, pix_b where `support_b`): supporting_surfels, the
    least `idx` at each pixel (INVALID_INDEX where none), and packed, the
    int32 sum of depth_units(z) + (1 << SUM_BITS).  The plain scatters on
    CPU tensors, one launch of csrc/association.cu's support_kernel on
    CUDA tensors."""
    name = "support_maps"
    tensors = (pix_a, pix_b, support_a, support_b, idx, z)
    if not _on_card(name, *tensors):
        return support_maps_reference(hw, *tensors, depth_scaling)
    return _min_index(name, hw, *tensors, depth_scaling, sums=True)


def min_index_map(hw: int, pix_a: torch.Tensor, pix_b: torch.Tensor,
                  on_a: torch.Tensor, on_b: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
    """(hw,) int32 least `idx` at each pixel over pix_a where `on_a` and
    pix_b where `on_b`, INVALID_INDEX where none: the plain scatter on
    CPU tensors, one launch of support_kernel without sums on CUDA tensors
    (counted with support_maps')."""
    name = "min_index_map"
    tensors = (pix_a, pix_b, on_a, on_b, idx)
    if not _on_card(name, *tensors):
        return min_index_map_reference(hw, *tensors)
    return _min_index(name, hw, *tensors, None, 0.0, sums=False)[0]


# The card route's kernels (csrc/association.cu), by name, and the
# wrappers that count their launches.
KERNELS = {"min_depth": min_depth_map, "support": support_maps}
for _kernel, _wrapper in KERNELS.items():
    launch_counts.register(f"association_{_kernel}", _wrapper)


def launches() -> dict:
    """Each association kernel's launches so far, by kernel name."""
    return {kernel: fn.launches for kernel, fn in KERNELS.items()}
