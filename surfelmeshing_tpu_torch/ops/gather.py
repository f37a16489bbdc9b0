"""Row gathers: the hand-written CUDA kernels, their wrappers and their
plain PyTorch versions.

Ports of the three Pallas kernels of tools/gather_probe.py::run, whose one
semantics is `src[idx]` over a (HW, 8) f32 source:

  gather_rows(src, idx)     <- pallas_gather       -> (N, 8)
  gather_rows3(srcs, idx)   <- pallas_gather3      -> three (N, 8)
  gather_lane(src, idx)     <- pallas_gather_lane  -> (N, 8), gathered from
                               the transposed (8, HW) source, returned as .T

Indices clamp to [0, HW-1] (`jnp.take(..., mode="clip")`; for indices >= 0
the same as JAX's `src[idx]`, which wraps negative ones).  Rows are moved as bits: NaN payloads and -0.0
arrive unchanged in the kernels and in the plain versions, which gather
through an int32 view.

On CPU tensors the wrappers run the plain versions (`*_reference`); on
CUDA tensors they launch csrc/gather.cu on the current stream (no
synchronisation) or raise.  Each wrapper counts its launches in
`<wrapper>.launches` (registered in ops/launch_counts.py).  The library
is built at first use (ops/cuda_build.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from . import cuda_build, launch_counts

COLS = 8      # f32 columns per row: 32 bytes, two 16-byte vectors


def _clamped(idx: torch.Tensor, hw: int) -> torch.Tensor:
    return idx.long().clamp(0, hw - 1)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def gather_rows_reference(src: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Plain version: src[clamp(idx)] for a (HW, C) f32 source."""
    return _bits(src)[_clamped(idx, src.shape[0])].view(src.dtype)


def gather_rows3_reference(srcs: Sequence[torch.Tensor], idx: torch.Tensor
                           ) -> Tuple[torch.Tensor, ...]:
    """Plain version: each source gathered by the one index vector."""
    return tuple(gather_rows_reference(s, idx) for s in srcs)


def gather_lane_reference(src: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Plain version of the transposed form: srcT = src.T (C, HW) gathered
    along its last dimension, returned transposed to (N, C)."""
    src_t = src.t().contiguous()
    return _bits(src_t)[:, _clamped(idx, src.shape[0])].view(src.dtype).t()


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    lib = ctypes.CDLL(str(cuda_build.build("gather")))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.gather_rows_launch.argtypes = [ptr, ptr, ptr, i64, i32, ptr]
    lib.gather_rows3_launch.argtypes = [ptr] * 7 + [i64, i32, ptr]
    lib.gather_lane_launch.argtypes = [ptr, ptr, ptr, ptr, i64, i32, ptr]
    for fn in (lib.gather_rows_launch, lib.gather_rows3_launch,
               lib.gather_lane_launch):
        fn.restype = ctypes.c_int
    return lib


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check(name: str, srcs, idx: torch.Tensor, shape) -> None:
    """Raise unless every source is a contiguous, 16-byte aligned f32
    tensor of `shape` and idx a contiguous 1-D int32 tensor, all on one
    CUDA device."""
    device = idx.device
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    if idx.dtype != torch.int32 or idx.dim() != 1 or \
            not idx.is_contiguous():
        raise ValueError(f"{name}: idx must be a contiguous 1-D int32 "
                         "tensor")
    for s in srcs:
        if s.device != device or s.dtype != torch.float32 or \
                tuple(s.shape) != tuple(shape) or not s.is_contiguous() or \
                s.data_ptr() % 16:
            raise ValueError(
                f"{name}: sources must be contiguous, 16-byte aligned "
                f"float32 {tuple(shape)} tensors on {device}")
    if shape[0] < 1 or shape[-1] < 1:
        raise ValueError(f"{name}: empty source")


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, 8) f32 rows src[clamp(idx)] of a (HW, 8) f32 source."""
    if _on_cpu(src, idx):
        return gather_rows_reference(src, idx)
    hw = src.shape[0]
    _check("gather_rows", [src], idx, (hw, COLS))
    n = idx.shape[0]
    out = torch.empty((n, COLS), dtype=src.dtype, device=src.device)
    if n == 0:
        return out
    with torch.cuda.device(src.device):
        _launch("gather_rows", load_library().gather_rows_launch,
                src.data_ptr(), idx.data_ptr(), out.data_ptr(), n, hw,
                _stream(src.device))
    gather_rows.launches += 1
    return out


def gather_rows3(srcs: Sequence[torch.Tensor], idx: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Three (HW, 8) f32 sources gathered by one index vector in one
    launch -> three (N, 8) f32."""
    if len(srcs) != 3:
        raise ValueError("gather_rows3: needs exactly three sources")
    if _on_cpu(*srcs, idx):
        return gather_rows3_reference(srcs, idx)
    hw = srcs[0].shape[0]
    _check("gather_rows3", srcs, idx, (hw, COLS))
    n = idx.shape[0]
    outs = tuple(torch.empty((n, COLS), dtype=torch.float32,
                             device=idx.device) for _ in range(3))
    if n == 0:
        return outs
    with torch.cuda.device(idx.device):
        _launch("gather_rows3", load_library().gather_rows3_launch,
                *(s.data_ptr() for s in srcs), idx.data_ptr(),
                *(o.data_ptr() for o in outs), n, hw, _stream(idx.device))
    gather_rows3.launches += 1
    return outs


def gather_lane(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The transposed form: the (HW, 8) source is laid out (8, HW), each
    index is gathered across the 8 planes into an (8, N) result, and its
    transpose (an (N, 8) view) is returned, as the JAX probe returns
    `out.T`.  A source that is already the transpose of a contiguous
    (8, HW) tensor is used as it lies; any other is copied to that
    layout first.  On the card one call runs two kernels: the planes are
    transposed into a (HW, 8) scratch of rows, then gathered from it."""
    if _on_cpu(src, idx):
        return gather_lane_reference(src, idx)
    hw = src.shape[0]
    src_t = src.t().contiguous()     # no copy when src is a view of (8, HW)
    _check("gather_lane", [src_t], idx, (COLS, hw))
    n = idx.shape[0]
    out_t = torch.empty((COLS, n), dtype=src.dtype, device=src.device)
    if n == 0:
        return out_t.t()
    rows = torch.empty((hw, COLS), dtype=src.dtype, device=src.device)
    with torch.cuda.device(src.device):
        _launch("gather_lane", load_library().gather_lane_launch,
                src_t.data_ptr(), idx.data_ptr(), out_t.data_ptr(),
                rows.data_ptr(), n, hw, _stream(src.device))
    gather_lane.launches += 1
    return out_t.t()


launch_counts.register("gather_rows", gather_rows)
launch_counts.register("gather_rows3", gather_rows3)
launch_counts.register("gather_lane", gather_lane)
