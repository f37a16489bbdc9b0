"""Tile selection of active-set fusion (ops/fusion.py::_integrate_tiled):
which whole tiles of `tile_size` rows a frame's working set must hold.

The full route changes, on frame f with regularisation window W, only
rows of these kinds (fusion._integrate_tiled's docstring says why):

  own:       the row projects into the image; its update stamp is at
             least f - W - 1 (inside the window, or inside it on the
             frame before, when regularisation last moved it); its
             stored recent-neighbour count (RCNT) is not 0;
  neighbour: a valid slot points at a row that projects into the image,
             whose update stamp is at least f - W - 1 or is 0 (a merge
             tombstone), or, without fast_neighbor_update, whose detach
             flag is set.

`row_flags_reference` flags the live rows (below surfel_count) of those
kinds, and a tile is flagged when one of its rows is.  The creation
frontier and the order of the working set (`select`) come after the flags
and stay plain.

Two routes for the flags, picked by the inputs' device alone (no flag, no
fallback):
- CPU tensors run `tile_flags_reference`, the plain PyTorch version over
  every row of the map: the tests' yardstick.
- CUDA tensors launch csrc/tiling.cu's `tile_select_kernel` once, on the
  current stream, with the surfel count and frame index read on the
  device and no host synchronisation, so a CUDA graph capture records it.
  Its launches are counted in `tile_flags.launches` (registered in
  ops/launch_counts.py as `tiling`).  Anything else raises.
The kernel equals the plain version as CUDA PyTorch runs it, bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

# fusion imports this module; its names are read at call time.
from . import cuda_build, fusion, launch_counts
from .association import INVALID_INDEX
from .preprocess import _on_card


def _in_view(params, local_T_global, x, y, z) -> torch.Tensor:
    """Whether global points project into the image (fusion._project of
    fusion._transform)."""
    lx, ly, lz = fusion._transform(local_T_global, x, y, z)
    return fusion._project(params, lx, ly, lz)[4]


def row_flags_reference(params, pack: torch.Tensor, neighbors: torch.Tensor,
                        surfel_count: torch.Tensor,
                        local_T_global: torch.Tensor,
                        frame_index) -> torch.Tensor:
    """(n,) bool: the live rows that the full route may change on frame
    `frame_index` (the module docstring's kinds)."""
    F = fusion
    n = pack.shape[0]
    dev = pack.device
    live = torch.arange(n, dtype=torch.int32, device=dev) < surfel_count
    stamps = pack.view(torch.int32)[:, F.STAMP]
    since = frame_index - params.regularization_frame_window_size - 1
    own = _in_view(params, local_T_global, pack[:, F.PX], pack[:, F.PY],
                   pack[:, F.PZ]) | (stamps >= since) | (pack[:, F.RCNT] != 0)
    slot = F._safe_idx(neighbors, n).long()                 # (4, n)
    slot_stamps = stamps[slot]
    hit = (slot_stamps >= since) | (slot_stamps == 0) | _in_view(
        params, local_T_global, pack[:, F.PX][slot], pack[:, F.PY][slot],
        pack[:, F.PZ][slot])
    if not params.fast_neighbor_update:
        hit = hit | (pack[:, F.DETACH][slot] > 0)
    return live & (own | ((neighbors != INVALID_INDEX) & hit).any(dim=0))


def tile_flags_reference(params, pack, neighbors, surfel_count,
                         local_T_global, frame_index) -> torch.Tensor:
    """Plain version of tile_flags."""
    rows = row_flags_reference(params, pack, neighbors, surfel_count,
                               local_T_global, frame_index)
    return rows.view(-1, params.tile_size).any(dim=1)


class _Args(ctypes.Structure):
    """csrc/tiling.cu's TileSelectArgs, field for field."""
    _fields_ = [(name, kind) for names, kind in (
        (("pack", "neighbors", "count", "local_T_global", "frame",
          "tile_flags"), ctypes.c_void_p),
        (("n",), ctypes.c_longlong),
        (("tile_size", "frame_value", "window", "width", "height", "fast"),
         ctypes.c_int),
        (("fx", "fy", "cx", "cy"), ctypes.c_float)) for name in names]


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """csrc/tiling.cu, built on first use (ops/cuda_build.py) and loaded
    once."""
    lib = ctypes.CDLL(str(cuda_build.build("tiling")))
    lib.tile_select_launch.argtypes = [ctypes.POINTER(_Args),
                                       ctypes.c_void_p]
    lib.tile_select_launch.restype = ctypes.c_int
    return lib


def _launch(args: _Args, device) -> None:
    """Launch the kernel on the current stream of `device`."""
    with torch.cuda.device(device):
        err = load_library().tile_select_launch(
            ctypes.byref(args), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tile_select kernel launch failed: CUDA error "
                           f"{err}")


def _checked(key: str, t: torch.Tensor, shape: tuple,
             dtype: torch.dtype) -> torch.Tensor:
    """`t` as the kernel reads it (contiguous); raises on a wrong dtype or
    shape."""
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"tile_flags: {key} must be {shape} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    return t.contiguous()


def tile_flags(params, pack: torch.Tensor, neighbors: torch.Tensor,
               surfel_count: torch.Tensor, local_T_global: torch.Tensor,
               frame_index) -> torch.Tensor:
    """(n // tile_size,) bool: the tiles holding a row that the full route
    may change on this frame, from the map's `pack` (n, 18) f32,
    `neighbors` (4, n) int32, its 0-d int32 `surfel_count`, the (3, 4) f32
    pose and the frame index (an int or a 0-d int32 tensor).

    tile_flags_reference on CPU tensors; one launch of csrc/tiling.cu on
    CUDA tensors."""
    tensors = [pack, neighbors, surfel_count, local_T_global]
    if isinstance(frame_index, torch.Tensor):
        tensors.append(frame_index)
    if not _on_card("tile_flags", *tensors):
        return tile_flags_reference(params, pack, neighbors, surfel_count,
                                    local_T_global, frame_index)
    n = pack.shape[0]
    ts = params.tile_size
    if n % ts != 0:
        raise ValueError(f"tile_flags: {n} rows are not whole tiles of {ts}")
    pack = _checked("pack", pack, (n, fusion.PACK_WIDTH), torch.float32)
    neighbors = _checked("neighbors", neighbors, (4, n), torch.int32)
    count = _checked("surfel_count", surfel_count.reshape(()), (),
                     torch.int32)
    pose = _checked("local_T_global", local_T_global, (3, 4), torch.float32)
    frame = None
    if isinstance(frame_index, torch.Tensor):
        frame = _checked("frame_index", frame_index.reshape(()), (),
                         torch.int32)
    flags = torch.zeros(n // ts, dtype=torch.bool, device=pack.device)
    # Python floats become f32 in ctypes' c_float fields (rounded to
    # nearest), as torch rounds a scalar multiplying an f32 tensor.
    args = _Args(
        pack=pack.data_ptr(), neighbors=neighbors.data_ptr(),
        count=count.data_ptr(), local_T_global=pose.data_ptr(),
        frame=None if frame is None else frame.data_ptr(),
        tile_flags=flags.data_ptr(), n=n, tile_size=ts,
        frame_value=0 if frame is not None else int(frame_index),
        window=params.regularization_frame_window_size, width=params.width,
        height=params.height, fast=int(params.fast_neighbor_update),
        fx=params.fx, fy=params.fy, cx=params.cx, cy=params.cy)
    _launch(args, pack.device)
    tile_flags.launches += 1
    return flags


launch_counts.register("tiling", tile_flags)


class Selection(NamedTuple):
    """A frame's working set: slot k of the k_cap working slots holds tile
    src_tiles[k]; the slots below num_live hold selected tiles (frontier
    first, then the flagged ones in tile order), the rest the first
    unselected tiles, gathered and written back unchanged.  total counts
    the tiles wanted (frontier + flagged), skipped those past k_cap."""
    src_tiles: torch.Tensor   # (k_cap,) int64
    slot_live: torch.Tensor   # (k_cap,) bool
    gidx: torch.Tensor        # (k_cap * tile_size,) int32 global row index,
                              #   INVALID_INDEX on unused slots
    total: torch.Tensor       # () int32
    skipped: torch.Tensor     # () int32


def select(params, state, local_T_global, frame_index, k_cap: int,
           c_budget: int) -> Selection:
    """The working set of a frame over `state`'s map: the creation
    frontier [surfel_count, surfel_count + c_budget) first, then the
    flagged tiles (tile_flags), capped at k_cap working slots."""
    ts = params.tile_size
    dev = state.pack.device
    count = state.surfel_count
    tflags = tile_flags(params, state.pack, state.neighbors, count,
                        local_T_global, frame_index)
    t_n = tflags.shape[0]
    tile_start = torch.arange(t_n, dtype=torch.int32, device=dev) * ts
    frontier = (tile_start < count + c_budget) & (tile_start + ts > count)
    f = frontier.to(torch.int32)
    o = (tflags & ~frontier).to(torch.int32)
    fpos = torch.cumsum(f, 0, dtype=torch.int32) - f
    opos = torch.cumsum(o, 0, dtype=torch.int32) - o + fpos[-1] + f[-1]
    pos = torch.where(frontier, fpos,
                      torch.where(o > 0, opos, INVALID_INDEX))
    selected = pos < k_cap
    total = opos[-1] + o[-1]

    # The selected tiles in slots [0, num_live), the first unselected
    # tiles after them (t_n > k_cap).
    num_live = selected.sum(dtype=torch.int32)
    spare = (~selected).to(torch.int32)
    spare_slot = num_live + torch.cumsum(spare, 0, dtype=torch.int32) - spare
    slot = torch.where(selected, pos, spare_slot).clamp_max(k_cap)
    src_tiles = torch.zeros(k_cap + 1, dtype=torch.int64, device=dev) \
        .scatter_(0, slot.long(), torch.arange(t_n, device=dev))[:k_cap]
    slot_live = torch.arange(k_cap, device=dev) < num_live
    gidx = torch.where(
        slot_live[:, None],
        src_tiles.to(torch.int32)[:, None] * ts +
        torch.arange(ts, dtype=torch.int32, device=dev), INVALID_INDEX) \
        .reshape(-1)
    return Selection(src_tiles, slot_live, gidx, total,
                     (total - k_cap).clamp_min(0))
