"""Surfel fusion engine in PyTorch.

Counterpart of surfelmeshing_tpu/ops/fusion.py: the reference's CUDA surfel
reconstruction (cuda_surfel_reconstruction_kernels.cu, sequenced by
cuda_surfel_reconstruction.cc:112-320) as one functional update of a
fixed-capacity packed surfel map.

The port follows the JAX package's default single-device semantics in the
form its golden oracle states (tests/golden_fusion.py): the per-pixel maps
are built with order-independent scatter reductions (amin, integer add), so
they are deterministic (ops/association.py: plain scatters on the CPU,
csrc/association.cu's atomics on the card); the supporter and conflictor
races of the reference are resolved by the min-index rule.  Phase 5,
"integrate measurements", is ops/integration.py (plain PyTorch on the CPU,
csrc/integration.cu on the card); phase 8, regularisation, in its
symmetric form is ops/regularization.py (likewise,
csrc/regularization.cu).
integrate_frame runs the per-surfel phases over the whole capacity,
masked by `surfel_count`, which stays on the device: a frame needs no
host synchronisation.  With an active-surfel budget they run instead
over a working set of whole tiles (the JAX package's active-set tiling,
`_integrate_tiled`).
integrate_frame_bucketed runs them over the first n_eff rows only, the
reference's count-sized launches; the pipeline picks n_eff from a bound
on the surfel count whenever no active-surfel budget is set
(pipeline.py).

State layout is the JAX package's: one packed (N, PACK_WIDTH) f32 matrix
whose int32 columns (STAMP, CREATION) ride in f32 lanes as bit patterns
(read and written only through `.view(torch.int32)`), plus slot-major
(4, N) neighbor indices and squared slot distances.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from . import association, integration, regularization, tiling
from .association import INVALID_INDEX, SUM_BITS
from .blend import blend_core
from .preprocess import sqrt_f32, to_i32_trunc
from ..utils.timing import tracer

# Constants fixed in the reference (kernels.cu:50-74).
SURFEL_NORMAL_TO_VIEWING_DIR_THRESHOLD = 0.0
MAX_OBSERVATION_RADIUS_FACTOR = 1.5          # kernels.cu:58
MERGE_RADIUS_DIFF_THRESHOLD_SQ = 1.2 ** 2    # kernels.cu:1959-1960
MERGE_DISTANCE_FACTOR = 0.5 * 0.25 * 0.25    # kernels.cu:1971
MERGE_COS_NORMAL_THRESHOLD = 0.93969         # 20 deg, kernels.cu:1981

# Pack column indices (same map as surfelmeshing_tpu.ops.fusion).
PX, PY, PZ = 0, 1, 2          # raw position
SX, SY, SZ = 3, 4, 5          # smoothed position
STAMP = 6                     # last-update stamp (int32 bits)
NX, NY, NZ = 7, 8, 9          # normal
RCNT = 10                     # last-computed recent-neighbor count (f32)
DETACH = 11                   # neighbor detach request flag (0.0 / 1.0)
CONF = 12                     # confidence
RAD = 13                      # squared radius (-1 == merged away)
CR, CG, CB = 14, 15, 16       # color (0..255 in f32)
CREATION = 17                 # creation stamp (int32 bits)
PACK_WIDTH = 18
_INT_COLS = (STAMP, CREATION)


@dataclasses.dataclass
class SurfelState:
    """Fixed-capacity packed surfel map on one device."""
    pack: torch.Tensor            # (N, PACK_WIDTH) f32
    neighbors: torch.Tensor       # (4, N) int32, INVALID_INDEX = none
    nbr_dist: torch.Tensor        # (4, N) f32 squared slot distances
    surfel_count: torch.Tensor    # () int32
    merge_count: torch.Tensor     # () int32
    overflow_count: torch.Tensor  # () int32: creations dropped at capacity
    deferred_count: torch.Tensor  # () int32: creations deferred to a later
                                  #   frame by the per-frame budget or the
                                  #   bucket (running total)
    skipped_tile_count: torch.Tensor  # () int32: tiles past the active budget
    active_tile_count: torch.Tensor   # () int32: tiles the last tiled frame
                                      #   wanted (frontier + flagged)


def _scalar(value: int, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.int32, device=device)


def _frame_scalar(frame_index, device):
    """The frame index as the step takes it: a Python int as it is, a
    tensor as a 0-d int32 tensor on `device`.  A device tensor keeps the
    step free of host values that a CUDA graph would bake in; both give
    the same bits."""
    if isinstance(frame_index, torch.Tensor):
        return frame_index.to(device=device, dtype=torch.int32).reshape(())
    return int(frame_index)


def create_surfel_state(capacity: int, device) -> SurfelState:
    device = resolve_device(device)
    pack = torch.zeros((capacity, PACK_WIDTH), dtype=torch.float32,
                       device=device)
    pack.view(torch.int32)[:, STAMP] = -(2 ** 30)
    return SurfelState(
        pack=pack,
        neighbors=torch.full((4, capacity), INVALID_INDEX, dtype=torch.int32,
                             device=device),
        nbr_dist=torch.full((4, capacity), math.inf, dtype=torch.float32,
                            device=device),
        surfel_count=_scalar(0, device),
        merge_count=_scalar(0, device),
        overflow_count=_scalar(0, device),
        deferred_count=_scalar(0, device),
        skipped_tile_count=_scalar(0, device),
        active_tile_count=_scalar(0, device))


def state_from_numpy(pack, neighbors, nbr_dist, surfel_count, merge_count,
                     overflow_count, device, skipped_tile_count=0,
                     active_tile_count=0, deferred_count=0) -> SurfelState:
    """A state from host arrays (e.g. the JAX package's state, converted
    with np.asarray, which has no deferred_count); bit patterns of the
    int32 columns are kept."""
    device = resolve_device(device)

    def tensor(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

    return SurfelState(
        pack=tensor(pack, np.float32),
        neighbors=tensor(neighbors, np.int32),
        nbr_dist=tensor(nbr_dist, np.float32),
        surfel_count=tensor(surfel_count, np.int32).reshape(()),
        merge_count=tensor(merge_count, np.int32).reshape(()),
        overflow_count=tensor(overflow_count, np.int32).reshape(()),
        deferred_count=tensor(deferred_count, np.int32).reshape(()),
        skipped_tile_count=tensor(skipped_tile_count, np.int32).reshape(()),
        active_tile_count=tensor(active_tile_count, np.int32).reshape(()))


def state_to_numpy(state: SurfelState) -> dict:
    """Host copy of the state: arrays under the SurfelState field names."""
    return {f.name: getattr(state, f.name).cpu().numpy()
            for f in dataclasses.fields(SurfelState)}


# -- convenience accessors (host/test side) ---------------------------------

def positions(state: SurfelState) -> torch.Tensor:
    return state.pack[:, PX:PZ + 1]


def smooth_positions(state: SurfelState) -> torch.Tensor:
    return state.pack[:, SX:SZ + 1]


def normals(state: SurfelState) -> torch.Tensor:
    return state.pack[:, NX:NZ + 1]


def confidences(state: SurfelState) -> torch.Tensor:
    return state.pack[:, CONF]


def radii_sq(state: SurfelState) -> torch.Tensor:
    return state.pack[:, RAD]


def colors_u8(state: SurfelState) -> torch.Tensor:
    return state.pack[:, CR:CB + 1].clamp(0, 255).to(torch.uint8)


def creation_stamps(state: SurfelState) -> torch.Tensor:
    return state.pack.view(torch.int32)[:, CREATION]


def update_stamps(state: SurfelState) -> torch.Tensor:
    return state.pack.view(torch.int32)[:, STAMP]


def plant_surfel(state: SurfelState, index: int, pos, normal,
                 confidence: float = 1.0, radius_sq: float = 1e-4,
                 creation: int = 0, stamp: int = 0,
                 smooth=None, color=(128, 128, 128)) -> SurfelState:
    """Test helper: a copy of the state with one surfel's attributes set."""
    row = np.zeros(PACK_WIDTH, np.float32)
    row[PX:PZ + 1] = pos
    row[SX:SZ + 1] = pos if smooth is None else smooth
    row[NX:NZ + 1] = normal
    row[CONF] = confidence
    row[RAD] = radius_sq
    row[CR:CB + 1] = color
    row[CREATION] = np.int32(creation).view(np.float32)
    row[STAMP] = np.int32(stamp).view(np.float32)
    pack = state.pack.clone()
    pack[index] = torch.from_numpy(row).to(pack.device)
    return dataclasses.replace(state, pack=pack)


@dataclasses.dataclass(frozen=True)
class FusionParams:
    """Fusion parameters; the semantic fields of the JAX package's
    FusionParams with the same defaults, including active-set tiling
    (active_surfel_budget, tile_size).  Its TPU dispatch fields
    (sorted_pixel_maps, mega_sort, pallas_blending, debug_stop_after) have
    no counterpart here."""
    width: int
    height: int
    fx: float
    fy: float
    cx: float            # pixel-corner convention
    cy: float
    depth_scaling: float = 5000.0
    sensor_noise_factor: float = 0.05
    max_surfel_confidence: float = 5.0
    normal_compatibility_threshold_deg: float = 40.0
    regularizer_weight: float = 10.0
    regularization_frame_window_size: int = 30
    do_blending: bool = True
    measurement_blending_radius: int = 12
    regularization_iterations: int = 1
    radius_factor_for_regularization_neighbors: float = 2.0
    surfel_integration_active_window_size: int = 2 ** 31 - 1
    # Creations beyond this per-frame budget are dropped and re-attempted
    # next frame (their pixels stay unsupported).
    max_creations_per_frame: int = 2 ** 15
    # Active-set tiling: when 0 < active_surfel_budget < capacity, each
    # frame runs every per-surfel phase on a working set of whole tiles of
    # `tile_size` rows: the creation frontier, then the tiles holding a
    # live surfel that projects into the image or was updated within the
    # regularization window, up to budget // tile_size tiles.  Tiles past
    # the budget are skipped for the frame (skipped_tile_count).  Requires
    # capacity % tile_size == 0.  0 processes every row every frame.
    active_surfel_budget: int = 0
    tile_size: int = 4096
    # Reference-parity modes of the JAX package (its FusionParams documents
    # each); the defaults are the semantics the golden oracle states.
    # False: the exact i -> j regularization cross terms, summed by
    #   _ordered_scatter_add in stream order (full shapes only, no tiling).
    symmetric_regularization: bool = True
    # True: the min-index conflictor map; a surfel decrements only where it
    #   is the pixel's conflictor, and creation tests the map.
    exact_conflict_arbitration: bool = False
    # False: existing neighbor slots re-gather their distance and detach
    #   flag every frame, flagged candidates are inserted, and a detach
    #   sweep closes phase 6 (kernels.cu:1302-1322, 1420-1437).
    fast_neighbor_update: bool = True

    @property
    def cos_normal_compat(self) -> float:
        return float(np.cos(np.pi / 180.0 *
                            self.normal_compatibility_threshold_deg))

    @property
    def active_window(self) -> int:
        # Clamp to avoid int32 underflow of frame_index - window while
        # keeping "always active" semantics for the INT_MAX default.
        return min(self.surfel_integration_active_window_size, 2 ** 30)

    @property
    def unprojection(self):
        return (1.0 / self.fx, 1.0 / self.fy,
                -(self.cx - 0.5) / self.fx, -(self.cy - 0.5) / self.fy)


def params_from(obj) -> FusionParams:
    """The port's FusionParams from any object carrying the JAX
    FusionParams field names (e.g. a surfelmeshing_tpu FusionParams)."""
    return FusionParams(**{f.name: getattr(obj, f.name)
                           for f in dataclasses.fields(FusionParams)})


# ---------------------------------------------------------------------------
# Small helpers.
# ---------------------------------------------------------------------------

def _div(numerator: float, t: torch.Tensor) -> torch.Tensor:
    """numerator / t as an IEEE division (Tensor.__rtruediv__ computes
    reciprocal(t) * numerator, which rounds differently)."""
    return torch.full_like(t, numerator) / t


def _project(params: FusionParams, x, y, z):
    """Project camera-space points -> (u, v, px, py, in_image).

    Pixel int via C-style truncation; the reference also rejects
    pixel_pos < 0 before truncation (kernels.cu:1496-1500).  The cast
    saturates (to_i32_trunc), so a surfel just in front of the camera with
    a huge u stays off-image."""
    safe_z = torch.where(z > 0, z, 1.0)
    u = params.fx * (x / safe_z) + params.cx
    v = params.fy * (y / safe_z) + params.cy
    px = to_i32_trunc(u)
    py = to_i32_trunc(v)
    in_image = (z > 0) & (u >= 0) & (v >= 0) & \
        (px < params.width) & (py < params.height)
    return u, v, px, py, in_image


def _side_pixel(params: FusionParams, u, v, px, py):
    """Second association pixel from the sub-pixel position: the neighbor
    toward which the surfel leans within its pixel (kernels.cu:1506-1555)."""
    x_frac = u - px.to(torch.float32)
    y_frac = v - py.to(torch.float32)
    bl = x_frac < y_frac              # bottom-left triangle half
    near = x_frac < 1.0 - y_frac      # toward top-left

    left = bl & near
    bottom = bl & ~near
    top = ~bl & near
    right = ~bl & ~near

    sx = torch.where(left, px - 1, torch.where(right, px + 1, px))
    sy = torch.where(top, py - 1, torch.where(bottom, py + 1, py))
    valid = torch.where(
        left, px > 1,                      # quirk preserved: px > 1, not >= 1
        torch.where(right, px < params.width - 1,
                    torch.where(top, py > 0, py < params.height - 1)))
    return sx, sy, valid


def _safe_idx(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Gather index with INVALID / out-of-range entries mapped to row 0."""
    return torch.where((idx < 0) | (idx >= n), 0, idx)


def _shift_flat(img_flat: torch.Tensor, shift: int) -> torch.Tensor:
    """img[i + shift] over a flattened image; out-of-range -> 0."""
    if shift == 0:
        return img_flat
    zeros = torch.zeros(abs(shift), dtype=img_flat.dtype,
                        device=img_flat.device)
    if shift > 0:
        return torch.cat([img_flat[shift:], zeros])
    return torch.cat([zeros, img_flat[:shift]])


def _ordered_scatter_add(n: int, index: torch.Tensor,
                         values: torch.Tensor) -> torch.Tensor:
    """(C, n) f32 sums of the (C, M) `values` at `index` (M,), entries with
    an INVALID_INDEX target dropped, each target's updates added in stream
    order to +0.0: the order of XLA's sequential scatter-add.

    An atomic float scatter sums in no fixed order, so the card would
    differ from the CPU and from itself.  Here a stable sort by target
    gives each update its rank within its target's run; the updates land
    in a zero-padded (C, R, n) block at (rank, target), unique positions,
    and R row additions in rank order sum them.  Adding the +0.0 padding
    leaves a sum unchanged (a running sum from +0.0 is never -0.0).  R,
    the longest run, is read on the host: one synchronisation a call."""
    c = values.shape[0]
    target = torch.where(index == INVALID_INDEX, n, index).to(torch.int64)
    sorted_t, order = torch.sort(target, stable=True)
    pos = torch.arange(sorted_t.numel(), device=target.device)
    starts = torch.ones_like(sorted_t, dtype=torch.bool)
    starts[1:] = sorted_t[1:] != sorted_t[:-1]
    rank = pos - torch.cummax(torch.where(starts, pos, 0), 0).values
    kept = sorted_t < n
    runs = int(torch.where(kept, rank + 1, 0).max())
    out = torch.zeros((c, n), dtype=values.dtype, device=values.device)
    if runs == 0:
        return out
    padded = torch.zeros((c, runs, n + 1), dtype=values.dtype,
                         device=values.device)
    padded[:, torch.where(kept, rank, 0), sorted_t] = values[:, order]
    for r in range(runs):
        out = out + padded[:, r, :n]
    return out


def _slot_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of a (4, N) tensor over its slots in slot order (the JAX
    package's order)."""
    return x[0] + x[1] + x[2] + x[3]


def _transform(T: torch.Tensor, x, y, z, translate: bool = True):
    """T[:, :3] @ (x, y, z) (+ T[:, 3]) with the JAX package's operation
    order, one output row at a time."""
    rows = []
    for r in range(3):
        val = T[r, 0] * x + T[r, 1] * y + T[r, 2] * z
        rows.append(val + T[r, 3] if translate else val)
    return rows


class StageTimer:
    """Per-phase times of one fusion step under the reference's
    --log_timings columns (utils/timing.COLUMNS; main.cc:1531-1545), the
    counterpart of the reference's per-phase cudaEvent brackets
    (cuda_surfel_reconstruction.cc:112-320), and the device half of the
    tracer (utils/timing.py), which takes the timers of preprocessing
    passes, fusion phases and chunk replays as device spans.

    The step calls the instance at each phase boundary with the column
    that starts there (None closes the last).  On a CUDA device a boundary
    records a CUDA event on the current stream, read once the device has
    passed it (done()); nothing here synchronises.  On the CPU, where
    every op runs to completion before it returns, it reads the host
    clock.  This brackets the real step: the JAX package re-runs a
    non-donating probe step under jax.profiler and attributes traced
    device time to the columns instead, a TPU workaround with no
    counterpart here.  Work outside the eight phases (the tiling of
    _integrate_tiled) falls in no column, as in the JAX package; the
    tracer takes it from a timer of its own (dev.tiling.*).

    A timer's CUDA events go back to a free list of their device when the
    timer is dropped, for the next timers: creating and destroying an
    event costs the host about ten times as much as recording one."""

    _free = {}                  # device index -> reusable CUDA events

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._marks = []        # (column opened here or None, event / s)
        if self.cuda:
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            self._stream = torch.cuda.current_stream(self.device)
            self._events = StageTimer._free.setdefault(self.device.index, [])

    def __call__(self, column: Optional[str]) -> None:
        if self.cuda:
            mark = self._events.pop() if self._events else \
                torch.cuda.Event(enable_timing=True)
            mark.record(self._stream)
        else:
            mark = time.perf_counter()
        self._marks.append((column, mark))

    def __del__(self):
        if self.cuda:
            self._events.extend(mark for _, mark in self._marks)

    def done(self) -> bool:
        """Whether the device has passed every mark (always on the CPU)."""
        return not self.cuda or not self._marks or self._marks[-1][1].query()

    def synchronize(self) -> None:
        """Wait until the device has passed every mark."""
        if self.cuda and self._marks:
            self._marks[-1][1].synchronize()

    def segments(self, ref) -> list:
        """(column, start, end) of each segment, in seconds after `ref`: a
        CUDA event the device passed before the first mark, or on the CPU
        a host time.  The device must have passed every mark."""
        at = [(column, ref.elapsed_time(mark) / 1000.0 if self.cuda
               else mark - ref) for column, mark in self._marks]
        return [(column, s, e) for (column, s), (_, e) in zip(at, at[1:])
                if column is not None]

    def stage_ms(self) -> dict:
        """{column: ms} summed over the segments of each column (integration
        has two).  The device must have passed every mark: the pipeline
        reads it after the timings line's surfel count, which waits."""
        out = {}
        if self._marks:
            for column, s, e in self.segments(self._marks[0][1]):
                out[column] = out.get(column, 0.0) + 1000.0 * (e - s)
        return out


# ---------------------------------------------------------------------------
# The per-frame fusion update.
# ---------------------------------------------------------------------------

def integrate_frame(
    state: SurfelState,
    depth: torch.Tensor,          # (H, W) int, preprocessed (u16 values)
    normals_xy: torch.Tensor,     # (2, H, W) f32
    radius_img: torch.Tensor,     # (H, W) f32 squared radii
    color: torch.Tensor,          # (3, H, W) u8
    global_T_local: torch.Tensor,  # (3, 4) f32
    local_T_global: torch.Tensor,  # (3, 4) f32
    frame_index,                  # int, or a 0-d int32 tensor
    params: FusionParams,
    taps: Optional[dict] = None,
    stages: Optional[StageTimer] = None,
) -> SurfelState:
    """One fusion step == CUDASurfelReconstruction::Integrate
    (cuda_surfel_reconstruction.cc:112-320).

    Returns a new state; the input state is not modified.  `frame_index`
    is an int or a 0-d int32 tensor (identical bits).  When `taps` is a
    dict, the phase-boundary maps are stored in it under the JAX package's
    tap names (plus "depth", the input depth map); on the tiled path the
    per-surfel taps are the working set's.  `stages` times the phases.
    """
    frame_index = _frame_scalar(frame_index, state.pack.device)
    args = (state, depth, normals_xy, radius_img, color, global_T_local,
            local_T_global, frame_index, params, taps, stages)
    if 0 < params.active_surfel_budget < state.pack.shape[0]:
        return _integrate_tiled(*args)
    return _integrate_body(*args)


def integrate_frame_bucketed(
    state: SurfelState,
    depth: torch.Tensor,
    normals_xy: torch.Tensor,
    radius_img: torch.Tensor,
    color: torch.Tensor,
    global_T_local: torch.Tensor,
    local_T_global: torch.Tensor,
    frame_index,
    params: FusionParams,
    n_eff: int,
    taps: Optional[dict] = None,
    stages: Optional[StageTimer] = None,
) -> SurfelState:
    """integrate_frame over only the first n_eff surfel rows (the JAX
    package's integrate_frame_bucketed): the reference's count-sized
    kernel grids, cuda_surfel_reconstruction.cc:131-140, where every
    kernel launches over surfels_size, not capacity.

    The caller picks n_eff >= surfel_count + the frame's creations
    (pipeline.shape_bucket_for); capacity tests inside the step then see
    n_eff, so creations that do not fit under it are deferred to the next
    frame, as in the JAX package.  overflow_count counts only creations
    dropped at the capacity and deferred_count those deferred by the
    bucket or the per-frame budget; the JAX function's overflow_count
    counts the bucket-deferred ones too (ROADMAP queue 3 #8).  The input
    state is consumed on every route: the returned state's pack,
    neighbors and nbr_dist are the input's tensors holding the new rows
    (its counters are new tensors; the input's are stale), the
    counterpart of the JAX function's donated state, so a CUDA graph of
    the step writes the map's fixed tensors.
    n_eff >= capacity runs integrate_frame's routes over the whole map:
    the tiled one writes its working tiles into the input's tensors
    directly (no full-map copy), the full-shape one copies its result
    back.  The write-back falls in no `stages` column.  `frame_index` is
    an int or a 0-d int32 tensor (identical bits).
    """
    n = state.pack.shape[0]
    frame_index = _frame_scalar(frame_index, state.pack.device)
    args = (depth, normals_xy, radius_img, color, global_T_local,
            local_T_global, frame_index, params, taps, stages)
    if n_eff >= n and 0 < params.active_surfel_budget < n:
        return _integrate_tiled(state, *args, in_place=True)
    if n_eff >= n:
        rows, out = (state.pack, state.neighbors, state.nbr_dist), \
            _integrate_body(state, *args)
    else:
        rows = (state.pack[:n_eff], state.neighbors[:, :n_eff],
                state.nbr_dist[:, :n_eff])
        sub = dataclasses.replace(state, pack=rows[0], neighbors=rows[1],
                                  nbr_dist=rows[2])
        out = _integrate_body(sub, *args, capacity=n)
    for dst, src in zip(rows, (out.pack, out.neighbors, out.nbr_dist)):
        dst.copy_(src)
    return dataclasses.replace(out, pack=state.pack,
                               neighbors=state.neighbors,
                               nbr_dist=state.nbr_dist)


class _Tiling(NamedTuple):
    """Working-set context of the tiled path (the JAX package's _Tiling).

    gidx is the global surfel index of each working row (INVALID_INDEX on
    unused slots); full_pack is the frame's input pack, the merge-phase
    gather source; sync(pack_w) writes the working tiles into the frame's
    full-pack copy and returns it, for every gather by global index."""
    gidx: torch.Tensor
    full_pack: torch.Tensor
    sync: Callable[[torch.Tensor], torch.Tensor]


class _Sharding(NamedTuple):
    """Surfel-axis shard context (the JAX package's _Sharding): this rank
    holds rows [offset, offset + n_local) of one map whose rows are split
    in rank order over the process group.

    Per-pixel maps are scattered locally and combined over the group right
    after the scatter (MIN for the min-depth raster and the supporter and
    conflictor claims, SUM for the packed count + depth sum): min and
    integer add are order-independent, so the combined map equals the
    global scatter bit for bit.  Gathers by global row index read the
    pack all-gathered in rank order.  Collectives are dist.all_reduce and
    dist.all_gather, which gloo runs on CPU and on CUDA tensors."""
    group: Optional[dist.ProcessGroup]
    world_size: int
    offset: int

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' tensors concatenated along dim 0 in rank order."""
        parts = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)

    def combine(self, t: torch.Tensor, op) -> torch.Tensor:
        """All-reduce of `t` over the group, in place; returns it."""
        dist.all_reduce(t, op=op, group=self.group)
        return t


def _integrate_tiled(state, depth, normals_xy, radius_img, color,
                     global_T_local, local_T_global, frame_index, params,
                     taps, stages, in_place: bool = False) -> SurfelState:
    """Active-set fusion (the JAX package's _integrate_tiled): gather the
    tiles holding the rows this frame may change (creation frontier
    first, then the tiles ops/tiling.py flags, up to the budget), run the
    8-phase update on that working set, write the tiles back: into copies
    of the input's pack, neighbors and nbr_dist, or with `in_place` into
    the input's tensors themselves (integrate_frame_bucketed).  In place
    is safe: the merge phase's gathers from the input pack are enqueued
    before the first tile write (phase 6), and the working tiles were
    gathered into tensors of their own.

    When no tile is skipped the result equals the full route's bit for
    bit (pack, neighbors, nbr_dist and every counter), however long the
    run: the working set holds every row the full route changes, and rows
    outside it are read through the synced full pack, where they hold
    what the full route holds.  On frame f with window W the full route
    changes only
      - the creation frontier (phase 7 writes rows [count, count + c));
      - rows in the image (phases 3, 5 and 6 change no other row);
      - in phase 8 (regularisation), a row whose stamp is >= f - W (its
        smoothed position steps), or == f - W - 1 (it stepped on frame
        f - 1 after its slot distances were computed, which are
        recomputed now);
      - in phase 8, a row with a slot pointing at a row whose stamp after
        phases 3-7 is >= f - W - 1 (its recent-neighbour count RCNT, a
        drift drop, or a slot distance from a position moved on this or
        the last frame), or is 0 (fast_neighbor_update drops slots to
        merge tombstones); a stamp changes in phases 3-7 only for rows
        in the image, so a slot pointing at a row in the image counts
        too;
      - in phase 8, a row whose stored RCNT is not 0 while no slot points
        at such a row: RCNT becomes 0 (its last recent neighbour left the
        window, or was dropped after being counted on the frame before);
      - without fast_neighbor_update, in phase 6's detach sweep a row
        with a slot pointing at a row whose detach flag is set.
    The flags (ops/tiling.py) test exactly these, on the input map.

    Tiles past the budget are skipped for the frame: their surfels go
    stale and their pixels may spawn duplicates, later merged; the count
    accumulates in skipped_tile_count.  The working set also holds unused
    slots when fewer tiles are wanted than the budget; they are filled
    with distinct tiles outside the set and written back unchanged, so
    every write-back index is unique.  While the tracer is on and
    `stages` times the step, the selection with the working-set gathers
    and the write-back are the host spans tiling.select and
    tiling.writeback and the device spans dev.tiling.select and
    dev.tiling.writeback.
    """
    pack = state.pack
    n = pack.shape[0]
    ts = params.tile_size
    if n % ts != 0:
        raise ValueError(
            f"active_surfel_budget requires capacity ({n}) to be a "
            f"multiple of tile_size ({ts})")
    if not params.symmetric_regularization:
        raise ValueError("active_surfel_budget requires "
                         "symmetric_regularization (the exact scatter "
                         "accumulation needs full shapes)")
    k_cap = max(params.active_surfel_budget // ts, 1)
    t_n = n // ts
    # The creation frontier spans at most c_budget // ts + 1 tiles; it must
    # always fit, or creations would be lost while surfel_count grows.
    c_budget = min(params.max_creations_per_frame,
                   params.height * params.width)
    if k_cap < c_budget // ts + 1:
        raise ValueError(
            f"active_surfel_budget ({params.active_surfel_budget}) too "
            f"small for the creation frontier: needs at least "
            f"{(c_budget // ts + 1) * ts} (max_creations_per_frame + one "
            f"tile)")
    traced = tracer.on and stages is not None
    if traced:
        span_id = frame_index if isinstance(frame_index, int) else -1
        marks = StageTimer(pack.device)
        tracer.begin("tiling.select", span_id)
        marks("select")
    sel = tiling.select(params, state, local_T_global, frame_index, k_cap,
                        c_budget)
    src_tiles, slot_live = sel.src_tiles, sel.slot_live

    # Whole-tile gathers of the working set.
    pack_w = pack.reshape(t_n, ts, PACK_WIDTH)[src_tiles] \
        .reshape(k_cap * ts, PACK_WIDTH)
    nbr_w = state.neighbors.reshape(4, t_n, ts)[:, src_tiles] \
        .reshape(4, k_cap * ts)
    dist_w = state.nbr_dist.reshape(4, t_n, ts)[:, src_tiles] \
        .reshape(4, k_cap * ts)

    # The frame's full pack (a copy, or the input's in place); every sync
    # writes the live working tiles into it (unused slots get their
    # gathered rows back).
    full = pack if in_place else \
        pack.clone(memory_format=torch.contiguous_format)
    if traced:
        marks(None)
        tracer.end()

    def sync(pack_now):
        full.view(t_n, ts, PACK_WIDTH).index_copy_(0, src_tiles, torch.where(
            slot_live[:, None, None],
            pack_now.reshape(k_cap, ts, PACK_WIDTH),
            pack_w.view(k_cap, ts, PACK_WIDTH)))
        return full

    wstate = dataclasses.replace(
        state, pack=pack_w, neighbors=nbr_w, nbr_dist=dist_w,
        skipped_tile_count=state.skipped_tile_count + sel.skipped,
        active_tile_count=sel.total)
    out = _integrate_body(wstate, depth, normals_xy, radius_img, color,
                          global_T_local, local_T_global, frame_index,
                          params, taps, stages,
                          _Tiling(sel.gidx, pack, sync))

    def write_back(full_arr, work, before):
        arr = full_arr if in_place else \
            full_arr.clone(memory_format=torch.contiguous_format)
        arr.view(4, t_n, ts).index_copy_(1, src_tiles, torch.where(
            slot_live[None, :, None], work.reshape(4, k_cap, ts),
            before.view(4, k_cap, ts)))
        return arr

    if traced:
        tracer.begin("tiling.writeback", span_id)
        marks("writeback")
    out = dataclasses.replace(
        out, pack=sync(out.pack),
        neighbors=write_back(state.neighbors, out.neighbors, nbr_w),
        nbr_dist=write_back(state.nbr_dist, out.nbr_dist, dist_w))
    if traced:
        marks(None)
        tracer.end()
        tracer.device(marks, "dev.tiling.", span_id)
    return out


def _integrate_body(state, depth, normals_xy, radius_img, color,
                    global_T_local, local_T_global, frame_index, params,
                    taps, stages=None,
                    tiling: Optional[_Tiling] = None, *,
                    shard: Optional[_Sharding] = None,
                    capacity: Optional[int] = None) -> SurfelState:
    """The 8 phases over the state's rows: the whole capacity, the working
    set of the tiled path (`tiling`), this rank's rows of a map sharded
    over the surfel axis (`shard`) or the first rows of a map of
    `capacity` rows (integrate_frame_bucketed; only overflow_count reads
    it).  `stages` is called at the JAX package's stage boundaries (its
    _StageScopes calls).

    Phases 1-7 run in _fuse, so their per-row temporaries are freed when
    it returns, before regularisation's neighbour gathers, which would
    otherwise hold the step's peak device memory on top of them."""
    out, sync = _fuse(state, depth, normals_xy, radius_img, color,
                      global_T_local, local_T_global, frame_index, params,
                      taps, stages, tiling, shard=shard, capacity=capacity)

    # --- Phase 8: Regularization (kernels.cu:2099-2410) -------------------
    if stages is not None:
        stages("regularization")
    pack, neighbors, nbr_dist = out.pack, out.neighbors, out.nbr_dist
    if params.regularization_iterations == 0:
        recent = pack.view(torch.int32)[:, STAMP] >= \
            frame_index - params.regularization_frame_window_size
        pack = pack.clone()
        for s, p in ((SX, PX), (SY, PY), (SZ, PZ)):
            pack[:, s] = torch.where(recent, pack[:, p], pack[:, s])
    else:
        for _ in range(params.regularization_iterations):
            pack, neighbors, nbr_dist = _regularize(
                params, pack, neighbors, nbr_dist, frame_index, sync)
    if stages is not None:
        stages(None)
    return dataclasses.replace(out, pack=pack, neighbors=neighbors,
                               nbr_dist=nbr_dist)


def _fuse(state, depth, normals_xy, radius_img, color, global_T_local,
          local_T_global, frame_index, params, taps, stages,
          tiling: Optional[_Tiling], *, shard: Optional[_Sharding],
          capacity: Optional[int]):
    """Phases 1-7 of _integrate_body (its arguments); -> (the state after
    creation, the pack sync that global-index gathers read through)."""
    def tap(name, value):
        if taps is not None:
            taps[name] = value

    def stage(column):
        if stages is not None:
            stages(column)

    def combine(img, op):
        """This rank's scatter map combined with the other ranks'
        (identity off the sharded path)."""
        return img if shard is None else shard.combine(img, op)

    n = state.pack.shape[0]
    h, w = params.height, params.width
    hw = h * w
    dev = state.pack.device
    noise = params.sensor_noise_factor
    inv_scale = float(np.float32(1.0 / params.depth_scaling))
    cos_compat = float(np.float32(params.cos_normal_compat))
    depth = depth.to(torch.int32)
    tap("depth", depth)

    pack0 = state.pack
    pack0_i = pack0.view(torch.int32)
    if shard is not None:
        assert tiling is None
        idx = shard.offset + torch.arange(n, dtype=torch.int32, device=dev)
        merge_src = shard.all_gather(pack0)
        sync = shard.all_gather
    elif tiling is None:
        idx = torch.arange(n, dtype=torch.int32, device=dev)
        merge_src = pack0

        def sync(pack_w):
            """Full-shape mode: the working pack is the full pack."""
            return pack_w
    else:
        idx, merge_src, sync = tiling
    in_count = idx < state.surfel_count       # INVALID_INDEX exceeds it
    stamps = pack0_i[:, STAMP]
    active = in_count & (stamps > frame_index - params.active_window)

    # Shared per-surfel projection of the raw position (kernels.cu:1481-1493).
    Tl = local_T_global
    ox, oy, oz = pack0[:, PX], pack0[:, PY], pack0[:, PZ]
    lx, ly, z = _transform(Tl, ox, oy, oz)
    u, v, px, py, in_image = _project(params, lx, ly, z)
    sx, sy, side_ok = _side_pixel(params, u, v, px, py)
    del u, v

    proj_a = active & in_image
    pix_a = torch.where(proj_a, py * w + px, INVALID_INDEX)
    proj_b = proj_a & side_ok
    pix_b = torch.where(proj_b, sy * w + sx, INVALID_INDEX)
    # Gather pixels are valid for every live in-image surfel: the merge
    # pass is not active-window gated (kernels.cu:2016-2017).
    img_a = in_count & in_image
    pix_a_c = torch.where(img_a, py * w + px, 0).clamp(0, hw - 1).long()
    pix_b_c = torch.where(img_a & side_ok, sy * w + sx, 0) \
        .clamp(0, hw - 1).long()
    del img_a

    # --- Phase 1: RenderMinDepth (kernels.cu:1458-1557) -------------------
    # The same z tensor feeds the min scatter and the `first == z` tests.
    stage("data_association")
    first_depth = combine(association.min_depth_map(hw, pix_a, pix_b, z),
                          dist.ReduceOp.MIN)
    tap("first_depth", first_depth)

    # --- Phase 2: Associate (kernels.cu:1586-1854) ------------------------
    depth_m_flat = depth.reshape(hw).to(torch.float32) * inv_scale
    mnx = normals_xy[0].reshape(hw)
    mny = normals_xy[1].reshape(hw)
    mnz = -sqrt_f32((1.0 - mnx * mnx - mny * mny).clamp_min(0.0))
    radius_flat = radius_img.reshape(hw)

    snx, sny, snz = _transform(Tl, pack0[:, NX], pack0[:, NY], pack0[:, NZ],
                               translate=False)
    surfel_dist = sqrt_f32(lx * lx + ly * ly + z * z)
    facing_ok = ((lx * snx + ly * sny + z * snz) /
                 surfel_dist.clamp_min(1e-30)) <= \
        SURFEL_NORMAL_TO_VIEWING_DIR_THRESHOLD
    radius_col = pack0[:, RAD]

    def associate_checks(meas, first, p_mnx, p_mny, p_mnz, on):
        """Common per-candidate association tests on the candidate's
        per-pixel values."""
        on = on & (meas > 0)
        conflict_zone = first < (1.0 - noise) * meas
        is_conflicting = on & conflict_zone & (first == z)
        on = on & ~conflict_zone
        on = on & ~(z > (1.0 + noise) * meas)
        on = on & facing_ok
        # Normal compatibility when the measurement is in front
        # (kernels.cu:1653-1668); the measurement normal is in camera space.
        compat_needed = meas < z
        compat = (snx * p_mnx + sny * p_mny + snz * p_mnz) >= cos_compat
        on = on & (~compat_needed | compat)
        return on, is_conflicting

    pre = {}
    for side, pix in (("a", pix_a_c), ("b", pix_b_c)):
        pre[side] = dict(meas=depth_m_flat[pix], first=first_depth[pix],
                         mnx=mnx[pix], mny=mny[pix], mnz=mnz[pix],
                         rad=radius_flat[pix])

    def pre_args(side):
        p = pre[side]
        return p["meas"], p["first"], p["mnx"], p["mny"], p["mnz"]

    support_a, conflict_a = associate_checks(*pre_args("a"), proj_a)
    support_b, conflict_b = associate_checks(*pre_args("b"), proj_b)
    support_a = support_a & (radius_col > 0)   # <= 0 rejected
    support_b = support_b & (radius_col > 0)   # (cu:1673-1676)

    # --- Phase 3 (part 1): merge checks --------------------------------
    # The merge pass runs over all surfels with radius >= 0, not only the
    # active window, and also marks conflicts (kernels.cu:1881-1890).
    merge_on = in_count & (radius_col >= 0) & in_image
    m_on, m_conflict = associate_checks(*pre_args("a"), merge_on)
    radius_a = pre["a"]["rad"]      # phase 6 reads it; the rest go
    # Each per-row temporary goes once its last reader has run: the
    # step's peak device memory is what is live at its largest phase.
    del pre, associate_checks, snx, sny, snz, facing_ok, merge_on, in_count

    # Support count + depth sum ride ONE int32 sum: the supporter depth in
    # the low 25 bits as fixed point at depth-unit resolution, the count
    # above (the JAX package's documented deviation from the reference's
    # separate f32 sums, kernels.cu:1691-1694).
    supporting_surfels, packed = association.support_maps(
        hw, pix_a, pix_b, support_a, support_b, idx, z, params.depth_scaling)
    supporting_surfels = combine(supporting_surfels, dist.ReduceOp.MIN)
    packed = combine(packed, dist.ReduceOp.SUM)
    support_counts = packed >> SUM_BITS
    support_depth_sums = (packed & ((1 << SUM_BITS) - 1)) \
        .to(torch.float32) * inv_scale
    # Pixel-has-a-conflictor is elementwise (kernels.cu:1610-1618).
    has_conflict = first_depth < (1.0 - noise) * depth_m_flat
    if params.exact_conflict_arbitration:
        # The reference's conflictor map, its last-writer race resolved by
        # the min-index rule: one decrementer per pixel.
        conflicting_surfels = combine(association.min_index_map(
            hw, pix_a, pix_b, conflict_a | m_conflict, conflict_b, idx),
            dist.ReduceOp.MIN)
    del pix_a, pix_b, proj_b, support_a, support_b, conflict_a, conflict_b, \
        m_conflict
    tap("supporting_surfels", supporting_surfels)
    tap("support_counts", support_counts)
    tap("support_depth_sums", support_depth_sums)
    tap("has_conflict", has_conflict)
    cr = color[0].reshape(hw).to(torch.float32)
    cg = color[1].reshape(hw).to(torch.float32)
    cb = color[2].reshape(hw).to(torch.float32)
    rgb_packed = cr + cg * 256.0 + cb * 65536.0

    # --- Phase 4 (hoisted before merge): blending (kernels.cu:563-738) ----
    # Blending reads only the phase-2 maps and the raw depth; merge mutates
    # only the pack, so the reference order Merge->Blend gives the same.
    stage("measurement_blending")
    if params.do_blending:
        depth = _blend_measurements(
            params, depth, supporting_surfels.reshape(h, w),
            support_counts.reshape(h, w), support_depth_sums.reshape(h, w))
        depth_post_flat = depth.reshape(hw).to(torch.float32) * inv_scale
    else:
        depth_post_flat = depth_m_flat
    tap("blended_depth", depth)

    # Supporting surfel at the 4 adjacent pixels (left, right, up, down).
    stage("integration")
    sup_shift = [_shift_flat(supporting_surfels, s) for s in (-1, +1, -w, +w)]
    supported = supporting_surfels[pix_a_c]
    sup_a = [s[pix_a_c] for s in sup_shift]

    # --- Phase 3 (part 2): merge tombstoning (kernels.cu:1949-1991) -------
    stage("surfel_merging")
    m_on = m_on & (supported != idx) & (supported != INVALID_INDEX)
    # Pristine rows of the frame's input pack (the full pack when tiled).
    other = merge_src[_safe_idx(supported, merge_src.shape[0]).long()]
    other_radius = other[:, RAD]
    radius_ratio = radius_col / torch.where(other_radius != 0, other_radius,
                                            1e-30)
    m_on = m_on & (radius_ratio <= MERGE_RADIUS_DIFF_THRESHOLD_SQ) & \
        (radius_ratio >= 1.0 / MERGE_RADIUS_DIFF_THRESHOLD_SQ)
    ddx = ox - other[:, PX]
    ddy = oy - other[:, PY]
    ddz = oz - other[:, PZ]
    m_on = m_on & (ddx * ddx + ddy * ddy + ddz * ddz <=
                   MERGE_DISTANCE_FACTOR * (radius_col + other_radius))
    m_on = m_on & (pack0[:, NX] * other[:, NX] +
                   pack0[:, NY] * other[:, NY] +
                   pack0[:, NZ] * other[:, NZ] >=
                   MERGE_COS_NORMAL_THRESHOLD)
    del other, other_radius, radius_ratio, ddx, ddy, ddz, supported

    pack = pack0.clone()
    pack_i = pack.view(torch.int32)
    pack_i[:, STAMP] = torch.where(m_on, 0, pack_i[:, STAMP])
    pack[:, RAD] = torch.where(m_on, -1.0, pack[:, RAD])
    pack[:, DETACH] = torch.maximum(pack[:, DETACH], m_on.to(torch.float32))
    m_total = m_on.sum(dtype=torch.int32)
    if shard is not None:
        m_total = shard.combine(m_total.reshape(1), dist.ReduceOp.SUM)[0]
    merge_count = state.merge_count + m_total
    tap("merge_mask", m_on)
    del m_on, merge_src
    if taps is not None:
        # A copy: phase 5 updates the pack in place on the card.
        taps["pack_after_merge"] = pack.clone()

    # --- Phase 5: Integrate measurements (kernels.cu:741-1142) ------------
    stage("integration")
    fx_inv, fy_inv, cx_inv, cy_inv = params.unprojection
    Tg = global_T_local
    # The measurement of every pixel, unprojected and rotated to global
    # space, for the creation phase.
    xs_f, ys_f = _pixel_coords(hw, w, dev)
    pgx, pgy, pgz = _transform(
        Tg, depth_post_flat * (fx_inv * xs_f + cx_inv),
        depth_post_flat * (fy_inv * ys_f + cy_inv), depth_post_flat)
    ngx, ngy, ngz = _transform(Tg, mnx, mny, mnz, translate=False)
    pack, neighbors, nbr_dist = integration.integrate_measurements(
        params, pack, state.neighbors, state.nbr_dist,
        integration.Rows(proj_a, side_ok, idx, lx, ly, z, surfel_dist, px,
                         py, sx, sy),
        integration.Maps(depth_post_flat, depth_m_flat, first_depth,
                         support_counts, rgb_packed, mnx, mny, mnz,
                         radius_flat, conflicting_surfels
                         if params.exact_conflict_arbitration else None),
        Tl, Tg, frame_index)
    del proj_a, side_ok, sx, sy, in_image, surfel_dist, pix_b_c
    tap("pack_after_integrate", pack)
    tap("neighbors_after_integrate", neighbors)

    # --- Phase 6: Neighbor update (kernels.cu:1197-1455) ------------------
    stage("neighbor_update")
    gpack = sync(pack)   # phase 3+5 updates, seen by global-index gathers
    neighbors, nbr_dist = _update_neighbors(
        params, idx, active, lx, ly, z, px, py, pack, neighbors, nbr_dist,
        depth_post_flat[pix_a_c], radius_a, sup_a, Tl, gpack)
    del active, lx, ly, z, px, py, pix_a_c, radius_a, sup_a
    tap("neighbors_after_update", neighbors)

    # --- Phase 7: New surfel creation (kernels.cu:90-271, .cc:37-146) -----
    stage("new_surfel_creation")
    if params.exact_conflict_arbitration:
        conflict_free = conflicting_surfels == INVALID_INDEX
    else:
        conflict_free = ~has_conflict
    img = dict(meas=depth_post_flat, pgx=pgx, pgy=pgy, pgz=pgz,
               ngx=ngx, ngy=ngy, ngz=ngz, cr=cr, cg=cg, cb=cb,
               radius=radius_flat)
    pack, neighbors, nbr_dist, surfel_count, overflow_count, \
        deferred_count = _create_new_surfels(
            params, depth, supporting_surfels, conflict_free, img,
            sup_shift, pack, neighbors, nbr_dist, state.surfel_count,
            state.overflow_count, state.deferred_count, frame_index, idx,
            gpack, capacity)
    tap("pack_after_create", pack)
    tap("neighbors_after_create", neighbors)
    tap("surfel_count_after_create", surfel_count)

    return dataclasses.replace(
        state, pack=pack, neighbors=neighbors, nbr_dist=nbr_dist,
        surfel_count=surfel_count, merge_count=merge_count,
        overflow_count=overflow_count, deferred_count=deferred_count), sync


def _pixel_coords(hw: int, w: int, device):
    """(x, y) f32 coordinates of the flattened pixels."""
    lin = torch.arange(hw, dtype=torch.int32, device=device)
    return (lin % w).to(torch.float32), (lin // w).to(torch.float32)


# ---------------------------------------------------------------------------
# Phase implementations.
# ---------------------------------------------------------------------------

def blend_inputs(depth, supporting_surfels, counts, sums):
    """The four f32 (H, W) maps blending reads: (depth_f, supported 0/1,
    valid 0/1, average supporter depth)."""
    supported = (supporting_surfels != INVALID_INDEX).to(torch.float32)
    valid = (depth != 0).to(torch.float32)
    avg = sums / counts.clamp_min(1).to(torch.float32)
    return depth.to(torch.float32), supported, valid, avg


def _blend_measurements(params: FusionParams, depth, supporting_surfels,
                        counts, sums) -> torch.Tensor:
    """Measurement blending -> int32 depth (u16 values).  The kernel runs
    for every radius: with radius < 2 its ring loop is empty and only the
    border snap applies, as in the JAX package."""
    maps = blend_inputs(depth, supporting_surfels, counts, sums)
    depth_f = blend_core(*maps, max(params.measurement_blending_radius, 1),
                         params.depth_scaling)
    return torch.floor(depth_f).clamp(0, 65535).to(torch.int32)


def _update_neighbors(params, idx, active, lx, ly, z, px, py, pack,
                      neighbors, nbr_dist, meas_a, radius_a, sup_a, Tl,
                      gpack):
    """Refresh the 4 regularization neighbors from the supporting surfels
    of the 4 adjacent pixels (kernels.cu:1197-1455).  With
    fast_neighbor_update, existing slots keep their stored squared
    distances and candidates with a pending detach flag are not inserted;
    without it, existing slots re-gather their distance and detach flag,
    flagged candidates are inserted and a detach sweep drops every slot
    whose surfel carries the flag (nbr_dist is returned unchanged, as in
    the JAX package).  Rows are read by global index from `gpack`, the
    full pack synced after phase 5 (`pack` itself in full-shape mode).
    -> (neighbors, nbr_dist)."""
    n = gpack.shape[0]
    h, w = params.height, params.width
    noise = params.sensor_noise_factor
    reg_factor_sq = float(np.float32(
        params.radius_factor_for_regularization_neighbors ** 2))
    radius_col = pack[:, RAD]

    border_ok = (px >= 1) & (py >= 1) & (px < w - 1) & (py < h - 1) & (z > 0)
    on = active & border_ok
    on = on & ~(z > (1.0 + noise) * meas_a)     # zero meas occludes all
    nx_, ny_, nz_ = pack[:, NX], pack[:, NY], pack[:, NZ]
    lsnx, lsny, lsnz = _transform(Tl, nx_, ny_, nz_, translate=False)
    sdist = sqrt_f32(lx * lx + ly * ly + z * z)
    on = on & ((lx * lsnx + ly * lsny + z * lsnz) / sdist.clamp_min(1e-30) <=
               SURFEL_NORMAL_TO_VIEWING_DIR_THRESHOLD)
    on = on & (radius_col >= 0)
    # CHECK_SCALE_COMPAT_NEIGHBORS (kernels.cu:64).
    on = on & (radius_a / torch.where(radius_col != 0, radius_col, 1e-30)
               <= MAX_OBSERVATION_RADIUS_FACTOR ** 2)
    del border_ok, lsnx, lsny, lsnz, sdist, meas_a

    ox, oy, oz = pack[:, PX], pack[:, PY], pack[:, PZ]

    def dist_sq(rows):
        dx = rows[:, PX] - ox
        dy = rows[:, PY] - oy
        dz = rows[:, PZ] - oz
        return dx * dx + dy * dy + dz * dz

    fast = params.fast_neighbor_update
    slot_idx = neighbors
    slot_valid = slot_idx != INVALID_INDEX
    if fast:
        slot_dist = torch.where(slot_valid, nbr_dist, math.inf)
    else:
        slot_rows = [gpack[_safe_idx(slot_idx[k], n).long()]
                     for k in range(4)]
        slot_dist = torch.where(slot_valid,
                                torch.stack([dist_sq(r) for r in slot_rows]),
                                math.inf)
        slot_det = torch.stack([r[:, DETACH] for r in slot_rows])
    slot4 = torch.arange(4, device=pack.device)[:, None]

    for direction in range(4):
        cand = sup_a[direction]
        c_ok = on & (cand != INVALID_INDEX) & (cand != idx)
        rows = gpack[_safe_idx(cand, n).long()]
        c_dist = dist_sq(rows)
        c_ok = c_ok & (c_dist <= reg_factor_sq * radius_col)
        c_ok = c_ok & (nx_ * rows[:, NX] + ny_ * rows[:, NY] +
                       nz_ * rows[:, NZ] > 0)
        if fast:
            c_ok = c_ok & (rows[:, DETACH] <= 0)
        c_ok = c_ok & ~(slot_idx == cand[None, :]).any(dim=0)

        # The slot to replace is the farthest one (first on ties).
        best = torch.argmax(slot_dist, dim=0)
        best_dist = torch.amax(slot_dist, dim=0)
        c_ok = c_ok & (c_dist < best_dist)
        onehot = (slot4 == best[None, :]) & c_ok[None, :]
        slot_idx = torch.where(onehot, cand[None, :], slot_idx)
        slot_dist = torch.where(onehot, c_dist[None, :], slot_dist)
        if not fast:
            slot_det = torch.where(onehot, rows[:, DETACH][None, :],
                                   slot_det)
        # The next direction's gathered rows are not allocated on top of
        # these.
        del rows, c_dist, c_ok, best, best_dist, onehot

    if fast:
        return slot_idx, torch.where(slot_idx != INVALID_INDEX, slot_dist,
                                     math.inf)
    # The detach sweep (kernels.cu:1420-1437).
    detach = (slot_det > 0) & (slot_idx != INVALID_INDEX)
    return torch.where(detach, INVALID_INDEX, slot_idx), nbr_dist


def _create_new_surfels(params, depth, supporting_surfels, conflict_free,
                        img, sup_shift, pack, neighbors, nbr_dist,
                        surfel_count, overflow_count, deferred_count,
                        frame_index, idx, gpack, capacity=None):
    """Append a surfel for every unexplained valid depth pixel
    (kernels.cu:90-271).  Flagged pixels are compacted by a cumsum in
    row-major pixel order (the reference's DeviceScan::ExclusiveSum,
    kernels.cc:94-113) into the first min(flagged, budget, free) slots
    after surfel_count; the rest of the frame's work runs over the
    creation budget, not the image.  Capacity tests use the full capacity
    and supporter rows are read by global index from `gpack`; new rows
    land in the rows of `pack` whose global index `idx` is theirs.
    `capacity` (default: gpack's rows) is the map's, for overflow_count
    only: creations past gpack's rows but under it are deferred.  Of the
    flagged pixels, those neither created nor dropped at capacity are
    deferred (past the budget or the bucket) and added to
    deferred_count."""
    h, w = params.height, params.width
    hw = h * w
    n = gpack.shape[0]       # full capacity (pack may be a working set)
    dev = pack.device
    reg_factor_sq = float(np.float32(
        params.radius_factor_for_regularization_neighbors ** 2))

    lin = torch.arange(hw, dtype=torch.int32, device=dev)
    xs = lin % w
    ys = lin // w
    interior = (xs >= 1) & (ys >= 1) & (xs < w - 1) & (ys < h - 1)
    flags = interior & (depth.reshape(hw) > 0) & \
        (supporting_surfels == INVALID_INDEX) & conflict_free
    flags_i = flags.to(torch.int32)

    c_budget = min(params.max_creations_per_frame, hw)
    prefix = torch.cumsum(flags_i, 0, dtype=torch.int32) - flags_i
    total = prefix[-1] + flags_i[-1]
    fits = flags & (surfel_count + prefix < n) & (prefix < c_budget)

    # src_pix[j] is the pixel of the j-th created surfel; slots past the
    # fitting count keep pixel 0 and are never written below.
    src_pix = torch.zeros(c_budget + 1, dtype=torch.int32, device=dev)
    src_pix.scatter_(0, torch.where(fits, prefix, c_budget).long(), lin)
    src_pix = src_pix[:c_budget].long()

    # ---- Everything below runs over the creation budget. ----
    pgx, pgy, pgz = img["pgx"][src_pix], img["pgy"][src_pix], \
        img["pgz"][src_pix]
    depth_c = img["meas"][src_pix]
    radius_c = img["radius"][src_pix]
    flags_f = flags.to(torch.float32)

    nbr_slots = []
    nbr_dists = []
    exist_sum = [torch.zeros(c_budget, device=dev) for _ in range(3)]
    exist_cnt = torch.ones(c_budget, device=dev)  # count + 1
    for k, shift in enumerate((-1, +1, -w, +w)):
        # Initial neighbors from the 4 adjacent pixels (kernels.cu:189-224).
        sup = sup_shift[k][src_pix]
        has_sup = sup != INVALID_INDEX
        rows = gpack[_safe_idx(sup, n).long()]
        dx = rows[:, PX] - pgx
        dy = rows[:, PY] - pgy
        dz = rows[:, PZ] - pgz
        in_range = dx * dx + dy * dy + dz * dz <= reg_factor_sq * radius_c
        use_sup = has_sup & in_range
        exist_sum[0] += torch.where(use_sup, rows[:, SX], 0.0)
        exist_sum[1] += torch.where(use_sup, rows[:, SY], 0.0)
        exist_sum[2] += torch.where(use_sup, rows[:, SZ], 0.0)
        exist_cnt += use_sup.to(torch.float32)

        adj = (src_pix + shift).clamp(0, hw - 1)
        adj_new = flags_f[adj] > 0
        adj_depth = img["meas"][adj]
        adj_prefix = prefix[adj]
        approx_sq = (depth_c - adj_depth) ** 2
        use_new = (~has_sup) & adj_new & \
            (approx_sq <= reg_factor_sq * radius_c)
        adj_dest = surfel_count + adj_prefix
        slot = torch.where(use_sup, sup,
                           torch.where(use_new & (adj_dest < n) &
                                       (adj_prefix < c_budget), adj_dest,
                                       INVALID_INDEX))
        nbr_slots.append(slot)
        # Stored distance: the quantity the slot was accepted under — the
        # exact supporter distance, or the depth-difference proxy for a
        # not-yet-created adjacent surfel (kernels.cu:207-215).
        nbr_dists.append(torch.where(
            slot == INVALID_INDEX, math.inf,
            torch.where(use_sup, dx * dx + dy * dy + dz * dz, approx_sq)))

    new_cols = [None] * PACK_WIDTH
    new_cols[PX], new_cols[PY], new_cols[PZ] = pgx, pgy, pgz
    new_cols[SX] = (pgx + exist_sum[0]) / exist_cnt
    new_cols[SY] = (pgy + exist_sum[1]) / exist_cnt
    new_cols[SZ] = (pgz + exist_sum[2]) / exist_cnt
    new_cols[NX], new_cols[NY], new_cols[NZ] = \
        img["ngx"][src_pix], img["ngy"][src_pix], img["ngz"][src_pix]
    new_cols[CONF] = torch.ones(c_budget, device=dev)
    new_cols[RAD] = radius_c
    new_cols[CR], new_cols[CG], new_cols[CB] = \
        img["cr"][src_pix], img["cg"][src_pix], img["cb"][src_pix]
    # Filled by an add, so a 0-d device frame index needs no host copy.
    frame_bits = torch.zeros(c_budget, dtype=torch.int32, device=dev) \
        .add_(frame_index).view(torch.float32)
    new_cols[CREATION] = frame_bits
    new_cols[STAMP] = frame_bits
    new_cols[RCNT] = torch.zeros(c_budget, device=dev)
    new_cols[DETACH] = torch.zeros(c_budget, device=dev)
    rows_c = torch.stack(new_cols, dim=1)                   # (C, PACK)
    nbrs_c = torch.stack(nbr_slots, dim=0)                  # (4, C)
    dists_c = torch.stack(nbr_dists, dim=0)                 # (4, C)

    free = (n - surfel_count).clamp_min(0)
    # clamp_max, not a minimum with a host-made tensor: no host copy.
    created = torch.minimum(total.clamp_max(c_budget), free)
    # Row r takes new row idx[r] - surfel_count when that is < created:
    # one pass over the rows instead of a host-synchronised slice.  Unused
    # working rows (idx INVALID_INDEX) never take one; creations land in
    # frontier tiles, which are always in the working set.
    j = idx - surfel_count
    take = (j >= 0) & (j < created)
    jc = j.clamp(0, c_budget - 1).long()
    pack = torch.where(take[:, None], rows_c[jc], pack)
    neighbors = torch.where(take[None, :], nbrs_c[:, jc], neighbors)
    nbr_dist = torch.where(take[None, :], dists_c[:, jc], nbr_dist)

    # Overflow counts only capacity-dropped creations; budget- and
    # bucket-deferred ones retry next frame and count as deferred.
    if capacity is not None:
        free = (capacity - surfel_count).clamp_min(0)
    capacity_short = (total.clamp_max(c_budget) - free).clamp_min(0)
    return (pack, neighbors, nbr_dist, surfel_count + created,
            overflow_count + capacity_short,
            deferred_count + (total - created - capacity_short))


def _regularize(params, pack, neighbors, nbr_dist, frame_index,
                sync_fn=None):
    """One gradient-descent denoising iteration (kernels.cu:2099-2308);
    -> (pack, neighbors, nbr_dist).

    Neighbor rows are read by global index from `sync_fn(pack)`, the full
    pack with this working set written in (`pack` itself when sync_fn is
    None).  With symmetric_regularization the iteration is
    ops/regularization.py (csrc/regularization.cu on the card); without
    it, the exact cross terms of _regularize_exact, plain PyTorch on every
    device.
    """
    gsrc = pack if sync_fn is None else sync_fn(pack)
    if params.symmetric_regularization:
        return regularization.regularize(pack, gsrc, neighbors, nbr_dist,
                                         frame_index, params)
    return _regularize_exact(params, pack, gsrc, neighbors, nbr_dist,
                             frame_index)


def _regularize_exact(params, pack, gsrc, neighbors, nbr_dist, frame_index):
    """_regularize without symmetric_regularization: every surfel adds its
    exact terms to its recent neighbors (the reference's atomicAdd,
    kernels.cu:2115-2194) through _ordered_scatter_add, and RCNT is not
    written.  Every recent surfel then steps its smoothed position with a
    data term toward the raw position, step length clamped to the surfel
    radius."""
    n = gsrc.shape[0]
    w_reg = float(np.float32(params.regularizer_weight))
    window = params.regularization_frame_window_size
    reg_factor_sq = float(np.float32(
        params.radius_factor_for_regularization_neighbors ** 2))

    sx, sy, sz = pack[:, SX], pack[:, SY], pack[:, SZ]
    nx_, ny_, nz_ = pack[:, NX], pack[:, NY], pack[:, NZ]
    stamps = pack.view(torch.int32)[:, STAMP]

    slot_valid = neighbors != INVALID_INDEX                  # (4, N)
    # The neighbours' columns this pass reads, each gathered as (4, N):
    # whole neighbour rows would be the step's largest temporary.
    slot_idx = _safe_idx(neighbors, n).long()

    def slot_col(col, dtype=torch.float32):
        return gsrc.view(dtype)[:, col][slot_idx]

    dx = slot_col(SX) - sx[None, :]
    dy = slot_col(SY) - sy[None, :]
    dz = slot_col(SZ) - sz[None, :]
    slot_stamps = slot_col(STAMP, torch.int32)
    del slot_idx
    use = slot_valid & (slot_stamps >= frame_index - window)

    cnt = _slot_sum(use.to(torch.float32))
    ndot = nx_[None, :] * dx + ny_[None, :] * dy + nz_[None, :] * dz
    nbr_dist_sq = dx * dx + dy * dy + dz * dz

    recent_self = stamps >= frame_index - window
    pack = pack.clone()
    # Exact cross terms: each surfel adds its own terms to its recent
    # neighbors, over the (4, N) slots flattened slot-major.
    term = _div(2.0 * w_reg, cnt.clamp_min(1.0))[None, :] * ndot
    wcnt = _div(w_reg, cnt.clamp_min(1.0))[None, :].expand(4, -1)
    grad_x, grad_y, grad_z, gcount = _ordered_scatter_add(
        n, torch.where(use, neighbors, INVALID_INDEX).reshape(-1),
        torch.stack([term * nx_[None, :], term * ny_[None, :],
                     term * nz_[None, :], wcnt]).reshape(4, -1))

    # Remove active neighbors that drifted out of range (kernels.cu:2184-
    # 2192).  With fast_neighbor_update, slots pointing at merge tombstones
    # (stamp 0) go too: they stand in for the skipped detach sweep.
    drop = use & (nbr_dist_sq > reg_factor_sq * pack[:, RAD][None, :])
    if params.fast_neighbor_update:
        tombstoned = (slot_stamps == 0) & (frame_index > 0)
        drop = drop | (slot_valid & tombstoned)
    neighbors = torch.where(drop, INVALID_INDEX, neighbors)

    # Per-surfel step (kernels.cu:2197-2308) over the updated neighbor list.
    valid2 = neighbors != INVALID_INDEX
    ndot2 = torch.where(valid2, ndot, 0.0)
    cnt2 = _slot_sum(valid2.to(torch.float32))
    sum_ndot2 = _slot_sum(ndot2)
    factor2 = torch.where(cnt2 > 0, _div(2.0 * w_reg, cnt2.clamp_min(1.0)),
                          0.0)
    reg_x = -sum_ndot2 * nx_
    reg_y = -sum_ndot2 * ny_
    reg_z = -sum_ndot2 * nz_

    gx = 2.0 * (sx - pack[:, PX]) + grad_x + factor2 * reg_x
    gy = 2.0 * (sy - pack[:, PY]) + grad_y + factor2 * reg_y
    gz = 2.0 * (sz - pack[:, PZ]) + grad_z + factor2 * reg_z
    weight_sum = (1.0 + w_reg) + gcount
    step = _div(0.5, weight_sum)
    max_step = sqrt_f32(pack[:, RAD])   # NaN for merged surfels, as in CUDA
    grad_len = step * sqrt_f32(gx * gx + gy * gy + gz * gz)
    step_factor = torch.where(grad_len > max_step,
                              max_step / grad_len.clamp_min(1e-30) * step,
                              step)
    pack[:, SX] = torch.where(recent_self, sx - step_factor * gx, sx)
    pack[:, SY] = torch.where(recent_self, sy - step_factor * gy, sy)
    pack[:, SZ] = torch.where(recent_self, sz - step_factor * gz, sz)
    if params.fast_neighbor_update:
        # The stored slot distances the next neighbor update replaces
        # against, from this pass's smoothed positions.
        nbr_dist = torch.where(valid2, nbr_dist_sq, math.inf)
    return pack, neighbors, nbr_dist


def regularize_only(state: SurfelState, frame_index,
                    params: FusionParams) -> SurfelState:
    """Standalone regularization iteration (CUDASurfelReconstruction::
    Regularize, cuda_surfel_reconstruction.cc:322-337; driven by the 'd'
    terminal key, main.cc:1573-1580).  Returns a new state.  `frame_index`
    is an int or a 0-d int32 tensor (identical bits)."""
    pack, neighbors, nbr_dist = _regularize(
        params, state.pack, state.neighbors, state.nbr_dist,
        _frame_scalar(frame_index, state.pack.device))
    return dataclasses.replace(state, pack=pack, neighbors=neighbors,
                               nbr_dist=nbr_dist)


# ---------------------------------------------------------------------------
# Export.
# ---------------------------------------------------------------------------

def export_vertices(state: SurfelState):
    """ExportVerticesCUDA (kernels.cu:2412-2464): smoothed positions with NaN
    for merged surfels, plus colors.  Returns ((N, 3) f32, (N, 3) u8)."""
    merged = state.pack[:, RAD] < 0
    pos = torch.where(merged[:, None], math.nan, state.pack[:, SX:SZ + 1])
    return pos, colors_u8(state)


def meshing_snapshot(state: SurfelState):
    """The SoA snapshot consumed by the meshing engine, the fields the
    reference downloads in TransferAllToCPU
    (cuda_surfel_reconstruction.cc:339-359): (smooth (N, 3), radius_sq
    (N,), normal (N, 3), stamps (N,) int32, surfel_count), all on the
    state's device."""
    return (smooth_positions(state), radii_sq(state), normals(state),
            update_stamps(state), state.surfel_count)


def meshing_snapshot_delta(state: SurfelState, last_snap_frame: int,
                           window: int,
                           before_size_read: Optional[Callable[[], None]]
                           = None):
    """Changed-rows snapshot for the meshing engine: index and payload of
    the live rows that can have changed since the snapshot taken at
    `last_snap_frame` (the JAX package's rule):

      - stamp >= last_snap_frame + 1 - window: integrated or created since,
        or moved by regularization on a frame after that snapshot (a row
        with stamp s is regularized on every frame f <= s + window);
      - radius < 0: merge tombstones (their stamp is 0).

    Returns (indices int32, positions (m, 3), radii_sq (m,), normals
    (m, 3), stamps int32 (m,), m, surfel_count) on the state's device, all
    m dirty rows in ascending index order.  Sizing the result by m reads
    the count on the host (a synchronisation), just after
    `before_size_read()` where given; the JAX package's fixed-size
    `max_rows` bucket has no counterpart."""
    pack = state.pack
    n = pack.shape[0]
    live = torch.arange(n, dtype=torch.int32, device=pack.device) < \
        state.surfel_count
    dirty = live & ((update_stamps(state) >= last_snap_frame + 1 - window) |
                    (pack[:, RAD] < 0))
    if before_size_read is not None:
        before_size_read()
    rows = torch.nonzero(dirty).squeeze(1)
    # Rows move as int32 bits, never through float arithmetic.
    bits = pack.view(torch.int32)[rows]
    payload = bits.view(torch.float32)
    return (rows.to(torch.int32), payload[:, SX:SZ + 1], payload[:, RAD],
            payload[:, NX:NZ + 1], bits[:, STAMP], rows.shape[0],
            state.surfel_count)
