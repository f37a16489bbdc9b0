"""The dispatch policy of the port's frame loop (JAX pipeline.py:266-374,
502-506,731-760): the bucket or active-set budget of each dispatch (a
frame, or a sub-chunk of deferred frames).

Without an active-surfel budget every frame is count-sized, the
reference's launches over surfels_size (cuda_surfel_reconstruction.cc:
131-140) and the JAX package's --use_shape_buckets dispatch: it runs
fusion.integrate_frame_bucketed over n_eff rows, the smallest multiple of
shape_bucket_step at or above a bound on the surfel count (count_bound:
the last confirmed count plus a creation charge per frame dispatched
since; adaptive_creation_bound tightens the charge).  With the exact
bound (adaptive_creation_bound 0) the result is the full-shape one bit
for bit; a shape_bucket_step of max_surfel_count runs every frame over
the whole capacity.  config.use_shape_buckets is accepted and changes
nothing.  `picks` records (frames, n_eff) for every dispatch.

Active-set tiling (config.active_surfel_budget) is the JAX package's:
a budget N > 0 is passed to integrate_frame, and -1 sizes each frame's
budget from the lagged visible-tile demand (auto_budget).  The bucket
and auto-budget policies read the surfel count and that demand through
non-blocking copies into pinned memory, one per dispatch, consumed once
their CUDA event has fired; the frame loop waits only while more than
max_inflight_dispatches - 1 are outstanding, the JAX package's throttle.
The same readback carries the running count of skipped tiles, and under
the auto budget the tracer's tile counters (counters) are summed from the
confirmed readbacks.  A new map (a loaded checkpoint) restarts both
from its count (reset).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .ops.fusion import FusionParams, SurfelState
from .utils.timing import tracer


def start_readback(values: torch.Tensor) -> tuple:
    """Start copying a small int32 tensor to the host without waiting:
    -> (host tensor, CUDA event or None).  A CUDA tensor is copied into
    pinned memory behind an event; its values are valid once the event has
    fired.  A CPU tensor is its own readback (event None)."""
    if not values.is_cuda:
        return values, None
    host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
    host.copy_(values, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def readback_values(state: SurfelState) -> list:
    """The map's counters a readback copies, in its order."""
    return [state.surfel_count, state.active_tile_count,
            state.deferred_count, state.skipped_tile_count]


class DispatchPolicy:
    """The picks of one pipeline, from `params` (the fusion parameters
    each dispatch starts from), and the bookkeeping they read.  bucket_for
    maps a count bound to its bucket (default shape_bucket_for; a
    pipeline passes its own method, so a replacement of it there picks)."""

    def __init__(self, config, params: FusionParams, camera,
                 bucket_for: Optional[Callable[[int], int]] = None):
        self.config = config
        self.params = params
        self.pixels = camera.width * camera.height
        self._bucket_for = bucket_for or self.shape_bucket_for
        # The last confirmed surfel count, tile demand, deferred and
        # skipped totals, the creations confirmed, the confirmed tile
        # demand and working-set rows summed over frames, the frames
        # dispatched since the last confirmed readback, the FIFO of
        # in-flight readbacks (host tensor, CUDA event or None, frames,
        # budget) and recent per-frame growth samples (for
        # adaptive_creation_bound); the active-set budget of the last pick
        # and (frames, n_eff) of every pick.
        self.confirmed_count = 0
        self.lagged_active_tiles = 0
        self.confirmed_deferred = 0
        self.confirmed_skipped = 0
        self.creations_made = 0
        self.tiles_active = 0
        self.tiles_working_rows = 0
        self.unconfirmed_frames = 0
        self.readbacks = []
        self.growth_window = []
        self.budget = config.active_surfel_budget
        self.picks = []

    def reset(self, state: SurfelState) -> None:
        """Restart from a new map's counts, read here (a blocking read),
        dropping the old map's readbacks."""
        count, tiles, self.confirmed_deferred, self.confirmed_skipped = \
            torch.stack(readback_values(state)).tolist()
        self.readbacks = []
        self.restore((count, tiles, []))

    def snapshot(self) -> tuple:
        """What the next picks read, for restore (with none in flight)."""
        return (self.confirmed_count, self.lagged_active_tiles,
                list(self.growth_window))

    def restore(self, snap: tuple) -> None:
        self.confirmed_count, self.lagged_active_tiles, growth = snap
        self.growth_window = list(growth)
        self.unconfirmed_frames = 0

    def counters(self) -> dict:
        """The tracer's creation counters and, under the auto budget, its
        tile counters, as far as the readbacks have confirmed them (they
        lag the dispatches by the readbacks in flight; a fixed active
        budget starts none): tiles.active sums the tile demand of each
        frame (a sub-chunk's last frame stands for each of its frames),
        tiles.working_rows the budget in rows of each frame, and
        tiles.skipped is the map's running count of skipped tiles."""
        out = {"creations.made": self.creations_made,
               "creations.deferred": self.confirmed_deferred}
        if self.config.active_surfel_budget == -1:
            out.update({"tiles.active": self.tiles_active,
                        "tiles.skipped": self.confirmed_skipped,
                        "tiles.working_rows": self.tiles_working_rows})
        return out

    def pick(self, state: SurfelState, frames: int) -> tuple:
        """(params, n_eff) for a dispatch of `frames` frames into `state`:
        without an active-surfel budget the bucket above the count bound
        after them; with one the capacity, with the auto budget (-1) the
        budget from the readbacks confirmed so far.  Logged in picks;
        traced as the span dispatch.pick."""
        traced = tracer.on
        if traced:
            tracer.begin("dispatch.pick")
        budget = self.config.active_surfel_budget
        if budget <= 0:          # both policies read the confirmed count
            self.drain(max(self.config.max_inflight_dispatches - 1, 0))
        params, n_eff = self.params, state.pack.shape[0]
        if budget == 0:
            n_eff = self._bucket_for(self.count_bound(frames))
        elif budget == -1:
            params = dataclasses.replace(
                params, active_surfel_budget=self.auto_budget(n_eff, frames))
        self.budget = params.active_surfel_budget
        self.picks.append((frames, n_eff))
        if traced:
            tracer.end()
        return params, n_eff

    def least_bucket(self) -> int:
        """The smallest n_eff any later pick can choose until the map is
        replaced (0: any, with an active-surfel budget)."""
        if self.config.active_surfel_budget != 0:
            return 0
        return self._bucket_for(self.confirmed_count)

    def queue_readback(self, state: SurfelState, frames: int) -> None:
        """Start the copy of (surfel_count, active_tile_count,
        deferred_count, skipped_tile_count) to the host without waiting for
        it (buckets or the auto budget), charged for the dispatch's
        `frames` frames at the last pick's budget."""
        if self.config.active_surfel_budget > 0:
            return
        self.readbacks.append(start_readback(torch.stack(
            readback_values(state))) + (frames, self.budget))
        self.unconfirmed_frames += frames

    def drain(self, max_outstanding: int) -> None:
        """Consume the readbacks whose copy has completed, in dispatch
        order, and block on the oldest while more than max_outstanding
        are unconfirmed.  A readback of `frames` frames gives the growth
        sample ceil(growth / frames)."""
        pend = self.readbacks
        while pend:
            values, event, frames, budget = pend[0]
            fired = event is None or event.query()
            if not fired and len(pend) <= max_outstanding:
                break
            pend.pop(0)
            if not fired:
                if tracer.on:
                    tracer.wait("readback", block=event.synchronize)
                else:
                    event.synchronize()
            new_count, active_tiles, deferred, self.confirmed_skipped = \
                values.tolist()
            self.tiles_active += active_tiles * frames
            self.tiles_working_rows += budget * frames
            self.growth_window.append(
                (new_count - self.confirmed_count + frames - 1) // frames)
            del self.growth_window[:-4]
            self.creations_made += new_count - self.confirmed_count
            self.confirmed_deferred = deferred
            self.confirmed_count = new_count
            self.lagged_active_tiles = active_tiles
            self.unconfirmed_frames -= frames

    def count_bound(self, frames: int = 0) -> int:
        """Upper bound on the surfel count after `frames` more frames: the
        last confirmed count plus one creation charge per unconfirmed
        frame, the full creation budget or, with adaptive_creation_bound,
        factor * the larger of the two latest confirmed growths (at least
        2048; a burst past it defers creations to the next frame)."""
        budget = self.params.max_creations_per_frame
        factor = self.config.adaptive_creation_bound
        if factor > 0 and self.growth_window:
            budget = min(budget, max(
                2048, int(factor * max(self.growth_window[-2:]))))
        return self.confirmed_count + \
            (self.unconfirmed_frames + frames) * budget

    def shape_bucket_for(self, count_bound: int) -> int:
        """The bucket for a surfel-count bound: the smallest multiple of
        shape_bucket_step holding it, at most max_surfel_count.  A fixed
        step keeps each per-surfel pass within one step of the live count
        at any map size."""
        step = self.config.shape_bucket_step
        n_eff = -(-max(count_bound, 1) // step) * step
        return int(min(max(n_eff, step), self.config.max_surfel_count))

    def auto_budget(self, capacity: int, frames: int = 1) -> int:
        """The auto budget of a dispatch of `frames` frames into a map of
        `capacity` rows: twice the lagged tile demand (or, before any
        demand is seen, twice the count bound) on a power-of-2 tile
        ladder, at least the creation frontier plus one tile, at most the
        capacity.  A demand jump past the 2x headroom skips tiles
        (skipped_tile_count) until the budget catches up.  A frame
        (frames 1) gets the JAX package's budget.  A chunk's budget holds
        for all its frames while its readback lags the unconfirmed ones
        too, so it adds a creation frontier's tiles for each of those
        frames (and its seed counts them): the JAX package's chunk adds
        nothing and skipped 24 tiles at 20m:-1 with frame_chunk 4 in the
        port (ROADMAP queue 3 #10)."""
        ts = self.params.tile_size
        c_budget = min(self.params.max_creations_per_frame, self.pixels)
        floor_tiles = c_budget // ts + 2
        chunk = frames > 1
        if self.lagged_active_tiles > 0:
            want_tiles = 2 * self.lagged_active_tiles
            if chunk:
                want_tiles += (self.unconfirmed_frames + frames) * \
                    -(-c_budget // ts)
        else:
            want_tiles = -(-2 * max(self.count_bound(
                frames if chunk else 0), 1) // ts)
        tiles = max(floor_tiles, want_tiles)
        tiles = 1 << (tiles - 1).bit_length()
        return int(min(tiles * ts, capacity))
