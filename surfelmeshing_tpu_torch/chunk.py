"""Chunked dispatch (--frame_chunk K > 1): the step that runs a sub-chunk
of deferred frames, the counterpart of the JAX pipeline's
_build_chunk_step (one jitted lax.scan whose body is the per-frame
preprocess + fusion step).

ChunkStep.run copies the frames' inputs into static buffers (device to
device from prefetch_inputs' staged tensors, host to device through
pinned memory otherwise) and runs the chunk body: for each frame the
pyramid downscale if set, preprocess_frame and integrate_frame_bucketed,
its results written into the map's own tensors (the 0-d counters
included), so the map's tensors never move.

On the CPU the body is called directly; the tests exercise the code the
card captures.  On a CUDA device each (frames, n_eff, FusionParams) key
is captured once as a CUDA graph and replayed: one submission from the
host for the sub-chunk's ~2,800 launches a frame, the role of JAX's
(length, bucket) compile.  Before the first capture of a key the body
runs once on a scratch copy of the map (kernel libraries loaded, every
op's device code loaded, cached constants built); neither the warm-up
nor the capture advances the map.  All graphs draw on one memory pool:
replays never overlap and nothing allocated in a capture outlives it.
A capture or replay failure raises; nothing falls back to eager
dispatch.

The one mode that is not captured: symmetric_regularization=False reads
the longest scatter run on the host (fusion._ordered_scatter_add), so a
sub-chunk of that mode runs its frames eagerly on the card, one after
another (same deferral and picks; `graphs_for` says which; logged once,
at the first such sub-chunk on the card).

Kernel launches: a capture runs the wrappers on the host without
launching anything.  Each graph keeps the counts its capture added to
ops/launch_counts.py's counters, the counters are restored to their value
before the warm-up, and each replay adds the graph's counts: the counters
count the kernels the card ran, as eager dispatch would (a fused frame:
one blending launch, one of each preprocessing kernel).
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from .ops import launch_counts
from .ops import preprocess as pp
from .ops.fusion import (FusionParams, StageTimer, SurfelState,
                         integrate_frame_bucketed)
from .utils.timing import stream_sync, tracer

STATE_FIELDS = tuple(f.name for f in dataclasses.fields(SurfelState))
COUNTERS = STATE_FIELDS[3:]


def pose_pack(transforms, t_gl, t_lg, frame_index: int) -> np.ndarray:
    """A frame's small inputs as one flat f32 vector: [K*12 outlier
    transforms | 12 t_gl | 12 t_lg | frame_index] (the JAX pipeline's
    _pose_pack; the frame index rides as f32, exact below 2**24)."""
    return np.concatenate([
        np.asarray(transforms, np.float32).reshape(-1),
        np.asarray(t_gl, np.float32).reshape(-1),
        np.asarray(t_lg, np.float32).reshape(-1),
        np.float32([frame_index])]).astype(np.float32)


def split_pose_pack(pack: torch.Tensor, k: int) -> tuple:
    """(transforms (k,3,4), t_gl (3,4), t_lg (3,4), 0-d int32 frame index)
    views of a pose pack."""
    return (pack[:12 * k].view(k, 3, 4),
            pack[12 * k:12 * k + 12].view(3, 4),
            pack[12 * k + 12:12 * k + 24].view(3, 4),
            pack[12 * k + 24].to(torch.int32))


@dataclasses.dataclass
class ChunkEntry:
    """One deferred frame's inputs: its depth window ([reference, K
    others] device tensors, kept alive past the window's retirement), its
    (3,H,W) u8 color and its pose pack, each a device tensor when
    prefetched, else a host array; and its frame index (the id of its
    spans)."""
    depths: list
    color: object
    pose: object
    index: int


def _same_tensors(a: SurfelState, b: SurfelState) -> bool:
    return all(getattr(a, f) is getattr(b, f) for f in STATE_FIELDS)


def same_layout(a: SurfelState, b: SurfelState) -> bool:
    """Whether every field of the two maps has one shape, dtype and
    device (so one can be copied into the other)."""
    def layout(t):
        return t.shape, t.dtype, t.device
    return all(layout(getattr(a, f)) == layout(getattr(b, f))
               for f in STATE_FIELDS)


def clone_state(state: SurfelState) -> SurfelState:
    """A copy of every tensor of the map."""
    return SurfelState(**{f: getattr(state, f).clone()
                          for f in STATE_FIELDS})


class ChunkStep:
    """The chunk step of one pipeline: static input buffers, the chunk
    body and, on a CUDA device, its graphs.

    captures, replays and capture_s count the graphs captured (warm-up
    included in the seconds), the replays and the host seconds they
    took; keys lists the captured (frames, n_eff, active_surfel_budget)
    in capture order."""

    def __init__(self, config, device, pp_kwargs: dict):
        self.device = device
        self.k = config.outlier_filtering_frame_count
        self.level = config.pyramid_level
        self.capacity = config.frame_chunk
        self.pp_kwargs = pp_kwargs
        self._buffers = None      # (depth, color, poses), at first run
        self._graphs = {}         # key -> (CUDAGraph, launch counts)
        self._bound = None        # the map the graphs write
        self._pool = None
        self._eager_logged = False
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self.keys = []

    def graphs_for(self, params: FusionParams) -> bool:
        """Whether a sub-chunk with these params is a CUDA-graph replay
        (else it runs eagerly: on the CPU, or symmetric_regularization
        False on the card)."""
        return self.device.type == "cuda" and \
            params.symmetric_regularization

    def has_graphs(self) -> bool:
        return bool(self._graphs)

    def drop_graphs(self) -> None:
        """Forget every graph (the map they write is being replaced)."""
        self._graphs.clear()
        self._bound = None

    def run(self, state: SurfelState, entries: list, params: FusionParams,
            n_eff: int) -> None:
        """Fuse the entries' frames into `state`, in place.  Traced as the
        spans chunk.stage, chunk.capture and chunk.replay (with the device
        span dev.chunk.replay), each with the last frame's index."""
        size = len(entries)
        traced = tracer.on
        last = entries[-1].index
        if traced:
            tracer.begin("chunk.stage", last)
        self._stage(entries)
        if traced:
            tracer.end()
        if not self.graphs_for(params):
            if self.device.type == "cuda" and not self._eager_logged:
                self._eager_logged = True
                logging.getLogger("surfelmeshing_tpu_torch").info(
                    "frame_chunk: symmetric_regularization=False reads the "
                    "host in its scatter, so its chunks run eagerly on the "
                    "card, not as CUDA graphs")
            self._body(state, size, params, n_eff)
            return
        if self._bound is not None and not _same_tensors(state,
                                                         self._bound):
            self.drop_graphs()
        self._bound = state
        key = (size, n_eff, params)
        if key not in self._graphs:
            if traced:
                tracer.begin("chunk.capture", last)
            self._graphs[key] = self._capture(state, size, params, n_eff)
            if traced:
                tracer.end()
        graph, counts = self._graphs[key]
        if traced:
            tracer.begin("chunk.replay", last)
            timer = StageTimer(self.device)
            timer("chunk.replay")
        graph.replay()
        if traced:
            timer(None)
            tracer.end()
            tracer.device(timer, "dev.", last)
        launch_counts.add(counts)
        self.replays += 1

    # -- inputs ---------------------------------------------------------

    def _host(self, array: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(array))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _stage(self, entries: list) -> None:
        """Copy the entries' inputs into the static buffers' first
        len(entries) slots."""
        s = len(entries)
        if self._buffers is None:
            e = entries[0]
            d, c, p = e.depths[0], e.color, e.pose
            self._buffers = (
                torch.empty((self.capacity, len(e.depths)) + tuple(d.shape),
                            dtype=torch.int32, device=self.device),
                torch.empty((self.capacity,) + tuple(c.shape),
                            dtype=torch.uint8, device=self.device),
                torch.empty((self.capacity,) + tuple(p.shape),
                            dtype=torch.float32, device=self.device))
        depth, color, poses = self._buffers
        torch.stack([d for e in entries for d in e.depths],
                    out=depth[:s].view((-1,) + tuple(depth.shape[2:])))
        for buf, items in ((color, [e.color for e in entries]),
                           (poses, [e.pose for e in entries])):
            if all(isinstance(x, torch.Tensor) for x in items):
                torch.stack(items, out=buf[:s])
                continue
            for j, x in enumerate(items):
                if not isinstance(x, torch.Tensor):
                    x = self._host(x)
                    if tracer.on:
                        tracer.h2d(x)
                buf[j].copy_(x, non_blocking=True)

    # -- the chunk body -------------------------------------------------

    def _body(self, state: SurfelState, size: int, params: FusionParams,
              n_eff: int) -> None:
        """The first `size` buffered frames, one after another, written
        into `state`'s tensors: the per-frame step of the pipeline."""
        depth, color, poses = self._buffers
        for i in range(size):
            ref, others = depth[i, 0], depth[i, 1:]
            if self.level > 0:
                factor = 1 << self.level
                ref = pp.downscale_median_excluding(ref, factor)
                others = torch.stack([pp.downscale_median_excluding(o, factor)
                                      for o in others])
            transforms, t_gl, t_lg, frame = split_pose_pack(poses[i], self.k)
            d, nrm, rad = pp.preprocess_frame(ref, others, transforms,
                                              **self.pp_kwargs)
            out = integrate_frame_bucketed(state, d, nrm, rad, color[i],
                                           t_gl, t_lg, frame, params, n_eff)
            for name in COUNTERS:
                dst, src = getattr(state, name), getattr(out, name)
                if dst is not src:
                    dst.copy_(src)

    # -- CUDA graphs ----------------------------------------------------

    def _capture(self, state: SurfelState, size: int, params: FusionParams,
                 n_eff: int) -> tuple:
        """Warm the body up on a scratch copy of the map, then capture it
        on the map; -> (graph, the launch counts one replay adds)."""
        t0 = time.perf_counter()
        counts = launch_counts.snapshot()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._body(clone_state(state), size, params, n_eff)
        current.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        if tracer.on:             # torch.cuda.graph synchronises first
            tracer.wait("capture", block=stream_sync(self.device))
        before = launch_counts.snapshot()
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            self._body(state, size, params, n_eff)
        captured = launch_counts.since(before)
        launch_counts.restore(counts)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        self.keys.append((size, n_eff, params.active_surfel_budget))
        return graph, captured
