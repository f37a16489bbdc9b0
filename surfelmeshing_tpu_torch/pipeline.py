"""Per-frame reconstruction pipeline on one explicit torch device.

Counterpart of surfelmeshing_tpu/pipeline.py's per-frame step: keeps the
resident window of depth frames for outlier filtering, runs preprocessing
and fusion on the device, ships meshing snapshots (full, then changed rows
only), tracks per-stage host timings and exports results.  With
frame_chunk 1 (the default) torch runs each frame's step
(chunk.FrameStep) eagerly as it comes.
Of the JAX package's dispatch machinery the precompiles
(precompile_shape_buckets, set_allowed_buckets, shape_bucket_ladder) and
the delta-row bucket have no counterpart: nothing here is compiled per
shape.

Chunked dispatch (frame_chunk K > 1) is the JAX package's: frames are
deferred (process_frame returns FrameResult(i, -1, -1)) and flushed at K
pending frames, and by every read of the map (state, snapshots, exports,
surfel_count, drain, block_until_ready, snapshot_dispatch_state), as
power-of-2 sub-chunks, largest first; each sub-chunk of `size` frames
takes one bucket pick and one count readback, charged for `size` frames
(bucket_pick_log records (size, n_eff)), and its host time is
"integration", amortized per frame in the timings line.  A sub-chunk runs
through chunk.ChunkStep, on the card as CUDA-graph replays
(graph_captures, graph_replays, graph_capture_s, graph_keys count them).
Assigning `state` raises while frames are pending.  log_timings_staged
and debug_depth_preprocessing need per-frame intermediates and do not
defer, as in the JAX package.

The bucket or active-set budget of each dispatch (a frame, or a
sub-chunk) is dispatch.DispatchPolicy's pick, from the surfel count and
tile demand read back without waiting; assigning `state` restarts it
from the new map.  The bucketed step writes its rows into the map's
tensors in place (the JAX package donates the map), so a caller that
keeps a map across frames copies it, as snapshot_dispatch_state does.

Stage timings (the Timing tags of the app's report and the timings
line's host columns) are host times around eager calls that return
before the device finishes: preprocessing the launch of preprocess_frame,
integration from there to the end of the fusion step's launch (or a
flush's), surfel_transfer a snapshot, which reads the device and so
includes the wait for the frames queued before it.  With log_timings and
log_timings_staged set, preprocessing and the fusion phases are timed on
the device instead (fusion.StageTimer, read when the timings line waits
for the count), under the reference's per-phase columns.

While the tracer (utils/timing.tracer) is on, the frame loop records the
spans frame (input.depth, input.stage, preprocess, dispatch.pick, fusion,
flush), flush (chunk.stage, chunk.capture, chunk.replay), drain and
snapshot (snapshot.select, snapshot.copy); preprocess, fusion, flush and
snapshot share their clock readings with the stage timings.
wait.upload, wait.readback, wait.drain and wait.snapshot cover the host
blocked on the card: a blocking upload runs as a copy enqueued and then
that wait, and a snapshot waits where its size read would, after the
selection's launches.  Each per-frame step hands the tracer the device
times of the five preprocessing passes and the fusion phases.
debug_depth_preprocessing saves each preprocessing pass as a PNG under
./debug_preprocessing, as the JAX pipeline does.

The JAX pipeline's driver support for the bench tools is carried:
prefetch_inputs stages a frame range's inputs on the device ahead of a
timed loop, drain is a dispatch barrier, and snapshot_dispatch_state /
restore_dispatch_state let a bench re-run its timed region from a known
point.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import resolve_device
from .chunk import (ChunkEntry, ChunkStep, FrameStep, clone_state,
                    pose_pack, same_layout)
from .config import SurfelMeshingConfig
from .dispatch import DispatchPolicy
from .io.mesh_io import write_ply
from .io.tum import RGBDVideo
from .ops import association, blend, cuda_build, integration, tiling
from .ops import preprocess as pp
# integrate_frame_bucketed: chunk.FrameStep calls it; wrappers patch both.
from .ops.fusion import (FusionParams, StageTimer, SurfelState,  # noqa: F401
                         create_surfel_state, export_vertices,
                         integrate_frame_bucketed, meshing_snapshot,
                         meshing_snapshot_delta, normals)
from .utils.camera import PinholeCamera
from .utils.timing import (COLUMNS, Timing, format_frame_timings_line,
                           stream_sync, tracer)

# The pass that follows each preprocessing pass (None after the last): the
# column a pass's on_stage call opens in its StageTimer.
_NEXT_PASS = dict(zip(pp.PASSES, pp.PASSES[1:] + (None,)))


@dataclasses.dataclass
class FrameResult:
    frame_index: int
    surfel_count: int
    merge_count: int


def fusion_params_from_config(config: SurfelMeshingConfig,
                              camera: PinholeCamera) -> FusionParams:
    return FusionParams(
        width=camera.width, height=camera.height,
        fx=camera.fx, fy=camera.fy, cx=camera.cx, cy=camera.cy,
        depth_scaling=config.depth_scaling,
        sensor_noise_factor=config.sensor_noise_factor,
        max_surfel_confidence=config.max_surfel_confidence,
        normal_compatibility_threshold_deg=(
            config.normal_compatibility_threshold_deg),
        regularizer_weight=config.regularizer_weight,
        regularization_frame_window_size=(
            config.regularization_frame_window_size),
        do_blending=config.do_blending,
        measurement_blending_radius=config.measurement_blending_radius,
        regularization_iterations=(
            config.regularization_iterations_per_integration_iteration),
        radius_factor_for_regularization_neighbors=(
            config.radius_factor_for_regularization_neighbors),
        surfel_integration_active_window_size=(
            config.surfel_integration_active_window_size),
        active_surfel_budget=config.active_surfel_budget,
        max_creations_per_frame=config.max_creations_per_frame,
    )


def preprocess_kwargs(config: SurfelMeshingConfig,
                      camera: PinholeCamera) -> dict:
    """preprocess_frame keyword arguments from the config and the camera
    (already pyramid-level-adjusted)."""
    required = config.outlier_filtering_required_inliers
    if required in (config.outlier_filtering_frame_count, -1):
        required = None   # the all-inlier kernel variant
    return dict(
        sigma_xy=config.bilateral_filter_sigma_xy,
        sigma_value_factor=config.bilateral_filter_sigma_depth_factor,
        radius_factor=config.bilateral_filter_radius_factor,
        max_depth_u16=int(config.depth_scaling * config.max_depth),
        depth_valid_region_radius=config.depth_valid_region_radius,
        tolerance=config.outlier_filtering_depth_tolerance_factor,
        required_inliers=required,
        erosion_radius=config.depth_erosion_radius,
        observation_angle_threshold_deg=(
            config.observation_angle_threshold_deg),
        depth_scaling=config.depth_scaling,
        point_radius_extension_factor=config.point_radius_extension_factor,
        point_radius_clamp_factor=config.point_radius_clamp_factor,
        fx=camera.fx, fy=camera.fy, cx=camera.cx, cy=camera.cy)


class ReconstructionPipeline:
    """Depth preprocessing + surfel fusion over an RGB-D stream."""

    def __init__(self, config: SurfelMeshingConfig, camera: PinholeCamera,
                 device):
        config.validate()
        self.config = config
        self.camera = camera.pyramid_level(config.pyramid_level)
        self.device = resolve_device(device)
        self.policy = DispatchPolicy(
            config, fusion_params_from_config(config, self.camera),
            self.camera, lambda bound: self.shape_bucket_for(bound))
        capacity = config.max_surfel_count
        if config.active_surfel_budget:
            # Tiling needs a tile-aligned capacity; round up.
            ts = self.fusion_params.tile_size
            capacity = (capacity + ts - 1) // ts * ts
        self._state: SurfelState = create_surfel_state(capacity,
                                                       self.device)
        self._log_device_memory()
        # The frame step, and for chunked dispatch (module docstring) the
        # deferred frames (chunk.ChunkEntry) and the step that runs them.
        self._step = FrameStep(config, preprocess_kwargs(config,
                                                         self.camera))
        self._pending = []
        self._defer = (config.frame_chunk > 1 and
                       not config.log_timings_staged and
                       not config.debug_depth_preprocessing)
        self._chunk = ChunkStep(config, self.device, self._step,
                                self.policy) if self._defer else None
        self.timing = Timing()
        self.timings_log_lines = []
        self._last_stage_ms: Dict[str, float] = {}
        # log_timings_staged: the last frame's (preprocessing, fusion)
        # StageTimers, read by log_frame_timings.
        self._staged_timers = None
        # Resident depth-frame window keyed by frame index, mirroring
        # frame_index_to_depth_buffer (main.cc:904-968).
        self._depth_buffers: Dict[int, torch.Tensor] = {}
        # Device-staged (pose pack, color) of prefetched frames.
        self._staged_inputs: Dict[int, tuple] = {}
        # Delta-snapshot state: the frame of the last meshing snapshot and
        # what all snapshots shipped.
        self._last_snap_frame: Optional[int] = None
        self.snapshot_rows_shipped = 0
        self.snapshot_count = 0
        # (frames, n_eff) of every dispatch: a frame, or a sub-chunk.
        self.bucket_pick_log = self.policy.picks
        tracer.watch(self)

    @property
    def fusion_params(self) -> FusionParams:
        """The policy's: what each dispatch starts from."""
        return self.policy.params

    @fusion_params.setter
    def fusion_params(self, value: FusionParams) -> None:
        self.policy.params = value

    @property
    def state(self) -> SurfelState:
        """The surfel map; reading it runs the deferred frames first.  A
        frame writes its rows into these tensors in place."""
        self._flush()
        return self._state

    @state.setter
    def state(self, value: SurfelState) -> None:
        """Replace the map (a loaded checkpoint, regularize_only): the
        dispatch policy restarts from the new map's surfel count and tile
        demand, read once here, and drops the old map's readbacks.
        Refused while frames are pending (the JAX pipeline's rule)."""
        if self._pending:
            raise RuntimeError(
                "cannot replace pipeline state while deferred frames are "
                "pending (read .state first to flush them)")
        self.policy.reset(value)
        self._adopt(value, copy=False)

    def _adopt(self, value: SurfelState, copy: bool) -> None:
        """Make `value` the map.  While chunk graphs write the map's
        tensors, a value of the same layout is copied into them, so the
        graphs stay valid; otherwise the graphs are dropped and `value`
        (a copy of it with `copy`) becomes the map."""
        if self._chunk is not None and self._chunk.has_graphs() and \
                same_layout(self._state, value):
            for f in dataclasses.fields(SurfelState):
                dst, src = getattr(self._state, f.name), \
                    getattr(value, f.name)
                if dst is not src:
                    dst.copy_(src)
            return
        if self._chunk is not None:
            self._chunk.drop_graphs()
        self._state = clone_state(value) if copy else value

    # -- chunk graph counters (0 without chunked dispatch) ----------------

    @property
    def graph_captures(self) -> int:
        return self._chunk.captures if self._chunk else 0

    @property
    def graph_replays(self) -> int:
        return self._chunk.replays if self._chunk else 0

    @property
    def graph_capture_s(self) -> float:
        """Host seconds of the captures, their warm-ups included."""
        return self._chunk.capture_s if self._chunk else 0.0

    @property
    def graph_keys(self) -> list:
        """(frames, n_eff, active_surfel_budget) of each capture."""
        return list(self._chunk.keys) if self._chunk else []

    def trace_counters(self) -> dict:
        """The counters the tracer reports (utils/timing.py), read where
        they live: the dispatch policy's (DispatchPolicy.counters), this
        pipeline's, and the process's blending, preprocessing,
        association, integration and tile-selection kernel launches and
        kernel builds."""
        return {**self.policy.counters(),
                "graph_captures": self.graph_captures,
                "graph_replays": self.graph_replays,
                "bucket_picks": len(self.bucket_pick_log),
                "snapshots": self.snapshot_count,
                "snapshot_rows_shipped": self.snapshot_rows_shipped,
                "blend_launches": blend.blend_core.launches,
                "preprocess_launches": sum(pp.launches().values()),
                "association_launches": sum(association.launches().values()),
                "integration_launches":
                    integration.integrate_measurements.launches,
                "tiling_launches": tiling.tile_flags.launches,
                "kernel_builds": cuda_build.builds}

    def _log_device_memory(self) -> None:
        """Device memory report at init (cudaMemGetInfo, main.cc:859-869)."""
        if self.device.type != "cuda":
            return
        free, total = torch.cuda.mem_get_info(self.device)
        logging.getLogger("surfelmeshing_tpu_torch").info(
            "device memory: %.1f MiB in use / %.1f MiB limit",
            (total - free) / 2**20, total / 2**20)

    # -- frame window management -------------------------------------------

    def _upload_depth(self, video: RGBDVideo, frame_index: int) -> None:
        if frame_index in self._depth_buffers or \
           frame_index >= video.frame_count:
            return
        traced = tracer.on
        if traced:
            tracer.begin("input.depth", frame_index)
        depth = np.asarray(video.depth_frames[frame_index].get_image())
        d = self._upload(torch.from_numpy(depth.astype(np.int32)),
                         frame_index)
        for _ in range(self.config.median_filter_and_densify_iterations):
            d = pp.median_filter_and_densify(d)
        self._depth_buffers[frame_index] = d
        if traced:
            tracer.end()

    def _retire_depth(self, frame_index: int) -> None:
        """Frame retirement (main.cc:1656-1667)."""
        self._depth_buffers.pop(frame_index, None)
        self._staged_inputs.pop(frame_index, None)

    # -- per-frame step -----------------------------------------------------

    def process_frame(self, video: RGBDVideo, frame_index: int,
                      taps: Optional[dict] = None) -> Optional[FrameResult]:
        """Preprocess and fuse one frame; None for frames lacking a full
        outlier window (main.cc:986-992).  `taps` is passed to
        integrate_frame_bucketed.  Traced as the span `frame`."""
        if not tracer.on:
            return self._process_frame(video, frame_index, taps)
        tracer.begin("frame", frame_index)
        try:
            tracer.poll()
            return self._process_frame(video, frame_index, taps)
        finally:
            tracer.end()

    def _process_frame(self, video: RGBDVideo, frame_index: int,
                       taps: Optional[dict]) -> Optional[FrameResult]:
        cfg = self.config
        half_window = cfg.outlier_filtering_frame_count // 2
        for idx in range(max(0, frame_index - half_window),
                         min(video.frame_count,
                             frame_index + half_window + 2)):
            self._upload_depth(video, idx)
        if frame_index < cfg.start_frame + half_window or \
           frame_index >= video.frame_count - half_window:
            return None

        if self._defer:
            if taps is not None:
                raise ValueError("taps need per-frame dispatch "
                                 "(frame_chunk 1)")
            self._pending.append(self._chunk_entry(video, frame_index))
        else:
            self._dispatch_frame(video, frame_index, taps)
        self._retire_depth(frame_index - half_window)
        video.color_frames[frame_index].clear_image()
        video.depth_frames[frame_index].clear_image()
        if len(self._pending) >= cfg.frame_chunk:
            self._flush()
        return FrameResult(frame_index=frame_index,
                           surfel_count=-1,  # fetched lazily: a host sync
                           merge_count=-1)

    def _dispatch_frame(self, video: RGBDVideo, frame_index: int,
                        taps: Optional[dict]) -> None:
        """Per-frame dispatch: the frame step's preprocessing launched,
        the pick, then the fusion launch."""
        cfg = self.config
        traced = tracer.on
        staged = cfg.log_timings and cfg.log_timings_staged
        pack, color = self._staged_inputs.get(frame_index) or \
            self._stage_inputs(video, frame_index)
        t0 = time.perf_counter()
        if traced:
            tracer.begin("preprocess", frame_index, t0)
        passes = stages = on_stage = None
        if traced or staged:
            passes, stages = StageTimer(self.device), StageTimer(self.device)
        if cfg.debug_depth_preprocessing or passes is not None:
            on_stage = functools.partial(self._on_pass, frame_index, passes)
        ref, *others = self._window(frame_index)
        *pre, _ = self._step.preprocess(ref, others, pack, passes, on_stage)
        t1 = time.perf_counter()
        if traced:
            tracer.end(t1)
        params, n_eff = self.policy.pick(self._state, frames=1)
        if traced:
            tracer.begin("fusion", frame_index)
        self._state = self._step.fuse(self._state, pre, color, frame_index,
                                      params, n_eff, taps, stages)
        self.policy.queue_readback(self._state, frames=1)
        t2 = time.perf_counter()
        if traced:
            tracer.end(t2)
            tracer.device(passes, "dev.preprocess.", frame_index)
            tracer.device(stages, "dev.fusion.", frame_index)
        self.timing.add_time("preprocessing", t1 - t0)
        self.timing.add_time("integration", t2 - t1)
        self._last_stage_ms = {"preprocessing": 1000.0 * (t1 - t0),
                               "integration": 1000.0 * (t2 - t1)}
        if staged:
            # Device times, read by log_frame_timings once the device has
            # run the frame.
            self._staged_timers = (passes, stages)
            self._last_stage_ms.update(dict.fromkeys(COLUMNS, 0.0))

    def _on_pass(self, frame_index: int, passes: Optional[StageTimer],
                 name: str, depth: torch.Tensor) -> None:
        """preprocess_frame's on_stage: the pass's end in the StageTimer,
        and with debug_depth_preprocessing its PNG."""
        if passes is not None:
            passes(_NEXT_PASS[name])
        if self.config.debug_depth_preprocessing:
            self._dump_depth(frame_index, name, depth)

    # -- chunked dispatch (JAX pipeline.py:214-227,376-451) -----------------

    def _chunk_entry(self, video: RGBDVideo, frame_index: int) -> ChunkEntry:
        """A deferred frame's inputs: its depth window's device tensors and
        its color and pose pack, taken from the prefetched ones when
        staged (consumed here), else made on the host."""
        traced = tracer.on
        if traced:
            tracer.begin("input.stage", frame_index)
        depths = self._window(frame_index)
        staged = self._staged_inputs.pop(frame_index, None)
        if staged is not None:
            pose, color = staged
        else:
            pose = self._frame_pose_pack(video, frame_index)
            color = self._frame_color(video, frame_index)
        if traced:
            tracer.end()
        return ChunkEntry(depths, color, pose, frame_index)

    def _flush(self) -> None:
        """Run every deferred frame, as power-of-2 sub-chunks (largest
        first), one bucket pick, one ChunkStep run and one count readback
        each (the JAX pipeline's _flush).  The chunk's host time is
        "integration", amortized per frame for the timings line."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        c = len(pending)
        traced = tracer.on
        t0 = time.perf_counter()
        if traced:
            tracer.begin("flush", pending[-1].index, t0)
        while pending:
            size = 1 << (len(pending).bit_length() - 1)
            entries, pending = pending[:size], pending[size:]
            params, n_eff = self.policy.pick(self._state, frames=size)
            self._chunk.run(self._state, entries, params, n_eff)
            self.policy.queue_readback(self._state, frames=size)
        t1 = time.perf_counter()
        if traced:
            tracer.end(t1)
        self.timing.add_time("integration", t1 - t0)
        self._last_stage_ms = {"integration": 1000.0 * (t1 - t0) / c}

    # -- dispatch policy (dispatch.py) ---------------------------------------

    def shape_bucket_for(self, count_bound: int) -> int:
        """The bucket for a count bound; the policy picks through it."""
        return self.policy.shape_bucket_for(count_bound)

    def active_budget(self) -> int:
        """The active-set budget of the last processed frame."""
        return self.policy.budget

    def _window_offsets(self):
        """Frame offsets of the outlier-filtering window, in order."""
        half_window = self.config.outlier_filtering_frame_count // 2
        return list(range(-half_window, 0)) + list(range(1, half_window + 1))

    def _window(self, frame_index: int) -> list:
        """The frame's depth window: [reference, K others] device
        tensors."""
        return [self._depth_buffers[frame_index + o]
                for o in [0] + self._window_offsets()]

    def _frame_pose_pack(self, video: RGBDVideo,
                         frame_index: int) -> np.ndarray:
        """The frame's pose pack (chunk.pose_pack): the (K,3,4)
        other_T_reference of its outlier-filtering window in depth-unit
        space, pose translations scaled by depth_scaling
        (main.cc:1038-1058), its (global_T_local, local_T_global) 3x4 and
        its index."""
        scale = self.config.depth_scaling
        pose = video.depth_frames[frame_index].global_T_frame
        ref_inv = pose.scaled_translation(scale).inverse()
        transforms = [
            (ref_inv * video.depth_frames[frame_index + offset]
             .global_T_frame.scaled_translation(scale)).inverse().matrix3x4()
            for offset in self._window_offsets()]
        return pose_pack(np.stack(transforms), pose.matrix3x4(),
                         pose.inverse().matrix3x4(), frame_index)

    def _stage_inputs(self, video: RGBDVideo, frame_index: int) -> tuple:
        """The frame's inputs besides depth, on the device: (pose pack,
        (3,H,W) u8 color)."""
        traced = tracer.on
        if traced:
            tracer.begin("input.stage", frame_index)
        color = self._upload(torch.from_numpy(
            self._frame_color(video, frame_index)), frame_index)
        pack = self._upload(torch.from_numpy(np.ascontiguousarray(
            self._frame_pose_pack(video, frame_index), np.float32)),
            frame_index)
        if traced:
            tracer.end()
        return pack, color

    def _upload(self, host: torch.Tensor, frame_index: int) -> torch.Tensor:
        """A host tensor on the device by a blocking copy, which waits for
        the work queued before it.  Traced, the copy is enqueued without
        blocking and the wait that the blocking copy makes follows it as
        the span wait.upload."""
        if not tracer.on:
            return host.to(self.device)
        tracer.h2d(host)
        out = host.to(self.device, non_blocking=True)
        tracer.wait("upload", frame_index, stream_sync(self.device))
        return out

    def _frame_color(self, video: RGBDVideo, frame_index: int) -> np.ndarray:
        """This frame's color image as plane-major (3, H, W) u8,
        pyramid-downscaled by 2x2 box averaging (ImagePyramid analog,
        main.cc:977-980)."""
        color = np.asarray(video.color_frames[frame_index].get_image())
        if color.ndim == 2:
            color = np.stack([color] * 3, axis=-1)
        color = color[..., :3].astype(np.uint8)
        for _ in range(self.config.pyramid_level):
            h2, w2 = color.shape[0] // 2 * 2, color.shape[1] // 2 * 2
            c = color[:h2, :w2].astype(np.uint16)
            color = ((c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] +
                      c[1::2, 1::2] + 2) // 4).astype(np.uint8)
        return np.ascontiguousarray(color.transpose(2, 0, 1))

    def _dump_depth(self, frame_index: int, stage: str,
                    depth: torch.Tensor) -> None:
        """--debug_depth_preprocessing: one pass's depth as an 8-bit PNG
        scaled to max_depth (the JAX pipeline's _dump_preprocessing_stages;
        the reference shows the passes in windows, main.cc:1028-1176)."""
        from PIL import Image

        cfg = self.config
        os.makedirs("debug_preprocessing", exist_ok=True)
        arr = depth.cpu().numpy().astype(np.float32)
        vmax = cfg.depth_scaling * cfg.max_depth
        vis = np.clip(255.0 * arr / max(vmax, 1.0), 0, 255).astype(np.uint8)
        Image.fromarray(vis).save(
            f"debug_preprocessing/frame{frame_index:06d}_{stage}.png")

    # -- outputs (each reads the device: a host synchronisation) ------------

    def surfel_count(self) -> int:
        return int(self.state.surfel_count)

    def block_until_ready(self) -> None:
        """Run the deferred frames and wait until the device has finished
        every queued frame."""
        self._flush()
        if tracer.on:
            tracer.wait("drain", block=self._synchronize)
        else:
            self._synchronize()

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- benchmark/driver support (JAX pipeline.py:454-532) -----------------

    def prefetch_inputs(self, video: RGBDVideo, start: int, stop: int
                        ) -> None:
        """Stage every input of frames [start, stop) on the device ahead of
        the frame loop, the reference's untimed prefetch
        (main.cc:891-898, 902-984): the depth window, and for each fusable
        frame its color and pose pack.  Processing a staged frame
        then copies nothing from the host; frame retirement frees what
        was staged."""
        cfg = self.config
        half_window = cfg.outlier_filtering_frame_count // 2
        for i in range(max(0, start - half_window),
                       min(video.frame_count, stop + half_window + 1)):
            self._upload_depth(video, i)
        for i in range(max(start, cfg.start_frame + half_window),
                       min(stop, video.frame_count - half_window)):
            if i not in self._staged_inputs:
                self._staged_inputs[i] = self._stage_inputs(video, i)

    def drain(self) -> None:
        """Run the deferred frames, consume every outstanding count
        readback and wait for the device: a dispatch barrier for
        benchmarks and teardown."""
        traced = tracer.on
        if traced:
            tracer.begin("drain")
        self._flush()
        self.policy.drain(0)
        self.block_until_ready()
        if traced:
            tracer.end()

    def snapshot_dispatch_state(self) -> tuple:
        """A copy of the surfel map and of the bookkeeping that decides the
        next frames' dispatch (DispatchPolicy.snapshot; the
        delta-snapshot frame and rows shipped), for restore_dispatch_state:
        a benchmark re-runs its timed region from it.  The copy survives
        the bucketed frames that write the map in place."""
        self.drain()
        return (clone_state(self.state), self.policy.snapshot(),
                self._last_snap_frame, self.snapshot_rows_shipped)

    def restore_dispatch_state(self, snap: tuple) -> None:
        """Restore a snapshot_dispatch_state copy.  The map is copied
        again (into the map's own tensors while chunk graphs write them),
        so one snapshot can be restored more than once."""
        self.drain()
        state, marks, self._last_snap_frame, self.snapshot_rows_shipped = snap
        self._adopt(state, copy=True)
        self.policy.restore(marks)

    def _record_transfer(self, t0: float) -> float:
        """Time the reference's surfel_transfer stage from host time t0:
        -> the host time at its end."""
        t1 = time.perf_counter()
        self.timing.add_time("surfel_transfer", t1 - t0)
        self._last_stage_ms["surfel_transfer"] = 1000.0 * (t1 - t0)
        return t1

    def snapshot(self):
        """SoA snapshot of the live rows for the meshing engine
        (TransferAllToCPU analog, cuda_surfel_reconstruction.cc:339-359;
        timed as the reference's surfel_transfer stage, main.cc:1255-1266):
        (smooth (n,3), radius_sq (n,), normal (n,3), stamps (n,), n), copies
        that the next frame's in-place write leaves as they are."""
        t0 = time.perf_counter()
        out = self._snapshot_full(-1)
        self._record_transfer(t0)
        return out

    def _snapshot_full(self, frame_index: int) -> tuple:
        """snapshot()'s arrays, traced as snapshot.select (the selection's
        launches, then wait.snapshot where the size read would wait for
        the queued frames and the selection) and snapshot.copy (the copies
        to the host)."""
        state = self.state
        traced = tracer.on
        if traced:
            tracer.begin("snapshot.select", frame_index)
        smooth, radius_sq, normal, stamps, count = meshing_snapshot(state)
        if traced:
            tracer.wait("snapshot", frame_index, stream_sync(self.device))
        count = int(count)
        if traced:
            tracer.end()
            tracer.begin("snapshot.copy", frame_index)
        out = tuple(a[:count].to("cpu", copy=True).numpy()
                    for a in (smooth, radius_sq, normal, stamps))
        if traced:
            tracer.d2h(sum(a.nbytes for a in out))
            tracer.end()
        return out + (count,)

    def snapshot_for_meshing(self, frame_index: int):
        """Tagged snapshot for MeshingDriver.submit_snapshot: the full SoA
        snapshot the first time (and always when delta transfer is off),
        afterwards only the rows changed since the last snapshot
        (fusion.meshing_snapshot_delta; the reference re-downloads
        everything each transfer, cuda_surfel_reconstruction.cc:339-359).
        Blocks until the device has fused every queued frame.  Traced as
        the span `snapshot`, over the stretch timed as surfel_transfer; a
        delta's snapshot.select waits twice: before the changed rows'
        count is read and before the copies, for the rows' gathers."""
        traced = tracer.on
        t0 = time.perf_counter()
        if traced:
            tracer.begin("snapshot", frame_index, t0)
        if not self.config.delta_surfel_transfer or \
                self._last_snap_frame is None:
            out = ("full",) + self._snapshot_full(frame_index)
            rows = out[5]
        else:
            state = self.state
            def wait():
                tracer.wait("snapshot", frame_index, stream_sync(self.device))

            if traced:
                tracer.begin("snapshot.select", frame_index)
            idx, pos, rad, nrm, stamps, rows, count = meshing_snapshot_delta(
                state, self._last_snap_frame,
                self.config.regularization_frame_window_size,
                before_size_read=wait if traced else None)
            if traced:
                wait()
                tracer.end()
                tracer.begin("snapshot.copy", frame_index)
            arrays = tuple(a.cpu().numpy() for a in (idx, pos, rad, nrm,
                                                      stamps))
            out = ("delta",) + arrays + (int(count),)
            if traced:
                tracer.d2h(sum(a.nbytes for a in arrays))
                tracer.end()
        t1 = self._record_transfer(t0)
        if traced:
            tracer.end(t1)
        self._last_snap_frame = frame_index
        self.snapshot_rows_shipped += rows
        self.snapshot_count += 1
        return out

    def export_vertices(self):
        """Live rows of export_vertices: smoothed positions (NaN for merged
        surfels) and u8 colors, as numpy arrays."""
        count = self.surfel_count()
        pos, col = export_vertices(self.state)
        return pos[:count].cpu().numpy(), col[:count].cpu().numpy()

    def export_point_cloud(self, path: str) -> int:
        """Save the surfel cloud as PLY (SavePointCloudAsPLY,
        main.cc:179-203); merged surfels (radius < 0) are skipped.  Returns
        the number of points written."""
        positions, colors = self.export_vertices()
        nrm = normals(self.state)[:len(positions)].cpu().numpy()
        alive = ~np.isnan(positions[:, 0])
        write_ply(path, positions[alive], colors[alive], nrm[alive])
        return int(alive.sum())

    def log_frame_timings(self, frame_index: int) -> None:
        """Append one reference-format per-frame timings line
        (main.cc:1531-1545); the values are host times, with
        log_timings_staged device times of the preprocessing passes and
        fusion phases (module docstring).  The count is read first: it
        runs the deferred frames, whose flush sets the stage times the
        line reports, and waits for the device, which has then passed the
        staged timers' marks."""
        count = self.surfel_count()
        if self._staged_timers is not None:
            passes, stages = self._staged_timers
            self._staged_timers = None
            self._last_stage_ms.update(
                stages.stage_ms(),
                preprocessing=sum(passes.stage_ms().values()))
        self.timings_log_lines.append(format_frame_timings_line(
            frame_index, self._last_stage_ms, count))
