"""Application driver of the port: the reference main loop
(applications/surfel_meshing/src/surfel_meshing/main.cc:255-1760) on one
explicit torch device.

Usage:
    python -m surfelmeshing_tpu_torch.app.main <dataset_folder_path> \
        <trajectory_filename> [--device cuda|cpu] [flags...]

Counterpart of surfelmeshing_tpu/app/main.py with the same flags
(config.py): dataset playback with pose interpolation, depth
preprocessing and surfel fusion on the device, asynchronous (or
synchronous) meshing fed by delta snapshots, the FPS cap, keyframe
recording and playback, checkpoints, terminal controls, OBJ / PLY export,
frame-by-frame video and the live browser viewer.  The device is never
chosen silently: `--device` defaults to cuda and fails without a GPU.

--create_video renders every fused frame on the pipeline's device with the
port's renderer (viewer/renderer.py) and saves frameNNNNNN.png in the
working directory; only the finished image leaves the device (and the
mesher's triangles go to it).  --show_input_images (the default) saves the
input color and depth frames beside them under input_images/.
--live_viewer PORT serves the browser viewer (viewer/live.py) during the
run; the server is closed when run() returns.

--profile_dir writes a torch.profiler trace of the frame loop (CPU and,
on a CUDA device, CUDA activities) as DIR/trace.json, the counterpart of
the JAX application's jax.profiler trace.

--frame_chunk K defers frames and runs them K at a time (pipeline.py):
on the card each power-of-2 sub-chunk is one CUDA-graph replay.  Every
snapshot, stats line, timings line and export reads the map and so
flushes the frames deferred before it; the outputs equal K=1's byte for
byte.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import os
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..config import SurfelMeshingConfig, config_from_args
from ..io.checkpoint import load_checkpoint, save_checkpoint
from ..io.tum import read_tum_rgbd_dataset
from ..meshing import MeshingDriver
from ..ops import fusion as F
from ..ops.fusion import INVALID_INDEX, regularize_only
from ..ops.preprocess import sqrt_f32
from ..pipeline import ReconstructionPipeline
from ..utils.se3 import SE3
from ..utils.spline import KeyframePath, read_keyframes, write_keyframes
from ..viewer.live import LiveViewerServer
from ..viewer.renderer import Renderer, save_png, surfel_colors

logger = logging.getLogger("surfelmeshing_tpu_torch")

STATS_INTERVAL = 200
LIVE_PUSH_INTERVAL = 5          # fused frames between live-viewer pushes


def _invert_quaternions(video) -> None:
    """Reference quirk preserved (main.cc:632-642): color frames get the
    conjugated quaternion; depth frames additionally get the whole pose
    inverted."""
    for frame in video.color_frames:
        q = frame.global_T_frame.q.copy()
        frame.global_T_frame = SE3([-q[0], -q[1], -q[2], q[3]],
                                   frame.global_T_frame.t)
    for frame in video.depth_frames:
        q = frame.global_T_frame.q.copy()
        inverted = SE3([-q[0], -q[1], -q[2], q[3]], frame.global_T_frame.t)
        frame.global_T_frame = inverted.inverse()


def _up_direction(cfg, video):
    """Up-direction heuristic (main.cc:644-659)."""
    if cfg.trajectory_filename == "groundtruth.txt":
        return np.array([0.0, 0.0, 1.0])
    gt_path = os.path.join(cfg.dataset_folder_path, "groundtruth.txt")
    if os.path.exists(gt_path):
        try:
            gt_video = read_tum_rgbd_dataset(cfg.dataset_folder_path,
                                             "groundtruth.txt")
            r_traj = video.depth_frames[0].frame_T_global.rotation_matrix
            r_gt = gt_video.depth_frames[0].frame_T_global.rotation_matrix
            return r_traj.T @ r_gt @ np.array([0.0, 0.0, 1.0])
        except Exception:  # noqa: BLE001 - heuristic only
            pass
    return video.depth_frames[0].frame_T_global.rotation_matrix.T @ \
        np.array([0.0, 1.0, 0.0])


def build_debug_line_sets(cfg, state: F.SurfelState, count: int):
    """Debug line passes (surfel_meshing_render_window.cc:382-430) on the
    state's device: red surfel->neighbor segments, blue radius-length
    normal segments.  Shared by the video writer and the live viewer;
    -> [((L, 2, 3) f32 tensor, (r, g, b)), ...]."""
    line_sets = []
    if not (cfg.debug_neighbor_rendering or cfg.debug_normal_rendering):
        return line_sets
    smooth = F.smooth_positions(state)[:count]
    if cfg.debug_neighbor_rendering:
        nbrs = state.neighbors[:, :count].T
        src, slot = torch.nonzero(nbrs != INVALID_INDEX, as_tuple=True)
        tgt = nbrs[src, slot]
        ok = tgt < count
        segs = torch.stack([smooth[src[ok]], smooth[tgt[ok].long()]], dim=1)
        line_sets.append((segs, (255, 0, 0)))
    if cfg.debug_normal_rendering:
        radii = sqrt_f32(torch.clamp_min(F.radii_sq(state)[:count], 0.0))
        tips = smooth + radii[:, None] * F.normals(state)[:count]
        segs = torch.stack([smooth, tips], dim=1)
        segs = segs[torch.isfinite(segs).all(dim=2).all(dim=1)]
        line_sets.append((segs, (0, 0, 255)))
    return line_sets


def _color_mode(cfg) -> str:
    """The --visualize_* debug color mode (kernels.cu:274-351)."""
    if cfg.visualize_last_update_timestamp:
        return "timestamp"
    if cfg.visualize_creation_timestamp:
        return "creation"
    if cfg.visualize_radii:
        return "radius"
    if cfg.visualize_surfel_normals:
        return "normals"
    return "color"


class VideoWriter:
    """Frame-by-frame screenshot video (--create_video, main.cc:1436-1440),
    rendered on the pipeline's device."""

    def __init__(self, cfg, device):
        self.cfg = cfg
        self.renderer = Renderer(cfg.render_window_default_width,
                                 cfg.render_window_default_height,
                                 device=device)
        self.count = 0

    def render_frame(self, pipe, mesher, view_pose, input_pose,
                     frame_index=0) -> torch.Tensor:
        """Render the pipeline's state and the mesher's latest triangles,
        save frameNNNNNN.png; -> the (H, W, 3) u8 image on the device."""
        state = pipe.state
        count = pipe.surfel_count()
        positions, colors = F.export_vertices(state)
        positions, colors = positions[:count], colors[:count]
        mode = _color_mode(self.cfg)
        if mode != "color":
            colors = surfel_colors(
                mode, colors, F.update_stamps(state)[:count],
                F.creation_stamps(state)[:count], F.radii_sq(state)[:count],
                F.normals(state)[:count], frame_index,
                active_window=min(
                    self.cfg.surfel_integration_active_window_size, 3000))
        tris = None
        mesh_surfels = 0
        if mesher is not None:
            out = mesher.peek_output()
            if out is not None:
                _, mesh_surfels, tris = out
        splats = splat_colors = None
        if self.cfg.render_new_surfels_as_splats:
            splats = positions[mesh_surfels:]
            splat_colors = colors[mesh_surfels:]
        img = self.renderer.render(
            view_pose,
            splat_points=splats,
            splat_colors=splat_colors,
            splat_half_extent=self.cfg.splat_half_extent_in_pixels,
            mesh_vertices=positions,
            mesh_colors=colors,
            mesh_triangles=torch.from_numpy(tris.astype(np.int64)).to(
                positions.device) if tris is not None and len(tris)
            else None,
            triangle_normal_shading=self.cfg.triangle_normal_shading,
            frustum_pose=input_pose if self.cfg.render_camera_frustum
            else None,
            frustum_camera=pipe.camera if self.cfg.render_camera_frustum
            else None,
            line_sets=build_debug_line_sets(self.cfg, state, count) or None)
        save_png(f"frame{self.count:06d}.png", img.cpu().numpy())
        self.count += 1
        return img


def _dump_input_images(cfg, video, frame_index: int) -> None:
    """Save the current input color/depth frame as PNGs (headless analog of
    the reference's input-image windows, main.cc:744-747,1004-1008)."""
    from PIL import Image as PILImage

    os.makedirs("input_images", exist_ok=True)
    color = np.asarray(video.color_frames[frame_index].get_image())
    if color.ndim == 2:
        color = np.stack([color] * 3, axis=-1)
    PILImage.fromarray(color[..., :3].astype(np.uint8)).save(
        f"input_images/frame{frame_index:06d}_color.png")
    depth = np.asarray(video.depth_frames[frame_index].get_image())
    vmax = max(cfg.depth_scaling * cfg.max_depth, 1.0)
    vis = np.clip(255.0 * depth.astype(np.float32) / vmax, 0,
                  255).astype(np.uint8)
    PILImage.fromarray(vis).save(
        f"input_images/frame{frame_index:06d}_depth.png")


def debug_triangulate_surfel(mesher, key: str, surfel_index: int,
                             live_viewer=None) -> bool:
    """The y/e per-surfel debug-triangulation keys (main.cc:1609-1627):
    y = force re-triangulation of the surfel; e = reset every triangle
    within its radius first, then re-triangulate.  Logs the surfel's
    meshing state and, when a live viewer is attached, shows its
    neighborhood there as debug lines (the headless analog of the
    reference's step-by-step debug rendering); False when the index is
    invalid."""
    if mesher is None:
        logger.warning("no meshing engine")
        return False
    mesher.drain()
    eng = mesher.engine
    info = eng.surfel_info(surfel_index)
    if info is None:
        logger.warning("surfel %d out of range (engine has %d)",
                       surfel_index, eng.surfel_count)
        return False
    if key == "e":
        logger.info("Retriangulating surfel %d (radius_squared: %g) ...",
                    surfel_index, info["radius_sq"])
        eng.remesh_triangles_at(surfel_index)
    else:
        logger.info("Trying to triangulate surfel %d ...", surfel_index)
        eng.queue_for_remesh(surfel_index)
    eng.triangulate()
    after = eng.surfel_info(surfel_index)
    _, nbrs = eng.find_neighbors(
        info["position"], 4.0 * info["radius_sq"], max_count=64,
        include_completed=True, include_free=True)
    logger.info(
        "surfel %d: state %d -> %d, triangles %d -> %d, fronts %d -> %d, "
        "%d neighbors in 2r, self-check %d", surfel_index, info["state"],
        after["state"], info["triangles"], after["triangles"],
        info["fronts"], after["fronts"], len(nbrs),
        eng.check_surfel_state(surfel_index))
    if live_viewer is not None and len(nbrs):
        segs = np.empty((len(nbrs), 2, 3), np.float32)
        for j, nb in enumerate(nbrs):
            nb_info = eng.surfel_info(int(nb))
            segs[j, 0] = info["position"]
            segs[j, 1] = nb_info["position"] if nb_info is not None \
                else info["position"]
        live_viewer.update_debug_lines([(segs, (255, 255, 0))])
    return True


def _set_regularizer_weight(cfg, pipe, weight: float) -> None:
    cfg.regularizer_weight = weight
    pipe.fusion_params = dataclasses.replace(pipe.fusion_params,
                                             regularizer_weight=weight)
    logger.info("regularizer_weight: %f", weight)


def _terminal_controls(cfg, pipe, mesher, frame_index, input_pose,
                       recorded_keyframes, live_viewer=None) -> str:
    """Terminal key controls (main.cc:1548-1653; reference README
    "Terminal controls"): Return = next frame, q = quit, r = run,
    a/s = regularizer weight x1.1 / /1.1, d = one regularization iteration,
    t = full retriangulation, p = save mesh now, k = record keyframe,
    'y N' / 'e N' = per-surfel debug triangulation of surfel N."""
    while True:
        try:
            cmd = input(
                "[Return=step, q, r, a, s, d, t, p, k, y N, e N] > ").strip()
        except EOFError:
            return "quit"
        if cmd == "":
            return "step"
        key = cmd[0].lower()
        if key == "q":
            return "quit"
        if key == "r":
            return "run"
        if key in ("y", "e"):
            parts = cmd.split()
            try:
                sel = int(parts[1])
            except (IndexError, ValueError):
                logger.warning("usage: %s <surfel_index>", key)
                continue
            debug_triangulate_surfel(mesher, key, sel, live_viewer)
        elif key == "a":
            _set_regularizer_weight(cfg, pipe, cfg.regularizer_weight * 1.1)
        elif key == "s":
            _set_regularizer_weight(cfg, pipe, cfg.regularizer_weight / 1.1)
        elif key == "d":
            logger.info("Regularization iteration ...")
            pipe.state = regularize_only(pipe.state, frame_index,
                                         pipe.fusion_params)
        elif key == "t" and mesher is not None:
            mesher.drain()
            mesher.engine.full_retriangulation()
            logger.info("full retriangulation: %d triangles",
                        mesher.engine.triangle_count)
        elif key == "p":
            if cfg.export_mesh and mesher is not None:
                mesher.drain()
                mesher.export_obj(cfg.export_mesh, pipe)
                logger.info("Wrote %s", cfg.export_mesh)
            elif cfg.export_point_cloud:
                pipe.export_point_cloud(cfg.export_point_cloud)
                logger.info("Wrote %s", cfg.export_point_cloud)
            else:
                logger.warning("no --export_mesh/--export_point_cloud path")
        elif key == "k":
            recorded_keyframes.append((frame_index, input_pose))
            logger.info("recorded keyframe at frame %d", frame_index)


def _submit_snapshot(cfg, pipe, mesher, frame_index, last_index) -> None:
    """Meshing pacing: asynchronous meshing takes a snapshot only when the
    mesher is idle or about to finish, or at the last frame
    (main.cc:1235-1254); synchronous meshing meshes inline every frame
    (main.cc:1343-1389)."""
    if cfg.asynchronous_triangulation:
        if mesher.idle() or frame_index == last_index:
            mesher.submit_snapshot(pipe.snapshot_for_meshing(frame_index),
                                   frame_index)
        return
    mesher.submit_snapshot(pipe.snapshot_for_meshing(frame_index),
                           frame_index)
    mesher.drain()
    if cfg.full_meshing_every_frame:
        mesher.engine.full_retriangulation()


def _write_outputs(cfg, pipe, mesher, last_frame, recorded_keyframes):
    """Keyframes, checkpoint, timing logs, point cloud and mesh."""
    if cfg.record_keyframes and recorded_keyframes:
        write_keyframes(cfg.record_keyframes, recorded_keyframes)
        logger.info("Wrote %d keyframes to %s", len(recorded_keyframes),
                    cfg.record_keyframes)
    if cfg.save_checkpoint and last_frame is not None:
        save_checkpoint(cfg.save_checkpoint, pipe.state, last_frame)
        logger.info("Wrote checkpoint %s (frame %d)", cfg.save_checkpoint,
                    last_frame)
    if cfg.log_timings:
        with open(cfg.log_timings, "w") as f:
            f.write("\n".join(pipe.timings_log_lines) + "\n")
        # Meshing-thread timings go to their own file, like the reference
        # (asynchronous_meshing.cc:158-165 writes timings_cpu.txt).
        if mesher is not None and mesher.timings_log_lines:
            with open("timings_cpu.txt", "w") as f:
                f.write("\n".join(mesher.timings_log_lines) + "\n")
    if cfg.export_point_cloud:
        n = pipe.export_point_cloud(cfg.export_point_cloud)
        logger.info("Wrote %s (%d points)", cfg.export_point_cloud, n)
    if cfg.export_mesh:
        if mesher is not None:
            mesher.export_obj(cfg.export_mesh, pipe)
            logger.info("Wrote %s", cfg.export_mesh)
        else:
            logger.warning("--export_mesh requested but meshing engine "
                           "unavailable; skipping")


@contextlib.contextmanager
def _profiled(profile_dir, device):
    """--profile_dir: a torch.profiler trace of the enclosed frame loop,
    written to <profile_dir>/trace.json when the loop ends."""
    if not profile_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    logger.info("profiling to %s", profile_dir)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("wrote profiler trace %s", path)


class _LivePublisher:
    """The live viewer's side of the loop: pushes the state and the
    mesher's latest triangles when the mesh changed (main.cc's render
    window updates), and closes the server."""

    def __init__(self, cfg, pipe, mesher):
        self.cfg, self.pipe, self.mesher = cfg, pipe, mesher
        self.server = LiveViewerServer(port=cfg.live_viewer_port)
        self.last_mesh = (-1, -1)
        logger.info("live viewer: http://127.0.0.1:%d/", self.server.port)

    def _vertices(self):
        count = self.pipe.surfel_count()
        positions, colors = F.export_vertices(self.pipe.state)
        return (positions[:count].cpu().numpy(),
                colors[:count].cpu().numpy(), count)

    def push(self, input_pose=None) -> None:
        out = self.mesher.peek_output() if self.mesher is not None else None
        mesh_id = (out[0], len(out[2])) if out is not None else (-1, 0)
        if mesh_id == self.last_mesh:
            return
        self.last_mesh = mesh_id
        positions, colors, count = self._vertices()
        tris = out[2] if out is not None else np.zeros((0, 3), np.uint32)
        debug = self.cfg.debug_neighbor_rendering or \
            self.cfg.debug_normal_rendering
        self.server.update(
            positions, colors, tris, out[1] if out is not None else 0,
            pose=(input_pose.matrix3x4() if input_pose is not None
                  else None),
            debug_lines=[(segs.cpu().numpy(), color) for segs, color in
                         build_debug_line_sets(self.cfg, self.pipe.state,
                                               count)] if debug else None)

    def publish_final(self) -> None:
        """The final state (the mesher thread has exited)."""
        positions, colors, count = self._vertices()
        self.server.update(positions, colors,
                           self.mesher.engine.get_triangles(), count)

    def close(self) -> None:
        self.server.close()


def _view_pose(cfg, video, frame_index, playback_path, processed: int,
               frames: int):
    """The video's camera: keyframe playback along the spline (`processed`
    of `frames` frames played), the input camera, or the start frame's
    (main.cc --follow_input_camera)."""
    if playback_path is not None:
        return playback_path.sample(
            playback_path.max_parameter * processed / max(1, frames))
    if cfg.follow_input_camera:
        return video.depth_frames[frame_index].global_T_frame
    return video.depth_frames[cfg.start_frame].global_T_frame


def run(cfg: SurfelMeshingConfig, device) -> int:
    """The application loop on `device`; returns the exit code."""
    if not cfg.dataset_folder_path:
        print("error: dataset_folder_path is required", file=sys.stderr)
        return 1
    device = resolve_device(device)

    video = read_tum_rgbd_dataset(
        cfg.dataset_folder_path, cfg.trajectory_filename,
        cfg.max_pose_interpolation_time_extent)
    logger.info("Read dataset with %d frames", video.frame_count)
    if video.frame_count == 0:
        print("error: could not read dataset", file=sys.stderr)
        return 1
    if cfg.invert_quaternions:
        _invert_quaternions(video)

    pipe = ReconstructionPipeline(cfg, video.depth_camera, device)

    resume_frame = None
    if cfg.load_checkpoint:
        state, resume_frame = load_checkpoint(cfg.load_checkpoint, device)
        if state.pack.shape[0] != pipe.state.pack.shape[0]:
            print("error: checkpoint capacity "
                  f"{state.pack.shape[0]} != configured "
                  f"{pipe.state.pack.shape[0]}", file=sys.stderr)
            return 1
        pipe.state = state
        logger.info("resumed from %s at frame %d", cfg.load_checkpoint,
                    resume_frame)

    mesher = None
    try:
        mesher = MeshingDriver(cfg, log_timings=bool(cfg.log_timings))
    except (ImportError, OSError) as exc:
        logger.warning("meshing engine unavailable (%s); "
                       "running fusion only", exc)

    up = _up_direction(cfg, video)
    logger.info("up direction: %s", np.round(up, 3))
    playback_path = None
    if cfg.playback_keyframes:
        keyframes = read_keyframes(cfg.playback_keyframes)
        playback_path = KeyframePath([p for _, p in keyframes])
        logger.info("Keyframe playback with %d keyframes", len(keyframes))
    video_writer = VideoWriter(cfg, device) if cfg.create_video else None
    live = _LivePublisher(cfg, pipe, mesher) if cfg.live_viewer_port \
        else None
    try:
        return _run_loop(cfg, video, pipe, mesher, resume_frame,
                         playback_path, video_writer, live, device)
    finally:
        if live is not None:
            live.close()


def _run_loop(cfg, video, pipe, mesher, resume_frame, playback_path,
              video_writer, live, device) -> int:
    end_frame = min(cfg.end_frame, video.frame_count)
    half_window = cfg.outlier_filtering_frame_count // 2
    recorded_keyframes = []
    frame_count_hits = 0
    frame_count_misses = 0
    target_dt = 1.0 / cfg.restrict_fps_to if cfg.restrict_fps_to > 0 else 0.0
    last_frame = None
    processed_frames = 0

    first_frame = cfg.start_frame
    if resume_frame is not None:
        first_frame = max(first_frame, resume_frame + 1)
    frame_range = range(first_frame, end_frame - half_window)
    last_index = end_frame - half_window - 1
    live_viewer = live.server if live is not None else None
    with _profiled(cfg.profile_dir, device):
        for frame_index in frame_range:
            frame_start = time.perf_counter()
            if cfg.show_input_images and video_writer is not None:
                # Input-image display analog (main.cc:744-747,1004-1008):
                # headless, the inputs are saved next to the video frames.
                _dump_input_images(cfg, video, frame_index)
            if pipe.process_frame(video, frame_index) is None:
                continue
            processed_frames += 1
            last_frame = frame_index
            if mesher is not None:
                _submit_snapshot(cfg, pipe, mesher, frame_index, last_index)

            input_pose = video.depth_frames[frame_index].global_T_frame
            if cfg.record_keyframes:
                recorded_keyframes.append((frame_index, input_pose))
            if video_writer is not None:
                view_pose = _view_pose(cfg, video, frame_index, playback_path,
                                       processed_frames, len(frame_range))
                video_writer.render_frame(pipe, mesher, view_pose, input_pose,
                                          frame_index)
            if live is not None:
                if processed_frames % LIVE_PUSH_INTERVAL == 0 or \
                        mesher is None:
                    live.push(input_pose)
                # y/e debug-triangulation requests from the browser
                # (main.cc:1609-1627 analog; selection is browser-side).
                for key, sel in live_viewer.poll_actions():
                    debug_triangulate_surfel(mesher, key, sel, live_viewer)
            if cfg.log_timings:
                pipe.log_frame_timings(frame_index)
            if frame_index % STATS_INTERVAL == 0:
                pipe.block_until_ready()
                tri = mesher.engine.triangle_count if mesher else 0
                if cfg.active_surfel_budget:
                    # Tiles skipped because the working set was full: their
                    # surfels went stale for the frame.
                    logger.info(
                        "frame %d: %d surfels, %d triangles, %d skipped tiles "
                        "(budget %d)", frame_index, pipe.surfel_count(), tri,
                        int(pipe.state.skipped_tile_count),
                        pipe.active_budget())
                else:
                    logger.info("frame %d: %d surfels, %d triangles",
                                frame_index, pipe.surfel_count(), tri)
                if cfg.abort_on_surfel_overflow and \
                        int(pipe.state.overflow_count) > 0:
                    # Reference parity: abort on exceeding max_surfel_count
                    # (README.md:105-107).
                    logger.error("max_surfel_count exceeded — aborting "
                                 "(--abort_on_surfel_overflow)")
                    return 1
            if cfg.step_by_step_playback:
                action = _terminal_controls(cfg, pipe, mesher, frame_index,
                                            input_pose, recorded_keyframes,
                                            live_viewer)
                if action == "quit":
                    break
                if action == "run":
                    cfg.step_by_step_playback = False
            # FPS cap (main.cc:1669-1692).
            if target_dt > 0:
                elapsed = time.perf_counter() - frame_start
                if elapsed < target_dt:
                    frame_count_hits += 1
                    time.sleep(target_dt - elapsed)
                else:
                    frame_count_misses += 1

        pipe.block_until_ready()
    overflow = int(pipe.state.overflow_count)
    if overflow > 0:
        # The reference aborts on exceeding --max_surfel_count
        # (README.md:105-107); by default the partial map is kept and the
        # overflow reported (--abort_on_surfel_overflow restores the abort).
        logger.error("max_surfel_count exceeded: %d surfel creations were "
                     "dropped — increase --max_surfel_count", overflow)
        if cfg.abort_on_surfel_overflow:
            return 1
    logger.info("done: %d surfels, fps target hit %d / missed %d",
                pipe.surfel_count(), frame_count_hits, frame_count_misses)
    if cfg.active_surfel_budget:
        skipped = int(pipe.state.skipped_tile_count)
        log = logger.warning if skipped else logger.info
        log("active-set tiling: %d tiles skipped over the run%s", skipped,
            " — stale surfels / duplicate creations possible; raise "
            "--active_surfel_budget" if skipped else "")
    if not cfg.active_surfel_budget:
        logger.info("shape buckets used: %s",
                    sorted({n for _, n in pipe.bucket_pick_log}))
    logger.info("%s", pipe.timing.report())

    # Post-processing terminal controls (main.cc:1550: show_result &&
    # is_last_frame); only when attached to an interactive terminal.
    if cfg.show_result and sys.stdin.isatty() and last_frame is not None:
        pose = video.depth_frames[last_frame].global_T_frame
        while _terminal_controls(cfg, pipe, mesher, last_frame, pose,
                                 recorded_keyframes) not in ("quit", "run"):
            pass

    if mesher is not None:
        # Final snapshot so the mesh covers the last fused state
        # (main.cc:1247-1254).
        if last_frame is not None:
            mesher.drain()
            mesher.submit_snapshot(pipe.snapshot_for_meshing(last_frame),
                                   last_frame)
        mesher.finish(full_retriangulation=cfg.full_retriangulation_at_end)
        logger.info("final mesh: %d triangles", mesher.engine.triangle_count)
        if live is not None:
            live.publish_final()

    _write_outputs(cfg, pipe, mesher, last_frame, recorded_keyframes)
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname).1s %(message)s")
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args, rest = parser.parse_known_args(argv)
    return run(config_from_args(rest), args.device)


if __name__ == "__main__":
    sys.exit(main())
