"""Pipeline configuration mirroring the reference CLI.

Every field name/default matches a flag declared in the reference driver
(applications/surfel_meshing/src/surfel_meshing/main.cc:276-608); the README
documents them (reference README.md:180-267).  One known doc/code mismatch is
preserved consciously: --observation_angle_threshold_deg defaults to 85 in code
(main.cc:425) although the reference README says 75.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Optional


_INT_MAX = 2**31 - 1


@dataclasses.dataclass
class SurfelMeshingConfig:
    # --- Dataset playback parameters (main.cc:278-315) ---
    depth_scaling: float = 5000.0          # TUM RGB-D: depth_png = 5000 * meters
    max_pose_interpolation_time_extent: float = 0.05
    start_frame: int = 0
    end_frame: int = _INT_MAX
    pyramid_level: int = 0
    restrict_fps_to: int = 30
    step_by_step_playback: bool = False
    invert_quaternions: bool = False

    # --- Surfel reconstruction parameters (main.cc:317-371) ---
    max_surfel_count: int = 20_000_000
    sensor_noise_factor: float = 0.05
    max_surfel_confidence: float = 5.0
    regularizer_weight: float = 10.0
    normal_compatibility_threshold_deg: float = 40.0
    regularization_frame_window_size: int = 30
    do_blending: bool = True               # inverse of --disable_blending
    measurement_blending_radius: int = 12
    regularization_iterations_per_integration_iteration: int = 1
    radius_factor_for_regularization_neighbors: float = 2.0
    surfel_integration_active_window_size: int = _INT_MAX

    # --- Meshing parameters (main.cc:373-412) ---
    max_angle_between_normals_deg: float = 90.0
    min_triangle_angle_deg: float = 10.0
    max_triangle_angle_deg: float = 170.0
    max_neighbor_search_range_increase_factor: float = 2.0
    long_edge_tolerance_factor: float = 1.5
    asynchronous_triangulation: bool = True  # inverse of --synchronous_meshing
    full_meshing_every_frame: bool = False
    full_retriangulation_at_end: bool = False

    # --- Depth preprocessing parameters (main.cc:414-478) ---
    max_depth: float = 3.0
    depth_valid_region_radius: float = 333.0
    observation_angle_threshold_deg: float = 85.0
    depth_erosion_radius: int = 2
    median_filter_and_densify_iterations: int = 0
    outlier_filtering_frame_count: int = 8
    outlier_filtering_required_inliers: int = -1
    bilateral_filter_sigma_xy: float = 3.0
    bilateral_filter_radius_factor: float = 2.0
    bilateral_filter_sigma_depth_factor: float = 0.05
    outlier_filtering_depth_tolerance_factor: float = 0.02
    point_radius_extension_factor: float = 1.5
    point_radius_clamp_factor: float = math.inf

    # --- Octree / neighbor-search parameters (main.cc:480-484) ---
    max_surfels_per_node: int = 50

    # --- File export parameters (main.cc:486-495) ---
    export_mesh: Optional[str] = None
    export_point_cloud: Optional[str] = None

    # --- Visualization parameters (main.cc:497-555) ---
    render_camera_frustum: bool = True     # inverse of --hide_camera_frustum
    render_new_surfels_as_splats: bool = True  # inverse of --hide_new_surfel_splats
    splat_half_extent_in_pixels: float = 3.0
    triangle_normal_shading: bool = False
    show_input_images: bool = True         # inverse of --hide_input_images
    render_window_default_width: int = 1280
    render_window_default_height: int = 720
    show_result: bool = True               # inverse of --exit_after_processing
    follow_input_camera: Optional[bool] = None
    record_keyframes: Optional[str] = None
    playback_keyframes: Optional[str] = None

    # --- Debug / evaluation parameters (main.cc:557-593) ---
    create_video: bool = False
    debug_depth_preprocessing: bool = False
    debug_neighbor_rendering: bool = False
    debug_normal_rendering: bool = False
    visualize_last_update_timestamp: bool = False
    visualize_creation_timestamp: bool = False
    visualize_radii: bool = False
    visualize_surfel_normals: bool = False
    log_timings: Optional[str] = None
    # With --log_timings: the reference's per-phase columns as device times,
    # from CUDA events bracketing each preprocessing pass and fusion phase
    # of the real step (fusion.StageTimer, the counterpart of the
    # reference's per-phase cudaEvents, cuda_surfel_reconstruction.cc:
    # 112-320), read once the timings line waits for the count.  Frames
    # are dispatched one at a time (no frame_chunk deferral).
    log_timings_staged: bool = False
    # A torch.profiler trace of the frame loop (trace.json), with each of
    # the tracer's spans a record_function range beside the kernels it
    # launched (the reference's cudaEvent stage timing, main.cc:765-796).
    profile_dir: Optional[str] = None
    # Count-sized fusion in the JAX package (its per-surfel passes over a
    # fixed-step surfel-count bucket).  Accepted for the JAX package's
    # command lines; this port runs every frame count-sized unless an
    # active-surfel budget is set, whatever its value (the reference's
    # count-sized launches, cuda_surfel_reconstruction.cc:131-140).
    use_shape_buckets: bool = False
    # Shape-bucket ladder step in surfel rows: a count-sized frame runs
    # over the smallest multiple of this step above the conservative count
    # bound.  Smaller steps track the live count tighter; a step of
    # max_surfel_count runs every frame over the whole capacity.
    shape_bucket_step: int = 65_536
    # Per-frame surfel creation budget (FusionParams.max_creations_per_frame):
    # creations beyond it are dropped and re-attempted next frame, keeping
    # the creation scatter small and the count bound tight.
    max_creations_per_frame: int = 2**15
    # Adaptive shape-bucket count bound (host-side dispatch policy, >0 = on):
    # instead of charging every unconfirmed frame the full creation budget,
    # charge it this safety factor times the largest recently CONFIRMED
    # per-frame surfel growth (floor 2048, cap max_creations_per_frame).
    # Tightens the bucket pick by ~1 ladder step once growth settles below
    # the budget.  If a growth burst outruns the bound, the excess creations
    # defer to the next frame (the same drop-and-retry semantics the static
    # budget already has) and the estimator catches up exponentially.
    # Deferred creations are not counted in state.overflow_count, which
    # counts only creations dropped at max_surfel_count (the JAX package
    # counts both).  0 = off (the bound is exact: creations can never defer
    # below capacity and bucketed results stay bit-exact vs full shapes).
    adaptive_creation_bound: float = 0.0
    # Maximum dispatches (frames or frame chunks) in flight before blocking
    # on the oldest count readback.  Bounds BOTH the host run-ahead and the
    # conservative count headroom (each unconfirmed frame adds one creation
    # budget to the bucket bound); 2 keeps the device busy across the
    # readback round-trip without inflating buckets.
    max_inflight_dispatches: int = 2
    # Reference-parity behavior switch: the reference ABORTS when
    # max_surfel_count is exceeded (README.md:105-107).  The TPU rebuild's
    # default is a documented deviation — keep the partial map, count the
    # dropped creations (state.overflow_count) and report loudly at exit —
    # because a fixed-capacity device map can degrade gracefully where the
    # reference's dynamic grids cannot.  Set this for the reference's
    # fail-fast behavior (checked at the stats interval and at exit).
    abort_on_surfel_overflow: bool = False
    # Ship only changed surfel rows (index + payload) to the meshing
    # engine instead of the full map each snapshot — the logical end of the
    # reference's partial row downloads (cuda_surfel_reconstruction.cc:
    # 348-358).  Identical meshing results (the engine diffs either way);
    # off = always full snapshots.
    delta_surfel_transfer: bool = True
    # Active-set tiling: per-frame fusion gathers a working set of at most
    # this many surfels (the tiles holding in-view / recently-updated /
    # frontier surfels) so cost tracks the visible set, not the capacity
    # (the reference gates on surfel_count grids + the active window,
    # kernels.cu:77-87).  0 = off.  Rounds max_surfel_count up to a tile
    # multiple.  TPU-specific flag with no reference equivalent.
    active_surfel_budget: int = 0
    # Chunked dispatch: frames are deferred and run K at a time (the JAX
    # package's one lax.scan launch over the per-frame step).  Every read
    # of the map flushes the deferred frames, in power-of-2 sub-chunks, so
    # the results equal per-frame dispatch bit for bit.  On the card a
    # sub-chunk is one CUDA-graph replay of its frames' steps (eager for
    # symmetric_regularization=False); on the CPU it runs the same step
    # eagerly.  log_timings_staged and debug_depth_preprocessing do not
    # defer.  1 = per-frame dispatch.  No reference equivalent.
    frame_chunk: int = 1

    # Live browser viewer (headless analog of the reference's interactive
    # Qt/OpenGL window, surfel_meshing_render_window.cc:195-430): serve an
    # orbit-navigation WebGL viewer with live mesh updates on this port.
    # 0 = off.
    live_viewer_port: int = 0

    # Reconstruction-state checkpointing (TPU extension; the reference has
    # none — SURVEY.md §5 "resume is re-run the dataset").
    save_checkpoint: Optional[str] = None   # written after processing
    load_checkpoint: Optional[str] = None   # resume before processing

    # --- Required input paths (main.cc:595-604) ---
    dataset_folder_path: Optional[str] = None
    trajectory_filename: Optional[str] = None

    def validate(self) -> None:
        if self.outlier_filtering_frame_count not in (2, 4, 6, 8):
            raise ValueError(
                "outlier_filtering_frame_count must be one of 2, 4, 6, 8 "
                f"(got {self.outlier_filtering_frame_count})")
        if not 0 <= self.depth_erosion_radius <= 3:
            raise ValueError("depth_erosion_radius must be in [0, 3]")
        if self.active_surfel_budget and self.use_shape_buckets:
            raise ValueError("active_surfel_budget and use_shape_buckets "
                             "are mutually exclusive")
        if self.active_surfel_budget < -1:
            raise ValueError("active_surfel_budget must be -1 (auto), 0 "
                             "(off), or a positive working-set size")
        if self.frame_chunk < 1:
            raise ValueError("frame_chunk must be >= 1")


def build_arg_parser() -> argparse.ArgumentParser:
    """CLI with the same flag names as the reference (main.cc:276-608)."""
    d = SurfelMeshingConfig()
    p = argparse.ArgumentParser(
        prog="surfelmeshing_tpu",
        description="TPU-native SurfelMeshing: surfel fusion + incremental "
                    "meshing of TUM RGB-D video.")

    # Dataset playback.
    p.add_argument("--depth_scaling", type=float, default=d.depth_scaling)
    p.add_argument("--max_pose_interpolation_time_extent", type=float,
                   default=d.max_pose_interpolation_time_extent)
    p.add_argument("--start_frame", type=int, default=d.start_frame)
    p.add_argument("--end_frame", type=int, default=d.end_frame)
    p.add_argument("--pyramid_level", type=int, default=d.pyramid_level)
    p.add_argument("--restrict_fps_to", type=int, default=d.restrict_fps_to)
    p.add_argument("--step_by_step_playback", action="store_true")
    p.add_argument("--invert_quaternions", action="store_true")

    # Surfel reconstruction.
    p.add_argument("--max_surfel_count", type=int, default=d.max_surfel_count)
    p.add_argument("--sensor_noise_factor", type=float, default=d.sensor_noise_factor)
    p.add_argument("--max_surfel_confidence", type=float, default=d.max_surfel_confidence)
    p.add_argument("--regularizer_weight", type=float, default=d.regularizer_weight)
    p.add_argument("--normal_compatibility_threshold_deg", type=float,
                   default=d.normal_compatibility_threshold_deg)
    p.add_argument("--regularization_frame_window_size", type=int,
                   default=d.regularization_frame_window_size)
    p.add_argument("--disable_blending", action="store_true")
    p.add_argument("--measurement_blending_radius", type=int,
                   default=d.measurement_blending_radius)
    p.add_argument("--regularization_iterations_per_integration_iteration",
                   type=int,
                   default=d.regularization_iterations_per_integration_iteration)
    p.add_argument("--radius_factor_for_regularization_neighbors", type=float,
                   default=d.radius_factor_for_regularization_neighbors)
    p.add_argument("--surfel_integration_active_window_size", type=int,
                   default=d.surfel_integration_active_window_size)

    # Meshing.
    p.add_argument("--max_angle_between_normals_deg", type=float,
                   default=d.max_angle_between_normals_deg)
    p.add_argument("--min_triangle_angle_deg", type=float,
                   default=d.min_triangle_angle_deg)
    p.add_argument("--max_triangle_angle_deg", type=float,
                   default=d.max_triangle_angle_deg)
    p.add_argument("--max_neighbor_search_range_increase_factor", type=float,
                   default=d.max_neighbor_search_range_increase_factor)
    p.add_argument("--long_edge_tolerance_factor", type=float,
                   default=d.long_edge_tolerance_factor)
    p.add_argument("--synchronous_meshing", action="store_true")
    p.add_argument("--full_meshing_every_frame", action="store_true")
    p.add_argument("--full_retriangulation_at_end", action="store_true")

    # Depth preprocessing.
    p.add_argument("--max_depth", type=float, default=d.max_depth)
    p.add_argument("--depth_valid_region_radius", type=float,
                   default=d.depth_valid_region_radius)
    p.add_argument("--observation_angle_threshold_deg", type=float,
                   default=d.observation_angle_threshold_deg)
    p.add_argument("--depth_erosion_radius", type=int, default=d.depth_erosion_radius)
    p.add_argument("--median_filter_and_densify_iterations", type=int,
                   default=d.median_filter_and_densify_iterations)
    p.add_argument("--outlier_filtering_frame_count", type=int,
                   default=d.outlier_filtering_frame_count)
    p.add_argument("--outlier_filtering_required_inliers", type=int,
                   default=d.outlier_filtering_required_inliers)
    p.add_argument("--bilateral_filter_sigma_xy", type=float,
                   default=d.bilateral_filter_sigma_xy)
    p.add_argument("--bilateral_filter_radius_factor", type=float,
                   default=d.bilateral_filter_radius_factor)
    p.add_argument("--bilateral_filter_sigma_depth_factor", type=float,
                   default=d.bilateral_filter_sigma_depth_factor)
    p.add_argument("--outlier_filtering_depth_tolerance_factor", type=float,
                   default=d.outlier_filtering_depth_tolerance_factor)
    p.add_argument("--point_radius_extension_factor", type=float,
                   default=d.point_radius_extension_factor)
    p.add_argument("--point_radius_clamp_factor", type=float,
                   default=d.point_radius_clamp_factor)

    # Octree.
    p.add_argument("--max_surfels_per_node", type=int, default=d.max_surfels_per_node)

    # File export.
    p.add_argument("--export_mesh", type=str, default=None)
    p.add_argument("--export_point_cloud", type=str, default=None)

    # Visualization.
    p.add_argument("--hide_camera_frustum", action="store_true")
    p.add_argument("--hide_new_surfel_splats", action="store_true")
    p.add_argument("--splat_half_extent_in_pixels", type=float,
                   default=d.splat_half_extent_in_pixels)
    p.add_argument("--triangle_normal_shading", action="store_true")
    p.add_argument("--hide_input_images", action="store_true")
    p.add_argument("--render_window_default_width", type=int,
                   default=d.render_window_default_width)
    p.add_argument("--render_window_default_height", type=int,
                   default=d.render_window_default_height)
    p.add_argument("--exit_after_processing", action="store_true")
    p.add_argument("--follow_input_camera", type=str, default="")
    p.add_argument("--record_keyframes", type=str, default=None)
    p.add_argument("--playback_keyframes", type=str, default=None)

    # Debug / evaluation.
    p.add_argument("--create_video", action="store_true")
    p.add_argument("--debug_depth_preprocessing", action="store_true")
    p.add_argument("--debug_neighbor_rendering", action="store_true")
    p.add_argument("--debug_normal_rendering", action="store_true")
    p.add_argument("--visualize_last_update_timestamp", action="store_true")
    p.add_argument("--visualize_creation_timestamp", action="store_true")
    p.add_argument("--visualize_radii", action="store_true")
    p.add_argument("--visualize_surfel_normals", action="store_true")
    p.add_argument("--log_timings", type=str, default=None)
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--log_timings_staged", action="store_true",
                   help="with --log_timings: per-phase device times from "
                        "CUDA events around each preprocessing pass and "
                        "fusion phase (frames are not deferred)")
    p.add_argument("--abort_on_surfel_overflow", action="store_true",
                   help="abort when max_surfel_count is exceeded (the "
                        "reference's behavior, README.md:105-107); default "
                        "keeps the partial map and reports dropped "
                        "creations at exit")
    p.add_argument("--no_delta_surfel_transfer", action="store_true",
                   help="always ship FULL surfel snapshots to the meshing "
                        "engine instead of changed rows only")
    p.add_argument("--use_shape_buckets", action="store_true",
                   help="count-sized fusion in the JAX package; "
                        "accepted, and this port runs count-sized "
                        "whenever no active-surfel budget is set")
    p.add_argument("--shape_bucket_step", type=int,
                   default=d.shape_bucket_step,
                   help="shape-bucket ladder step in surfel rows; "
                        "max_surfel_count runs every frame over the whole "
                        "capacity (no reference equivalent)")
    p.add_argument("--max_creations_per_frame", type=int,
                   default=d.max_creations_per_frame,
                   help="per-frame surfel creation budget; overflowing "
                        "creations retry next frame (TPU-specific; no "
                        "reference equivalent)")
    p.add_argument("--adaptive_creation_bound", type=float,
                   default=d.adaptive_creation_bound,
                   help="shape-bucket count bound safety factor over the "
                        "confirmed per-frame surfel growth; 0 = exact "
                        "conservative bound (TPU-specific; no reference "
                        "equivalent)")
    p.add_argument("--max_inflight_dispatches", type=int,
                   default=d.max_inflight_dispatches,
                   help="dispatches in flight before blocking on the oldest "
                        "surfel-count readback (TPU-specific; no reference "
                        "equivalent)")
    p.add_argument("--active_surfel_budget", type=int,
                   default=d.active_surfel_budget,
                   help="active-set tiling working-set size in surfels; "
                        "0 = off, -1 = auto-size to ~2x the live count on "
                        "a power-of-2 ladder (TPU-specific; no reference "
                        "equivalent)")
    p.add_argument("--frame_chunk", type=int, default=d.frame_chunk,
                   help="defer frames and run them K at a time: on the "
                        "GPU one CUDA-graph replay a power-of-2 sub-chunk "
                        "(eager with symmetric_regularization off), on the "
                        "CPU the same steps eagerly; any read of the map "
                        "flushes; results equal K=1 (no reference "
                        "equivalent)")
    p.add_argument("--live_viewer", type=int, default=0, metavar="PORT",
                   help="serve the live WebGL viewer on this port (0=off)")
    p.add_argument("--save_checkpoint", type=str, default=None,
                   help="write a reconstruction checkpoint (.npz) after "
                        "processing (TPU extension)")
    p.add_argument("--load_checkpoint", type=str, default=None,
                   help="resume reconstruction from a checkpoint (.npz) "
                        "(TPU extension)")

    # Required input paths (sequential parameters in the reference).
    p.add_argument("dataset_folder_path", type=str, nargs="?")
    p.add_argument("trajectory_filename", type=str, nargs="?")
    return p


def config_from_args(argv=None) -> SurfelMeshingConfig:
    args = build_arg_parser().parse_args(argv)

    follow_input_camera: Optional[bool]
    if args.follow_input_camera == "true":
        follow_input_camera = True
    elif args.follow_input_camera == "false":
        follow_input_camera = False
    elif args.follow_input_camera == "":
        # Reference default: follow unless step-by-step playback (main.cc:533).
        follow_input_camera = not args.step_by_step_playback
    else:
        raise SystemExit(
            f"Unknown value for --follow_input_camera: {args.follow_input_camera}")

    cfg = SurfelMeshingConfig(
        depth_scaling=args.depth_scaling,
        max_pose_interpolation_time_extent=args.max_pose_interpolation_time_extent,
        start_frame=args.start_frame,
        end_frame=args.end_frame,
        pyramid_level=args.pyramid_level,
        restrict_fps_to=args.restrict_fps_to,
        step_by_step_playback=args.step_by_step_playback,
        invert_quaternions=args.invert_quaternions,
        max_surfel_count=args.max_surfel_count,
        sensor_noise_factor=args.sensor_noise_factor,
        max_surfel_confidence=args.max_surfel_confidence,
        regularizer_weight=args.regularizer_weight,
        normal_compatibility_threshold_deg=args.normal_compatibility_threshold_deg,
        regularization_frame_window_size=args.regularization_frame_window_size,
        do_blending=not args.disable_blending,
        measurement_blending_radius=args.measurement_blending_radius,
        regularization_iterations_per_integration_iteration=(
            args.regularization_iterations_per_integration_iteration),
        radius_factor_for_regularization_neighbors=(
            args.radius_factor_for_regularization_neighbors),
        surfel_integration_active_window_size=(
            args.surfel_integration_active_window_size),
        max_angle_between_normals_deg=args.max_angle_between_normals_deg,
        min_triangle_angle_deg=args.min_triangle_angle_deg,
        max_triangle_angle_deg=args.max_triangle_angle_deg,
        max_neighbor_search_range_increase_factor=(
            args.max_neighbor_search_range_increase_factor),
        long_edge_tolerance_factor=args.long_edge_tolerance_factor,
        asynchronous_triangulation=not args.synchronous_meshing,
        full_meshing_every_frame=args.full_meshing_every_frame,
        full_retriangulation_at_end=args.full_retriangulation_at_end,
        max_depth=args.max_depth,
        depth_valid_region_radius=args.depth_valid_region_radius,
        observation_angle_threshold_deg=args.observation_angle_threshold_deg,
        depth_erosion_radius=args.depth_erosion_radius,
        median_filter_and_densify_iterations=args.median_filter_and_densify_iterations,
        outlier_filtering_frame_count=args.outlier_filtering_frame_count,
        outlier_filtering_required_inliers=args.outlier_filtering_required_inliers,
        bilateral_filter_sigma_xy=args.bilateral_filter_sigma_xy,
        bilateral_filter_radius_factor=args.bilateral_filter_radius_factor,
        bilateral_filter_sigma_depth_factor=args.bilateral_filter_sigma_depth_factor,
        outlier_filtering_depth_tolerance_factor=(
            args.outlier_filtering_depth_tolerance_factor),
        point_radius_extension_factor=args.point_radius_extension_factor,
        point_radius_clamp_factor=args.point_radius_clamp_factor,
        max_surfels_per_node=args.max_surfels_per_node,
        export_mesh=args.export_mesh,
        export_point_cloud=args.export_point_cloud,
        render_camera_frustum=not args.hide_camera_frustum,
        render_new_surfels_as_splats=not args.hide_new_surfel_splats,
        splat_half_extent_in_pixels=args.splat_half_extent_in_pixels,
        triangle_normal_shading=args.triangle_normal_shading,
        show_input_images=not args.hide_input_images,
        render_window_default_width=args.render_window_default_width,
        render_window_default_height=args.render_window_default_height,
        show_result=not args.exit_after_processing,
        follow_input_camera=follow_input_camera,
        record_keyframes=args.record_keyframes,
        playback_keyframes=args.playback_keyframes,
        create_video=args.create_video,
        debug_depth_preprocessing=args.debug_depth_preprocessing,
        debug_neighbor_rendering=args.debug_neighbor_rendering,
        debug_normal_rendering=args.debug_normal_rendering,
        visualize_last_update_timestamp=args.visualize_last_update_timestamp,
        visualize_creation_timestamp=args.visualize_creation_timestamp,
        visualize_radii=args.visualize_radii,
        visualize_surfel_normals=args.visualize_surfel_normals,
        log_timings=args.log_timings,
        log_timings_staged=args.log_timings_staged,
        profile_dir=args.profile_dir,
        use_shape_buckets=args.use_shape_buckets,
        shape_bucket_step=args.shape_bucket_step,
        max_creations_per_frame=args.max_creations_per_frame,
        adaptive_creation_bound=args.adaptive_creation_bound,
        max_inflight_dispatches=args.max_inflight_dispatches,
        abort_on_surfel_overflow=args.abort_on_surfel_overflow,
        delta_surfel_transfer=not args.no_delta_surfel_transfer,
        active_surfel_budget=args.active_surfel_budget,
        frame_chunk=args.frame_chunk,
        live_viewer_port=args.live_viewer,
        save_checkpoint=args.save_checkpoint,
        load_checkpoint=args.load_checkpoint,
        dataset_folder_path=args.dataset_folder_path,
        trajectory_filename=args.trajectory_filename,
    )
    cfg.validate()
    return cfg
