"""Chunked dispatch of the port (--frame_chunk K: pipeline.py's deferral
and flush, chunk.py's chunk step) on the CPU, where the chunk body runs
eagerly: the same body the card captures as a CUDA graph.

- (a) the port's app with --frame_chunk 3, and with 4 under a finer
  count-sized bucket step, writes the per-frame run's PLY byte for byte
  while async meshing snapshots flush chunks early (the JAX package's
  tests/test_app.py::test_frame_chunk_*);
- (b) the port's pipeline at frame_chunk 4 against the JAX pipeline at 4
  (its chunk a jitted lax.scan) over the same frames and the same early
  flush: bucket_pick_log entries (size, n_eff) equal, and the state held
  to test_torch_pipeline.py's criterion against jitted JAX;
- (c) deferral: a state read flushes, the setter refuses pending frames,
  staged timings and debug_depth_preprocessing do not defer, the growth
  sample of a multi-frame readback is the JAX pipeline's;
- (d) integrate_frame, integrate_frame_bucketed (bucketed, full-shape and
  tiled routes) and regularize_only give the same bits with a 0-d int32
  frame index as with an int;
- (e) symmetric_regularization=False chunked equals per-frame bit for bit;
- on a CUDA device (skipped here): chunks are CUDA-graph replays, equal
  to per-frame dispatch bit for bit, one blending launch a fused frame.
"""

import dataclasses
import itertools
import os

import jax.numpy as jnp
import pytest
import torch

from surfelmeshing_tpu.config import SurfelMeshingConfig as JaxConfig
from surfelmeshing_tpu.pipeline import ReconstructionPipeline as JaxPipeline
from surfelmeshing_tpu_torch import chunk as CH
from surfelmeshing_tpu_torch.app.main import main as app_main
from surfelmeshing_tpu_torch.config import SurfelMeshingConfig
from surfelmeshing_tpu_torch.io.synthetic import (default_camera,
                                                  synthetic_rgbd_video)
from surfelmeshing_tpu_torch.meshing import MeshingDriver
from surfelmeshing_tpu_torch.ops import blend, launch_counts
from surfelmeshing_tpu_torch.ops import preprocess as pp
from surfelmeshing_tpu_torch.ops import fusion as TF
from surfelmeshing_tpu_torch.pipeline import ReconstructionPipeline

from test_torch_pipeline import assert_pipelines_match
from test_torch_tiled import (COUNTERS, assert_bit_identical, base_params,
                              sequence_inputs)

torch.set_num_threads(1)

W, H, CAP = 64, 48, 8192
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tum_micro")
APP_FLAGS = ["--device", "cpu", "--max_surfel_count", "120000",
             "--pyramid_level", "2", "--outlier_filtering_frame_count", "2",
             "--depth_erosion_radius", "1", "--restrict_fps_to", "0",
             "--exit_after_processing"]
# The JAX pipeline's chunk compiles once per (length, bucket): a light
# step (5-tap bilateral filter, blending radius 4) and one bucket (4096)
# keep its three compiles short.
CHUNK_CONFIG = dict(max_surfel_count=CAP, outlier_filtering_frame_count=2,
                    max_creations_per_frame=512, shape_bucket_step=4096,
                    max_inflight_dispatches=1, restrict_fps_to=0,
                    bilateral_filter_sigma_xy=0.5,
                    measurement_blending_radius=4, depth_erosion_radius=1)


def port_config(**kw) -> SurfelMeshingConfig:
    return SurfelMeshingConfig(**{**CHUNK_CONFIG, **kw})


def run_port(cfg, frames=10, read_after=None, modes=None, device="cpu"):
    """The port's pipeline over a 64x48 video; the map is read (a flush)
    after frame `read_after`."""
    video, _ = synthetic_rgbd_video(frames, W, H, noise_sigma=0.002)
    pipe = ReconstructionPipeline(cfg, video.depth_camera, device)
    if modes:
        pipe.fusion_params = dataclasses.replace(pipe.fusion_params, **modes)
    for i in range(video.frame_count):
        pipe.process_frame(video, i)
        if i == read_after:
            pipe.state
    pipe.drain()
    return pipe


# -- (a) the app ------------------------------------------------------------

def run_app(tmp_path, monkeypatch, name, extra):
    """The port's app on tum_micro; the mesher reports idle at every 5th
    frame only, so its snapshots flush chunks early at fixed frames."""
    ticks = itertools.cycle([False] * 4 + [True])
    monkeypatch.setattr(MeshingDriver, "idle", lambda self: next(ticks))
    out = tmp_path / f"{name}.ply"
    assert app_main([*APP_FLAGS, *extra, "--export_point_cloud", str(out),
                     FIXTURE, "groundtruth.txt"]) == 0
    return out.read_bytes()


@pytest.fixture(scope="module")
def per_frame_ply(tmp_path_factory):
    """The per-frame app's PLY (count-sized dispatch equals full shape bit
    for bit, so one reference serves every bucket step)."""
    with pytest.MonkeyPatch.context() as mp:
        tmp = tmp_path_factory.mktemp("per_frame")
        mp.chdir(tmp)
        return run_app(tmp, mp, "ref", [])


@pytest.mark.parametrize("chunk,extra,sizes_want", [
    (3, [], [2, 1, 2, 2, 1]),
    (4, ["--shape_bucket_step", "4096"], [4, 1, 2, 1])],
    ids=["chunk3", "chunk4-fine-buckets"])
def test_app_chunked_ply_matches_per_frame(tmp_path, monkeypatch,
                                           per_frame_ply, chunk, extra,
                                           sizes_want):
    monkeypatch.chdir(tmp_path)
    sizes = []
    run = CH.ChunkStep.run

    def counted(self, state, entries, params, n_eff):
        sizes.append(len(entries))
        return run(self, state, entries, params, n_eff)

    monkeypatch.setattr(CH.ChunkStep, "run", counted)
    got = run_app(tmp_path, monkeypatch, "chunk",
                  [*extra, "--frame_chunk", str(chunk)])
    assert got == per_frame_ply
    assert sizes == sizes_want         # early flushes at frames 5 and 8


# -- (b) against the JAX pipeline -----------------------------------------

def test_pipeline_chunk4_matches_jax_chunk4(record_property):
    """Frames 1-3 fused, then a state read (an early flush of 3: sub-chunks
    of 2 and 1), frames 4-7 (a chunk of 4), frame 8 flushed by drain."""
    cfg = JaxConfig(**CHUNK_CONFIG, use_shape_buckets=True, frame_chunk=4)
    video, _ = synthetic_rgbd_video(10, W, H, noise_sigma=0.002)
    jax_pipe = JaxPipeline(cfg, video.depth_camera)
    for i in range(video.frame_count):
        jax_pipe.process_frame(video, i)
        if i == 3:
            jax_pipe.state
    jax_pipe.drain()
    port = run_port(cfg, read_after=3)
    assert port.bucket_pick_log == jax_pipe.bucket_pick_log
    assert [s for s, _ in port.bucket_pick_log] == [2, 1, 4, 1]
    record_property("pipeline_parity", assert_pipelines_match(jax_pipe,
                                                              port))


# -- (c) deferral semantics -------------------------------------------------

def test_state_read_flushes_and_setter_refuses_pending():
    video, _ = synthetic_rgbd_video(6, W, H, noise_sigma=0.002)
    pipe = ReconstructionPipeline(port_config(frame_chunk=4),
                                  video.depth_camera, "cpu")
    results = [pipe.process_frame(video, i) for i in range(4)]
    assert results[0] is None
    assert [(r.frame_index, r.surfel_count, r.merge_count)
            for r in results[1:]] == [(i, -1, -1) for i in (1, 2, 3)]
    assert len(pipe._pending) == 3 and pipe.bucket_pick_log == []
    with pytest.raises(RuntimeError, match="deferred frames are pending"):
        pipe.state = TF.create_surfel_state(CAP, "cpu")
    assert int(pipe.state.surfel_count) > 0      # the read flushes
    assert not pipe._pending
    assert [s for s, _ in pipe.bucket_pick_log] == [2, 1]
    assert pipe.graph_captures == pipe.graph_replays == 0   # CPU: eager
    pipe.state = TF.create_surfel_state(CAP, "cpu")        # now allowed
    assert pipe.surfel_count() == 0


@pytest.mark.parametrize("flag", ["log_timings_staged",
                                  "debug_depth_preprocessing"])
def test_staged_and_debug_modes_do_not_defer(flag, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = port_config(frame_chunk=4, log_timings=True, **{flag: True})
    video, _ = synthetic_rgbd_video(5, W, H, noise_sigma=0.002)
    pipe = ReconstructionPipeline(cfg, video.depth_camera, "cpu")
    assert not JaxPipeline(JaxConfig(**CHUNK_CONFIG, frame_chunk=4,
                                     log_timings=True, **{flag: True}),
                           default_camera(W, H))._defer
    for i in range(3):
        pipe.process_frame(video, i)
        assert not pipe._pending
    assert pipe.bucket_pick_log == [(1, 4096), (1, 4096)]


def test_growth_sample_per_frame_matches_jax():
    """Readbacks charged for 3 and 2 frames: the growth sample is the
    ceiling of the growth per frame, in both pipelines."""
    cfg = JaxConfig(**CHUNK_CONFIG, use_shape_buckets=True, frame_chunk=4,
                    adaptive_creation_bound=2.0)
    pipes = (ReconstructionPipeline(cfg, default_camera(W, H), "cpu"),
             JaxPipeline(cfg, default_camera(W, H)))
    policy, ref = pipes[0].policy, pipes[1]
    for count, frames in ((1000, 3), (1905, 2)):
        policy.readbacks.append(   # count, tiles, deferred, skipped
            (torch.tensor([count, 0, 0, 0], dtype=torch.int32), None,
             frames, 0))
        ref._pending_counts.append((jnp.array([count, 0], jnp.int32),
                                    frames))
        policy.unconfirmed_frames += frames
        ref._unconfirmed_frames += frames
        policy.drain(0)
        ref._drain_count_readbacks(0)
    got = [policy.growth_window, policy.confirmed_count,
           policy.unconfirmed_frames, policy.count_bound(4)]
    want = [ref._growth_window, ref._confirmed_count,
            ref._unconfirmed_frames, ref._count_bound(4)]
    assert got == want == [[334, 453], 1905, 0, 1905 + 4 * 512]


# -- (d) the frame index as a device value ----------------------------------

@pytest.fixture(scope="module")
def frames():
    cam, seq = sequence_inputs("arc", 6)
    params = base_params(cam, max_creations_per_frame=1024)
    state = TF.create_surfel_state(CAP, "cpu")
    for i, inputs in seq[:4]:
        state = TF.integrate_frame(state, *inputs, i, params)
    return params, seq, state


def clone(state):
    return TF.SurfelState(**{f.name: getattr(state, f.name).clone()
                             for f in dataclasses.fields(TF.SurfelState)})


@pytest.mark.parametrize("route", ["full", "bucketed", "bucketed-full",
                                   "tiled", "bucketed-tiled", "regularize"])
def test_tensor_frame_index_gives_the_same_bits(frames, route):
    params, seq, state = frames
    i, inputs = seq[4]
    tiled = dataclasses.replace(params, active_surfel_budget=4096,
                                tile_size=256)

    def step(frame_index):
        s = clone(state)
        if route == "full":
            return TF.integrate_frame(s, *inputs, frame_index, params)
        if route == "tiled":
            return TF.integrate_frame(s, *inputs, frame_index, tiled)
        if route == "regularize":
            return TF.regularize_only(s, frame_index, params)
        n_eff = {"bucketed": 4096, "bucketed-full": CAP,
                 "bucketed-tiled": CAP}[route]
        return TF.integrate_frame_bucketed(
            s, *inputs, frame_index,
            tiled if route == "bucketed-tiled" else params, n_eff)

    want = step(i)
    got = step(torch.tensor(i, dtype=torch.int32))
    assert_bit_identical(got, want, counters=COUNTERS)
    if route != "regularize":
        assert int(got.surfel_count) > int(state.surfel_count)


# -- (e) the mode that is not captured --------------------------------------

def test_exact_regularization_chunked_matches_per_frame():
    modes = dict(symmetric_regularization=False)
    per_frame = run_port(port_config(), modes=modes)
    chunked = run_port(port_config(frame_chunk=4), read_after=6,
                       modes=modes)
    assert not chunked._chunk.graphs_for(chunked.fusion_params)
    assert [s for s, _ in chunked.bucket_pick_log] == [4, 2, 2]
    assert_bit_identical(chunked.state, per_frame.state, counters=COUNTERS)


# -- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_chunk_graphs_match_per_frame_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py's [chunk] phase "
                    "runs the same check on the card)")
    per_frame = run_port(port_config(), device="cuda")
    launch_counts.zero()
    chunked = run_port(port_config(frame_chunk=4), read_after=6,
                       device="cuda")
    assert blend.blend_core.launches == 8
    assert pp.launches() == dict.fromkeys(pp.KERNELS, 8)
    assert chunked.graph_captures >= 1
    assert chunked.graph_replays == len(chunked.bucket_pick_log)
    assert_bit_identical(chunked.state, per_frame.state, counters=COUNTERS)


# -- the auto budget of a chunk ---------------------------------------------

def test_chunk_auto_budget_charges_its_frames():
    """A frame's auto budget is the JAX pipeline's; a chunk's adds a
    creation frontier (8 tiles at 640x480) for each unconfirmed and
    chunked frame (ROADMAP queue 3 #10)."""
    cfg = SurfelMeshingConfig(max_surfel_count=1_000_000,
                              active_surfel_budget=-1)
    camera = default_camera(640, 480)
    pipes = (ReconstructionPipeline(cfg, camera, "cpu"),
             JaxPipeline(cfg, camera))
    port, ref = pipes
    policy, rows = port.policy, port.state.pack.shape[0]
    policy.confirmed_count, policy.unconfirmed_frames = 200_000, 4
    ref._confirmed_count, ref._unconfirmed_frames = 200_000, 4
    policy.lagged_active_tiles = ref._lagged_active_tiles = 20
    assert policy.auto_budget(rows, 1) == ref._auto_budget() == 64 * 4096
    assert policy.auto_budget(rows, 4) == 128 * 4096   # 40 + 8 * 8 tiles


def test_auto_budget_chunked_matches_per_frame():
    per_frame = run_port(port_config(active_surfel_budget=-1))
    chunked = run_port(port_config(active_surfel_budget=-1, frame_chunk=4),
                       read_after=6)
    assert int(chunked.state.skipped_tile_count) == 0
    assert_bit_identical(chunked.state, per_frame.state, counters=COUNTERS)
