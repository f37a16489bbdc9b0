"""Count-sized dispatch of the port (ops/fusion.py::integrate_frame_bucketed
and the pipeline's bucket policy, which runs whenever no active-surfel
budget is set: the JAX package's --use_shape_buckets) against the port's
full-shape path and against the JAX package, on the CPU at 64x48 with
capacity 8192.

- integrate_frame_bucketed against the JAX function, run eagerly
  (jax.disable_jit, as test_torch_tiled.py runs its JAX steps), at two
  n_eff values, and against the port's full-shape step: pack, neighbors,
  nbr_dist and counters bit for bit;
- n_eff >= capacity with a budget N takes the tiled path;
- a binding bucket defers creations as in the JAX package (same pack and
  count) but counts no overflow, where the JAX function does (ROADMAP
  queue 3 #8);
- the bucketed pipeline equals the full-shape pipeline (a bucket step of
  the capacity) bit for bit, and its picks are the JAX pipeline's
  policy's on the same readbacks (max_inflight_dispatches=1, so every
  pick waits for the previous frame's count);
- the policy's count_bound and shape_bucket_for equal the JAX pipeline's
  on the same bookkeeping;
- assigning `state` (a resume) seeds the count bound, where the JAX
  pipeline keeps 0 (ROADMAP queue 3 #9);
- the bucketed step consumes its input state, and the dispatch-state
  snapshot and the meshing snapshot survive the frames after them;
- staged timings on the bucketed path; the app runs count-sized and
  accepts --use_shape_buckets.
"""

import dataclasses
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfelmeshing_tpu.ops import fusion as JF
from surfelmeshing_tpu.pipeline import ReconstructionPipeline as JaxPipeline
from surfelmeshing_tpu_torch.app.main import main as app_main
from surfelmeshing_tpu_torch.config import SurfelMeshingConfig
from surfelmeshing_tpu_torch.io.synthetic import (default_camera,
                                                  synthetic_rgbd_video)
from surfelmeshing_tpu_torch.ops import fusion as TF
from surfelmeshing_tpu_torch.pipeline import ReconstructionPipeline
from surfelmeshing_tpu_torch.utils.timing import COLUMNS

from test_torch_tiled import (assert_bit_identical, base_params,
                              sequence_inputs, to_jax)

torch.set_num_threads(1)

W, H, CAP = 64, 48, 8192
COUNTERS = ("surfel_count", "merge_count", "overflow_count")
CONFIG = SurfelMeshingConfig(max_surfel_count=CAP,
                             outlier_filtering_frame_count=2,
                             max_creations_per_frame=512,
                             shape_bucket_step=1024,
                             max_inflight_dispatches=1,
                             restrict_fps_to=0)
FULL_SHAPE = dataclasses.replace(CONFIG, shape_bucket_step=CAP)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tum_micro")
APP_FLAGS = ["--device", "cpu", "--max_surfel_count", "120000",
             "--pyramid_level", "2", "--outlier_filtering_frame_count", "2",
             "--depth_erosion_radius", "1", "--restrict_fps_to", "0",
             "--exit_after_processing"]


@pytest.fixture(scope="module")
def frames():
    """(params, six preprocessed 64x48 arc frames, the port's full-shape
    state after the first four)."""
    cam, frames = sequence_inputs("arc", 6)
    params = base_params(cam, max_creations_per_frame=1024)
    state = TF.create_surfel_state(CAP, "cpu")
    for i, inputs in frames[:4]:
        state = TF.integrate_frame(state, *inputs, i, params)
    return params, frames, state


def clone(state: TF.SurfelState) -> TF.SurfelState:
    return TF.SurfelState(**{f.name: getattr(state, f.name).clone()
                             for f in dataclasses.fields(TF.SurfelState)})


def jax_bucketed(state, inputs, frame, params, n_eff):
    """The JAX package's integrate_frame_bucketed, eagerly."""
    d, normals, radius, color, t_gl, t_lg = (t.numpy() for t in inputs)
    with jax.disable_jit():
        return JF.integrate_frame_bucketed(
            to_jax(state), jnp.asarray(d.astype(np.uint16)),
            jnp.asarray(normals), jnp.asarray(radius), jnp.asarray(color),
            jnp.asarray(t_gl), jnp.asarray(t_lg), jnp.int32(frame),
            JF.FusionParams(**dataclasses.asdict(params)), n_eff)


def assert_equals_jax(got: TF.SurfelState, want: JF.SurfelState,
                      counters=COUNTERS):
    out = TF.state_to_numpy(got)
    for name in ("pack", "neighbors", "nbr_dist"):
        np.testing.assert_array_equal(
            np.ascontiguousarray(out[name]).view(np.int32),
            np.ascontiguousarray(np.asarray(getattr(want, name)))
            .view(np.int32), name)
    for name in counters:
        assert int(out[name]) == int(getattr(want, name)), name


@pytest.mark.parametrize("n_eff", [3072, 6144])
def test_bucketed_matches_jax_and_full_shape(frames, n_eff):
    params, seq, state = frames
    i, inputs = seq[4]
    assert int(state.surfel_count) + params.max_creations_per_frame <= n_eff
    full = TF.integrate_frame(state, *inputs, i, params)
    want = jax_bucketed(state, inputs, i, params, n_eff)
    got = TF.integrate_frame_bucketed(clone(state), *inputs, i, params,
                                      n_eff)
    assert int(got.surfel_count) > int(state.surfel_count)
    assert_equals_jax(got, want)
    assert_bit_identical(got, full)


def test_full_bucket_takes_the_tiled_path(frames):
    """n_eff at the capacity with budget 4096 in 256-row tiles runs
    integrate_frame's tiled path, its tiles written into the input's
    tensors: the input is consumed, as on every bucketed route."""
    params, seq, state = frames
    i, inputs = seq[4]
    tiled = dataclasses.replace(params, active_surfel_budget=4096,
                                tile_size=256)
    before = clone(state)
    want = TF.integrate_frame(state, *inputs, i, tiled)
    assert_bit_identical(state, before)              # not modified
    consumed = clone(state)
    got = TF.integrate_frame_bucketed(consumed, *inputs, i, tiled, CAP)
    assert 0 < int(got.active_tile_count) < CAP // 256
    assert_bit_identical(got, want, counters=COUNTERS + (
        "skipped_tile_count", "active_tile_count"))
    for name in ("pack", "neighbors", "nbr_dist"):
        assert getattr(got, name).data_ptr() == \
            getattr(consumed, name).data_ptr(), name


def test_binding_bucket_defers_without_overflow(frames):
    """A bucket with room for fewer creations than the frame makes: the
    rest are deferred in both packages, with the same pack, neighbors and
    count; the JAX function counts them in overflow_count (ROADMAP queue
    3 #8), the port counts only creations dropped at the capacity."""
    params, seq, state = frames
    i, inputs = seq[4]
    count = int(state.surfel_count)
    n_eff = count + 64
    want = jax_bucketed(state, inputs, i, params, n_eff)
    got = TF.integrate_frame_bucketed(clone(state), *inputs, i, params,
                                      n_eff)
    assert int(got.surfel_count) == n_eff == int(want.surfel_count)
    assert_equals_jax(got, want, counters=("surfel_count", "merge_count"))
    assert int(want.overflow_count) > 0          # #8: deferrals counted
    assert int(got.overflow_count) == 0
    full = TF.integrate_frame(state, *inputs, i, params)
    assert int(full.surfel_count) > n_eff


def run_pipeline(cfg, video_frames=10, jax_pipe=None):
    """The port's pipeline over a 64x48 video; with `jax_pipe`, the JAX
    pipeline's dispatch policy runs beside it on the port's counts (its
    pick before each fused frame, its readback of the port's state
    after) and its picks are returned too."""
    video, _ = synthetic_rgbd_video(video_frames, W, H, noise_sigma=0.002)
    pipe = ReconstructionPipeline(cfg, video.depth_camera, "cpu")
    jax_picks = []
    for i in range(video.frame_count):
        if jax_pipe is not None and i in range(1, video.frame_count - 1):
            jax_picks.append((1, jax_pipe._pick_params_and_bucket(1)[1]))
        if pipe.process_frame(video, i) is not None and \
                jax_pipe is not None:
            jax_pipe._state = to_jax(pipe.state)
            jax_pipe._queue_count_readback(frames=1)
    return pipe, jax_picks


@pytest.mark.parametrize("factor", [0.0, 2.0])
def test_bucketed_pipeline_matches_full_shape_and_jax_picks(factor):
    cfg = dataclasses.replace(CONFIG, adaptive_creation_bound=factor)
    full, _ = run_pipeline(dataclasses.replace(cfg, shape_bucket_step=CAP))
    jax_pipe = JaxPipeline(dataclasses.replace(cfg, use_shape_buckets=True),
                           default_camera(W, H))
    pipe, jax_picks = run_pipeline(cfg, jax_pipe=jax_pipe)
    assert_bit_identical(pipe.state, full.state)
    assert full.bucket_pick_log == [(1, CAP)] * 8
    assert pipe.bucket_pick_log == jax_picks
    buckets = [n for _, n in pipe.bucket_pick_log]
    assert len(buckets) == 8 and max(buckets) < CAP
    assert buckets == sorted(buckets) or factor > 0
    assert pipe.surfel_count() > 1000


@pytest.mark.parametrize("confirmed,in_flight,growth,factor,step", [
    (0, 0, [], 0.0, 16_384),                   # fresh map
    (5_000, 1, [], 0.0, 16_384),               # one frame in flight
    (40_000, 2, [9_000, 3_000], 2.0, 16_384),  # adaptive_creation_bound
    (40_000, 0, [500], 2.0, 16_384),           # the 2048 floor
    (150_000, 3, [], 0.0, 16_384),             # clamped at max_surfel_count
    (20_000, 1, [], 0.0, 65_536),              # a coarser step
    (5_000, 1, [], 0.0, 180_000)])             # a step of the capacity
def test_bucket_policy_matches_jax(confirmed, in_flight, growth, factor,
                                   step):
    cfg = SurfelMeshingConfig(max_surfel_count=180_000,
                              use_shape_buckets=True,
                              shape_bucket_step=step,
                              adaptive_creation_bound=factor)
    camera = default_camera(640, 480)
    pipes = (ReconstructionPipeline(cfg, camera, "cpu"),
             JaxPipeline(cfg, camera))
    policy, ref = pipes[0].policy, pipes[1]
    policy.confirmed_count, policy.unconfirmed_frames = confirmed, in_flight
    ref._confirmed_count, ref._unconfirmed_frames = confirmed, in_flight
    policy.growth_window, ref._growth_window = list(growth), list(growth)
    port = [policy.count_bound(1),
            pipes[0].shape_bucket_for(policy.count_bound(1))]
    ref = [ref._count_bound(1), ref.shape_bucket_for(ref._count_bound(1))]
    assert port == ref
    assert port[1] % step == 0 or port[1] == 180_000
    assert port[1] >= min(port[0], 180_000)


def test_resume_seeds_the_count_bound():
    """A map assigned to `state`, as the app's --load_checkpoint does:
    the port's first bucket holds the map's count plus a frame's
    creations, and the frames after it equal a full-shape resume's.  The
    JAX pipeline keeps its confirmed count at 0, so its first bucket is
    below the live count (ROADMAP queue 3 #9)."""
    first, _ = run_pipeline(CONFIG, video_frames=6)
    saved = TF.state_to_numpy(first.state)
    count = int(saved["surfel_count"])

    jax_pipe = JaxPipeline(dataclasses.replace(CONFIG,
                                               use_shape_buckets=True),
                           default_camera(W, H))
    jax_pipe.state = JF.SurfelState(**{k: jnp.asarray(saved[k])
                                       for k in JF.SurfelState._fields})
    assert jax_pipe._confirmed_count == 0
    assert jax_pipe.shape_bucket_for(jax_pipe._count_bound(1)) < count

    runs = []
    for run_cfg in (CONFIG, FULL_SHAPE):
        video, _ = synthetic_rgbd_video(10, W, H, noise_sigma=0.002)
        pipe = ReconstructionPipeline(run_cfg, video.depth_camera, "cpu")
        pipe.state = TF.state_from_numpy(device="cpu", **saved)
        assert pipe.policy.confirmed_count == count
        for i in range(5, video.frame_count):
            pipe.process_frame(video, i)
        runs.append(pipe)
    picks = [n for _, n in runs[0].bucket_pick_log]
    assert picks[0] >= count + CONFIG.max_creations_per_frame
    assert max(picks) < CAP
    assert_bit_identical(runs[0].state, runs[1].state)


def test_bucketed_step_consumes_its_input_and_snapshot_survives(frames):
    params, seq, state = frames
    i, inputs = seq[4]
    kept = clone(state)
    TF.integrate_frame(state, *inputs, i, params)
    assert_bit_identical(state, kept)                # not modified
    consumed = clone(state)
    out = TF.integrate_frame_bucketed(consumed, *inputs, i, params, 4096)
    assert out.pack.data_ptr() == consumed.pack.data_ptr()
    assert not torch.equal(consumed.pack, kept.pack)

    video, _ = synthetic_rgbd_video(10, W, H, noise_sigma=0.002)
    pipe = ReconstructionPipeline(CONFIG, video.depth_camera, "cpu")
    for j in range(5):
        pipe.process_frame(video, j)
    snap = pipe.snapshot_dispatch_state()
    copy = TF.state_to_numpy(snap[0])
    for j in range(5, 9):
        pipe.process_frame(video, j)
    pipe.drain()
    after = TF.state_to_numpy(pipe.state)
    assert after["surfel_count"] > copy["surfel_count"]
    for name, value in TF.state_to_numpy(snap[0]).items():
        np.testing.assert_array_equal(value, copy[name], name)
    pipe.restore_dispatch_state(snap)
    for j in range(5, 9):
        pipe.process_frame(video, j)
    for name, value in TF.state_to_numpy(pipe.state).items():
        np.testing.assert_array_equal(value, after[name], name)


def test_meshing_snapshot_survives_the_next_frame():
    """The meshing thread reads a snapshot after the frame loop has moved
    on: on the CPU too its arrays are copies, not views of the map that
    the next bucketed frame writes in place."""
    video, _ = synthetic_rgbd_video(8, W, H, noise_sigma=0.002)
    pipe = ReconstructionPipeline(CONFIG, video.depth_camera, "cpu")
    for j in range(5):
        pipe.process_frame(video, j)
    snap = pipe.snapshot()
    kept = [np.copy(a) for a in snap[:4]]
    before = np.copy(TF.state_to_numpy(pipe.state)["pack"])
    pipe.process_frame(video, 5)
    assert not np.array_equal(TF.state_to_numpy(pipe.state)["pack"], before)
    for got, want in zip(snap[:4], kept):
        np.testing.assert_array_equal(got, want)


def test_staged_timings_on_the_bucketed_path():
    plain, _ = run_pipeline(CONFIG, video_frames=6)
    staged_cfg = dataclasses.replace(CONFIG, log_timings="timings.txt",
                                     log_timings_staged=True)
    video, _ = synthetic_rgbd_video(6, W, H, noise_sigma=0.002)
    pipe = ReconstructionPipeline(staged_cfg, video.depth_camera, "cpu")
    for i in range(video.frame_count):
        if pipe.process_frame(video, i) is not None:
            assert set(COLUMNS) <= set(pipe._last_stage_ms)
            pipe.log_frame_timings(i)
    assert len(pipe.timings_log_lines) == 4
    assert pipe.bucket_pick_log == plain.bucket_pick_log
    assert_bit_identical(pipe.state, plain.state)


def test_app_use_shape_buckets(tmp_path, monkeypatch, caplog):
    """The app runs count-sized and accepts the JAX package's
    --use_shape_buckets: it logs the buckets it used, each below the
    capacity, and writes the full-shape run's point cloud (a bucket step
    of the capacity) byte for byte."""
    monkeypatch.chdir(tmp_path)
    for name, extra in (("full.ply", ["--shape_bucket_step", "120000"]),
                        ("buckets.ply", ["--use_shape_buckets",
                                         "--shape_bucket_step", "16384"])):
        with caplog.at_level(logging.INFO, logger="surfelmeshing_tpu_torch"):
            assert app_main([*APP_FLAGS, *extra, "--export_point_cloud",
                             name, FIXTURE, "groundtruth.txt"]) == 0
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("shape buckets used")]
    assert len(lines) == 2
    full, used = ([int(b) for b in line.split("[")[1].rstrip("]").split(",")]
                  for line in lines)
    assert full == [120_000]
    assert used and max(used) < 120_000
    assert (tmp_path / "buckets.ply").read_bytes() == \
        (tmp_path / "full.ply").read_bytes()
