"""Active-set tiling of the port (ops/fusion.py::_integrate_tiled and the
pipeline's auto budget, --active_surfel_budget N|-1) against the port's
full-shape path and against the JAX package, on 64x48 frames of
SyntheticRGBDSequence.

With every wanted tile in the working set, the tiled path must equal the
full-shape path bit for bit (every scatter is order-independent), as
tests/test_fusion.py::TestActiveSetTiling asserts for the JAX package.  A
budget that skips tiles changes the result; there the port is held to
eager JAX (jax.disable_jit, as in test_torch_fusion.py): counters,
neighbor slots and discrete columns exactly, continuous columns within
assert_pack_close (rtol 3e-5, atol 3e-6).

The frames are preprocessed once by the port (exact against eager JAX,
test_torch_preprocess.py) and fed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfelmeshing_tpu.config import SurfelMeshingConfig
from surfelmeshing_tpu.io.synthetic import (SyntheticRGBDSequence,
                                            default_camera,
                                            synthetic_rgbd_video)
from surfelmeshing_tpu.ops import fusion as JF
from surfelmeshing_tpu.pipeline import ReconstructionPipeline as JaxPipeline
from surfelmeshing_tpu_torch.ops import fusion as TF
from surfelmeshing_tpu_torch.ops import preprocess as TP
from surfelmeshing_tpu_torch.pipeline import ReconstructionPipeline

from test_golden_fusion import assert_pack_close

torch.set_num_threads(1)

W, H, SCALE = 64, 48, 5000.0
EXACT_COLS = (TF.STAMP, TF.RCNT, TF.DETACH, TF.CONF, TF.CR, TF.CG, TF.CB,
              TF.CREATION)
COUNTERS = ("surfel_count", "merge_count", "overflow_count",
            "skipped_tile_count", "active_tile_count")


def sequence_inputs(trajectory, frames):
    """(camera, [(i, (depth, normals, radius, color, T_gl, T_lg))]) for
    frames i = 1..frames, preprocessed with tests/test_fusion.py's
    settings."""
    seq = SyntheticRGBDSequence(num_frames=frames + 2, width=W, height=H,
                                trajectory=trajectory)
    cam = seq.camera
    out = []
    for i in range(1, frames + 1):
        depth, color = seq.depth_and_color(i)
        others = np.stack([seq.depth_and_color(i - 1)[0],
                           seq.depth_and_color(i + 1)[0]])
        ref = seq.poses[i].scaled_translation(SCALE)
        T = np.stack([
            (ref.inverse() * seq.poses[j].scaled_translation(SCALE))
            .inverse().matrix3x4() for j in (i - 1, i + 1)]) \
            .astype(np.float32)
        d, normals, radius = TP.preprocess_frame(
            torch.from_numpy(depth.astype(np.int32)),
            torch.from_numpy(others.astype(np.int32)), torch.from_numpy(T),
            sigma_xy=3.0, sigma_value_factor=0.05, radius_factor=2.0,
            max_depth_u16=int(SCALE * 3.0), depth_valid_region_radius=1000.0,
            tolerance=0.02, required_inliers=None, erosion_radius=1,
            observation_angle_threshold_deg=85.0, depth_scaling=SCALE,
            point_radius_extension_factor=1.5,
            point_radius_clamp_factor=np.inf,
            fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy)
        color_pm = torch.from_numpy(np.ascontiguousarray(
            color.transpose(2, 0, 1)))
        poses = [torch.from_numpy(p.matrix3x4().astype(np.float32))
                 for p in (seq.poses[i], seq.poses[i].inverse())]
        out.append((i, (d, normals, radius, color_pm, *poses)))
    return cam, out


def base_params(cam, **kw) -> TF.FusionParams:
    return TF.FusionParams(width=W, height=H, fx=cam.fx, fy=cam.fy,
                           cx=cam.cx, cy=cam.cy, depth_scaling=SCALE,
                           do_blending=True, regularization_iterations=1,
                           **kw)


def run_port(state, frames, params):
    for i, inputs in frames:
        state = TF.integrate_frame(state, *inputs, i, params)
    return state


def bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.int32)


def assert_bit_identical(got: TF.SurfelState, want: TF.SurfelState,
                         counters=COUNTERS[:3]):
    for name in ("pack", "neighbors", "nbr_dist"):
        np.testing.assert_array_equal(bits(getattr(got, name)),
                                      bits(getattr(want, name)), name)
    for name in counters:
        assert int(getattr(got, name)) == int(getattr(want, name)), name


def to_jax(state: TF.SurfelState) -> JF.SurfelState:
    host = TF.state_to_numpy(state)
    return JF.SurfelState(**{k: jnp.asarray(host[k])
                             for k in JF.SurfelState._fields})


def jax_step(jstate, inputs, frame, params):
    d, normals, radius, color, t_gl, t_lg = (t.numpy() for t in inputs)
    jparams = JF.FusionParams(**dataclasses.asdict(params))
    with jax.disable_jit():
        return JF.integrate_frame(
            jstate, jnp.asarray(d.astype(np.uint16)), jnp.asarray(normals),
            jnp.asarray(radius), jnp.asarray(color), jnp.asarray(t_gl),
            jnp.asarray(t_lg), jnp.int32(frame), jparams)


def test_tiled_matches_full_bitexact():
    """Budget 4096 in 256-row tiles at capacity 8192 (tests/test_fusion.py
    :297-316).  At 64x48 the creation frontier of the default budget
    (3,072 pixels, 13 tiles) would leave too little room for the live
    tiles, so creations are capped at 1,024 a frame (5 tiles)."""
    cam, frames = sequence_inputs("arc", 6)
    base = base_params(cam, max_creations_per_frame=1024)
    full = run_port(TF.create_surfel_state(8192, "cpu"), frames, base)
    tiled = run_port(TF.create_surfel_state(8192, "cpu"), frames,
                     dataclasses.replace(base, active_surfel_budget=4096,
                                         tile_size=256))
    assert int(tiled.skipped_tile_count) == 0
    assert 0 < int(tiled.active_tile_count) < 16
    assert int(full.surfel_count) > 1500
    assert_bit_identical(tiled, full)


def test_auto_budget_matches_full_bitexact():
    """The pipeline's auto budget (-1) on the look-away trajectory in
    128-row tiles (tests/test_fusion.py:318-363): bit-exact against the
    full-shape pipeline, and the budget is below the capacity after the
    second frame, so the working set really is a subset.  Each budget is
    the one the JAX pipeline's policy picks from the same lagged demand
    (on the CPU every readback has completed by the next frame)."""
    cfg = SurfelMeshingConfig(max_surfel_count=8192,
                              outlier_filtering_frame_count=2,
                              max_creations_per_frame=512,
                              restrict_fps_to=0)
    pipes, budgets, jax_budgets = [], [], []
    for budget in (0, -1):
        video, _ = synthetic_rgbd_video(10, W, H, trajectory="lookaway")
        cfg_b = dataclasses.replace(cfg, active_surfel_budget=budget)
        pipe = ReconstructionPipeline(cfg_b, video.depth_camera, "cpu")
        jax_pipe = JaxPipeline(cfg_b, video.depth_camera)
        for p in (pipe, jax_pipe):
            p.fusion_params = dataclasses.replace(p.fusion_params,
                                                  tile_size=128)
        for i in range(video.frame_count):
            jax_pipe._confirmed_count = int(pipe.state.surfel_count)
            jax_pipe._lagged_active_tiles = int(pipe.state.active_tile_count)
            if pipe.process_frame(video, i) is not None and budget:
                budgets.append(pipe.active_budget())
                jax_budgets.append(jax_pipe._auto_budget())
        pipes.append(pipe)
    full, auto = (p.state for p in pipes)
    assert budgets == jax_budgets and len(budgets) == 8
    assert max(budgets[2:]) < 8192, budgets
    assert int(auto.skipped_tile_count) == 0
    assert int(auto.active_tile_count) > 0
    assert_bit_identical(auto, full)


@pytest.mark.parametrize("confirmed,in_flight,tiles,growth,factor", [
    (0, 0, 0, [], 0.0),                      # first frame: no readback yet
    (300_000, 1, 0, [], 0.0),                # count bound, one in flight
    (300_000, 2, 0, [9_000, 3_000], 1.5),    # adaptive_creation_bound
    (300_000, 1, 37, [9_000], 1.5),          # lagged tile demand
    (990_000, 0, 200, [], 0.0)])             # capped at the capacity
def test_auto_budget_policy_matches_jax(confirmed, in_flight, tiles, growth,
                                        factor):
    """The auto budget of the port's policy and of the JAX pipeline on the
    same readback state (640x480, 1M capacity rounded to 4096-row
    tiles)."""
    cfg = SurfelMeshingConfig(max_surfel_count=1_000_000,
                              active_surfel_budget=-1,
                              adaptive_creation_bound=factor)
    camera = default_camera(640, 480)
    pipes = (ReconstructionPipeline(cfg, camera, "cpu"),
             JaxPipeline(cfg, camera))
    port, ref = pipes
    policy = port.policy
    policy.confirmed_count, policy.unconfirmed_frames = confirmed, in_flight
    ref._confirmed_count, ref._unconfirmed_frames = confirmed, in_flight
    policy.lagged_active_tiles, policy.growth_window = tiles, list(growth)
    ref._lagged_active_tiles, ref._growth_window = tiles, list(growth)
    budgets = [policy.auto_budget(port.state.pack.shape[0]),
               ref._auto_budget()]
    assert budgets[0] == budgets[1]
    assert budgets[0] % 4096 == 0 and budgets[0] <= 1_003_520


def test_skipping_budget_matches_jax():
    """A working set of 8 tiles of 128 rows under a map of ~14 live tiles
    skips tiles; two such frames after four full-shape ones, the port and
    eager JAX from the same states."""
    cam, frames = sequence_inputs("arc", 6)
    base = base_params(cam)
    state = run_port(TF.create_surfel_state(8192, "cpu"), frames[:4], base)
    tiled = dataclasses.replace(base, active_surfel_budget=1024,
                                tile_size=128, max_creations_per_frame=256)
    jstate = to_jax(state)
    for i, inputs in frames[4:]:
        state = TF.integrate_frame(state, *inputs, i, tiled)
        jstate = jax_step(jstate, inputs, i, tiled)
        got = TF.state_to_numpy(state)
        for name in COUNTERS:
            assert int(got[name]) == int(getattr(jstate, name)), name
        np.testing.assert_array_equal(got["neighbors"],
                                      np.asarray(jstate.neighbors))
        want_pack = np.asarray(jstate.pack)
        for c in EXACT_COLS:
            np.testing.assert_array_equal(got["pack"][:, c].view(np.int32),
                                          want_pack[:, c].view(np.int32),
                                          err_msg=f"col {c}")
        assert_pack_close(got["pack"], want_pack, f"frame {i}")
        np.testing.assert_allclose(got["nbr_dist"],
                                   np.asarray(jstate.nbr_dist),
                                   rtol=3e-5, atol=3e-6)
    assert int(state.skipped_tile_count) > 0
    assert int(state.active_tile_count) > 8


@pytest.mark.parametrize("capacity,budget", [(8000, 4096), (8192, 512)])
def test_tiling_errors_match_jax(capacity, budget):
    """Capacity not a multiple of the tile size, and a budget below the
    creation frontier: the same ValueError as the JAX package."""
    cam, frames = sequence_inputs("arc", 1)
    params = base_params(cam, active_surfel_budget=budget, tile_size=256,
                         max_creations_per_frame=1024)
    (i, inputs), = frames
    with pytest.raises(ValueError) as got:
        TF.integrate_frame(TF.create_surfel_state(capacity, "cpu"), *inputs,
                           i, params)
    with pytest.raises(ValueError) as want:
        jax_step(JF.create_surfel_state(capacity), inputs, i, params)
    assert str(got.value) == str(want.value)
