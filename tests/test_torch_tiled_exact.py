"""Active-set tiling equals the full route past the regularisation window
(ops/fusion.py::_integrate_tiled, ops/tiling.py), on the CPU, with no
JAX.

64x48 frames of SyntheticRGBDSequence on the look-away trajectory (the
camera pans away and back), with the regularisation window cut to 3
frames, so rows leave the window, neighbours age out of it and merges
leave tombstones within the run.  Tiles of 16 rows under a budget that
skips none: the working set holds a subset of the live tiles, and the
tiled route must equal the full route bit for bit after every frame
(pack, neighbors, nbr_dist and every counter), per frame through
integrate_frame and chunked (frame_chunk 4) through the pipeline's auto
budget.  The tile flags hold every row the full route changes on a frame.

The frames are preprocessed once by the port (tests/test_torch_tiled.py
holds the same helpers beside the JAX package's).
"""

import dataclasses

import numpy as np
import pytest
import torch

from surfelmeshing_tpu_torch.config import SurfelMeshingConfig
from surfelmeshing_tpu_torch.io.synthetic import (SyntheticRGBDSequence,
                                                  synthetic_rgbd_video)
from surfelmeshing_tpu_torch.ops import fusion as TF
from surfelmeshing_tpu_torch.ops import preprocess as TP
from surfelmeshing_tpu_torch.ops import tiling
from surfelmeshing_tpu_torch.pipeline import ReconstructionPipeline

torch.set_num_threads(1)

W, H, SCALE = 64, 48, 5000.0
FRAMES, WINDOW, TILE, CREATIONS = 40, 3, 16, 128
CAPACITY, BUDGET = 8192, 4096
COUNTERS = ("surfel_count", "merge_count", "overflow_count",
            "deferred_count", "skipped_tile_count")


@pytest.fixture(scope="module")
def frames():
    """(camera, [(i, (depth, normals, radius, color, T_gl, T_lg))]) for
    frames 1..FRAMES, noisy depth, preprocessed with
    tests/test_torch_tiled.py's settings."""
    seq = SyntheticRGBDSequence(num_frames=FRAMES + 2, width=W, height=H,
                                trajectory="lookaway", noise_sigma=0.002)
    cam = seq.camera
    out = []
    for i in range(1, FRAMES + 1):
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


def full_params(cam, **kw) -> TF.FusionParams:
    return TF.FusionParams(width=W, height=H, fx=cam.fx, fy=cam.fy,
                           cx=cam.cx, cy=cam.cy, depth_scaling=SCALE,
                           max_creations_per_frame=CREATIONS,
                           regularization_frame_window_size=WINDOW, **kw)


def bits(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.numpy()).view(np.int32)


def mismatch(got: TF.SurfelState, want: TF.SurfelState) -> dict:
    """Words of each map tensor and each counter that differ."""
    out = {name: int((bits(getattr(got, name)) !=
                      bits(getattr(want, name))).sum())
           for name in ("pack", "neighbors", "nbr_dist")}
    out.update({name: int(getattr(got, name)) != int(getattr(want, name))
                for name in COUNTERS})
    return {k: v for k, v in out.items() if v}


def stale_rows(state: TF.SurfelState, frame: int) -> int:
    """Live rows whose update stamp has left the regularisation window."""
    n = int(state.surfel_count)
    return int((TF.update_stamps(state)[:n] < frame - WINDOW).sum())


@pytest.mark.parametrize("fast", [True, False],
                         ids=["fast_neighbor_update", "detach_sweep"])
def test_tiled_equals_full_frame_by_frame(frames, fast):
    """integrate_frame with a budget of 256 tiles of 16 rows against the
    full route, compared after every frame; the map ages past the window
    and merges, and the working set leaves live tiles out."""
    cam, inputs = frames
    full_p = full_params(cam, fast_neighbor_update=fast)
    tiled_p = dataclasses.replace(full_p, active_surfel_budget=BUDGET,
                                  tile_size=TILE)
    full = TF.create_surfel_state(CAPACITY, "cpu")
    tiled = TF.create_surfel_state(CAPACITY, "cpu")
    left_out = stale = 0
    for i, inp in inputs:
        full = TF.integrate_frame(full, *inp, i, full_p)
        tiled = TF.integrate_frame(tiled, *inp, i, tiled_p)
        assert mismatch(tiled, full) == {}, f"frame {i}"
        live_tiles = -(-int(full.surfel_count) // TILE)
        frontier = CREATIONS // TILE + 1
        left_out = max(left_out, live_tiles + frontier -
                       int(tiled.active_tile_count))
        stale = max(stale, stale_rows(full, i))
    assert int(tiled.skipped_tile_count) == 0
    assert int(full.merge_count) > 50
    assert stale > 500
    assert left_out > 5


def test_auto_budget_chunked_equals_full(frames):
    """The pipeline's auto budget (-1) with frame_chunk 4 against the
    count-sized pipeline with frame_chunk 4, compared after every chunk
    (reading the state flushes it); the auto budget falls below the
    capacity once the first demand is read back."""
    cfg = SurfelMeshingConfig(max_surfel_count=CAPACITY,
                              outlier_filtering_frame_count=2,
                              max_creations_per_frame=CREATIONS,
                              regularization_frame_window_size=WINDOW,
                              shape_bucket_step=1024, frame_chunk=4,
                              restrict_fps_to=0)
    video, _ = synthetic_rgbd_video(FRAMES, W, H, noise_sigma=0.002,
                                    trajectory="lookaway")
    pipes = []
    for budget in (0, -1):
        pipe = ReconstructionPipeline(
            dataclasses.replace(cfg, active_surfel_budget=budget),
            video.depth_camera, "cpu")
        pipe.fusion_params = dataclasses.replace(pipe.fusion_params,
                                                 tile_size=TILE)
        pipes.append(pipe)
    full, auto = pipes
    budgets = []
    for i in range(video.frame_count):
        for pipe in pipes:
            pipe.process_frame(video, i)
        if (i + 1) % 4 == 0:
            assert mismatch(auto.state, full.state) == {}, f"frame {i}"
            budgets.append(auto.active_budget())
    assert len(budgets) == FRAMES // 4
    assert int(auto.state.skipped_tile_count) == 0
    assert {n_eff for _, n_eff in auto.policy.picks} == {CAPACITY}
    assert min(budgets[1:]) < CAPACITY, budgets
    assert min(p[1] for p in full.policy.picks) < CAPACITY
    assert stale_rows(full.state, video.frame_count - 1) > 0
    assert int(full.state.merge_count) > 0


def test_flags_hold_every_row_the_full_route_changes(frames):
    """Before each frame, the plain flags (tiling.row_flags_reference)
    hold every live row that the full route's frame changes (a word of
    its pack row, a slot or a slot distance), and leave some live rows
    out; the rule of in-image or in-window rows alone misses changed
    rows."""
    cam, inputs = frames
    params = full_params(cam)
    state = TF.create_surfel_state(CAPACITY, "cpu")
    missed_by_old = unflagged = 0
    for i, inp in inputs:
        n = int(state.surfel_count)
        flags = tiling.row_flags_reference(
            params, state.pack, state.neighbors, state.surfel_count,
            inp[5], i)[:n].numpy()
        old = (tiling._in_view(params, inp[5], *state.pack[:, :3].unbind(1))
               | (TF.update_stamps(state) >=
                  i - WINDOW))[:n].numpy()
        before = [bits(t).copy() for t in (state.pack, state.neighbors,
                                           state.nbr_dist)]
        state = TF.integrate_frame(state, *inp, i, params)
        after = [bits(t) for t in (state.pack, state.neighbors,
                                   state.nbr_dist)]
        changed = (before[0] != after[0]).any(axis=1)
        for b, a in zip(before[1:], after[1:]):
            changed |= (b != a).any(axis=0)
        changed = changed[:n]
        assert not (changed & ~flags).any(), \
            f"frame {i}: {np.nonzero(changed & ~flags)[0][:10]}"
        missed_by_old += int((changed & ~old).sum())
        unflagged += int((~flags).sum())
    assert missed_by_old > 0
    assert unflagged > 0
