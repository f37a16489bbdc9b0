"""Meshing snapshots, standalone regularization, point-cloud export and
checkpoints of the port against the JAX package, bit for bit, on one
multi-frame state.

The state comes from the port's pipeline over 6 fused frames of a 64x48
synthetic video (2-frame outlier window), with two rows turned into merge
tombstones; the JAX side gets the same arrays.  JAX runs eagerly
(jax.disable_jit), as in test_torch_fusion.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfelmeshing_tpu.config import SurfelMeshingConfig
from surfelmeshing_tpu.io import checkpoint as jax_checkpoint
from surfelmeshing_tpu.io.synthetic import synthetic_rgbd_video
from surfelmeshing_tpu.ops import fusion as JF
from surfelmeshing_tpu.pipeline import ReconstructionPipeline as JaxPipeline
from surfelmeshing_tpu_torch.io import checkpoint
from surfelmeshing_tpu_torch.ops import fusion as TF
from surfelmeshing_tpu_torch.pipeline import ReconstructionPipeline

torch.set_num_threads(1)

W, H, FRAMES = 64, 48, 8
CONFIG = SurfelMeshingConfig(max_surfel_count=8192,
                             outlier_filtering_frame_count=2,
                             restrict_fps_to=0)
TOMBSTONES = (5, 17)


def bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.int32)


def to_jax(state):
    host = TF.state_to_numpy(state)
    return JF.SurfelState(**{k: jnp.asarray(host[k])
                             for k in JF.SurfelState._fields})


@pytest.fixture(scope="module")
def run():
    video, _ = synthetic_rgbd_video(FRAMES, W, H, noise_sigma=0.002)
    pipe = ReconstructionPipeline(CONFIG, video.depth_camera, "cpu")
    fused = [i for i in range(FRAMES)
             if pipe.process_frame(video, i) is not None]
    assert fused == list(range(1, FRAMES - 1))
    pack = pipe.state.pack.clone()
    for row in TOMBSTONES:
        pack[row, TF.RAD] = -1.0
        pack.view(torch.int32)[row, TF.STAMP] = 0
    pipe.state = dataclasses.replace(pipe.state, pack=pack)
    return pipe, video


@pytest.mark.parametrize("last,window", [(3, 1), (5, 1), (5, 30)])
def test_snapshot_delta_matches_jax(run, last, window):
    pipe, _ = run
    idx, pos, rad, nrm, stamps, total, count = TF.meshing_snapshot_delta(
        pipe.state, last, window)
    n = pipe.state.pack.shape[0]
    with jax.disable_jit():
        want = JF.meshing_snapshot_delta(to_jax(pipe.state), jnp.int32(last),
                                         window, n)
    j_total = int(want[5])
    assert total == j_total > len(TOMBSTONES)
    assert int(count) == int(want[6]) == pipe.surfel_count()
    for got, w in zip((idx, pos, rad, nrm, stamps), want[:5]):
        np.testing.assert_array_equal(bits(got), bits(w[:j_total]))
    assert (np.diff(idx.numpy()) > 0).all()
    assert set(TOMBSTONES) <= set(idx.tolist())
    if window == 1:
        assert total < pipe.surfel_count()     # a true subset


def test_snapshot_for_meshing_full_then_delta_matches_jax(run):
    pipe, video = run
    jax_pipe = JaxPipeline(CONFIG, video.depth_camera)
    jax_pipe.state = to_jax(pipe.state)
    pipe._last_snap_frame = None
    before = (pipe.snapshot_rows_shipped, pipe.snapshot_count)
    full = pipe.snapshot_for_meshing(4)
    j_full = jax_pipe.snapshot_for_meshing(4)
    assert full[0] == j_full[0] == "full"
    for got, want in zip(full[1:], j_full[1:]):
        np.testing.assert_array_equal(bits(got), bits(want))
    delta = pipe.snapshot_for_meshing(6)
    j_delta = jax_pipe.snapshot_for_meshing(6)
    assert delta[0] == j_delta[0] == "delta"
    for got, want in zip(delta[1:6], j_delta[1:6]):
        np.testing.assert_array_equal(bits(got), bits(want))
    assert delta[6] == j_delta[6] == pipe.surfel_count()
    assert pipe.snapshot_count - before[1] == 2
    assert pipe.snapshot_rows_shipped - before[0] == \
        full[5] + len(delta[1]) == jax_pipe.snapshot_rows_shipped
    assert pipe.timing.stats("surfel_transfer").count >= 2


def test_snapshot_without_delta_transfer_is_always_full(run):
    pipe, video = run
    cfg = dataclasses.replace(CONFIG, delta_surfel_transfer=False)
    other = ReconstructionPipeline(cfg, video.depth_camera, "cpu")
    other.state = pipe.state
    tags = [other.snapshot_for_meshing(f)[0] for f in (3, 4)]
    assert tags == ["full", "full"]
    assert other.snapshot_rows_shipped == 2 * pipe.surfel_count()


@pytest.mark.parametrize("frame", [6, 40])
def test_regularize_only_matches_jax(run, frame):
    pipe, _ = run
    jparams = JF.FusionParams(**dataclasses.asdict(pipe.fusion_params))
    got = TF.regularize_only(pipe.state, frame, pipe.fusion_params)
    with jax.disable_jit():
        want = JF.regularize_only(to_jax(pipe.state), jnp.int32(frame),
                                  jparams)
    for name in ("pack", "neighbors", "nbr_dist"):
        np.testing.assert_array_equal(bits(getattr(got, name)),
                                      bits(getattr(want, name)), name)
    if frame == 6:      # recent surfels moved
        assert not torch.equal(got.pack, pipe.state.pack)


def test_export_point_cloud_same_bytes(run, tmp_path):
    pipe, video = run
    jax_pipe = JaxPipeline(CONFIG, video.depth_camera)
    jax_pipe.state = to_jax(pipe.state)
    n = pipe.export_point_cloud(str(tmp_path / "port.ply"))
    j_n = jax_pipe.export_point_cloud(str(tmp_path / "jax.ply"))
    assert n == j_n <= pipe.surfel_count() - len(TOMBSTONES)
    assert (tmp_path / "port.ply").read_bytes() == \
        (tmp_path / "jax.ply").read_bytes()


def test_checkpoints_interchange_both_ways(run, tmp_path):
    pipe, _ = run
    port_path = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(port_path, pipe.state, 6)
    jstate, frame = jax_checkpoint.load_checkpoint(port_path)
    assert frame == 6
    host = TF.state_to_numpy(pipe.state)
    for name in JF.SurfelState._fields:
        np.testing.assert_array_equal(bits(getattr(jstate, name)),
                                      bits(host[name]), name)
    assert int(jstate.skipped_tile_count) == 0

    jax_path = str(tmp_path / "jax.npz")
    jax_checkpoint.save_checkpoint(jax_path, to_jax(pipe.state), 5)
    tstate, frame = checkpoint.load_checkpoint(jax_path, "cpu")
    assert frame == 5
    for name, value in TF.state_to_numpy(tstate).items():
        # The JAX state has no deferred_count: it loads as 0.
        want = getattr(pipe.state, name) if name in JF.SurfelState._fields \
            else np.zeros((), np.int32)
        np.testing.assert_array_equal(bits(value), bits(want), name)


def test_checkpoint_tile_counters_interchange(run, tmp_path):
    """The tiled path's skipped_tile_count / active_tile_count survive a
    checkpoint both ways."""
    pipe, _ = run
    state = dataclasses.replace(
        pipe.state, skipped_tile_count=torch.tensor(3, dtype=torch.int32),
        active_tile_count=torch.tensor(7, dtype=torch.int32))
    port_path = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(port_path, state, 6)
    jstate, _ = jax_checkpoint.load_checkpoint(port_path)
    assert (int(jstate.skipped_tile_count),
            int(jstate.active_tile_count)) == (3, 7)

    jax_path = str(tmp_path / "jax.npz")
    jax_checkpoint.save_checkpoint(jax_path, to_jax(state)._replace(
        skipped_tile_count=jnp.int32(5), active_tile_count=jnp.int32(9)), 5)
    tstate, _ = checkpoint.load_checkpoint(jax_path, "cpu")
    assert (int(tstate.skipped_tile_count),
            int(tstate.active_tile_count)) == (5, 9)
    assert tstate.skipped_tile_count.dtype == torch.int32
    np.testing.assert_array_equal(bits(tstate.pack), bits(state.pack))


def test_checkpoint_rejects_other_versions(tmp_path):
    path = str(tmp_path / "old.npz")
    np.savez_compressed(path, version=3, frame_index=0)
    with pytest.raises(ValueError):
        checkpoint.load_checkpoint(path, "cpu")
