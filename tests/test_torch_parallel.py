"""The port's scale-out (surfelmeshing_tpu_torch/parallel) against its own
single-sequence step and against the JAX package's parallel modules.

- Batched step: every sequence's state equals integrate_frame on that
  sequence alone, bit for bit; against JAX's make_batched_step (jitted,
  on a 2-device slice of the conftest mesh) as its test says.
- Batched preprocessing: bit for bit against per-sequence preprocess_frame,
  and against JAX's jitted make_batched_preprocess bit for bit or, failing
  that, within 1 depth unit (`batched_preprocess_parity` records which).
- Sharded map: 2 spawned gloo ranks on the CPU against the unsharded
  integrate_frame, bit for bit, over 3 frames whose first creates rows on
  both shards, in the default mode and the reference-parity modes that
  sharding supports.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from surfelmeshing_tpu.ops.fusion import FusionParams as JaxParams
from surfelmeshing_tpu.parallel import batch as JB
from surfelmeshing_tpu_torch.app.multi_sequence import LockstepBatch
from surfelmeshing_tpu_torch.config import SurfelMeshingConfig
from surfelmeshing_tpu_torch.io.synthetic import synthetic_rgbd_video
from surfelmeshing_tpu_torch.ops import fusion as TF
from surfelmeshing_tpu_torch.ops import preprocess as TP
from surfelmeshing_tpu_torch.parallel import batch, shard

from test_golden_fusion import assert_pack_close

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
H, W = 24, 32
SCALE = 5000.0
IDENT = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]], np.float32)
STATE_FIELDS = ("pack", "neighbors", "nbr_dist", "surfel_count",
                "merge_count", "overflow_count")


def jax_params(h=H, w=W, **kw) -> JaxParams:
    return JaxParams(width=w, height=h, fx=30.0, fy=30.0, cx=w / 2 + 0.5,
                     cy=h / 2 + 0.5, depth_scaling=SCALE, do_blending=True,
                     regularization_iterations=1, **kw)


def frame_inputs(rng, frame, h=H, w=W, s=None):
    """One frame's fusion inputs as numpy arrays (a leading sequence axis
    of length s when s is given): noisy depth around a plane that moves
    200 units a frame, flat normals, constant radii, random colors."""
    lead = () if s is None else (s,)
    depth = (10000 + 200 * frame +
             rng.integers(-300, 300, lead + (h, w))).astype(np.uint16)
    if s is not None:
        depth += (500 * np.arange(s, dtype=np.uint16))[:, None, None]
    return (depth, np.zeros(lead + (2, h, w), np.float32),
            np.full(lead + (h, w), 0.01, np.float32),
            rng.integers(0, 255, lead + (3, h, w)).astype(np.uint8),
            np.broadcast_to(IDENT, lead + (3, 4)).copy(),
            np.broadcast_to(IDENT, lead + (3, 4)).copy())


def to_torch(arrays, device="cpu"):
    return tuple(torch.from_numpy(np.asarray(a).astype(
        np.int32 if a.dtype == np.uint16 else a.dtype)).to(device)
        for a in arrays)


def assert_states_equal(got: dict, want: dict, label: str):
    for k in STATE_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(got[k]).view(np.int32),
            np.asarray(want[k]).view(np.int32), err_msg=f"{label}: {k}")


def mean_nearest_distance(a: np.ndarray, b: np.ndarray) -> float:
    d = torch.cdist(torch.from_numpy(a).double(), torch.from_numpy(b).double())
    return float(d.min(dim=1).values.mean())


def run_batched_port(params, inputs_per_frame, capacity, device="cpu",
                     frame_indices=None):
    s = inputs_per_frame[0][0].shape[0]
    step = batch.make_batched_step(params, device)
    states = batch.create_batched_state(s, capacity, device)
    totals = []
    if frame_indices is None:
        frame_indices = range(len(inputs_per_frame))
    for frame, inputs in zip(frame_indices, inputs_per_frame):
        states, total = step(states, *to_torch(inputs), frame)
        totals.append(total)
    return states, totals


def test_batched_step_matches_single_sequence():
    params = TF.params_from(jax_params())
    rng = np.random.default_rng(11)
    frames = [frame_inputs(rng, f, s=3) for f in range(2)]
    states, totals = run_batched_port(params, frames, 2048)
    assert totals[-1].device.type == "cpu" and totals[-1].dtype == torch.int32
    assert int(totals[-1]) == sum(int(st.surfel_count) for st in states)
    for s, st in enumerate(states):
        alone = TF.create_surfel_state(2048, "cpu")
        for frame, inputs in enumerate(frames):
            alone = TF.integrate_frame(
                alone, *to_torch(a[s] for a in inputs), frame, params)
        assert int(alone.surfel_count) > 0
        assert_states_equal(TF.state_to_numpy(st), TF.state_to_numpy(alone),
                            f"sequence {s}")


def scene_frames(s_pairs, frames=8, w=64, h=48):
    """Preprocessed fusion inputs (numpy, leading sequence axis) of
    synthetic videos, one per (scene, trajectory) pair, through the port's
    lockstep batch (its preprocessing equals eager JAX's bit for bit);
    -> (the batch's FusionParams, [inputs per fused frame])."""
    videos = [synthetic_rgbd_video(frames, w, h, noise_sigma=0.002,
                                   scene=scene, trajectory=trajectory)[0]
              for scene, trajectory in s_pairs]
    cfg = SurfelMeshingConfig(max_surfel_count=16384,
                              outlier_filtering_frame_count=2,
                              restrict_fps_to=0)
    lock = LockstepBatch(videos, cfg, "cpu")
    assert len(set(lock.params)) == 1     # one camera for all sequences
    inputs = []
    for i in lock.frame_range():
        arrays = [t.numpy() for t in lock.frame_inputs(lock.assemble(i))]
        arrays[0] = arrays[0].astype(np.uint16)
        inputs.append(tuple(arrays))
    return lock.params[0], inputs


def test_batched_step_matches_jax(record_property):
    """Two synthetic sequences, six fused frames, every one passed as frame
    index 0: JAX's make_batched_step stamps every frame as frame 0 whatever
    index it is given (ROADMAP queue 3), so both sides fuse the same
    function.  Counts and the stamp, creation, detach, confidence and color
    columns must be equal.  The continuous columns are held to
    assert_pack_close or, where jitted XLA's fused arithmetic moves a value
    past it, to a mean nearest-surfel distance under 0.5 mm.  Neighbor
    slots are compared and the differing ones counted, not required equal:
    jitted XLA also flips near-tie slot choices (its own eager run differs
    from it there, and the port equals the eager run, test_torch_fusion).
    `batched_parity` records what held per sequence."""
    params, frames = scene_frames([("default", "arc"),
                                   ("occlusion", "lookaway")])
    jparams = JaxParams(**{f.name: getattr(params, f.name)
                           for f in dataclasses.fields(TF.FusionParams)})
    states, totals = run_batched_port(params, frames, 16384,
                                      frame_indices=[0] * len(frames))
    mesh = Mesh(np.array(jax.devices()[:2]), ("seq",))
    jstate = JB.create_batched_state(2, 16384, mesh)
    jstep = JB.make_batched_step(jparams, mesh)
    for inputs in frames:
        jstate, jtotal = jstep(jstate, *(jnp.asarray(a) for a in inputs),
                               jnp.int32(0))
    assert int(jtotal) == int(totals[-1])

    held = []
    for s, st in enumerate(states):
        got = TF.state_to_numpy(st)
        count = int(got["surfel_count"])
        assert count == int(jstate.surfel_count[s]) > 500
        assert int(got["merge_count"]) == int(jstate.merge_count[s])
        assert int(got["overflow_count"]) == int(jstate.overflow_count[s])
        want = np.asarray(jstate.pack[s])
        for c in (TF.STAMP, TF.CREATION, TF.DETACH, TF.CONF, TF.CR, TF.CG,
                  TF.CB):
            np.testing.assert_array_equal(
                got["pack"][:count, c].view(np.int32),
                want[:count, c].view(np.int32), err_msg=f"col {c}")
        slots = int((got["neighbors"] != np.asarray(jstate.neighbors[s]))
                    .sum())
        try:
            assert_pack_close(got["pack"][:count], want[:count],
                              f"sequence {s}")
            cont = "assert_pack_close"
        except AssertionError:
            live = want[:count, TF.RAD] >= 0
            dist = mean_nearest_distance(
                got["pack"][:count][live][:, TF.SX:TF.SZ + 1],
                want[:count][live][:, TF.SX:TF.SZ + 1])
            assert dist < 5e-4
            cont = f"fallback (mean nearest distance {dist:.2e} m)"
        held.append(f"sequence {s}: {slots} of {4 * count} neighbor slots "
                    f"differ; continuous columns {cont}")
    record_property("batched_parity", "; ".join(held))


PP_KWARGS = dict(sigma_xy=3.0, sigma_value_factor=0.05, radius_factor=2.0,
                 max_depth_u16=30000, depth_valid_region_radius=1000.0,
                 tolerance=0.02, required_inliers=None, erosion_radius=1,
                 observation_angle_threshold_deg=85.0, depth_scaling=SCALE,
                 point_radius_extension_factor=1.5,
                 point_radius_clamp_factor=np.inf,
                 fx=30.0, fy=30.0, cx=W / 2 + 0.5, cy=H / 2 + 0.5)


def test_batched_preprocess_matches_single_and_jax(record_property):
    s, k = 4, 2
    rng = np.random.default_rng(0)
    depth = (10000 + rng.integers(-500, 500, (s, H, W))).astype(np.uint16)
    others = (10000 + rng.integers(-500, 500, (s, k, H, W))).astype(np.uint16)
    transforms = np.tile(IDENT, (s, k, 1, 1))
    pre = batch.make_batched_preprocess(PP_KWARGS, "cpu")
    got = pre(*to_torch((depth, others, transforms)))
    assert all(o.shape[0] == s for o in got)
    for i in range(s):
        alone = TP.preprocess_frame(*to_torch((depth[i], others[i],
                                               transforms[i])), **PP_KWARGS)
        for g, a in zip(got, alone):
            assert torch.equal(g[i], a)

    mesh = Mesh(np.array(jax.devices()[:s]), ("seq",))
    want = JB.make_batched_preprocess(PP_KWARGS, mesh)(
        jnp.asarray(depth), jnp.asarray(others), jnp.asarray(transforms))
    d_got, d_want = got[0].numpy(), np.asarray(want[0]).astype(np.int32)
    if all(np.array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))
           for g, w in zip(got, want)):
        held = "bit for bit"
    else:
        assert np.abs(d_got - d_want).max() <= 1
        held = (f"within 1 depth unit ({int((d_got != d_want).sum())} "
                f"pixels differ)")
    record_property("batched_preprocess_parity", held)


SHARD_H, SHARD_W, SHARD_CAPACITY = 48, 64, 4096
SHARD_MODES = {
    "defaults": {},
    "exact_conflict_arbitration": dict(exact_conflict_arbitration=True),
    "fast_neighbor_update_off": dict(fast_neighbor_update=False),
    "regularization_iterations_2": dict(regularization_iterations=2),
}


@pytest.mark.parametrize("mode", list(SHARD_MODES))
def test_sharded_map_matches_unsharded(mode, tmp_path):
    """At 64x48 frame 0 creates 62 * 46 = 2852 surfels, past rank 0's 2048
    rows, so both ranks own created rows from the first frame on."""
    params = dataclasses.replace(TF.params_from(jax_params(SHARD_H, SHARD_W)),
                                 **SHARD_MODES[mode])
    rng = np.random.default_rng(3)
    frames = [frame_inputs(rng, f, SHARD_H, SHARD_W) + (f,)
              for f in range(3)]
    ref = TF.create_surfel_state(SHARD_CAPACITY, "cpu")
    for f in frames:
        ref = TF.integrate_frame(ref, *to_torch(f[:6]), f[6], params)
        if f[6] == 0:
            assert int(ref.surfel_count) > SHARD_CAPACITY // 2
    got = shard.spawn_sharded(params, SHARD_CAPACITY, frames, 2, "cpu",
                              workdir=str(tmp_path), timeout=240)
    assert int(ref.merge_count) > 0 or mode != "defaults"
    assert_states_equal(got, TF.state_to_numpy(ref), mode)
    assert got["frame_seconds"].shape == (3,)


@pytest.fixture
def fake_group():
    """A 2-rank process group in this process (torch's fake backend: no
    collective runs), for the checks made before any collective."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    import torch.distributed as dist
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_sharded_state_refuses_uneven_capacity(fake_group):
    assert shard.create_sharded_state(4096, fake_group, "cpu") \
        .pack.shape[0] == 2048
    with pytest.raises(ValueError, match="divide"):
        shard.create_sharded_state(4095, fake_group, "cpu")


@pytest.mark.parametrize("kw", [dict(active_surfel_budget=4096),
                                dict(active_surfel_budget=-1),
                                dict(symmetric_regularization=False)],
                         ids=["budget", "auto_budget", "asymmetric"])
def test_sharded_step_refuses_unsupported_modes(kw):
    params = dataclasses.replace(TF.params_from(jax_params()), **kw)
    with pytest.raises(ValueError):
        shard.make_sharded_step(params)


def run_module(module, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_dryrun_on_cpu():
    out = run_module("surfelmeshing_tpu_torch.parallel.dryrun", "--ranks",
                     "2", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "bit-identical" in out.stdout


def test_entry_points_default_to_cuda():
    """Without --device the dry run asks for the card, and fails without
    one rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = run_module("surfelmeshing_tpu_torch.parallel.dryrun", "--ranks",
                     "2")
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batch.make_batched_step(TF.params_from(jax_params()), "cuda")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_batched_step_on_card_matches_cpu(cuda_device):
    params = TF.params_from(jax_params())
    rng = np.random.default_rng(11)
    frames = [frame_inputs(rng, f, s=3) for f in range(2)]
    gpu, gpu_totals = run_batched_port(params, frames, 2048, cuda_device)
    cpu, cpu_totals = run_batched_port(params, frames, 2048)
    assert int(gpu_totals[-1]) == int(cpu_totals[-1])
    for s, (g, c) in enumerate(zip(gpu, cpu)):
        assert_states_equal(TF.state_to_numpy(g), TF.state_to_numpy(c),
                            f"sequence {s}")
