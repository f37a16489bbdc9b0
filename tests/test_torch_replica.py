"""The port at the Replica deployment's camera cut by 8 against the JAX
package: 150x85 frames, fx = fy = 75, principal point 75.0, 42.5, depth
unit 6553.5, an open valid region (benchmark/configs/replica1200_20m.json
at 1/64 of its pixels).

- The port's fusion step, as its pipeline dispatches it per frame and in
  chunks of 4 (count-sized buckets, a creation budget of 2048 that
  binds), equals the JAX package's integrate_frame_bucketed run eagerly
  on the same preprocessed frames, bit for bit, frame by frame over 12
  fused frames of a seeded synthetic video.
- Where the bucket defers creations, the port's overflow_count plus its
  deferred_count equals the JAX package's overflow_count, which counts
  the creations past the bucket as dropped (the port counts only those
  past the capacity as dropped).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import surfelmeshing_tpu_torch.chunk as CH
import surfelmeshing_tpu_torch.pipeline as PL
from surfelmeshing_tpu.ops import fusion as JF
from surfelmeshing_tpu_torch.ops import fusion as TF

from test_torch_replica_kernels import replica_config, replica_video

torch.set_num_threads(1)

CAP, STEP, BUDGET = 65536, 16384, 2048
FRAMES = 14                 # 12 fused with the 2-frame outlier window
WORDS = ("pack", "neighbors", "nbr_dist")
COUNTERS = ("surfel_count", "merge_count", "overflow_count")


def host(state: TF.SurfelState) -> dict:
    """A copy of a port state (the map's tensors are written in place)."""
    return {k: np.array(v, copy=True)
            for k, v in TF.state_to_numpy(state).items()}


def run_recorded(chunk: int, video) -> tuple:
    """The port's pipeline over the video: -> (pipe, [(inputs, n_eff)],
    [state after each frame]) from every fusion step it dispatched."""
    steps, states = [], []
    fuse = TF.integrate_frame_bucketed

    def record(state, d, nrm, rad, color, t_gl, t_lg, frame, params, n_eff,
               *rest):
        inputs = tuple(t.clone() for t in (d, nrm, rad, color, t_gl, t_lg))
        steps.append((inputs + (int(frame),), n_eff))
        out = fuse(state, d, nrm, rad, color, t_gl, t_lg, frame, params,
                   n_eff, *rest)
        states.append(host(out))
        return out

    cfg = replica_config(max_surfel_count=CAP, shape_bucket_step=STEP,
                         max_creations_per_frame=BUDGET, frame_chunk=chunk)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PL, "integrate_frame_bucketed", record)
        mp.setattr(CH, "integrate_frame_bucketed", record)
        pipe = PL.ReconstructionPipeline(cfg, video.depth_camera, "cpu")
        for i in range(video.frame_count):
            pipe.process_frame(video, i)
        pipe.drain()
    return pipe, steps, states


def to_jax(state: dict) -> JF.SurfelState:
    return JF.SurfelState(**{k: jnp.asarray(state[k])
                             for k in JF.SurfelState._fields})


def jax_step(jstate, inputs, params, n_eff):
    """The JAX package's integrate_frame_bucketed, eagerly."""
    d, nrm, rad, color, t_gl, t_lg, frame = inputs
    with jax.disable_jit():
        return JF.integrate_frame_bucketed(
            jstate, jnp.asarray(d.numpy().astype(np.uint16)),
            jnp.asarray(nrm.numpy()), jnp.asarray(rad.numpy()),
            jnp.asarray(color.numpy()), jnp.asarray(t_gl.numpy()),
            jnp.asarray(t_lg.numpy()), jnp.int32(frame),
            JF.FusionParams(**dataclasses.asdict(params)), n_eff)


def assert_equals_jax(got: dict, want: JF.SurfelState, label,
                      counters=COUNTERS):
    for name in WORDS:
        np.testing.assert_array_equal(
            np.ascontiguousarray(got[name]).view(np.int32),
            np.ascontiguousarray(np.asarray(getattr(want, name)))
            .view(np.int32), f"{label}: {name}")
    for name in counters:
        assert int(got[name]) == int(getattr(want, name)), (label, name)


@pytest.fixture(scope="module")
def runs():
    """Per frame and frame_chunk 4 over one video, and the JAX package's
    states over the per-frame run's inputs and buckets."""
    video = replica_video(FRAMES, cut=8)
    one = run_recorded(1, video)
    four = run_recorded(4, video)
    params = one[0].fusion_params
    jstate = to_jax(host(TF.create_surfel_state(CAP, "cpu")))
    jstates = []
    for inputs, n_eff in one[1]:
        jstate = jax_step(jstate, inputs, params, n_eff)
        jstates.append(jstate)
    return one, four, jstates


def test_camera_and_frames_are_the_cut_deployment(runs):
    (pipe, steps, _), _, _ = runs
    p = pipe.fusion_params
    assert (p.width, p.height, p.fx, p.fy, p.cx, p.cy, p.depth_scaling) == \
        (150, 85, 75.0, 75.0, 75.0, 42.5, 6553.5)
    assert [inputs[-1] for inputs, _ in steps] == list(range(1, 13))
    assert all(n_eff < CAP for _, n_eff in steps)    # count-sized


def test_frame_step_per_frame_equals_jax(runs):
    (pipe, steps, states), _, jstates = runs
    for k, (got, want) in enumerate(zip(states, jstates)):
        assert_equals_jax(got, want, f"frame {steps[k][0][-1]}")
    # The budget binds: each frame made its 2048 creations and deferred
    # the rest of a first view.
    assert int(pipe.state.surfel_count) < 12 * BUDGET
    assert int(states[0]["surfel_count"]) == BUDGET
    assert int(pipe.state.deferred_count) > 0


def test_frame_step_chunked_equals_jax(runs):
    """Chunks of 4 (other buckets than per frame: the count bound covers
    4 frames) give every frame the per-frame run's inputs and the JAX
    package's state."""
    (_, steps, _), (pipe, chunk_steps, states), jstates = runs
    assert [s for s, _ in pipe.bucket_pick_log] == [4, 4, 4]
    assert len(chunk_steps) == len(steps) == len(jstates) == 12
    for (a, _), (b, _) in zip(chunk_steps, steps):
        assert a[-1] == b[-1]
        for x, y in zip(a[:-1], b[:-1]):
            assert torch.equal(x, y)
    for k, (got, want) in enumerate(zip(states, jstates)):
        assert_equals_jax(got, want, f"chunked frame {chunk_steps[k][0][-1]}")
    assert int(pipe.state.deferred_count) == \
        int(runs[0][0].state.deferred_count)


@pytest.mark.parametrize("capacity", [CAP, 6144])
def test_overflow_plus_deferred_equals_jax_overflow(runs, capacity):
    """Four frames into a bucket of 6144 rows that binds on the first
    (a first view flags ~6.6k pixels) with a budget that does not: the
    JAX package counts every creation the bucket leaves out as overflow;
    the port counts them as deferred, and only those past the capacity
    (here the whole map, or a map of the bucket's own rows) as
    overflow."""
    (pipe, steps, _), _, _ = runs
    params = dataclasses.replace(pipe.fusion_params,
                                 max_creations_per_frame=2 ** 15)
    state = TF.create_surfel_state(capacity, "cpu")
    jstate = to_jax(host(state))
    for inputs, _ in steps[:4]:
        state = TF.integrate_frame_bucketed(state, *inputs, params, 6144)
        jstate = jax_step(jstate, inputs, params, 6144)
        assert int(state.surfel_count) == int(jstate.surfel_count)
        assert int(state.overflow_count) + int(state.deferred_count) == \
            int(jstate.overflow_count)
    assert int(state.surfel_count) == 6144
    assert int(jstate.overflow_count) > 0
    if capacity == CAP:
        assert int(state.overflow_count) == 0
    else:
        assert int(state.deferred_count) == 0
    # The maps are equal bit for bit; the overflow counts differ as above.
    assert_equals_jax(host(state), jstate, f"capacity {capacity}",
                      COUNTERS[:2])
