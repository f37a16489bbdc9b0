"""Fusion parity: the port's integrate_frame vs the JAX package's, phase by
phase, on the same inputs and the same starting state.

The JAX step runs eagerly (jax.disable_jit) with fusion._TAP enabled, as
tests/test_golden_fusion.py runs it; the port fills its `taps` dict with the
same names.  Discrete outputs (counts, stamps, neighbor slots, flags, pixel
maps) must be exactly equal; f32 pack columns agree within assert_pack_close
(rtol 3e-5, atol 3e-6); blended depth within 1 unit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from surfelmeshing_tpu.ops import fusion as JF
from surfelmeshing_tpu_torch.ops import fusion as TF

from test_golden_fusion import (H, IDENT, PARAMS, SCALE, W, assert_pack_close,
                                noisy_wall)

torch.set_num_threads(1)

INVALID = 2 ** 31 - 1
EXACT_TAPS = ("supporting_surfels", "support_counts", "has_conflict",
              "merge_mask", "neighbors_after_integrate",
              "neighbors_after_update", "neighbors_after_create",
              "surfel_count_after_create")


def pose(yaw=0.0, t=(0.0, 0.0, 0.0)):
    """(global_T_local, local_T_global) 3x4 f32 for a yaw + translation."""
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    T = np.concatenate([R, np.asarray(t)[:, None]], axis=1)
    inv = np.concatenate([R.T, -R.T @ np.asarray(t)[:, None]], axis=1)
    return T.astype(np.float32), inv.astype(np.float32)


def jax_step(state, inputs, frame, params, poses=(IDENT, IDENT)):
    depth, normals, radius, color = inputs
    JF._TAP = {}
    try:
        with jax.disable_jit():
            out = JF.integrate_frame(
                state, jnp.asarray(depth), jnp.asarray(normals),
                jnp.asarray(radius), jnp.asarray(color),
                jnp.asarray(poses[0]), jnp.asarray(poses[1]),
                jnp.int32(frame), params)
        taps = {k: np.asarray(v) for k, v in JF._TAP.items()}
    finally:
        JF._TAP = None
    return out, taps


def port_step(state, inputs, frame, params, poses=(IDENT, IDENT)):
    depth, normals, radius, color = inputs
    taps = {}
    out = TF.integrate_frame(
        state, torch.from_numpy(depth.astype(np.int32)),
        torch.from_numpy(normals), torch.from_numpy(radius),
        torch.from_numpy(color), torch.from_numpy(poses[0]),
        torch.from_numpy(poses[1]), frame, TF.params_from(params), taps=taps)
    return out, {k: v.numpy() for k, v in taps.items()}


def to_port(jstate):
    return TF.state_from_numpy(
        np.asarray(jstate.pack), np.asarray(jstate.neighbors),
        np.asarray(jstate.nbr_dist), int(jstate.surfel_count),
        int(jstate.merge_count), int(jstate.overflow_count), "cpu")


def assert_states_match(tstate, jstate, label):
    got = TF.state_to_numpy(tstate)
    assert int(got["surfel_count"]) == int(jstate.surfel_count), label
    assert int(got["merge_count"]) == int(jstate.merge_count), label
    assert int(got["overflow_count"]) == int(jstate.overflow_count), label
    assert_pack_close(got["pack"], np.asarray(jstate.pack), label)
    np.testing.assert_array_equal(got["neighbors"],
                                  np.asarray(jstate.neighbors))
    np.testing.assert_allclose(got["nbr_dist"], np.asarray(jstate.nbr_dist),
                               rtol=3e-5, atol=3e-6)


def compare_frame(jstate, tstate, inputs, frame, params, poses=(IDENT, IDENT)):
    jstate, jt = jax_step(jstate, inputs, frame, params, poses)
    tstate, tt = port_step(tstate, inputs, frame, params, poses)
    assert set(jt) <= set(tt)
    for name in EXACT_TAPS:
        np.testing.assert_array_equal(tt[name], jt[name], err_msg=name)
    np.testing.assert_allclose(tt["first_depth"], jt["first_depth"],
                               rtol=1e-6)
    np.testing.assert_allclose(tt["support_depth_sums"],
                               jt["support_depth_sums"], rtol=1e-6)
    assert np.abs(tt["blended_depth"].astype(np.int64) -
                  jt["blended_depth"].astype(np.int64)).max() <= 1
    for name in ("pack_after_merge", "pack_after_integrate",
                 "pack_after_create"):
        assert_pack_close(tt[name], jt[name], name)
    assert_states_match(tstate, jstate, f"frame {frame}")
    return jstate, tstate


def test_one_frame_all_taps():
    jstate = JF.create_surfel_state(4096)
    tstate = TF.create_surfel_state(4096, "cpu")
    jstate, tstate = compare_frame(jstate, tstate, noisy_wall(seed=0), 0,
                                   PARAMS)
    assert int(tstate.surfel_count) > 100


def test_three_frames_all_taps():
    """Creation, then association / blending / integration / neighbors /
    regularization on a moving camera, hole and no hole."""
    jstate = JF.create_surfel_state(4096)
    tstate = TF.create_surfel_state(4096, "cpu")
    for frame, (seed, hole, yaw, tx) in enumerate(
            [(0, True, 0.0, 0.0), (1, False, 0.01, 0.005),
             (2, True, 0.02, 0.01)]):
        jstate, tstate = compare_frame(jstate, tstate,
                                       noisy_wall(seed=seed, hole=hole),
                                       frame, PARAMS,
                                       pose(yaw, (tx, 0.0, 0.0)))
    assert int(tstate.surfel_count) > 600


def test_conflict_and_merge_paths():
    """A floating surfel (conflict decrement) and a near-duplicate (merge
    tombstone) decide exactly as in JAX."""
    jstate = JF.create_surfel_state(4096)
    inputs = noisy_wall(seed=2, hole=False)
    jstate, _ = jax_step(jstate, inputs, 0, PARAMS)
    count = int(jstate.surfel_count)
    jstate = JF.plant_surfel(jstate, count, pos=[0, 0, 1.0],
                             normal=[0, 0, -1], confidence=1.0,
                             radius_sq=0.001, stamp=0)
    src = count // 2
    p = np.asarray(JF.positions(jstate)[src]) + \
        np.array([1e-5, 0, 0], np.float32)
    jstate = JF.plant_surfel(
        jstate, count + 1, pos=p, normal=np.asarray(JF.normals(jstate)[src]),
        confidence=1.0, radius_sq=float(JF.radii_sq(jstate)[src]), stamp=0)
    jstate = jstate._replace(surfel_count=jnp.int32(count + 2))
    jstate, tstate = compare_frame(jstate, to_port(jstate), inputs, 1,
                                   PARAMS)
    assert int(tstate.merge_count) >= 1


def test_side_pixel_association_without_blending():
    """Slanted wall (off-center projections), blending off, two
    regularization iterations."""
    params = dataclasses.replace(PARAMS, do_blending=False,
                                 regularization_iterations=2)
    rng = np.random.default_rng(5)
    ys = np.arange(H)[:, None]
    depth = (SCALE * (1.8 + 0.3 * ys / H) *
             (1.0 + 0.003 * rng.standard_normal((H, W)))).astype(np.uint16)
    normals = np.stack([np.zeros((H, W), np.float32),
                        np.full((H, W), -0.28, np.float32)])
    radius = np.full((H, W), 0.01, np.float32)
    color = rng.integers(0, 255, (3, H, W)).astype(np.uint8)
    inputs = (depth, normals, radius, color)
    jstate = JF.create_surfel_state(4096)
    tstate = TF.create_surfel_state(4096, "cpu")
    for frame in range(2):
        jstate, tstate = compare_frame(jstate, tstate, inputs, frame, params)


def test_capacity_overflow_and_creation_budget():
    """Creation clamps at capacity (overflow counted) and at the per-frame
    budget (deferred, not counted), slots in row-major pixel order."""
    # Capacity: start 300 slots short of full (empty rows below the count
    # are never associated).
    jstate = JF.create_surfel_state(4096)
    jstate = jstate._replace(surfel_count=jnp.int32(4096 - 300))
    _, tstate = compare_frame(jstate, to_port(jstate), noisy_wall(seed=0), 0,
                              PARAMS)
    assert int(tstate.overflow_count) > 0
    assert int(tstate.surfel_count) == 4096
    # Budget: 100 creations a frame, the rest retried next frame.
    params = dataclasses.replace(PARAMS, max_creations_per_frame=100)
    jstate = JF.create_surfel_state(4096)
    tstate = TF.create_surfel_state(4096, "cpu")
    for frame in range(2):
        jstate, tstate = compare_frame(jstate, tstate,
                                       noisy_wall(seed=frame), frame, params)
    assert int(tstate.surfel_count) == 200
    assert int(tstate.overflow_count) == 0


def test_project_saturates_huge_coordinates():
    """A surfel just in front of the camera projects to a huge u: it must be
    off-image (a wrapping float->int cast would give INT_MIN < width)."""
    params = TF.params_from(PARAMS)
    x = torch.tensor([1.0, 0.0, -1.0, 0.0])
    y = torch.tensor([0.0, 1.0, 0.0, 0.0])
    z = torch.tensor([1e-9, 1e-9, 1e-9, 2.0])
    _, _, _, _, in_image = TF._project(params, x, y, z)
    _, _, _, _, want = JF._project(PARAMS, jnp.asarray(x.numpy()),
                                   jnp.asarray(y.numpy()),
                                   jnp.asarray(z.numpy()))
    assert in_image.tolist() == [False, False, False, True]
    np.testing.assert_array_equal(in_image.numpy(), np.asarray(want))

    # Through a whole frame: the near surfel neither supports nor
    # conflicts anywhere, exactly as in JAX.
    jstate = JF.plant_surfel(JF.create_surfel_state(4096), 0,
                             pos=[1.0, 0.0, 1e-9], normal=[0, 0, -1],
                             confidence=2.0, radius_sq=0.0025)
    jstate = jstate._replace(surfel_count=jnp.int32(1))
    _, tstate = compare_frame(jstate, to_port(jstate), noisy_wall(seed=4), 1,
                              PARAMS)
    assert float(TF.confidences(tstate)[0]) == 2.0


def test_state_numpy_round_trip_keeps_bits():
    jstate = JF.plant_surfel(JF.create_surfel_state(64), 3, pos=[1, 2, 3],
                             normal=[0, 0, -1], creation=7, stamp=-5)
    tstate = to_port(jstate)
    back = TF.state_to_numpy(tstate)
    np.testing.assert_array_equal(back["pack"].view(np.int32),
                                  np.asarray(jstate.pack).view(np.int32))
    assert int(TF.creation_stamps(tstate)[3]) == 7
    assert int(TF.update_stamps(tstate)[3]) == -5
    assert int(TF.update_stamps(tstate)[0]) == -(2 ** 30)
    assert (back["neighbors"] == INVALID).all()


EXACT_MODES = {
    "symmetric_regularization-False": dict(symmetric_regularization=False),
    "exact_conflict_arbitration-True": dict(exact_conflict_arbitration=True),
    "fast_neighbor_update-False": dict(fast_neighbor_update=False),
    "exact_all": dict(symmetric_regularization=False,
                      exact_conflict_arbitration=True,
                      fast_neighbor_update=False)}


@pytest.mark.parametrize("modes", EXACT_MODES.values(),
                         ids=EXACT_MODES.keys())
def test_unported_modes_raise(modes):
    """Each reference-parity mode (once refused), and all three at once,
    matches eager JAX phase by phase over four frames: the three of
    test_three_frames_all_taps, then a frame where two planted surfels
    float in front of the wall at the same position, so they project to
    one pixel with bitwise-equal depth.  That tie is where the exact
    conflictor map differs from the default: only the lower index
    decrements."""
    params = dataclasses.replace(PARAMS, **modes)
    jstate = JF.create_surfel_state(4096)
    tstate = TF.create_surfel_state(4096, "cpu")
    for frame, (seed, hole, yaw, tx) in enumerate(
            [(0, True, 0.0, 0.0), (1, False, 0.01, 0.005),
             (2, True, 0.02, 0.01)]):
        jstate, tstate = compare_frame(jstate, tstate,
                                       noisy_wall(seed=seed, hole=hole),
                                       frame, params,
                                       pose(yaw, (tx, 0.0, 0.0)))
    count = int(jstate.surfel_count)
    for i in (count, count + 1):
        jstate = JF.plant_surfel(jstate, i, pos=[0.0, 0.0, 1.0],
                                 normal=[0, 0, -1], confidence=2.0,
                                 radius_sq=0.001, stamp=2)
    jstate = jstate._replace(surfel_count=jnp.int32(count + 2))
    _, tstate = compare_frame(jstate, to_port(jstate), noisy_wall(seed=3), 3,
                              params)
    conf = TF.confidences(tstate)[count:count + 2].tolist()
    assert conf == ([1.0, 2.0] if params.exact_conflict_arbitration
                    else [1.0, 1.0])


def test_exact_cross_terms_sum_in_stream_order():
    """The exact cross terms (symmetric_regularization=False) are float
    scatter-adds, so their order shows in the last bit.  XLA:CPU adds the
    updates of a target in stream order (pinned against a sequential
    float32 loop); _ordered_scatter_add reproduces that order, bit for
    bit, and so does the whole regularization step against eager JAX on a
    state where surfel 0 is the recent neighbor of seven others."""
    rng = np.random.default_rng(11)
    n = 64
    index = rng.integers(0, n, 4 * n).astype(np.int32)
    index[rng.choice(4 * n, 40, replace=False)] = INVALID
    to_zero = [3, 40, 77, 130, 131, 200, 255]
    index[to_zero] = 0
    values = (rng.standard_normal(4 * n) *
              10.0 ** rng.uniform(-3, 3, 4 * n)).astype(np.float32)
    values[to_zero] = [1.0, 1e8, -1e8, 3e-3, 7.0, -2.5e-2, 1.234567]
    want = np.zeros(n, np.float32)
    for i, v in zip(index, values):
        if i != INVALID:
            want[i] = np.float32(want[i] + v)
    reverse = np.float32(0.0)
    for v in values[index == 0][::-1]:
        reverse = np.float32(reverse + v)
    assert reverse != want[0]          # the order shows at target 0
    got_jax = np.asarray(jnp.zeros(n, jnp.float32).at[index].add(
        values, mode="drop"))
    np.testing.assert_array_equal(got_jax.view(np.int32), want.view(np.int32))
    got = TF._ordered_scatter_add(n, torch.from_numpy(index),
                                  torch.from_numpy(values)[None])[0]
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))

    # The whole step: surfel 0 sits in a slot of surfels 1..7.
    params = dataclasses.replace(PARAMS, symmetric_regularization=False)
    jstate = JF.create_surfel_state(n)
    for i in range(n):
        p = np.array([0.01 * (i % 8), 0.01 * (i // 8), 2.0]) + \
            0.002 * rng.standard_normal(3)
        nrm = np.array([0.0, 0.0, -1.0]) + 0.2 * rng.standard_normal(3)
        jstate = JF.plant_surfel(jstate, i, pos=p, normal=nrm / np.linalg.norm(
            nrm), radius_sq=0.01, stamp=5,
            smooth=p + 0.003 * rng.standard_normal(3))
    nbrs = rng.integers(0, n, (4, n)).astype(np.int32)
    nbrs[rng.integers(0, 4, 7), np.arange(1, 8)] = 0
    jstate = jstate._replace(neighbors=jnp.asarray(nbrs),
                             surfel_count=jnp.int32(n))
    with jax.disable_jit():
        jout = JF.regularize_only(jstate, jnp.int32(5), params)
    tout = TF.regularize_only(to_port(jstate), 5, TF.params_from(params))
    got = TF.state_to_numpy(tout)
    np.testing.assert_array_equal(got["pack"].view(np.int32),
                                  np.asarray(jout.pack).view(np.int32))
    np.testing.assert_array_equal(got["neighbors"],
                                  np.asarray(jout.neighbors))
    assert (got["pack"][:, TF.RCNT] == 0).all()     # not written here


def test_tiling_refuses_exact_regularization():
    params = dataclasses.replace(PARAMS, symmetric_regularization=False,
                                 active_surfel_budget=2048, tile_size=1024)
    with pytest.raises(ValueError, match="symmetric_regularization"):
        port_step(TF.create_surfel_state(4096, "cpu"), noisy_wall(seed=0), 0,
                  params)


def test_create_state_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TF.create_surfel_state(16, "cuda")
