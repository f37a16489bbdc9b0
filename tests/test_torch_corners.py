"""The scalar corner cases of tests/test_cuda_corners.py, run through the
PyTorch port.

Each case plants one or two surfels against a single valid depth pixel and
computes the expected outcome in the test from the CUDA formulas (f32, same
expression order).  Discrete outcomes (confidence counters, stamps, flags,
u8 colors, neighbor invalidation, surfel counts) are exact; continuous ones
use 1e-5 relative tolerance.
"""

import dataclasses

import numpy as np
import torch

from surfelmeshing_tpu_torch.ops import fusion as F
from surfelmeshing_tpu_torch.ops.fusion import (FusionParams, INVALID_INDEX,
                                                create_surfel_state,
                                                integrate_frame, plant_surfel)

torch.set_num_threads(1)

H, W = 24, 32
FX = FY = 30.0
CX, CY = W / 2 + 0.5, H / 2 + 0.5   # pixel-corner convention
SCALE = 5000.0
f32 = np.float32

PARAMS = FusionParams(
    width=W, height=H, fx=FX, fy=FY, cx=CX, cy=CY, depth_scaling=SCALE,
    do_blending=False, regularization_iterations=0)

IDENT = torch.tensor([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]],
                     dtype=torch.float32)
PX_, PY_ = 16, 12                    # target pixel


def meas_depth(depth_u16: int) -> np.float32:
    """The f32 measurement depth the kernel sees: u16 * (1/scale)."""
    return f32(depth_u16) * f32(1.0 / SCALE)


def one_pixel_inputs(depth_u16: int, radius_sq=0.0025,
                     color=(40, 102, 201), px=PX_, py=PY_):
    """Depth valid at exactly one pixel; fronto-parallel normal."""
    depth = np.zeros((H, W), np.int32)
    depth[py, px] = depth_u16
    normals = np.zeros((2, H, W), np.float32)        # mnz = -1 exactly
    radius = np.zeros((H, W), np.float32)
    radius[py, px] = radius_sq
    col = np.zeros((3, H, W), np.uint8)
    col[:, py, px] = color
    return depth, normals, radius, col


def surfel_pos_at_pixel(z, px=PX_, py=PY_, u_frac=0.5, v_frac=0.5):
    """World position with camera z == `z` projecting inside pixel (px, py)
    at the given sub-pixel fractions (identity pose)."""
    u, v = px + u_frac, py + v_frac
    return [float((u - CX) * z / FX), float((v - CY) * z / FY), float(z)]


def run(state, inputs, frame_index, params=PARAMS):
    depth, normals, radius, color = (torch.from_numpy(a) for a in inputs)
    return integrate_frame(state, depth, normals, radius, color, IDENT,
                           IDENT, frame_index, params)


def with_count(state, count):
    return dataclasses.replace(
        state, surfel_count=torch.tensor(count, dtype=torch.int32))


def planted(z, confidence, normal=(0, 0, -1), radius_sq=0.0025, stamp=0,
            creation=0, color=(128, 128, 128), cap=256, index=0, count=1,
            u_frac=0.5, v_frac=0.5):
    state = create_surfel_state(cap, "cpu")
    state = plant_surfel(state, index, pos=surfel_pos_at_pixel(
        z, u_frac=u_frac, v_frac=v_frac), normal=normal,
        confidence=confidence, radius_sq=radius_sq, stamp=stamp,
        creation=creation, color=color)
    return with_count(state, count)


def row(state, i=0):
    return state.pack[i].numpy()


class TestConflictHandling:
    """kernels.cu:816-868 — the conflict critical section."""

    def test_conflict_decrements_confidence(self):
        meas = meas_depth(12500)                      # 2.5 m
        z = 2.0                                       # < 0.95 * 2.5
        assert f32(z) < f32(0.95) * meas
        state = planted(z, confidence=3.0)
        before = row(state).copy()
        state = run(state, one_pixel_inputs(12500), 1)
        assert float(F.confidences(state)[0]) == 2.0          # 3 - 1, exact
        after = row(state)
        for lo, hi in ((F.PX, F.PZ), (F.NX, F.NZ), (F.CR, F.CB)):
            np.testing.assert_array_equal(after[lo:hi + 1], before[lo:hi + 1])
        assert int(F.update_stamps(state)[0]) == 0            # no stamp
        assert int(state.surfel_count) == 1

    def test_conflict_reinitializes_at_zero_confidence(self):
        d_u16 = 12500
        meas = meas_depth(d_u16)
        state = planted(2.0, confidence=1.0, color=(1, 2, 3))
        neighbors = state.neighbors.clone()
        neighbors[:, 0] = 7
        state = dataclasses.replace(state, neighbors=neighbors)
        state = run(state, one_pixel_inputs(d_u16, radius_sq=0.0049), 3)

        ex = meas * f32((PX_ + 0.5 - CX) / FX)
        ey = meas * f32((PY_ + 0.5 - CY) / FY)
        r = row(state)
        np.testing.assert_allclose(r[F.PX:F.PZ + 1], [ex, ey, meas],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(r[F.SX:F.SZ + 1], r[F.PX:F.PZ + 1])
        np.testing.assert_allclose(r[F.NX:F.NZ + 1], [0, 0, -1], rtol=1e-6)
        assert float(F.confidences(state)[0]) == 1.0
        assert float(r[F.RAD]) == f32(0.0049)
        np.testing.assert_array_equal(r[F.CR:F.CB + 1], [40, 102, 201])
        assert float(r[F.DETACH]) == 1.0
        assert int(F.creation_stamps(state)[0]) == 3
        assert int(F.update_stamps(state)[0]) == 3
        assert (state.neighbors[:, 0] == INVALID_INDEX).all()

    def test_reinitialized_surfel_not_integrated_same_frame(self):
        d_u16 = 10000
        meas = meas_depth(d_u16)
        state = planted(float(meas), confidence=1.0, stamp=5, creation=5)
        before = row(state).copy()
        state = run(state, one_pixel_inputs(d_u16), 5)
        assert float(F.confidences(state)[0]) == 1.0
        np.testing.assert_array_equal(row(state)[F.PX:F.PZ + 1],
                                      before[F.PX:F.PZ + 1])
        assert int(state.surfel_count) == 1


class TestIntegration:
    """kernels.cu:925-981 — the measurement integration critical section."""

    def test_confidence_clamp_and_weighted_blend(self):
        d_u16 = 10100                                   # 2.02 m
        meas = meas_depth(d_u16)
        conf0 = f32(4.5)
        state = planted(2.0, confidence=float(conf0), radius_sq=0.0049,
                        color=(10, 101, 200))
        pos0 = row(state)[F.PX:F.PZ + 1].copy()
        state = run(state, one_pixel_inputs(
            d_u16, radius_sq=0.0025, color=(40, 102, 201)), 1)

        weight = f32(1.0)
        assert float(F.confidences(state)[0]) == 5.0    # clamped
        norm = f32(1.0) / (conf0 + weight)
        gx = meas * f32((PX_ + 0.5 - CX) / FX)
        gy = meas * f32((PY_ + 0.5 - CY) / FY)
        want = [(conf0 * f32(pos0[0]) + weight * gx) * norm,
                (conf0 * f32(pos0[1]) + weight * gy) * norm,
                (conf0 * f32(pos0[2]) + weight * meas) * norm]
        np.testing.assert_allclose(row(state)[F.PX:F.PZ + 1], want,
                                   rtol=1e-5, atol=1e-7)
        assert float(F.radii_sq(state)[0]) == f32(0.0025)
        assert int(F.update_stamps(state)[0]) == 1
        want_col = [int(np.floor((conf0 * f32(o) + weight * f32(c)) * norm
                                 + f32(0.5)))
                    for o, c in ((10, 40), (101, 102), (200, 201))]
        np.testing.assert_array_equal(F.colors_u8(state)[0].numpy(),
                                      want_col)

    def test_two_pixel_association_integrates_twice(self):
        d_u16 = 10000
        meas = meas_depth(d_u16)
        depth, normals, radius, col = one_pixel_inputs(d_u16)
        depth[PY_, PX_ + 1] = d_u16
        radius[PY_, PX_ + 1] = 0.0025
        col[:, PX_ + 1] = 0
        state = planted(float(meas), confidence=1.0, u_frac=0.8)
        state = run(state, (depth, normals, radius, col), 1)
        assert float(F.confidences(state)[0]) == 3.0
        assert int(state.surfel_count) == 1

    def test_supporter_map_min_index_tiebreak(self):
        d_u16 = 10050                                  # 2.01 m
        state = create_surfel_state(256, "cpu")
        state = plant_surfel(state, 0, pos=surfel_pos_at_pixel(2.0),
                             normal=(0, 0, -1), confidence=1.0,
                             radius_sq=0.0025)
        t = np.deg2rad(25.0)
        state = plant_surfel(state, 1, pos=surfel_pos_at_pixel(2.004),
                             normal=(np.sin(t), 0, -np.cos(t)),
                             confidence=1.0, radius_sq=0.0025)
        state = run(with_count(state, 2), one_pixel_inputs(d_u16), 1)
        assert float(F.confidences(state)[0]) == 1.5
        assert float(F.confidences(state)[1]) == 1.5
        assert int(state.surfel_count) == 2
        assert int(state.merge_count) == 0


class TestAssociationBoundaries:
    """kernels.cu:1610-1633 — strict inequalities at the zone boundaries."""

    def test_conflict_zone_boundary_is_strict(self):
        d_u16 = 12500
        meas = meas_depth(d_u16)
        z_edge = float(f32(1.0 - 0.05) * meas)
        state = run(planted(z_edge, confidence=2.0),
                    one_pixel_inputs(d_u16), 1)
        assert float(F.confidences(state)[0]) == 3.0

    def test_occlusion_boundary_is_strict(self):
        d_u16 = 10000
        meas = meas_depth(d_u16)
        z_edge = f32(1.0 + 0.05) * meas
        state = run(planted(float(z_edge), confidence=2.0),
                    one_pixel_inputs(d_u16), 1)
        assert float(F.confidences(state)[0]) == 3.0   # still integrates

        z_above = float(np.nextafter(z_edge, f32(np.inf), dtype=f32))
        state = run(planted(z_above, confidence=2.0),
                    one_pixel_inputs(d_u16), 1)
        assert float(F.confidences(state)[0]) == 2.0   # occluded: untouched
        assert int(state.surfel_count) == 2
