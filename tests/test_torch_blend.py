"""Measurement blending: the port's plain version vs the JAX package's
_blend_core and its Pallas kernel (interpret mode), and the CUDA kernel vs
the plain version on the card (marked `cuda`, skipped without a GPU).

Bound: <= 1 depth unit after the floor (backends may differ in FMA
contraction, as tests/test_fusion.py::TestBlending states).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from surfelmeshing_tpu.ops import fusion as JF
from surfelmeshing_tpu_torch.ops import blend as TB
from surfelmeshing_tpu_torch.ops import fusion as TF

torch.set_num_threads(1)

SCALE = 5000.0
FX = FY = 30.0


def random_maps(h, w, seed):
    rng = np.random.default_rng(seed)
    depth_f = (rng.integers(0, 3, (h, w)) * 5000 +
               rng.integers(0, 200, (h, w))).astype(np.float32)
    supported = (rng.random((h, w)) < 0.7).astype(np.float32)
    valid = (depth_f > 0).astype(np.float32)
    avg = (depth_f / SCALE +
           0.01 * rng.standard_normal((h, w))).astype(np.float32)
    return depth_f, supported, valid, avg


@pytest.mark.parametrize("radius", [6, 12])
def test_plain_version_matches_jax_core_and_pallas(radius):
    maps = random_maps(24, 32, seed=3 + radius)
    got = np.floor(TB.blend_core_reference(
        *[torch.from_numpy(m) for m in maps], radius, SCALE).numpy())
    jmaps = [jnp.asarray(m) for m in maps]
    core = np.floor(np.asarray(JF._blend_core(*jmaps, radius=radius,
                                              scale=SCALE)))
    pallas = np.floor(np.asarray(JF._blend_pallas(
        *jmaps, radius=radius, scale=SCALE, interpret=True)))
    assert np.abs(got - core).max() <= 1
    assert np.abs(got - pallas).max() <= 1
    assert (got != maps[0]).any()       # blending changed something


def _measurements(h, w, seed, avg_offset=0.0):
    """(depth u16, supporting surfels, counts, sums) blending inputs."""
    rng = np.random.default_rng(seed)
    depth = (10000 + rng.integers(0, 300, (h, w))).astype(np.uint16)
    depth[:, :4] = 0
    supporting = np.where(rng.random((h, w)) < 0.8, 7,
                          2 ** 31 - 1).astype(np.int32)
    counts = rng.integers(1, 3, (h, w)).astype(np.int32)
    sums = (counts * (depth / SCALE + avg_offset)).astype(np.float32)
    return depth, supporting, counts, sums


@pytest.mark.parametrize("radius,avg_offset", [
    (0, 0.01), (1, 0.01), (6, 0.01),
    (12, 20.0),      # supporter average beyond u16: clipped to 65535
    (12, -5.0)])     # negative blended depth: clipped to 0
def test_blend_measurements_matches_jax(radius, avg_offset):
    """The whole blending step, floor and u16 clip included; radius < 2
    keeps only the border snap."""
    h, w = 24, 32
    depth, supporting, counts, sums = _measurements(h, w, 11, avg_offset)
    jparams = JF.FusionParams(width=w, height=h, fx=FX, fy=FY, cx=w / 2,
                              cy=h / 2, depth_scaling=SCALE,
                              measurement_blending_radius=radius)
    want = np.asarray(JF._blend_measurements(
        jparams, jnp.asarray(depth), jnp.asarray(supporting),
        jnp.asarray(counts), jnp.asarray(sums))).astype(np.int64)
    got = TF._blend_measurements(
        TF.params_from(jparams), torch.from_numpy(depth.astype(np.int32)),
        torch.from_numpy(supporting), torch.from_numpy(counts),
        torch.from_numpy(sums)).numpy().astype(np.int64)
    assert np.abs(got - want).max() <= 1
    assert got.min() >= 0 and got.max() <= 65535
    if avg_offset > 1:
        assert got.max() == 65535
    if avg_offset < 0:
        assert (got[depth > 0] == 0).any()


def test_blend_core_on_cpu_runs_plain_version_without_launch():
    maps = [torch.from_numpy(m) for m in random_maps(24, 32, seed=5)]
    before = TB.blend_core.launches
    got = TB.blend_core(*maps, 6, SCALE)
    assert TB.blend_core.launches == before
    torch.testing.assert_close(got, TB.blend_core_reference(*maps, 6, SCALE),
                               rtol=0, atol=0)


def _blend_in_place(depth_f, supported, valid, avg, radius, scale, seed):
    """blend_core_reference with one buffer updated in place: each ring
    iteration visits the rows in a seeded random order and updates each row
    from the maps as they stand, rows already visited included (csrc/
    blend.cu's order is that of its warps, which is arbitrary)."""
    h, w = depth_f.shape
    scale = float(np.float32(scale))
    order = np.random.default_rng(seed)
    sup_b, val_b = supported > 0.5, valid > 0.5
    ys = torch.arange(h)[:, None]
    xs = torch.arange(w)[None, :]
    interior = (xs >= 1) & (ys >= 1) & (xs < w - 1) & (ys < h - 1)
    eligible = interior & val_b & sup_b
    meas = torch.zeros((h, w), dtype=torch.bool)
    surf = torch.zeros_like(meas)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nb_valid = TB._shifted(valid, dy, dx) > 0.5
            meas |= ~nb_valid
            surf |= nb_valid & ~(TB._shifted(supported, dy, dx) > 0.5)
    meas &= eligible
    surf &= eligible
    delta0 = avg - depth_f / torch.full_like(depth_f, scale)
    dist = torch.where(meas, 1.0, torch.where(eligible, 255.0, 0.0))
    delta = torch.where(meas, delta0, 0.0)
    ndist = torch.where(surf, 1.0, 0.0)
    ndelta = torch.where(surf, delta0, 0.0)
    depth = torch.where(meas, torch.floor(scale * avg + 0.5), depth_f)
    target = interior & val_b & ~sup_b
    for it in range(2, radius):
        blend_w = float(np.float32(scale) *
                        np.float32(1.0 - (it - 1.0) / (radius - 1.0)))
        for y in order.permutation(h):
            for dmap, vals, grows in ((dist, delta, dist[y] == 255.0),
                                      (ndist, ndelta,
                                       target[y] & (ndist[y] == 0.0))):
                ssum = torch.zeros(w)
                cnt = torch.zeros(w)
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        ring = TB._shifted(dmap, dy, dx)[y] == it - 1
                        ssum += torch.where(
                            ring, TB._shifted(vals, dy, dx)[y], 0.0)
                        cnt += ring.to(torch.float32)
                grow = grows & (cnt > 0)
                mean = ssum / cnt.clamp_min(1.0)
                dmap[y] = torch.where(grow, float(it), dmap[y])
                vals[y] = torch.where(grow, mean, vals[y])
                depth[y] = torch.where(grow, depth[y] + blend_w * mean + 0.5,
                                       depth[y])
    return depth


@pytest.mark.parametrize("radius", [3, 12])
def test_in_place_rings_equal_jacobi_rings(radius):
    """The argument behind csrc/blend.cu's single buffer, on the plain
    side: updating the maps in place, in any row order, gives the Jacobi
    version's result bit for bit, because iteration `it` reads only ring
    it-1 and writes only open pixels, which become ring it."""
    maps = [torch.from_numpy(m) for m in random_maps(24, 32, seed=radius)]
    want = TB.blend_core_reference(*maps, radius, SCALE)
    for seed in (0, 1):
        got = _blend_in_place(*maps, radius, SCALE, seed)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (want != maps[0]).sum() > 100


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,radius", [((24, 32), 6), ((480, 640), 12),
                                          ((100, 77), 2), ((481, 641), 3),
                                          ((120, 160), TB.MAX_RADIUS)])
def test_kernel_matches_plain_version_on_card(cuda_device, shape, radius):
    maps = [torch.from_numpy(m).to(cuda_device)
            for m in random_maps(*shape, seed=radius)]
    before = TB.blend_core.launches
    got = TB.blend_core(*maps, radius, SCALE)
    torch.cuda.synchronize()
    assert TB.blend_core.launches == before + 1
    want = TB.blend_core_reference(*maps, radius, SCALE)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_inputs(cuda_device):
    maps = [torch.from_numpy(m).to(cuda_device)
            for m in random_maps(24, 32, seed=1)]
    with pytest.raises(ValueError):
        TB.blend_core(maps[0].t(), *maps[1:], 6, SCALE)      # not contiguous
    with pytest.raises(ValueError):
        TB.blend_core(maps[0].double(), *maps[1:], 6, SCALE)
    with pytest.raises(ValueError):
        TB.blend_core(*maps, TB.MAX_RADIUS + 1, SCALE)
