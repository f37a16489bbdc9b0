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


def test_plain_version_matches_jax_core_above_one_launch_radius():
    """Radius 40, past csrc/blend.cu's MAX_RADIUS: the radii the wide path
    serves on the card."""
    radius = 40
    assert radius > TB.MAX_RADIUS
    maps = random_maps(24, 32, seed=radius)
    got = np.floor(TB.blend_core_reference(
        *[torch.from_numpy(m) for m in maps], radius, SCALE).numpy())
    core = np.floor(np.asarray(JF._blend_core(
        *[jnp.asarray(m) for m in maps], radius=radius, scale=SCALE)))
    assert np.abs(got - core).max() <= 1
    assert (got != maps[0]).any()


def sentinel_maps(h, w):
    """Every pixel valid and supported: no border, so every eligible
    (interior) pixel stays at the reference's 'unknown' ring value 255."""
    depth_f = np.full((h, w), 5000.0, np.float32)
    ones = np.ones((h, w), np.float32)
    avg = (depth_f / SCALE + 0.01).astype(np.float32)
    return depth_f, ones, ones.copy(), avg


def test_sentinel_collision_at_radius_257_matches_jax():
    """_blend_core marks 'unknown' as 255, so iteration 256 takes every
    pixel still at 255 for ring 255: it counts itself and grows, gaining
    blend_w * 0 + 0.5.  The plain version (and so the wide path held to
    it) must reproduce that: every eligible pixel moves by exactly +0.5."""
    h, w = 24, 32
    maps = sentinel_maps(h, w)
    got = TB.blend_core_reference(*[torch.from_numpy(m) for m in maps], 257,
                                  SCALE).numpy()
    want = np.asarray(JF._blend_core(*[jnp.asarray(m) for m in maps],
                                     radius=257, scale=SCALE))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    moved = np.zeros((h, w), np.float32)
    moved[1:-1, 1:-1] = 0.5
    np.testing.assert_array_equal(got - maps[0], moved)
    below = TB.blend_core_reference(*[torch.from_numpy(m) for m in maps],
                                    256, SCALE).numpy()
    np.testing.assert_array_equal(below, maps[0])


@pytest.mark.parametrize("radius,avg_offset", [
    (-3, 0.01), (0, 0.01), (1, 0.01), (6, 0.01),
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


@pytest.mark.parametrize("radius", [6, 40])
def test_blend_core_on_cpu_runs_plain_version_without_launch(radius):
    maps = [torch.from_numpy(m) for m in random_maps(24, 32, seed=5)]
    core = TB.blend_core
    before = core.launches, core.wide_launches, core.wide_kernel_launches
    got = TB.blend_core(*maps, radius, SCALE)
    assert (core.launches, core.wide_launches,
            core.wide_kernel_launches) == before
    torch.testing.assert_close(
        got, TB.blend_core_reference(*maps, radius, SCALE), rtol=0, atol=0)


@pytest.mark.parametrize("radius", [-3, 0])
def test_blend_measurements_passes_at_least_radius_one(monkeypatch, radius):
    """_blend_measurements hands blend_core max(radius, 1), as the JAX
    package does, so the wrapper (which refuses radius < 1 on the card)
    never sees a radius below 1 from the frame step."""
    h, w = 24, 32
    depth, supporting, counts, sums = _measurements(h, w, 13)
    args = (torch.from_numpy(depth.astype(np.int32)),
            torch.from_numpy(supporting), torch.from_numpy(counts),
            torch.from_numpy(sums))
    seen = []

    def recording_blend_core(*maps_and_radius):
        seen.append(maps_and_radius[4])
        return TB.blend_core(*maps_and_radius)

    monkeypatch.setattr(TF, "blend_core", recording_blend_core)
    params = TF.FusionParams(width=w, height=h, fx=FX, fy=FY, cx=w / 2,
                             cy=h / 2, depth_scaling=SCALE,
                             measurement_blending_radius=radius)
    got = TF._blend_measurements(params, *args)
    one = TF._blend_measurements(
        TF.FusionParams(width=w, height=h, fx=FX, fy=FY, cx=w / 2, cy=h / 2,
                        depth_scaling=SCALE, measurement_blending_radius=1),
        *args)
    assert seen == [1, 1]
    assert torch.equal(got, one)


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


def _blend_wide_emulated(depth_f, supported, valid, avg, radius, scale, seed,
                         snapshot=True, chunks=4):
    """csrc/blend_wide.cu's order on the plain side: dist / ndist kept as
    the reference's values in global maps, one pass an iteration updating
    them in place, its pixels visited in a seeded random order cut into
    `chunks` groups (each group reads the maps as the groups before it left
    them).  With `snapshot`, iteration 256 reads dist and delta from a copy
    taken before it, as the launcher does."""
    h, w = depth_f.shape
    n = h * w
    scale = float(np.float32(scale))
    order = np.random.default_rng(seed)
    ys, xs = np.divmod(np.arange(n), w)
    neighbours = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            yy, xx = ys + dy, xs + dx
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            neighbours.append(torch.from_numpy(
                np.where(inside, yy * w + xx, -1)))
    sup_b, val_b = supported > 0.5, valid > 0.5
    yt = torch.arange(h)[:, None]
    xt = torch.arange(w)[None, :]
    interior = (xt >= 1) & (yt >= 1) & (xt < w - 1) & (yt < h - 1)
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
    dist = torch.where(meas, 1, torch.where(eligible, 255, 0)).flatten()
    delta = torch.where(meas, delta0, 0.0).flatten()
    ndist = torch.where(surf, 1, 0).flatten()
    ndelta = torch.where(surf, delta0, 0.0).flatten()
    target = (interior & val_b & ~sup_b).flatten()
    depth = torch.where(meas, torch.floor(scale * avg + 0.5),
                        depth_f).flatten()
    for it in range(2, radius):
        blend_w = float(np.float32(scale) *
                        np.float32(1.0 - (it - 1.0) / (radius - 1.0)))
        ring_in, vals_in = dist, delta
        if snapshot and it - 1 == 255:
            ring_in, vals_in = dist.clone(), delta.clone()
        for group in np.array_split(order.permutation(n), chunks):
            p = torch.from_numpy(group)
            for rd, rv, wd, wv, opened in (
                    (ring_in, vals_in, dist, delta, dist[p] == 255),
                    (ndist, ndelta, ndist, ndelta,
                     target[p] & (ndist[p] == 0))):
                ssum = torch.zeros(len(p))
                cnt = torch.zeros(len(p))
                for nb in neighbours:
                    q = nb[p]
                    at = (q >= 0) & (rd[q.clamp_min(0)] == it - 1)
                    ssum += torch.where(at, rv[q.clamp_min(0)], 0.0)
                    cnt += at.to(torch.float32)
                grow = opened & (cnt > 0)
                mean = ssum / cnt.clamp_min(1.0)
                wd[p] = torch.where(grow, it, wd[p])
                wv[p] = torch.where(grow, mean, wv[p])
                depth[p] = torch.where(grow, depth[p] + blend_w * mean + 0.5,
                                       depth[p])
    return depth.reshape(h, w)


def long_ring_maps(h, w, seed):
    """Invalid left columns and an unsupported run in one row: rings grow
    along the rows past ring 255 (the sentinel's value), and targets grow
    ndist rings."""
    rng = np.random.default_rng(seed)
    depth_f = (10000 + rng.integers(0, 300, (h, w))).astype(np.float32)
    depth_f[:, :3] = 0
    supported = np.ones((h, w), np.float32)
    supported[h // 2, w // 2:] = 0
    valid = (depth_f > 0).astype(np.float32)
    avg = (depth_f / SCALE +
           0.01 * rng.standard_normal((h, w))).astype(np.float32)
    return depth_f, supported, valid, avg


@pytest.mark.parametrize("case,radius", [("random", 33), ("random", 257),
                                         ("sentinel", 257),
                                         ("long rings", 260)])
def test_wide_path_order_equals_jacobi_rings(case, radius):
    """The argument behind csrc/blend_wide.cu on the plain side: global
    maps of values updated in place in any pixel order, with iteration
    256's snapshot, give the Jacobi version's result bit for bit."""
    maps = {"random": lambda: random_maps(24, 32, seed=radius),
            "sentinel": lambda: sentinel_maps(24, 32),
            "long rings": lambda: long_ring_maps(4, 300, seed=1)}[case]()
    maps = [torch.from_numpy(m) for m in maps]
    want = TB.blend_core_reference(*maps, radius, SCALE)
    got = _blend_wide_emulated(*maps, radius, SCALE, seed=radius)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (want != maps[0]).sum() > 20


def test_wide_path_needs_the_snapshot_at_iteration_256():
    """Where rings pass 255, updating iteration 256 in place lets a pixel
    miss a neighbour that left ring 255 earlier in the same pass: the
    result then depends on the order and differs from the reference."""
    maps = [torch.from_numpy(m) for m in long_ring_maps(4, 300, seed=1)]
    want = TB.blend_core_reference(*maps, 260, SCALE)
    got = _blend_wide_emulated(*maps, 260, SCALE, seed=260, snapshot=False)
    assert not torch.equal(got.view(torch.int32), want.view(torch.int32))


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
@pytest.mark.parametrize("case,shape,radius", [
    ("random", (480, 640), 33), ("random", (480, 640), 48),
    ("random", (480, 640), 64), ("random", (100, 77), 40),
    ("sentinel", (24, 32), 257), ("long rings", (64, 640), 300)])
def test_wide_path_matches_plain_version_on_card(cuda_device, case, shape,
                                                 radius):
    maps = {"random": lambda: random_maps(*shape, seed=radius),
            "sentinel": lambda: sentinel_maps(*shape),
            "long rings": lambda: long_ring_maps(*shape, seed=1)}[case]()
    maps = [torch.from_numpy(m).to(cuda_device) for m in maps]
    core = TB.blend_core
    before = core.launches, core.wide_launches, core.wide_kernel_launches
    got = TB.blend_core(*maps, radius, SCALE)
    torch.cuda.synchronize()
    # An init kernel and one ring kernel for each iteration 2 .. radius-1.
    assert (core.launches, core.wide_launches, core.wide_kernel_launches) == \
        (before[0], before[1] + 1, before[2] + radius - 1)
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
        TB.blend_core(*maps, 0, SCALE)       # _blend_measurements passes >= 1
