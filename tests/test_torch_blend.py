"""Measurement blending: the port's plain version vs the JAX package's
_blend_core and its Pallas kernel (interpret mode), and the CUDA kernel vs
the plain version on the card (marked `cuda`, skipped without a GPU).

Bound: <= 1 depth unit after the floor (backends may differ in FMA
contraction, as tests/test_fusion.py::TestBlending states).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
    """The in-place order of csrc/blend_wide.cu's float stage on the plain
    side: dist / ndist kept as the reference's values, one pass an
    iteration updating the maps in place, its pixels visited in a seeded
    random order cut into `chunks` groups (each group reads the maps as the
    groups before it left them).  With `snapshot`, iteration 256 reads
    dist and delta from a copy taken before it, as the kernel's float stage
    of 256 reads its snapshot of the deltas."""
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
    """The argument behind csrc/blend_wide.cu's in-place float stage on the
    plain side: maps of values updated in place in any pixel order, with
    iteration 256's snapshot, give the Jacobi version's result bit for
    bit."""
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


def _ring_step(s, target, it, radius, scale):
    """Ring iteration `it` of _blend_core on the region `s` (dist, delta,
    ndist, ndelta, depth; zero outside it), in place; -> the mask of
    pixels that grew."""
    blend_w = float(np.float32(scale) *
                    np.float32(1.0 - (it - 1.0) / (radius - 1.0)))
    steps = []
    for dkey, vkey, opened in (("dist", "delta", s["dist"] == 255.0),
                               ("ndist", "ndelta",
                                target & (s["ndist"] == 0.0))):
        ssum = torch.zeros_like(s["depth"])
        cnt = torch.zeros_like(s["depth"])
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                at = TB._shifted(s[dkey], dy, dx) == it - 1
                ssum += torch.where(at, TB._shifted(s[vkey], dy, dx), 0.0)
                cnt += at.to(torch.float32)
        steps.append((dkey, vkey, opened & (cnt > 0),
                      ssum / cnt.clamp_min(1.0)))
    for dkey, vkey, grow, mean in steps:
        s[dkey] = torch.where(grow, float(it), s[dkey])
        s[vkey] = torch.where(grow, mean, s[vkey])
        s["depth"] = torch.where(grow, s["depth"] + blend_w * mean + 0.5,
                                 s["depth"])
    return steps[0][2] | steps[1][2]


def _init_state(depth_f, supported, valid, avg, interior, scale):
    """The border iteration of _blend_core: the reference's dist / ndist
    values, deltas and snapped depth, and the unsupported targets."""
    sup_b, val_b = supported > 0.5, valid > 0.5
    eligible = interior & val_b & sup_b
    meas = torch.zeros_like(eligible)
    surf = torch.zeros_like(eligible)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nb_valid = TB._shifted(valid, dy, dx) > 0.5
            meas |= ~nb_valid
            surf |= nb_valid & ~(TB._shifted(supported, dy, dx) > 0.5)
    meas &= eligible
    surf &= eligible
    delta0 = avg - depth_f / torch.full_like(depth_f, scale)
    state = dict(dist=torch.where(meas, 1.0, torch.where(eligible, 255.0,
                                                         0.0)),
                 delta=torch.where(meas, delta0, 0.0),
                 ndist=torch.where(surf, 1.0, 0.0),
                 ndelta=torch.where(surf, delta0, 0.0),
                 depth=torch.where(meas, torch.floor(scale * avg + 0.5),
                                   depth_f))
    return state, interior & val_b & ~sup_b


def _blend_chunked(depth_f, supported, valid, avg, radius, scale, chunk,
                   core=(8, 8), exit_in_256=False):
    """csrc/blend_wide.cu's schedule on the plain side.  The first chunk
    runs the border iteration and ring iterations 2 .. chunk, each later
    chunk `chunk` ring iterations.  A chunk cuts the image into cores of
    `core` pixels and runs on each core's region (the core and a halo of
    `chunk`; zero outside the image and the region), from the inputs
    (first chunk) or the state, and writes back only the core, into a
    second copy of the state that the next chunk reads.  A region stops
    once an iteration grows nothing in it; a chunk whose predecessor grew
    nothing in its last iteration only copies the state.  Neither exit is
    taken in the chunk that holds iteration 256, unless `exit_in_256`."""
    h, w = depth_f.shape
    scale = float(np.float32(scale))
    ys = torch.arange(h)[:, None]
    xs = torch.arange(w)[None, :]
    interior = (xs >= 1) & (ys >= 1) & (xs < w - 1) & (ys < h - 1)
    ch, cw = core
    pad = (chunk, chunk, chunk, chunk)
    padded_inputs = [F.pad(m, pad) for m in (depth_f, supported, valid, avg)]
    padded_interior = F.pad(interior.to(torch.uint8), pad).bool()
    bounds = [(2, max(2, min(1 + chunk, radius)))]
    bounds += [(it0, min(it0 + chunk, radius))
               for it0 in range(1 + chunk, radius, chunk)]
    state = target = None
    grew_last = True
    for it0, it1 in bounds:
        may_exit = exit_in_256 or not it0 <= 256 < it1
        if not grew_last and may_exit:
            continue
        if state is None:
            state = {k: torch.zeros((h, w)) for k in
                     ("dist", "delta", "ndist", "ndelta", "depth")}
            target = torch.zeros((h, w), dtype=torch.bool)
            padded = None
        else:
            padded = {k: F.pad(v, pad) for k, v in state.items()}
            padded_target = F.pad(target.to(torch.uint8), pad).bool()
        out = {k: v.clone() for k, v in state.items()}
        out_target = target.clone()
        grew_last = False
        for y0 in range(0, h, ch):
            for x0 in range(0, w, cw):
                rows = slice(y0, y0 + ch + 2 * chunk)
                cols = slice(x0, x0 + cw + 2 * chunk)
                if padded is None:
                    region, region_target = _init_state(
                        *[m[rows, cols] for m in padded_inputs],
                        padded_interior[rows, cols], scale)
                else:
                    region = {k: v[rows, cols].clone()
                              for k, v in padded.items()}
                    region_target = padded_target[rows, cols]
                core_of = (slice(chunk, chunk + min(ch, h - y0)),
                           slice(chunk, chunk + min(cw, w - x0)))
                if it1 == 2:         # no ring iteration: ring 1 grew last
                    grew_last |= bool(
                        ((region["dist"] == 1.0) |
                         (region["ndist"] == 1.0))[core_of].any())
                for it in range(it0, it1):
                    grew = _ring_step(region, region_target, it, radius,
                                      scale)
                    grew_last |= it == it1 - 1 and bool(grew[core_of].any())
                    if may_exit and not grew.any():
                        break
                for k, v in region.items():
                    out[k][y0:y0 + ch, x0:x0 + cw] = v[core_of]
                out_target[y0:y0 + ch, x0:x0 + cw] = region_target[core_of]
        state, target = out, out_target
    return state["depth"]


@pytest.mark.parametrize("case,radius,chunk,core", [
    ("random", 33, 1, (8, 8)), ("random", 33, 8, (8, 8)),
    ("random", 33, 16, (12, 16)),
    ("random", 48, 8, (5, 7)), ("random", 48, 16, (8, 8)),
    # iteration 256 starts a chunk (2), follows a boundary at 255 (11),
    # ends one (15)
    ("sentinel", 257, 2, (12, 16)), ("sentinel", 257, 11, (12, 16)),
    ("sentinel", 257, 15, (7, 9)),
    ("long rings", 300, 2, (4, 57)), ("long rings", 300, 11, (4, 60)),
    ("long rings", 300, 15, (3, 70))])
def test_chunked_schedule_equals_jacobi_rings(case, radius, chunk, core):
    """csrc/blend_wide.cu's chunks on the plain side (tiles with a halo of
    T, T iterations a chunk, core-only write-back between chunks, the
    exits and the iteration-256 rule) give the reference's result bit for
    bit, on cores that do not divide the image too."""
    maps = {"random": lambda: random_maps(24, 32, seed=radius),
            "sentinel": lambda: sentinel_maps(24, 32),
            "long rings": lambda: long_ring_maps(4, 300, seed=1)}[case]()
    maps = [torch.from_numpy(m) for m in maps]
    want = TB.blend_core_reference(*maps, radius, SCALE)
    got = _blend_chunked(*maps, radius, SCALE, chunk, core)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (want != maps[0]).sum() > 20


def test_an_exit_that_skips_iteration_256_is_wrong():
    """The sentinel map has no border, so every frontier is empty from the
    start; iteration 256 still grows every open pixel (+0.5).  An exit
    taken in the chunk that holds 256 misses that."""
    maps = [torch.from_numpy(m) for m in sentinel_maps(24, 32)]
    want = TB.blend_core_reference(*maps, 257, SCALE)
    got = _blend_chunked(*maps, 257, SCALE, 11, (12, 16), exit_in_256=True)
    assert torch.equal(got, maps[0])
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
    # One chunk kernel for the border iteration and each WIDE_CHUNK of the
    # iterations 1 .. radius-1.
    chunks = -(-(radius - 1) // TB.WIDE_CHUNK)
    assert (core.launches, core.wide_launches, core.wide_kernel_launches) == \
        (before[0], before[1] + 1, before[2] + chunks)
    want = TB.blend_core_reference(*maps, radius, SCALE)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("chunk,core_h", [(1, 32), (2, 7), (11, 33),
                                          (15, 48), (31, 66)])
def test_wide_path_chunk_shapes_match_plain_version_on_card(
        cuda_device, chunk, core_h):
    """Other chunk lengths and core heights than the defaults: iteration
    256 starting a chunk, after a boundary at 255, ending one."""
    for maps, radius in ((sentinel_maps(24, 32), 257),
                         (long_ring_maps(64, 640, seed=1), 300),
                         (random_maps(100, 77, seed=40), 40)):
        maps = [torch.from_numpy(m).to(cuda_device) for m in maps]
        before = TB.blend_core.wide_kernel_launches
        got = TB.blend_wide(*maps, radius, SCALE, chunk, core_h)
        torch.cuda.synchronize()
        assert TB.blend_core.wide_kernel_launches - before == \
            -(-(radius - 1) // chunk)
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
    with pytest.raises(ValueError):
        TB.blend_wide(*maps, 40, SCALE, chunk=32)
    with pytest.raises(ValueError):
        TB.blend_wide(*maps, 40, SCALE, chunk=16, core_h=97)
