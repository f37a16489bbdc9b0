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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,radius", [((24, 32), 6), ((480, 640), 12),
                                          ((100, 77), 2)])
def test_kernel_matches_plain_version_on_card(cuda_device, shape, radius):
    maps = [torch.from_numpy(m).to(cuda_device)
            for m in random_maps(*shape, seed=radius)]
    before = TB.blend_core.launches
    got = TB.blend_core(*maps, radius, SCALE)
    torch.cuda.synchronize()
    assert TB.blend_core.launches == before + 1
    want = TB.blend_core_reference(*maps, radius, SCALE)
    assert (torch.floor(got) - torch.floor(want)).abs().max().item() <= 1


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
