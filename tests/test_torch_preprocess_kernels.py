"""The preprocessing passes' two routes (ops/preprocess.py): the plain
passes on the CPU and csrc/preprocess.cu's kernels on the card.

- CPU: each pass and preprocess_frame run the plain versions
  (`<pass>_reference`), launch nothing and never load the kernel library;
  the card route's wrappers check their arguments and hand the kernels the
  plain code's scalars (exercised on the CPU by standing in for the
  launch).
- Card (`cuda`): each kernel equals its plain pass run on the same CUDA
  tensors bit for bit, on seeded 640x480 frames at the benchmark cells'
  settings and on corner cases (all-zero maps, depths beyond max_depth,
  image borders, pixels outside the valid-region circle, required inliers
  all / -1 / 3, erosion radii 0-3, clamp factor inf and finite, a 320x240
  pyramid shape); preprocess_frame launches each of the 5 kernels once,
  and captured in a CUDA graph and replayed it equals the eager call.

This file imports no JAX and nothing of the JAX package, so `python -m
pytest tests/test_torch_preprocess_kernels.py -m cuda` runs on the card.
"""

import math

import numpy as np
import pytest
import torch

from surfelmeshing_tpu_torch.ops import preprocess as pp
from surfelmeshing_tpu_torch.tools.kernel_timing import (
    preprocess_inputs as seeded_frame, preprocess_pass_args)

torch.set_num_threads(1)

FX = FY = 525.0
SCALE = 5000.0

# The benchmark cells' settings (benchmark/configs/*.json), as
# pipeline.preprocess_kwargs passes them.
CELL = dict(sigma_xy=3.0, sigma_value_factor=0.05, radius_factor=2.0,
            max_depth_u16=15000, depth_valid_region_radius=333.0,
            tolerance=0.02, required_inliers=None, erosion_radius=2,
            observation_angle_threshold_deg=85.0, depth_scaling=SCALE,
            point_radius_extension_factor=1.5,
            point_radius_clamp_factor=math.inf)


def camera(h, w):
    return dict(fx=FX * w / 640, fy=FY * h / 480, cx=w / 2 + 0.5,
                cy=h / 2 + 0.5)


def reference_frame(depth, others, transforms, *, sigma_xy,
                    sigma_value_factor, radius_factor, max_depth_u16,
                    depth_valid_region_radius, tolerance, required_inliers,
                    erosion_radius, observation_angle_threshold_deg,
                    depth_scaling, point_radius_extension_factor,
                    point_radius_clamp_factor, fx, fy, cx, cy):
    """preprocess_frame's chain through the plain passes alone."""
    d = pp.bilateral_filter_and_cutoff_reference(
        depth, sigma_xy, sigma_value_factor, radius_factor, max_depth_u16,
        depth_valid_region_radius)
    d = pp.outlier_depth_map_fusion_reference(
        d, others, transforms, fx, fy, cx, cy, tolerance, required_inliers)
    d = pp.erode_depth_reference(d, erosion_radius)
    d, normals = pp.compute_normals_and_drop_bad_pixels_reference(
        d, observation_angle_threshold_deg, depth_scaling, fx, fy, cx, cy)
    d, radius_sq = pp.compute_point_radii_and_remove_isolated_reference(
        d, point_radius_extension_factor, point_radius_clamp_factor,
        depth_scaling, fx, fy, cx, cy)
    return d, normals, radius_sq


def bits(t):
    return t.contiguous().view(torch.int32).cpu()


def assert_bits_equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(bits(g), bits(w)), \
            f"{int((bits(g) != bits(w)).sum())} words differ"


PASS_NAMES = ("bilateral", "outlier", "erode", "normals", "radii")


# -- the CPU route ------------------------------------------------------------

@pytest.fixture
def no_library(monkeypatch):
    """Fails the test if anything loads the kernel library."""
    def refuse():
        raise AssertionError("the CPU route loaded the kernel library")
    monkeypatch.setattr(pp, "load_library", refuse)


@pytest.mark.parametrize("index", range(len(PASS_NAMES)), ids=PASS_NAMES)
def test_cpu_route_runs_the_plain_pass(no_library, index):
    depth, others, transforms = seeded_frame(1, 48, 64, k=4)
    kw = dict(CELL, depth_valid_region_radius=30.0, **camera(48, 64))
    _, fn, args = preprocess_pass_args(depth, others, transforms, kw)[index]
    before = pp.launches()
    got = getattr(pp, fn)(*args)
    assert pp.launches() == before
    assert_bits_equal(got, getattr(pp, fn + "_reference")(*args))


def test_cpu_route_preprocess_frame_counts_no_launch(no_library):
    depth, others, transforms = seeded_frame(2, 48, 64, k=4)
    kw = dict(CELL, **camera(48, 64))
    stages = []
    before = pp.launches()
    got = pp.preprocess_frame(depth, others, transforms, **kw,
                              on_stage=lambda n, d: stages.append(n))
    assert pp.launches() == before
    assert stages == list(pp.PASSES)
    assert_bits_equal(got, reference_frame(depth, others, transforms, **kw))


@pytest.fixture
def card_route(monkeypatch):
    """The card route's wrappers on CPU tensors: the route is forced and
    each launch is recorded as (kernel, scalar arguments) instead."""
    calls = []
    monkeypatch.setattr(pp, "_on_card", lambda name, *tensors: True)
    monkeypatch.setattr(pp, "_launch", lambda depth, kernel, *args:
                        calls.append((kernel, list(args))))
    return calls


def test_card_route_hands_the_kernels_the_plain_scalars(card_route):
    depth, others, transforms = seeded_frame(3, 48, 64, k=8)
    cam = camera(48, 64)
    pp.preprocess_frame(depth, others, transforms, **CELL, **cam)
    fx_inv, fy_inv = 1.0 / cam["fx"], 1.0 / cam["fy"]
    cx_inv, cy_inv = -(cam["cx"] - 0.5) / cam["fx"], \
        -(cam["cy"] - 0.5) / cam["fy"]
    assert [k for k, _ in card_route] == ["bilateral", "outlier", "erode",
                                          "normals", "radii"]
    scalars = {k: args[-k_n:] for (k, args), k_n in
               zip(card_route, (7, 14, 3, 9, 10))}
    assert scalars["bilateral"] == [48, 64, 6, 18.0, 0.05, 15000, 333.0 ** 2]
    assert scalars["outlier"] == [48, 64, 8, 8, cam["fx"], cam["fy"],
                                  cam["cx"], cam["cy"], fx_inv, fy_inv,
                                  cx_inv, cy_inv, 1.0 + 0.02, 1.0 - 0.02]
    assert scalars["erode"] == [48, 64, 2]
    assert scalars["normals"] == [
        48, 64, fx_inv, fy_inv, cx_inv, cy_inv, 1.0 / SCALE, 1.0,
        -math.cos(math.pi / 180.0 * 85.0)]
    assert scalars["radii"] == [48, 64, fx_inv, fy_inv, cx_inv, cy_inv,
                                1.0 / SCALE, 2.25, 0, math.inf]


@pytest.mark.parametrize("required, want", [(None, 8), (-1, 8), (3, 3)])
def test_card_route_required_inliers(card_route, required, want):
    depth, others, transforms = seeded_frame(4, 24, 32, k=8)
    pp.outlier_depth_map_fusion(depth, others, transforms,
                                *camera(24, 32).values(), 0.02, required)
    (kernel, args), = card_route
    assert kernel == "outlier" and args[-12:-10] == [8, want]


@pytest.mark.parametrize("case", [
    "float depth", "3-d depth", "erosion -1", "bilateral radius 65",
    "others shape", "float others", "transforms shape", "max depth float"])
def test_card_route_checks_arguments(card_route, case):
    depth, others, transforms = seeded_frame(5, 24, 32, k=4)
    cam = camera(24, 32).values()
    call = {
        "float depth": lambda: pp.erode_depth(depth.float(), 1),
        "3-d depth": lambda: pp.erode_depth(depth[None], 1),
        "erosion -1": lambda: pp.erode_depth(depth, -1),
        "bilateral radius 65": lambda: pp.bilateral_filter_and_cutoff(
            depth, 13.0, 0.05, 5.0, 15000, 333.0),
        "others shape": lambda: pp.outlier_depth_map_fusion(
            depth, others[:, :-1], transforms, *cam, 0.02),
        "float others": lambda: pp.outlier_depth_map_fusion(
            depth, others.float(), transforms, *cam, 0.02),
        "transforms shape": lambda: pp.outlier_depth_map_fusion(
            depth, others, transforms[:3], *cam, 0.02),
        "max depth float": lambda: pp.bilateral_filter_and_cutoff(
            depth, 3.0, 0.05, 2.0, 15000.0, 333.0),
    }[case]
    with pytest.raises((ValueError, TypeError)):
        call()
    assert card_route == []


@pytest.mark.parametrize("devices", [("meta",), ("cpu", "meta")])
def test_route_refuses_other_and_mixed_devices(devices):
    maps = [torch.zeros((8, 8), dtype=torch.int32, device=d)
            for d in devices]
    with pytest.raises(ValueError, match="one CUDA device"):
        pp._on_card("erode_depth", *maps)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (csrc/preprocess.cu has no CPU "
                    "build)")
    return torch.device("cuda")


def cuda(*tensors):
    return tuple(t.cuda() for t in tensors)


def check_passes(depth, others, transforms, kw):
    """Each pass's kernel against its plain version on the same CUDA
    tensors, bit for bit, one launch each."""
    for name, fn, args in preprocess_pass_args(depth, others, transforms, kw):
        before = pp.launches()
        got = getattr(pp, fn)(*args)
        torch.cuda.synchronize()
        assert pp.launches() == dict(before, **{name: before[name] + 1})
        assert_bits_equal(got, getattr(pp, fn + "_reference")(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 12, 2 ** 31 + 5])
def test_kernels_equal_plain_passes_at_the_cells_settings(cuda_device, seed):
    frame = cuda(*seeded_frame(seed, 480, 640))
    check_passes(*frame, dict(CELL, **camera(480, 640)))


CORNERS = {
    "valid region 200": dict(depth_valid_region_radius=200.0),
    "valid region inf": dict(depth_valid_region_radius=math.inf),
    "max depth 9000": dict(max_depth_u16=9000),
    "required -1": dict(required_inliers=-1),
    "required 3": dict(required_inliers=3),
    "erosion 0": dict(erosion_radius=0),
    "erosion 1": dict(erosion_radius=1),
    "erosion 3": dict(erosion_radius=3),
    "clamp 2": dict(point_radius_clamp_factor=2.0),
    "clamp 0": dict(point_radius_clamp_factor=0.0),
    "sigma 1": dict(sigma_xy=1.0, radius_factor=1.5),
    "tolerance 0.1": dict(tolerance=0.1),
    "angle 60": dict(observation_angle_threshold_deg=60.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CORNERS))
def test_kernels_equal_plain_passes_at_corner_settings(cuda_device, case):
    frame = cuda(*seeded_frame(21, 480, 640))
    check_passes(*frame, dict(CELL, **CORNERS[case], **camera(480, 640)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zeros", "beyond max depth", "320x240",
                                  "k 2", "k 4", "k 6", "odd shape",
                                  "far transforms"])
def test_kernels_equal_plain_passes_on_corner_maps(cuda_device, case):
    h, w, k = {"320x240": (240, 320, 8), "odd shape": (97, 131, 8),
               "k 2": (480, 640, 2), "k 4": (480, 640, 4),
               "k 6": (480, 640, 6)}.get(case, (480, 640, 8))
    depth, others, transforms = seeded_frame(31, h, w, k)
    if case == "zeros":
        depth, others = torch.zeros_like(depth), torch.zeros_like(others)
    elif case == "beyond max depth":
        depth = depth + 20000
    elif case == "far transforms":
        # Points behind the other cameras and projections far off-image
        # (the saturating cast).
        transforms[:, :, 3] *= 1e6
        transforms[::2, 2, :3] *= -1
    check_passes(*cuda(depth, others, transforms), dict(CELL, **camera(h, w)))


@pytest.mark.cuda
def test_preprocess_frame_launches_five_kernels(cuda_device):
    depth, others, transforms = cuda(*seeded_frame(41, 480, 640))
    kw = dict(CELL, **camera(480, 640))
    stages = []
    before = pp.launches()
    got = pp.preprocess_frame(depth, others, transforms, **kw,
                              on_stage=lambda n, d: stages.append(n))
    torch.cuda.synchronize()
    assert pp.launches() == {k: n + 1 for k, n in before.items()}
    assert stages == list(pp.PASSES)
    assert_bits_equal(got, reference_frame(depth, others, transforms, **kw))


@pytest.mark.cuda
def test_preprocess_frame_in_a_cuda_graph_equals_eager(cuda_device):
    depth, others, transforms = cuda(*seeded_frame(51, 480, 640))
    kw = dict(CELL, **camera(480, 640))
    eager = pp.preprocess_frame(depth, others, transforms, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pp.preprocess_frame(depth, others, transforms, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = pp.launches()
    with torch.cuda.graph(graph):
        captured = pp.preprocess_frame(depth, others, transforms, **kw)
    assert pp.launches() == {k: n + 1 for k, n in before.items()}
    # New inputs in the captured buffers: the replay reads them.
    depth2, others2, transforms2 = cuda(*seeded_frame(52, 480, 640))
    for dst, src in ((depth, depth2), (others, others2),
                     (transforms, transforms2)):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    assert_bits_equal(captured, pp.preprocess_frame(depth, others,
                                                    transforms, **kw))
    assert_bits_equal(captured,
                      reference_frame(depth, others, transforms, **kw))
    assert not torch.equal(captured[0], eager[0])
