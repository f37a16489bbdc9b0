"""The port at the Replica deployment's shape
(benchmark/configs/replica1200_20m.json): 1200x680 frames, fx = fy = 600,
depth unit 6553.5 a metre (max_depth 3 m cuts at 19,660 units) and a
690 px valid circle that holds every pixel.

- CPU: the deferred-creation counter (SurfelState.deferred_count) splits a
  frame's flagged pixels into creations made, dropped at capacity
  (overflow_count) and deferred by the per-frame budget or the bucket;
  per-frame and chunked dispatch (frame_chunk 4) leave the same counter
  and map; the pipeline's trace counters creations.made and
  creations.deferred are the confirmed count growth and deferred total.
- Card (`cuda`): the five preprocessing kernels (csrc/preprocess.cu) and
  the blending kernel (csrc/blend.cu, 680 rows: a partial last row of
  32-row cores) equal their plain versions bit for bit at 1200x680 and
  unit 6553.5, eagerly and replayed from a CUDA graph; the pipeline's
  graph-replayed chunks leave the deferred counter and the map of
  per-frame (eager) dispatch, with the default creation budget binding.

This file imports no JAX and nothing of the JAX package, so `python -m
pytest tests/test_torch_replica_kernels.py -m cuda` runs on the card.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from surfelmeshing_tpu_torch.config import SurfelMeshingConfig
from surfelmeshing_tpu_torch.io.synthetic import (ArrayImageFrame,
                                                  SyntheticRGBDSequence)
from surfelmeshing_tpu_torch.io.tum import RGBDVideo
from surfelmeshing_tpu_torch.ops import blend
from surfelmeshing_tpu_torch.ops import fusion as TF
from surfelmeshing_tpu_torch.ops import preprocess as pp
from surfelmeshing_tpu_torch.pipeline import ReconstructionPipeline
from surfelmeshing_tpu_torch.tools.kernel_timing import (
    preprocess_inputs, preprocess_pass_args)
from surfelmeshing_tpu_torch.utils.camera import PinholeCamera

torch.set_num_threads(1)

WIDTH, HEIGHT, FOCAL = 1200, 680, 600.0
SCALE = 6553.5
MAX_DEPTH_U16 = int(SCALE * 3.0)          # 19,660
# The deployment's preprocessing settings as pipeline.preprocess_kwargs
# passes them (every other one the port's default).
CELL = dict(sigma_xy=3.0, sigma_value_factor=0.05, radius_factor=2.0,
            max_depth_u16=MAX_DEPTH_U16, depth_valid_region_radius=690.0,
            tolerance=0.02, required_inliers=None, erosion_radius=2,
            observation_angle_threshold_deg=85.0, depth_scaling=SCALE,
            point_radius_extension_factor=1.5,
            point_radius_clamp_factor=math.inf)


def replica_camera(cut: int = 1) -> PinholeCamera:
    """Replica's NICE-SLAM camera cut by `cut` (pixel-corner principal
    point: the centre-convention 599.5, 339.5 plus 0.5)."""
    return PinholeCamera(WIDTH // cut, HEIGHT // cut, FOCAL / cut,
                         FOCAL / cut, 600.0 / cut, 340.0 / cut)


def replica_video(frames: int, cut: int = 1, noise: float = 0.002):
    """A seeded synthetic RGB-D video (io/synthetic.py's room and arc) seen
    by the Replica camera cut by `cut`, depth in units of 6553.5 a metre."""
    seq = SyntheticRGBDSequence(frames, WIDTH // cut, HEIGHT // cut, SCALE,
                                noise_sigma=noise)
    seq.camera = replica_camera(cut)
    colors, depths = [], []
    for i in range(frames):
        d, c = seq.depth_and_color(i)
        ts = 1000.0 + 0.05 * i
        colors.append(ArrayImageFrame(c, ts, seq.poses[i]))
        depths.append(ArrayImageFrame(d, ts, seq.poses[i]))
    return RGBDVideo(colors, depths, seq.camera, seq.camera)


def replica_config(**kw) -> SurfelMeshingConfig:
    """The deployment's settings (open valid circle, unit 6553.5), with a
    2-frame outlier window to keep the tests short."""
    base = dict(depth_scaling=SCALE, depth_valid_region_radius=690.0,
                outlier_filtering_frame_count=2, restrict_fps_to=0)
    return SurfelMeshingConfig(**{**base, **kw})


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


def assert_same_map(a: TF.SurfelState, b: TF.SurfelState):
    for name in ("pack", "neighbors", "nbr_dist", "surfel_count",
                 "merge_count", "overflow_count", "deferred_count"):
        assert torch.equal(bits(getattr(a, name)), bits(getattr(b, name))), \
            name


def run_pipeline(cfg, video, device):
    pipe = ReconstructionPipeline(cfg, video.depth_camera, device)
    for i in range(video.frame_count):
        pipe.process_frame(video, i)
    pipe.drain()
    return pipe


# -- the deferred-creation counter on the CPU -----------------------------------

@pytest.fixture(scope="module")
def first_frame():
    """(params, the preprocessed inputs of frame 1 of a 150x85 video,
    flagged pixels: the creations of that frame into an empty map with no
    budget, bucket or capacity short)."""
    video = replica_video(3, cut=8)
    cfg = replica_config(max_surfel_count=65536)
    pipe = ReconstructionPipeline(cfg, video.depth_camera, "cpu")
    inputs = []
    fuse = TF.integrate_frame_bucketed

    def record(state, *args):
        inputs.append(args[:7])
        return fuse(state, *args)

    import surfelmeshing_tpu_torch.chunk as CH
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CH, "integrate_frame_bucketed", record)
        pipe.process_frame(video, 1)
    params = pipe.fusion_params
    flagged = int(pipe.state.surfel_count)
    assert int(pipe.state.deferred_count) == 0
    assert flagged > 4096
    return params, inputs[0], flagged


@pytest.mark.parametrize("case", ["budget", "bucket", "capacity",
                                  "budget and capacity"])
def test_deferred_count_splits_the_flagged_pixels(first_frame, case):
    """One frame into an empty map: created + dropped at capacity +
    deferred = flagged, with each limit binding in turn."""
    params, inputs, flagged = first_frame
    budget, capacity, n_eff = {
        "budget": (1024, 65536, 65536),
        "bucket": (16384, 65536, 512),
        "capacity": (16384, 512, 512),
        "budget and capacity": (2048, 512, 512)}[case]
    p = dataclasses.replace(params, max_creations_per_frame=budget)
    out = TF.integrate_frame_bucketed(TF.create_surfel_state(capacity, "cpu"),
                                      *inputs, p, n_eff)
    created = int(out.surfel_count)
    dropped = int(out.overflow_count)
    deferred = int(out.deferred_count)
    assert created == min(budget, n_eff, capacity)
    assert dropped == max(0, min(flagged, budget) - capacity)
    assert created + dropped + deferred == flagged
    assert deferred == flagged - min(flagged, budget) + \
        (min(flagged, budget, capacity) - created)


@pytest.fixture(scope="module")
def cpu_runs():
    """Per frame and frame_chunk 4 at 150x85 with a creation budget that
    binds (512 of ~6.6k flagged pixels a first view)."""
    video = replica_video(14, cut=8)
    runs = {}
    for chunk in (1, 4):
        cfg = replica_config(max_surfel_count=65536, shape_bucket_step=4096,
                             max_creations_per_frame=512, frame_chunk=chunk)
        runs[chunk] = run_pipeline(cfg, video, "cpu")
    return runs


def test_chunked_deferred_count_equals_per_frame(cpu_runs):
    one, four = cpu_runs[1], cpu_runs[4]
    assert_same_map(one.state, four.state)
    assert [s for s, _ in four.bucket_pick_log] == [4, 4, 4]
    # 12 fused frames, each making its budget's creations.
    assert int(one.state.surfel_count) == 12 * 512
    assert int(one.state.deferred_count) > 12 * 512


@pytest.mark.parametrize("chunk", [1, 4])
def test_trace_counters_read_the_confirmed_creations(cpu_runs, chunk):
    pipe = cpu_runs[chunk]
    counters = pipe.trace_counters()
    assert counters["creations.made"] == int(pipe.state.surfel_count)
    assert counters["creations.deferred"] == int(pipe.state.deferred_count)


def test_least_n_eff_follows_the_confirmed_count(cpu_runs):
    """The chunk step's floor (the policy's least_bucket) is the bucket of
    the confirmed count, which no pick goes below."""
    pipe = cpu_runs[4]
    least = pipe.policy.least_bucket()
    assert 0 < least <= pipe.shape_bucket_for(pipe.policy.confirmed_count)
    assert least % pipe.config.shape_bucket_step == 0
    picks = [n for _, n in pipe.bucket_pick_log]
    assert picks == sorted(picks) and picks[-1] >= least


def test_unreachable_graphs_are_retired(monkeypatch):
    """Before a capture, graphs below the policy's least_bucket are
    dropped and the cache is emptied once; none is dropped while all are
    reachable."""
    from surfelmeshing_tpu_torch import chunk as CH
    from surfelmeshing_tpu_torch.dispatch import DispatchPolicy
    emptied = []
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: emptied.append(1))
    cfg = replica_config(frame_chunk=4, shape_bucket_step=4096)
    policy = DispatchPolicy(cfg, None, replica_camera())
    step = CH.ChunkStep(cfg, "cpu", None, policy)
    step._graphs.update({(4, n, None): ("graph", {})
                         for n in (4096, 8192, 12288)})
    policy.confirmed_count = 4096
    step._retire_unreachable()
    assert len(step._graphs) == 3 and step.retired == 0 and not emptied
    policy.confirmed_count = 12288
    step._retire_unreachable()
    assert list(step._graphs) == [(4, 12288, None)]
    assert step.retired == 2 and emptied == [1]


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (csrc/preprocess.cu and csrc/blend.cu "
                    "have no CPU build)")
    return torch.device("cuda")


def replica_frame(seed: int, device):
    """kernel_timing's seeded frame at 1200x680 with its depths in units
    of 6553.5 a metre (a wall at ~1.8 m, a window beyond 3 m) and a band
    of pixels at the max_depth cut, 19,658-19,663 units."""
    depth, others, transforms = preprocess_inputs(seed, HEIGHT, WIDTH)
    depth = (depth.double() * (SCALE / 5000.0)).to(torch.int32)
    others = (others.double() * (SCALE / 5000.0)).to(torch.int32)
    band = torch.arange(WIDTH, dtype=torch.int32) % 6 + MAX_DEPTH_U16 - 2
    depth[HEIGHT // 2] = band
    others[:, HEIGHT // 2] = band
    return tuple(t.to(device) for t in (depth, others, transforms))


def camera_kw():
    return dict(fx=FOCAL, fy=FOCAL, cx=600.0, cy=340.0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [61, 2 ** 31 + 17])
def test_preprocess_kernels_equal_plain_passes(cuda_device, seed):
    depth, others, transforms = replica_frame(seed, cuda_device)
    for name, fn, args in preprocess_pass_args(depth, others, transforms,
                                               dict(CELL, **camera_kw())):
        before = pp.launches()
        got = getattr(pp, fn)(*args)
        torch.cuda.synchronize()
        assert pp.launches()[name] == before[name] + 1
        assert_bits_equal(got, getattr(pp, fn + "_reference")(*args))


def plain_chain(depth, others, transforms, kw):
    """preprocess_frame through the plain passes alone."""
    cam = (kw["fx"], kw["fy"], kw["cx"], kw["cy"])
    d = pp.bilateral_filter_and_cutoff_reference(
        depth, kw["sigma_xy"], kw["sigma_value_factor"], kw["radius_factor"],
        kw["max_depth_u16"], kw["depth_valid_region_radius"])
    d = pp.outlier_depth_map_fusion_reference(
        d, others, transforms, *cam, kw["tolerance"], kw["required_inliers"])
    d = pp.erode_depth_reference(d, kw["erosion_radius"])
    d, normals = pp.compute_normals_and_drop_bad_pixels_reference(
        d, kw["observation_angle_threshold_deg"], kw["depth_scaling"], *cam)
    d, radius_sq = pp.compute_point_radii_and_remove_isolated_reference(
        d, kw["point_radius_extension_factor"],
        kw["point_radius_clamp_factor"], kw["depth_scaling"], *cam)
    return d, normals, radius_sq


def capture(fn):
    """fn() warmed up on a side stream, then captured: -> (graph, its
    outputs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


@pytest.mark.cuda
def test_preprocess_frame_eager_and_in_a_cuda_graph(cuda_device):
    depth, others, transforms = replica_frame(71, cuda_device)
    kw = dict(CELL, **camera_kw())
    eager = pp.preprocess_frame(depth, others, transforms, **kw)
    torch.cuda.synchronize()
    assert_bits_equal(eager, plain_chain(depth, others, transforms, kw))
    assert int((eager[0] > 0).sum()) > HEIGHT * WIDTH // 8
    graph, captured = capture(
        lambda: pp.preprocess_frame(depth, others, transforms, **kw))
    for dst, src in zip((depth, others, transforms),
                        replica_frame(72, cuda_device)):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    assert_bits_equal(captured, plain_chain(depth, others, transforms, kw))
    assert not torch.equal(captured[0], eager[0])


def blend_maps(seed: int, device):
    """The blending kernel's four (680, 1200) f32 maps: depth in units of
    6553.5 a metre over three depth bands (many observation boundaries),
    70% supported pixels, the supporters' mean depth in metres."""
    rng = np.random.default_rng(seed)
    depth = np.floor(rng.integers(0, 3, (HEIGHT, WIDTH)) * SCALE +
                     rng.integers(0, 260, (HEIGHT, WIDTH))).astype(np.float32)
    supported = (rng.random((HEIGHT, WIDTH)) < 0.7).astype(np.float32)
    valid = (depth > 0).astype(np.float32)
    avg = (depth / SCALE +
           0.01 * rng.standard_normal((HEIGHT, WIDTH))).astype(np.float32)
    return [torch.from_numpy(m).to(device)
            for m in (depth, supported, valid, avg)]


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [12, 32])
def test_blend_kernel_equals_plain_version(cuda_device, radius):
    maps = blend_maps(81 + radius, cuda_device)
    before = blend.blend_core.launches
    got = blend.blend_core(*maps, radius, SCALE)
    torch.cuda.synchronize()
    assert blend.blend_core.launches == before + 1
    want = blend.blend_core_reference(*maps, radius, SCALE)
    assert_bits_equal(got, want)
    assert int((want != maps[0]).sum()) > 1000   # blending moved depths
    # The last row of cores (rows 672-679) is partial: it blended too.
    assert int((want[-8:] != maps[0][-8:]).sum()) > 10


@pytest.mark.cuda
def test_blend_kernel_in_a_cuda_graph(cuda_device):
    maps = blend_maps(91, cuda_device)
    graph, captured = capture(lambda: blend.blend_core(*maps, 12, SCALE))
    for dst, src in zip(maps, blend_maps(92, cuda_device)):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    assert_bits_equal(captured, blend.blend_core_reference(*maps, 12, SCALE))


@pytest.mark.cuda
def test_graph_replayed_chunks_keep_the_deferred_count(cuda_device):
    """Full-size frames with the default budget (2^15 creations a frame
    of ~400k flagged pixels): per-frame dispatch runs eagerly on the card,
    frame_chunk 4 replays CUDA graphs; both leave the same map and
    deferred total.  The map grows through buckets, and the graphs of the
    buckets left behind are retired."""
    from surfelmeshing_tpu_torch.dispatch import DispatchPolicy
    video = replica_video(18)
    runs, floors = {}, []
    least = DispatchPolicy.least_bucket

    def record(policy):
        floors.append(least(policy))
        return floors[-1]

    for chunk in (1, 4):
        cfg = replica_config(max_surfel_count=2_000_000, frame_chunk=chunk)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(DispatchPolicy, "least_bucket", record)
            runs[chunk] = run_pipeline(cfg, video, cuda_device)
    one, four = runs[1], runs[4]
    assert four.graph_captures >= 3 and four.graph_replays == 4
    assert four._chunk.retired >= 1
    assert len(four._chunk._graphs) == four.graph_captures - \
        four._chunk.retired
    assert all(k[1] >= floors[-1] for k in four._chunk._graphs)
    assert_same_map(one.state, four.state)
    assert int(one.state.surfel_count) == 16 * 2 ** 15
    assert int(one.state.deferred_count) > 16 * 2 ** 15
    for pipe in (one, four):
        counters = pipe.trace_counters()
        assert counters["creations.deferred"] == \
            int(pipe.state.deferred_count)
        assert counters["creations.made"] == int(pipe.state.surfel_count)
