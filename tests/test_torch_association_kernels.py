"""Data association's pixel maps (ops/association.py): the plain scatters
on the CPU and csrc/association.cu's kernels on the card.

- CPU: each map runs its plain version, launches nothing and never loads
  the kernel library; mixed and other devices raise; the card route's
  wrappers check their rows and hand the kernels the plain code's scalars
  (exercised on the CPU by standing in for the launch); and the kernels'
  algorithm, replayed in numpy (entries of pixels outside the map skipped,
  z's bits taken as int32 for the min, wrapping uint32 sums), gives the
  plain maps at 640x480 (unit 5000) and 1200x680 (unit 6553.5).
- Card (`cuda`): each kernel equals its plain version run on the same
  CUDA tensors bit for bit on seeded maps at both shapes: rows past
  surfel_count, behind the camera and off the image, side pixels at the
  image border, no valid entry, one pixel hit by hundreds of rows, a
  tiled working set's global indices, a bucket's leading rows; captured
  in a CUDA graph and replayed on new rows, with the launch counters
  moved as the chunk graphs move them; and a pipeline's frames, per frame
  and replayed from chunk graphs, launch each kernel once a fused frame
  and equal the plain maps' run.

This file imports no JAX and nothing of the JAX package, so `python -m
pytest tests/test_torch_association_kernels.py -m cuda` runs on the card.
"""

import numpy as np
import pytest
import torch

from surfelmeshing_tpu_torch.config import SurfelMeshingConfig
from surfelmeshing_tpu_torch.io.synthetic import synthetic_rgbd_video
from surfelmeshing_tpu_torch.ops import association as A
from surfelmeshing_tpu_torch.ops import blend, launch_counts
from surfelmeshing_tpu_torch.pipeline import ReconstructionPipeline
from surfelmeshing_tpu_torch.tools.kernel_timing import association_inputs

torch.set_num_threads(1)

INVALID = A.INVALID_INDEX
# (height, width, focal length, depth unit): Kinect v1 and Replica.
SHAPES = {"640x480": (480, 640, 525.0, 5000.0),
          "1200x680": (680, 1200, 600.0, 6553.5)}
ROWS = 60_000


def seeded_rows(seed, shape, n=ROWS, case="seeded"):
    """(hw, depth unit, rows) of a seeded map at `shape`, changed for
    `case`."""
    h, w, focal, scale = SHAPES[shape]
    r = association_inputs(seed, n, h, w, focal, count=n - n // 16)
    rng = np.random.default_rng(seed)
    if case == "border":
        # Side pixels on the image's first and last rows and columns.
        pick = torch.from_numpy(rng.choice(n, 4000, replace=False))
        edges = torch.tensor([0, w - 1, (h - 1) * w, h * w - 1, w, 2 * w - 1,
                              (h - 2) * w, 3], dtype=torch.int32)
        r["pix_a"][pick] = edges[torch.arange(4000) % 8]
        r["pix_b"][pick] = edges[(torch.arange(4000) + 3) % 8]
        r["z"][pick] = torch.from_numpy(
            rng.uniform(0.3, 4.0, 4000).astype(np.float32))
        r["support_a"][pick] = torch.from_numpy(rng.random(4000) < 0.7)
        r["support_b"][pick] = torch.from_numpy(rng.random(4000) < 0.7)
    elif case == "none valid":
        r["pix_a"].fill_(INVALID)
        r["pix_b"].fill_(INVALID)
        r["support_a"].fill_(False)
        r["support_b"].fill_(False)
    elif case == "one pixel":
        # 700 rows on one pixel (and 300 of them on its right neighbour),
        # with ties in z.
        pick = torch.from_numpy(rng.choice(n, 700, replace=False))
        target = (h // 2) * w + w // 2
        r["pix_a"][pick] = target
        r["pix_b"][pick] = torch.where(torch.arange(700) < 300, target + 1,
                                       INVALID).to(torch.int32)
        r["z"][pick] = torch.from_numpy(
            rng.choice([1.25, 1.5, 2.0], 700).astype(np.float32))
        r["support_a"][pick] = True
        r["support_b"][pick] = r["pix_b"][pick] != INVALID
    elif case == "tiled":
        # A working set's rows carry global indices, INVALID_INDEX on
        # unused slots (which project nowhere).
        tiles = torch.from_numpy(rng.permutation(-(-n // 256))) * 256
        r["idx"] = (tiles[:, None] + torch.arange(256)).reshape(-1)[:n] \
            .to(torch.int32) + 3_000_000
        unused = torch.arange(n) >= n - 1024
        r["idx"][unused] = INVALID
        for k in ("pix_a", "pix_b"):
            r[k][unused] = INVALID
        for k in ("support_a", "support_b"):
            r[k][unused] = False
    elif case == "bucket":
        # A bucket's leading rows of a larger map: views of the first rows.
        r = {k: v[: n // 2 + 77] for k, v in r.items()}
    return h * w, scale, r


CASES = ("seeded", "border", "none valid", "one pixel", "tiled", "bucket")


def maps(r, hw, scale, plain=False):
    """min_depth_map, support_maps and the conflictor's min_index_map (on
    the support flags' negation within the in-image sides) of `r`."""
    sfx = "_reference" if plain else ""
    other_a = (r["pix_a"] != INVALID) & ~r["support_a"]
    other_b = (r["pix_b"] != INVALID) & ~r["support_b"]
    return (getattr(A, "min_depth_map" + sfx)(
                hw, r["pix_a"], r["pix_b"], r["z"]),
            *getattr(A, "support_maps" + sfx)(
                hw, r["pix_a"], r["pix_b"], r["support_a"], r["support_b"],
                r["idx"], r["z"], scale),
            getattr(A, "min_index_map" + sfx)(
                hw, r["pix_a"], r["pix_b"], other_a, other_b, r["idx"]))


def bits(t):
    return t.contiguous().view(torch.int32).cpu()


def assert_bits_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(bits(g), bits(w)), \
            f"{int((bits(g) != bits(w)).sum())} words differ"


# -- the CPU route ------------------------------------------------------------

@pytest.fixture
def no_library(monkeypatch):
    """Fails the test if anything loads the kernel library."""
    def refuse():
        raise AssertionError("the CPU route loaded the kernel library")
    monkeypatch.setattr(A, "load_library", refuse)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_cpu_route_runs_the_plain_scatters(no_library, shape):
    hw, scale, r = seeded_rows(1, shape, 4000)
    before = A.launches()
    got = maps(r, hw, scale)
    assert A.launches() == before
    assert_bits_equal(got, maps(r, hw, scale, plain=True))
    assert float(got[0].min()) > 0 and int((got[2] >> A.SUM_BITS).max()) > 0


def kernels_in_numpy(r, hw, scale):
    """csrc/association.cu's algorithm over the rows in numpy: entries of
    pixels outside [0, hw) skipped, the least z by its bits as int32, the
    least index, and the uint32 sum of depth units + 1 << SUM_BITS."""
    def sides(on_a=None, on_b=None):
        for pix, on in ((r["pix_a"].numpy(), on_a), (r["pix_b"].numpy(),
                                                     on_b)):
            ok = (pix >= 0) & (pix < hw)
            yield pix, ok if on is None else ok & on.numpy()

    first = np.full(hw, np.inf, np.float32).view(np.int32)
    for pix, ok in sides():
        np.minimum.at(first, pix[ok], r["z"].numpy().view(np.int32)[ok])
    units = np.clip(np.rint(r["z"].numpy() * np.float32(scale)), 0,
                    A.DEPTH_UNITS_MAX).astype(np.uint32) + (1 << A.SUM_BITS)
    index = np.full(hw, INVALID, np.int32)
    packed = np.zeros(hw, np.uint32)
    for pix, ok in sides(r["support_a"], r["support_b"]):
        np.minimum.at(index, pix[ok], r["idx"].numpy()[ok])
        np.add.at(packed, pix[ok], units[ok])
    return (torch.from_numpy(first).view(torch.float32),
            torch.from_numpy(index),
            torch.from_numpy(packed.view(np.int32)))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("case", CASES)
def test_the_kernels_algorithm_gives_the_plain_maps(shape, case):
    hw, scale, r = seeded_rows(2, shape, 8000, case)
    assert_bits_equal(kernels_in_numpy(r, hw, scale),
                      maps(r, hw, scale, plain=True)[:3])


@pytest.fixture
def card_route(monkeypatch):
    """The card route's wrappers on CPU tensors: the route is forced and
    each launch is recorded as (kernel, arguments) instead."""
    calls = []
    monkeypatch.setattr(A, "_on_card", lambda name, *tensors: True)
    monkeypatch.setattr(A, "_launch", lambda kernel, device, *args:
                        calls.append((kernel, list(args))))
    saved = launch_counts.snapshot()
    yield calls
    launch_counts.restore(saved)


def test_card_route_hands_the_kernels_the_rows(card_route):
    hw, scale, r = seeded_rows(3, "1200x680", 512)
    before = A.launches()
    first, (index, packed), conflictors = A.min_depth_map(
        hw, r["pix_a"], r["pix_b"], r["z"]), A.support_maps(
        hw, r["pix_a"], r["pix_b"], r["support_a"], r["support_b"],
        r["idx"], r["z"], scale), A.min_index_map(
        hw, r["pix_a"], r["pix_b"], r["support_a"], r["support_b"], r["idx"])
    assert A.launches() == {"min_depth": before["min_depth"] + 1,
                            "support": before["support"] + 2}
    assert [k for k, _ in card_route] == ["min_depth", "support", "support"]
    ptr = lambda t: t.data_ptr()
    rows = [ptr(r[k]) for k in ("pix_a", "pix_b", "support_a", "support_b",
                                "idx")]
    assert card_route[0][1] == [*rows[:2], ptr(r["z"]), 512, ptr(first), hw]
    assert card_route[1][1] == [*rows, ptr(r["z"]), 512, scale, ptr(index),
                                ptr(packed), hw]
    assert card_route[2][1][:6] == [*rows, None]
    assert card_route[2][1][6:] == [512, 0.0, ptr(conflictors), None, hw]
    # The maps' fills: what no entry reaches keeps them.
    assert torch.equal(first, torch.full((hw,), np.inf))
    assert torch.equal(index, torch.full((hw,), INVALID, dtype=torch.int32))
    assert torch.equal(packed, torch.zeros(hw, dtype=torch.int32))


@pytest.mark.parametrize("case", ["int64 pixels", "float idx", "short z",
                                  "int flags", "2-d rows"])
def test_card_route_checks_the_rows(card_route, case):
    hw, scale, r = seeded_rows(4, "640x480", 256)
    if case == "int64 pixels":
        r["pix_a"] = r["pix_a"].long()
    elif case == "float idx":
        r["idx"] = r["idx"].float()
    elif case == "short z":
        r["z"] = r["z"][:-1]
    elif case == "int flags":
        r["support_b"] = r["support_b"].to(torch.int32)
    else:
        r = {k: v[None] for k, v in r.items()}
    with pytest.raises(ValueError, match="must be"):
        if case in ("int64 pixels", "short z", "2-d rows"):
            A.min_depth_map(hw, r["pix_a"], r["pix_b"], r["z"])
        A.support_maps(hw, r["pix_a"], r["pix_b"], r["support_a"],
                       r["support_b"], r["idx"], r["z"], scale)
    assert card_route == []


@pytest.mark.parametrize("devices", [("cpu", "meta"), ("meta", "meta")])
def test_route_refuses_mixed_and_other_devices(devices):
    hw, scale, r = seeded_rows(5, "640x480", 128)
    pix_a = r["pix_a"].to(devices[0])
    rest = {k: v.to(devices[1]) for k, v in r.items()}
    for call in (
            lambda: A.min_depth_map(hw, pix_a, rest["pix_b"], rest["z"]),
            lambda: A.support_maps(hw, pix_a, rest["pix_b"],
                                   rest["support_a"], rest["support_b"],
                                   rest["idx"], rest["z"], scale),
            lambda: A.min_index_map(hw, pix_a, rest["pix_b"],
                                    rest["support_a"], rest["support_b"],
                                    rest["idx"])):
        with pytest.raises(ValueError, match="one CUDA device"):
            call()


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (csrc/association.cu has no CPU "
                    "build)")
    return torch.device("cuda")


def on_card(r):
    return {k: v.cuda() for k, v in r.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("case", CASES)
def test_kernels_equal_plain_scatters(cuda_device, shape, case):
    hw, scale, r = seeded_rows(11, shape, ROWS, case)
    r = on_card(r)
    before = A.launches()
    got = maps(r, hw, scale)
    torch.cuda.synchronize()
    assert A.launches() == {"min_depth": before["min_depth"] + 1,
                            "support": before["support"] + 2}
    assert_bits_equal(got, maps(r, hw, scale, plain=True))


@pytest.mark.cuda
def test_kernels_at_a_replica_sized_map(cuda_device):
    """Seven and a half million rows at 1200x680, most out of view."""
    hw, scale, r = seeded_rows(2 ** 31 + 9, "1200x680", 7_500_000)
    r = on_card(r)
    assert_bits_equal(maps(r, hw, scale), maps(r, hw, scale, plain=True))


@pytest.mark.cuda
def test_kernels_in_a_cuda_graph(cuda_device):
    """Captured, the wrappers count their launches as chunk.py counts a
    graph's (what the capture added is the graph's, added at each replay);
    replayed on new rows in the captured buffers, they give those rows'
    plain maps."""
    hw, scale, r = seeded_rows(21, "1200x680")
    r = on_card(r)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        maps(r, hw, scale)
    torch.cuda.current_stream().wait_stream(side)
    saved = launch_counts.snapshot()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = maps(r, hw, scale)
    added = launch_counts.since(saved)
    assert {k: v for k, v in added.items() if v} == {
        "association_min_depth": 1, "association_support": 2}
    launch_counts.restore(saved)
    _, _, r2 = seeded_rows(22, "1200x680")
    for k, v in r2.items():
        r[k].copy_(v)
    for _ in range(3):
        graph.replay()
        launch_counts.add(added)
    torch.cuda.synchronize()
    assert A.launches() == {"min_depth": saved["association_min_depth"] + 3,
                            "support": saved["association_support"] + 6}
    assert_bits_equal(captured, maps(r, hw, scale, plain=True))


def run_pipeline(device, chunk):
    video, _ = synthetic_rgbd_video(10, 320, 240, noise_sigma=0.002)
    cfg = SurfelMeshingConfig(max_surfel_count=400_000, frame_chunk=chunk,
                              outlier_filtering_frame_count=2,
                              restrict_fps_to=0)
    pipe = ReconstructionPipeline(cfg, video.depth_camera, device)
    blends, before = blend.blend_core.launches, A.launches()
    for i in range(video.frame_count):
        pipe.process_frame(video, i)
    pipe.drain()
    fused = blend.blend_core.launches - blends
    return pipe, fused, {k: v - before[k] for k, v in A.launches().items()}


@pytest.mark.cuda
def test_pipeline_launches_two_kernels_a_fused_frame(cuda_device,
                                                     monkeypatch):
    """Per frame (eager) and chunked (graph replays): one launch of each
    kernel a fused frame (one blending launch each), and the maps of the
    plain scatters leave the same map."""
    runs = {chunk: run_pipeline(cuda_device, chunk) for chunk in (1, 4)}
    for chunk, (pipe, fused, launched) in runs.items():
        assert fused > 0
        assert launched == {"min_depth": fused, "support": fused}, chunk
        assert pipe.trace_counters()["association_launches"] == \
            sum(A.launches().values())
    assert runs[4][0].graph_replays > 0
    for name in ("min_depth_map", "support_maps"):
        monkeypatch.setattr(A, name, getattr(A, name + "_reference"))
    plain, _, launched = run_pipeline(cuda_device, 1)
    assert launched == {"min_depth": 0, "support": 0}
    for pipe, _, _ in runs.values():
        for name in ("pack", "neighbors", "nbr_dist", "surfel_count",
                     "merge_count", "overflow_count", "deferred_count"):
            assert torch.equal(bits(getattr(pipe.state, name)),
                               bits(getattr(plain.state, name))), name
