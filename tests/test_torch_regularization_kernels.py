"""Regularisation, phase 8 of the fusion step in its symmetric form
(ops/regularization.py): the plain version on the CPU and
csrc/regularization.cu on the card.

- CPU: the plain route gives the JAX package's regularisation iteration
  (`_regularize`) on seeded maps, with fast_neighbor_update on and off,
  `gsrc` the pack or a distinct map, at frame 0 and past the window,
  launching nothing and never loading the kernel library; the seeded
  inputs of tools/kernel_timing.py hold every kind of row and slot phase
  8 meets; the fusion step routes the symmetric form through the wrapper
  (with the synced map) and the exact form past it; the card route hands
  the kernel its arguments (pointers, strides, the frame index by value
  or by pointer, f32 scalars) in the layout of the kernel's argument
  struct, and checks device, dtype and shape; mixed and other devices
  raise.
- Card (`cuda`): the kernel equals the plain version run on the same CUDA
  tensors bit for bit with fast_neighbor_update on and off, on each
  layout (`gsrc` the pack, a distinct map of tiles, strided neighbour
  views), over one and two iterations, at frame 0 and past the window;
  captured in a CUDA graph and replayed with a new frame index, counted
  as the chunk graphs count; and a pipeline's frames, per frame and
  replayed from chunk graphs, launch it once a fused frame (none with
  the exact form) and leave the map the plain version leaves.

This file imports no JAX at module level (the JAX cases import it in
their body and skip without it), so `python -m pytest --noconftest
tests/test_torch_regularization_kernels.py -m cuda` runs on the card.
"""

import ctypes
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from surfelmeshing_tpu_torch.config import SurfelMeshingConfig
from surfelmeshing_tpu_torch.io.synthetic import synthetic_rgbd_video
from surfelmeshing_tpu_torch.ops import blend, launch_counts
from surfelmeshing_tpu_torch.ops import fusion as TF
from surfelmeshing_tpu_torch.ops import regularization as R
from surfelmeshing_tpu_torch.pipeline import ReconstructionPipeline
from surfelmeshing_tpu_torch.tools import kernel_timing as KT

torch.set_num_threads(1)

CARD_ROWS = 1_000_000
FRAMES = {"frame 0": 0, "past the window": 500}


def bits(t):
    return t.contiguous().view(torch.int32).cpu()


def assert_bits_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(bits(g), bits(w)), \
            f"{int((bits(g) != bits(w)).sum())} words differ"


def inputs(seed, n, fast=True, layout="rows", frame=500, device="cpu"):
    """Seeded inputs; off the tiled layout the last sixteenth of the rows
    unused."""
    return KT.regularization_inputs(
        seed, n, frame=frame, fast=fast, layout=layout,
        count=None if layout == "tiled" else n - n // 16, device=device)


# -- the CPU route ------------------------------------------------------------

@pytest.fixture
def no_library(monkeypatch):
    """Fails the test if anything loads the kernel library."""
    def refuse():
        raise AssertionError("the CPU route loaded the kernel library")
    monkeypatch.setattr(R, "load_library", refuse)


@pytest.mark.parametrize("frame", list(FRAMES))
@pytest.mark.parametrize("layout", ["rows", "tiled"])
@pytest.mark.parametrize("fast", [True, False], ids=["fast", "full"])
def test_plain_route_gives_the_jax_iteration(no_library, fast, layout,
                                             frame):
    """The plain route on a seeded map of 3,000 rows gives eager JAX's
    symmetric regularisation iteration (its `_regularize`, reading
    neighbours from the same map) word for word, launching nothing."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from surfelmeshing_tpu.ops import fusion as JF

    inp = inputs(5, 3000, fast, layout, FRAMES[frame])
    before = launch_counts.snapshot()
    got = R.regularize(inp["pack"], inp["gsrc"], inp["neighbors"],
                       inp["nbr_dist"], inp["frame"], inp["params"])
    assert launch_counts.snapshot() == before
    params = JF.FusionParams(**dataclasses.asdict(inp["params"]))
    gsrc = jnp.asarray(inp["gsrc"].numpy())
    with jax.disable_jit():
        want = JF._regularize(
            params, jnp.asarray(inp["pack"].numpy()),
            jnp.asarray(inp["neighbors"].numpy()),
            jnp.asarray(inp["nbr_dist"].numpy()), jnp.int32(inp["frame"]),
            lambda p: p if layout == "rows" else gsrc)
    for name, g, w in zip(("pack", "neighbors", "nbr_dist"), got, want):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32),
                                      err_msg=name)


@pytest.mark.parametrize("frame", list(FRAMES))
@pytest.mark.parametrize("layout", KT.REGULARIZATION_LAYOUTS)
def test_seeded_inputs_hold_every_kind_of_row(no_library, layout, frame):
    """The card tests' inputs (kernel_timing.regularization_inputs): rows
    in and out of the window, merged rows among the recent ones, rows
    with no slot; edges from neighbours with a stored count of 0, slots at
    merge tombstones and out of range, slots dropped for drifting, steps
    clamped to the radius."""
    inp = inputs(1, 40_000, layout=layout, frame=FRAMES[frame])
    kinds = KT.regularization_row_kinds(inp, KT.regularize(inp))
    assert all(v > 0 for v in kinds.values()), kinds


@pytest.mark.parametrize("symmetric", [True, False],
                         ids=["symmetric", "exact"])
def test_fusion_routes_phase_8(monkeypatch, symmetric):
    """fusion._regularize hands the symmetric form to the wrapper with the
    synced map as `gsrc` (here a tiled working set's), and runs the exact
    form (full shapes only) past it, plain as before, on every device."""
    inp = inputs(6, 4096, layout="tiled" if symmetric else "rows")
    params = dataclasses.replace(inp["params"],
                                 symmetric_regularization=symmetric)
    calls = []

    def wrapper(pack, gsrc, *rest):
        calls.append(gsrc)
        return R.regularize_reference(pack, gsrc, *rest)

    monkeypatch.setattr(R, "regularize", wrapper)
    got = TF._regularize(params, inp["pack"], inp["neighbors"],
                         inp["nbr_dist"], inp["frame"],
                         lambda pack: inp["gsrc"])
    if symmetric:
        assert len(calls) == 1 and calls[0] is inp["gsrc"]
        want = R.regularize_reference(inp["pack"], inp["gsrc"],
                                      inp["neighbors"], inp["nbr_dist"],
                                      inp["frame"], params)
    else:
        assert calls == []
        want = TF._regularize_exact(params, inp["pack"], inp["gsrc"],
                                    inp["neighbors"], inp["nbr_dist"],
                                    inp["frame"])
    assert_bits_equal(got, want)


@pytest.fixture
def card_route(monkeypatch):
    """The card route's wrapper on CPU tensors: the route is forced and
    each launch is recorded as (arguments, device) instead."""
    calls = []
    monkeypatch.setattr(R, "_on_card", lambda name, *tensors: True)
    monkeypatch.setattr(R, "_launch", lambda args, device:
                        calls.append((args, device)))
    saved = launch_counts.snapshot()
    yield calls
    launch_counts.restore(saved)


def call(inp, **changes):
    a = dict(inp, **changes)
    return R.regularize(a["pack"], a["gsrc"], a["neighbors"], a["nbr_dist"],
                        a["frame"], a["params"])


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "full"])
@pytest.mark.parametrize("frame", ["int", "tensor"])
def test_card_route_hands_the_kernel_its_arguments(card_route, frame, fast):
    inp = inputs(2, 512, fast, layout="bucket")
    frame_t = torch.tensor(inp["frame"], dtype=torch.int32)
    before = R.regularize.launches
    pack, nbr, dist = call(inp, frame=frame_t if frame == "tensor"
                           else inp["frame"])
    assert R.regularize.launches == before + 1
    (args, device), = card_route
    assert device == pack.device and pack is not inp["pack"]
    assert pack.shape == (512, TF.PACK_WIDTH) and pack.is_contiguous()
    assert nbr.shape == (4, 512) and nbr.is_contiguous()
    assert nbr.dtype == torch.int32
    assert (args.pack, args.gsrc, args.pack_out, args.nbr_out, args.n,
            args.n_src) == (inp["pack"].data_ptr(), inp["pack"].data_ptr(),
                            pack.data_ptr(), nbr.data_ptr(), 512, 512)
    # The bucket's neighbour view is read in place, with its stride.
    assert (args.nbr_in, args.nbr_stride) == (
        inp["neighbors"].data_ptr(), 512 + 4096)
    if fast:
        assert dist.shape == (4, 512) and dist.dtype == torch.float32
        assert dist.is_contiguous() and args.dist_out == dist.data_ptr()
    else:      # the slot distances pass through: no output
        assert dist is inp["nbr_dist"] and args.dist_out is None
    if frame == "tensor":
        assert (args.frame, args.frame_value) == (frame_t.data_ptr(), 0)
    else:
        assert (args.frame, args.frame_value) == (None, inp["frame"])
    params = inp["params"]
    f32 = np.float32
    w = f32(params.regularizer_weight)
    assert args.window == params.regularization_frame_window_size
    assert (args.two_w, args.w, args.one_plus_w) == (2 * w, w, 1 + w)
    assert args.reg_factor_sq == f32(
        params.radius_factor_for_regularization_neighbors ** 2)


def test_card_route_reads_a_distinct_map(card_route):
    inp = inputs(3, 1024, layout="tiled")
    call(inp)
    (args, _), = card_route
    assert (args.gsrc, args.n, args.n_src) == (
        inp["gsrc"].data_ptr(), 1024, inp["gsrc"].shape[0])
    assert args.n_src == 2048 and args.nbr_stride == 1024


def test_argument_struct_matches_the_kernel():
    """_Args lists csrc/regularization.cu's RegularizeArgs fields in
    order, each of the C type's size."""
    src = (Path(R.__file__).parents[1] / "csrc" / "regularization.cu") \
        .read_text()
    body = re.search(r"struct RegularizeArgs \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*([\w ]+?\*?)\s*(\w+);", body, re.M)
    size = {"long long": 8, "int": 4, "float": 4}
    want = [(name, 8 if kind.endswith("*") else size[kind])
            for kind, name in fields]
    assert [(name, ctypes.sizeof(kind)) for name, kind in R._Args._fields_] \
        == want


CHECK_CASES = ["f64 pack", "narrow pack", "1-d pack", "narrow gsrc",
               "empty gsrc", "int64 neighbors", "short neighbors",
               "3 slots", "f64 nbr_dist", "short nbr_dist", "int64 frame",
               "1-d frame"]


@pytest.mark.parametrize("case", CHECK_CASES)
def test_card_route_checks_its_inputs(card_route, case):
    inp = inputs(4, 256)
    pack, nbr, dist = inp["pack"], inp["neighbors"], inp["nbr_dist"]
    changes = {}
    if case == "f64 pack":
        changes["pack"] = pack.double()
    elif case == "narrow pack":
        changes["pack"] = pack[:, :17].contiguous()
    elif case == "1-d pack":
        changes["pack"] = pack.reshape(-1)
    elif case == "narrow gsrc":
        changes["gsrc"] = pack[:, :17].contiguous()
    elif case == "empty gsrc":
        changes["gsrc"] = pack[:0]
    elif case == "int64 neighbors":
        changes["neighbors"] = nbr.long()
    elif case == "short neighbors":
        changes["neighbors"] = nbr[:, 1:]
    elif case == "3 slots":
        changes["neighbors"] = nbr[:3]
    elif case == "f64 nbr_dist":
        changes["nbr_dist"] = dist.double()
    elif case == "short nbr_dist":
        changes["nbr_dist"] = dist[:, 1:]
    elif case == "int64 frame":
        changes["frame"] = torch.tensor(inp["frame"])
    else:
        changes["frame"] = torch.tensor([inp["frame"], 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="regularize"):
        call(inp, **changes)
    assert card_route == []


@pytest.mark.parametrize("devices", [("cpu", "meta"), ("meta", "meta")])
def test_route_refuses_mixed_and_other_devices(devices):
    inp = inputs(4, 128)
    moved = dict(inp, gsrc=inp["gsrc"].to(devices[1]),
                 neighbors=inp["neighbors"].to(devices[1]),
                 nbr_dist=inp["nbr_dist"].to(devices[1]),
                 pack=inp["pack"].to(devices[0]))
    with pytest.raises(ValueError, match="one CUDA device"):
        call(moved)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (csrc/regularization.cu has no "
                    "CPU build)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("frame", list(FRAMES))
@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("layout", KT.REGULARIZATION_LAYOUTS)
@pytest.mark.parametrize("fast", [True, False], ids=["fast", "full"])
def test_kernel_equals_plain_version(cuda_device, fast, layout, iterations,
                                     frame):
    """1M rows with every kind of row and slot: the kernel's iterations
    give the plain version's, word for word, one launch an iteration."""
    inp = inputs(2 ** 31 + 17, CARD_ROWS, fast, layout, FRAMES[frame],
                 cuda_device)
    before = R.regularize.launches
    got = KT.regularize(inp, iterations=iterations)
    torch.cuda.synchronize()
    assert R.regularize.launches == before + iterations
    want = KT.regularize(inp, plain=True, iterations=iterations)
    assert_bits_equal(got, want)
    if not fast:
        assert got[2] is inp["nbr_dist"]
    kinds = KT.regularization_row_kinds(inp, KT.regularize(inp))
    assert all(v > 0 for v in kinds.values()), kinds


@pytest.mark.cuda
def test_kernel_in_a_cuda_graph(cuda_device):
    """Captured with the frame index in a device tensor, the launch counts
    as chunk.py counts a graph's; replayed on another map's inputs copied
    into the captured buffers, with a new frame index, it gives their
    plain result."""
    first = inputs(41, 400_000, device=cuda_device)
    second = inputs(42, 400_000, frame=777, device=cuda_device)
    frame = torch.tensor(first["frame"], dtype=torch.int32,
                         device=cuda_device)
    buf = dict(first, pack=first["pack"].clone())
    buf["gsrc"] = buf["pack"]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        KT.regularize(buf, frame=frame)
    torch.cuda.current_stream().wait_stream(side)
    saved = launch_counts.snapshot()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = KT.regularize(buf, frame=frame)
    added = launch_counts.since(saved)
    assert {k: v for k, v in added.items() if v} == {"regularization": 1}
    launch_counts.restore(saved)
    for key in ("pack", "neighbors", "nbr_dist"):
        buf[key].copy_(second[key])
    frame.fill_(second["frame"])
    for _ in range(3):
        graph.replay()
        launch_counts.add(added)
    torch.cuda.synchronize()
    assert R.regularize.launches == saved["regularization"] + 3
    assert_bits_equal(captured, KT.regularize(second, plain=True))


def run_pipeline(device, chunk, modes=None):
    video, _ = synthetic_rgbd_video(10, 320, 240, noise_sigma=0.002)
    cfg = SurfelMeshingConfig(max_surfel_count=400_000, frame_chunk=chunk,
                              outlier_filtering_frame_count=2,
                              restrict_fps_to=0)
    pipe = ReconstructionPipeline(cfg, video.depth_camera, device)
    if modes:
        pipe.fusion_params = dataclasses.replace(pipe.fusion_params, **modes)
    blends, before = blend.blend_core.launches, regularization_launches()
    for i in range(video.frame_count):
        pipe.process_frame(video, i)
    pipe.drain()
    return (pipe, blend.blend_core.launches - blends,
            regularization_launches() - before)


def regularization_launches():
    """The kernel's launches so far, read through the registry (a test
    may stand the plain version in for the wrapper)."""
    return launch_counts.snapshot()["regularization"]


@pytest.mark.cuda
def test_pipeline_launches_one_kernel_a_fused_frame(cuda_device,
                                                    monkeypatch):
    """Per frame (eager) and chunked (graph replays): one launch a fused
    frame (one blending launch each), none with the exact form, and the
    plain version leaves the same map."""
    runs = {chunk: run_pipeline(cuda_device, chunk) for chunk in (1, 4)}
    for chunk, (pipe, fused, launched) in runs.items():
        assert fused > 0 and launched == fused, chunk
        assert pipe.trace_counters()["regularization_launches"] == \
            regularization_launches()
    assert runs[4][0].graph_replays > 0
    _, fused, launched = run_pipeline(
        cuda_device, 4, dict(symmetric_regularization=False))
    assert fused > 0 and launched == 0
    monkeypatch.setattr(R, "regularize", R.regularize_reference)
    plain, _, _ = run_pipeline(cuda_device, 1)
    for pipe, _, _ in runs.values():
        for name in ("pack", "neighbors", "nbr_dist", "surfel_count",
                     "merge_count", "overflow_count", "deferred_count"):
            assert torch.equal(bits(getattr(pipe.state, name)),
                               bits(getattr(plain.state, name))), name
