"""Tile selection of active-set fusion (ops/tiling.py): the plain version
on the CPU and csrc/tiling.cu's tile_select_kernel on the card.

- CPU: the seeded maps of tools/kernel_timing.py hold every kind of row
  the selection meets, and rows none of its tests flags; the CPU route
  launches nothing and never loads the kernel library; the card route
  hands the kernel its arguments (pointers, the frame index by value or
  by pointer, f32 scalars) in the layout of the kernel's argument
  struct, and checks dtype, shape and whole tiles; mixed and other
  devices raise; the kernel's byte bound counts the words its tests
  read, row by row.
- Card (`cuda`): the kernel equals the plain version run on the same CUDA
  tensors bit for bit on a 20,000,768-row map (the default capacity in
  tiles of 4,096) with 0.5M and 1.8M live rows, with and without
  fast_neighbor_update, with the frame index by value and in a device
  tensor; at the window's edge, on slots pointing at tombstones and
  INVALID_INDEX slots, and with the live count on and off tile
  boundaries (0, one row, a tile, a tile and one row, every row);
  captured in a CUDA graph and replayed with a new count and frame
  index; and a pipeline under the auto budget, per frame and chunked,
  launches it once a tiled frame and leaves the map of the count-sized
  pipeline.

This file imports no JAX, so `python -m pytest --noconftest
tests/test_torch_tiling_kernels.py -m cuda` runs on the card.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from surfelmeshing_tpu_torch.config import SurfelMeshingConfig
from surfelmeshing_tpu_torch.io.synthetic import synthetic_rgbd_video
from surfelmeshing_tpu_torch.ops import launch_counts
from surfelmeshing_tpu_torch.ops import fusion as TF
from surfelmeshing_tpu_torch.ops import tiling as T
from surfelmeshing_tpu_torch.pipeline import ReconstructionPipeline
from surfelmeshing_tpu_torch.tools import kernel_timing as KT

torch.set_num_threads(1)

CAPACITY = 20_000_768            # 20,000,000 rounded up to 4,096-row tiles
LIVE = (500_000, 1_800_000)


def small(seed=1, fast=True, device="cpu"):
    return KT.tiling_inputs(seed, 65_536, 40_000, tile_size=256, fast=fast,
                            device=device)


# -- the CPU route ------------------------------------------------------------

@pytest.fixture
def no_library(monkeypatch):
    """Fails the test if anything loads the kernel library."""
    def refuse():
        raise AssertionError("the CPU route loaded the kernel library")
    monkeypatch.setattr(T, "load_library", refuse)


@pytest.mark.parametrize("fast", [True, False])
def test_seeded_inputs_hold_every_kind_of_row(no_library, fast):
    """Every test of the selection flags some live rows of the card
    tests' inputs, and some live rows none flags."""
    inp = small(fast=fast)
    kinds = KT.tiling_row_kinds(inp)
    assert all(v > 0 for v in kinds.values()), kinds
    flags = KT.tile_select(inp)
    assert flags.dtype == torch.bool and flags.shape == (65_536 // 256,)
    assert 0 < int(flags.sum()) < 40_000 // 256


@pytest.mark.parametrize("fast", [True, False])
def test_bound_counts_the_words_the_tests_read(no_library, fast):
    """tiling_bound's bytes: row by row, the words the kernel's tests read
    up to the first that flags the row (its stamp, its recent-neighbour
    count, its position; then per slot the slot and a valid neighbour's
    stamp, detach flag without fast_neighbor_update, and position), each
    distinct word once, and one byte a flagged tile."""
    inp = KT.tiling_inputs(3, 8_192, 6_000, tile_size=256, fast=fast)
    params, pack, nbr = inp["params"], inp["pack"], inp["neighbors"]
    since = inp["frame"] - params.regularization_frame_window_size - 1
    stamps = pack.view(torch.int32)[:, TF.STAMP].tolist()
    rcnt = pack[:, TF.RCNT].tolist()
    detach = pack[:, TF.DETACH].tolist()
    view = T._in_view(params, inp["local_T_global"],
                      *pack[:, :3].unbind(1)).tolist()
    slots = nbr.tolist()
    words, tiles = set(), set()
    for i in range(6_000):
        words.add((i, "stamp"))
        flag = stamps[i] >= since
        if not flag:
            words.add((i, "rcnt"))
            flag = rcnt[i] != 0
        if not flag:
            words.update((i, c) for c in "xyz")
            flag = view[i]
        for k in range(4):
            if flag:
                break
            words.add((k, i, "slot"))
            j = slots[k][i]
            if j == T.INVALID_INDEX:
                continue
            j = 0 if j < 0 or j >= 8_192 else j
            words.add((j, "stamp"))
            flag = stamps[j] >= since or stamps[j] == 0
            if not flag and not fast:
                words.add((j, "detach"))
                flag = detach[j] > 0
            if not flag:
                words.update((j, c) for c in "xyz")
                flag = view[j]
        if flag:
            tiles.add(i // 256)
    assert tiles == set(torch.nonzero(KT.tile_select(inp)).view(-1).tolist())
    want = 4 * len(words) + len(tiles)
    assert KT.tiling_bound(inp)["bytes"] == want
    assert want < 36 * 6_000


@pytest.fixture
def card_route(monkeypatch):
    """The card route's wrapper on CPU tensors: the route is forced and
    each launch is recorded as (arguments, device) instead."""
    calls = []
    monkeypatch.setattr(T, "_on_card", lambda name, *tensors: True)
    monkeypatch.setattr(T, "_launch", lambda args, device:
                        calls.append((args, device)))
    saved = launch_counts.snapshot()
    yield calls
    launch_counts.restore(saved)


@pytest.mark.parametrize("frame", ["int", "tensor"])
def test_card_route_hands_the_kernel_its_arguments(card_route, frame):
    inp = small(fast=False)
    frame_t = torch.tensor(inp["frame"], dtype=torch.int32)
    before = T.tile_flags.launches
    flags = KT.tile_select(inp, frame=frame_t if frame == "tensor"
                           else inp["frame"])
    assert T.tile_flags.launches == before + 1
    (args, device), = card_route
    assert device == inp["pack"].device
    assert flags.dtype == torch.bool and flags.shape == (256,)
    assert not flags.any()              # zeroed for the kernel's stores
    params = inp["params"]
    assert (args.pack, args.neighbors, args.count, args.local_T_global,
            args.tile_flags) == (
        inp["pack"].data_ptr(), inp["neighbors"].data_ptr(),
        inp["surfel_count"].data_ptr(), inp["local_T_global"].data_ptr(),
        flags.data_ptr())
    if frame == "tensor":
        assert (args.frame, args.frame_value) == (frame_t.data_ptr(), 0)
    else:
        assert (args.frame, args.frame_value) == (None, inp["frame"])
    assert (args.n, args.tile_size, args.window, args.width, args.height,
            args.fast) == (65_536, 256, 30, 640, 480, 0)
    f32 = np.float32
    assert (args.fx, args.fy, args.cx, args.cy) == tuple(
        f32(v) for v in (params.fx, params.fy, params.cx, params.cy))


def test_argument_struct_matches_the_kernel():
    """_Args lists csrc/tiling.cu's TileSelectArgs fields in order, each
    of the C type's size."""
    src = (Path(T.__file__).parents[1] / "csrc" / "tiling.cu").read_text()
    body = re.search(r"struct TileSelectArgs \{(.*?)\};", src,
                     re.S).group(1)
    fields = re.findall(r"^\s*([\w ]+?\*?)\s*(\w+);", body, re.M)
    size = {"long long": 8, "int": 4, "float": 4}
    want = [(name, 8 if kind.endswith("*") else size[kind])
            for kind, name in fields]
    assert [(name, ctypes.sizeof(kind)) for name, kind in T._Args._fields_] \
        == want


CHECK_CASES = ["f64 pack", "narrow pack", "short neighbors",
               "int64 neighbors", "int64 count", "int64 frame", "pose 4x4",
               "partial tile"]


@pytest.mark.parametrize("case", CHECK_CASES)
def test_card_route_checks_its_inputs(card_route, case):
    inp = small()
    pack, nbr = inp["pack"], inp["neighbors"]
    changes = {}
    if case == "f64 pack":
        changes["pack"] = pack.double()
    elif case == "narrow pack":
        changes["pack"] = pack[:, :17].contiguous()
    elif case == "short neighbors":
        changes["neighbors"] = nbr[:, 1:]
    elif case == "int64 neighbors":
        changes["neighbors"] = nbr.long()
    elif case == "int64 count":
        changes["surfel_count"] = inp["surfel_count"].long()
    elif case == "int64 frame":
        changes["frame"] = torch.tensor(inp["frame"])
    elif case == "pose 4x4":
        changes["local_T_global"] = torch.eye(4)
    else:
        changes["pack"], changes["neighbors"] = pack[:-1], nbr[:, :-1]
    with pytest.raises(ValueError, match="tile_flags"):
        KT.tile_select(inp, **changes)
    assert card_route == []


@pytest.mark.parametrize("devices", [("cpu", "meta"), ("meta", "meta")])
def test_route_refuses_mixed_and_other_devices(devices):
    inp = small()
    moved = {k: v.to(devices[1]) if isinstance(v, torch.Tensor) else v
             for k, v in inp.items()}
    moved["pack"] = inp["pack"].to(devices[0])
    with pytest.raises(ValueError, match="tile_flags"):
        KT.tile_select(moved)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (csrc/tiling.cu has no CPU build)")
    return torch.device("cuda")


def assert_equal_flags(inp, **changes):
    """The kernel's flags equal the plain version's on `inp`; one launch."""
    before = T.tile_flags.launches
    got = KT.tile_select(inp, **changes)
    torch.cuda.synchronize()
    assert T.tile_flags.launches == before + 1
    want = KT.tile_select(inp, plain=True, **changes)
    assert torch.equal(got.cpu(), want.cpu()), \
        f"{int((got != want).sum())} tiles differ"
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("live", LIVE)
@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("frame", ["int", "tensor"])
def test_kernel_equals_plain_version(cuda_device, live, fast, frame):
    """The default capacity, most of it unused; every kind of row among
    the live ones (window edge, tombstones, INVALID_INDEX slots)."""
    inp = KT.tiling_inputs(2 ** 31 + 21, CAPACITY, live, fast=fast,
                           device=cuda_device)
    if frame == "tensor":
        inp["frame"] = torch.tensor(inp["frame"], dtype=torch.int32,
                                    device=cuda_device)
    flags = assert_equal_flags(inp)
    assert int(flags.sum()) > 0
    assert not flags[-(-live // 4096):].any()


@pytest.mark.cuda
@pytest.mark.parametrize("count", [0, 1, 4095, 4096, 4097, 262_144 - 1,
                                   262_144])
def test_count_boundary(cuda_device, count):
    """Rows at and past the live count: a tile flags only rows below it
    (the rows past it here hold live-looking data and slots)."""
    inp = KT.tiling_inputs(5, 262_144, 262_144, device=cuda_device)
    inp["surfel_count"].fill_(count)
    assert_equal_flags(inp)


@pytest.mark.cuda
def test_window_edge_and_slots(cuda_device):
    """The same map seen at frames around its stamps' window: each frame
    moves the edge over other rows; and with every slot INVALID_INDEX,
    then every slot pointing at a tombstone."""
    inp = KT.tiling_inputs(6, 1 << 20, 900_000, device=cuda_device)
    for frame in range(inp["frame"] - 3, inp["frame"] + 40, 7):
        assert_equal_flags(inp, frame=frame)
    invalid = torch.full_like(inp["neighbors"], T.INVALID_INDEX)
    assert_equal_flags(inp, neighbors=invalid)
    stamps = inp["pack"].view(torch.int32)[:, TF.STAMP]
    tomb = torch.nonzero(stamps[:900_000] == 0).squeeze(1).to(torch.int32)
    pick = torch.randint(0, tomb.numel(), inp["neighbors"].shape,
                         device=cuda_device)
    assert_equal_flags(inp, neighbors=tomb[pick])


@pytest.mark.cuda
def test_kernel_in_a_cuda_graph(cuda_device):
    """Captured with the count and the frame index in device tensors, the
    launch counts as chunk.py counts a graph's; replayed with a new count
    and frame index, it gives their plain flags."""
    inp = KT.tiling_inputs(7, 1 << 20, 800_000, device=cuda_device)
    frame = torch.tensor(inp["frame"], dtype=torch.int32, device=cuda_device)
    buf = dict(inp, frame=frame)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        KT.tile_select(buf)
    torch.cuda.current_stream().wait_stream(side)
    saved = launch_counts.snapshot()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = KT.tile_select(buf)
    added = launch_counts.since(saved)
    assert {k: v for k, v in added.items() if v} == {"tiling": 1}
    launch_counts.restore(saved)
    for count, f in ((600_000, inp["frame"] + 25), (800_000, 40)):
        buf["surfel_count"].fill_(count)
        frame.fill_(f)
        graph.replay()
        launch_counts.add(added)
        want = KT.tile_select(buf, plain=True)
        assert torch.equal(captured.cpu(), want.cpu())
    assert T.tile_flags.launches == saved["tiling"] + 2


def run_pipeline(device, chunk, budget):
    video, _ = synthetic_rgbd_video(12, 320, 240, noise_sigma=0.002,
                                    trajectory="lookaway")
    cfg = SurfelMeshingConfig(max_surfel_count=2_000_000, frame_chunk=chunk,
                              outlier_filtering_frame_count=2,
                              regularization_frame_window_size=4,
                              active_surfel_budget=budget,
                              shape_bucket_step=65_536, restrict_fps_to=0)
    pipe = ReconstructionPipeline(cfg, video.depth_camera, device)
    before = launch_counts.snapshot()["tiling"]
    tiled = 0
    for i in range(video.frame_count):
        picks = len(pipe.policy.picks)
        pipe.process_frame(video, i)
        if budget and pipe.active_budget() < pipe.state.pack.shape[0]:
            tiled += sum(f for f, _ in pipe.policy.picks[picks:])
    pipe.drain()
    return pipe, tiled, launch_counts.snapshot()["tiling"] - before


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 4])
def test_pipeline_launches_one_kernel_a_tiled_frame(cuda_device, chunk):
    """Under the auto budget, per frame (eager) and chunked (graph
    replays): one launch a frame fused on the tiled route, no tile
    skipped, and the map equals the count-sized pipeline's."""
    pipe, tiled, launched = run_pipeline(cuda_device, chunk, -1)
    assert tiled > 0 and launched == tiled
    assert pipe.trace_counters()["tiling_launches"] == \
        launch_counts.snapshot()["tiling"]
    assert int(pipe.state.skipped_tile_count) == 0
    if chunk > 1:
        assert pipe.graph_replays > 0
    full, _, _ = run_pipeline(cuda_device, chunk, 0)
    n = full.state.pack.shape[0]
    for name in ("pack", "neighbors", "nbr_dist"):
        got = getattr(pipe.state, name)
        got = got[:n] if name == "pack" else got[:, :n]
        assert torch.equal(got.contiguous().view(torch.int32).cpu(),
                           getattr(full.state, name).contiguous()
                           .view(torch.int32).cpu()), name
    for name in ("surfel_count", "merge_count", "overflow_count",
                 "deferred_count"):
        assert int(getattr(pipe.state, name)) == \
            int(getattr(full.state, name)), name
