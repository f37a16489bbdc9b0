"""Surfel integration, phase 5 of the fusion step (ops/integration.py):
the plain version on the CPU and csrc/integration.cu on the card.

- CPU: the fusion step's plain route gives the JAX package's
  `pack_after_integrate` and `neighbors_after_integrate` taps at 64x48
  (planted surfels that re-initialise, decrement and tie at one pixel, a
  merged duplicate; exact_conflict_arbitration off and on), launching
  nothing and never loading the kernel library; the seeded inputs of
  tools/kernel_timing.py hold every kind of row phase 5 meets; the card
  route hands the kernel its arguments (pointers, strides, the frame
  index by value or by pointer, f32 scalars) in the layout of the
  kernel's argument struct, and checks device, dtype, length and
  contiguity; mixed and other devices raise.
- Card (`cuda`): the kernel equals the plain version run on the same CUDA
  tensors bit for bit at 640x480 and 1200x680 on 7.5M-row maps, with
  exact_conflict_arbitration off and on and on each row layout (row
  indices, a tiled working set with INVALID_INDEX rows, a shard's offset
  indices, a bucket's strided neighbour views); captured in a CUDA graph
  and replayed with a new frame index and pose, counted as the chunk
  graphs count; and a pipeline's frames, per frame and replayed from
  chunk graphs, launch it once a fused frame and leave the map the plain
  version leaves.

This file imports no JAX at module level (the JAX case imports it in its
body and skips without it), so `python -m pytest --noconftest
tests/test_torch_integration_kernels.py -m cuda` runs on the card.
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
from surfelmeshing_tpu_torch.ops import integration as I
from surfelmeshing_tpu_torch.pipeline import ReconstructionPipeline
from surfelmeshing_tpu_torch.tools import kernel_timing as KT

torch.set_num_threads(1)

INVALID = I.INVALID_INDEX
# (height, width, focal length): Kinect v1 and Replica.
SHAPES = {"640x480": (480, 640, 525.0), "1200x680": (680, 1200, 600.0)}
CARD_ROWS = 7_500_000


def inputs(seed, shape, n, exact=False, layout="rows", device="cpu"):
    h, w, focal = SHAPES[shape]
    return KT.integration_inputs(seed, n, h, w, focal, count=n - n // 16,
                                 exact=exact, layout=layout, device=device)


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
    monkeypatch.setattr(I, "load_library", refuse)


H, W, FOCAL, SCALE = 48, 64, 60.0, 5000.0


def wall(seed, depth_m=2.0):
    """A noisy wall at 64x48 with a hole: (depth u16, normals, radius,
    colour)."""
    rng = np.random.default_rng(seed)
    depth = (SCALE * depth_m * (1.0 + 0.004 * rng.standard_normal((H, W)))) \
        .astype(np.uint16)
    depth[12:20, 16:28] = 0
    normals = np.zeros((2, H, W), np.float32)
    r = depth_m / FOCAL * 1.5
    radius = np.full((H, W), r * r, np.float32)
    color = rng.integers(0, 255, (3, H, W)).astype(np.uint8)
    return depth, normals, radius, color


def yaw_pose(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    t = np.array([0.004, 0.0, 0.0])
    return (np.concatenate([rot, t[:, None]], 1).astype(np.float32),
            np.concatenate([rot.T, -rot.T @ t[:, None]], 1)
            .astype(np.float32))


@pytest.mark.parametrize("exact", [False, True], ids=["default", "exact"])
def test_plain_route_gives_the_jax_taps(no_library, exact):
    """Frame 0 fills a map from a wall; then surfels float in front of it
    (confidence 1: re-initialised; 3: decremented; two at one position:
    a tie at one pixel, which exact_conflict_arbitration breaks by index)
    and a near-duplicate is merged away, and frame 1 integrates from a
    turned camera.  The port's step (the plain route) gives eager JAX's
    phase-5 taps: every word of the pack, every neighbour slot."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from surfelmeshing_tpu.ops import fusion as JF

    params = JF.FusionParams(width=W, height=H, fx=FOCAL, fy=FOCAL,
                             cx=W / 2 + 0.5, cy=H / 2 + 0.5,
                             depth_scaling=SCALE,
                             measurement_blending_radius=6,
                             exact_conflict_arbitration=exact)
    ident = np.eye(3, 4, dtype=np.float32)

    def jax_step(state, frame, poses, taps):
        depth, normals, radius, color = wall(frame)
        JF._TAP = {} if taps else None
        try:
            with jax.disable_jit():
                out = JF.integrate_frame(
                    state, jnp.asarray(depth), jnp.asarray(normals),
                    jnp.asarray(radius), jnp.asarray(color),
                    jnp.asarray(poses[0]), jnp.asarray(poses[1]),
                    jnp.int32(frame), params)
            got = {k: np.asarray(v) for k, v in (JF._TAP or {}).items()}
        finally:
            JF._TAP = None
        return out, got

    jstate, _ = jax_step(JF.create_surfel_state(8192), 0, (ident, ident),
                         False)
    count = int(jstate.surfel_count)
    planted = [([0.1, 0.05, 1.0], 1.0), ([-0.2, 0.1, 1.1], 3.0),
               ([0.3, -0.1, 0.9], 3.0), ([0.3, -0.1, 0.9], 3.0),
               ([-0.3, 0.2, 1.2], 0.5)]
    for k, (pos, conf) in enumerate(planted):
        jstate = JF.plant_surfel(jstate, count + k, pos=pos,
                                 normal=[0, 0, -1], confidence=conf,
                                 radius_sq=0.0004, stamp=0)
    src = count // 2
    dup = np.asarray(JF.positions(jstate)[src]) + \
        np.array([1e-5, 0, 0], np.float32)
    jstate = JF.plant_surfel(
        jstate, count + len(planted), pos=dup,
        normal=np.asarray(JF.normals(jstate)[src]), confidence=1.0,
        radius_sq=float(JF.radii_sq(jstate)[src]), stamp=0)
    jstate = jstate._replace(surfel_count=jnp.int32(count + len(planted) + 1))

    def port_taps(jstate, frame, poses):
        tstate = TF.state_from_numpy(
            np.asarray(jstate.pack), np.asarray(jstate.neighbors),
            np.asarray(jstate.nbr_dist), int(jstate.surfel_count),
            int(jstate.merge_count), int(jstate.overflow_count), "cpu")
        depth, normals, radius, color = wall(frame)
        taps = {}
        before = launch_counts.snapshot()
        TF.integrate_frame(
            tstate, torch.from_numpy(depth.astype(np.int32)),
            torch.from_numpy(normals), torch.from_numpy(radius),
            torch.from_numpy(color), torch.from_numpy(poses[0]),
            torch.from_numpy(poses[1]), frame, TF.params_from(params),
            taps=taps)
        assert launch_counts.snapshot() == before
        return {k: v.numpy() for k, v in taps.items()}

    # Frame 1 from the same pose (the duplicate's pixel is its source's),
    # frame 2 from a turned camera.
    for frame, poses in ((1, (ident, ident)), (2, yaw_pose(0.01))):
        jnext, want = jax_step(jstate, frame, poses, True)
        got = port_taps(jstate, frame, poses)
        for name in ("pack_after_merge", "pack_after_integrate",
                     "neighbors_after_integrate"):
            np.testing.assert_array_equal(got[name].view(np.int32),
                                          want[name].view(np.int32),
                                          err_msg=f"{name}, frame {frame}")
        ints = got["pack_after_integrate"].view(np.int32)
        assert (ints[:count, TF.STAMP] == frame).sum() > count // 2
        if frame == 1:
            # The planted rows met each case: re-initialised (creation
            # stamp 1), decremented, the tie broken by index only in exact
            # mode; the duplicate merged away.
            conf = got["pack_after_integrate"][count:, TF.CONF]
            assert ints[count, TF.CREATION] == \
                ints[count + 4, TF.CREATION] == 1
            assert conf[1] < 3.0 and conf[2] < 3.0
            assert (conf[3] == 3.0) == exact
            assert got["merge_mask"][count + len(planted)]
        jstate = jnext


@pytest.mark.parametrize("shape", list(SHAPES))
def test_seeded_inputs_hold_every_kind_of_row(no_library, shape):
    """The card tests' inputs (kernel_timing.integration_inputs): rows
    that re-initialise, decrement and integrate, rows created this frame,
    merged away or with no side pixel, all in view."""
    for exact in (False, True):
        inp = inputs(1, shape, 40_000, exact)
        kinds = KT.integration_row_kinds(inp, KT.integrate(inp))
        assert all(v > 0 for v in kinds.values()), kinds


@pytest.fixture
def card_route(monkeypatch):
    """The card route's wrapper on CPU tensors: the route is forced and
    each launch is recorded as (arguments, device) instead."""
    calls = []
    monkeypatch.setattr(I, "_on_card", lambda name, *tensors: True)
    monkeypatch.setattr(I, "_launch", lambda args, device:
                        calls.append((args, device)))
    saved = launch_counts.snapshot()
    yield calls
    launch_counts.restore(saved)


def call(inp, pack=None, **changes):
    args = dict(inp, pack=inp["pack"] if pack is None else pack)
    args.update(changes)
    return I.integrate_measurements(
        args["params"], args["pack"], args["neighbors"], args["nbr_dist"],
        args["rows"], args["maps"], args["local_T_global"],
        args["global_T_local"], args["frame"])


@pytest.mark.parametrize("frame", ["int", "tensor"])
def test_card_route_hands_the_kernel_its_arguments(card_route, frame):
    inp = inputs(2, "1200x680", 512, exact=True, layout="bucket")
    frame_t = torch.tensor(inp["frame"], dtype=torch.int32)
    before = I.integrate_measurements.launches
    pack, nbr, dist = call(inp, frame=frame_t if frame == "tensor"
                           else inp["frame"])
    assert I.integrate_measurements.launches == before + 1
    (args, device), = card_route
    assert pack is inp["pack"] and device == pack.device
    assert nbr.shape == dist.shape == (4, 512) and nbr.is_contiguous()
    assert nbr.dtype == torch.int32 and dist.dtype == torch.float32
    params, rows, maps = inp["params"], inp["rows"], inp["maps"]
    assert (args.pack, args.n, args.nbr_out, args.dist_out) == (
        pack.data_ptr(), 512, nbr.data_ptr(), dist.data_ptr())
    # The bucket's neighbour views are read in place, with their stride.
    assert (args.nbr_in, args.nbr_stride, args.dist_in, args.dist_stride) \
        == (inp["neighbors"].data_ptr(), 512 + 4096,
            inp["nbr_dist"].data_ptr(), 512 + 4096)
    for key, t in (*rows._asdict().items(), *maps._asdict().items()):
        assert getattr(args, key) == t.data_ptr(), key
    assert args.local_T_global == inp["local_T_global"].data_ptr()
    assert args.global_T_local == inp["global_T_local"].data_ptr()
    if frame == "tensor":
        assert (args.frame, args.frame_value) == (frame_t.data_ptr(), 0)
    else:
        assert (args.frame, args.frame_value) == (None, inp["frame"])
    assert (args.width, args.hw) == (1200, 1200 * 680)
    f32 = np.float32
    noise = params.sensor_noise_factor
    assert (args.one_minus_noise, args.one_plus_noise) == (
        f32(1.0 - noise), f32(1.0 + noise))
    assert (args.fx_inv, args.fy_inv, args.cx_inv, args.cy_inv) == tuple(
        f32(v) for v in params.unprojection)
    assert args.cos_compat == f32(params.cos_normal_compat)
    assert args.max_confidence == f32(params.max_surfel_confidence)
    assert args.view_threshold == 0.0
    # Without exact_conflict_arbitration the conflictor pointer is null.
    call(inputs(2, "1200x680", 512))
    assert card_route[1][0].conflictor is None


def test_argument_struct_matches_the_kernel():
    """_Args lists csrc/integration.cu's IntegrateArgs fields in order,
    each of the C type's size."""
    src = (Path(I.__file__).parents[1] / "csrc" / "integration.cu") \
        .read_text()
    body = re.search(r"struct IntegrateArgs \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*([\w ]+?\*?)\s*(\w+);", body, re.M)
    size = {"long long": 8, "int": 4, "float": 4}
    want = [(name, 8 if kind.endswith("*") else size[kind])
            for kind, name in fields]
    assert [(name, ctypes.sizeof(kind)) for name, kind in I._Args._fields_] \
        == want


CHECK_CASES = ["int64 px", "float idx", "short z", "2-d on", "int counts",
               "long map", "strided pack", "narrow pack", "f64 pack",
               "short neighbors", "int64 frame", "pose 4x4", "wrong hw"]


@pytest.mark.parametrize("case", CHECK_CASES)
def test_card_route_checks_its_inputs(card_route, case):
    inp = inputs(3, "640x480", 256, exact=True)
    rows, maps, pack = inp["rows"], inp["maps"], inp["pack"]
    changes = {}
    if case == "int64 px":
        changes["rows"] = rows._replace(px=rows.px.long())
    elif case == "float idx":
        changes["rows"] = rows._replace(idx=rows.idx.float())
    elif case == "short z":
        changes["rows"] = rows._replace(z=rows.z[:-1])
    elif case == "2-d on":
        changes["rows"] = rows._replace(on=rows.on[None])
    elif case == "int counts":
        changes["maps"] = maps._replace(counts=maps.counts.float())
    elif case == "long map":
        changes["maps"] = maps._replace(
            radius=torch.cat([maps.radius, maps.radius[:1]]))
    elif case == "strided pack":
        changes["pack"] = torch.cat([pack, pack], 1)[:, ::2]
    elif case == "narrow pack":
        changes["pack"] = pack[:, :17].contiguous()
    elif case == "f64 pack":
        changes["pack"] = pack.double()
    elif case == "short neighbors":
        changes["neighbors"] = inp["neighbors"][:, 1:]
    elif case == "int64 frame":
        changes["frame"] = torch.tensor(inp["frame"])
    elif case == "pose 4x4":
        changes["local_T_global"] = torch.eye(4)
    else:
        changes["params"] = dataclasses.replace(inp["params"], width=320)
    with pytest.raises(ValueError, match="integrate_measurements"):
        call(inp, **changes)
    assert card_route == []


@pytest.mark.parametrize("devices", [("cpu", "meta"), ("meta", "meta")])
def test_route_refuses_mixed_and_other_devices(devices):
    inp = inputs(4, "640x480", 128)
    moved = {k: v.to(devices[1]) if isinstance(v, torch.Tensor) else v
             for k, v in inp.items()}
    moved["rows"] = inp["rows"]._replace(
        **{k: v.to(devices[1]) for k, v in inp["rows"]._asdict().items()})
    moved["maps"] = inp["maps"]._replace(
        **{k: v.to(devices[1]) for k, v in inp["maps"]._asdict().items()
           if v is not None})
    moved["pack"] = inp["pack"].to(devices[0])
    with pytest.raises(ValueError, match="one CUDA device"):
        call(moved, pack=moved["pack"])


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (csrc/integration.cu has no CPU "
                    "build)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("exact", [False, True], ids=["default", "exact"])
@pytest.mark.parametrize("layout", KT.LAYOUTS)
def test_kernel_equals_plain_version(cuda_device, shape, exact, layout):
    """7.5M rows, most out of view, every kind of row among those in it."""
    inp = inputs(2 ** 31 + 11, shape, CARD_ROWS, exact, layout, cuda_device)
    before = I.integrate_measurements.launches
    got = KT.integrate(inp)
    torch.cuda.synchronize()
    assert I.integrate_measurements.launches == before + 1
    want = KT.integrate(inp, plain=True)
    assert_bits_equal(got, want)
    kinds = KT.integration_row_kinds(inp, got)
    assert all(v > 0 for v in kinds.values()), kinds


@pytest.mark.cuda
def test_kernel_in_a_cuda_graph(cuda_device):
    """Captured with the frame index and poses in device tensors, the
    launch counts as chunk.py counts a graph's; replayed on another map's
    inputs copied into the captured buffers, with a new frame index and
    pose, it gives their plain result."""
    first = inputs(31, "1200x680", 400_000, True, device=cuda_device)
    second = inputs(32, "1200x680", 400_000, True, device=cuda_device)
    second["frame"] = 777
    frame = torch.tensor(first["frame"], dtype=torch.int32,
                         device=cuda_device)
    buf = dict(first, frame=frame, pack=first["pack"].clone())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        KT.integrate(buf)
    torch.cuda.current_stream().wait_stream(side)
    saved = launch_counts.snapshot()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = KT.integrate(buf, pack=buf["pack"])
    added = launch_counts.since(saved)
    assert {k: v for k, v in added.items() if v} == {"integration": 1}
    launch_counts.restore(saved)
    for key in ("neighbors", "nbr_dist", "local_T_global",
                "global_T_local"):
        buf[key].copy_(second[key])
    for key in ("rows", "maps"):
        for dst, src in zip(buf[key], second[key]):
            dst.copy_(src)
    frame.fill_(second["frame"])
    for _ in range(3):
        buf["pack"].copy_(second["pack"])
        graph.replay()
        launch_counts.add(added)
    torch.cuda.synchronize()
    assert I.integrate_measurements.launches == saved["integration"] + 3
    assert_bits_equal(captured, KT.integrate(second, plain=True))


def run_pipeline(device, chunk):
    video, _ = synthetic_rgbd_video(10, 320, 240, noise_sigma=0.002)
    cfg = SurfelMeshingConfig(max_surfel_count=400_000, frame_chunk=chunk,
                              outlier_filtering_frame_count=2,
                              restrict_fps_to=0)
    pipe = ReconstructionPipeline(cfg, video.depth_camera, device)
    blends, before = blend.blend_core.launches, integration_launches()
    for i in range(video.frame_count):
        pipe.process_frame(video, i)
    pipe.drain()
    return (pipe, blend.blend_core.launches - blends,
            integration_launches() - before)


def integration_launches():
    """The kernel's launches so far, read through the registry (a test
    may stand the plain version in for the wrapper)."""
    return launch_counts.snapshot()["integration"]


@pytest.mark.cuda
def test_pipeline_launches_one_kernel_a_fused_frame(cuda_device,
                                                    monkeypatch):
    """Per frame (eager) and chunked (graph replays): one launch a fused
    frame (one blending launch each), and the plain version leaves the
    same map."""
    runs = {chunk: run_pipeline(cuda_device, chunk) for chunk in (1, 4)}
    for chunk, (pipe, fused, launched) in runs.items():
        assert fused > 0 and launched == fused, chunk
        assert pipe.trace_counters()["integration_launches"] == \
            integration_launches()
    assert runs[4][0].graph_replays > 0
    monkeypatch.setattr(I, "integrate_measurements", I.integrate_reference)
    plain, _, _ = run_pipeline(cuda_device, 1)
    for pipe, _, _ in runs.values():
        for name in ("pack", "neighbors", "nbr_dist", "surfel_count",
                     "merge_count", "overflow_count", "deferred_count"):
            assert torch.equal(bits(getattr(pipe.state, name)),
                               bits(getattr(plain.state, name))), name
