"""The port's tracer (utils/timing.tracer) on the CPU, and on a card where
there is one.

- off (the default): no span site calls into the tracer or makes a
  StageTimer, and the map is bit for bit a run's made before any tracing;
- on: the map is still bit-identical; every span lies inside its parent
  on its thread; every fused frame has one `frame` span, with `preprocess`
  and `fusion` children per frame or inside a `flush` when chunked, and
  its device spans for the five preprocessing passes and the fusion
  phases; host_waits counts the wait.* spans; a snapshot waits inside
  snapshot.select; h2d_bytes are the bytes of the arrays uploaded; the
  stage timings share their clock readings with the spans over the same
  stretch; the mesher records one mesher.iteration per batch, and its
  timings lines are those spans' times;
- --log_timings_staged's preprocessing and phase columns are the device
  spans of the same StageTimers;
- the app with --profile_dir shows the spans in its trace, with
  --log_timings writes timings_cpu.txt from the mesher's spans, and with
  either logs the spans by name and the counters;
- tools/trace_cells reads the tracer's records of a benchmark cell.
"""

import collections
import dataclasses
import json
import os

import pytest
import torch

from surfelmeshing_tpu_torch import chunk as CH
from surfelmeshing_tpu_torch import pipeline as PL
from surfelmeshing_tpu_torch.app.main import main as app_main
from surfelmeshing_tpu_torch.config import SurfelMeshingConfig
from surfelmeshing_tpu_torch.io.synthetic import synthetic_rgbd_video
from surfelmeshing_tpu_torch.meshing import MeshingDriver
from surfelmeshing_tpu_torch.ops import preprocess as TP
from surfelmeshing_tpu_torch.tools import trace_cells
from surfelmeshing_tpu_torch.utils.timing import (COLUMNS, Tracer,
                                                   trace_report, tracer)

torch.set_num_threads(1)

W, H, FRAMES, K = 64, 48, 10, 2
SNAPSHOT_AT = (2, 7, 8)
CONFIG = dict(max_surfel_count=8192, outlier_filtering_frame_count=K,
              max_creations_per_frame=512, shape_bucket_step=4096,
              max_inflight_dispatches=1, restrict_fps_to=0,
              bilateral_filter_sigma_xy=0.5, measurement_blending_radius=4,
              depth_erosion_radius=1)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tum_micro")
APP_FLAGS = ["--device", "cpu", "--max_surfel_count", "120000",
             "--pyramid_level", "2", "--outlier_filtering_frame_count", "2",
             "--depth_erosion_radius", "1", "--restrict_fps_to", "0",
             "--exit_after_processing", "--end_frame", "5"]


def run(chunk, trace=False, device="cpu", **kw):
    """The pipeline over the video with a snapshot to a mesher at
    SNAPSHOT_AT (each a batch of its own); -> (pipe, mesher, fused
    frames, the tracer's records or None)."""
    cfg = SurfelMeshingConfig(**CONFIG, frame_chunk=chunk, **kw)
    video, _ = synthetic_rgbd_video(FRAMES, W, H, noise_sigma=0.002)
    pipe = PL.ReconstructionPipeline(cfg, video.depth_camera, device)
    mesher = MeshingDriver(cfg)
    fused = []
    if trace:
        tracer.start()
    try:
        for i in range(FRAMES):
            if pipe.process_frame(video, i) is not None:
                fused.append(i)
            if cfg.log_timings and i in fused:
                pipe.log_frame_timings(i)
            if i in SNAPSHOT_AT:
                mesher.submit_snapshot(pipe.snapshot_for_meshing(i), i)
                mesher.drain()
        pipe.drain()
    finally:
        records = tracer.stop() if trace else None
        mesher.finish()
    return pipe, mesher, fused, records


def refuse(*args, **kwargs):
    raise AssertionError("a span site reached the tracer while it was off")


@pytest.fixture(scope="module")
def runs():
    """Per frame and frame_chunk 4: the map before any tracing, the map
    with the tracer off after it was started and stopped, and the traced
    run."""
    out = {}
    for chunk in (1, 4):
        with pytest.MonkeyPatch.context() as mp:
            for name in ("begin", "end", "wait", "h2d", "d2h", "device",
                         "poll"):
                mp.setattr(Tracer, name, refuse)
            for module in (PL, CH):
                mp.setattr(module, "StageTimer", refuse)
                mp.setattr(module, "stream_sync", refuse)
            before = run(chunk)
            tracer.start()
            tracer.stop()
            after = run(chunk)
        out[chunk] = before, after, run(chunk, trace=True)
    return out


def bits(state):
    return {name: getattr(state, name).view(torch.int32).clone()
            if getattr(state, name).dtype == torch.float32
            else getattr(state, name).clone()
            for name in ("pack", "neighbors", "nbr_dist", "surfel_count",
                         "merge_count", "overflow_count")}


def assert_same_map(a, b):
    for name, want in bits(a.state).items():
        assert torch.equal(bits(b.state)[name], want), name


@pytest.mark.parametrize("chunk", [1, 4])
def test_tracer_off_records_nothing(runs, chunk):
    """With the tracer off no site called it (every entry point raised),
    and a run after the tracer was started and stopped leaves the same
    map."""
    before, after, _ = runs[chunk]
    assert not tracer.on
    assert before[2] == after[2] == list(range(1, FRAMES - 1))
    assert_same_map(before[0], after[0])
    assert before[1].timings_log_lines == after[1].timings_log_lines == []


@pytest.mark.parametrize("chunk", [1, 4])
def test_traced_map_is_bit_identical(runs, chunk):
    before, _, traced = runs[chunk]
    assert_same_map(before[0], traced[0])
    assert before[0].bucket_pick_log == traced[0].bucket_pick_log
    assert traced[3]["dropped"] == 0


def by_thread(records):
    spans = records["spans"]
    out = collections.defaultdict(list)
    for k, s in enumerate(spans):
        out[s["thread"]].append((k, s))
    return spans, out


@pytest.mark.parametrize("chunk", [1, 4])
def test_spans_lie_inside_their_parents(runs, chunk):
    records = runs[chunk][2][3]
    spans, threads = by_thread(records)
    # On the CPU only the per-frame path hands the tracer StageTimers.
    assert set(threads) == {"MainThread", "mesher"} | \
        ({"device"} if chunk == 1 else set())
    for s in spans:
        assert records["start"] <= s["start"] <= s["end"] <= records["stop"]
        if s["parent"] >= 0:
            p = spans[s["parent"]]
            assert p["thread"] == s["thread"] != "device"
            assert p["start"] <= s["start"] <= s["end"] <= p["end"]
    # The frame loop's top-level spans follow one another.
    top = [s for _, s in threads["MainThread"] if s["parent"] < 0]
    assert {s["name"] for s in top} == {"frame", "snapshot", "drain"}
    for a, b in zip(top, top[1:]):
        assert a["end"] <= b["start"]


def children(spans, k):
    return [s["name"] for s in spans if s["parent"] == k]


@pytest.mark.parametrize("chunk", [1, 4])
def test_every_fused_frame_has_one_frame_span(runs, chunk):
    _, _, (pipe, _, fused, records) = runs[chunk]
    spans = records["spans"]
    frames = {}
    for k, s in enumerate(spans):
        if s["name"] == "frame":
            assert s["id"] not in frames
            frames[s["id"]] = k
    assert sorted(frames) == list(range(FRAMES))
    device = collections.Counter((s["id"], s["name"]) for s in spans
                                 if s["thread"] == "device")
    flushes = [s for s in spans if s["name"] == "flush"]
    for i in fused:
        names = children(spans, frames[i])
        assert names.count("input.stage") == 1
        if chunk == 1:
            assert names.count("preprocess") == names.count("fusion") == 1
            assert "flush" not in names
            for name in TP.PASSES:
                assert device[(i, "dev.preprocess." + name)] == 1
            for column in COLUMNS:
                assert device[(i, "dev.fusion." + column)] == \
                    (2 if column == "integration" else 1)
        else:
            assert "preprocess" not in names and "fusion" not in names
            assert any(f["id"] >= i for f in flushes)
    if chunk > 1:
        # Each flush runs its sub-chunks: a pick and a stage each.
        picks = sum(children(spans, spans.index(f)).count("dispatch.pick")
                    for f in flushes)
        assert picks == len(pipe.bucket_pick_log) == \
            sum(s["name"] == "chunk.stage" for s in spans)
        assert [s["id"] for s in spans if s["name"] == "frame" and
                "flush" in children(spans, spans.index(s))] == [6]
        assert not device          # the CPU runs no graph replays
    assert records["pipelines"] == [{
        "creations.made": int(pipe.state.surfel_count),
        "creations.deferred": int(pipe.state.deferred_count),
        "graph_captures": 0, "graph_replays": 0,
        "bucket_picks": len(pipe.bucket_pick_log),
        "snapshots": len(SNAPSHOT_AT),
        "snapshot_rows_shipped": pipe.snapshot_rows_shipped,
        "blend_launches": 0, "preprocess_launches": 0,
        "association_launches": 0, "integration_launches": 0,
        "tiling_launches": 0, "kernel_builds": 0}]


@pytest.mark.parametrize("chunk", [1, 4])
def test_tiled_run_traces_its_selection(chunk):
    """Under the auto active-set budget (tiles of 128 rows): per frame,
    each frame fused on the tiled route (a budget below the capacity)
    holds in its fusion span tiling.select, then
    tiling.writeback, with the device spans dev.tiling.select and
    dev.tiling.writeback; in both dispatch modes the tile counters are
    the readbacks' sums (tiles.active: each frame's tile demand, a
    sub-chunk's last frame's for each of its frames; tiles.working_rows:
    each frame's budget; tiles.skipped: the map's count), and
    tiling_launches is reported (0: the CPU launches no kernel)."""
    cfg = SurfelMeshingConfig(**CONFIG, frame_chunk=chunk,
                              active_surfel_budget=-1)
    video, _ = synthetic_rgbd_video(FRAMES, W, H, noise_sigma=0.002)
    pipe = PL.ReconstructionPipeline(cfg, video.depth_camera, "cpu")
    pipe.fusion_params = dataclasses.replace(pipe.fusion_params,
                                             tile_size=128)
    active = rows = 0
    tiled = []          # frames below the capacity: the tiled route
    tracer.start()
    try:
        for i in range(FRAMES):
            picks = len(pipe.policy.picks)
            pipe.process_frame(video, i)
            for frames, _ in pipe.policy.picks[picks:]:
                active += frames * int(pipe._state.active_tile_count)
                rows += frames * pipe.active_budget()
                if pipe.active_budget() < 8192:
                    tiled.append(i)
        pipe.drain()
    finally:
        records = tracer.stop()
    assert records["pipelines"] == [{
        "creations.made": int(pipe.state.surfel_count),
        "creations.deferred": int(pipe.state.deferred_count),
        "tiles.active": active, "tiles.skipped": 0,
        "tiles.working_rows": rows, "graph_captures": 0,
        "graph_replays": 0, "bucket_picks": len(pipe.bucket_pick_log),
        "snapshots": 0, "snapshot_rows_shipped": 0, "blend_launches": 0,
        "preprocess_launches": 0, "association_launches": 0,
        "integration_launches": 0, "tiling_launches": 0,
        "kernel_builds": 0}]
    assert 0 < active and 0 < rows < len(pipe.bucket_pick_log) * 8192 * \
        (4 if chunk > 1 else 1)
    spans = records["spans"]
    names = collections.Counter(s["name"] for s in spans)
    assert len(tiled) > (0 if chunk > 1 else 2)
    if chunk > 1:
        assert not any(n.startswith(("tiling.", "dev.tiling."))
                       for n in names)
        return
    assert names["tiling.select"] == names["tiling.writeback"] == \
        names["dev.tiling.select"] == names["dev.tiling.writeback"] == \
        len(tiled)
    for k, s in enumerate(spans):
        if s["name"] == "fusion":
            inner = [c for c in children(spans, k) if c.startswith("tiling")]
            assert inner == (["tiling.select", "tiling.writeback"]
                             if s["id"] in tiled else [])
    device = [s for s in spans if s["name"].startswith("dev.tiling.")]
    assert sorted(s["id"] for s in device) == sorted(2 * tiled)
    assert all(s["thread"] == "device" for s in device)


@pytest.mark.parametrize("chunk", [1, 4])
def test_report_lists_the_creations(runs, chunk):
    """trace_report names creations.made and creations.deferred: the
    budget of 512 creations a frame binds on the 64x48 frames."""
    _, _, (pipe, _, _, records) = runs[chunk]
    made, deferred = int(pipe.state.surfel_count), \
        int(pipe.state.deferred_count)
    assert deferred > 0
    assert f"Traced creations: {{'creations.made': {made}, " \
        f"'creations.deferred': {deferred}}}" in trace_report(records)


@pytest.mark.parametrize("chunk", [1, 4])
def test_host_waits_count_the_wait_spans(runs, chunk):
    records = runs[chunk][2][3]
    waits = collections.Counter(s["name"][5:] for s in records["spans"]
                                if s["name"].startswith("wait."))
    assert records["host_waits"] == dict(waits)
    # On the CPU: one upload wait a depth frame and two a fused frame
    # (colour and pose pack; chunked they are staged on the host), one
    # for the first (full) snapshot and two for each delta one, one for
    # the final drain.
    uploads = FRAMES + (2 * len(runs[chunk][2][2]) if chunk == 1 else 0)
    assert waits == {"upload": uploads,
                     "snapshot": 2 * len(SNAPSHOT_AT) - 1, "drain": 1}
    spans = records["spans"]
    for s in spans:
        if s["name"] == "wait.upload":
            assert spans[s["parent"]]["name"] in ("input.depth",
                                                  "input.stage")
    # A snapshot waits after its selection's launches, where its size read
    # would: inside snapshot.select, never before it.
    snaps = [k for k, s in enumerate(spans) if s["name"] == "snapshot"]
    assert len(snaps) == len(SNAPSHOT_AT)
    for n, k in enumerate(snaps):
        assert [c for c in children(spans, k) if c != "flush"] == \
            ["snapshot.select", "snapshot.copy"]
        select = spans.index(next(s for s in spans if s["parent"] == k and
                                  s["name"] == "snapshot.select"))
        assert children(spans, select) == ["wait.snapshot"] * (1 + (n > 0))


@pytest.mark.parametrize("chunk", [1, 4])
def test_stage_timings_share_the_spans_clock(runs, chunk):
    """The stage timings over a span's stretch are its readings: the
    preprocessing time is the preprocess span, the integration time runs
    from its end to the fusion span's end (chunked: the flush span), and
    surfel_transfer is the snapshot span."""
    _, _, (pipe, _, fused, records) = runs[chunk]
    spans = records["spans"]

    def seconds(name):
        return [s["end"] - s["start"] for s in spans if s["name"] == name]

    timing = pipe.timing
    if chunk == 1:
        pre = [s for s in spans if s["name"] == "preprocess"]
        fus = [s for s in spans if s["name"] == "fusion"]
        assert timing.stats("preprocessing").total == \
            sum(seconds("preprocess"))
        assert timing.stats("integration").total == \
            sum(f["end"] - p["end"] for p, f in zip(pre, fus))
        assert timing.stats("preprocessing").count == len(fused)
    else:
        assert timing.stats("preprocessing") is None
        assert timing.stats("integration").total == sum(seconds("flush"))
    assert timing.stats("surfel_transfer").total == sum(seconds("snapshot"))


@pytest.mark.parametrize("chunk", [1, 4])
def test_h2d_bytes_are_the_arrays_uploaded(runs, chunk):
    """Every depth frame (int32) and every fused frame's (3, H, W) u8
    colour and f32 pose pack; pageable on the CPU, chunked or not."""
    _, _, (_, _, fused, records) = runs[chunk]
    pose_pack = 4 * (12 * K + 25)
    assert records["h2d_bytes.pageable"] == \
        FRAMES * 4 * W * H + len(fused) * (3 * W * H + pose_pack)
    assert records["h2d_bytes.pinned"] == 0
    assert records["d2h_bytes"] > 0


@pytest.mark.parametrize("chunk", [1, 4])
def test_mesher_records_one_iteration_per_batch(runs, chunk):
    _, _, (_, mesher, _, records) = runs[chunk]
    spans, threads = by_thread(records)
    iterations = [(k, s) for k, s in threads["mesher"]
                  if s["name"] == "mesher.iteration"]
    assert [s["id"] for _, s in iterations] == list(SNAPSHOT_AT)
    lines = mesher.timings_log_lines
    assert len(lines) == 6 * len(SNAPSHOT_AT)
    for n, (k, s) in enumerate(iterations):
        steps = {c["name"][7:]: c for c in spans if c["parent"] == k}
        assert list(steps) == ["integrate", "remesh", "triangulate",
                               "publish"]
        assert steps["publish"]["end"] >= steps["integrate"]["end"]
        block = dict(line.split(" ", 1) for line in lines[6 * n:6 * n + 6])
        assert block["frame"] == str(s["id"])
        for key, step in (("-synchronization", "integrate"),
                          ("-remeshing", "remesh"),
                          ("-meshing", "triangulate")):
            c = steps[step]
            assert float(block[key]) == pytest.approx(
                1000 * (c["end"] - c["start"]), abs=2e-6)


def test_staged_columns_are_the_device_spans():
    """--log_timings_staged with the tracer on: each line's preprocessing
    column is the sum of the frame's dev.preprocess spans and each phase
    column the sum of its dev.fusion spans (one set of StageTimers)."""
    pipe, _, fused, records = run(1, trace=True, log_timings="t.txt",
                                  log_timings_staged=True)
    assert len(pipe.timings_log_lines) == len(fused)
    ms = collections.defaultdict(float)
    for s in records["spans"]:
        if s["thread"] == "device":
            column = "preprocessing" if s["name"].startswith(
                "dev.preprocess.") else s["name"].split(".")[-1]
            ms[(s["id"], column)] += 1000 * (s["end"] - s["start"])
    for i, line in zip(fused, pipe.timings_log_lines):
        words = line.split()
        values = dict(zip(words[0::2], words[1::2]))
        assert values["frame"] == str(i)
        for column in ("preprocessing",) + COLUMNS:
            assert float(values[column]) == pytest.approx(
                ms[(i, column)], abs=2e-6), column


def test_tracer_buffer_and_nesting():
    """A tracer of 5 slots: parents are the innermost open span on the
    thread, end() gives the span's seconds, spans past the capacity are
    counted as dropped, and a span still open at stop() is left out (its
    children then have no parent)."""
    t = Tracer()
    t.CAPACITY = 5
    with pytest.raises(RuntimeError):
        t.stop()
    t.start()
    with pytest.raises(RuntimeError):
        t.start()
    t.begin("open", 7)
    t.begin("b")
    assert t.end() >= 0.0
    t.wait("x", 3)
    t.begin("c")
    t.begin("d")
    t.end()
    t.end()
    t.begin("e")                   # the sixth span: dropped
    t.end()
    records = t.stop()
    assert [(s["name"], s["parent"], s["id"]) for s in records["spans"]] \
        == [("b", -1, -1), ("wait.x", -1, 3), ("c", -1, -1), ("d", 2, -1)]
    assert records["dropped"] == 1
    assert records["host_waits"] == {"x": 1}
    assert t.end() >= 0.0          # "open", closed after stop()
    t.start()
    assert t.stop()["spans"] == []


def test_app_traces_with_profile_dir_and_log_timings(tmp_path, monkeypatch,
                                                      caplog):
    monkeypatch.chdir(tmp_path)
    caplog.set_level("INFO")
    assert app_main([*APP_FLAGS, "--profile_dir", "trace", "--log_timings",
                     "timings.txt", FIXTURE, "groundtruth.txt"]) == 0
    assert not tracer.on
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"frame", "input.depth", "input.stage", "preprocess",
            "dispatch.pick", "fusion", "snapshot", "wait.upload",
            "wait.snapshot", "aten::scatter_reduce_"} <= names
    lines = (tmp_path / "timings_cpu.txt").read_text().splitlines()
    assert len(lines) % 6 == 0 and lines
    # The run's report: the spans by name, the device's among them, and
    # the counters.
    report = next(r.getMessage() for r in caplog.records
                  if r.getMessage().startswith("Traced spans"))
    for name in ("frame", "wait.upload", "dev.preprocess.1_bilateral",
                 "dev.fusion.integration", "mesher.iteration",
                 "Traced counters", "h2d_bytes.pageable", "graph_replays"):
        assert name in report, name
    for n in range(0, len(lines), 6):
        keys = [line.split()[0] for line in lines[n:n + 6]]
        assert keys == ["frame", "-remeshing", "-meshing",
                        "-synchronization", "-triangle_count",
                        "-deleted_triangle_count"]
        assert all(float(line.split()[1]) >= 0 for line in lines[n:n + 6])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 2])
def test_device_spans_on_card(cuda_device, chunk):
    """On the card: the traced map equals the untraced one, device spans
    lie between start() and stop() on the host clock, per frame for each pass and
    phase, chunked one dev.chunk.replay a graph replay; each wait.* span
    is counted."""
    plain = run(chunk, device=cuda_device)
    traced = run(chunk, trace=True, device=cuda_device)
    assert_same_map(plain[0], traced[0])
    records = traced[3]
    device = [s for s in records["spans"] if s["thread"] == "device"]
    for s in device:
        assert records["start"] <= s["start"] <= s["end"] <= records["stop"]
    names = collections.Counter(s["name"] for s in device)
    fused = len(traced[2])
    if chunk == 1:
        assert names["dev.preprocess.1_bilateral"] == fused
        assert names["dev.fusion.measurement_blending"] == fused
    else:
        assert names == {"dev.chunk.replay": traced[0].graph_replays}
        assert records["h2d_bytes.pinned"] > 0
    waits = collections.Counter(s["name"][5:] for s in records["spans"]
                                if s["name"].startswith("wait."))
    assert records["host_waits"] == dict(waits)


@pytest.mark.cuda
def test_staged_columns_on_card(cuda_device):
    """--log_timings_staged on the card: the timers are read after the
    timings line's count, without a synchronisation of their own; every
    column is filled, as the tracer's device spans of the same timers."""
    pipe, _, fused, records = run(1, trace=True, device=cuda_device,
                                  log_timings="t.txt",
                                  log_timings_staged=True)
    assert len(pipe.timings_log_lines) == len(fused)
    device = collections.Counter(s["id"] for s in records["spans"]
                                 if s["thread"] == "device")
    for i, line in zip(fused, pipe.timings_log_lines):
        words = line.split()
        values = dict(zip(words[0::2], words[1::2]))
        assert all(float(values[c]) > 0 for c in ("preprocessing",) +
                   COLUMNS if c != "measurement_blending"), line
        assert device[i] == len(TP.PASSES) + len(COLUMNS) + 1


@pytest.mark.cuda
def test_app_traces_on_card(cuda_device, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    flags = [f for f in APP_FLAGS if f not in ("--device", "cpu")]
    assert app_main(["--device", "cuda", *flags, "--profile_dir", "trace",
                     "--log_timings", "timings.txt", FIXTURE,
                     "groundtruth.txt"]) == 0
    assert not tracer.on
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"frame", "preprocess", "fusion", "wait.upload"} <= names
    assert (tmp_path / "timings_cpu.txt").read_text().startswith("frame ")


def test_trace_cells_reads_a_cell_on_the_cpu(tmp_path):
    """tools/trace_cells on a benchmark cell at its CPU-test size: the
    stretches alternate the tracer, the traced ones read the six metrics,
    the creations a frame and frame spans that sum to the benchmark's
    process_frame spans, the program's spans change no number of the
    device summary, and the check passes; a --set setting is applied over
    the cell's and named in every line."""
    assert trace_cells.main([
        "--workload", "tum640_20m_defaults.explore.live", "--seed",
        "2147483999", "--window", "0.5", "--stretch", "0.5", "--pairs",
        "1", "--out", str(tmp_path), "--cpu", "--set",
        "traffic.check_frames=3"]) == 0
    lines = [json.loads(line) for line in (
        tmp_path / "trace_tum640_20m_defaults.explore.live_2147483999.jsonl"
    ).read_text().splitlines()]
    costs, plain, profiled, checks = lines[0], lines[1:3], lines[3:5], \
        lines[5]
    assert all(line["set"] == {"traffic.check_frames": 3} for line in lines)
    assert costs["span_pair_us"] > 0 and costs["event_mark_us"] > 0
    assert [r["tracer"] for r in plain + profiled] == [False, True] * 2
    for r in (plain[1], profiled[1]):
        assert r["frames"] > 0
        assert r["frame_vs_process_frame"] == pytest.approx(1.0, abs=0.05)
    traced = profiled[1]
    assert traced["same_numbers"] is True
    assert traced["host_waits_per_frame"] > 0
    assert traced["preprocess_device_ms_per_frame"] > 0
    assert traced["fusion_device_ms_per_frame"] > 0
    assert traced["creations_made_per_frame"] > 0
    assert traced["creations_deferred_per_frame"] >= 0
    assert traced["dropped"] == 0
    assert checks["checks"] and all(
        value <= limit for value, limit in checks["checks"].values())
