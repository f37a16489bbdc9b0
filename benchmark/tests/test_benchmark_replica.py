"""The Replica cell (replica1200_20m.room.replay) on the CPU at the
deployment's camera cut by 8: 150x85 frames, fx = fy = 75, principal point
75.0, 42.5, depth unit 6553.5, the open valid circle, and the map, bucket
step and creation budget cut by 64 with the pixels, so the budget binds as
at full size.  A sound run compares equal to the plain reference and the
control (the reference with its map in bfloat16) does not; the room mix
keeps its depth within max_depth and walks at the assumed speed."""

import json
import time

import numpy as np
import pytest

from benchmark import cell as C
from benchmark.traffic import generator as g

CELL = "replica1200_20m.room.replay"
CUT = 8
CAMERA = {"width": 1200 // CUT, "height": 680 // CUT, "fx": 600.0 / CUT,
          "fy": 600.0 / CUT, "cx": 600.0 / CUT, "cy": 340.0 / CUT,
          "fps": 30}


def overrides() -> dict:
    _, config, traffic = C.find_cell(CELL)
    s = dict(config["settings"])
    px = CUT * CUT
    s.update(max_surfel_count=s["max_surfel_count"] // px,
             shape_bucket_step=s["shape_bucket_step"] // px,
             max_creations_per_frame=s["max_creations_per_frame"] // px)
    return {"config.camera": CAMERA, "config.settings": s,
            "traffic.trajectory": dict(traffic["trajectory"], period=120),
            "traffic.warmup_frames": 8, "traffic.check_frames": 4,
            "traffic.trace_seconds": 1.0}


def run(control=False, seed=2 ** 31 + 9):
    r = C.Run(CELL, seed, 1.0, False, time.perf_counter(), device="cpu",
              overrides=overrides(), control=control)
    return r, r.execute()


def failed(checks):
    return {k: v for k, (v, lim) in checks.items() if v > lim}


def test_the_cell_is_the_stated_deployment():
    cell, config, traffic = C.find_cell(CELL)
    assert cell["chips"] == 1 and config["reduced"] == []
    assert config["camera"] == {"width": 1200, "height": 680, "fx": 600.0,
                                "fy": 600.0, "cx": 600.0, "cy": 340.0,
                                "fps": 30}
    s = C.program_settings(config)
    assert (s["depth_scaling"], s["depth_valid_region_radius"],
            s["max_surfel_count"]) == (6553.5, 690.0, 20_000_000)
    # The circle holds every pixel: the half-diagonal is 689.6 px.
    assert np.hypot(600.0, 340.0) < s["depth_valid_region_radius"]
    # One lap of warm-up: the window is the second lap.
    assert (traffic["frame_chunk"], traffic["meshing"],
            traffic["warmup_frames"], traffic["trajectory"]["period"]) == \
        (4, False, 450, 450)


def test_sound_run_matches_the_reference():
    r, out = run()
    assert out["attempted"] > 0 and out["failed"] == 0
    assert failed(out["checks"]) == {}
    assert {"start_state_mismatch", "end_state_mismatch",
            "bucket_short_frames"} == set(out["checks"])
    # The cut budget (512 creations a frame) binds: creations are deferred.
    assert int(r.pipe.state.deferred_count) > 0
    assert r.pipe.graph_captures == 0 and r.pipe.bucket_pick_log


def test_control_fails():
    _, out = run(control=True)
    bad = failed(out["checks"])
    assert bad.get("start_state_mismatch", 0) > 0
    assert bad.get("end_state_mismatch", 0) > 0


def mix():
    return json.loads((C.BENCH / "traffic" / "room.replay.json").read_text())


def test_depth_within_max_depth_on_most_pixels():
    """At least 85% of a lap's pixels carry depth within max_depth (3 m
    at 6553.5 units a metre); every 10th frame of the lap at 150x85."""
    m = mix()
    frames = g.render(m, CAMERA, 6553.5, 2 ** 31 + 3, "cpu")
    d = frames.depth[::10].astype(np.int64)
    share = ((d > 0) & (d <= int(6553.5 * 3.0))).mean()
    assert share >= 0.85


def test_room_walk_speed_and_slots():
    m = mix()
    _, t = g.trajectory(m["trajectory"])
    speed = 30 * g.path_speed_m_per_frame(t)
    assert 0.39 < speed.mean() < 0.42
    assert len(m["scene"]["slots"]) >= len(m["scene"]["objects"])


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 5])
def test_same_seed_same_frames(seed):
    m = dict(mix(), trajectory=dict(mix()["trajectory"], period=4))
    a = g.render(m, CAMERA, 6553.5, seed, "cpu")
    b = g.render(m, CAMERA, 6553.5, seed, "cpu")
    assert np.array_equal(a.depth, b.depth)
    assert np.array_equal(a.color, b.color)
    assert a.depth.shape == (4, 85, 150)
