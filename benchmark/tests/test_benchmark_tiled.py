"""The tiled 20M cell (tum640_20m.explore.live) on the CPU at the size of
tiny_cell.py (160x120, a 163,840-row map of 40 tiles): a sound run on the
working-set route compares equal to the plain reference (the full-shape
route, benchmark/reference/) with no tile skipped, and the control (the
reference with its map in bfloat16) does not; the deployment is the
defaults cell's with the auto active-set budget; the tile selection's
reader reads the kernel's device time and nothing without it, and the
cell's dotted metrics read with their quantities' readers."""

import json

import pytest

import tiny_cell
from benchmark import cell as C
from benchmark.reference import step as rstep
from benchmark.run import load_reader

CELL = "tum640_20m.explore.live"


def failed(checks):
    return {k: v for k, (v, lim) in checks.items() if v > lim}


def test_the_cell_is_the_stated_deployment():
    cell, config, traffic = C.find_cell(CELL)
    _, defaults, defaults_traffic = C.find_cell(
        "tum640_20m_defaults.explore.live")
    assert cell["chips"] == 1 and config["reduced"] == []
    assert traffic == defaults_traffic
    assert config["camera"] == defaults["camera"]
    s = C.program_settings(config)
    assert s == dict(C.program_settings(defaults), active_surfel_budget=-1)
    assert rstep.capacity(s) == 20_000_768


def test_sound_run_matches_the_reference():
    r, out = tiny_cell.run(CELL)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert failed(out["checks"]) == {}
    assert {"start_state_mismatch", "end_state_mismatch",
            "bucket_short_frames", "snapshot_row_mismatch",
            "triangle_invalid"} <= set(out["checks"])
    pipe = r.pipe
    assert int(pipe.state.skipped_tile_count) == 0
    # The working set is a subset of the map: a budget below the capacity.
    assert pipe.active_budget() < pipe.state.pack.shape[0] == 163_840
    # The async mesher took snapshots in the window: snapshot_ms.tiled
    # has something to read.
    assert load_reader("snapshot_ms.tiled")({"window": out["window"]}) > 0


def test_control_fails():
    _, out = tiny_cell.run(CELL, control=True)
    bad = failed(out["checks"])
    assert bad.get("start_state_mismatch", 0) > 0
    assert bad.get("end_state_mismatch", 0) > 0


def ctx(kernels, frames=4):
    trace = {"frames": frames, "kernels": kernels, "busy_s": 0.01,
             "window_s": 0.02}
    return {"window": C.Window(), "trace": trace, "frame_shape": (480, 640),
            "peaks": {}}


def test_reader_reads_the_kernel_and_nothing_without_it():
    read = load_reader("tile_select_ms_per_frame")
    assert read(ctx({"blend_kernel": (0.001, 4)})) is None
    assert read(ctx({})) is None
    assert read(dict(ctx({}), trace=None)) is None
    assert read(ctx({"tile_select_kernel(TileSelectArgs)": (0.0012, 4),
                     "blend_kernel": (0.5, 4)})) == pytest.approx(0.3)
    assert read(ctx({"tile_select_kernel": (0.0012, 4)}, frames=0)) is None


def test_tiled_metrics_are_the_existing_quantities():
    """The dotted per-layer metrics of the cell read with the readers of
    their quantities, and each metric of the cell lists it alone."""
    bench = json.loads((C.ROOT / "BENCHMARK.json").read_text())
    mine = [m for m in bench["per_layer"] if CELL in m.get("workloads", [])]
    assert {m["name"] for m in mine} == {
        "tile_select_ms_per_frame", "host_dispatch_ms_per_frame.tiled",
        "device_busy_ms_per_frame.tiled", "device_idle_pct.tiled",
        "blend_roofline_pct.tiled", "snapshot_ms.tiled"}
    assert all(m["workloads"] == [CELL] for m in mine)
    for m in mine[1:]:
        assert load_reader(m["name"]) is not None
