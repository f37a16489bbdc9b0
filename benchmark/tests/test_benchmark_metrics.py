"""The benchmark's arithmetic and its per-layer readers on made-up
inputs."""

import math

import numpy as np
import pytest

from benchmark import cell as C
from benchmark import devtrace, stats
from benchmark.run import load_reader


def test_rate_and_p95():
    assert stats.rate(300, 10.0) == 30.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    assert stats.p95(range(1, 101)) == pytest.approx(95.05)
    assert stats.p95([5.0]) == 5.0


def test_intervals():
    iv = [(0, 2), (1, 3), (5, 6)]
    assert stats.merge_intervals(iv) == [[0, 3], [5, 6]]
    assert stats.union_length(iv, 0, 10) == 4
    assert stats.union_length(iv, 1, 5.5) == 2.5
    assert stats.idle_gaps(iv, -1, 8) == [[-1, 0], [3, 5], [6, 8]]


def test_roofline():
    peak = {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12}
    b = stats.blend_bytes(480, 640)
    assert b == 6_144_000
    # 6,144,000 B at 3.35 TB/s is 1.834 us; at 21.8 us that is 8.4%.
    assert stats.roofline_pct(b, 0, 21.8e-6, peak) == pytest.approx(
        100 * 6_144_000 / 3.35e12 / 21.8e-6)
    assert stats.roofline_pct(0, 67e6, 1e-6, peak) == pytest.approx(100.0)


def _trace_events():
    """A marker at 0 us, then kernels and a copy; the host clock equals
    the device's (t_mark 0)."""
    ev = [{"ph": "X", "cat": "kernel", "name": "fill_marker", "ts": 0.0,
           "dur": 1.0}]
    for s in (5.0, 100.0, 900.0):
        ev.append({"ph": "X", "cat": "kernel", "name": "blend_kernel",
                   "ts": s, "dur": 50.0})
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
               "ts": 150.0, "dur": 100.0})
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
               "ts": 3.0, "dur": 1.0})
    return ev


SPANS = [("process_frame", 0.0, 0.0004), ("snapshot_for_meshing", 0.0005,
                                          0.0008)]


def _summary():
    return devtrace.summarize(_trace_events(), SPANS, 0.0, 0.0, 0.001)


def test_devtrace_summary():
    s = _summary()
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(250e-6)
    assert s["kernels"]["blend_kernel"] == (pytest.approx(150e-6), 3)
    assert "fill_marker" not in s["kernels"]
    assert s["idle_gaps"][0] == ["snapshot_for_meshing",
                                 pytest.approx(650e-6)]
    assert s["idle_gaps"][1] == ["host_loop", pytest.approx(50e-6)]
    assert s["idle_gaps"][2] == ["process_frame", pytest.approx(45e-6)]
    assert s["device_ops"][0][0] == "blend_kernel"


def _ctx(trace=True):
    win = C.Window(fused=[10, 11, 12, 13], dispatch_s=[0.01] * 4,
                   snapshot_s=[0.002, 0.004], drain_s=0.02)
    tr = _summary()
    tr["frames"] = 2
    return {"window": win, "trace": tr if trace else None,
            "frame_shape": (480, 640),
            "peaks": stats.peaks(), "n_eff": [1_048_576, 1_114_112],
            "surfels": (1_000_000, 1_030_000),
            "settings": {
                "regularization_iterations_per_integration_iteration": 1}}


def test_readers():
    ctx = _ctx()
    assert load_reader("host_dispatch_ms_per_frame")(ctx) == \
        pytest.approx(1000 * (0.04 + 0.02) / 4)
    assert load_reader("device_busy_ms_per_frame")(ctx) == \
        pytest.approx(0.125)
    assert load_reader("device_idle_pct")(ctx) == pytest.approx(75.0)
    assert load_reader("blend_roofline_pct")(ctx) == pytest.approx(
        100 * 6_144_000 / 3.35e12 / 50e-6)
    assert load_reader("snapshot_ms")(ctx) == pytest.approx(3.0)


def test_readers_return_nothing_without_something_to_read():
    ctx = _ctx(trace=False)
    ctx["window"].snapshot_s = []
    for name in ("device_busy_ms_per_frame", "device_idle_pct",
                 "blend_roofline_pct", "snapshot_ms"):
        assert load_reader(name)(ctx) is None
    ctx = _ctx()
    ctx["trace"]["kernels"] = {"other": (1.0, 1)}
    assert load_reader("blend_roofline_pct")(ctx) is None


def _regularize_ctx(kernels, n_eff=(1_048_576, 1_114_112), iterations=1):
    ctx = _ctx()
    ctx["trace"]["kernels"] = kernels
    ctx["n_eff"] = list(n_eff)
    ctx["settings"] = {
        "regularization_iterations_per_integration_iteration": iterations}
    return ctx


def test_regularize_roofline_reads_the_rows_stepped():
    read = load_reader("regularize_roofline_pct")
    assert stats.regularize_bytes(1, 1) == 192
    rows = 1_048_576 + 1_114_112
    # 192 B a row over both frames' rows at 3.35 TB/s, over the kernel's
    # 0.2 ms in the stretch (other kernels ignored).
    kernels = {"regularize_kernel(RegularizeArgs)": (0.2e-3, 2),
               "blend_kernel": (1.0, 2)}
    want = 100 * 192 * rows / 3.35e12 / 0.2e-3
    assert read(_regularize_ctx(kernels)) == pytest.approx(want)
    # Two iterations a frame: twice the launches and twice the bytes.
    kernels["regularize_kernel(RegularizeArgs)"] = (0.4e-3, 4)
    assert read(_regularize_ctx(kernels, iterations=2)) == \
        pytest.approx(want)
    # The dotted name of the Replica cell reads with the same reader.
    assert load_reader("regularize_roofline_pct.replica")(
        _regularize_ctx(kernels, iterations=2)) == pytest.approx(want)


def test_regularize_roofline_returns_nothing_without_something_to_read():
    read = load_reader("regularize_roofline_pct")
    # The exact form launches no kernel; a stretch with no frame fused.
    assert read(_regularize_ctx({"blend_kernel": (1.0, 2)})) is None
    assert read(_regularize_ctx(
        {"regularize_kernel": (0.2e-3, 2)}, n_eff=())) is None
    assert read(dict(_regularize_ctx({"regularize_kernel": (1e-3, 2)}),
                     trace=None)) is None


def test_traced_stretch_hands_readers_its_rows():
    """A tiny traced run on the CPU: the stretch's n_eff is one entry per
    frame fused in it, each holding the live count, and the live count at
    its start and end brackets the growth."""
    import tiny_cell
    r, out = tiny_cell.run("tum640_2m.loop.replay", trace=True)
    tr = out["trace"]
    assert tr["frames"] > 0 and len(tr["n_eff"]) == tr["frames"]
    start, end = tr["surfels"]
    assert 0 < start <= end
    assert min(tr["n_eff"]) >= start and max(tr["n_eff"]) <= 40_960


def test_mesher_view_and_triangles():
    pos = np.arange(12, dtype=np.float32).reshape(4, 3)
    rad = np.array([1, 1, -1, 1], np.float32)
    nrm = pos + 1
    st = np.arange(4, dtype=np.int32)
    full = ("full", pos[:3], rad[:3], nrm[:3], st[:3], 3)
    delta = ("delta", np.array([1, 3], np.int32), pos[[1, 3]] * 0 + 7,
             rad[[1, 3]], nrm[[1, 3]], st[[1, 3]], 4)
    view = C.mesher_view([full, delta])
    assert view[-1] == 4 and view[0][1, 0] == 7 and view[0][0, 0] == 0
    want = (view[0].copy(), view[1].copy(), view[2].copy(), view[3].copy())
    assert C.view_mismatch(view, want) == 0
    want[0][2, 1] += 1
    assert C.view_mismatch(view, want) == 1
    tris = np.array([[0, 1, 3], [0, 1, 1], [0, 2, 3], [0, 1, 4]])
    assert C.triangle_invalid(tris, rad) == 3
    assert C.triangle_invalid(np.zeros((0, 3)), rad) == 1


def test_per_frame_n_eff():
    assert C.per_frame_n_eff([(4, 8), (2, 16), (1, 4)]) == \
        [8] * 4 + [16] * 2 + [4]
    assert math.isinf(float("inf"))
