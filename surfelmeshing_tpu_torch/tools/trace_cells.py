"""Traced stretches of a benchmark cell with the port's tracer
(utils/timing.tracer) off and on in turns, for the readings that the
tracer's spans and counters give and for the cost of tracing.

After the cell's set-up (benchmark/cell.py: build, warm-up) and one
measured window of frames, the tool runs `--pairs` pairs of stretches of
the cell's `trace_seconds` (ABBA: off-on, on-off, ...), first without a
profiler (the cost of tracing: fps, host dispatch and the benchmark's own
process_frame spans, off against on), then under the benchmark's own
CUDA-only profiler (benchmark/devtrace.py: device busy and idle time, and
the idle gaps named by the benchmark's spans, then again by the
benchmark's and the program's spans together).  It ends with the cell's
check, and prints one JSON line a stretch, all of which it also writes to
OUT/trace_<cell>_<seed>.jsonl (OUT: build/trace_cells by default).

The readers of the tracer's records are program_metrics (the per-layer
metrics the spans and counters are for), busy_within (device busy time
inside each device span) and wait_detail (device idle time inside each
wait span).  Run from the root of the repository, which holds benchmark/:

    python3 -m surfelmeshing_tpu_torch.tools.trace_cells \\
        --workload <cell> --seed <n> [--window 30] [--pairs 3] [--out DIR]
    [--set KEY=VALUE ...]

--cpu runs the cell at the size of the benchmark's CPU tests
(benchmark/tests/tiny_cell.py).  --set replaces one of the cell's settings
("config.<key>" or "traffic.<key>", the value as JSON), e.g.
`--set traffic.frame_chunk=1` dispatches a chunked cell per frame, where
the fusion phases' device spans (dev.fusion.<column>) are recorded.
"""

import argparse
import bisect
import collections
import json
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from benchmark import cell as C
from benchmark import devtrace, stats

from ..ops.fusion import StageTimer
from ..utils.timing import tracer

ROOT = Path(C.ROOT)


def dur(s: dict) -> float:
    return s["end"] - s["start"]


def program_metrics(rec: dict, frames: int, main: str) -> dict:
    """The readings of Tracer.stop()'s records `rec` over a stretch that
    fused `frames` frames, on the frame-loop thread named `main`: the six
    per-layer metrics (host_wait_ms_per_frame: wait.* spans;
    host_waits_per_frame: the host_waits counter; input_stage_ms_per_frame:
    self time of input.depth and input.stage; preprocess_device_ms_per_frame
    and fusion_device_ms_per_frame: dev.preprocess.* and dev.fusion.* spans,
    which bracket idle time too (busy_within reads the busy time inside
    them); snapshot_wait_ms: wait.snapshot per snapshot span), the
    creations made and deferred a frame (the pipelines' creations.*
    counters, as far as the count readbacks confirmed them), the sum of
    the frame spans, and the breakdown by span name."""
    spans = rec["spans"]
    loop = [s for s in spans if s["thread"] == main]
    kids = collections.defaultdict(float)
    for s in spans:
        if s["parent"] >= 0:
            kids[s["parent"]] += dur(s)
    self_s = collections.defaultdict(float)
    count = collections.Counter()
    for k, s in enumerate(spans):
        if s["thread"] == main:
            self_s[s["name"]] += dur(s) - kids[k]
            count[s["name"]] += 1
    waits = [s for s in loop if s["name"].startswith("wait.")]
    wait_by = collections.defaultdict(lambda: [0, 0.0])
    for s in waits:
        wait_by[s["name"]][0] += 1
        wait_by[s["name"]][1] += dur(s)
    inputs = sum(self_s[n] for n in ("input.depth", "input.stage"))
    dev = collections.defaultdict(float)
    for s in spans:
        if s["thread"] == "device":
            dev[s["name"]] += dur(s)
    pre = sum(v for n, v in dev.items() if n.startswith("dev.preprocess."))
    fus = sum(v for n, v in dev.items() if n.startswith("dev.fusion."))
    snaps = count["snapshot"]
    mesher = [s for s in spans if s["name"] == "mesher.iteration"]
    made, deferred = (sum(p.get(k, 0) for p in rec["pipelines"])
                      for k in ("creations.made", "creations.deferred"))
    return {
        "host_wait_ms_per_frame": 1e3 * sum(map(dur, waits)) / frames,
        "host_waits_per_frame": sum(rec["host_waits"].values()) / frames,
        "input_stage_ms_per_frame": 1e3 * inputs / frames,
        "preprocess_device_ms_per_frame": 1e3 * pre / frames,
        "fusion_device_ms_per_frame": 1e3 * fus / frames,
        "snapshot_wait_ms": 1e3 * wait_by["wait.snapshot"][1] / snaps
        if snaps else None,
        "creations_made_per_frame": made / frames,
        "creations_deferred_per_frame": deferred / frames,
        "frame_span_s": sum(dur(s) for s in loop if s["name"] == "frame"),
        "self_ms_per_frame": {n: 1e3 * v / frames for n, v in
                              sorted(self_s.items(), key=lambda x: -x[1])},
        "span_counts": dict(count),
        "waits": {n: [c, 1e3 * v] for n, (c, v) in wait_by.items()},
        "device_ms_per_frame": {n: 1e3 * v / frames for n, v in
                                sorted(dev.items(), key=lambda x: -x[1])},
        "mesher_iterations": len(mesher),
        "mesher_ms_mean": 1e3 * sum(map(dur, mesher)) / len(mesher)
        if mesher else None,
        "dropped": rec["dropped"], "host_waits": rec["host_waits"],
        "h2d_bytes.pageable": rec["h2d_bytes.pageable"],
        "h2d_bytes.pinned": rec["h2d_bytes.pinned"],
        "d2h_bytes": rec["d2h_bytes"], "pipelines": rec["pipelines"],
    }


def device_intervals(events: list, t_mark: float) -> list:
    """The trace's device activity (kernels, copies, fills), merged, on
    the host clock through the marker (the first device event)."""
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                    for e in events if e.get("ph") == "X" and
                    e.get("cat", "") in devtrace.DEVICE_CATS)
    if not device:
        return []
    offset = t_mark - device[0][0] * 1e-6
    return stats.merge_intervals([(a * 1e-6 + offset, b * 1e-6 + offset)
                                  for a, b in device[1:]])


def busy_within(merged: list, spans: list) -> dict:
    """Device busy seconds inside each span, summed by name."""
    starts = [m[0] for m in merged]
    out = collections.defaultdict(float)
    for s in spans:
        a, b = s["start"], s["end"]
        k = max(bisect.bisect_right(starts, a) - 1, 0)
        while k < len(merged) and merged[k][0] < b:
            lo, hi = max(merged[k][0], a), min(merged[k][1], b)
            if hi > lo:
                out[s["name"]] += hi - lo
            k += 1
    return dict(out)


def wait_detail(merged: list, loop: list, dev: list) -> list:
    """For each wait span with more than 1 ms of device idle inside:
    [name, ms, idle ms, ms from the last device activity's end to the
    wait's end, ms from the wait's start to the first idle instant, the
    end of the last device span before the wait's end, relative to the
    wait's end], the first 40."""
    out = []
    for s in loop:
        if not s["name"].startswith("wait."):
            continue
        a, b = s["start"], s["end"]
        busy = stats.union_length(merged, a, b)
        if (b - a) - busy < 1e-3:
            continue
        last = max((m[1] for m in merged if m[1] <= b), default=None)
        first_idle = None
        for m in merged:
            if m[0] <= a < m[1]:
                first_idle = m[1]
        dev_end = max((d["end"] for d in dev if d["end"] <= b + 0.05),
                      default=None)
        out.append([s["name"], 1e3 * (b - a), 1e3 * ((b - a) - busy),
                    None if last is None else 1e3 * (b - last),
                    None if first_idle is None else 1e3 * (first_idle - a),
                    None if dev_end is None else 1e3 * (dev_end - b)])
    return out[:40]


def site_costs(device) -> dict:
    """Host microseconds of a begin/end pair and of a StageTimer mark with
    the tracer on: the cost of a span site and of a device-span mark."""
    tracer.start()
    n = 20000
    t = time.perf_counter()
    for _ in range(n):
        tracer.begin("x")
        tracer.end()
    pair = (time.perf_counter() - t) / n
    timer = StageTimer(device)
    m = 2000
    t = time.perf_counter()
    for _ in range(m):
        timer("c")
    mark = (time.perf_counter() - t) / m
    sync(device)
    tracer.stop()
    return {"span_pair_us": 1e6 * pair, "event_mark_us": 1e6 * mark}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def loop_numbers(win, frames: int) -> dict:
    pf = sum(e - s for n, s, e in win.spans if n == "process_frame")
    return {"frames": frames, "seconds": win.seconds,
            "fps": frames / win.seconds,
            "host_dispatch_ms_per_frame":
                1e3 * (sum(win.dispatch_s) + win.drain_s) / frames,
            "process_frame_s": pf}


def plain_stretch(run, seconds: float, on: bool) -> dict:
    """A stretch without the profiler, the tracer on or off."""
    run.pipe.drain()
    sync(run.device)
    if on:
        tracer.start()
    win = run.loop.run(C.Window(), seconds=seconds)
    sync(run.device)
    rec = tracer.stop() if on else None
    frames = len(win.fused)
    out = {"profiled": False, "tracer": on,
           "captures": run.pipe.graph_captures, **loop_numbers(win, frames)}
    if rec is not None:
        m = program_metrics(rec, frames, threading.main_thread().name)
        out["frame_vs_process_frame"] = \
            m["frame_span_s"] / out["process_frame_s"]
        out["spans_per_frame"] = sum(m["span_counts"].values()) / frames
        out["device_spans_per_frame"] = sum(
            1 for s in rec["spans"] if s["thread"] == "device") / frames
    return out


def export(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def stretch(run, seconds: float, on: bool) -> dict:
    """A stretch under the benchmark's profiler, the tracer on or off;
    traced, the program's spans also name the idle gaps (`same_numbers`:
    every other number of the summary is unchanged by them)."""
    run.pipe.drain()
    sync(run.device)
    prof = devtrace.profiler(run.device.type == "cuda")
    prof.start()
    t_mark = devtrace.mark(run.device)
    if on:
        tracer.start()
    t0 = time.perf_counter()
    win = run.loop.run(C.Window(), seconds=seconds)
    sync(run.device)
    t1 = time.perf_counter()
    rec = tracer.stop() if on else None
    prof.stop()
    events = export(prof)
    base = devtrace.summarize(events, win.spans, t_mark, t0, t1)
    frames = len(win.fused)
    out = {"profiled": True, "tracer": on,
           "captures": run.pipe.graph_captures, **loop_numbers(win, frames),
           "snapshot_ms": 1e3 * sum(win.snapshot_s) / len(win.snapshot_s)
           if win.snapshot_s else None,
           "busy_ms_per_frame": 1e3 * base["busy_s"] / frames,
           "idle_pct": 100 * (1 - base["busy_s"] / base["window_s"]),
           "window_s": base["window_s"], "gaps": base["idle_gaps"],
           "device_ops": base["device_ops"]}
    if rec is None:
        return out
    main = threading.main_thread().name
    out.update(program_metrics(rec, frames, main))
    loop = [s for s in rec["spans"] if s["thread"] == main]
    prog = [(s["name"], s["start"], s["end"]) for s in loop]
    fine = devtrace.summarize(events, win.spans + prog, t_mark, t0, t1)
    out["same_numbers"] = all(
        fine[k] == base[k] for k in ("busy_s", "window_s", "kernels",
                                      "device_ops")) and \
        [g[1] for g in fine["idle_gaps"]] == \
        [g[1] for g in base["idle_gaps"]]
    out["fine_gaps"] = fine["idle_gaps"]
    out["frame_vs_process_frame"] = out["frame_span_s"] / \
        out["process_frame_s"]
    merged = device_intervals(events, t_mark)
    dev = [s for s in rec["spans"] if s["thread"] == "device"]
    within = busy_within(merged, dev)
    out["busy_within_ms_per_frame"] = {
        n: 1e3 * v / frames for n, v in
        sorted(within.items(), key=lambda x: -x[1])}
    for layer in ("preprocess", "fusion"):
        out[f"{layer}_busy_ms_per_frame"] = 1e3 * sum(
            v for n, v in within.items()
            if n.startswith(f"dev.{layer}.")) / frames
    out["wait_detail"] = wait_detail(merged, loop, dev)
    out["busy_during_wait_ms_per_frame"] = 1e3 * sum(busy_within(
        merged, [s for s in loop if s["name"].startswith("wait.")])
        .values()) / frames
    return out


BRIEF = ("tracer", "frames", "fps", "host_dispatch_ms_per_frame",
         "busy_ms_per_frame", "idle_pct", "host_wait_ms_per_frame",
         "host_waits_per_frame", "input_stage_ms_per_frame",
         "preprocess_device_ms_per_frame", "fusion_device_ms_per_frame",
         "snapshot_wait_ms", "frame_vs_process_frame", "same_numbers",
         "preprocess_busy_ms_per_frame", "fusion_busy_ms_per_frame",
         "creations_made_per_frame", "creations_deferred_per_frame",
         "captures")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--window", type=float, default=30.0)
    ap.add_argument("--stretch", type=float, default=None,
                    help="seconds a stretch (default: the cell's "
                    "trace_seconds)")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "build" / "trace_cells"))
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE", help="a cell setting replaced "
                    "(config.<key> or traffic.<key>; the value as JSON)")
    args = ap.parse_args(argv)
    overrides = {}
    for item in args.set:
        key, _, value = item.partition("=")
        overrides[key] = json.loads(value)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    t_start = time.perf_counter()
    if args.cpu:
        from benchmark.tests import tiny_cell
        card = "cpu"
        run = C.Run(args.workload, args.seed, args.window, False, t_start,
                    device="cpu", overrides={
                        **tiny_cell.overrides(args.workload), **overrides})
    else:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        run = C.Run(args.workload, args.seed, args.window, False, t_start,
                    overrides=overrides)
    run.build()
    run.warm_up()
    if not args.cpu:
        C.isolate_main_thread()
    win = run.loop.run(C.Window(), seconds=args.window)
    seconds = args.stretch or run.traffic["trace_seconds"]
    order = []
    for p in range(args.pairs):
        order += [False, True] if p % 2 == 0 else [True, False]
    tag = {"workload": args.workload, "seed": args.seed, "card": card,
           "set": overrides}
    lines = [dict(site_costs(run.device), **tag)]
    print(json.dumps(lines[-1]), flush=True)
    for on in order:
        lines.append(dict(plain_stretch(run, seconds, on), **tag))
        print(json.dumps(lines[-1]), flush=True)
    for on in order:
        r = dict(stretch(run, seconds, on), **tag,
                 surfels=run.pipe.surfel_count())
        lines.append(r)
        print(json.dumps({k: r.get(k) for k in BRIEF}), flush=True)
    checks = run.check()
    if run.mesher is not None:
        run.mesher.finish()
    lines.append({"window_frames": len(win.fused), "window_s": win.seconds,
                  "checks": checks, **tag})
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"trace_{args.workload}_{args.seed}.jsonl").write_text(
        "".join(json.dumps(line) + "\n" for line in lines))
    print(json.dumps({"checks": checks, "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
