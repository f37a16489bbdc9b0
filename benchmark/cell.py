"""One run of one cell: set-up, the measured window, the traced stretch
and the check against the plain reference.

A cell names a deployment (configs/<name>.json: camera and pipeline
settings) and a traffic mix (traffic/<name>.json: scene, trajectory,
dispatch, meshing, warm-up).  The run

1. renders the mix's distinct frames on the device from the seed and
   keeps them on the host as the pipeline's input (an RGBDVideo of
   ArrayImageFrames; frame i shows image i mod period);
2. builds the program's ReconstructionPipeline (and, in a live mix, its
   MeshingDriver with the app's snapshot rule) and warms it up over the
   mix's warm-up frames, keeping a host copy of the map after the first
   `start_check_frames` fused frames;
3. measures for `seconds`: frames fed in a closed loop, each a
   process_frame call, then (live mixes) a snapshot whenever the mesher
   is idle; the window ends once the device has finished;
4. with a trace, profiles a further stretch of `trace_seconds`;
5. checks: the reference replays the first frames from an empty map
   against the copy kept in set-up, and steps the map the window left
   through `check_frames` further frames that the program runs through
   the same path.  It steps each frame over rows of its own choosing
   unless the deployment lets the dispatch policy defer creations
   (adaptive_creation_bound > 0); then it takes the program's bucket,
   once that bucket has been found to hold the reference's live rows
   plus the policy's least creation charge.  The mesher's view, rebuilt
   from every snapshot shipped, must equal the reference's rows, and
   every triangle must join three distinct live surfels.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from . import devtrace, stats
from .reference import fusion as rfu
from .reference import step as rstep
from .traffic import generator

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Frame indices stay exact in the program's f32 pose pack below 2**24.
FRAME_COUNT = 2 ** 24 - 1
# Rows of the map compared per mismatched surfel: pack, neighbors, slot
# distances.
WORDS_PER_ROW = 18 + 4 + 4


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find_cell(name: str, bench: dict = None) -> tuple:
    """(workload entry, configuration, traffic mix) of a cell, each found
    by name: the configuration's file as BENCHMARK.json gives it, the mix
    at traffic/<name>.json."""
    bench = bench or manifest()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def program_settings(config: dict) -> dict:
    """The configuration's settings as the program's config takes them."""
    out = dict(config["settings"])
    for k, v in out.items():
        if v == "inf":
            out[k] = float("inf")
    return out


class _Cyclic:
    """A video's frame list: frame i shows image i mod period at pose i
    mod period (a closed trajectory), as a fresh ArrayImageFrame."""

    def __init__(self, images, poses, frame_cls, fps):
        self.images, self.poses = images, poses
        self.frame_cls, self.fps = frame_cls, fps

    def __len__(self):
        return FRAME_COUNT

    def __getitem__(self, i):
        p = i % len(self.images)
        return self.frame_cls(self.images[p], i / self.fps, self.poses[p])


def make_video(frames: generator.Frames, camera: dict):
    from surfelmeshing_tpu_torch.io.synthetic import ArrayImageFrame
    from surfelmeshing_tpu_torch.io.tum import RGBDVideo
    from surfelmeshing_tpu_torch.utils.camera import PinholeCamera
    from surfelmeshing_tpu_torch.utils.se3 import SE3

    cam = PinholeCamera(camera["width"], camera["height"], camera["fx"],
                        camera["fy"], camera["cx"], camera["cy"])
    poses = [SE3(q, t) for q, t in zip(frames.quat, frames.trans)]
    fps = camera["fps"]
    return RGBDVideo(_Cyclic(frames.color, poses, ArrayImageFrame, fps),
                     _Cyclic(frames.depth, poses, ArrayImageFrame, fps),
                     cam, cam)


def isolate_main_thread() -> None:
    """Give the calling (frame loop) thread a CPU of its own and every
    other thread of the process (the mesher, the poller, the CUDA
    runtime's) the rest, so that which threads share a CPU no longer
    changes from run to run."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) < 4:
        return
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus[:-1])
        except OSError:
            pass                  # a thread that has ended meanwhile
    os.sched_setaffinity(0, cpus[-1:])


@dataclasses.dataclass
class Window:
    """What the frame loop recorded over one stretch of frames."""
    fused: list = dataclasses.field(default_factory=list)
    call_start: list = dataclasses.field(default_factory=list)
    dispatch_s: list = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)
    snapshot_s: list = dataclasses.field(default_factory=list)
    # (name, start, end) on the host clock of every process_frame call,
    # snapshot and drain, for naming the device's idle gaps.
    spans: list = dataclasses.field(default_factory=list)
    drain_s: float = 0.0
    seconds: float = 0.0


class Loop:
    """The closed frame loop over the program: process_frame, then in a
    live mix the app's snapshot rule (a snapshot whenever the mesher is
    idle)."""

    def __init__(self, pipe, video, mesher, chunk: int, record_events: bool):
        self.pipe, self.video, self.mesher = pipe, video, mesher
        self.chunk = chunk
        self.record_events = record_events
        self.next_index = 0
        self.shipped = []          # every snapshot shipped, in order
        self.last_snapshot = -1

    def snapshot(self, i: int, win: Window = None) -> None:
        t0 = time.perf_counter()
        snap = self.pipe.snapshot_for_meshing(i)
        t1 = time.perf_counter()
        if win is not None:
            win.snapshot_s.append(t1 - t0)
            win.spans.append(("snapshot_for_meshing", t0, t1))
        self.shipped.append(snap)
        self.mesher.submit_snapshot(snap, i)
        self.last_snapshot = i

    def run(self, win: Window, frames: int = None, seconds: float = None,
            snapshots: bool = True, ctr_log=None) -> Window:
        """Feed frames until `frames` are fused, or until `seconds` have
        passed at a chunk boundary; then drain the pipeline."""
        pipe, video = self.pipe, self.video
        t_start = time.perf_counter()
        deadline = None if seconds is None else t_start + seconds
        while True:
            n = len(win.fused)
            if frames is not None and n >= frames:
                break
            if deadline is not None and n % self.chunk == 0 and \
                    time.perf_counter() >= deadline:
                break
            i = self.next_index
            self.next_index += 1
            t0 = time.perf_counter()
            result = pipe.process_frame(video, i)
            t1 = time.perf_counter()
            win.spans.append(("process_frame", t0, t1))
            if result is None:
                continue
            win.fused.append(i)
            win.call_start.append(t0)
            win.dispatch_s.append(t1 - t0)
            if self.record_events:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                win.events.append(ev)
            if ctr_log is not None:
                st = pipe._state
                torch.stack([st.overflow_count, st.skipped_tile_count],
                            out=ctr_log[len(win.fused) - 1])
            if snapshots and self.mesher is not None and self.mesher.idle():
                self.snapshot(i, win)
        t0 = time.perf_counter()
        pipe.drain()
        t1 = time.perf_counter()
        win.spans.append(("drain", t0, t1))
        win.drain_s = t1 - t0
        win.seconds = t1 - t_start
        return win


def _host_rows(state, n: int) -> dict:
    """A host copy of a map's first n rows and its counters."""
    def copy(t):
        return t.to("cpu", copy=True)
    return {"pack": copy(state.pack[:n].view(torch.int32)),
            "neighbors": copy(state.neighbors[:, :n]),
            "nbr_dist": copy(state.nbr_dist[:, :n].view(torch.int32)),
            "counters": [int(state.surfel_count), int(state.merge_count),
                         int(state.overflow_count)]}


def rows_mismatch(got: dict, ref) -> int:
    """32-bit words of a host copy of a map's live rows (_host_rows) that
    differ from the reference's, a row's worth for each surfel the counts
    differ by, plus each counter that differs."""
    n_ref = int(ref.surfel_count)
    n = min(got["pack"].shape[0], n_ref)
    want = _host_rows(ref, n)
    bad = int(got["pack"][:n].ne(want["pack"]).sum())
    for k in ("neighbors", "nbr_dist"):
        bad += int(got[k][:, :n].ne(want[k]).sum())
    bad += WORDS_PER_ROW * abs(got["pack"].shape[0] - n_ref)
    bad += sum(a != b for a, b in zip(got["counters"], want["counters"]))
    return bad


def map_mismatch(got, ref) -> int:
    """32-bit words of two whole maps that differ, plus each counter."""
    bad = 0
    for name in ("pack", "nbr_dist"):
        a = getattr(got, name).view(torch.int32)
        b = getattr(ref, name).view(torch.int32).to(a.device)
        bad += int(a.ne(b).sum().item())
    bad += int(got.neighbors.ne(ref.neighbors.to(got.neighbors.device))
               .sum().item())
    for name in ("surfel_count", "merge_count", "overflow_count"):
        bad += int(int(getattr(got, name)) != int(getattr(ref, name)))
    return bad


def mesher_view(shipped: list) -> tuple:
    """The surfel rows the mesher was sent, rebuilt from every snapshot
    in order: (smooth (n, 3), radius_sq, normal (n, 3), stamps, n)."""
    n_max = max(int(s[-1]) for s in shipped)
    pos = np.zeros((n_max, 3), np.float32)
    rad = np.zeros(n_max, np.float32)
    nrm = np.zeros((n_max, 3), np.float32)
    stamps = np.zeros(n_max, np.int32)
    n = 0
    for s in shipped:
        if s[0] == "full":
            _, p, r, q, st, n = s
            n = int(n)
            pos[:n], rad[:n], nrm[:n], stamps[:n] = p[:n], r[:n], q[:n], \
                st[:n]
        else:
            _, idx, p, r, q, st, n = s
            n = int(n)
            pos[idx], rad[idx], nrm[idx], stamps[idx] = p, r, q, st
    return pos[:n], rad[:n], nrm[:n], stamps[:n], n


def view_mismatch(view: tuple, want: tuple) -> int:
    """Rows of the mesher's view whose bits differ from the reference's
    snapshot rows, plus every row the counts differ by."""
    n_view, n_want = view[-1], want[0].shape[0]
    n = min(n_view, n_want)
    if n == 0:
        return abs(n_view - n_want)
    bad = np.zeros(n, bool)
    for a, b in zip(view[:4], want):
        a = np.ascontiguousarray(a[:n]).view(np.int32).reshape(n, -1)
        b = np.ascontiguousarray(b[:n]).view(np.int32).reshape(n, -1)
        bad |= (a != b).any(axis=1)
    return int(bad.sum()) + abs(n_view - n_want)


def triangle_invalid(tris: np.ndarray, radius_sq: np.ndarray) -> int:
    """Triangles that do not join three distinct live surfels of the
    reference's map (an index past its count, a repeated index, or a
    merged surfel), plus one for an empty mesh."""
    n = radius_sq.shape[0]
    tris = np.asarray(tris, np.int64).reshape(-1, 3)
    if tris.shape[0] == 0:
        return 1
    out_of_range = (tris >= n).any(axis=1) | (tris < 0).any(axis=1)
    safe = np.where(out_of_range[:, None], 0, tris)
    repeated = (safe[:, 0] == safe[:, 1]) | (safe[:, 1] == safe[:, 2]) | \
        (safe[:, 0] == safe[:, 2])
    merged = (radius_sq[safe] < 0).any(axis=1)
    return int((out_of_range | repeated | merged).sum())


def per_frame_n_eff(picks: list) -> list:
    """n_eff of every frame from the pipeline's (frames, n_eff) picks."""
    out = []
    for frames, n_eff in picks:
        out += [n_eff] * frames
    return out


class Run:
    """One run of a cell.  `device` and `overrides` ("config.<key>" or
    "traffic.<key>" replaced) let the CPU tests run a cell at a tiny
    size; `control` puts the reference in bfloat16 in the program's place
    for the frames compared (control.py)."""

    def __init__(self, workload: str, seed: int, seconds: float,
                 trace: bool, t_process_start: float, device="cuda",
                 overrides: dict = None, control: bool = False):
        self.cell, self.config, self.traffic = find_cell(workload)
        for key, value in (overrides or {}).items():
            part, _, name = key.partition(".")
            getattr(self, part)[name] = value
        rstep.refuse_unchecked(self.config["settings"])
        self.workload, self.seed = workload, seed
        self.seconds, self.trace = seconds, trace
        self.t0 = t_process_start
        self.device = torch.device(device)
        self.control = control
        self.lines = []            # diagnostics, printed before the result

    def note(self, text: str) -> None:
        self.lines.append(text)

    # -- the program ---------------------------------------------------------

    def build(self):
        from surfelmeshing_tpu_torch.config import SurfelMeshingConfig
        from surfelmeshing_tpu_torch.meshing import MeshingDriver
        from surfelmeshing_tpu_torch.pipeline import ReconstructionPipeline

        tr = self.traffic
        cfg = SurfelMeshingConfig(**program_settings(self.config),
                                  frame_chunk=tr["frame_chunk"])
        self.frames = generator.render(
            tr, self.config["camera"], cfg.depth_scaling, self.seed,
            self.device)
        self.video = make_video(self.frames, self.config["camera"])
        self.pipe = ReconstructionPipeline(cfg, self.video.depth_camera,
                                           self.device)
        self.mesher = MeshingDriver(cfg) if tr["meshing"] else None
        self.loop = Loop(self.pipe, self.video, self.mesher,
                         tr["frame_chunk"],
                         self.device.type == "cuda" and tr["frame_chunk"] == 1)

    def warm_up(self) -> None:
        tr = self.traffic
        s = tr["start_check_frames"]
        win = self.loop.run(Window(), frames=s)
        self.start_picks = list(self.pipe.bucket_pick_log)
        self.start_frames = list(win.fused)
        st = self.pipe.state
        self.start_rows = _host_rows(st, int(st.surfel_count))
        chunk = tr["frame_chunk"]
        self.loop.run(win, frames=-(-tr["warmup_frames"] // chunk) * chunk)
        if self.mesher is not None:
            self.mesher.drain()
        self.pipe.drain()

    # -- the run -------------------------------------------------------------

    def execute(self) -> dict:
        from surfelmeshing_tpu_torch.ops import blend, cuda_build

        cuda = self.device.type == "cuda"
        self.build()
        self.warm_up()
        pipe = self.pipe
        captures0, replays0 = pipe.graph_captures, pipe.graph_replays
        launches0, builds0 = blend.blend_core.launches, cuda_build.builds
        picks0 = len(pipe.bucket_pick_log)
        rows0 = pipe.snapshot_rows_shipped
        ctr_log = torch.zeros((1 << 16, 2), dtype=torch.int32,
                              device=self.device)
        if cuda:
            isolate_main_thread()
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
            e0.synchronize()
        t_window = time.perf_counter()
        setup_s = t_window - self.t0
        win = self.loop.run(Window(), seconds=self.seconds, ctr_log=ctr_log)
        peak = torch.cuda.max_memory_allocated(self.device) if cuda else 0
        n = len(win.fused)
        counters = ctr_log[:n].cpu().numpy()
        grew = np.zeros(n, bool)
        if n:
            before = np.vstack([[0, 0], counters[:-1]])
            before[0] = counters[0]
            grew = (counters > before).any(axis=1)
        # A chunk's growth shows at its last frame; charge its frames.
        failed = set()
        for k in np.nonzero(grew)[0]:
            failed.update(range(max(0, k - self.loop.chunk + 1), k + 1))
        self.note(f"window: {n} frames in {win.seconds:.6f} s; graph "
                  f"captures {pipe.graph_captures - captures0}, replays "
                  f"{pipe.graph_replays - replays0}, blend launches "
                  f"{blend.blend_core.launches - launches0}, builds "
                  f"{cuda_build.builds - builds0}, bucket picks "
                  f"{len(pipe.bucket_pick_log) - picks0}, surfels at the end "
                  f"{pipe.surfel_count()}, snapshots "
                  f"{len(win.snapshot_s)}, rows shipped "
                  f"{pipe.snapshot_rows_shipped - rows0}, overflow "
                  f"{int(pipe.state.overflow_count)}, skipped tiles "
                  f"{int(pipe.state.skipped_tile_count)}")
        picks = pipe.bucket_pick_log[picks0:]
        self.note(f"window bucket picks (frames, n_eff): first "
                  f"{picks[:3]}, last {picks[-3:]}, distinct n_eff "
                  f"{sorted({p[1] for p in picks})}")

        e2e = {"setup_s": setup_s, "fps": stats.rate(n, win.seconds),
               "peak_mib": peak / 2 ** 20}
        if cuda and win.events:
            done_at = [t_window + e0.elapsed_time(ev) / 1000.0
                       for ev in win.events]
            e2e["frame_ms_p95"] = stats.p95(
                1000.0 * (d - s) for d, s in zip(done_at, win.call_start))
        self.note("end-to-end readings: " + ", ".join(
            f"{k} {v!r}" for k, v in e2e.items()))
        trace = None
        if self.trace:
            trace = self.traced_stretch()
        checks = self.check()
        if self.mesher is not None:
            self.mesher.finish()
        return {"e2e": e2e, "window": win, "trace": trace,
                "checks": checks, "attempted": n, "failed": len(failed),
                "peak_bytes": peak}

    def traced_stretch(self) -> dict:
        """A further stretch of the same loop under the profiler (CUDA
        activity only, so the host runs at its own pace), from an idle
        device to an idle device.  Besides the trace's summary: `n_eff`,
        the rows each frame fused in the stretch ran over (the pipeline's
        bucket picks), and `surfels`, the live count at its start and
        end, read outside the profiled stretch."""
        pipe = self.pipe
        pipe.drain()
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        picks0 = len(pipe.bucket_pick_log)
        count0 = pipe.surfel_count()
        prof = devtrace.profiler(cuda)
        prof.start()
        t_mark = devtrace.mark(self.device)
        t0 = time.perf_counter()
        win = self.loop.run(Window(), seconds=self.traffic["trace_seconds"])
        if cuda:
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        prof.stop()
        summary = devtrace.read(prof, win.spans, t_mark, t0, t1)
        summary["frames"] = len(win.fused)
        summary["n_eff"] = per_frame_n_eff(pipe.bucket_pick_log[picks0:])
        summary["surfels"] = (count0, pipe.surfel_count())
        return summary

    # -- correctness -----------------------------------------------------

    def check(self) -> dict:
        """Every number compared, as {name: (value, limit)}."""
        tr = self.traffic
        settings = program_settings(self.config)
        camera = self.config["camera"]
        ref = rstep.ReferenceFusion(settings, camera, self.frames,
                                    self.device)
        cap = rstep.capacity(settings)
        deferring = settings["adaptive_creation_bound"] > 0
        # The least room for creations the policy leaves above the live
        # count: with the adaptive bound its 2048 floor, else a whole
        # frame's creations (pipeline._count_bound).
        floor = min(2048, settings["max_creations_per_frame"]) \
            if deferring else settings["max_creations_per_frame"]
        short, headroom = [], []

        def n_for(state, n_eff):
            """Rows the reference steps a frame over: the program's bucket
            where the policy may defer creations and the bucket holds the
            live rows plus the floor; else its own."""
            count = int(state.surfel_count)
            headroom.append(n_eff - count)
            if n_eff < min(cap, count + floor):
                short.append(n_eff - count)
            elif deferring and n_eff < cap:
                return n_eff
            return ref.needed_rows(state)

        checks = {}
        # The start: the first frames from an empty map.
        st = rstep.empty_map(settings, self.device)
        if self.control:
            ctl = rstep.ReferenceFusion(settings, camera, self.frames,
                                        self.device, low_precision=True)
            got = rstep.empty_map(settings, self.device)
        for i, n_eff in zip(self.start_frames,
                            per_frame_n_eff(self.start_picks)):
            n_ref = n_for(st, n_eff)
            st = ref.step(st, i, n_ref)
            if self.control:
                got = ctl.step(got, i, n_ref)
        start_rows = _host_rows(got, int(got.surfel_count)) \
            if self.control else self.start_rows
        checks["start_state_mismatch"] = (rows_mismatch(start_rows, st), 0)
        del st

        # The end: the map the window left, stepped further.
        pipe = self.pipe
        pipe.drain()
        st = rstep.clone_map(pipe.state)
        picks0 = len(pipe.bucket_pick_log)
        if self.control:
            got = rstep.clone_map(pipe.state)
            frames = list(range(self.loop.next_index,
                                self.loop.next_index + tr["check_frames"]))
            self.loop.next_index += tr["check_frames"]
            n_effs = [cap] * len(frames)     # the reference's own rows
        else:
            win = self.loop.run(Window(), frames=tr["check_frames"],
                                snapshots=False)
            frames = win.fused
            n_effs = per_frame_n_eff(pipe.bucket_pick_log[picks0:])
        for i, n_eff in zip(frames, n_effs):
            n_ref = n_for(st, n_eff)
            st = ref.step(st, i, n_ref)
            if self.control:
                got = ctl.step(got, i, n_ref)
        if not self.control:
            got = pipe.state
        checks["end_state_mismatch"] = (map_mismatch(got, st), 0)
        checks["bucket_short_frames"] = (len(short), 0)
        self.note(f"checked frames' bucket rows above the reference's live "
                  f"count: least {min(headroom)}, floor {floor}, short "
                  f"{short}")

        if self.mesher is not None:
            last = frames[-1]
            if self.control:
                d = rfu.meshing_snapshot_delta(
                    got, self.loop.last_snapshot,
                    settings["regularization_frame_window_size"])
                snap = ("delta",) + tuple(a.cpu().numpy() for a in d[:5]) + \
                    (int(d[6]),)
                self.loop.shipped.append(snap)
                self.mesher.submit_snapshot(snap, last)
            else:
                self.loop.snapshot(last)
            self.mesher.drain()
            want = rstep.snapshot_rows(st)
            checks["snapshot_row_mismatch"] = (
                view_mismatch(mesher_view(self.loop.shipped), want), 0)
            checks["triangle_invalid"] = (triangle_invalid(
                self.mesher.engine.get_triangles(), want[1]), 0)
        return checks
