"""Asynchronous meshing driver.

Mirrors the reference's AsynchronousMeshing thread
(asynchronous_meshing.{h,cc}): a background thread consumes double-buffered
surfel snapshots (integrate -> check remeshing -> triangulate -> publish
indices), decoupled from the fusion cadence; the pipeline only submits a new
snapshot when the mesher is idle or about to finish (main.cc:1235-1254).

While the tracer (utils/timing.tracer) is on, each iteration records the
span mesher.iteration (thread "mesher", id the batch's last frame) with
children mesher.integrate, mesher.remesh, mesher.triangulate and
mesher.publish; the end of mesher.publish is when the mesh was published.
Each traced iteration also appends the reference's meshing-thread timings
lines (timings_log_lines), made from those spans: the app turns the tracer
on for --log_timings and writes them to timings_cpu.txt.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

import numpy as np

from ..io.mesh_io import write_obj
from ..utils.timing import tracer
from .engine import MeshingEngine


class MeshingDriver:
    def __init__(self, config=None):
        kwargs = {}
        if config is not None:
            kwargs = dict(
                max_angle_between_normals_deg=(
                    config.max_angle_between_normals_deg),
                min_triangle_angle_deg=config.min_triangle_angle_deg,
                max_triangle_angle_deg=config.max_triangle_angle_deg,
                max_neighbor_search_range_increase_factor=(
                    config.max_neighbor_search_range_increase_factor),
                long_edge_tolerance_factor=config.long_edge_tolerance_factor,
                regularization_frame_window_size=(
                    config.regularization_frame_window_size),
                # --max_surfels_per_node: the reference octree's density
                # knob (main.cc:480-484); here it scales the hash-grid
                # auto cell size (meshing_engine.h MeshingConfig).
                max_surfels_per_node=config.max_surfels_per_node,
            )
        self.engine = MeshingEngine(**kwargs)
        self.timings_log_lines = []    # of traced iterations

        # Pending-snapshot queue consumed under the lock (the reference's
        # CUDASurfelsCPU double buffer holds ONE full snapshot and lets a
        # newer one replace it; delta snapshots must never be dropped, so
        # this is a FIFO the consumer drains completely each iteration).
        self._input_lock = threading.Condition()
        self._pending = []             # [(tagged_snapshot, frame_index)]
        self._busy = False
        self._exit = False

        # Published output (latest triangle index buffer).
        self._output_lock = threading.Lock()
        self._output: Optional[Tuple[int, int, np.ndarray]] = None
        self._latest_duration = 0.0
        self._latest_start = time.monotonic()

        self._thread = threading.Thread(target=self._loop, name="mesher",
                                        daemon=True)
        self._thread.start()

    # -- producer side ------------------------------------------------------

    def idle(self) -> bool:
        """True when no meshing iteration is running/queued, or the running
        one is expected to finish soon (main.cc:1235-1246)."""
        with self._input_lock:
            if not self._busy and not self._pending:
                return True
            since = time.monotonic() - self._latest_start
            return since > self._latest_duration - 0.05

    def submit(self, positions, radii_sq, normals, stamps, count,
               frame_index) -> None:
        self.submit_snapshot(("full", positions, radii_sq, normals, stamps,
                              count), frame_index)

    def submit_snapshot(self, tagged, frame_index) -> None:
        """Tagged snapshot from ReconstructionPipeline.snapshot_for_meshing:
        ("full", pos, rad, nrm, stamps, count) or
        ("delta", indices, pos, rad, nrm, stamps, total_count)."""
        with self._input_lock:
            self._pending.append((tagged, frame_index))
            self._input_lock.notify_all()

    def get_output(self):
        """-> (frame_index, surfel_count, (M,3) u32 indices) or None."""
        with self._output_lock:
            out = self._output
            self._output = None
            return out

    def peek_output(self):
        with self._output_lock:
            return self._output

    # -- consumer thread ----------------------------------------------------

    def _loop(self):
        while True:
            with self._input_lock:
                while not self._pending and not self._exit:
                    self._input_lock.wait()
                if self._exit:
                    return
                batch = self._pending
                self._pending = []
                self._busy = True
                self._latest_start = time.monotonic()

            frame_index = batch[-1][1]
            traced = tracer.on
            if traced:
                tracer.begin("mesher.iteration", frame_index)
                tracer.begin("mesher.integrate", frame_index)
            self._integrate(batch)
            count = int(self.engine.surfel_count)
            if traced:
                integrate_s = tracer.end()
                tracer.begin("mesher.remesh", frame_index)
            self.engine.check_remeshing()
            if traced:
                remesh_s = tracer.end()
                tracer.begin("mesher.triangulate", frame_index)
            self.engine.triangulate()
            if traced:
                triangulate_s = tracer.end()
                tracer.begin("mesher.publish", frame_index)
            tris = self.engine.get_triangles()

            with self._output_lock:
                self._output = (frame_index, count, tris)
            if traced:
                tracer.end()
                tracer.end()
            with self._input_lock:
                self._busy = False
                self._latest_duration = time.monotonic() - self._latest_start

            if traced:
                # Reference meshing-thread log format
                # (asynchronous_meshing.cc:127-134).
                self.timings_log_lines += [
                    f"frame {frame_index}",
                    f"-remeshing {1000 * remesh_s:f}",
                    f"-meshing {1000 * triangulate_s:f}",
                    f"-synchronization {1000 * integrate_s:f}",
                    f"-triangle_count {self.engine.triangle_count}",
                    f"-deleted_triangle_count "
                    f"{self.engine.deleted_triangle_count}",
                ]

    def _integrate(self, batch) -> None:
        """Feed the batch's snapshots to the engine, in order."""
        for tagged, frame_index in batch:
            if tagged[0] == "full":
                _, positions, radii_sq, normals, stamps, count = tagged
                count = int(count)
                self.engine.integrate(
                    frame_index, np.asarray(positions)[:count],
                    np.asarray(radii_sq)[:count],
                    np.asarray(normals)[:count],
                    np.asarray(stamps)[:count])
            else:
                (_, indices, positions, radii_sq, normals, stamps,
                 count) = tagged
                count = int(count)
                self.engine.integrate_delta(
                    frame_index, np.asarray(indices),
                    np.asarray(positions), np.asarray(radii_sq),
                    np.asarray(normals), np.asarray(stamps), count)

    # -- shutdown -----------------------------------------------------------

    def drain(self, timeout: float = 600.0) -> None:
        """Block until the queue is empty and the thread is idle."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._input_lock:
                if not self._pending and not self._busy:
                    return
            time.sleep(0.005)

    def finish(self, full_retriangulation: bool = False) -> None:
        self.drain()
        if full_retriangulation:
            self.engine.full_retriangulation()
        with self._input_lock:
            self._exit = True
            self._input_lock.notify_all()
        self._thread.join(timeout=60)

    def export_obj(self, path: str, pipe) -> None:
        """Write the final mesh as OBJ (SaveMeshAsOBJ, main.cc:128-176):
        vertices from the fusion state (smoothed positions and colors,
        merged slots remapped away), indices from the mesher."""
        positions, colors = pipe.export_vertices()
        tris = self.engine.get_triangles().astype(np.int64)
        alive = ~np.isnan(positions[:, 0])
        remap = np.cumsum(alive) - 1
        keep = alive[tris].all(axis=1) if len(tris) else np.zeros(0, bool)
        tris_remapped = remap[tris[keep]] if len(tris) else tris
        write_obj(path, positions[alive], tris_remapped, colors[alive])
