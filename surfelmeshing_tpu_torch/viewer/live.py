"""Live browser viewer: interactive orbit navigation over the streaming
reconstruction.

The reference opens a Qt/OpenGL window with mouse orbit controls and live
cloud/mesh updates (surfel_meshing_render_window.{h,cc}:195-430).  This
machine is headless, so the equivalent capability is served to a browser: a
background HTTP server exposes a self-contained WebGL2 viewer page and a
binary snapshot endpoint the page polls; the app pushes new surfel/mesh
snapshots as reconstruction progresses.

Endpoints:
  /          the viewer page (vanilla WebGL2, no external assets)
  /mesh      latest snapshot: little-endian header
             [version u32, num_vertices u32, num_triangles u32,
              mesh_surfel_count u32]
             + positions f32[num_vertices,3] + colors u8[num_vertices,3]
             (padded to 4-byte alignment) + indices u32[num_triangles,3]
  /version   current snapshot version as text (cheap poll)
  /pose      latest input-camera pose as 12 space-separated floats
             (global_T_camera 3x4, row-major; empty before the first frame)
             — drives the follow-input-camera mode
             (main.cc --follow_input_camera)
  /debug     debug line sets (surfel_meshing_render_window.cc:382-430
             neighbor/normal passes): [num_sets u32] then per set
             [count u32, r u8, g u8, b u8, pad u8]
             + segments f32[count, 2, 3]
"""

from __future__ import annotations

import os
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_HTML_PATH = os.path.join(os.path.dirname(__file__), "live_viewer.html")


class LiveViewerServer:
    def __init__(self, port: int = 8890, host: str = "127.0.0.1"):
        self._lock = threading.Lock()
        self._payload = self._encode(np.zeros((0, 3), np.float32),
                                     np.zeros((0, 3), np.uint8),
                                     np.zeros((0, 3), np.uint32), 0, 0)
        self._version = 0
        self._pose = b""
        self._debug = struct.pack("<I", 0)
        self.selected_surfel = -1      # browser shift-click selection
        self._actions = []             # queued (key, surfel_index) actions

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # silence request logging
                pass

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    with open(_HTML_PATH, "rb") as f:
                        body = f.read()
                    self._reply(200, "text/html", body)
                elif self.path == "/mesh":
                    with viewer._lock:
                        body = viewer._payload
                    self._reply(200, "application/octet-stream", body)
                elif self.path == "/version":
                    with viewer._lock:
                        body = str(viewer._version).encode()
                    self._reply(200, "text/plain", body)
                elif self.path == "/pose":
                    with viewer._lock:
                        body = viewer._pose
                    self._reply(200, "text/plain", body)
                elif self.path == "/debug":
                    with viewer._lock:
                        body = viewer._debug
                    self._reply(200, "application/octet-stream", body)
                elif self.path.startswith("/select?") or \
                        self.path.startswith("/action?"):
                    # Surfel selection + y/e debug-triangulation actions
                    # (the reference's click-selection + y/e keys,
                    # surfel_meshing_render_window.cc:
                    # selected_surfel_index / main.cc:1609-1627).
                    from urllib.parse import parse_qs, urlparse
                    q = parse_qs(urlparse(self.path).query)
                    try:
                        idx = int(q.get("i", ["-1"])[0])
                    except ValueError:
                        idx = -1
                    with viewer._lock:
                        if self.path.startswith("/select?"):
                            viewer.selected_surfel = idx
                        else:
                            key = q.get("k", [""])[0]
                            if key in ("y", "e") and idx >= 0:
                                viewer._actions.append((key, idx))
                    self._reply(200, "text/plain", b"ok")
                else:
                    self._reply(404, "text/plain", b"not found")

            def _reply(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    @staticmethod
    def _encode(positions, colors, triangles, mesh_surfel_count, version):
        positions = np.ascontiguousarray(positions, np.float32)
        colors = np.ascontiguousarray(colors, np.uint8)
        triangles = np.ascontiguousarray(triangles, np.uint32)
        n = len(positions)
        header = struct.pack("<4I", version, n, len(triangles),
                             mesh_surfel_count)
        col_bytes = colors.tobytes()
        pad = (-len(col_bytes)) % 4
        return b"".join([header, positions.tobytes(),
                         col_bytes, b"\0" * pad, triangles.tobytes()])

    def update(self, positions, colors, triangles,
               mesh_surfel_count: int, pose=None,
               debug_lines=None) -> None:
        """Publish a new snapshot.  NaN vertices (merged surfels) are kept —
        the client skips non-finite splats and WebGL culls NaN triangles —
        so indices stay valid without remapping.

        pose: optional global_T_camera 3x4 (row-major) of the current input
        frame, served on /pose for the follow-input-camera mode.
        debug_lines: optional [(segments (M, 2, 3) f32, (r, g, b)), ...]
        served on /debug (neighbor/normal line passes)."""
        with self._lock:
            self._version += 1
            self._payload = self._encode(positions, colors, triangles,
                                         mesh_surfel_count, self._version)
            if pose is not None:
                vals = np.asarray(pose, np.float64).reshape(-1)[:12]
                self._pose = " ".join(f"{v:.9g}" for v in vals).encode()
            if debug_lines is not None:
                parts = [struct.pack("<I", len(debug_lines))]
                for segs, (r, g, b) in debug_lines:
                    segs = np.ascontiguousarray(segs, np.float32)
                    parts.append(struct.pack("<I4B", len(segs), r, g, b, 0))
                    parts.append(segs.tobytes())
                self._debug = b"".join(parts)

    def update_debug_lines(self, debug_lines) -> None:
        """Publish debug line sets only (per-surfel debug triangulation
        neighborhood rendering, main.cc:1609-1627 analog)."""
        with self._lock:
            parts = [struct.pack("<I", len(debug_lines))]
            for segs, (r, g, b) in debug_lines:
                segs = np.ascontiguousarray(segs, np.float32)
                parts.append(struct.pack("<I4B", len(segs), r, g, b, 0))
                parts.append(segs.tobytes())
            self._debug = b"".join(parts)
            # Nudge clients to re-poll (the mesh payload header carries the
            # version, so patch it in place to keep the two consistent).
            self._version += 1
            self._payload = struct.pack("<I", self._version) + \
                self._payload[4:]

    def poll_actions(self):
        """Drain queued (key, surfel_index) actions from the browser
        (y/e debug-triangulation requests)."""
        with self._lock:
            actions, self._actions = self._actions, []
        return actions

    def close(self) -> None:
        """Stop serving and release the port (the JAX package's server
        keeps its socket open until it is collected)."""
        self._server.shutdown()
        self._thread.join(timeout=10)
        self._server.server_close()
