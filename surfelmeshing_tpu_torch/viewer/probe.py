"""A client that checks a live viewer server (viewer/live.py) is up: a free
local port to serve on, whether a port is free again after the server
closed, and a thread that fetches /, /version and /mesh until the mesh
payload holds vertices.

    port = free_port()
    with MeshProbe(port) as probe:
        ...                      # run the app with --live_viewer port
    probe.vertices()             # > 0 once the app published a mesh
"""

from __future__ import annotations

import socket
import struct
import threading
import time
import urllib.request


def fetch(port: int, path: str) -> bytes:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.read()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def port_is_free(port: int) -> bool:
    """A new server can listen on `port` (with SO_REUSEADDR, as every
    http.server does, so closed connections in TIME_WAIT do not count)."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("127.0.0.1", port))
            s.listen()
        except OSError:
            return False
    return True


class MeshProbe:
    """Polls the server on `port` every 50 ms from a thread, keeping the
    last bytes of "html" (/), "version" and "mesh", until /mesh holds a
    vertex or the `with` block ends."""

    def __init__(self, port: int):
        self.port = port
        self.served: dict = {}
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._poll)

    def _poll(self) -> None:
        while not self._done.is_set():
            try:
                # /mesh before /version: the server bumps both under one
                # lock, so the version read after a mesh is never older.
                mesh = fetch(self.port, "/mesh")
                self.served.update(html=fetch(self.port, "/"), mesh=mesh,
                                   version=fetch(self.port, "/version"))
                if self.vertices() > 0:
                    return
            except OSError:
                pass
            time.sleep(0.05)

    def header(self) -> tuple:
        """(version, vertices, triangles, mesh surfels) of the last /mesh;
        zeros before the first."""
        return struct.unpack_from("<4I", self.served.get("mesh", bytes(16)))

    def vertices(self) -> int:
        return self.header()[1]

    def alive(self) -> bool:
        return self._thread.is_alive()

    def __enter__(self) -> "MeshProbe":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._done.set()
        self._thread.join(timeout=60)
