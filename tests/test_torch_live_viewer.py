"""The port's live browser viewer (surfelmeshing_tpu_torch/viewer/live.py)
against the JAX package's: the cases of tests/test_live_viewer.py on the
port, every endpoint's bytes equal to the JAX server's after the same
updates, the y/e debug-triangulation lines, and --live_viewer through the
port's CLI on the CPU.  Ports are found free at run time (the test files
run side by side)."""

import struct

import numpy as np
import pytest
import torch

from surfelmeshing_tpu.viewer.live import LiveViewerServer as JaxServer
from surfelmeshing_tpu_torch.app.main import debug_triangulate_surfel, main
from surfelmeshing_tpu_torch.meshing import MeshingDriver
from surfelmeshing_tpu_torch.viewer.live import LiveViewerServer
from surfelmeshing_tpu_torch.viewer.probe import (MeshProbe, fetch,
                                                  free_port, port_is_free)

from test_torch_app import DATASET, FLAGS
from test_torch_host import _snapshot

torch.set_num_threads(1)

ENDPOINTS = ("/", "/mesh", "/version", "/pose", "/debug")


def _updates(seed: int):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 9))
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    col = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    tris = rng.integers(0, n, (int(rng.integers(0, 5)), 3)).astype(np.uint32)
    pose = rng.standard_normal((3, 4))
    segs = rng.standard_normal((int(rng.integers(0, 4)), 2, 3))
    return pos, col, tris, pose, segs


def test_close_releases_the_port():
    server = LiveViewerServer(port=0)
    fetch(server.port, "/version")
    assert not port_is_free(server.port)
    server.close()
    assert port_is_free(server.port)


def test_endpoints_and_snapshot_roundtrip():
    server = LiveViewerServer(port=0)
    try:
        html = fetch(server.port, "/")
        assert b"webgl2" in html.lower()
        assert fetch(server.port, "/version") == b"0"
        pos = np.arange(12, dtype=np.float32).reshape(4, 3)
        col = np.arange(12, dtype=np.uint8).reshape(4, 3)
        tris = np.array([[0, 1, 2], [1, 2, 3]], np.uint32)
        pose = np.arange(12, dtype=np.float32).reshape(3, 4)
        segs = np.arange(18, dtype=np.float32).reshape(3, 2, 3)
        server.update(pos, col, tris, mesh_surfel_count=3, pose=pose,
                      debug_lines=[(segs, (255, 0, 0))])
        assert fetch(server.port, "/version") == b"1"
        got_pose = np.array(
            [float(v) for v in fetch(server.port, "/pose").split()])
        np.testing.assert_allclose(got_pose.reshape(3, 4), pose)
        dbg = fetch(server.port, "/debug")
        assert struct.unpack_from("<I", dbg, 0) == (1,)
        assert struct.unpack_from("<I4B", dbg, 4)[:4] == (3, 255, 0, 0)
        np.testing.assert_array_equal(
            np.frombuffer(dbg, np.float32, 18, 12).reshape(3, 2, 3), segs)
        buf = fetch(server.port, "/mesh")
        version, nv, nt, ms = struct.unpack_from("<4I", buf, 0)
        assert (version, nv, nt, ms) == (1, 4, 2, 3)
        off = 16
        np.testing.assert_array_equal(
            np.frombuffer(buf, np.float32, nv * 3, off).reshape(nv, 3), pos)
        off += nv * 12
        np.testing.assert_array_equal(
            np.frombuffer(buf, np.uint8, nv * 3, off).reshape(nv, 3), col)
        off += (nv * 3 + 3) & ~3
        np.testing.assert_array_equal(
            np.frombuffer(buf, np.uint32, nt * 3, off).reshape(nt, 3), tris)
        fetch(server.port, "/action?k=y&i=7")
        fetch(server.port, "/action?k=x&i=8")
        assert server.poll_actions() == [("y", 7)]
        assert server.poll_actions() == []
    finally:
        server.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_served_bytes_match_jax(seed):
    """After the same updates the two servers serve the same bytes on every
    endpoint, and the payload is JAX's LiveViewerServer._encode."""
    servers = [JaxServer(port=0), LiveViewerServer(port=0)]
    try:
        pos, col, tris, pose, segs = _updates(seed)
        for server in servers:
            server.update(pos, col, tris, len(pos) - 1, pose=pose,
                          debug_lines=[(segs, (1, 2, 3)), (segs[:1],
                                                           (4, 5, 6))])
            server.update(pos[:1], col[:1], tris[:0], 1)
            server.update_debug_lines([(segs, (255, 255, 0))])
        jax_bytes, port_bytes = ([fetch(s.port, e) for e in ENDPOINTS]
                                 for s in servers)
        assert port_bytes == jax_bytes
        assert port_bytes[1][4:] == JaxServer._encode(
            pos[:1], col[:1], tris[:0], 1, 3)[4:]
        assert LiveViewerServer._encode(pos, col, tris, 2, 9) == \
            JaxServer._encode(pos, col, tris, 2, 9)
    finally:
        for server in servers:
            server.close()


def test_debug_triangulation_shows_neighborhood():
    """'y N' with a live viewer attached publishes the surfel's
    neighborhood as one yellow line set (main.cc:1609-1627 analog)."""
    mesher = MeshingDriver()
    server = LiveViewerServer(port=0)
    try:
        mesher.submit(*_snapshot(), 600, frame_index=0)
        mesher.drain()
        assert debug_triangulate_surfel(mesher, "y", 10, server)
        dbg = fetch(server.port, "/debug")
        count, r, g, b, _ = struct.unpack_from("<I4B", dbg, 4)
        assert struct.unpack_from("<I", dbg, 0) == (1,)
        assert count > 0 and (r, g, b) == (255, 255, 0)
        assert fetch(server.port, "/version") == b"1"
        assert not debug_triangulate_surfel(mesher, "e", 10 ** 6, server)
    finally:
        server.close()
        mesher.finish()


def test_app_flag_serves_viewer(tmp_path, monkeypatch):
    """--live_viewer through the port's CLI serves a non-empty /mesh during
    the run, and the port is free again once run() returns."""
    monkeypatch.chdir(tmp_path)
    port = free_port()
    with MeshProbe(port) as probe:
        assert main(["--device", "cpu", *FLAGS, "--live_viewer", str(port),
                     *DATASET]) == 0
    assert not probe.alive()
    assert b"canvas" in probe.served.get("html", b"")
    assert int(probe.served["version"]) > 0
    assert probe.vertices() > 0
    assert port_is_free(port)
