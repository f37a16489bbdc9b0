"""The port's copy of the host layer against the JAX package's original, on
the same numpy inputs (CPU, small): config parsing, the synthetic video,
the mesh writers, the TUM reader, SE3 / pose / spline interpolation, the
native mesher, the mesh-accuracy metric and the live viewer's page and
snapshot encoding.  The copies started equal;
these tests keep them answering alike while they live apart.  Everything
discrete or written to bytes must match exactly; the metrics (numpy on
both sides, same order of operations) match exactly too."""

import dataclasses
import os

import numpy as np
import pytest

from surfelmeshing_tpu import config as JC
from surfelmeshing_tpu.eval import mesh_accuracy as JMA
from surfelmeshing_tpu.io import mesh_io as JIO
from surfelmeshing_tpu.io import synthetic as JS
from surfelmeshing_tpu.io import tum as JT
from surfelmeshing_tpu.meshing.engine import MeshingEngine as JaxEngine
from surfelmeshing_tpu.utils import se3 as JSE3
from surfelmeshing_tpu.utils import spline as JSP
from surfelmeshing_tpu.viewer import live as JLV
from surfelmeshing_tpu_torch import config as TC
from surfelmeshing_tpu_torch.eval import mesh_accuracy as TMA
from surfelmeshing_tpu_torch.io import mesh_io as TIO
from surfelmeshing_tpu_torch.io import synthetic as TS
from surfelmeshing_tpu_torch.io import tum as TT
from surfelmeshing_tpu_torch.meshing.engine import MeshingEngine as PortEngine
from surfelmeshing_tpu_torch.utils import se3 as TSE3
from surfelmeshing_tpu_torch.utils import spline as TSP
from surfelmeshing_tpu_torch.viewer import live as TLV

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tum_micro")
DATASET = [FIXTURE, "groundtruth.txt"]


@pytest.mark.parametrize("flags", [
    [],
    ["--max_surfel_count", "120000", "--pyramid_level", "2",
     "--outlier_filtering_frame_count", "2", "--depth_erosion_radius", "1",
     "--restrict_fps_to", "0", "--exit_after_processing"],
    ["--active_surfel_budget", "-1", "--log_timings", "t.txt",
     "--log_timings_staged", "--measurement_blending_radius", "6",
     "--export_mesh", "m.obj", "--export_point_cloud", "c.ply"],
], ids=["defaults", "app_test_flags", "tiling_and_exports"])
def test_config_from_args_matches_jax(flags):
    jax_cfg = JC.config_from_args([*flags, *DATASET])
    port_cfg = TC.config_from_args([*flags, *DATASET])
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
    assert dataclasses.asdict(TC.SurfelMeshingConfig()) == \
        dataclasses.asdict(JC.SurfelMeshingConfig())


@pytest.mark.parametrize("scene,trajectory", [
    ("default", "arc"), ("occlusion", "lookaway"), ("thin", "push"),
    ("corner", "arc")])
def test_synthetic_video_matches_jax(scene, trajectory):
    """Every depth and color frame, pose and camera of a 32x24 video,
    bit for bit, and the scene's surface distance."""
    kwargs = dict(num_frames=4, width=32, height=24, noise_sigma=0.002,
                  scene=scene, trajectory=trajectory)
    (jv, jseq), (tv, tseq) = (JS.synthetic_rgbd_video(**kwargs),
                              TS.synthetic_rgbd_video(**kwargs))
    assert tv.depth_camera == jv.depth_camera
    assert tv.frame_count == jv.frame_count == 4
    for frames in ("depth_frames", "color_frames"):
        for t, j in zip(getattr(tv, frames), getattr(jv, frames)):
            assert t.get_image().dtype == j.get_image().dtype
            np.testing.assert_array_equal(t.get_image(), j.get_image())
            assert t.timestamp == j.timestamp
            np.testing.assert_array_equal(t.global_T_frame.matrix(),
                                          j.global_T_frame.matrix())
    pts = np.random.default_rng(0).uniform(-1, 1, (64, 3)).astype(np.float32)
    np.testing.assert_array_equal(tseq.surface_distance(pts),
                                  jseq.surface_distance(pts))


def _mesh(seed: int):
    rng = np.random.default_rng(seed)
    vertices = rng.standard_normal((40, 3)).astype(np.float32)
    triangles = rng.integers(0, 40, (30, 3))
    colors = rng.integers(0, 256, (40, 3)).astype(np.uint8)
    normals = rng.standard_normal((40, 3)).astype(np.float32)
    return vertices, triangles, colors, normals


@pytest.mark.parametrize("writer,uses", [
    ("write_ply", ("colors", "normals")), ("write_ply", ()),
    ("write_obj", ("triangles", "colors")), ("write_obj", ("triangles",))])
def test_mesh_writers_match_jax(tmp_path, writer, uses):
    vertices, triangles, colors, normals = _mesh(1)
    kwargs = {k: v for k, v in (("triangles", triangles),
                                ("colors", colors), ("normals", normals))
              if k in uses}
    getattr(JIO, writer)(str(tmp_path / "jax"), vertices, **kwargs)
    getattr(TIO, writer)(str(tmp_path / "port"), vertices, **kwargs)
    assert (tmp_path / "port").read_bytes() == \
        (tmp_path / "jax").read_bytes()
    if writer == "write_ply":
        for a, b in zip(TIO.read_ply(str(tmp_path / "port")),
                        JIO.read_ply(str(tmp_path / "jax"))):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("extent", [np.inf, 0.05])
def test_tum_dataset_matches_jax(extent):
    """Poses, timestamps, cameras and images of the real-format fixture."""
    jv = JT.read_tum_rgbd_dataset(*DATASET, extent)
    tv = TT.read_tum_rgbd_dataset(*DATASET, extent)
    assert tv.depth_camera == jv.depth_camera
    assert tv.color_camera == jv.color_camera
    assert tv.frame_count == jv.frame_count > 0
    for frames in ("depth_frames", "color_frames"):
        for t, j in zip(getattr(tv, frames), getattr(jv, frames)):
            assert t.timestamp == j.timestamp
            np.testing.assert_array_equal(t.global_T_frame.matrix(),
                                          j.global_T_frame.matrix())
    np.testing.assert_array_equal(tv.depth_frames[0].get_image(),
                                  jv.depth_frames[0].get_image())


def _poses(module, seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [module.SE3(q=rng.standard_normal(4), t=rng.standard_normal(3))
            for _ in range(n)]


def _se3_results(m):
    a, b = _poses(m, 2, 2)
    stamps = np.array([0.0, 0.1, 0.25, 0.4])
    poses = _poses(m, 3, 4)
    interp = [m.interpolate_pose(t, stamps, poses, ext) for t, ext in
              ((0.05, np.inf), (0.3, np.inf), (-1.0, np.inf), (2.0, np.inf),
               (0.3, 0.1), (0.3, 0.2))]
    out = [a.matrix(), a.inverse().matrix(), (a * b).matrix(),
           a.matrix3x4(), m.SE3.from_matrix((a * b).matrix()).matrix(),
           a.scaled_translation(0.5).matrix(),
           m.quat_slerp(a.q, b.q, 0.3), a * np.array([0.1, -0.2, 0.3])]
    return out + [None if p is None else p.matrix() for p in interp]


def _spline_results(m, tmp_path):
    tmp_path.mkdir()
    path = m.KeyframePath(_poses(m, 4, 5))
    samples = [path.sample(s).matrix()
               for s in np.linspace(0.0, path.max_parameter, 9)]
    m.write_keyframes(str(tmp_path / "k.txt"),
                      list(enumerate(_poses(m, 5, 3))))
    text = (tmp_path / "k.txt").read_text()
    read = [(i, p.matrix()) for i, p in
            m.read_keyframes(str(tmp_path / "k.txt"))]
    return samples + [text] + read


@pytest.mark.parametrize("what", ["se3", "spline"])
def test_se3_and_spline_match_jax(tmp_path, what):
    if what == "se3":
        got, want = _se3_results(TSE3), _se3_results(JSE3)
    else:
        got = _spline_results(TSP, tmp_path / "port")
        want = _spline_results(JSP, tmp_path / "jax")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            assert g[0] == w[0]
            g, w = g[1], w[1]
        if isinstance(w, str) or w is None:
            assert g == w
        else:
            np.testing.assert_array_equal(g, w)


def _snapshot(n=600, seed=0):
    """A fixed surfel snapshot: a gently curved sheet of surfels."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 3), np.float32)
    pos[:, :2] = rng.uniform(0, 1, (n, 2))
    pos[:, 2] = 0.05 * np.sin(3.0 * pos[:, 0])
    radius_sq = np.full(n, (2.0 / np.sqrt(n)) ** 2, np.float32)
    normals = np.tile(np.array([0, 0, -1], np.float32), (n, 1))
    return pos, radius_sq, normals, np.zeros(n, np.uint32)


def test_meshing_engine_triangles_match_jax():
    snap = _snapshot()
    tris = []
    for engine in (JaxEngine(), PortEngine()):
        engine.integrate(0, *snap)
        engine.check_remeshing()
        engine.triangulate()
        tris.append(engine.get_triangles())
    assert len(tris[0]) > 100
    np.testing.assert_array_equal(tris[1], tris[0])


def test_mesh_accuracy_matches_jax(tmp_path):
    # A 12x12 grid over a curved sheet, two triangles a cell.
    g = np.linspace(0.0, 1.0, 12)
    x, y = np.meshgrid(g, g)
    vertices = np.stack([x, y, 0.05 * np.sin(3.0 * x)], -1).reshape(-1, 3)
    vertices = vertices.astype(np.float32)
    cell = (np.arange(11)[:, None] * 12 + np.arange(11)[None, :]).ravel()
    triangles = np.concatenate([np.stack([cell, cell + 1, cell + 12], 1),
                                np.stack([cell + 1, cell + 13, cell + 12],
                                         1)])
    rng = np.random.default_rng(2)
    points = (vertices[rng.integers(0, len(vertices), 200)] +
              0.01 * rng.standard_normal((200, 3))).astype(np.float32)
    results = []
    for m, io in ((JMA, JIO), (TMA, TIO)):
        samples = m.sample_mesh_surface(vertices, triangles,
                                        max_samples=5000)
        acc = m.evaluate_accuracy(points, samples, 0.01, 95.0).as_dict()
        dist = m.point_to_mesh_distance(points, vertices, triangles)
        path = str(tmp_path / "mesh.obj")
        io.write_obj(path, vertices, triangles)
        v, t = m.load_obj_vertices_triangles(path)
        results.append((samples, acc, dist, v, t))
    (js, ja, jd, jv, jt), (ts, ta, td, tv, tt) = results
    np.testing.assert_array_equal(ts, js)
    assert ta == ja
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tt, jt)


def test_live_viewer_page_is_the_jax_page():
    with open(TLV._HTML_PATH, "rb") as port, open(JLV._HTML_PATH, "rb") as j:
        assert port.read() == j.read()


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5])
def test_live_viewer_encoding_matches_jax(n):
    """The /mesh payload for n vertices (colour padding to 4 bytes)."""
    rng = np.random.default_rng(n)
    args = (rng.standard_normal((n, 3)), rng.integers(0, 256, (n, 3)),
            rng.integers(0, max(n, 1), (2 * n, 3)), n // 2, 7)
    assert TLV.LiveViewerServer._encode(*args) == \
        JLV.LiveViewerServer._encode(*args)
