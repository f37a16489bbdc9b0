"""The port's renderer (surfelmeshing_tpu_torch/viewer/renderer.py) against
the JAX package's numpy renderer on the same seeded numpy inputs, on the
CPU at 160x120: every image must be equal, pixel for pixel.  The scenes
exercise each pass (the three mesh size classes and the dropped triangle
of extent >= 192, splats, frustum, lines and line sets), NaN inputs, the
z-order across passes, numpy's last-write-wins at a pixel, the colour
modes and triangle chunking.  The GPU-vs-CPU case is marked `cuda`."""

import numpy as np
import pytest
import torch

from surfelmeshing_tpu.utils.camera import PinholeCamera as JaxCamera
from surfelmeshing_tpu.utils.se3 import SE3 as JaxSE3
from surfelmeshing_tpu.viewer import renderer as JR
from surfelmeshing_tpu_torch.utils.camera import PinholeCamera
from surfelmeshing_tpu_torch.utils.se3 import SE3
from surfelmeshing_tpu_torch.viewer import renderer as TR

torch.set_num_threads(1)

W, H = 160, 120
MODES = ("color", "timestamp", "creation", "radius", "normals")


def _triangles(rng, n, size, z=(2.0, 4.0)):
    """n random triangles of about `size` metres around random centres in
    front of the identity camera; -> (vertices (3n, 3) f32, triangles)."""
    centres = np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(-0.7, 0.7, n),
                        rng.uniform(*z, n)], 1)
    offsets = rng.uniform(-size, size, (n, 3, 3))
    offsets[:, :, 2] *= 0.3
    vertices = (centres[:, None, :] + offsets).reshape(-1, 3)
    return vertices.astype(np.float32), np.arange(3 * n).reshape(n, 3)


def scene(seed: int = 0) -> dict:
    """A seeded scene with triangles of every size class (pixel-scale,
    12-48, 48-192 pixels and one of extent >= 192, which no pass draws),
    NaN vertices, vertex colours, splats with NaN points and surfel
    attributes for the colour modes."""
    rng = np.random.default_rng(seed)
    parts = [_triangles(rng, 300, 0.02), _triangles(rng, 30, 0.15),
             _triangles(rng, 6, 0.6),
             (np.array([[-6, -4, 2.5], [6, -4, 2.6], [0, 5, 2.4]],
                       np.float32), np.arange(3).reshape(1, 3))]
    vertices, triangles, offset = [], [], 0
    for v, t in parts:
        vertices.append(v)
        triangles.append(t + offset)
        offset += len(v)
    vertices = np.concatenate(vertices)
    vertices[rng.choice(len(vertices), 20, replace=False)] = np.nan
    triangles = np.concatenate(triangles).astype(np.uint32)
    n = len(vertices)
    splats = rng.uniform(-1.2, 1.2, (400, 3)).astype(np.float32)
    splats[:, 2] = rng.uniform(1.5, 4.5, 400)
    splats[rng.choice(400, 10, replace=False), 1] = np.nan
    normals = rng.standard_normal((n, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    segments = rng.uniform(-1.0, 1.0, (30, 2, 3))
    segments[:, :, 2] = rng.uniform(1.0, 5.0, (30, 2))
    return dict(
        vertices=vertices, triangles=triangles,
        colors=rng.integers(0, 256, (n, 3)).astype(np.uint8),
        splats=splats,
        splat_colors=rng.integers(0, 256, (400, 3)).astype(np.uint8),
        stamps=rng.integers(0, 40, n).astype(np.int32),
        creation=rng.integers(0, 40, n).astype(np.int32),
        radii_sq=rng.uniform(-1e-5, 2e-4, n).astype(np.float32),
        normals=normals,
        segments=segments.astype(np.float32))


def _port_args(kwargs: dict) -> dict:
    """The JAX renderer's keyword arguments with every array a CPU tensor
    and every pose or camera the port's own."""
    out = {}
    for k, v in kwargs.items():
        if isinstance(v, np.ndarray):
            out[k] = torch.from_numpy(v)
        elif k == "line_sets":
            out[k] = [(torch.from_numpy(s), c) for s, c in v]
        elif isinstance(v, JaxSE3):
            out[k] = SE3.from_matrix(v.matrix())
        elif isinstance(v, JaxCamera):
            out[k] = PinholeCamera(v.width, v.height, v.fx, v.fy, v.cx, v.cy)
        else:
            out[k] = v
    return out


def assert_same_image(pose, **kwargs):
    """Render with both renderers on the same inputs; -> the image."""
    want = JR.Renderer(W, H).render(pose, **kwargs)
    port = TR.Renderer(W, H, device="cpu")
    got = port.render(SE3.from_matrix(pose.matrix()), **_port_args(kwargs))
    assert got.dtype == torch.uint8 and got.shape == (H, W, 3)
    diff = (got.numpy() != want).any(axis=2)
    assert not diff.any(), f"{int(diff.sum())} pixels differ"
    return want


def _background(img) -> int:
    return int((img == 255).all(axis=2).sum())


VIEW = JaxSE3.from_matrix(np.array([[1, 0, 0, 0.05], [0, 1, 0, -0.02],
                                    [0, 0, 1, -0.1], [0, 0, 0, 1.0]]))
TILTED = JaxSE3(q=[0.05, -0.08, 0.02, 0.995], t=[0.1, 0.05, -0.3])


@pytest.mark.parametrize("pose", [VIEW, TILTED], ids=["view", "tilted"])
@pytest.mark.parametrize("shading", [False, True],
                         ids=["vertex_colors", "normal_shading"])
def test_mesh_matches_jax(pose, shading):
    s = scene(1)
    img = assert_same_image(pose, mesh_vertices=s["vertices"],
                            mesh_colors=s["colors"],
                            mesh_triangles=s["triangles"],
                            triangle_normal_shading=shading)
    assert _background(img) < W * H - 1000


@pytest.mark.parametrize("size,patch", [(0.02, 12), (0.15, 48), (0.6, 192)])
def test_each_size_class_matches_jax(size, patch):
    """One class at a time, with the same vertex set: its pass draws
    them; the triangle of extent >= 192 is never drawn."""
    rng = np.random.default_rng(patch)
    vertices, triangles = _triangles(rng, 40 if patch < 192 else 4, size)
    big = np.array([[-6, -4, 2.5], [6, -4, 2.6], [0, 5, 2.4]], np.float32)
    vertices = np.concatenate([vertices, big])
    colors = rng.integers(0, 256, (len(vertices), 3)).astype(np.uint8)
    tri = triangles.astype(np.uint32)
    img = assert_same_image(VIEW, mesh_vertices=vertices, mesh_colors=colors,
                            mesh_triangles=tri)
    assert _background(img) < W * H
    alone = assert_same_image(
        VIEW, mesh_vertices=vertices, mesh_colors=colors,
        mesh_triangles=np.array([[len(vertices) - 3, len(vertices) - 2,
                                  len(vertices) - 1]], np.uint32))
    assert _background(alone) == W * H


def test_z_order_across_passes_matches_jax():
    """Mesh of every class, splats in front of and behind it, the frustum
    and lines, some occluded (lines test the z-buffer with +1e-4)."""
    s = scene(2)
    cam = JaxCamera(640, 480, 525.0, 525.0, 319.5, 239.5)
    assert_same_image(
        VIEW, mesh_vertices=s["vertices"], mesh_colors=s["colors"],
        mesh_triangles=s["triangles"], splat_points=s["splats"],
        splat_colors=s["splat_colors"], splat_half_extent=2.0,
        frustum_pose=JaxSE3(t=[0.0, 0.0, 2.5]), frustum_camera=cam,
        lines=s["segments"][:10],
        line_sets=[(s["segments"][10:20], (0, 255, 0)),
                   (s["segments"][20:], (0, 0, 255))])


@pytest.mark.parametrize("half_extent", [0.4, 1.5, 3.0])
def test_splats_with_nan_points_match_jax(half_extent):
    s = scene(3)
    img = assert_same_image(TILTED, splat_points=s["splats"],
                            splat_colors=s["splat_colors"],
                            splat_half_extent=half_extent)
    assert _background(img) < W * H
    assert_same_image(TILTED, splat_points=s["splats"],
                      splat_half_extent=half_extent)     # default grey


def test_frustum_matches_jax():
    cam = JaxCamera(640, 480, 525.0, 525.0, 320.5, 240.5)
    img = assert_same_image(VIEW, frustum_pose=JaxSE3(t=[0, 0, 0.5]),
                            frustum_camera=cam)
    assert _background(img) < W * H


def test_lines_and_line_sets_match_jax():
    s = scene(4)
    img = assert_same_image(
        TILTED, lines=s["segments"][:15], line_color=(10, 20, 30),
        line_sets=[(s["segments"][15:], (255, 0, 0)),
                   (np.zeros((0, 2, 3), np.float32), (0, 0, 255))])
    assert _background(img) < W * H


@pytest.mark.parametrize("mode", MODES)
def test_surfel_colors_match_jax(mode):
    s = scene(5)
    args = [s["colors"], s["stamps"], s["creation"], s["radii_sq"],
            s["normals"]]
    want = JR.surfel_colors(mode, *args, 37, active_window=20)
    got = TR.surfel_colors(mode, *map(torch.from_numpy, args), 37,
                           active_window=20)
    np.testing.assert_array_equal(got.numpy(), want)
    assert_same_image(VIEW, mesh_vertices=s["vertices"], mesh_colors=want,
                      mesh_triangles=s["triangles"],
                      splat_points=s["vertices"][::7],
                      splat_colors=want[::7])


def test_last_write_wins_like_numpy():
    """Many coincident triangles and splats at one pixel: numpy's fancy
    assignment keeps the last write, among equal-depth triangles the one
    of largest (triangle, pixel) index, among splats the nearest (the
    far-to-near order's last)."""
    rng = np.random.default_rng(6)
    base = np.array([[-0.02, -0.02, 2.0], [0.03, -0.01, 2.0],
                     [0.0, 0.03, 2.0]], np.float32)
    vertices = np.concatenate([base] * 50 + [base - [0, 0, 0.001]] * 10)
    triangles = np.arange(len(vertices)).reshape(-1, 3).astype(np.uint32)
    colors = rng.integers(0, 256, (len(vertices), 3)).astype(np.uint8)
    splats = np.tile([[0.0, 0.0, 1.0]], (64, 1)).astype(np.float32)
    splats[:, 2] += rng.permutation(64) * 1e-3
    splats[:, 0] += rng.uniform(-1e-3, 1e-3, 64)
    splat_colors = rng.integers(0, 256, (64, 3)).astype(np.uint8)
    img = assert_same_image(VIEW, mesh_vertices=vertices, mesh_colors=colors,
                            mesh_triangles=triangles)
    assert _background(img) < W * H
    assert_same_image(VIEW, mesh_vertices=vertices, mesh_colors=colors,
                      mesh_triangles=triangles, splat_points=splats,
                      splat_colors=splat_colors, splat_half_extent=2.0)


@pytest.mark.parametrize("chunk", [1, 200, 1 << 23])
def test_chunked_mesh_equals_unchunked(chunk, monkeypatch):
    """The triangle chunk (candidates a chunk) does not change a pixel: a
    chunk of one triangle gives the unchunked image."""
    monkeypatch.setattr(TR, "CHUNK_CANDIDATES", chunk)
    s = scene(7)
    assert_same_image(VIEW, mesh_vertices=s["vertices"],
                      mesh_colors=s["colors"], mesh_triangles=s["triangles"])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_projection_is_numpys_product(dtype, monkeypatch):
    """numpy's `points @ R.T` is a fused multiply-add chain: the emulated
    chain the renderer runs on every device equals it bit for bit; so does
    the projected depth and column."""
    rng = np.random.default_rng(8)
    points = (rng.standard_normal((20000, 3)) *
              10.0 ** rng.integers(-3, 3, (20000, 1))).astype(dtype)
    rt = TILTED.rotation_matrix.T
    want = points @ rt
    p = torch.from_numpy(points).to(torch.float64)
    rt_t = torch.from_numpy(rt.copy())
    np.testing.assert_array_equal(TR._fma_chain(p, rt_t).numpy(), want)
    port = TR.Renderer(W, H, device="cpu")
    want = want + TILTED.t
    u, _, z = port._project(SE3.from_matrix(TILTED.matrix()),
                            torch.from_numpy(points))
    np.testing.assert_array_equal(z.numpy(), want[:, 2])
    safe = np.where(want[:, 2] > 1e-6, want[:, 2], 1.0)
    np.testing.assert_array_equal(u.numpy(),
                                  port.fx * want[:, 0] / safe + port.cx)


def test_emulated_fma_rounds_once():
    """_fma against exact rational arithmetic, ties and cancellation
    included."""
    from fractions import Fraction
    rng = np.random.default_rng(11)
    n = 4000
    a = rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n)
    b = rng.standard_normal(n)
    c = rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n)
    c[:500] = -(a[:500] * b[:500])                  # cancellation
    big = rng.integers(1, 2 ** 52, 500) * 2.0 ** rng.integers(-8, 8, 500)
    a[500:1000] = np.spacing(big) / 2               # halfway cases
    b[500:1000] = 1.0
    c[500:1000] = big
    got = TR._fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = [float(Fraction(x) * Fraction(y) + Fraction(z))
            for x, y, z in zip(a, b, c)]
    np.testing.assert_array_equal(got, want)


def test_orbit_camera_matches_jax():
    for yaw, pitch in ((0.0, 0.0), (0.3, -0.2), (2.0, 1.2)):
        kw = dict(center=np.array([0.0, 0.2, 2.0]), radius=3.4, yaw=yaw,
                  pitch=pitch)
        np.testing.assert_array_equal(TR.OrbitCamera(**kw).pose().matrix(),
                                      JR.OrbitCamera(**kw).pose().matrix())


def test_renderer_refuses_host_arrays_and_bad_indices():
    s = scene(9)
    port = TR.Renderer(W, H, device="cpu")
    pose = SE3.identity()
    with pytest.raises(TypeError):
        port.render(pose, splat_points=s["splats"])
    with pytest.raises(ValueError):
        port.render(pose, mesh_vertices=torch.from_numpy(s["vertices"][:3]),
                    mesh_triangles=torch.tensor([[0, 1, 3]]))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py [video] runs this)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_gpu_image_equals_cpu_image(cuda_device, mode):
    s = scene(10)
    images = []
    for dev in (cuda_device, torch.device("cpu")):
        t = {k: torch.from_numpy(v).to(dev) for k, v in s.items()}
        cols = TR.surfel_colors(mode, t["colors"], t["stamps"],
                                t["creation"], t["radii_sq"], t["normals"],
                                37, active_window=20)
        images.append(TR.Renderer(1280, 720, device=dev).render(
            SE3.identity(), mesh_vertices=t["vertices"], mesh_colors=cols,
            mesh_triangles=t["triangles"], splat_points=t["splats"],
            splat_colors=t["splat_colors"],
            line_sets=[(t["segments"], (255, 0, 0))]).cpu())
    assert torch.equal(images[0], images[1])
