"""The port's application and its pipeline at --pyramid_level 2 over the
committed real-format fixture tests/fixtures/tum_micro (see
test_real_fixture.py), on the CPU.

The application runs end to end with the JAX test's flags (160x120
processing, async meshing) and writes mesh, point cloud, checkpoint and
timing logs.  The port's pipeline is held to the JAX pipeline, run eagerly,
on the first frames of the same fixture by test_torch_pipeline.py's
criterion; it holds in its exact form.  (Jitted, XLA fuses multiply-adds
in the bilateral filter and the fusion step, which moves a few neighbor
slots; ROADMAP queue 3.)
"""

import json
import logging
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from surfelmeshing_tpu.config import config_from_args
from surfelmeshing_tpu.io.tum import read_tum_rgbd_dataset
from surfelmeshing_tpu.pipeline import ReconstructionPipeline as JaxPipeline
from surfelmeshing_tpu_torch.app.main import (VideoWriter, _dump_input_images,
                                              main)
from surfelmeshing_tpu_torch.io import tum as TT
from surfelmeshing_tpu_torch.io.checkpoint import load_checkpoint
from surfelmeshing_tpu_torch.ops import fusion as TF
from surfelmeshing_tpu_torch.pipeline import ReconstructionPipeline
from surfelmeshing_tpu_torch.utils.se3 import SE3
from surfelmeshing_tpu_torch.utils.spline import (read_keyframes,
                                                  write_keyframes)

from test_torch_pipeline import assert_pipelines_match

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tum_micro")
FLAGS = ["--max_surfel_count", "120000",
         "--pyramid_level", "2",           # 160x120 processing on the CPU
         "--outlier_filtering_frame_count", "2",
         "--depth_erosion_radius", "1",
         "--restrict_fps_to", "0",
         "--exit_after_processing"]
DATASET = [FIXTURE, "groundtruth.txt"]
FRAMES = 5              # frames played in the pipeline comparison


def test_app_runs_on_real_fixture(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc = main(["--device", "cpu", *FLAGS,
               "--export_mesh", "mesh.obj",
               "--export_point_cloud", "cloud.ply",
               "--save_checkpoint", "ckpt.npz",
               "--log_timings", "timings.txt", *DATASET])
    assert rc == 0
    obj = (tmp_path / "mesh.obj").read_text()
    assert obj.count("\nf ") > 50
    ply = (tmp_path / "cloud.ply").read_bytes()
    points = int(ply.split(b"element vertex ")[1].split(b"\n")[0])
    state, frame = load_checkpoint(str(tmp_path / "ckpt.npz"), "cpu")
    count = int(state.surfel_count)
    assert frame == 8
    assert points == int((state.pack[:count, TF.RAD] >= 0).sum()) > 1000
    lines = (tmp_path / "timings.txt").read_text().splitlines()
    assert [line.split()[1] for line in lines] == \
        [str(i) for i in range(1, 9)]
    assert lines[-1].endswith(f"surfel_count {count}")
    assert (tmp_path / "timings_cpu.txt").exists()


def test_app_resumes_from_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    first = ["--device", "cpu", *FLAGS, "--end_frame", "6"]
    assert main([*first, "--save_checkpoint", "a.npz", *DATASET]) == 0
    assert main(["--device", "cpu", *FLAGS, "--load_checkpoint", "a.npz",
                 "--save_checkpoint", "b.npz", *DATASET]) == 0
    a, frame_a = load_checkpoint("a.npz", "cpu")
    b, frame_b = load_checkpoint("b.npz", "cpu")
    assert (frame_a, frame_b) == (4, 8)
    assert int(b.surfel_count) > int(a.surfel_count)


def test_app_auto_active_budget(tmp_path, monkeypatch, caplog):
    """--active_surfel_budget -1 logs the skipped-tile count
    (tests/test_app.py:277-287); with no tile skipped the point cloud is
    the untiled run's, byte for byte."""
    monkeypatch.chdir(tmp_path)
    for name, extra in (("full.ply", []),
                        ("tiled.ply", ["--active_surfel_budget", "-1"])):
        with caplog.at_level(logging.INFO, logger="surfelmeshing_tpu_torch"):
            assert main(["--device", "cpu", *FLAGS, *extra,
                         "--export_point_cloud", name, *DATASET]) == 0
    assert "active-set tiling: 0 tiles skipped over the run" in caplog.text
    assert (tmp_path / "tiled.ply").read_bytes() == \
        (tmp_path / "full.ply").read_bytes()


VIDEO = ["--create_video", "--render_window_default_width", "160",
         "--render_window_default_height", "120", "--end_frame", "6"]


def _frames(path):
    return sorted(path.glob("frame*.png"))


def _image(path):
    return np.asarray(Image.open(path))


def test_app_writes_video_and_input_images(tmp_path, monkeypatch):
    """--create_video with the debug line passes writes one frame a fused
    frame and, by default, each played frame's input color and depth
    (tests/test_app.py's two video cases, on the port at 160x120)."""
    monkeypatch.chdir(tmp_path)
    assert main(["--device", "cpu", *FLAGS, *VIDEO,
                 "--debug_neighbor_rendering", "--debug_normal_rendering",
                 *DATASET]) == 0
    frames = _frames(tmp_path)
    assert [f.name for f in frames] == [f"frame{i:06d}.png"
                                        for i in range(4)]
    assert all(_image(f).shape == (120, 160, 3) for f in frames)
    assert (_image(frames[-1]) != 255).any(axis=2).sum() > 1000
    names = sorted(p.name for p in (tmp_path / "input_images").iterdir())
    assert names == sorted(f"frame{i:06d}_{kind}.png" for i in range(5)
                           for kind in ("color", "depth"))


def test_hide_input_images(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert main(["--device", "cpu", *FLAGS, *VIDEO, "--hide_input_images",
                 *DATASET]) == 0
    assert len(_frames(tmp_path)) == 4
    assert not (tmp_path / "input_images").exists()


def test_playback_keyframes_drive_the_view(tmp_path, monkeypatch):
    """--playback_keyframes moves the video's camera along the keyframe
    spline: with keyframes that back away from the recorded input poses
    the frames differ from the follow-camera video's, and the last frame
    shows the scene from the last keyframe (smaller on screen)."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "follow").mkdir()
    monkeypatch.chdir(tmp_path / "follow")
    assert main(["--device", "cpu", *FLAGS, *VIDEO, "--hide_input_images",
                 "--record_keyframes", "../recorded.txt", *DATASET]) == 0
    recorded = read_keyframes(str(tmp_path / "recorded.txt"))
    assert len(recorded) == 4
    back = SE3(t=[0.0, 0.0, -1.5])
    write_keyframes(str(tmp_path / "backed.txt"),
                    [(i, pose * back) for i, pose in recorded])
    (tmp_path / "playback").mkdir()
    monkeypatch.chdir(tmp_path / "playback")
    assert main(["--device", "cpu", *FLAGS, *VIDEO, "--hide_input_images",
                 "--playback_keyframes", "../backed.txt", *DATASET]) == 0
    follow = [_image(f) for f in _frames(tmp_path / "follow")]
    played = [_image(f) for f in _frames(tmp_path / "playback")]
    assert len(played) == len(follow) == 4
    for a, b in zip(follow, played):
        assert (a != b).any()

    def drawn(img):
        return int((img != 255).any(axis=2).sum())
    assert drawn(played[-1]) < drawn(follow[-1])


def _jax_state(state: TF.SurfelState):
    from surfelmeshing_tpu.ops.fusion import SurfelState as JaxState
    host = TF.state_to_numpy(state)
    return JaxState(**{k: jax.numpy.asarray(host[k])
                       for k in JaxState._fields})


class _Stub:
    """The few attributes of a pipeline and a mesher that the video
    writers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def surfel_count(self):
        return self.count

    def peek_output(self):
        return self.output


@pytest.fixture(scope="module")
def fused_state():
    """The port's CPU state after four frames of the fixture at 160x120,
    and the native mesher's triangles of it (a fixed triangle set)."""
    from surfelmeshing_tpu_torch.meshing.engine import MeshingEngine
    cfg = config_from_args([*FLAGS, *DATASET])
    video = TT.read_tum_rgbd_dataset(FIXTURE, "groundtruth.txt",
                                     cfg.max_pose_interpolation_time_extent)
    pipe = ReconstructionPipeline(cfg, video.depth_camera, "cpu")
    for i in range(5):
        pipe.process_frame(video, i)
    count = pipe.surfel_count()
    mesh_surfels = count - 300           # the newest surfels are splats
    engine = MeshingEngine()
    engine.integrate(0, *(t[:mesh_surfels].numpy() for t in (
        TF.smooth_positions(pipe.state), TF.radii_sq(pipe.state),
        TF.normals(pipe.state), TF.update_stamps(pipe.state))))
    engine.check_remeshing()
    engine.triangulate()
    tris = engine.get_triangles()
    assert len(tris) > 1000
    return video, pipe, (4, mesh_surfels, tris)


@pytest.mark.parametrize("flags", [
    [], ["--visualize_last_update_timestamp"],
    ["--visualize_creation_timestamp"], ["--visualize_radii"],
    ["--visualize_surfel_normals"],
    ["--triangle_normal_shading", "--debug_neighbor_rendering",
     "--debug_normal_rendering", "--splat_half_extent_in_pixels", "1"]],
    ids=["color", "timestamp", "creation", "radii", "normals",
         "shading_and_debug_lines"])
def test_video_writer_matches_jax(tmp_path, monkeypatch, fused_state, flags):
    """The port's VideoWriter and the JAX package's on the same state (the
    port's, converted) and the same triangles: equal frames in every
    --visualize_* mode, and with normal shading and debug lines."""
    from surfelmeshing_tpu.app.main import VideoWriter as JaxVideoWriter
    from surfelmeshing_tpu.utils.se3 import SE3 as JaxSE3
    video, pipe, output = fused_state
    cfg = config_from_args([*FLAGS, *VIDEO, *flags, *DATASET])
    pose = video.depth_frames[4].global_T_frame
    view = pose * SE3(t=[0.05, -0.1, -0.4])
    mesher = _Stub(output=output)
    for name, make, stub, to_pose in (
            ("jax", lambda: JaxVideoWriter(cfg, video.depth_camera),
             _Stub(state=_jax_state(pipe.state), count=pipe.surfel_count(),
                   camera=pipe.camera),
             lambda p: JaxSE3.from_matrix(p.matrix())),
            ("port", lambda: VideoWriter(cfg, "cpu"),
             pipe, lambda p: p)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        make().render_frame(stub, mesher, to_pose(view), to_pose(pose), 4)
    want = _image(tmp_path / "jax" / "frame000000.png")
    got = _image(tmp_path / "port" / "frame000000.png")
    assert (want != 255).any(axis=2).sum() > 1000
    np.testing.assert_array_equal(got, want)


def test_input_images_match_jax(tmp_path, monkeypatch):
    from surfelmeshing_tpu.app.main import _dump_input_images as jax_dump
    cfg = config_from_args([*FLAGS, *DATASET])
    for name, dump, read in (("jax", jax_dump, read_tum_rgbd_dataset),
                             ("port", _dump_input_images,
                              TT.read_tum_rgbd_dataset)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        dump(cfg, read(FIXTURE, "groundtruth.txt",
                       cfg.max_pose_interpolation_time_extent), 3)
    for kind in ("color", "depth"):
        path = f"input_images/frame000003_{kind}.png"
        assert (tmp_path / "port" / path).read_bytes() == \
            (tmp_path / "jax" / path).read_bytes()


def test_profile_dir_writes_a_trace(tmp_path, monkeypatch):
    """--profile_dir: a torch.profiler Chrome trace of the frame loop, with
    the fusion step's operators in it."""
    monkeypatch.chdir(tmp_path)
    assert main(["--device", "cpu", *FLAGS, "--end_frame", "4",
                 "--profile_dir", "trace", *DATASET]) == 0
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::scatter_reduce_" in names


def test_app_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        main([*FLAGS, *DATASET])               # --device defaults to cuda


def test_pipeline_at_pyramid_level_2_matches_jax(record_property):
    cfg = config_from_args([*FLAGS, *DATASET])
    pipes = []
    for make in (lambda cam: JaxPipeline(cfg, cam),
                 lambda cam: ReconstructionPipeline(cfg, cam, "cpu")):
        video = read_tum_rgbd_dataset(FIXTURE, "groundtruth.txt",
                                      cfg.max_pose_interpolation_time_extent)
        pipe = make(video.depth_camera)
        with jax.disable_jit():           # eager: see ROADMAP queue 3
            fused = [i for i in range(FRAMES)
                     if pipe.process_frame(video, i) is not None]
        assert fused == list(range(1, FRAMES))
        pipes.append(pipe)
    assert (pipes[1].camera.width, pipes[1].camera.height) == (160, 120)
    record_property("pipeline_parity", assert_pipelines_match(*pipes))
    np.testing.assert_array_equal(
        pipes[1].state.pack.view(torch.int32)[:, TF.CREATION].numpy(),
        np.asarray(pipes[0].state.pack).view(np.int32)[:, TF.CREATION])
