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

from surfelmeshing_tpu.config import config_from_args
from surfelmeshing_tpu.io.tum import read_tum_rgbd_dataset
from surfelmeshing_tpu.pipeline import ReconstructionPipeline as JaxPipeline
from surfelmeshing_tpu_torch.app.main import main
from surfelmeshing_tpu_torch.io.checkpoint import load_checkpoint
from surfelmeshing_tpu_torch.ops import fusion as TF
from surfelmeshing_tpu_torch.pipeline import ReconstructionPipeline

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


@pytest.mark.parametrize("flags", [["--create_video"],
                                   ["--live_viewer", "8123"]])
def test_unported_app_options_raise(flags):
    with pytest.raises(NotImplementedError):
        main(["--device", "cpu", *FLAGS, *flags, *DATASET])


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
