"""The port's bench tools (surfelmeshing_tpu_torch/bench.py,
tools/bench_e2e.py, tools/bench_configs.py, tools/bench_configs_common.py)
and the pipeline's driver support they use, on the CPU at 64x48 or the
benches' smoke sizes.

- prefetch_inputs: a prefetched run reads no host input and its state is
  bit-identical to a plain run's (full shape and auto budget);
- snapshot_dispatch_state / restore_dispatch_state: re-running frames
  from a restored snapshot gives the first run's state bit for bit, twice;
- drain leaves no readback pending;
- BenchEnv.step against the JAX tool's BenchEnv.step (imported by path)
  at 64x48 over 3 frames, JAX eager: counters, neighbor slots and every
  pack column bit for bit;
- AutoBudgetPolicy against the JAX tool's over scripted readbacks;
- the three entry points: bench's smoke mode with its CPU audit, one JSON
  line per config from bench_e2e and bench_configs with the JAX tools'
  keys, and each refuses to run without CUDA unless asked for the CPU;
- ops/cuda_build.builds counts compiles, not cache hits.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfelmeshing_tpu.ops import fusion as JF
from surfelmeshing_tpu_torch import bench
from surfelmeshing_tpu_torch.config import SurfelMeshingConfig
from surfelmeshing_tpu_torch.io import synthetic
from surfelmeshing_tpu_torch.ops import cuda_build
from surfelmeshing_tpu_torch.ops import fusion as TF
from surfelmeshing_tpu_torch.pipeline import ReconstructionPipeline
from surfelmeshing_tpu_torch.tools import bench_configs, bench_e2e
from surfelmeshing_tpu_torch.tools import bench_configs_common as common

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
W, H, FRAMES = 64, 48, 10
CONFIG = SurfelMeshingConfig(max_surfel_count=16384,
                             outlier_filtering_frame_count=2,
                             restrict_fps_to=0)
E2E_KEYS = {"config", "capacity", "budget", "e2e_fps", "ms_per_frame",
            "snapshots", "rows_shipped", "triangles", "surfels",
            "compiles_in_timed_region"}
CONFIGS_KEYS = {"config", "capacity", "budget", "trajectory", "fps",
                "ms_per_frame", "surfels", "skipped_tiles"}


def state_bits(state: TF.SurfelState) -> dict:
    return {k: np.asarray(v).view(np.int32) if np.asarray(v).dtype ==
            np.float32 else np.asarray(v)
            for k, v in TF.state_to_numpy(state).items()}


def assert_states_equal(got: TF.SurfelState, want: TF.SurfelState):
    a, b = state_bits(got), state_bits(want)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def pipeline(budget: int):
    video, _ = synthetic.synthetic_rgbd_video(FRAMES, W, H,
                                              noise_sigma=0.002)
    cfg = dataclasses.replace(CONFIG, active_surfel_budget=budget)
    return ReconstructionPipeline(cfg, video.depth_camera, "cpu"), video


def refuse(*args, **kwargs):
    raise AssertionError("a prefetched frame read host input")


@pytest.mark.parametrize("budget", [0, -1])
def test_prefetch_matches_plain_run(budget, monkeypatch):
    plain, video = pipeline(budget)
    for i in range(FRAMES):
        plain.process_frame(video, i)
    staged, video = pipeline(budget)
    staged.prefetch_inputs(video, 0, FRAMES)
    assert sorted(staged._staged_inputs) == list(range(1, FRAMES - 1))
    monkeypatch.setattr(synthetic.ArrayImageFrame, "get_image", refuse)
    monkeypatch.setattr(staged, "_stage_inputs", refuse)
    fused = [i for i in range(FRAMES)
             if staged.process_frame(video, i) is not None]
    assert fused == list(range(1, FRAMES - 1))
    assert set(staged._staged_inputs) <= {FRAMES - 2}   # not yet retired
    assert_states_equal(staged.state, plain.state)
    assert int(staged.state.surfel_count) > 0
    if budget:
        assert int(staged.state.active_tile_count) > 0


def test_restore_replays_bit_for_bit():
    pipe, video = pipeline(-1)
    for i in range(5):
        pipe.process_frame(video, i)
    pipe.snapshot_for_meshing(4)
    snap = pipe.snapshot_dispatch_state()
    policy = pipe.policy
    marks = (policy.confirmed_count, policy.lagged_active_tiles,
             list(policy.growth_window), pipe._last_snap_frame,
             pipe.snapshot_rows_shipped)
    runs = []
    for _ in range(3):
        for i in range(5, 9):
            pipe.process_frame(video, i)
        pipe.snapshot_for_meshing(8)
        pipe.drain()
        runs.append((pipe.state,
                     policy.confirmed_count, pipe.snapshot_rows_shipped))
        pipe.restore_dispatch_state(snap)
        assert (policy.confirmed_count, policy.lagged_active_tiles,
                policy.growth_window, pipe._last_snap_frame,
                pipe.snapshot_rows_shipped) == marks
        assert policy.unconfirmed_frames == 0 and not policy.readbacks
    first = runs[0]
    assert int(first[0].surfel_count) > int(snap[0].surfel_count)
    for state, confirmed, rows in runs[1:]:
        assert_states_equal(state, first[0])
        assert (confirmed, rows) == first[1:]


def test_drain_consumes_every_readback():
    pipe, video = pipeline(-1)
    for i in range(6):
        pipe.process_frame(video, i)
    policy = pipe.policy
    assert policy.readbacks and policy.unconfirmed_frames > 0
    pipe.drain()
    assert not policy.readbacks and policy.unconfirmed_frames == 0
    assert policy.confirmed_count == pipe.surfel_count()


def jax_tool():
    """tools/bench_configs_common.py of the JAX package, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench_configs_common", REPO / "tools" / "bench_configs_common.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_bench_env_step_matches_jax():
    jax_common = jax_tool()

    class JaxEnv(jax_common.BenchEnv):
        W, H, NUM_FRAMES = 64, 48, 11

    class PortEnv(common.BenchEnv):
        W, H, NUM_FRAMES = 64, 48, 11

    jenv, env = JaxEnv(), PortEnv("cpu")
    assert env.pp_kwargs == jenv.pp_kwargs
    params, jparams = env.make_params(), jenv.make_params()
    for name, value in dataclasses.asdict(params).items():
        assert getattr(jparams, name) == value, name
    jstate = JF.create_surfel_state(16384)
    state = TF.create_surfel_state(16384, "cpu")
    for i in range(env.lo, env.lo + 3):
        np.testing.assert_array_equal(env.transforms_for(i).numpy(),
                                      np.asarray(jenv.transforms_for(i)))
        with jax.disable_jit():
            jstate = jenv.step(jstate, i, jparams, JF.integrate_frame)
        state = env.step(state, i, params)
        got = state_bits(state)
        for name, want in jstate._asdict().items():
            want = np.asarray(want)
            if want.dtype == np.float32:
                want = want.view(np.int32)
            np.testing.assert_array_equal(got[name], want,
                                          err_msg=f"frame {i} {name}")
    assert int(state.surfel_count) > 1000


@pytest.mark.parametrize("cap", [1_003_520, 20_000_768])
def test_auto_budget_policy_matches_jax(cap):
    script = [(0, 0), (3_000, 0), (31_000, 0), (60_000, 0), (90_000, 37),
              (120_000, 37), (150_000, 200), (160_000, 0), (400_000, 3),
              (900_000, 255)]
    args = (cap, 4096, 2**15, 640, 480)
    policies = (common.AutoBudgetPolicy(*args),
                jax_tool().AutoBudgetPolicy(*args))
    cam = synthetic.default_camera(640, 480)
    fields = dict(width=640, height=480, fx=cam.fx, fy=cam.fy, cx=cam.cx,
                  cy=cam.cy)
    params = (TF.FusionParams(**fields), JF.FusionParams(**fields))
    budgets = ([], [])
    for count, tiles in script:
        for k, (policy, p) in enumerate(zip(policies, params)):
            budgets[k].append(policy.params_for_frame(p).active_surfel_budget)
        policies[0].observe(types.SimpleNamespace(
            surfel_count=torch.tensor(count, dtype=torch.int32),
            active_tile_count=torch.tensor(tiles, dtype=torch.int32)))
        policies[1].observe(types.SimpleNamespace(
            surfel_count=jnp.int32(count), active_tile_count=jnp.int32(tiles)))
        policies[1].pending[-1].block_until_ready()
    assert budgets[0] == budgets[1]
    assert policies[0].budgets_used == policies[1].budgets_used
    assert len(set(budgets[0])) > 2 and max(budgets[0]) <= cap


def test_bench_smoke_check_on_the_cpu():
    env = dict(os.environ, SM_BENCH_SMOKE="1", SM_BENCH_CHECK="1",
               OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    run = subprocess.run(
        [sys.executable, "-m", "surfelmeshing_tpu_torch.bench", "--device",
         "cpu"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    lines = [json.loads(line) for line in run.stdout.splitlines()]
    assert lines[-1]["metric"] == "SMOKE_fusion_fps_640x480_500k"
    assert set(lines[-1]) == {"metric", "value", "unit", "vs_baseline",
                              "graph_captures"}
    assert lines[-1]["value"] > 0
    assert lines[-1]["graph_captures"] == 0        # no graphs on the CPU
    assert lines[0]["smoke_check"] == {"count_equal": True,
                                       "pack_equal": True,
                                       "max_abs_diff": 0.0}
    assert "12 timed frames" in run.stderr
    assert "builds in the timed region 0" in run.stderr


def test_bench_e2e_smoke_config(monkeypatch, capsys):
    monkeypatch.setenv("SM_BENCH_SMOKE", "1")
    result, = bench_e2e.main(["--device", "cpu", "41k"])
    assert json.loads(capsys.readouterr().out) == result
    assert E2E_KEYS <= set(result)
    assert result["compiles_in_timed_region"] == 0
    assert result["triangles"] > 0 and result["surfels"] > 0
    assert result["snapshots"] >= 1 and result["rows_shipped"] > 0
    assert result["fused_frames"] == 16 and result["skipped_tiles"] == 0
    assert result["peak_mib"] is None and result["blend_launches"] == 0


def test_bench_configs_small_sweep(monkeypatch, capsys):
    for name, value in (("W", 64), ("H", 48), ("NUM_FRAMES", 16)):
        monkeypatch.setattr(common.BenchEnv, name, value)
    full, auto = bench_configs.main(["--device", "cpu", "16k", "16k:-1"])
    lines = [json.loads(line)
             for line in capsys.readouterr().out.splitlines()]
    assert lines == [full, auto]
    assert CONFIGS_KEYS <= set(full) and "budgets_used" not in full
    assert CONFIGS_KEYS | {"budgets_used", "final_active_tiles"} <= set(auto)
    assert auto["capacity"] == 16384 and auto["budgets_used"] == [16384]
    assert full["surfels"] == auto["surfels"] > 0
    assert full["fused_frames"] == auto["fused_frames"] == 8


@pytest.mark.parametrize("entry", [bench, bench_e2e, bench_configs],
                         ids=["bench", "bench_e2e", "bench_configs"])
def test_entry_points_need_cuda_by_default(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.main([])


def test_build_counter_counts_compiles_only(tmp_path):
    src = tmp_path / "lib.c"
    src.write_text("int x;\n")
    # A stand-in compiler: writes its -o argument.
    flags = ["-c", "import sys; open(sys.argv[2], 'w').write('lib')"]
    before = cuda_build.builds
    first = cuda_build.cached_build("probe", sys.executable, flags, [src],
                                    build_dir=tmp_path)
    again = cuda_build.cached_build("probe", sys.executable, flags, [src],
                                    build_dir=tmp_path)
    assert first == again and first.read_text() == "lib"
    assert cuda_build.builds == before + 1
