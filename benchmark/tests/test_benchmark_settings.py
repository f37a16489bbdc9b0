"""A deployment's settings are each read by the reference or left aside by
design (reference/step.py: READ, UNCHECKED), and any other is refused
before a frame is rendered: by cell.Run, and by run.py with a non-zero
exit that names it.  The reference's FusionParams of every configuration
is what it was before the fusion modes were read."""

import json
import shutil
import subprocess
import sys
import time

import pytest

from benchmark import cell as C
from benchmark.reference import fusion as rfu
from benchmark.reference import step as rstep

BENCH = json.loads((C.ROOT / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: c["file"] for c in BENCH["configs"]}
CELL_OF = {w["config"]: w["name"] for w in BENCH["workloads"]}


def config(name: str) -> dict:
    return json.loads((C.ROOT / CONFIGS[name]).read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_every_setting_is_classified(name):
    keys = set(config(name)["settings"])
    assert keys <= rstep.READ | rstep.UNCHECKED, \
        keys - rstep.READ - rstep.UNCHECKED
    rstep.refuse_unchecked(config(name)["settings"])


def test_the_two_lists_are_apart_and_name_the_modes():
    assert not rstep.READ & rstep.UNCHECKED
    assert set(rstep.MODES) <= rstep.READ
    assert set(rstep.ONLY) <= rstep.READ


def _fusion_params_before(s: dict, camera: dict) -> rfu.FusionParams:
    """reference/step.py::fusion_params as it was before it read the
    fusion modes."""
    return rfu.FusionParams(
        width=camera["width"], height=camera["height"],
        fx=camera["fx"], fy=camera["fy"], cx=camera["cx"], cy=camera["cy"],
        depth_scaling=s["depth_scaling"],
        sensor_noise_factor=s["sensor_noise_factor"],
        max_surfel_confidence=s["max_surfel_confidence"],
        normal_compatibility_threshold_deg=(
            s["normal_compatibility_threshold_deg"]),
        regularizer_weight=s["regularizer_weight"],
        regularization_frame_window_size=(
            s["regularization_frame_window_size"]),
        do_blending=s["do_blending"],
        measurement_blending_radius=s["measurement_blending_radius"],
        regularization_iterations=(
            s["regularization_iterations_per_integration_iteration"]),
        radius_factor_for_regularization_neighbors=(
            s["radius_factor_for_regularization_neighbors"]),
        surfel_integration_active_window_size=(
            s["surfel_integration_active_window_size"]),
        active_surfel_budget=0,
        max_creations_per_frame=s["max_creations_per_frame"])


@pytest.mark.parametrize("name", CONFIGS)
def test_fusion_params_of_every_configuration_are_unchanged(name):
    cfg = config(name)
    settings = C.program_settings(cfg)
    got = rstep.fusion_params(settings, cfg["camera"])
    assert got == _fusion_params_before(settings, cfg["camera"])
    assert (got.symmetric_regularization, got.exact_conflict_arbitration,
            got.fast_neighbor_update) == (True, False, True)


@pytest.mark.parametrize("extra", [{"no_such_setting": 1},
                                   {"log_timings_staged": True},
                                   {"start_frame": 3}])
def test_run_refuses_a_setting_before_rendering(monkeypatch, extra):
    def render(*a, **k):
        raise AssertionError("rendered before the settings were checked")

    monkeypatch.setattr(C.generator, "render", render)
    name = "tum640_2m"
    settings = dict(config(name)["settings"], **extra)
    with pytest.raises(ValueError, match=next(iter(extra))):
        C.Run(CELL_OF[name], 1, 1.0, False, time.perf_counter(),
              device="cpu", overrides={"config.settings": settings})


def test_run_py_exits_naming_the_setting(tmp_path):
    """A checkout whose configuration holds an unknown setting: run.py
    exits non-zero within seconds, names it and prints no result."""
    shutil.copy(C.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(C.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = tmp_path / CONFIGS["tum640_2m"]
    cfg = json.loads(path.read_text())
    cfg["settings"]["no_such_setting"] = 1
    path.write_text(json.dumps(cfg))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, str(tmp_path / "benchmark" / "run.py"),
         "--workload", CELL_OF["tum640_2m"], "--seed", "2147483901",
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
        timeout=120, cwd=str(tmp_path))
    assert out.returncode != 0
    assert "no_such_setting" in out.stderr
    assert out.stdout.strip() == ""
    assert time.perf_counter() - t0 < 60
