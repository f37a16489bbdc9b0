"""The port's evaluation tools against the JAX package's, on the CPU.

- eval/ab_matrix.py: the hostile subset of tests/test_ab_matrix.py (64x48,
  5 frames, occlusion and thin scenes on the look-away trajectory, the two
  endpoint modes).  Every mode stays within 5% of exact_all, and each cell
  is within 2% (relative) of the JAX package's: the JAX tool runs jitted,
  and XLA's fused multiply-adds move continuous values (ROADMAP queue 3).
- tools/fidelity_anchor.py: runs at 64x48 over 4 frames and prints the JAX
  tool's JSON keys.
- app/evaluate.py: tests/test_eval.py's synthetic dataset and ground
  truth; every metric within 2% (relative) of the JAX app's and the point
  count within 1%, for the same reason.
"""

import json

import numpy as np
import pytest
import torch

from surfelmeshing_tpu.app.evaluate import \
    evaluate_sequence as jax_evaluate_sequence
from surfelmeshing_tpu.eval import ab_matrix as JAB
from surfelmeshing_tpu.io.mesh_io import write_ply
from surfelmeshing_tpu.io.synthetic import write_tum_dataset
from surfelmeshing_tpu_torch.app.evaluate import evaluate_sequence
from surfelmeshing_tpu_torch.eval import ab_matrix as AB
from surfelmeshing_tpu_torch.tools import fidelity_anchor

torch.set_num_threads(1)

HOSTILE = dict(frames=5, width=64, height=48, capacity=16384,
               scenes=("occlusion", "thin"), trajectories=("lookaway",))
REL_TOL = 0.02


def endpoints(modes):
    return tuple(m for m in modes if m[0] in ("tpu_defaults", "exact_all"))


def test_hostile_deviations_bounded_and_match_jax():
    matrix = AB.deviation_matrix(modes=endpoints(AB.MODES), device="cpu",
                                 **HOSTILE)
    want = JAB.deviation_matrix(modes=endpoints(JAB.MODES), **HOSTILE)
    assert set(matrix) == set(want) == {"occlusion/lookaway",
                                        "thin/lookaway"}
    for key, row in matrix.items():
        assert row["exact_all"] < 5.0, (key, row)      # sane reconstruction
        assert AB.max_rel_deviation(row) <= 0.05, (key, row)
        for mode, err in row.items():
            assert abs(err - want[key][mode]) <= REL_TOL * want[key][mode], \
                (key, mode, err, want[key][mode])
    table = AB.format_markdown({k: dict.fromkeys(
        (m for m, _ in AB.MODES), 1.0) for k in matrix})
    assert table.count("\n") == 1 + len(matrix)


def test_ab_matrix_refuses_overflow():
    with pytest.raises(RuntimeError, match="overflow"):
        AB.deviation_matrix(frames=2, width=64, height=48, capacity=256,
                            scenes=("thin",), trajectories=("arc",),
                            modes=AB.MODES[:1], device="cpu")


def test_fidelity_anchor_prints_json(capsys):
    assert fidelity_anchor.main(["--device", "cpu", "--frames", "4",
                                 "--width", "64", "--height", "48",
                                 "--capacity", "16384"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"metric", "value", "unit", "frames", "shape", "scene",
            "trajectory", "surfels_tpu", "surfels_oracle", "triangles_tpu",
            "triangles_ref", "mesh_median_mm", "mesh_rms_mm",
            "completeness_1mm", "surfel_mean_delta_mm",
            "surfel_max_delta_mm", "elapsed_s"} <= set(out)
    assert out["device"] == "cpu" and out["shape"] == [48, 64]
    assert out["surfels_tpu"] == out["surfels_oracle"] > 500
    assert 0.0 <= out["value"] < 1.0
    assert out["triangles_tpu"] > 0 and out["triangles_ref"] > 0


def test_evaluate_sequence_matches_jax(tmp_path):
    """tests/test_eval.py::test_evaluate_sequence_app's inputs through both
    apps."""
    ds = write_tum_dataset(str(tmp_path / "ds"), num_frames=6,
                           width=64, height=48)
    rng = np.random.default_rng(0)
    wall = np.stack([rng.uniform(-2, 2, 60000), rng.uniform(-2, 0.8, 60000),
                     np.full(60000, 2.5)], axis=1)
    floor = np.stack([rng.uniform(-2, 2, 30000), np.full(30000, 0.8),
                      rng.uniform(0, 2.5, 30000)], axis=1)
    u = rng.normal(size=(20000, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sphere = np.array([0.0, 0.3, 1.8]) + 0.35 * u
    gt_path = str(tmp_path / "gt.ply")
    write_ply(gt_path, np.concatenate([wall, floor, sphere])
              .astype(np.float32))
    kw = dict(max_surfel_count=32768, outlier_filtering_frame_count=2)
    got = evaluate_sequence(ds, "groundtruth.txt", gt_path, device="cpu",
                            **kw)
    want = jax_evaluate_sequence(ds, "groundtruth.txt", gt_path, **kw)
    assert got.n_points > 100 and got.median < 0.01
    assert abs(got.n_points - want.n_points) <= 0.01 * want.n_points
    for name in ("mean", "median", "rms", "completeness"):
        a, b = getattr(got, name), getattr(want, name)
        assert abs(a - b) <= REL_TOL * abs(b), (name, a, b)
