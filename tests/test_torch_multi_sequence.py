"""The port's multi-sequence app (surfelmeshing_tpu_torch/app/
multi_sequence.py) on two synthetic TUM datasets (64x48, 5 frames, the arc
and look-away trajectories): each sequence's PLY equals, byte for byte,
the PLY of the same app run on that dataset alone; `main` returns 0 on the
CPU and asks for the card by default; and against the JAX package's
run_batched the point clouds agree by tests/test_torch_pipeline.py's
fallback criterion (count within 1%, mean nearest-point distance under
0.5 mm).  JAX's batched step stamps every frame as frame 0 (ROADMAP queue
3), so surfels it created are never integrated again: the criterion, not
equality, is what the two apps can share."""

import time

import numpy as np
import pytest
import torch

from surfelmeshing_tpu_torch.app import multi_sequence as MS
from surfelmeshing_tpu_torch.io.mesh_io import read_ply
from surfelmeshing_tpu_torch.io.synthetic import write_tum_dataset

torch.set_num_threads(1)

CAPACITY = 16384
NAMES = ("arc", "lookaway")


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("multi_seq")
    return [write_tum_dataset(str(root / name), num_frames=5, width=64,
                              height=48, trajectory=name) for name in NAMES]


def ply_bytes(out_dir, name) -> bytes:
    return (out_dir / f"{name}.ply").read_bytes()


@pytest.fixture(scope="module")
def batched_run(datasets, tmp_path_factory):
    out = tmp_path_factory.mktemp("batched_out")
    counts = MS.run_batched(datasets, "groundtruth.txt",
                            max_surfel_count=CAPACITY, output_dir=str(out),
                            device="cpu")
    return out, counts


def test_batched_plys_equal_single_dataset_runs(datasets, batched_run,
                                                tmp_path):
    out, counts = batched_run
    assert len(counts) == 2 and all(c > 50 for c in counts)
    for name, d in zip(NAMES, datasets):
        alone = tmp_path / name
        MS.run_batched([d], "groundtruth.txt", max_surfel_count=CAPACITY,
                       output_dir=str(alone), device="cpu")
        assert ply_bytes(out, name) == ply_bytes(alone, name), name
    assert ply_bytes(out, NAMES[0]) != ply_bytes(out, NAMES[1])


def test_main_returns_zero_on_cpu(datasets, batched_run, tmp_path):
    rc = MS.main([*datasets, "--output_dir", str(tmp_path),
                  "--max_surfel_count", str(CAPACITY), "--device", "cpu"])
    assert rc == 0
    for name in NAMES:
        assert ply_bytes(tmp_path, name) == ply_bytes(batched_run[0], name)


def test_main_asks_for_the_card_by_default(datasets, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MS.main([*datasets, "--output_dir", str(tmp_path)])


def mean_nearest_distance(a: np.ndarray, b: np.ndarray) -> float:
    d = torch.cdist(torch.from_numpy(a).double(), torch.from_numpy(b).double())
    return float(d.min(dim=1).values.mean())


def test_matches_jax_app(datasets, batched_run, tmp_path, record_property):
    import jax

    from surfelmeshing_tpu.app.multi_sequence import run_batched

    t0 = time.perf_counter()
    counts = run_batched(datasets, "groundtruth.txt",
                         max_surfel_count=CAPACITY, output_dir=str(tmp_path),
                         devices=jax.devices()[:2])
    record_property("jax_app_seconds", round(time.perf_counter() - t0, 1))
    out, port_counts = batched_run
    dists = []
    for name, c, pc in zip(NAMES, counts, port_counts):
        want = read_ply(str(tmp_path / f"{name}.ply"))
        got = read_ply(str(out / f"{name}.ply"))
        assert abs(int(c) - int(pc)) <= 0.01 * int(c)
        assert abs(len(got) - len(want)) <= 0.01 * len(want)
        xyz = lambda rec: np.stack([rec["x"], rec["y"], rec["z"]], 1)
        dist = mean_nearest_distance(xyz(got), xyz(want))
        assert dist < 5e-4, (name, dist)
        dists.append(f"{name}: {len(got)} vs {len(want)} points, mean "
                     f"nearest distance {dist:.2e} m")
    record_property("multi_sequence_parity", "; ".join(dists))


def test_each_sequence_uses_its_own_camera(datasets, batched_run, tmp_path):
    """A copy of the arc dataset whose calibration has 10% longer focal
    lengths, fused beside the original: its PLY equals its run alone
    (the JAX app would fuse it with the first dataset's intrinsics)."""
    import shutil

    wide = tmp_path / "arc_long_focal"
    shutil.copytree(datasets[0], wide)
    fx, fy, cx, cy = (float(v) for v in
                      (wide / "calibration.txt").read_text().split())
    (wide / "calibration.txt").write_text(f"{1.1 * fx} {1.1 * fy} {cx} {cy}\n")
    MS.run_batched([datasets[0], str(wide)], "groundtruth.txt",
                   max_surfel_count=CAPACITY, output_dir=str(tmp_path / "b"),
                   device="cpu")
    MS.run_batched([str(wide)], "groundtruth.txt", max_surfel_count=CAPACITY,
                   output_dir=str(tmp_path / "a"), device="cpu")
    name = wide.name
    assert ply_bytes(tmp_path / "b", name) == ply_bytes(tmp_path / "a", name)
    assert ply_bytes(tmp_path / "b", name) != ply_bytes(batched_run[0], "arc")
    assert ply_bytes(tmp_path / "b", "arc") == ply_bytes(batched_run[0], "arc")
