"""The kernel launch counters' registry (ops/launch_counts.py): every
hand-written kernel's wrapper registers its counter there, and a CUDA
graph's capture moves all of them through it (chunk.py): snapshot before,
what the capture added kept as the graph's counts, snapshot restored, the
graph's counts added at each replay."""

import pytest

from surfelmeshing_tpu_torch.ops import association, blend, gather, \
    integration, launch_counts, regularization, \
    tiling  # noqa: F401 (each registers itself)
from surfelmeshing_tpu_torch.ops import preprocess as pp


@pytest.fixture(autouse=True)
def keep_counts():
    """Each test leaves the process's counters as it found them."""
    saved = launch_counts.snapshot()
    yield
    launch_counts.restore(saved)


def test_every_kernel_wrapper_is_registered():
    assert set(launch_counts.snapshot()) == {
        "blend_core", "blend_wide", "blend_wide_kernels",
        "gather_rows", "gather_rows3", "gather_lane",
        *(f"preprocess_{k}" for k in pp.KERNELS),
        *(f"association_{k}" for k in association.KERNELS),
        "integration", "regularization", "tiling"}
    assert list(pp.KERNELS) == ["bilateral", "outlier", "erode", "normals",
                                "radii"]


def test_counters_live_in_their_wrappers():
    launch_counts.zero()
    blend.blend_core.wide_launches = 2
    gather.gather_lane.launches = 3
    pp.erode_depth.launches = 4
    counts = launch_counts.snapshot()
    assert (counts["blend_wide"], counts["gather_lane"],
            counts["preprocess_erode"]) == (2, 3, 4)
    assert sum(counts.values()) == 9
    assert pp.launches() == dict(dict.fromkeys(pp.KERNELS, 0), erode=4)


def test_capture_and_replays_count_what_the_card_ran():
    """chunk.ChunkStep's bookkeeping: a capture counts nothing, each
    replay counts the captured launches."""
    launch_counts.zero()
    blend.blend_core.launches = 7              # eager frames before
    counts = launch_counts.snapshot()
    blend.blend_core.launches += 1             # the warm-up
    before = launch_counts.snapshot()
    blend.blend_core.launches += 2             # the capture: 2 frames
    for fn in pp.KERNELS.values():
        fn.launches += 2
    captured = launch_counts.since(before)
    launch_counts.restore(counts)
    assert launch_counts.snapshot() == counts
    for _ in range(3):                         # three replays
        launch_counts.add(captured)
    assert blend.blend_core.launches == 7 + 3 * 2
    assert pp.launches() == dict.fromkeys(pp.KERNELS, 3 * 2)
    assert captured["blend_wide"] == captured["gather_rows"] == 0


def test_register_refuses_a_name_twice():
    with pytest.raises(ValueError, match="registered twice"):
        launch_counts.register("blend_core", blend.blend_core)
    assert launch_counts.snapshot()["blend_core"] == blend.blend_core.launches
