"""The generator: the same frames for a seed, the same work for every
seed, and closed trajectories whose poses are continuous across the
wrap."""

import json

import numpy as np
import pytest

from benchmark import cell as C
from benchmark.traffic import generator as g

MIXES = ["loop.replay", "explore.live"]
CAMERA = {"width": 64, "height": 48, "fx": 52.5, "fy": 52.5, "cx": 32.5,
          "cy": 24.5}


def mix(name):
    return json.loads((C.BENCH / "traffic" / f"{name}.json").read_text())


def short(name, period=6):
    m = mix(name)
    m["trajectory"] = dict(m["trajectory"], period=period)
    return m


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_frames(name):
    a = g.render(short(name), CAMERA, 5000.0, 2 ** 31 + 5, "cpu")
    b = g.render(short(name), CAMERA, 5000.0, 2 ** 31 + 5, "cpu")
    c = g.render(short(name), CAMERA, 5000.0, 12, "cpu")
    assert np.array_equal(a.depth, b.depth)
    assert np.array_equal(a.color, b.color)
    assert not np.array_equal(a.depth, c.depth)
    assert a.depth.dtype == np.uint16 and a.color.dtype == np.uint8
    assert a.depth.shape == (6, 48, 64) and a.color.shape == (6, 48, 64, 3)
    assert (a.depth > 0).mean() > 0.9


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_places_the_same_objects(name):
    spec = mix(name)["scene"]

    def sizes(seed):
        s = g.scene(spec, np.random.default_rng(seed))
        boxes = sorted(tuple(np.round(hi - lo, 9)) for lo, hi in s["boxes"])
        return boxes, sorted(r for _, r in s["spheres"])

    assert sizes(1) == sizes(2 ** 31 + 77)
    assert len(spec["slots"]) >= len(spec["objects"])


@pytest.mark.parametrize("name", MIXES)
def test_poses_are_continuous_across_the_wrap(name):
    quat, trans = g.trajectory(mix(name)["trajectory"])
    step = g.path_speed_m_per_frame(trans)
    # The step across the wrap is no larger than the largest elsewhere.
    assert step[-1] <= 1.01 * step[:-1].max() + 1e-12
    rot = g.rotation_matrices(quat)
    turn = np.arccos(np.clip((np.einsum(
        "pij,pij->p", rot, np.roll(rot, -1, axis=0)) - 1) / 2, -1, 1))
    assert turn[-1] <= 1.01 * turn[:-1].max() + 1e-9
    np.testing.assert_allclose(np.linalg.norm(quat, axis=1), 1.0)


def test_walk_speeds_are_the_assumed_ones():
    _, t = g.trajectory(mix("explore.live")["trajectory"])
    speed = 30 * g.path_speed_m_per_frame(t)
    assert 0.2 < speed.mean() < 0.3
    _, t = g.trajectory(mix("loop.replay")["trajectory"])
    assert 30 * g.path_speed_m_per_frame(t).max() < 0.3


def test_video_shows_image_i_mod_period():
    frames = g.render(short("loop.replay", 5), CAMERA, 5000.0, 3, "cpu")
    video = C.make_video(frames, dict(CAMERA, fps=30))
    assert video.frame_count == C.FRAME_COUNT
    for i in (0, 4, 5, 13):
        f = video.depth_frames[i]
        assert np.shares_memory(f.get_image(), frames.depth[i % 5])
        assert np.array_equal(f.global_T_frame.t, frames.trans[i % 5])
        assert np.array_equal(video.color_frames[i].get_image(),
                              frames.color[i % 5])
