"""The port's dispatch policy (dispatch.DispatchPolicy) on its own: no
fusion, readbacks scripted as CPU tensors (event None).

- the picks of a recorded pipeline run (64x48, frame_chunk 3 with a map
  read after frame 6: sub-chunks of 2 and 1 frames) replayed from its
  confirmed counts equal that run's bucket_pick_log, with the exact and
  the adaptive count bound;
- least_bucket is never above a later pick;
- a snapshot and restore round trip, and a reset from an assigned map;
- a chunk's auto budget charges each of its frames a creation frontier
  (ROADMAP queue 3 #10), through pick.
"""

import types

import pytest
import torch

from surfelmeshing_tpu_torch.config import SurfelMeshingConfig
from surfelmeshing_tpu_torch.dispatch import DispatchPolicy
from surfelmeshing_tpu_torch.io.synthetic import default_camera
from surfelmeshing_tpu_torch.pipeline import fusion_params_from_config

CAP = 32768
# (frames, surfel count after them) of each dispatch of the recorded run,
# and the run's bucket_pick_log by adaptive_creation_bound.
SCRIPT = [(2, 1368), (1, 1488), (2, 1622), (1, 1669), (2, 1700),
          (1, 1708), (1, 1723)]
PICKS = {0.0: [(2, 16384), (1, 10240), (2, 18432), (1, 10240), (2, 18432),
               (1, 10240), (1, 10240)],
         2.0: [(2, 16384), (1, 4096), (2, 6144), (1, 4096), (2, 6144),
               (1, 4096), (1, 4096)]}


def policy(camera=None, **kw) -> DispatchPolicy:
    cfg = SurfelMeshingConfig(**{**dict(
        max_surfel_count=CAP, outlier_filtering_frame_count=2,
        max_creations_per_frame=8192, shape_bucket_step=1024), **kw})
    camera = camera or default_camera(64, 48)
    return DispatchPolicy(cfg, fusion_params_from_config(cfg, camera),
                          camera)


def counts(count=0, tiles=0, deferred=0, rows=CAP):
    """A stand-in map: the four counters the policy reads back (no tile
    skipped) and a pack of `rows` rows."""
    def i32(v):
        return torch.tensor(v, dtype=torch.int32)
    return types.SimpleNamespace(
        pack=torch.empty((rows, 0)), surfel_count=i32(count),
        active_tile_count=i32(tiles), deferred_count=i32(deferred),
        skipped_tile_count=i32(0))


def replay(p: DispatchPolicy) -> list:
    """The script through `p`: a pick, then the dispatch's readback; ->
    least_bucket() before each pick."""
    floors = []
    for frames, count in SCRIPT:
        floors.append(p.least_bucket())
        p.pick(counts(), frames)
        p.queue_readback(counts(count), frames)
    return floors


@pytest.mark.parametrize("factor", [0.0, 2.0])
def test_picks_replay_the_recorded_run(factor):
    p = policy(adaptive_creation_bound=factor)
    replay(p)
    assert p.picks == PICKS[factor]
    assert p.confirmed_count == SCRIPT[-2][1]       # the last is in flight
    assert p.unconfirmed_frames == 1 and len(p.readbacks) == 1
    p.drain(0)
    assert p.confirmed_count == p.creations_made == SCRIPT[-1][1]
    assert p.unconfirmed_frames == 0 and not p.readbacks


@pytest.mark.parametrize("factor", [0.0, 2.0])
def test_least_bucket_is_never_above_a_later_pick(factor):
    p = policy(adaptive_creation_bound=factor)
    floors = replay(p)
    n_effs = [n for _, n in p.picks]
    assert floors[0] == 1024                         # the empty map's
    for i, floor in enumerate(floors):
        assert floor % 1024 == 0 and floor <= min(n_effs[i:])
    assert policy(active_surfel_budget=-1).least_bucket() == 0


def test_snapshot_restore_round_trip():
    p = policy(adaptive_creation_bound=2.0)
    replay(p)
    p.drain(0)
    snap = p.snapshot()
    marks = (p.confirmed_count, p.lagged_active_tiles, list(p.growth_window))
    want = p.count_bound(1)
    p.pick(counts(), 1)
    p.queue_readback(counts(5000), 1)
    p.drain(0)
    assert p.count_bound(1) != want
    p.pick(counts(), 2)
    p.queue_readback(counts(6000), 2)
    p.drain(0)
    p.restore(snap)
    assert (p.confirmed_count, p.lagged_active_tiles,
            p.growth_window) == marks
    assert p.unconfirmed_frames == 0 and p.count_bound(1) == want
    p.growth_window.append(1)
    assert snap[2] == marks[2]                       # the snapshot's own


def test_reset_from_an_assigned_map():
    p = policy(adaptive_creation_bound=2.0)
    replay(p)
    assert p.readbacks and p.growth_window
    p.reset(counts(20000, 7, 300))
    assert (p.confirmed_count, p.lagged_active_tiles,
            p.confirmed_deferred) == (20000, 7, 300)
    assert not p.readbacks and not p.growth_window
    assert p.unconfirmed_frames == 0
    # The first bucket holds the map's count plus a frame's creations.
    assert p.pick(counts(), 1)[1] == 28672
    assert p.least_bucket() == 20480


def test_chunk_auto_budget_charges_its_frames():
    """200k confirmed surfels, 20 tiles of demand and 4 frames unconfirmed
    at 640x480: a frame's budget is twice the demand (64 tiles of 4096
    rows); a chunk of 4 adds 8 tiles for each of its and the unconfirmed
    frames (40 + 64 -> 128 tiles)."""
    p = policy(camera=default_camera(640, 480), max_surfel_count=1_000_000,
               active_surfel_budget=-1, max_creations_per_frame=32768)
    p.confirmed_count, p.unconfirmed_frames = 200_000, 4
    p.lagged_active_tiles = 20
    assert p.auto_budget(1_003_520, 1) == 64 * 4096
    params, n_eff = p.pick(counts(rows=1_003_520), 4)
    assert n_eff == 1_003_520
    assert params.active_surfel_budget == p.budget == 128 * 4096
    assert p.picks == [(4, 1_003_520)]
