"""The check that decides `correct`, on the CPU at a tiny size: sound
runs of the port compare equal to the plain reference, and the control
(the reference with its map stored in bfloat16) and each fault that a
cell can have, planted under a run, make it fail."""

import dataclasses

import numpy as np
import pytest
import torch

import tiny_cell
from benchmark.reference import step as rstep

CELLS = ["tum640_2m.loop.replay", "tum640_20m_defaults.explore.live"]


def failed(checks):
    return {k: v for k, (v, lim) in checks.items() if v > lim}


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_matches_the_reference(workload):
    r, out = tiny_cell.run(workload)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert failed(out["checks"]) == {}
    names = set(out["checks"])
    assert {"start_state_mismatch", "end_state_mismatch",
            "bucket_short_frames"} <= names
    if r.mesher is not None:
        assert {"snapshot_row_mismatch", "triangle_invalid"} <= names


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload):
    _, out = tiny_cell.run(workload, control=True)
    bad = failed(out["checks"])
    assert bad.get("start_state_mismatch", 0) > 0
    assert bad.get("end_state_mismatch", 0) > 0


def test_bfloat16_rounding_keeps_the_stamps():
    state = rstep.empty_map({"max_surfel_count": 8,
                             "active_surfel_budget": 0}, "cpu")
    state.pack[:, 0] = 1.0 + 2.0 ** -20
    stamps = state.pack.view(torch.int32)[:, 6].clone()
    rstep.round_to_bfloat16(state)
    assert torch.all(state.pack[:, 0] == 1.0)
    assert torch.equal(state.pack.view(torch.int32)[:, 6], stamps)


def _patch_step(monkeypatch, wrap):
    """Plant `wrap(original)` as the fusion step the pipeline and its
    chunk step call."""
    import surfelmeshing_tpu_torch.chunk as chunk
    import surfelmeshing_tpu_torch.pipeline as pipeline
    orig = pipeline.integrate_frame_bucketed
    monkeypatch.setattr(pipeline, "integrate_frame_bucketed", wrap(orig))
    monkeypatch.setattr(chunk, "integrate_frame_bucketed", wrap(orig))


def test_fault_step_returns_its_state_unchanged(monkeypatch):
    _patch_step(monkeypatch, lambda orig: lambda state, *a, **k: state)
    _, out = tiny_cell.run("tum640_20m_defaults.explore.live")
    bad = failed(out["checks"])
    assert bad.get("start_state_mismatch", 0) > 0
    assert bad.get("end_state_mismatch", 0) > 0


def test_fault_half_of_a_chunk_left_out(monkeypatch):
    import surfelmeshing_tpu_torch.chunk as chunk
    orig = chunk.ChunkStep.run

    def half(self, state, entries, params, n_eff):
        return orig(self, state, entries[:max(1, len(entries) // 2)],
                    params, n_eff)

    monkeypatch.setattr(chunk.ChunkStep, "run", half)
    _, out = tiny_cell.run("tum640_2m.loop.replay")
    bad = failed(out["checks"])
    assert bad.get("start_state_mismatch", 0) > 0
    assert bad.get("end_state_mismatch", 0) > 0


@pytest.mark.parametrize("workload", ["tum640_2m.loop.replay",
                                      "tum640_20m_defaults.explore.live"])
def test_fault_answer_altered_where_produced(monkeypatch, workload):
    def alter(orig):
        def step(*a, **k):
            out = orig(*a, **k)
            out.pack.view(torch.int32)[0, 0] += 1   # one ulp of one value
            return out
        return step

    _patch_step(monkeypatch, alter)
    _, out = tiny_cell.run(workload)
    assert failed(out["checks"]).get("end_state_mismatch", 0) > 0


@pytest.mark.parametrize("workload", ["tum640_2m.loop.replay",
                                      "tum640_20m_defaults.explore.live"])
def test_fault_bucket_shrunk(monkeypatch, workload):
    """A policy that picks half the bucket it should (fewer rows fused,
    creations deferred) fails, though the reference could step over the
    same rows."""
    import surfelmeshing_tpu_torch.pipeline as pipeline
    orig = pipeline.ReconstructionPipeline.shape_bucket_for

    def half(self, count_bound):
        step = self.config.shape_bucket_step
        return max(step, orig(self, count_bound) // 2 // step * step)

    monkeypatch.setattr(pipeline.ReconstructionPipeline, "shape_bucket_for",
                        half)
    _, out = tiny_cell.run(workload)
    assert failed(out["checks"]).get("bucket_short_frames", 0) > 0


def test_fault_snapshot_row_altered(monkeypatch):
    import surfelmeshing_tpu_torch.pipeline as pipeline
    orig = pipeline.ReconstructionPipeline.snapshot_for_meshing

    def altered(self, frame_index):
        snap = list(orig(self, frame_index))
        k = 1 if snap[0] == "full" else 2       # the smooth positions
        pos = np.array(snap[k], copy=True)
        if len(pos):
            pos[-1, 0] += 1.0
        snap[k] = pos
        return tuple(snap)

    monkeypatch.setattr(pipeline.ReconstructionPipeline,
                        "snapshot_for_meshing", altered)
    _, out = tiny_cell.run("tum640_20m_defaults.explore.live")
    assert failed(out["checks"]).get("snapshot_row_mismatch", 0) > 0


def test_fault_triangle_altered(monkeypatch):
    from surfelmeshing_tpu_torch.meshing import engine
    orig = engine.MeshingEngine.get_triangles

    def altered(self):
        tris = np.array(orig(self), copy=True)
        if len(tris):
            tris[0, 1] = tris[0, 0]
        return tris

    monkeypatch.setattr(engine.MeshingEngine, "get_triangles", altered)
    _, out = tiny_cell.run("tum640_20m_defaults.explore.live")
    assert failed(out["checks"]).get("triangle_invalid", 0) > 0


def test_reference_is_independent_of_the_map_it_steps(monkeypatch):
    """The reference writes a clone, never the map it was handed."""
    state = rstep.empty_map({"max_surfel_count": 64,
                             "active_surfel_budget": 0}, "cpu")
    before = state.pack.clone()
    clone = rstep.clone_map(state)
    clone.pack += 1
    assert torch.equal(state.pack, before)
    assert dataclasses.is_dataclass(clone)
