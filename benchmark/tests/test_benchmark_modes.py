"""The fusion modes a deployment may state (reference/step.py::MODES),
each alone and all three together: the reference's parameters carry
the mode, the frozen reference steps a map as the port's plain
integrate_frame_bucketed does in that mode word for word, the mode
changes the map against the defaults (so a reference that dropped it
would fail the comparison), and the bfloat16 control differs from the
reference.  On the CPU at the size of tiny_cell.py, 6 frames from an
empty map over one bucket below capacity, with conflicting surfels
planted before the fourth (plant_conflicts); the `cuda` case runs the
desk-loop deployment at full size on the card, 12 frames, through the
port's kernels, as it comes and with the same planting."""

from __future__ import annotations

import dataclasses
import functools

import pytest
import torch

import tiny_cell
from benchmark import cell as C
from benchmark.reference import step as rstep
from benchmark.traffic import generator

WORKLOAD = "tum640_2m.loop.replay"
MODES = {
    "exact_regularization": {"symmetric_regularization": False},
    "exact_conflicts": {"exact_conflict_arbitration": True},
    "full_neighbor_update": {"fast_neighbor_update": False},
}
MODES["all_three"] = {k: v for m in MODES.values() for k, v in m.items()}
SEED = 2147483901
FRAMES = range(4, 10)
PLANT_AT = 7
N_EFF = 32_768                 # one bucket below the tiny map's 40,960


def deployment(tiny: bool, device) -> tuple:
    """(settings, camera, frames) of the desk-loop cell, at tiny_cell's
    size or at its own."""
    _, config, traffic = C.find_cell(WORKLOAD)
    parts = {"config": dict(config), "traffic": dict(traffic)}
    for key, value in (tiny_cell.overrides(WORKLOAD) if tiny else {}).items():
        part, _, name = key.partition(".")
        parts[part][name] = value
    config, traffic = parts["config"], parts["traffic"]
    settings = C.program_settings(config)
    frames = generator.render(traffic, config["camera"],
                              settings["depth_scaling"], SEED, device)
    return settings, config["camera"], frames


@functools.lru_cache(maxsize=None)
def tiny_inputs() -> tuple:
    return deployment(True, "cpu")


def reference(mode: str, device="cpu", low_precision=False, tiny=True):
    settings, camera, frames = tiny_inputs() if tiny else \
        deployment(False, device)
    settings = dict(settings, **MODES.get(mode, {}))
    return rstep.ReferenceFusion(settings, camera, frames, device,
                                 low_precision=low_precision)


def plant_conflicts(state, ref, i: int, every: int = 5):
    """Pull every `every`-th live surfel to 0.6 of its distance from frame
    i's camera and append a copy of each: pairs of surfels at one depth in
    front of what frame i measures, as an object that moved away leaves
    them.  Both of a pair conflict at the same pixels, so the conflict
    modes arbitrate them differently (a smooth static scene has no such
    pairs: there exact_conflict_arbitration changes no word)."""
    n = int(state.surfel_count)
    centre = torch.tensor(ref.frames.trans[i % ref.frames.period],
                          dtype=torch.float32, device=state.pack.device)
    rows = torch.arange(0, n, every, device=state.pack.device)
    copies = torch.arange(n, n + rows.numel(), device=state.pack.device)
    for lo in (0, 3):                  # raw and smoothed positions
        p = state.pack[rows, lo:lo + 3]
        state.pack[rows, lo:lo + 3] = centre + 0.6 * (p - centre)
    state.pack[copies] = state.pack[rows]
    state.neighbors[:, copies] = state.neighbors[:, rows]
    state.nbr_dist[:, copies] = state.nbr_dist[:, rows]
    return dataclasses.replace(
        state, surfel_count=state.surfel_count + rows.numel())


def port_step(ref, mode: str, state, i: int, n_eff: int):
    """Frame i through the port's integrate_frame_bucketed, fed the
    reference's inputs, with the port's FusionParams of the deployment
    and the mode set on it here, not taken from the reference's."""
    from surfelmeshing_tpu_torch.ops import fusion as pfu
    params = dataclasses.replace(
        pfu.params_from(rstep.fusion_params(
            {k: v for k, v in ref.settings.items() if k not in rstep.MODES},
            ref.camera)), **MODES.get(mode, {}))
    return pfu.integrate_frame_bucketed(
        state, *ref.frame_inputs(i), i, params, n_eff)


@functools.lru_cache(maxsize=None)
def tiny_map(mode: str, side: str):
    """The tiny map after FRAMES from an empty map: side "reference",
    "control" (the reference with its map in bfloat16) or "port"."""
    from surfelmeshing_tpu_torch.ops import fusion as pfu
    ref = reference(mode, low_precision=side == "control")
    cap = rstep.capacity(ref.settings)
    assert N_EFF < cap
    if side == "port":
        state, step = pfu.create_surfel_state(cap, "cpu"), \
            functools.partial(port_step, ref, mode)
    else:
        state, step = rstep.empty_map(ref.settings, "cpu"), ref.step
    for i in FRAMES:
        if i == PLANT_AT:
            state = plant_conflicts(state, ref, i)
        state = step(state, i, N_EFF)
    return state


@pytest.mark.parametrize("mode", MODES)
def test_fusion_params_carry_the_mode(mode):
    settings, camera, _ = tiny_inputs()
    params = rstep.fusion_params(dict(settings, **MODES[mode]), camera)
    default = rstep.fusion_params(settings, camera)
    for key, value in MODES[mode].items():
        assert getattr(params, key) == value != getattr(default, key)
    assert dataclasses.replace(params, **{
        k: getattr(default, k) for k in MODES[mode]}) == default


@pytest.mark.parametrize("mode", MODES)
def test_reference_equals_the_ports_plain_step(mode):
    ref, port = tiny_map(mode, "reference"), tiny_map(mode, "port")
    assert int(ref.surfel_count) > 4096
    assert C.map_mismatch(port, ref) == 0


@pytest.mark.parametrize("mode", MODES)
def test_the_mode_changes_the_map(mode):
    assert C.map_mismatch(tiny_map(mode, "reference"),
                          tiny_map("defaults", "reference")) > 0


def test_control_differs_in_all_three_modes():
    assert C.map_mismatch(tiny_map("all_three", "control"),
                          tiny_map("all_three", "reference")) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("planted", [False, True])
def test_full_size_all_three_modes_on_the_card(cuda, planted):
    """The desk-loop deployment at 640x480 into 2M rows with the three
    modes set, 12 frames from an empty map, count-sized buckets of the
    cell's step, as it comes or with conflicting pairs planted before the
    seventh: the port on the card (its association, integration and
    blending kernels) equals the frozen reference on the card word for
    word."""
    ref = reference("all_three", cuda, tiny=False)
    s = ref.settings
    from surfelmeshing_tpu_torch.ops import fusion as pfu
    cap = rstep.capacity(s)
    want = rstep.empty_map(s, cuda)
    got = pfu.create_surfel_state(cap, cuda)
    step = s["shape_bucket_step"]
    for i in range(4, 16):
        if planted and i == 10:
            want = plant_conflicts(want, ref, i)
            got = plant_conflicts(got, ref, i)
        need = int(want.surfel_count) + s["max_creations_per_frame"]
        n_eff = min(cap, -(-need // step) * step)
        want = ref.step(want, i, n_eff)
        got = port_step(ref, "all_three", got, i, n_eff)
    torch.cuda.synchronize()
    bad = C.map_mismatch(got, want)
    print(f"all three modes at 640x480, 12 frames, planted {planted}: "
          f"{int(want.surfel_count)} surfels, {bad} differing words")
    assert int(want.surfel_count) > 100_000
    assert bad == 0
