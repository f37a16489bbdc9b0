"""Row gathers (ports of tools/gather_probe.py's three Pallas kernels): the
plain versions against JAX's `src[idx]`, `jnp.take` and
`jnp.take_along_axis` bit for bit, and the CUDA kernels against the plain
versions on the card (marked `cuda`, skipped without a GPU).

Sources carry the INVALID_INDEX NaN pattern, other NaN payloads, -0.0 and
denormals; indices include out-of-range values, which clamp to
[0, HW - 1] (jnp.take's mode="clip"; JAX's src[idx] and take_along_axis
wrap negative indices first, so they see only indices >= 0 here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfelmeshing_tpu_torch.ops import gather as G
from surfelmeshing_tpu_torch.tools import gather_probe

torch.set_num_threads(1)

HW, N, COLS = 96, 250, 8


def bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.int32)


def test_gather_rows_plain_matches_jax_index():
    """Indices >= 0: JAX's src[idx] clamps high indices like the port."""
    srcs, idx = gather_probe.special_inputs(HW, N, 1, negative=False)
    src = srcs[0]
    got = G.gather_rows_reference(torch.from_numpy(src), torch.from_numpy(idx))
    assert got.shape == (N, COLS) and got.dtype == torch.float32
    np.testing.assert_array_equal(bits(got), bits(jnp.asarray(src)[idx]))


@pytest.mark.parametrize("seed", [3, 4])
def test_gather_rows_plain_matches_jax_take_clip(seed):
    """Negative indices clamp to row 0 (jnp.take mode="clip"; src[idx]
    would wrap them)."""
    srcs, idx = gather_probe.special_inputs(HW, N, seed)
    src = srcs[0]
    got = G.gather_rows_reference(torch.from_numpy(src), torch.from_numpy(idx))
    want = jnp.take(jnp.asarray(src), jnp.asarray(idx), axis=0, mode="clip")
    np.testing.assert_array_equal(bits(got), bits(want))
    np.testing.assert_array_equal(bits(got),
                                  bits(src[np.clip(idx, 0, HW - 1)]))


def test_gather_rows3_plain_matches_jax():
    # take_along_axis wraps negative indices
    srcs, idx = gather_probe.special_inputs(HW, N, 5, negative=False)
    got = G.gather_rows3_reference([torch.from_numpy(s) for s in srcs],
                                   torch.from_numpy(idx))
    assert len(got) == 3
    for g, s in zip(got, srcs):
        ixb = jnp.broadcast_to(jnp.asarray(idx)[:, None], (N, COLS))
        want = jnp.take_along_axis(jnp.asarray(s), ixb, axis=0, mode="clip")
        np.testing.assert_array_equal(bits(g), bits(want))


def test_gather_lane_plain_matches_jax_take_along_lanes():
    """The transposed form of the JAX probe: srcT (8, HW) gathered along
    lanes, returned as .T."""
    srcs, idx = gather_probe.special_inputs(HW, N, 7, negative=False)
    src = srcs[0]
    got = G.gather_lane_reference(torch.from_numpy(src), torch.from_numpy(idx))
    ixb = jnp.broadcast_to(jnp.asarray(idx)[None, :], (COLS, N))
    want = jnp.take_along_axis(jnp.asarray(src).T, ixb, axis=1,
                               mode="clip").T
    assert got.shape == (N, COLS)
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("n", [0, 1, 257])
def test_wrappers_on_cpu_run_plain_versions_without_launch(n):
    srcs, idx = gather_probe.special_inputs(HW, n, 9)
    srcs = [torch.from_numpy(s) for s in srcs]
    idx = torch.from_numpy(idx)
    before = [fn.launches for fn in (G.gather_rows, G.gather_rows3,
                                     G.gather_lane)]
    rows = G.gather_rows(srcs[0], idx)
    rows3 = G.gather_rows3(srcs, idx)
    lane = G.gather_lane(srcs[0], idx)
    assert [fn.launches for fn in (G.gather_rows, G.gather_rows3,
                                   G.gather_lane)] == before
    want = [s.numpy()[np.clip(idx.numpy(), 0, HW - 1)] for s in srcs]
    np.testing.assert_array_equal(bits(rows), bits(want[0]))
    np.testing.assert_array_equal(bits(lane), bits(want[0]))
    for g, w in zip(rows3, want):
        np.testing.assert_array_equal(bits(g), bits(w))


def test_probe_runs_plain_variants_and_refuses_kernels_off_card(capsys):
    cpu = torch.device("cpu")
    inputs = gather_probe.make_inputs(cpu, hw=HW, n=N)
    for variant in ("plain", "plain3"):
        times = gather_probe.run_variant(variant, inputs, cpu)
        assert times["host_ms"] > 0 and times["device_ms"] is None
    assert "bit-identical" in capsys.readouterr().out
    with pytest.raises(ValueError):
        gather_probe.run_variant("kernel", inputs, cpu)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("hw,n", [(HW, 1), (HW, 257), (97, 4099),
                                  (gather_probe.HW, 4099),
                                  (gather_probe.HW, gather_probe.N)])
def test_kernels_match_plain_versions_on_card(cuda_device, hw, n):
    srcs, idx = gather_probe.special_inputs(hw, n, 11)
    srcs = [torch.from_numpy(s).to(cuda_device) for s in srcs]
    idx = torch.from_numpy(idx).to(cuda_device)
    before = G.gather_rows.launches
    got = [G.gather_rows(srcs[0], idx), G.gather_lane(srcs[0], idx),
           *G.gather_rows3(srcs, idx)]
    torch.cuda.synchronize()
    assert G.gather_rows.launches == before + 1
    want = [G.gather_rows_reference(srcs[0], idx)] * 2 + \
        list(G.gather_rows3_reference(srcs, idx))
    for g, w in zip(got, want):
        assert torch.equal(g.contiguous().view(torch.int32),
                           w.view(torch.int32))


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(cuda_device):
    src = torch.zeros((HW, COLS), device=cuda_device)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        G.gather_rows(src, idx.long())                  # not int32
    with pytest.raises(ValueError):
        G.gather_rows(src[:, :4].contiguous(), idx)     # not 8 columns
    with pytest.raises(ValueError):
        G.gather_rows(src.double(), idx)
    with pytest.raises(ValueError):
        G.gather_rows3([src, src], idx)
