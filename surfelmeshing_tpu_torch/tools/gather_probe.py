"""Gather-rate probe: the hand-written CUDA row gathers against plain
PyTorch indexing and torch.index_select on the card.

    python -m surfelmeshing_tpu_torch.tools.gather_probe [--device cuda]
        [variant ...]

Counterpart of tools/gather_probe.py, at its sizes: a (307,200, 8) f32
source (one 640x480 image of 8-wide rows) gathered by 500,736 int32
indices.  Variants, with the JAX probe's names they stand for:

  plain        xla          src[idx], plain PyTorch indexing
  plain3       xla3         three sources, three plain gathers
  kernel       pallas       ops.gather.gather_rows (csrc/gather.cu)
  kernel3      pallas3      ops.gather.gather_rows3, one launch for three
  kernel_lane  pallas_lane  ops.gather.gather_lane, (8, HW) source layout
  library      -            torch.index_select(src, 0, idx), the one
                            PyTorch call for gather_rows (a yardstick: the
                            port never calls it)
  library_lane -            torch.index_select(src_t, 1, idx) on the
                            (8, HW) layout, the one call for gather_lane
  library3     -            three torch.index_select(src, 0, idx) calls
                            beside gather_rows3 (three calls: no one
                            PyTorch call computes it, so no yardstick)

Inputs come from numpy with the fixed seed SEED: a normal source, src*2,
src*3, and indices uniform in [0, HW).  Each variant first checks its
output bit for bit against the plain gather, then is timed after a
warm-up (tools/kernel_timing.py): on the card its device time (REPEATS
calls captured in a CUDA graph and replayed between CUDA events) and its
host-inclusive time (REPEATS back-to-back calls between CUDA events);
elsewhere the host clock.  It prints ms/gather-step and M idx/s (three
index streams for the *3 variants).  A variant that fails or disagrees
ends the run with a non-zero exit; the kernel variants raise on a device
other than CUDA.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import resolve_device
from ..ops import gather as G
from . import kernel_timing

HW = 307_200          # 640*480
N = 500_736           # padded surfel count of the JAX probe
COLS = G.COLS
REPEATS = kernel_timing.REPEATS
VARIANTS = ("plain", "kernel", "plain3", "kernel3", "kernel_lane", "library",
            "library_lane", "library3")
SEED = 0


def make_inputs(device, hw: int = HW, n: int = N):
    """(src, src*2, src*3, idx) on `device`, from numpy with SEED."""
    rng = np.random.default_rng(SEED)
    src = rng.standard_normal((hw, COLS)).astype(np.float32)
    idx = rng.integers(0, hw, n).astype(np.int32)
    srcs = [torch.from_numpy(s).to(device) for s in (src, src * 2, src * 3)]
    return srcs[0], srcs[1], srcs[2], torch.from_numpy(idx).to(device)


def special_inputs(hw: int, n: int, seed: int, negative: bool = True):
    """Edge-case numpy inputs for the bit-exact checks: three (hw, 8) f32
    sources (base, 2*base, 3*base) whose first rows carry the INVALID_INDEX
    NaN pattern, -0.0, NaN payloads and a denormal, and n int32 indices
    whose first entries lie on and beyond both ends of [0, hw) (beyond the
    low end only when `negative`).  -> (sources, idx)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((hw, COLS)).astype(np.float32)
    srcs = []
    for k in (1, 2, 3):
        src = base * np.float32(k)
        bits = src.view(np.int32)
        bits[0] = 2 ** 31 - 1                       # INVALID_INDEX
        bits[1] = np.int32(-2 ** 31)                # -0.0
        bits[2] = 0x7FA00001 + k                    # signalling NaN
        bits[3] = np.uint32(0xFFC00123).view(np.int32)
        bits[4] = k                                 # denormal
        srcs.append(src)
    idx = rng.integers(0, hw, n).astype(np.int64)
    special = [hw + 5, 0, 1, 2, 3, 4, hw - 1, hw, 2 ** 31 - 1]
    if negative:
        special += [-1, -hw - 3, -2 ** 31]
    idx[:min(n, len(special))] = special[:n]
    return srcs, idx.astype(np.int32)


def variant_fns(src, src2, src3, idx):
    """variant -> zero-argument step returning its list of outputs."""
    lane_src = src.t().contiguous().t()     # laid out (8, HW) once
    return {
        "plain": lambda: [G.gather_rows_reference(src, idx)],
        "plain3": lambda: list(G.gather_rows3_reference((src, src2, src3),
                                                        idx)),
        "kernel": lambda: [G.gather_rows(src, idx)],
        "kernel3": lambda: list(G.gather_rows3((src, src2, src3), idx)),
        "kernel_lane": lambda: [G.gather_lane(lane_src, idx)],
        "library": lambda: [torch.index_select(src, 0, idx)],
        "library_lane": lambda: [
            torch.index_select(lane_src.t(), 1, idx).t()],
        "library3": lambda: [torch.index_select(s, 0, idx)
                             for s in (src, src2, src3)],
    }


def run_variant(variant: str, inputs, device) -> dict:
    """Check one variant bit for bit, time it and print its line; returns
    {"device_ms", "host_ms"} per gather-step (device_ms None off the
    card)."""
    src, src2, src3, idx = inputs
    if variant.startswith("kernel") and device.type != "cuda":
        raise ValueError(f"{variant}: the kernels run on a CUDA device, "
                         f"not {device}")
    step = variant_fns(*inputs)[variant]
    got = step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    want = [G.gather_rows_reference(s, idx) for s in (src, src2, src3)]
    for g, w in zip(got, want):
        if not torch.equal(g.contiguous().view(torch.int32),
                           w.view(torch.int32)):
            raise AssertionError(f"{variant}: gather mismatch")
    times = {"device_ms": None,
             "host_ms": kernel_timing.host_ms(step, device, REPEATS)}
    streams = len(got)
    rate = idx.shape[0] * streams / 1e3
    if device.type == "cuda":
        times["device_ms"] = kernel_timing.device_ms(step, REPEATS)
        print(f"{variant:12s}: {times['device_ms']:8.4f} ms/gather-step "
              f"device ({rate / times['device_ms']:.0f}M idx/s, CUDA graph "
              f"replay), {times['host_ms']:8.4f} host-inclusive (CUDA "
              f"events), bit-identical to plain")
    else:
        print(f"{variant:12s}: {times['host_ms']:8.4f} ms/gather-step "
              f"({rate / times['host_ms']:.0f}M idx/s, host clock, "
              f"bit-identical to plain)")
    return times


def run_probe(device, variants=VARIANTS) -> dict:
    """Every variant on one set of inputs; -> {variant: run_variant's
    times}."""
    inputs = make_inputs(device)
    return {v: run_variant(v, inputs, device) for v in variants}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*", choices=VARIANTS,
                        metavar="variant", help=f"any of {VARIANTS}")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}")
    run_probe(device, args.variants or VARIANTS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
