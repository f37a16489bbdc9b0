"""Device times of the blending kernels at chosen radii on chip_smoke's
seeded 640x480 maps, on the card.

    python surfelmeshing_tpu_torch/tools/blend_timing.py [--root DIR]
        [--label NAME] [--radii 12 48] [--wide-radii 16 24 32]
        [--repeats 3]

--radii go through blend_core, which takes the one-launch kernel up to
MAX_RADIUS and the wide path above it; --wide-radii through blend_wide,
the wide path at any radius (where the checkout has it).  Each time is
the device time of one call (tools/kernel_timing.py: 30 calls in a CUDA
graph replayed between CUDA events), taken --repeats times.  --root
imports the port from another checkout, such as a git archive of an
earlier commit: to compare two commits on one card, run parent, change,
change, parent in one session.  Run the file by its path, so that --root
decides which package is imported.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch


def seeded_maps(h: int, w: int, seed: int, device) -> list:
    """chip_smoke.py's random_maps: 70% supported, depth 0 one pixel in
    600."""
    rng = np.random.default_rng(seed)
    depth_f = (rng.integers(0, 3, (h, w)) * 5000 +
               rng.integers(0, 200, (h, w))).astype(np.float32)
    supported = (rng.random((h, w)) < 0.7).astype(np.float32)
    valid = (depth_f > 0).astype(np.float32)
    avg = (depth_f / 5000.0 +
           0.01 * rng.standard_normal((h, w))).astype(np.float32)
    return [torch.from_numpy(m).to(device)
            for m in (depth_f, supported, valid, avg)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    p.add_argument("--label", default="")
    p.add_argument("--radii", type=int, nargs="*", default=[12, 48])
    p.add_argument("--wide-radii", type=int, nargs="*", default=[])
    p.add_argument("--repeats", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("blend_timing: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.root)
    from surfelmeshing_tpu_torch.ops import blend
    from surfelmeshing_tpu_torch.tools import kernel_timing
    maps = seeded_maps(480, 640, 2, torch.device("cuda"))
    calls = [("blend_core", blend.blend_core, r) for r in args.radii]
    calls += [("blend_wide", blend.blend_wide, r) for r in args.wide_radii]
    for name, fn, radius in calls:
        want = blend.blend_core_reference(*maps, radius, 5000.0)
        got = fn(*maps, radius, 5000.0)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise RuntimeError(f"{name} differs from the plain version at "
                               f"radius {radius}")
        ms = [kernel_timing.device_ms(
            lambda: fn(*maps, radius, 5000.0), 30)
            for _ in range(args.repeats)]
        print(f"{args.label} {name} radius {radius}: device ms " +
              " ".join(f"{m:.4f}" for m in ms), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
