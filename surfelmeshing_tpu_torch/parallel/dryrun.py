"""Dry run of both scale-out modes at a tiny size.

    python -m surfelmeshing_tpu_torch.parallel.dryrun --ranks N \
        [--device cuda|cpu]

The port's counterpart of the JAX package's multi-chip dry run
(__graft_entry__.py::dryrun_multichip): (1) the batched step over N
sequences at 32x24, whose surfel total must be N * (H - 2) * (W - 2);
(2) one map of N * 2048 rows sharded over N spawned gloo ranks, two
frames, whose pack and neighbors must equal the single-device state bit
for bit.  Exits 0 when both hold.  `--device` defaults to cuda.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..ops.fusion import FusionParams, create_surfel_state, integrate_frame
from .batch import create_batched_state, make_batched_step
from .shard import spawn_sharded

W, H = 32, 24
CAPACITY = 2048
IDENT = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]], np.float32)


def dryrun_params() -> FusionParams:
    return FusionParams(width=W, height=H, fx=30.0, fy=30.0,
                        cx=W / 2 + 0.5, cy=H / 2 + 0.5, depth_scaling=5000.0,
                        do_blending=True, regularization_iterations=1)


def batched_check(n: int, device) -> int:
    """One batched step over n flat sequences; -> the surfel total."""
    step = make_batched_step(dryrun_params(), device)
    states = create_batched_state(n, CAPACITY, device)
    inputs = (np.full((n, H, W), 10000, np.int32),
              np.zeros((n, 2, H, W), np.float32),
              np.full((n, H, W), 0.01, np.float32),
              np.full((n, 3, H, W), 100, np.uint8),
              np.tile(IDENT, (n, 1, 1)), np.tile(IDENT, (n, 1, 1)))
    states, total = step(states, *(torch.from_numpy(a) for a in inputs), 0)
    total = int(total)
    expected = n * (H - 2) * (W - 2)
    if total != expected:
        raise AssertionError(f"batched total {total} != {expected}")
    return total


def sharded_check(n: int, device) -> int:
    """Two frames of one map sharded over n spawned ranks against the
    single-device state; -> the surfel count."""
    params = dryrun_params()
    rng = np.random.default_rng(7)
    frames = []
    for frame in range(2):
        depth = (10000 + 150 * frame +
                 rng.integers(-250, 250, (H, W))).astype(np.int32)
        color = rng.integers(0, 255, (3, H, W)).astype(np.uint8)
        frames.append((depth, np.zeros((2, H, W), np.float32),
                       np.full((H, W), 0.01, np.float32), color, IDENT,
                       IDENT, frame))
    dev = resolve_device(device)
    ref = create_surfel_state(CAPACITY * n, dev)
    for f in frames:
        ref = integrate_frame(ref, *(torch.from_numpy(a).to(dev)
                                     for a in f[:6]), f[6], params)
    got = spawn_sharded(params, CAPACITY * n, frames, n, dev)
    count = int(ref.surfel_count)
    if int(got["surfel_count"]) != count or count == 0:
        raise AssertionError(f"sharded surfel count {int(got['surfel_count'])}"
                             f", single-device {count}")
    for name in ("pack", "neighbors"):
        want = getattr(ref, name).cpu().numpy()
        if not np.array_equal(got[name].view(np.int32), want.view(np.int32)):
            raise AssertionError(f"sharded {name} differs from the "
                                 f"single-device state")
    return count


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    total = batched_check(args.ranks, args.device)
    print(f"batched: {args.ranks} sequences at {W}x{H} on {args.device}, "
          f"{total} surfels in all")
    count = sharded_check(args.ranks, args.device)
    print(f"sharded: one map of {CAPACITY * args.ranks} rows over "
          f"{args.ranks} gloo ranks on {args.device}, 2 frames, {count} "
          f"surfels; pack and neighbors bit-identical to the single-device "
          f"state ({time.perf_counter() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
