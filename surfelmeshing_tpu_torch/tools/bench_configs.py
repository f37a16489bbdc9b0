"""Fusion timing sweep across capacities / active-set budgets on one GPU
(the counterpart of tools/bench_configs.py of the JAX package).

    python -m surfelmeshing_tpu_torch.tools.bench_configs \
        [--trajectory NAME] [--device cuda|cpu] [CAP[:BUDGET] ...]

A config is "CAP[:BUDGET]", e.g. "500k" "2m:2m" "20m:2m" "20m:-1"
(default: 500k 2m:2m 20m:2m).  BUDGET absent or 0 runs the full shape; -1
is the auto budget that tracks the lagged visible-set tile demand (the
pipeline's --active_surfel_budget -1 policy).  Each config fuses 6
warm-up frames and then times the rest of BenchEnv's 40-frame sequence on
the host clock, ending in a device synchronisation.

Prints one JSON line per config with the JAX tool's keys, plus the run's
counters: peak_mib (peak device memory allocated, null on the CPU),
fused_frames and blend_launches (launches of csrc/blend.cu; 0 on the CPU,
where blending runs its plain version).  The device defaults to cuda and
the tool fails without a GPU.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..ops import blend
from ..ops.fusion import create_surfel_state
from .bench_configs_common import (AutoBudgetPolicy, BenchEnv, parse_size,
                                   peak_mib)

TILE = 4096
WARMUP = 6


def run_config(cfg: str, env: BenchEnv, trajectory: str) -> dict:
    device = env.device
    parts = cfg.split(":")
    cap = parse_size(parts[0])
    budget = parse_size(parts[1]) if len(parts) > 1 else 0
    if budget:
        cap = (cap + TILE - 1) // TILE * TILE
    auto = budget == -1
    params = env.make_params(budget=budget, tile=TILE)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = create_surfel_state(cap, device)
    policy = AutoBudgetPolicy(cap, TILE, params.max_creations_per_frame,
                              env.W, env.H) if auto else None
    launches = blend.blend_core.launches

    def step(state, i):
        p = policy.params_for_frame(params) if auto else params
        state = env.step(state, i, p)
        if auto:
            policy.observe(state)
        return state

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    lo, hi = env.lo, env.hi
    for i in range(lo, lo + WARMUP):
        state = step(state, i)
    sync()

    t0 = time.perf_counter()
    n = 0
    for i in range(lo + WARMUP, hi):
        state = step(state, i)
        n += 1
    sync()
    elapsed = time.perf_counter() - t0
    return {
        "config": cfg, "capacity": cap, "budget": budget,
        "trajectory": trajectory,
        "fps": round(n / elapsed, 2),
        "ms_per_frame": round(1000 * elapsed / n, 1),
        "surfels": int(state.surfel_count),
        "skipped_tiles": int(state.skipped_tile_count),
        **({"budgets_used": sorted(policy.budgets_used),
            "final_active_tiles": int(state.active_tile_count)}
           if auto else {}),
        "peak_mib": peak_mib(device),
        "fused_frames": WARMUP + n,
        "blend_launches": blend.blend_core.launches - launches,
    }


def main(argv=None) -> list:
    """Run the configs; prints and returns one result dict each."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trajectory", default="arc")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("configs", nargs="*",
                    default=["500k", "2m:2m", "20m:2m"])
    args = ap.parse_args(argv)
    env = BenchEnv(args.device, trajectory=args.trajectory)
    results = []
    for cfg in args.configs:
        results.append(run_config(cfg, env, args.trajectory))
        print(json.dumps(results[-1]), flush=True)
    return results


if __name__ == "__main__":
    main()
