"""Where a call of the wide blending path spends its time, slot by slot,
on the card.

    python -m surfelmeshing_tpu_torch.tools.blend_wide_profile
        [--radius 48] [--chunk T] [--core-h ROWS] [--width 640]
        [--height 480] [--seed 2]

Builds csrc/blend_wide.cu with -DBLEND_WIDE_PROFILE (clock64 stamps in
device memory; the library blend_core loads has none) into build/kernels/,
runs the wide path once on chip_smoke's seeded maps, holds it bit for bit
to the plain version, and prints for each chunk launch the median over
its blocks (SM clock cycles) of:

  load       start to the first slot (for the first chunk with the border
             iteration's mask stage);
  mask       a slot's start to the end of its mask stage (thread 0, a
             warp of the mask stage);
  float end  the slot's start to the end of its float stage (the block's
             last thread, a float warp);
  barrier    the slot's start to thread 0 leaving its closing barrier;
  listed     the pixels the float stage took;
  writeback  the last slot's end to the block's end;

and each chunk's slowest block, which sets the launch's time.  Stamps of
one thread in one SM share its clock; cycles over the SM clock
(nvidia-smi clocks.max.sm) are an upper bound of the time.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys

import numpy as np
import torch

from ..ops import blend, cuda_build
from .blend_timing import seeded_maps

# csrc/blend_wide.cu's kProfileChunks, kProfileBlocks, kProfileWords.
CHUNKS, BLOCKS, WORDS = 16, 1024, 80


def load_profiled() -> ctypes.CDLL:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    path = cuda_build.cached_build(
        "blend_wide_profile", nvcc,
        [*cuda_build.NVCC_FLAGS, "-DBLEND_WIDE_PROFILE"],
        [cuda_build.CSRC / "blend_wide.cu"],
        headers=sorted(cuda_build.CSRC.glob("*.cuh")))
    lib = ctypes.CDLL(str(path))
    lib.blend_wide_launch.argtypes = \
        blend.load_wide_library().blend_wide_launch.argtypes
    lib.blend_wide_launch.restype = ctypes.c_int
    lib.blend_wide_profile_read.argtypes = [ctypes.c_void_p]
    for fn in (lib.blend_wide_configure, lib.blend_wide_profile_read):
        fn.restype = ctypes.c_int
    if lib.blend_wide_configure() != 0:
        raise RuntimeError("cudaFuncSetAttribute failed")
    return lib


def run(radius, chunk, core_h, maps, scale=5000.0) -> np.ndarray:
    """One profiled call; -> the stamps (CHUNKS, BLOCKS, WORDS)."""
    lib = load_profiled()
    h, w = maps[0].shape
    out = torch.empty_like(maps[0])
    scratch = torch.empty(blend.WIDE_SCRATCH_PLANES * h * w + radius,
                          dtype=torch.int32, device=maps[0].device)
    stamps = np.zeros(CHUNKS * BLOCKS * WORDS, np.int64)
    lib.blend_wide_profile_read(stamps.ctypes.data)      # clears them
    kernels = ctypes.c_int(0)
    err = lib.blend_wide_launch(
        *[m.data_ptr() for m in (*maps, out)], scratch.data_ptr(), h, w,
        radius, chunk, core_h, scale,
        torch.cuda.current_stream().cuda_stream, ctypes.byref(kernels))
    torch.cuda.synchronize()
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    want = blend.blend_core_reference(*maps, radius, scale)
    if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
        raise RuntimeError("the profiled build differs from the plain "
                           "version")
    if lib.blend_wide_profile_read(stamps.ctypes.data) != 0:
        raise RuntimeError("reading the stamps failed")
    print(f"radius {radius}, T {chunk}, core {64 - 2 * chunk} x {core_h}, "
          f"{w}x{h}: {kernels.value} chunk kernels, bit-identical to the "
          f"plain version")
    return stamps.reshape(CHUNKS, BLOCKS, WORDS)[:kernels.value]


def report(stamps: np.ndarray, blocks: int) -> None:
    def med(x):
        return f"{np.median(x):.0f}" if len(x) else "-"
    for c, chunk_stamps in enumerate(stamps):
        b = chunk_stamps[:blocks]
        ran = b[:, 2] > 0                   # blocks that did not skip
        if not ran.any():
            print(f"chunk {c}: skipped (device flag)")
            continue
        b = b[ran]
        total = b[:, 2] - b[:, 0]
        print(f"chunk {c}: {ran.sum()} blocks ran; cycles median "
              f"{med(total)}, slowest {total.max()}; load "
              f"{med(b[:, 1] - b[:, 0])}")
        start = b[:, 1]
        for s in range((WORDS - 3) // 4):
            mask, fend, bar, listed = (b[:, 3 + 4 * s + j] for j in range(4))
            live = bar > 0
            if not live.any():
                break
            print(f"  slot {s:2d}: {live.sum():4d} blocks; mask "
                  f"{med((mask - start)[live])}, float end "
                  f"{med((fend - start)[live])}, barrier "
                  f"{med((bar - start)[live])}; listed median "
                  f"{med(listed[live])}, max {listed[live].max()}")
            start = np.where(live, bar, start)
        print(f"  writeback {med(b[:, 2] - start)}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--radius", type=int, default=48)
    p.add_argument("--chunk", type=int, default=blend.WIDE_CHUNK)
    p.add_argument("--core-h", type=int, default=blend.WIDE_CORE_H)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--seed", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("blend_wide_profile: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip())
    maps = seeded_maps(args.height, args.width, args.seed,
                       torch.device("cuda"))
    core_w = 64 - 2 * args.chunk
    blocks = (-(-args.width // core_w)) * (-(-args.height // args.core_h))
    if blocks > BLOCKS:
        print(f"blend_wide_profile: {blocks} blocks, stamps kept for "
              f"{BLOCKS}", file=sys.stderr)
        return 1
    report(run(args.radius, args.chunk, args.core_h, maps), blocks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
