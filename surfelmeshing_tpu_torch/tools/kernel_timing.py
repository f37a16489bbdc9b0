"""Times of one call of a step on the card: its device time and its
host-inclusive time.

device_ms: the step is warmed up, R calls of it are captured in one
  torch.cuda.CUDAGraph, and the graph is replayed between two CUDA events;
  the elapsed time over R is the device time of one call, free of the
  host's checks, allocations and launch cost.
host_ms: R back-to-back Python calls between two CUDA events, as a caller
  that launches eagerly sees them (the host clock off the card).

Inputs stay where they are between calls, so a step finds them in the L2
cache when they fit, as the frame step does for the maps it has just
written.

l2_read_bytes_per_s: the card's L2-to-SM read rate, from csrc/l2_read.cu
  (a streaming read of an L2-resident buffer) timed by device_ms; the
  gathers' sector bounds divide by it.
"""

from __future__ import annotations

import ctypes
import functools
import time

import torch

from ..ops import cuda_build

REPEATS = 30
WARMUP = 3


def host_ms(step, device, repeats: int = REPEATS,
            warmup: int = WARMUP) -> float:
    """ms per call over `repeats` back-to-back calls of `step` after
    `warmup`: CUDA events on the card, the host clock elsewhere."""
    for _ in range(warmup):
        step()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(repeats):
            step()
        return 1000.0 * (time.perf_counter() - t0) / repeats
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        step()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / repeats


def device_ms(step, repeats: int = REPEATS, warmup: int = WARMUP) -> float:
    """Device ms per call of `step` on the current CUDA device: `repeats`
    calls captured in one CUDA graph, replayed once to warm up and once
    between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(repeats):
            step()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / repeats


@functools.lru_cache(maxsize=None)
def load_l2_read_library() -> ctypes.CDLL:
    """csrc/l2_read.cu, built on first use and loaded once."""
    lib = ctypes.CDLL(str(cuda_build.build("l2_read")))
    lib.l2_read_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_void_p]
    lib.l2_read_launch.restype = ctypes.c_int
    return lib


def l2_read_bytes_per_s(device, megabytes: int = 16,
                        passes: int = 8) -> float:
    """Bytes/s of `passes` streaming reads of a `megabytes` buffer that
    stays in L2, 8 blocks an SM, timed by device_ms."""
    nvec = megabytes * 2 ** 20 // 16
    buf = torch.randint(0, 2 ** 30, (nvec * 4,), dtype=torch.int32,
                        device=device)
    sink = torch.zeros(4, dtype=torch.int32, device=device)
    blocks = 8 * torch.cuda.get_device_properties(device).multi_processor_count
    lib = load_l2_read_library()

    def step():
        err = lib.l2_read_launch(buf.data_ptr(), nvec, passes,
                                 sink.data_ptr(), blocks,
                                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"l2_read launch failed: CUDA error {err}")

    ms = device_ms(step, 20)
    return 16.0 * nvec * passes / (ms / 1000.0)
