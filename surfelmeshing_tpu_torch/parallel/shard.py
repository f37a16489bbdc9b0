"""One surfel map sharded over the surfel axis of a process group.

Counterpart of surfelmeshing_tpu/parallel/shard.py.  Every rank holds
capacity / D consecutive rows of the map (rank r holds global rows
[r * capacity / D, (r + 1) * capacity / D)), runs every per-surfel phase
over its own rows and repeats the image-domain work, which is identical on
every rank.  Per frame the ranks exchange (ops/fusion.py::_Sharding):
- all-reduces of the per-pixel scatter maps right after the local scatter:
  MIN for the min-depth raster, the supporter claims and (under
  exact_conflict_arbitration) the conflictor claims, SUM for the packed
  count + depth-sum map and for the frame's merge count;
- all-gathers of the pack where gathers address rows by global index: the
  merge lookup at the top of the frame, the neighbor candidates and
  creation after phase 5, and each regularization iteration.
A creation is written by the rank that owns its row, and surfel_count and
overflow_count come from the replicated image-domain work, so they need
no collective.  The result equals integrate_frame on the whole map bit for
bit (tests/test_torch_parallel.py).

Collectives go through torch.distributed with the caller's process group;
gloo runs them on CPU and CUDA tensors (NCCL refuses two ranks on one
GPU).  spawn_sharded runs the step in D spawned gloo ranks on this host.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import multiprocessing.connection
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..ops import blend
from ..ops.fusion import (FusionParams, SurfelState, _integrate_body,
                          _Sharding, create_surfel_state, state_to_numpy)


def create_sharded_state(capacity: int, group: Optional[dist.ProcessGroup],
                         device) -> SurfelState:
    """This rank's capacity / D rows of an empty map (pack rows and the
    matching columns of neighbors and nbr_dist; every row of an empty map
    is the same)."""
    world = dist.get_world_size(group)
    if capacity % world:
        raise ValueError(f"capacity ({capacity}) must divide evenly over "
                         f"the {world} ranks of the process group")
    return create_surfel_state(capacity // world, device)


def make_sharded_step(params: FusionParams,
                      group: Optional[dist.ProcessGroup] = None):
    """-> step(state, depth, normals_xy, radius_img, color, T_gl, T_lg,
    frame_index) -> state, over this rank's rows (`state`, from
    create_sharded_state) with every other input replicated on the
    state's device.  Semantics of integrate_frame on the whole map."""
    if params.active_surfel_budget:
        raise ValueError("surfel-axis sharding and active-set tiling are "
                         "separate dispatch modes; set active_surfel_budget=0")
    if not params.symmetric_regularization:
        # The exact cross terms are summed in one stream order over global
        # rows (_ordered_scatter_add); a sum across ranks cannot keep it.
        raise ValueError("surfel-axis sharding requires "
                         "symmetric_regularization")

    def step(state, depth, normals_xy, radius_img, color, t_gl, t_lg,
             frame_index: int) -> SurfelState:
        shard = _Sharding(group, dist.get_world_size(group),
                          dist.get_rank(group) * state.pack.shape[0])
        return _integrate_body(state, depth, normals_xy, radius_img, color,
                               t_gl, t_lg, frame_index, params, None,
                               shard=shard)

    return step


def gather_state(state: SurfelState,
                 group: Optional[dist.ProcessGroup] = None) -> SurfelState:
    """The whole map on every rank: pack rows and neighbor columns
    all-gathered in rank order; the counters are the same on every rank."""
    shard = _Sharding(group, dist.get_world_size(group), 0)
    return dataclasses.replace(
        state, pack=shard.all_gather(state.pack),
        neighbors=shard.all_gather(state.neighbors.t()).t(),
        nbr_dist=shard.all_gather(state.nbr_dist.t()).t())


def _rank_main(rank: int, world_size: int, store: str,
               params: FusionParams, capacity: int, frames, device: str,
               out: str) -> None:
    """One spawned rank of spawn_sharded."""
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=300))
    try:
        dev = resolve_device(device)
        torch.set_num_threads(max(1, torch.get_num_threads() // world_size))
        step = make_sharded_step(params)
        state = create_sharded_state(capacity, None, dev)
        inputs = [tuple(torch.from_numpy(a).to(dev) for a in f[:6]) + (f[6],)
                  for f in frames]
        launches = blend.blend_core.launches
        times = []
        for f in inputs:
            dist.barrier()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state = step(state, *f)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
        whole = state_to_numpy(gather_state(state))
        counts = _Sharding(None, world_size, 0).all_gather(torch.tensor(
            [blend.blend_core.launches - launches]))
        if rank == 0:
            np.savez(out, **whole, frame_seconds=np.array(times),
                     blend_launches=counts.numpy())
    finally:
        dist.destroy_process_group()


def spawn_sharded(params: FusionParams, capacity: int, frames: Sequence,
                  world_size: int, device, workdir: Optional[str] = None,
                  timeout: float = 600.0) -> dict:
    """Fuse `frames` into one map of `capacity` rows sharded over
    `world_size` spawned gloo ranks on this host, every rank on `device`.

    frames: (depth, normals_xy, radius_img, color, T_gl, T_lg,
    frame_index) per frame, arrays or tensors.  The ranks meet through a
    file:// store in a temporary directory under `workdir`.  -> the whole
    map as host arrays under the SurfelState field names, plus
    `frame_seconds` (rank 0's host time of each frame, the device
    synchronised around it) and `blend_launches` (each rank's blending
    kernel launches).  Raises RuntimeError when a rank fails or the run
    outlasts `timeout` seconds; every rank is stopped before it returns."""
    device = str(resolve_device(device))
    frames = [tuple(np.ascontiguousarray(torch.as_tensor(a).cpu().numpy())
                    for a in f[:6]) + (int(f[6]),) for f in frames]
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        store = os.path.join(tmp, "store")
        out = os.path.join(tmp, "state.npz")
        procs = [ctx.Process(target=_rank_main, args=(
            rank, world_size, store, params, capacity, frames, device, out))
            for rank in range(world_size)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout
            running = list(procs)
            while running and time.monotonic() < deadline:
                multiprocessing.connection.wait(
                    [p.sentinel for p in running],
                    max(deadline - time.monotonic(), 0.0))
                running = [p for p in running if p.exitcode is None]
                if any(p.exitcode for p in procs):
                    break
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"sharded ranks exited with {codes}")
        with np.load(out) as result:
            return dict(result)
