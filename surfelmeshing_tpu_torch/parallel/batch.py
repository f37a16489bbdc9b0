"""Batched multi-sequence reconstruction on one device.

Counterpart of surfelmeshing_tpu/parallel/batch.py.  The scale-out axis is
sequences: S independent RGB-D streams, each with its own surfel map.  The
JAX package vmaps the frame step over a leading sequence axis sharded over
a device mesh; here the S states are held as a tuple (PyTorch has no vmap
over this step, and restacking a leading axis would copy every state every
frame) and each sequence goes through integrate_frame in turn, on the
current stream.  Sequences share nothing, so each state equals the state
of that sequence fused alone, bit for bit.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from .. import resolve_device
from ..ops.fusion import (FusionParams, SurfelState, create_surfel_state,
                          integrate_frame)
from ..ops.preprocess import preprocess_frame


def create_batched_state(num_sequences: int, capacity: int,
                         device) -> Tuple[SurfelState, ...]:
    """S independent empty surfel maps of `capacity` rows on `device`."""
    return tuple(create_surfel_state(capacity, device)
                 for _ in range(num_sequences))


def make_batched_step(params: Union[FusionParams, Sequence[FusionParams]],
                      device):
    """-> step(states, depth_S, normals_S, radius_S, color_S, T_gl_S,
    T_lg_S, frame_index) -> (states, total).

    `params` serves every sequence, or is a sequence of FusionParams, one
    per sequence (each sequence's own camera).  Every input carries a
    leading sequence axis and is moved to `device`; sequence s is fused
    into states[s].  `total`, the sum of the surfel counts (the JAX step's
    psum, its only collective), stays on the device: the step never
    synchronises with the host."""
    device = resolve_device(device)

    def step(states, depth, normals_xy, radius_img, color, t_gl, t_lg,
             frame_index: int):
        inputs = [t.to(device) for t in (depth, normals_xy, radius_img,
                                         color, t_gl, t_lg)]
        per_seq = [params] * len(states) \
            if isinstance(params, FusionParams) else params
        new = tuple(integrate_frame(st, *(t[s] for t in inputs),
                                    frame_index, per_seq[s])
                    for s, st in enumerate(states))
        total = torch.stack([st.surfel_count for st in new]) \
            .sum(dtype=torch.int32)
        return new, total

    return step


def make_batched_preprocess(pp_kwargs: Union[dict, Sequence[dict]],
                            device):
    """-> preprocess(depth_S, others_S, T_S) -> (depth_S, normals_S,
    radius_S): preprocess_frame over each sequence with `pp_kwargs` (one
    dict for every sequence, or one per sequence), outputs stacked along
    the leading sequence axis."""
    device = resolve_device(device)

    def preprocess(depth, others, transforms):
        depth, others, transforms = (t.to(device)
                                     for t in (depth, others, transforms))
        n = depth.shape[0]
        per_seq = [pp_kwargs] * n if isinstance(pp_kwargs, dict) \
            else pp_kwargs
        outs = [preprocess_frame(depth[s], others[s], transforms[s],
                                 **per_seq[s])
                for s in range(n)]
        return tuple(torch.stack(o) for o in zip(*outs))

    return preprocess
