"""Reconstruction checkpoint / resume, in the JAX package's npz format.

Version 4 of surfelmeshing_tpu/io/checkpoint.py: one compressed npz with
`version`, `frame_index` and one array per state field, the tiled path's
skipped_tile_count and active_tile_count included.  Checkpoints
interchange both ways; a missing scalar counter loads as 0, as in the JAX
package (whose state has no deferred_count: its loader skips it).  The
meshing engine is rebuilt from the fused surfels on resume.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops.fusion import SurfelState, state_from_numpy, state_to_numpy

FORMAT_VERSION = 4    # v4 adds the nbr_dist stored-slot-distance array
_COUNTERS = ("surfel_count", "merge_count", "overflow_count",
             "deferred_count", "skipped_tile_count", "active_tile_count")


def save_checkpoint(path: str, state: SurfelState, frame_index: int) -> None:
    np.savez_compressed(path, version=FORMAT_VERSION,
                        frame_index=frame_index, **state_to_numpy(state))


def load_checkpoint(path: str, device):
    """-> (SurfelState on `device`, frame_index)."""
    with np.load(path) as data:
        if int(data["version"]) != FORMAT_VERSION:
            # Older versions used another pack column order / neighbor
            # layout; there is no migration path.
            raise ValueError(
                f"unsupported checkpoint version {data['version']}")
        fields = {}
        for f in dataclasses.fields(SurfelState):
            if f.name in data:
                fields[f.name] = data[f.name]
            elif f.name in _COUNTERS:
                fields[f.name] = np.zeros((), np.int32)
            else:
                raise ValueError(f"checkpoint {path} has no {f.name!r}")
        frame_index = int(data["frame_index"])
    return state_from_numpy(device=device, **fields), frame_index
