"""Asynchronous meshing for the port.

The meshing driver and its native engine are host code of the JAX package
(surfelmeshing_tpu/meshing/driver.py, engine.py; the engine library is
built with `make` in surfelmeshing_tpu/native at first use).  The port
uses them as they are; its driver overrides only `export_obj`, whose
reference version imports the JAX package's export_vertices.
"""

from __future__ import annotations

import numpy as np

from surfelmeshing_tpu.io.mesh_io import write_obj
from surfelmeshing_tpu.meshing import driver


class MeshingDriver(driver.MeshingDriver):
    """The reference's asynchronous meshing thread, fed by the port's
    ReconstructionPipeline.snapshot_for_meshing."""

    def export_obj(self, path: str, pipe) -> None:
        """Write the final mesh as OBJ (SaveMeshAsOBJ, main.cc:128-176):
        vertices from the fusion state (smoothed positions and colors,
        merged slots remapped away), indices from the mesher."""
        positions, colors = pipe.export_vertices()
        tris = self.engine.get_triangles().astype(np.int64)
        alive = ~np.isnan(positions[:, 0])
        remap = np.cumsum(alive) - 1
        keep = alive[tris].all(axis=1) if len(tris) else np.zeros(0, bool)
        tris_remapped = remap[tris[keep]] if len(tris) else tris
        write_obj(path, positions[alive], tris_remapped, colors[alive])
