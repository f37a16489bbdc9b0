"""Mesh / point-cloud export.

Matches the reference's output formats:
- OBJ: "v x y z [r g b]" lines (colors normalized to [0,1]) followed by
  1-based "f a b c" lines (libvis/src/libvis/mesh.h:106-129,
  point_cloud.h:557-582).
- PLY: binary little-endian, float x/y/z [+ uchar rgb] [+ float nx/ny/nz]
  (point_cloud.h:493-533).
"""

from __future__ import annotations

import io as _io
from typing import Optional

import numpy as np


def write_obj(path: str,
              vertices: np.ndarray,
              triangles: Optional[np.ndarray] = None,
              colors: Optional[np.ndarray] = None) -> None:
    """Write an OBJ mesh.

    vertices: (N, 3) float; triangles: (M, 3) int 0-based (written 1-based,
    CCW order preserved); colors: (N, 3) uint8, normalized like the reference
    (point_cloud.h:568-582).
    """
    vertices = np.asarray(vertices, dtype=np.float32)
    buf = _io.StringIO()
    if colors is not None:
        colors = np.asarray(colors, dtype=np.float64) / 255.0
        for (x, y, z), (r, g, b) in zip(vertices, colors):
            buf.write(f"v {x:g} {y:g} {z:g} {r:g} {g:g} {b:g}\n")
    else:
        for x, y, z in vertices:
            buf.write(f"v {x:g} {y:g} {z:g}\n")
    if triangles is not None:
        tris = np.asarray(triangles, dtype=np.int64) + 1
        for a, b, c in tris:
            buf.write(f"f {a} {b} {c}\n")
    with open(path, "wb") as f:
        f.write(buf.getvalue().encode("ascii"))


def write_ply(path: str,
              positions: np.ndarray,
              colors: Optional[np.ndarray] = None,
              normals: Optional[np.ndarray] = None) -> None:
    """Write a binary little-endian PLY point cloud (point_cloud.h:493-533)."""
    positions = np.ascontiguousarray(positions, dtype="<f4")
    n = positions.shape[0]

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    if normals is not None:
        header += ["property float nx", "property float ny",
                   "property float nz"]
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    header.append("end_header")

    rec = np.empty(n, dtype=np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = positions[:, 0], positions[:, 1], positions[:, 2]
    if colors is not None:
        colors = np.asarray(colors, dtype=np.uint8)
        rec["red"], rec["green"], rec["blue"] = (
            colors[:, 0], colors[:, 1], colors[:, 2])
    if normals is not None:
        normals = np.ascontiguousarray(normals, dtype="<f4")
        rec["nx"], rec["ny"], rec["nz"] = (
            normals[:, 0], normals[:, 1], normals[:, 2])

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


def read_ply(path: str):
    """Minimal binary-little-endian PLY reader (for tests / eval)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header_lines = data[:header_end].decode("ascii").splitlines()
    n = 0
    fields = []
    type_map = {"float": "<f4", "uchar": "u1", "double": "<f8",
                "int": "<i4", "uint": "<u4"}
    for line in header_lines:
        parts = line.split()
        if parts[0] == "element" and parts[1] == "vertex":
            n = int(parts[2])
        elif parts[0] == "property":
            fields.append((parts[2], type_map[parts[1]]))
    rec = np.frombuffer(data[header_end:], dtype=np.dtype(fields), count=n)
    return rec
