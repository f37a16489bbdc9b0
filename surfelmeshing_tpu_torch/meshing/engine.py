"""ctypes bindings for the native advancing-front meshing engine
(surfelmeshing_tpu_torch/native/meshing_engine.{h,cc}).

The library is built on demand with g++ into build/native/ at the
repository root (ops/cuda_build.cached_build: a content-hashed name and
an atomic rename, so concurrent first uses agree); the reference's CPU
meshing stack (surfel_meshing.cc + octree.cc) is replaced by this engine
fed with SoA snapshots from the fusion step.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..ops.cuda_build import BUILD_ROOT, cached_build

_NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared"]

_lib = None


def build_library() -> Path:
    """Compile the engine unless built from the same sources already; its
    path."""
    return cached_build(
        "libsmt_meshing", "g++", CXX_FLAGS,
        [_NATIVE_DIR / "meshing_engine.cc"],
        [_NATIVE_DIR / "meshing_engine.h", _NATIVE_DIR / "spatial_grid.h"],
        BUILD_ROOT / "native")


def _load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()))

    f32p = ctypes.POINTER(ctypes.c_float)
    u32p = ctypes.POINTER(ctypes.c_uint32)

    lib.smt_create.restype = ctypes.c_void_p
    lib.smt_create.argtypes = [ctypes.c_float] * 5 + [ctypes.c_int,
                                                      ctypes.c_float,
                                                      ctypes.c_int]
    lib.smt_destroy.argtypes = [ctypes.c_void_p]
    lib.smt_integrate.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_uint, f32p, f32p, f32p, u32p]
    lib.smt_integrate_delta.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_uint, u32p, f32p, f32p,
                                        f32p, u32p, ctypes.c_uint]
    lib.smt_check_remeshing.argtypes = [ctypes.c_void_p]
    lib.smt_triangulate.argtypes = [ctypes.c_void_p]
    lib.smt_full_retriangulation.argtypes = [ctypes.c_void_p]
    lib.smt_triangle_count.restype = ctypes.c_ulong
    lib.smt_triangle_count.argtypes = [ctypes.c_void_p]
    lib.smt_deleted_triangle_count.restype = ctypes.c_ulong
    lib.smt_deleted_triangle_count.argtypes = [ctypes.c_void_p]
    lib.smt_surfel_count.restype = ctypes.c_ulong
    lib.smt_surfel_count.argtypes = [ctypes.c_void_p]
    lib.smt_merged_surfel_count.restype = ctypes.c_ulong
    lib.smt_merged_surfel_count.argtypes = [ctypes.c_void_p]
    lib.smt_get_triangles.restype = ctypes.c_ulong
    lib.smt_get_triangles.argtypes = [ctypes.c_void_p, u32p, ctypes.c_ulong]
    lib.smt_find_neighbors.restype = ctypes.c_int
    lib.smt_find_neighbors.argtypes = [ctypes.c_void_p, f32p, ctypes.c_float,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, f32p, u32p]
    lib.smt_check_surfel_state.restype = ctypes.c_int
    lib.smt_check_surfel_state.argtypes = [ctypes.c_void_p, ctypes.c_uint]
    lib.smt_surfel_meshing_state.restype = ctypes.c_int
    lib.smt_surfel_meshing_state.argtypes = [ctypes.c_void_p, ctypes.c_uint]
    lib.smt_inconsistency_count.restype = ctypes.c_uint
    lib.smt_inconsistency_count.argtypes = [ctypes.c_void_p]
    lib.smt_queue_for_remesh.argtypes = [ctypes.c_void_p, ctypes.c_uint]
    lib.smt_remesh_triangles_at.argtypes = [ctypes.c_void_p, ctypes.c_uint]
    lib.smt_get_surfel_info.restype = ctypes.c_int
    lib.smt_get_surfel_info.argtypes = [ctypes.c_void_p, ctypes.c_uint, f32p]

    _lib = lib
    return lib


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


class MeshingEngine:
    """Incremental advancing-front mesher over streamed surfel snapshots."""

    FREE, FRONT, COMPLETED = 0, 1, 2

    def __init__(self,
                 max_angle_between_normals_deg: float = 90.0,
                 min_triangle_angle_deg: float = 10.0,
                 max_triangle_angle_deg: float = 170.0,
                 max_neighbor_search_range_increase_factor: float = 2.0,
                 long_edge_tolerance_factor: float = 1.5,
                 regularization_frame_window_size: int = 30,
                 cell_size: float = 0.0,
                 max_surfels_per_node: int = 50):
        self._lib = _load_library()
        d = math.pi / 180.0
        self._handle = self._lib.smt_create(
            max_angle_between_normals_deg * d,
            min_triangle_angle_deg * d,
            max_triangle_angle_deg * d,
            max_neighbor_search_range_increase_factor,
            long_edge_tolerance_factor,
            regularization_frame_window_size,
            cell_size,
            max_surfels_per_node)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.smt_destroy(self._handle)
            self._handle = None

    def integrate(self, frame_index: int, positions: np.ndarray,
                  radii_sq: np.ndarray, normals: np.ndarray,
                  stamps: np.ndarray) -> None:
        n = positions.shape[0]
        positions = np.ascontiguousarray(positions, np.float32)
        radii_sq = np.ascontiguousarray(radii_sq, np.float32)
        normals = np.ascontiguousarray(normals, np.float32)
        stamps = np.ascontiguousarray(stamps, np.uint32)
        self._lib.smt_integrate(self._handle, frame_index, n,
                                _f32p(positions), _f32p(radii_sq),
                                _f32p(normals), _u32p(stamps))

    def integrate_delta(self, frame_index: int, indices: np.ndarray,
                        positions: np.ndarray, radii_sq: np.ndarray,
                        normals: np.ndarray, stamps: np.ndarray,
                        total_surfel_count: int) -> None:
        """Apply only the changed rows (ascending indices; appended rows
        must arrive dense).  See IntegrateSnapshotDelta in the native
        engine; the device-side producer is fusion.meshing_snapshot_delta."""
        m = indices.shape[0]
        indices = np.ascontiguousarray(indices, np.uint32)
        positions = np.ascontiguousarray(positions, np.float32)
        radii_sq = np.ascontiguousarray(radii_sq, np.float32)
        normals = np.ascontiguousarray(normals, np.float32)
        stamps = np.ascontiguousarray(stamps, np.uint32)
        self._lib.smt_integrate_delta(self._handle, frame_index, m,
                                      _u32p(indices), _f32p(positions),
                                      _f32p(radii_sq), _f32p(normals),
                                      _u32p(stamps), total_surfel_count)

    def check_remeshing(self) -> None:
        self._lib.smt_check_remeshing(self._handle)

    def triangulate(self) -> None:
        self._lib.smt_triangulate(self._handle)

    def full_retriangulation(self) -> None:
        self._lib.smt_full_retriangulation(self._handle)

    @property
    def triangle_count(self) -> int:
        return self._lib.smt_triangle_count(self._handle)

    @property
    def deleted_triangle_count(self) -> int:
        return self._lib.smt_deleted_triangle_count(self._handle)

    @property
    def surfel_count(self) -> int:
        return self._lib.smt_surfel_count(self._handle)

    @property
    def merged_surfel_count(self) -> int:
        return self._lib.smt_merged_surfel_count(self._handle)

    @property
    def inconsistency_count(self) -> int:
        return self._lib.smt_inconsistency_count(self._handle)

    def get_triangles(self) -> np.ndarray:
        """(M, 3) u32 surfel indices of valid triangles (merged surfels keep
        their slots in the numbering, like ConvertToMesh3fCu8(indices_only))."""
        cap = self.triangle_count
        out = np.empty((max(cap, 1), 3), np.uint32)
        n = self._lib.smt_get_triangles(self._handle, _u32p(out), cap)
        return out[:n]

    def find_neighbors(self, pos, radius_sq: float, max_count: int = 64,
                       include_completed: bool = True,
                       include_free: bool = True
                       ) -> Tuple[np.ndarray, np.ndarray]:
        pos = np.ascontiguousarray(pos, np.float32)
        dist = np.empty(max_count, np.float32)
        idx = np.empty(max_count, np.uint32)
        n = self._lib.smt_find_neighbors(
            self._handle, _f32p(pos), radius_sq, max_count,
            int(include_completed), int(include_free), _f32p(dist), _u32p(idx))
        return dist[:n], idx[:n]

    def check_surfel_state(self, surfel_index: int) -> int:
        """0 if the stored meshing state/fronts are consistent with the
        incident triangles."""
        return self._lib.smt_check_surfel_state(self._handle, surfel_index)

    def meshing_state(self, surfel_index: int) -> int:
        return self._lib.smt_surfel_meshing_state(self._handle, surfel_index)

    def queue_for_remesh(self, surfel_index: int) -> None:
        self._lib.smt_queue_for_remesh(self._handle, surfel_index)

    def remesh_triangles_at(self, surfel_index: int) -> None:
        """The 'e' terminal key (reference main.cc:1619-1627): reset all
        triangles within the surfel's own radius and queue it for
        re-triangulation by the next triangulate() call."""
        self._lib.smt_remesh_triangles_at(self._handle, surfel_index)

    def surfel_info(self, surfel_index: int):
        """Debug info dict for the y/e per-surfel debug-triangulation keys
        (reference main.cc:1609-1627), or None when out of range."""
        out = np.zeros(10, np.float32)
        if self._lib.smt_get_surfel_info(self._handle, surfel_index,
                                         _f32p(out)) != 0:
            return None
        return {
            "position": out[0:3].copy(),
            "normal": out[3:6].copy(),
            "radius_sq": float(out[6]),
            "state": int(out[7]),       # 0 free, 1 front, 2 completed
            "triangles": int(out[8]),
            "fronts": int(out[9]),
        }
