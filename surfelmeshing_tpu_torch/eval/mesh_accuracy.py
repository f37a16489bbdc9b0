"""Mesh-accuracy evaluation against a ground-truth model.

Implements the ICL-NUIM-style accuracy metric (BASELINE config 4): mean /
median / RMS distance from reconstructed surface points to the ground-truth
surface, plus completeness (fraction of ground-truth samples within a
tolerance of the reconstruction).  The reference repo itself ships no
evaluation code; this reproduces the standard SurfelMeshing paper protocol.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class AccuracyResult:
    mean: float
    median: float
    rms: float
    max: float
    completeness: float        # fraction of GT samples covered
    n_points: int

    def as_dict(self):
        return dataclasses.asdict(self)


def sample_mesh_surface(vertices: np.ndarray, triangles: np.ndarray,
                        samples_per_area: float = 1e6,
                        max_samples: int = 2_000_000,
                        seed: int = 0) -> np.ndarray:
    """Uniformly sample points on a triangle mesh (area-weighted)."""
    v = np.asarray(vertices, np.float64)
    t = np.asarray(triangles, np.int64)
    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    total_area = areas.sum()
    n = int(min(max_samples, max(len(t), total_area * samples_per_area)))
    rng = np.random.default_rng(seed)
    tri_idx = rng.choice(len(t), size=n, p=areas / total_area)
    r1 = np.sqrt(rng.random(n))
    r2 = rng.random(n)
    w0 = 1.0 - r1
    w1 = r1 * (1.0 - r2)
    w2 = r1 * r2
    return (w0[:, None] * a[tri_idx] + w1[:, None] * b[tri_idx] +
            w2[:, None] * c[tri_idx])


def evaluate_accuracy(reconstructed_points: np.ndarray,
                      gt_points: np.ndarray,
                      completeness_tolerance: float = 0.01,
                      trim_percentile: Optional[float] = None
                      ) -> AccuracyResult:
    """Distances from reconstruction to ground truth + completeness.

    reconstructed_points: (N, 3) surfel/vertex positions.
    gt_points: (M, 3) dense samples of the ground-truth surface.
    """
    from scipy.spatial import cKDTree

    rec = np.asarray(reconstructed_points, np.float64)
    rec = rec[np.isfinite(rec).all(axis=1)]
    gt = np.asarray(gt_points, np.float64)

    gt_tree = cKDTree(gt)
    d_rec_to_gt, _ = gt_tree.query(rec, k=1)
    if trim_percentile is not None:
        cut = np.percentile(d_rec_to_gt, trim_percentile)
        d_rec_to_gt = d_rec_to_gt[d_rec_to_gt <= cut]

    rec_tree = cKDTree(rec)
    d_gt_to_rec, _ = rec_tree.query(gt, k=1)
    completeness = float((d_gt_to_rec <= completeness_tolerance).mean())

    return AccuracyResult(
        mean=float(d_rec_to_gt.mean()),
        median=float(np.median(d_rec_to_gt)),
        rms=float(np.sqrt((d_rec_to_gt ** 2).mean())),
        max=float(d_rec_to_gt.max()),
        completeness=completeness,
        n_points=int(len(rec)),
    )


def point_to_mesh_distance(points: np.ndarray, vertices: np.ndarray,
                           triangles: np.ndarray, k: int = 8) -> np.ndarray:
    """Exact distance from each query point to a triangle mesh surface.

    Point-to-POINT sampling distances are floored by the sample spacing
    (~sqrt(area/n)), which drowns sub-mm surface deviations; this computes
    the exact point-to-TRIANGLE distance over the k nearest triangles by
    centroid (k-NN via cKDTree), which is exact whenever the true nearest
    triangle is within the k candidates — ample for dense reconstruction
    meshes whose triangles are near-uniform in size.
    """
    from scipy.spatial import cKDTree

    v = np.asarray(vertices, np.float64)
    t = np.asarray(triangles, np.int64)
    p = np.asarray(points, np.float64)
    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    centroids = (a + b + c) / 3.0
    k = min(k, len(t))
    _, cand = cKDTree(centroids).query(p, k=k)
    if k == 1:
        cand = cand[:, None]

    # Vectorized exact point-triangle distance (Ericson, Real-Time
    # Collision Detection §5.1.5 closest-point-on-triangle region tests).
    pa = a[cand]                      # (N, k, 3)
    ab = b[cand] - pa
    ac = c[cand] - pa
    ap = p[:, None, :] - pa
    d1 = np.einsum("nkj,nkj->nk", ab, ap)
    d2 = np.einsum("nkj,nkj->nk", ac, ap)
    bp = p[:, None, :] - b[cand]
    d3 = np.einsum("nkj,nkj->nk", ab, bp)
    d4 = np.einsum("nkj,nkj->nk", ac, bp)
    cp = p[:, None, :] - c[cand]
    d5 = np.einsum("nkj,nkj->nk", ab, cp)
    d6 = np.einsum("nkj,nkj->nk", ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = np.where(va + vb + vc != 0, va + vb + vc, 1.0)

    with np.errstate(divide="ignore", invalid="ignore"):
        # Interior (barycentric) candidate.
        w_v = vb / denom
        w_w = vc / denom
        closest = pa + w_v[..., None] * ab + w_w[..., None] * ac
        # Vertex regions.
        closest = np.where(((d1 <= 0) & (d2 <= 0))[..., None], pa, closest)
        closest = np.where(((d3 >= 0) & (d4 <= d3))[..., None], b[cand],
                           closest)
        closest = np.where(((d6 >= 0) & (d5 <= d6))[..., None], c[cand],
                           closest)
        # Edge AB.
        t_ab = np.clip(np.where(d1 - d3 != 0, d1 / np.where(
            d1 - d3 != 0, d1 - d3, 1.0), 0.0), 0.0, 1.0)
        on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
        closest = np.where(on_ab[..., None], pa + t_ab[..., None] * ab,
                           closest)
        # Edge AC.
        t_ac = np.clip(np.where(d2 - d6 != 0, d2 / np.where(
            d2 - d6 != 0, d2 - d6, 1.0), 0.0), 0.0, 1.0)
        on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
        closest = np.where(on_ac[..., None], pa + t_ac[..., None] * ac,
                           closest)
        # Edge BC.
        num_bc = d4 - d3
        den_bc = (d4 - d3) + (d5 - d6)
        t_bc = np.clip(np.where(den_bc != 0,
                                num_bc / np.where(den_bc != 0, den_bc, 1.0),
                                0.0), 0.0, 1.0)
        on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
        closest = np.where(
            on_bc[..., None],
            b[cand] + t_bc[..., None] * (c[cand] - b[cand]), closest)
        # Re-apply vertex regions last (they win over edge formulas).
        closest = np.where(((d1 <= 0) & (d2 <= 0))[..., None], pa, closest)
        closest = np.where(((d3 >= 0) & (d4 <= d3))[..., None], b[cand],
                           closest)
        closest = np.where(((d6 >= 0) & (d5 <= d6))[..., None], c[cand],
                           closest)

    d = np.linalg.norm(p[:, None, :] - closest, axis=2)
    return d.min(axis=1)


def load_obj_vertices_triangles(path: str):
    """Minimal OBJ reader for ground-truth models (v / f lines)."""
    vertices = []
    triangles = []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                vertices.append([float(parts[1]), float(parts[2]),
                                 float(parts[3])])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) - 1 for p in line.split()[1:]]
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    triangles.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(vertices, np.float64),
            np.asarray(triangles, np.int64))
