// Native incremental meshing engine: advancing-front triangulation of a
// streamed surfel cloud.
//
// Re-designed equivalent of the reference's CPU meshing stack
// (applications/surfel_meshing/src/surfel_meshing/{surfel_meshing,octree}.*):
// consumes SoA snapshots produced by the TPU fusion engine and maintains an
// incremental triangle mesh.  The compressed octree is replaced by a uniform
// spatial hash grid (spatial_grid.h); the per-surfel advancing-front logic
// keeps the same behavioral contract (front bookkeeping, visibility pruning
// on the tangent plane, skinny-triangle suppression, hole closing, remeshing
// triggers) so meshes match the reference's quality.

#pragma once

#include <cstdint>
#include <vector>

#include "spatial_grid.h"

namespace smt {

enum class MeshState : std::uint8_t { kFree = 0, kFront = 1, kCompleted = 2 };

struct FrontEdge {
  u32 left;
  u32 right;
};

struct Tri {
  u32 v[3];
  bool valid;
  u32 free_next;  // free-list linkage when !valid
};

struct MeshSurfel {
  float pos[3];
  float normal[3];
  float radius_sq;
  u32 stamp;
  MeshState state = MeshState::kFree;
  bool can_remesh = true;
  bool can_reset = false;
  bool in_grid = false;
  std::vector<u32> tris;
  std::vector<FrontEdge> fronts;
};

struct MeshingConfig {
  float max_angle_between_normals = 90.0f * 3.14159265f / 180.0f;
  float min_triangle_angle = 10.0f * 3.14159265f / 180.0f;
  float max_triangle_angle = 170.0f * 3.14159265f / 180.0f;
  float max_neighbor_search_range_increase_factor = 2.0f;
  float long_edge_tolerance_factor = 1.5f;
  int regularization_frame_window_size = 30;
  float cell_size = 0.0f;  // 0 = auto from first snapshot's median radius
  // Analog of the reference octree's --max_surfels_per_node (main.cc:
  // 480-484): the density knob of the spatial index.  Scales the auto cell
  // size by cbrt(node_capacity / 50) — a cell holds ~(cell/ (r*sqrt(2)))^2
  // surfels of radius r on a surface, so the reference default of 50
  // corresponds to the 3*median_radius auto size.
  int node_capacity = 50;
};

class MeshingEngine {
 public:
  static constexpr int kMaxNeighbors = 64;

  explicit MeshingEngine(const MeshingConfig& config);

  // Diff a fusion snapshot against the engine state: move/update existing
  // surfels, append new ones, queue remesh/check work
  // (reference: IntegrateCUDABuffers, surfel_meshing.cc:189-288).
  void IntegrateSnapshot(int frame_index, u32 surfel_count,
                         const float* positions,     // (N, 3) smoothed
                         const float* radii_sq,      // (N,)
                         const float* normals,       // (N, 3)
                         const std::uint32_t* stamps);  // (N,)

  // Delta variant: apply only the changed rows (ascending surfel indices;
  // every index >= the current size must arrive, in order, so appends stay
  // dense).  Mirrors the reference's partial row downloads
  // (cuda_surfel_reconstruction.cc:348-358) taken to its logical end: the
  // device ships index + payload for rows whose stamp/merge state changed,
  // instead of the whole map (the mesher diffs anyway).
  void IntegrateSnapshotDelta(int frame_index, u32 n_rows,
                              const u32* indices,       // (M,)
                              const float* positions,   // (M, 3)
                              const float* radii_sq,    // (M,)
                              const float* normals,     // (M, 3)
                              const std::uint32_t* stamps,  // (M,)
                              u32 total_surfel_count);

  // Delete triangles invalidated by new/moved/merged surfels
  // (reference: CheckRemeshing, surfel_meshing.cc:537-665).
  void CheckRemeshing();

  // Drain the remesh queue, creating initial triangles / advancing fronts
  // (reference: Triangulate, surfel_meshing.cc:667-752).
  void Triangulate();

  // Reset everything and re-triangulate from scratch
  // (reference: FullRetriangulation, surfel_meshing.cc:754-790).
  void FullRetriangulation();

  // Mesh extraction. Indices reference surfel slots directly (merged slots
  // included in the numbering), like ConvertToMesh3fCu8(indices_only=true).
  std::size_t CollectTriangles(std::vector<u32>* out) const;
  std::size_t ValidTriangleCount() const;
  std::size_t DeletedTriangleCount() const { return deleted_triangle_count_; }
  std::size_t SurfelCount() const { return surfels_.size(); }
  std::size_t MergedSurfelCount() const { return merged_count_; }

  // Radius-limited max-k nearest-neighbor query (sorted by distance); used by
  // tests to validate the grid against brute force.
  int FindNeighbors(const float* pos, float radius_sq, int max_count,
                    bool include_completed, bool include_free,
                    float* out_dist_sq, u32* out_indices) const;

  // Recompute a surfel's meshing state from its incident triangles and
  // compare with the stored state; returns 0 if consistent
  // (reference: CheckSurfelState, surfel_meshing.cc:2524-2779).
  int CheckSurfelState(u32 surfel_index) const;

  // The 'e' terminal key (reference main.cc:1619-1627): reset all
  // triangles within the surfel's own radius and queue it, so the next
  // Triangulate() rebuilds its neighborhood from scratch.
  void RemeshTrianglesAt(u32 surfel_index);

  // Debug info for the per-surfel debug-triangulation keys (reference
  // main.cc:1609-1627): out10 = pos[3], normal[3], radius_sq, state,
  // triangle count, front count.  Returns 0, or -1 when out of range.
  int GetSurfelInfo(u32 surfel_index, float* out10) const;

  // Test hooks.
  void QueueForRemesh(u32 surfel_index);
  const MeshSurfel& surfel(u32 i) const { return surfels_[i]; }
  u32 inconsistency_count() const {
    return fronts_triangles_inconsistency_ + fronts_sharing_edge_ +
           connected_without_suitable_front_;
  }

 private:
  struct NeighborInfo {
    float uv[2];
    float angle;
    u32 surfel_index;
    u32 nn_rank;
    bool visible;
  };
  struct BoundaryEdge {
    u32 neighbor_slot;  // slot in the neighbor array the edge starts from
    u32 end_index;      // surfel index of the edge end
    float end_uv[2];
  };

  void UpdateExistingSurfel(u32 slot, u32 old_frame_index, const float* p,
                            float radius_sq, const float* normal, u32 stamp);
  void MaybeRebuildGrid();
  void AppendSurfel(const float* p, float radius_sq, const float* normal,
                    u32 stamp);
  void TriangulateOne(u32 surfel_index, bool no_resets);
  void RemeshTrianglesAround(u32 surfel_index, float radius_sq);
  void DeleteTriangle(u32 triangle_index, u32 skip_surfel);
  void DetachFrontsForRemovedTriangle(u32 surfel_index, u32 left, u32 right);
  void ResetSurfelToFree(u32 surfel_index);
  void DeleteAllTrianglesOf(u32 surfel_index);
  void AddTriangle(u32 a, u32 b, u32 c);
  bool TryInitialTriangle(u32 surfel_index, int neighbor_count);
  void AdvanceFront(u32 surfel_index, int neighbor_count, int max_neighbors,
                    bool no_resets);
  void ProjectAndTestVisibility(u32 surfel_index, const float* surfel_proj,
                                int neighbor_count, const float* u,
                                const float* v);
  void UpdateCornerFronts(u32 corner, u32 left, u32 right, float corner_angle,
                          const float* surfel_proj, const float* corner_uv,
                          const float* u, const float* v);
  void CloseFrontAt(u32 surfel_index, std::size_t front_pos);
  float AutoCellSize(u32 count, const float* radii_sq) const;

  MeshingConfig cfg_;
  float cos_max_normal_angle_;
  float search_increase_sq_;
  float long_edge_total_sq_;

  std::vector<MeshSurfel> surfels_;
  std::vector<Tri> tris_;
  u32 free_tri_head_ = kInvalidIndex;
  SpatialHashGrid grid_;
  bool grid_initialized_ = false;

  u32 frame_index_ = 0;
  u32 integrate_calls_ = 0;
  std::size_t first_new_surfel_ = 0;
  std::size_t merged_count_ = 0;
  std::size_t deleted_triangle_count_ = 0;

  std::vector<u32> remesh_queue_;
  std::vector<u32> check_queue_;

  // Per-triangulation scratch (fixed capacity).
  u32 nn_idx_[kMaxNeighbors];
  float nn_dist_[kMaxNeighbors];
  NeighborInfo nbr_[kMaxNeighbors];
  NeighborInfo sel_[kMaxNeighbors + 1];
  std::vector<BoundaryEdge> edges_;
  std::vector<FrontEdge> new_fronts_;

  // Diagnostics counters (reference: surfel_meshing.h:269-279).
  u32 holes_closed_ = 0;
  u32 front_too_far_ = 0;
  u32 front_completed_ = 0;
  u32 max_nn_exceeded_ = 0;
  u32 front_not_visible_ = 0;
  u32 fronts_triangles_inconsistency_ = 0;
  u32 fronts_sharing_edge_ = 0;
  u32 connected_without_suitable_front_ = 0;
};

}  // namespace smt
