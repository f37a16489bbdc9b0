// Incremental advancing-front meshing engine.  See meshing_engine.h.
//
// Behavioral contract follows the reference CPU mesher
// (applications/surfel_meshing/src/surfel_meshing/surfel_meshing.cc); the
// structure is re-designed: flat surfel store + uniform spatial hash grid,
// one class, C ABI at the bottom for ctypes.

#include "meshing_engine.h"

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstring>

namespace smt {

namespace {

constexpr float kPi = 3.14159265358979323846f;

// Fast atan2 approximation (max error ~0.005 rad); the meshing code only
// compares and wraps angles, so a consistent approximation suffices
// (reference uses a similar trick, surfel_meshing.cc:112-147).
inline float FastAtan2(float y, float x) {
  if (x == 0.0f) {
    if (y > 0.0f) return 0.5f * kPi;
    if (y < 0.0f) return -0.5f * kPi;
    return 0.0f;
  }
  float ax = std::fabs(x), ay = std::fabs(y);
  float base, z;
  if (ax >= ay) {
    z = y / x;
    base = (x > 0.0f) ? 0.0f : ((y < 0.0f) ? -kPi : kPi);
    return base + (0.97239411f - 0.19194795f * z * z) * z;
  }
  z = x / y;
  base = (y > 0.0f) ? 0.5f * kPi : -0.5f * kPi;
  return base - (0.97239411f - 0.19194795f * z * z) * z;
}

inline void Cross(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

inline float Dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

inline float DistSq3(const float* a, const float* b) {
  float dx = a[0] - b[0], dy = a[1] - b[1], dz = a[2] - b[2];
  return dx * dx + dy * dy + dz * dz;
}

// Unit vector orthogonal to n (Eigen unitOrthogonal semantics).
inline void UnitOrthogonal(const float* n, float* out) {
  if (std::fabs(n[0]) > 1e-12f || std::fabs(n[1]) > 1e-12f) {
    float inv = 1.0f / std::sqrt(n[0] * n[0] + n[1] * n[1]);
    out[0] = -n[1] * inv;
    out[1] = n[0] * inv;
    out[2] = 0.0f;
  } else {
    float inv = 1.0f / std::sqrt(n[1] * n[1] + n[2] * n[2]);
    out[0] = 0.0f;
    out[1] = -n[2] * inv;
    out[2] = n[1] * inv;
  }
}

// Does the segment S1-S2 NOT block the ray from the origin to X?
// (reference: IsVisible, surfel_meshing.cc:2498-2515)
inline bool SegmentDoesNotBlock(const float* X, const float* S1,
                                const float* S2) {
  float x_perp_s1 = X[1] * S1[0] - X[0] * S1[1];
  float x_perp_s2 = X[1] * S2[0] - X[0] * S2[1];
  if (x_perp_s1 * x_perp_s2 > 0) return true;
  float px = S2[1] - S1[1];
  float py = -(S2[0] - S1[0]);
  float d_x = px * X[0] + py * X[1];
  float d_s1 = px * S1[0] + py * S1[1];
  return (d_s1 > 0 && d_s1 > d_x) || (d_s1 < 0 && d_s1 < d_x);
}

// Is X strictly on the origin side of the line through S1-S2?
// (reference: IsInFrontOfLine, surfel_meshing.cc:2517-2522)
inline bool InFrontOfLine(const float* X, const float* S1, const float* S2) {
  float ex = S2[0] - S1[0], ey = S2[1] - S1[1];
  float px = -ey, py = ex;
  float a = px * (S1[0] - X[0]) + py * (S1[1] - X[1]);
  float b = px * S1[0] + py * S1[1];
  return a * b > 0;
}

}  // namespace

MeshingEngine::MeshingEngine(const MeshingConfig& config) : cfg_(config) {
  cos_max_normal_angle_ = std::cos(cfg_.max_angle_between_normals);
  search_increase_sq_ = cfg_.max_neighbor_search_range_increase_factor *
                        cfg_.max_neighbor_search_range_increase_factor;
  long_edge_total_sq_ = cfg_.long_edge_tolerance_factor *
                        cfg_.long_edge_tolerance_factor * search_increase_sq_;
  edges_.resize(4 * kMaxNeighbors);
  if (cfg_.cell_size > 0) {
    grid_.SetCellSize(cfg_.cell_size);
    grid_initialized_ = true;
  }
}

float MeshingEngine::AutoCellSize(u32 count, const float* radii_sq) const {
  std::vector<float> valid;
  valid.reserve(count);
  for (u32 i = 0; i < count; ++i) {
    if (radii_sq[i] > 0) valid.push_back(radii_sq[i]);
  }
  if (valid.empty()) return 0.02f;
  std::nth_element(valid.begin(), valid.begin() + valid.size() / 2,
                   valid.end());
  float median_r = std::sqrt(valid[valid.size() / 2]);
  float density_scale =
      std::cbrt(std::max(1, cfg_.node_capacity) / 50.0f);
  return std::max(1e-4f, 3.0f * median_r * density_scale);
}

void MeshingEngine::MaybeRebuildGrid() {
  // Re-derive the cell size when the scene scale drifts: the auto size is
  // picked from the FIRST snapshot's median radius and would otherwise be
  // frozen forever (the reference octree re-subdivides adaptively,
  // octree.cc:69-262; a hash grid must rebuild instead).  Checked every
  // 16 integrates; rebuilt only past a 2x drift so steady-state pays one
  // O(n) median pass per 16 snapshots and nothing else.
  if (!grid_initialized_ || surfels_.empty()) return;
  if (++integrate_calls_ % 16 != 0) return;
  std::vector<float> radii;
  radii.reserve(surfels_.size());
  for (const MeshSurfel& s : surfels_) {
    if (s.in_grid) radii.push_back(s.radius_sq);
  }
  if (radii.empty()) return;
  float want = AutoCellSize(static_cast<u32>(radii.size()), radii.data());
  float have = grid_.cell_size();
  if (want > 2.0f * have || want < 0.5f * have) {
    grid_.Rebuild(want, surfels_.size(),
                  [this](std::size_t i) { return surfels_[i].pos; });
  }
}

void MeshingEngine::UpdateExistingSurfel(u32 slot, u32 old_frame_index,
                                         const float* p, float radius_sq,
                                         const float* normal, u32 stamp) {
  MeshSurfel& s = surfels_[slot];
  bool merged_now = radius_sq < 0;
  if (!s.in_grid && merged_now) {
    return;  // zombie slot
  }
  if (s.in_grid && merged_now) {
    check_queue_.push_back(slot);
  }

  if (s.pos[0] != p[0] || s.pos[1] != p[1] || s.pos[2] != p[2]) {
    if (s.in_grid) grid_.Move(slot, p);
    s.pos[0] = p[0];
    s.pos[1] = p[1];
    s.pos[2] = p[2];
    // Queue meshing work only when the surfel was observed or is inside
    // the regularization window — loop-closure-only motion does not
    // trigger remeshing (surfel_meshing.cc:226-240).
    if (stamp > s.stamp ||
        static_cast<int>(old_frame_index) - static_cast<int>(s.stamp) <=
            cfg_.regularization_frame_window_size) {
      if (s.state != MeshState::kCompleted) {
        remesh_queue_.push_back(slot);
      }
      if (s.state != MeshState::kFree) {
        check_queue_.push_back(slot);
      }
    }
  }
  s.radius_sq = radius_sq;
  s.normal[0] = normal[0];
  s.normal[1] = normal[1];
  s.normal[2] = normal[2];
  s.stamp = stamp;
  s.can_remesh = true;
  s.can_reset = true;
}

void MeshingEngine::AppendSurfel(const float* p, float radius_sq,
                                 const float* normal, u32 stamp) {
  u32 slot = static_cast<u32>(surfels_.size());
  surfels_.emplace_back();
  MeshSurfel& s = surfels_.back();
  s.pos[0] = p[0];
  s.pos[1] = p[1];
  s.pos[2] = p[2];
  s.radius_sq = radius_sq;
  s.normal[0] = normal[0];
  s.normal[1] = normal[1];
  s.normal[2] = normal[2];
  s.stamp = stamp;
  s.can_remesh = true;
  s.can_reset = false;
  if (s.radius_sq < 0) {
    s.in_grid = false;
    ++merged_count_;
  } else {
    grid_.Insert(slot, s.pos);
    s.in_grid = true;
  }
}

void MeshingEngine::IntegrateSnapshot(int frame_index, u32 surfel_count,
                                      const float* positions,
                                      const float* radii_sq,
                                      const float* normals,
                                      const std::uint32_t* stamps) {
  if (!grid_initialized_ && surfel_count > 0) {
    grid_.SetCellSize(AutoCellSize(surfel_count, radii_sq));
    grid_initialized_ = true;
  }

  u32 old_frame_index = frame_index_;
  frame_index_ = static_cast<u32>(frame_index);

  // Update existing surfels.
  std::size_t existing = std::min<std::size_t>(surfels_.size(), surfel_count);
  for (std::size_t i = 0; i < existing; ++i) {
    UpdateExistingSurfel(static_cast<u32>(i), old_frame_index,
                         positions + 3 * i, radii_sq[i], normals + 3 * i,
                         stamps[i]);
  }

  first_new_surfel_ = surfels_.size();

  if (surfels_.capacity() < surfel_count) {
    surfels_.reserve(std::max<std::size_t>(3000000, 2ul * surfel_count));
    tris_.reserve(static_cast<std::size_t>(2.1 * surfels_.capacity()));
  }
  grid_.Reserve(surfel_count);

  // Append new surfels.
  for (std::size_t i = surfels_.size(); i < surfel_count; ++i) {
    AppendSurfel(positions + 3 * i, radii_sq[i], normals + 3 * i, stamps[i]);
  }
  MaybeRebuildGrid();
}

void MeshingEngine::IntegrateSnapshotDelta(int frame_index, u32 n_rows,
                                           const u32* indices,
                                           const float* positions,
                                           const float* radii_sq,
                                           const float* normals,
                                           const std::uint32_t* stamps,
                                           u32 total_surfel_count) {
  if (!grid_initialized_ && n_rows > 0) {
    grid_.SetCellSize(AutoCellSize(n_rows, radii_sq));
    grid_initialized_ = true;
  }

  u32 old_frame_index = frame_index_;
  frame_index_ = static_cast<u32>(frame_index);
  first_new_surfel_ = surfels_.size();

  if (surfels_.capacity() < total_surfel_count) {
    surfels_.reserve(
        std::max<std::size_t>(3000000, 2ul * total_surfel_count));
    tris_.reserve(static_cast<std::size_t>(2.1 * surfels_.capacity()));
  }
  grid_.Reserve(total_surfel_count);

  for (u32 j = 0; j < n_rows; ++j) {
    u32 i = indices[j];
    if (i < surfels_.size()) {
      UpdateExistingSurfel(i, old_frame_index, positions + 3 * j,
                           radii_sq[j], normals + 3 * j, stamps[j]);
    } else if (i == surfels_.size()) {
      AppendSurfel(positions + 3 * j, radii_sq[j], normals + 3 * j,
                   stamps[j]);
    }
    // i > size would mean the producer dropped a new row; ignore — the
    // row arrives with the next (full or larger-bucket) snapshot.
  }
  MaybeRebuildGrid();
}

int MeshingEngine::FindNeighbors(const float* pos, float radius_sq,
                                 int max_count, bool include_completed,
                                 bool include_free, float* out_dist_sq,
                                 u32* out_indices) const {
  int count = 0;
  float worst = radius_sq;
  grid_.VisitBall(pos, radius_sq, [&](u32 i) {
    const MeshSurfel& s = surfels_[i];
    if (!include_completed && s.state == MeshState::kCompleted) return;
    if (!include_free && s.state == MeshState::kFree) return;
    float d = DistSq3(pos, s.pos);
    if (d > radius_sq) return;
    if (count == max_count && d >= out_dist_sq[count - 1]) return;
    // Insertion sort (ascending distance), capped at max_count.
    int at = (count < max_count) ? count : max_count - 1;
    while (at > 0 && out_dist_sq[at - 1] > d) {
      out_dist_sq[at] = out_dist_sq[at - 1];
      out_indices[at] = out_indices[at - 1];
      --at;
    }
    out_dist_sq[at] = d;
    out_indices[at] = i;
    if (count < max_count) ++count;
    (void)worst;
  });
  return count;
}

void MeshingEngine::AddTriangle(u32 a, u32 b, u32 c) {
  u32 t;
  if (free_tri_head_ == kInvalidIndex) {
    tris_.push_back(Tri{{a, b, c}, true, 0});
    t = static_cast<u32>(tris_.size() - 1);
  } else {
    t = free_tri_head_;
    free_tri_head_ = tris_[t].free_next;
    tris_[t] = Tri{{a, b, c}, true, 0};
  }
  surfels_[a].tris.push_back(t);
  surfels_[b].tris.push_back(t);
  surfels_[c].tris.push_back(t);
}

void MeshingEngine::DeleteTriangle(u32 triangle_index, u32 skip_surfel) {
  Tri& tri = tris_[triangle_index];
  if (!tri.valid) return;
  ++deleted_triangle_count_;

  for (int k = 0; k < 3; ++k) {
    u32 si = tri.v[k];
    if (si == skip_surfel) continue;
    // Unlink from the surfel's triangle list (swap-remove).
    auto& list = surfels_[si].tris;
    for (std::size_t j = 0; j < list.size(); ++j) {
      if (list[j] == triangle_index) {
        list[j] = list.back();
        list.pop_back();
        break;
      }
    }
    // Fronts: vertex k sees v[k+1] as right and v[k-1] as left when looking
    // into the triangle from the top (surfel_meshing.cc:864-886).
    u32 left = tri.v[(k + 2) % 3];
    u32 right = tri.v[(k + 1) % 3];
    DetachFrontsForRemovedTriangle(si, left, right);
    remesh_queue_.push_back(si);
    surfels_[si].can_remesh = true;
  }

  tri.valid = false;
  tri.free_next = free_tri_head_;
  free_tri_head_ = triangle_index;
}

void MeshingEngine::DetachFrontsForRemovedTriangle(u32 surfel_index, u32 left,
                                                   u32 right) {
  MeshSurfel& s = surfels_[surfel_index];
  auto& fronts = s.fronts;

  if (s.state == MeshState::kCompleted) {
    fronts.clear();
    fronts.push_back(FrontEdge{left, right});
    s.state = MeshState::kFront;
    return;
  }
  if (s.state == MeshState::kFree) {
    ++fronts_triangles_inconsistency_;
    return;
  }

  // Look for fronts sharing an edge with the removed triangle.
  bool matched = false;
  int right_match = -1;
  int left_match = -1;
  for (int i = 0; i < static_cast<int>(fronts.size()); ++i) {
    FrontEdge& f = fronts[i];
    if (f.left == right && f.right == left) {
      fronts.erase(fronts.begin() + i);
      matched = true;
      --i;
      continue;
    }
    if (f.left == right) {
      if (right_match >= 0) {
        ++fronts_sharing_edge_;
        fronts.erase(fronts.begin() + right_match);
        --i;
        if (left_match > right_match) --left_match;
      }
      right_match = i;
      matched = true;
    } else if (f.right == left) {
      if (left_match >= 0) {
        ++fronts_sharing_edge_;
        fronts.erase(fronts.begin() + left_match);
        --i;
        if (right_match > left_match) --right_match;
      }
      left_match = i;
      matched = true;
    }
  }

  if (left_match >= 0) {
    FrontEdge& lf = fronts[left_match];
    if (right_match == -1) {
      if (lf.right == left) {
        lf.right = right;
      } else {
        lf.left = right;
      }
    } else {
      FrontEdge& rf = fronts[right_match];
      if (lf.right == left) {
        lf.right = (rf.left == right) ? rf.right : rf.left;
        fronts.erase(fronts.begin() + right_match);
      } else {
        if (rf.left == right) {
          rf.left = lf.right;
        } else {
          rf.right = lf.right;
        }
        fronts.erase(fronts.begin() + left_match);
      }
    }
  } else if (right_match >= 0) {
    FrontEdge& rf = fronts[right_match];
    if (rf.left == right) {
      rf.left = left;
    } else {
      rf.right = left;
    }
  }

  if (matched) {
    if (fronts.empty()) {
      s.state = MeshState::kFree;
      s.can_reset = false;
    } else if (s.tris.empty()) {
      ++fronts_triangles_inconsistency_;
      fronts.clear();
      s.state = MeshState::kFree;
      s.can_reset = false;
    } else {
      s.state = MeshState::kFront;
    }
    return;
  }

  // Removal opened a new hole not adjacent to an existing front.
  fronts.push_back(FrontEdge{left, right});
  s.state = MeshState::kFront;
}

void MeshingEngine::DeleteAllTrianglesOf(u32 surfel_index) {
  MeshSurfel& s = surfels_[surfel_index];
  for (int t = static_cast<int>(s.tris.size()) - 1; t >= 0; --t) {
    DeleteTriangle(s.tris[t], surfel_index);
  }
  s.tris.clear();
  s.fronts.clear();
  s.state = MeshState::kFree;
  s.can_reset = false;
  remesh_queue_.push_back(surfel_index);
}

void MeshingEngine::ResetSurfelToFree(u32 surfel_index) {
  DeleteAllTrianglesOf(surfel_index);
  surfels_[surfel_index].can_reset = false;
}

void MeshingEngine::RemeshTrianglesAround(u32 surfel_index, float radius_sq) {
  // Reset every non-free surfel within the radius (completed included,
  // free excluded; surfel_meshing.cc:814-838).
  static thread_local std::vector<u32> found;
  static thread_local std::vector<float> found_d;
  found.resize(kMaxNeighbors);
  found_d.resize(kMaxNeighbors);
  int n = FindNeighbors(surfels_[surfel_index].pos, radius_sq, kMaxNeighbors,
                        /*include_completed=*/true, /*include_free=*/false,
                        found_d.data(), found.data());
  for (int i = 0; i < n; ++i) {
    u32 si = found[i];
    MeshSurfel& s = surfels_[si];
    for (int t = static_cast<int>(s.tris.size()) - 1; t >= 0; --t) {
      DeleteTriangle(s.tris[t], si);
    }
    s.tris.clear();
    s.fronts.clear();
    s.state = MeshState::kFree;
    s.can_reset = false;
    remesh_queue_.push_back(si);
    s.can_remesh = true;
  }
}

void MeshingEngine::RemeshTrianglesAt(u32 surfel_index) {
  // The 'e' terminal key (main.cc:1619-1627): RemeshTrianglesAt(surfel,
  // surfel->radius_squared()) followed by a debug triangulation pass.
  if (surfel_index >= surfels_.size()) return;
  RemeshTrianglesAround(surfel_index, surfels_[surfel_index].radius_sq);
  remesh_queue_.push_back(surfel_index);
}

int MeshingEngine::GetSurfelInfo(u32 surfel_index, float* out10) const {
  if (surfel_index >= surfels_.size()) return -1;
  const MeshSurfel& s = surfels_[surfel_index];
  out10[0] = s.pos[0];
  out10[1] = s.pos[1];
  out10[2] = s.pos[2];
  out10[3] = s.normal[0];
  out10[4] = s.normal[1];
  out10[5] = s.normal[2];
  out10[6] = s.radius_sq;
  out10[7] = static_cast<float>(static_cast<int>(s.state));
  out10[8] = static_cast<float>(s.tris.size());
  out10[9] = static_cast<float>(s.fronts.size());
  return 0;
}

void MeshingEngine::CheckRemeshing() {
  deleted_triangle_count_ = 0;

  // Clear old geometry around newly created surfels
  // (surfel_meshing.cc:540-552).
  for (std::size_t i = first_new_surfel_; i < surfels_.size(); ++i) {
    if (!surfels_[i].in_grid) continue;
    RemeshTrianglesAround(static_cast<u32>(i), surfels_[i].radius_sq);
    remesh_queue_.push_back(static_cast<u32>(i));
  }

  // Check queued surfels for merged state, long edges, flipped normals
  // (surfel_meshing.cc:554-664).
  std::vector<bool> tri_checked(tris_.size(), false);
  for (u32 si : check_queue_) {
    MeshSurfel& s = surfels_[si];
    float max_edge_sq = long_edge_total_sq_ * s.radius_sq;

    if (max_edge_sq < 0) {
      // Merged: drop it from the grid and the mesh.
      if (s.in_grid) {
        DeleteAllTrianglesOf(si);
        grid_.Remove(si);
        s.in_grid = false;
        ++merged_count_;
      }
      continue;
    }

    for (std::size_t t = 0; t < s.tris.size(); ++t) {
      u32 ti = s.tris[t];
      if (tri_checked[ti]) continue;
      tri_checked[ti] = true;
      const Tri& tri = tris_[ti];

      u32 ir, il;
      if (si == tri.v[0]) {
        ir = tri.v[1];
        il = tri.v[2];
      } else if (si == tri.v[1]) {
        ir = tri.v[2];
        il = tri.v[0];
      } else {
        ir = tri.v[0];
        il = tri.v[1];
      }
      MeshSurfel& sr = surfels_[ir];
      MeshSurfel& sl = surfels_[il];
      float max_a_sq = long_edge_total_sq_ * sr.radius_sq;
      float max_b_sq = long_edge_total_sq_ * sl.radius_sq;

      float ra[3] = {sr.pos[0] - s.pos[0], sr.pos[1] - s.pos[1],
                     sr.pos[2] - s.pos[2]};
      float rb[3] = {sl.pos[0] - s.pos[0], sl.pos[1] - s.pos[1],
                     sl.pos[2] - s.pos[2]};
      float ea = Dot3(ra, ra);
      float eb = Dot3(rb, rb);
      float eab = DistSq3(sr.pos, sl.pos);

      bool long_edges =
          (ea > max_edge_sq && ea > max_a_sq &&
           (eb > max_b_sq || eab > max_b_sq)) ||
          (eb > max_edge_sq && eb > max_b_sq &&
           (ea > max_a_sq || eab > max_a_sq)) ||
          (eab > max_a_sq && eab > max_b_sq &&
           (ea > max_edge_sq || eb > max_edge_sq));

      bool flipped = false;
      if (!long_edges) {
        float tn[3];
        Cross(ra, rb, tn);
        flipped = Dot3(tn, s.normal) <= 0 && Dot3(tn, sr.normal) <= 0 &&
                  Dot3(tn, sl.normal) <= 0;
      }

      if (long_edges || flipped) {
        RemeshTrianglesAround(si, s.radius_sq);
        if (sr.state != MeshState::kFree) {
          RemeshTrianglesAround(ir, sr.radius_sq);
        }
        if (sl.state != MeshState::kFree) {
          RemeshTrianglesAround(il, sl.radius_sq);
        }
        break;
      }
    }
  }
  check_queue_.clear();
}

void MeshingEngine::Triangulate() {
  while (!remesh_queue_.empty()) {
    u32 si = remesh_queue_.back();
    remesh_queue_.pop_back();
    if (!surfels_[si].can_remesh ||
        surfels_[si].state == MeshState::kCompleted) {
      continue;
    }
    TriangulateOne(si, /*no_resets=*/false);
  }
}

void MeshingEngine::FullRetriangulation() {
  for (std::size_t i = 0; i < surfels_.size(); ++i) {
    if (!surfels_[i].in_grid) continue;
    ResetSurfelToFree(static_cast<u32>(i));
    surfels_[i].can_remesh = true;
  }
  remesh_queue_.clear();
  first_new_surfel_ = 0;
  for (std::size_t i = 0; i < surfels_.size(); ++i) {
    if (surfels_[i].in_grid) remesh_queue_.push_back(static_cast<u32>(i));
  }
  Triangulate();
}

void MeshingEngine::QueueForRemesh(u32 surfel_index) {
  remesh_queue_.push_back(surfel_index);
  surfels_[surfel_index].can_remesh = true;
  first_new_surfel_ = surfels_.size();
}

void MeshingEngine::TriangulateOne(u32 surfel_index, bool no_resets) {
  MeshSurfel* s = &surfels_[surfel_index];
  if (s->state == MeshState::kCompleted) return;

  // Widen the search radius to cover far front neighbors
  // (surfel_meshing.cc:320-415).
  float search_radius_sq = s->radius_sq;
  if (s->state == MeshState::kFront) {
    float max_front_dist_sq = 0;
    for (const FrontEdge& f : s->fronts) {
      MeshSurfel& lft = surfels_[f.left];
      MeshSurfel& rgt = surfels_[f.right];
      if (lft.state == MeshState::kCompleted ||
          rgt.state == MeshState::kCompleted) {
        ++front_completed_;
        if (s->can_reset && !no_resets) ResetSurfelToFree(surfel_index);
        return;
      }
      max_front_dist_sq =
          std::max(max_front_dist_sq, DistSq3(s->pos, lft.pos));
      max_front_dist_sq =
          std::max(max_front_dist_sq, DistSq3(s->pos, rgt.pos));
    }

    float max_search_sq = search_increase_sq_ * s->radius_sq;
    if (max_front_dist_sq > max_search_sq) {
      ++front_too_far_;
      // Close one-triangle holes (surfel_meshing.cc:368-397).
      if (s->tris.size() > 1) {
        for (int fi = static_cast<int>(s->fronts.size()) - 1; fi >= 0; --fi) {
          FrontEdge f = s->fronts[fi];
          MeshSurfel& lft = surfels_[f.left];
          MeshSurfel& rgt = surfels_[f.right];
          if (lft.tris.size() > 1 && lft.fronts.size() == 1 &&
              lft.fronts[0].left == f.right &&
              lft.fronts[0].right == surfel_index && rgt.tris.size() > 1 &&
              rgt.fronts.size() == 1 && rgt.fronts[0].left == surfel_index &&
              rgt.fronts[0].right == f.left) {
            AddTriangle(surfel_index, f.right, f.left);
            lft.fronts.clear();
            lft.state = MeshState::kCompleted;
            rgt.fronts.clear();
            rgt.state = MeshState::kCompleted;
            s->fronts.erase(s->fronts.begin() + fi);
          }
        }
      }
      if (s->fronts.empty()) {
        s->state = MeshState::kCompleted;
      } else {
        s->state = MeshState::kFront;
        s->can_remesh = false;
      }
      return;
    }

    max_front_dist_sq *= 1.05f;
    if (max_front_dist_sq > search_radius_sq) {
      search_radius_sq = std::min(max_search_sq, max_front_dist_sq);
    }
  }

  int n = FindNeighbors(s->pos, search_radius_sq, kMaxNeighbors,
                        /*include_completed=*/false, /*include_free=*/true,
                        nn_dist_, nn_idx_);
  if (n < 2) {
    s->can_remesh = false;
    return;
  }

  // Slot 0 must be the surfel itself (surfel_meshing.cc:433-465).
  if (nn_idx_[0] != surfel_index) {
    bool found = false;
    for (int i = 1; i < n; ++i) {
      if (nn_idx_[i] == surfel_index) {
        std::swap(nn_idx_[0], nn_idx_[i]);
        found = true;
        break;
      }
    }
    if (!found) {
      s->can_remesh = false;
      return;
    }
  }

  if (s->state == MeshState::kFree) {
    TryInitialTriangle(surfel_index, n);
    s = &surfels_[surfel_index];
  }

  if (s->state == MeshState::kFront) {
    AdvanceFront(surfel_index, n, kMaxNeighbors, no_resets);
    s = &surfels_[surfel_index];
  }

  s->can_remesh = false;
}

void MeshingEngine::ProjectAndTestVisibility(u32 surfel_index,
                                             const float* surfel_proj,
                                             int neighbor_count,
                                             const float* u, const float* v) {
  MeshSurfel& s = surfels_[surfel_index];
  u32 edge_count = 0;

  for (int ni = 1; ni < neighbor_count; ++ni) {
    u32 nsi = nn_idx_[ni];
    const MeshSurfel& nsurfel = surfels_[nsi];
    NeighborInfo& nb = nbr_[ni];
    nb.surfel_index = nsi;
    nb.nn_rank = static_cast<u32>(ni);
    nb.visible = nsurfel.state != MeshState::kCompleted;
    if (nb.visible) {
      float off[3] = {nsurfel.pos[0] - surfel_proj[0],
                      nsurfel.pos[1] - surfel_proj[1],
                      nsurfel.pos[2] - surfel_proj[2]};
      nb.uv[0] = Dot3(off, u);
      nb.uv[1] = Dot3(off, v);
      nb.angle = FastAtan2(nb.uv[1], nb.uv[0]);
    }

    // Normal-consistency cull (surfel_meshing.cc:1246-1262).
    bool same_side = true;
    if (nb.visible) {
      float cosine = Dot3(s.normal, nsurfel.normal);
      if (cosine < cos_max_normal_angle_) {
        nb.visible = false;
        same_side = false;
      }
    }

    if (same_side && nsurfel.state == MeshState::kFront) {
      // Collect this neighbor's front edges for visibility testing
      // (surfel_meshing.cc:1264-1364).
      bool behind_all_fronts = true;
      for (const FrontEdge& f : nsurfel.fronts) {
        if (edges_.size() <= edge_count + 1) edges_.resize(2 * edges_.size());

        bool have_left = f.left == surfel_index;
        bool have_right = f.right == surfel_index;
        for (u32 ei = 0; ei < edge_count; ++ei) {
          if (edges_[ei].end_index == nsi) {
            u32 start = nbr_[edges_[ei].neighbor_slot].surfel_index;
            if (start == f.left) {
              have_left = true;
              if (have_right) break;
            } else if (start == f.right) {
              have_right = true;
              if (have_left) break;
            }
          }
        }

        const MeshSurfel& fls = surfels_[f.left];
        float offl[3] = {fls.pos[0] - surfel_proj[0],
                         fls.pos[1] - surfel_proj[1],
                         fls.pos[2] - surfel_proj[2]};
        float left_uv[2] = {Dot3(offl, u), Dot3(offl, v)};
        if (!have_left) {
          BoundaryEdge& e = edges_[edge_count++];
          e.neighbor_slot = static_cast<u32>(ni);
          e.end_index = f.left;
          e.end_uv[0] = left_uv[0];
          e.end_uv[1] = left_uv[1];
        }

        const MeshSurfel& frs = surfels_[f.right];
        float offr[3] = {frs.pos[0] - surfel_proj[0],
                         frs.pos[1] - surfel_proj[1],
                         frs.pos[2] - surfel_proj[2]};
        float right_uv[2] = {Dot3(offr, u), Dot3(offr, v)};
        if (!have_right) {
          BoundaryEdge& e = edges_[edge_count++];
          e.neighbor_slot = static_cast<u32>(ni);
          e.end_index = f.right;
          e.end_uv[0] = right_uv[0];
          e.end_uv[1] = right_uv[1];
        }

        if (nb.visible && behind_all_fronts) {
          if (f.left == surfel_index || f.right == surfel_index) {
            behind_all_fronts = false;
          } else {
            float angle_r = nb.angle + kPi;
            if (angle_r >= kPi) angle_r -= 2 * kPi;
            float angle_left = FastAtan2(left_uv[1] - nb.uv[1],
                                         left_uv[0] - nb.uv[0]);
            float angle_right = FastAtan2(right_uv[1] - nb.uv[1],
                                          right_uv[0] - nb.uv[0]);
            if (angle_left <= angle_right) {
              if (!(angle_r < angle_left || angle_right < angle_r)) {
                behind_all_fronts = false;
              }
            } else {
              if (!(angle_right < angle_r && angle_r < angle_left)) {
                behind_all_fronts = false;
              }
            }
          }
        }
      }
      if (behind_all_fronts) {
        nb.visible = false;
        ++front_not_visible_;  // informational
      }
    }
  }
  nbr_[0].visible = false;

  // Ray-crossing pruning against collected boundary edges
  // (surfel_meshing.cc:1368-1397).
  for (int ni = 1; ni < neighbor_count; ++ni) {
    NeighborInfo& nb = nbr_[ni];
    if (!nb.visible) continue;
    for (u32 ei = 0; ei < edge_count; ++ei) {
      const BoundaryEdge& e = edges_[ei];
      if (e.neighbor_slot == static_cast<u32>(ni) ||
          e.end_index == nb.surfel_index) {
        continue;
      }
      if (!SegmentDoesNotBlock(nb.uv, nbr_[e.neighbor_slot].uv, e.end_uv)) {
        nb.visible = false;
        break;
      }
    }
  }
}

bool MeshingEngine::TryInitialTriangle(u32 surfel_index, int neighbor_count) {
  MeshSurfel* s = &surfels_[surfel_index];
  const float* normal = s->normal;
  float v[3], u[3];
  UnitOrthogonal(normal, v);
  Cross(normal, v, u);
  float nd = Dot3(normal, s->pos);
  float surfel_proj[3] = {s->pos[0] - nd * normal[0],
                          s->pos[1] - nd * normal[1],
                          s->pos[2] - nd * normal[2]};

  ProjectAndTestVisibility(surfel_index, surfel_proj, neighbor_count, u, v);

  // Compact the visible neighbors (surfel_meshing.cc:2307-2317).
  u32 m = 0;
  for (int ni = 1; ni < neighbor_count; ++ni) {
    if (nbr_[ni].visible) nbr_[m++] = nbr_[ni];
  }

  for (u32 first = 0; first < m; ++first) {
    for (u32 second = first + 1; second < m; ++second) {
      float angle_diff = std::fabs(nbr_[second].angle - nbr_[first].angle);
      bool between = angle_diff < kPi;
      if (!between) angle_diff = 2 * kPi - angle_diff;
      if (angle_diff < cfg_.min_triangle_angle ||
          angle_diff > cfg_.max_triangle_angle) {
        continue;
      }

      if (first != 0 || second != 1) {
        // No other visible neighbor may lie inside the candidate triangle
        // (surfel_meshing.cc:2342-2392).
        float amin = std::min(nbr_[first].angle, nbr_[second].angle);
        float amax = std::max(nbr_[first].angle, nbr_[second].angle);
        const float* S1 = nbr_[first].uv;
        const float* S2 = nbr_[second].uv;
        bool problem = false;
        for (u32 k = 0; k < m; ++k) {
          if (k == first || k == second) continue;
          if (between) {
            if (nbr_[k].angle < amin || nbr_[k].angle > amax) continue;
          } else {
            if (nbr_[k].angle > amin && nbr_[k].angle < amax) continue;
          }
          if (SegmentDoesNotBlock(nbr_[k].uv, S1, S2)) {
            problem = true;
            break;
          }
        }
        if (problem) continue;
      }

      // Orientation via the normal (surfel_meshing.cc:2401-2417).
      const MeshSurfel& fs = surfels_[nbr_[first].surfel_index];
      const MeshSurfel& ss = surfels_[nbr_[second].surfel_index];
      float f2r[3] = {s->pos[0] - fs.pos[0], s->pos[1] - fs.pos[1],
                      s->pos[2] - fs.pos[2]};
      float s2r[3] = {s->pos[0] - ss.pos[0], s->pos[1] - ss.pos[1],
                      s->pos[2] - ss.pos[2]};
      float cr[3];
      Cross(f2r, s2r, cr);
      u32 left_slot, right_slot;
      if (Dot3(normal, cr) > 0) {
        left_slot = second;
        right_slot = first;
      } else {
        left_slot = first;
        right_slot = second;
      }
      u32 left_surfel = nbr_[left_slot].surfel_index;
      u32 right_surfel = nbr_[right_slot].surfel_index;

      AddTriangle(surfel_index, right_surfel, left_surfel);
      s->fronts.push_back(FrontEdge{right_surfel, left_surfel});
      s->state = MeshState::kFront;

      UpdateCornerFronts(left_surfel, surfel_index, right_surfel,
                         nbr_[left_slot].angle, surfel_proj,
                         nbr_[left_slot].uv, u, v);
      UpdateCornerFronts(right_surfel, left_surfel, surfel_index,
                         nbr_[right_slot].angle, surfel_proj,
                         nbr_[right_slot].uv, u, v);
      return true;
    }
  }
  return false;
}

void MeshingEngine::AdvanceFront(u32 surfel_index, int neighbor_count,
                                 int max_neighbors, bool no_resets) {
  MeshSurfel* s = &surfels_[surfel_index];
  const float normal[3] = {s->normal[0], s->normal[1], s->normal[2]};
  float v[3], u[3];
  UnitOrthogonal(normal, v);
  Cross(normal, v, u);
  float nd = Dot3(normal, s->pos);
  float surfel_proj[3] = {s->pos[0] - nd * normal[0],
                          s->pos[1] - nd * normal[1],
                          s->pos[2] - nd * normal[2]};

  bool gaps[kMaxNeighbors + 1];
  bool skinny[kMaxNeighbors + 1];
  float angle_diff[kMaxNeighbors + 1];
  bool to_erase[kMaxNeighbors + 1];
  struct SkinnyEntry {
    std::uint8_t sel_index;
    std::uint8_t nn_rank;
  } skinny_entries[kMaxNeighbors];

  new_fronts_.clear();
  std::vector<FrontEdge>& fronts = s->fronts;
  for (std::size_t front_index = 0; front_index < fronts.size();
       ++front_index) {
    FrontEdge front = fronts[front_index];

    ProjectAndTestVisibility(surfel_index, surfel_proj, neighbor_count, u, v);

    // Locate the front neighbors in the NN list (surfel_meshing.cc:1470-1492).
    int left = -1, right = -1;
    for (int i = 1; i < neighbor_count; ++i) {
      if (front.left == nbr_[i].surfel_index) {
        left = i;
      } else if (front.right == nbr_[i].surfel_index) {
        right = i;
      }
      if (left >= 0 && right >= 0) break;
    }

    if (left < 0 || right < 0 || !nbr_[left].visible ||
        !nbr_[right].visible) {
      if (neighbor_count == max_neighbors) {
        ++max_nn_exceeded_;
      } else if (left >= 0 && right >= 0) {
        // Force visibility for completeness (surfel_meshing.cc:1508-1517).
        ++front_not_visible_;
        nbr_[left].visible = true;
        nbr_[right].visible = true;
        goto continue_meshing;
      } else {
        if (s->can_reset && !no_resets) {
          ResetSurfelToFree(surfel_index);
          return;
        }
      }
      s->state = MeshState::kFront;
      continue;
    }
  continue_meshing:;

    bool wrap = nbr_[left].angle > nbr_[right].angle;
    float wrap_angle = nbr_[left].angle;

    // Select visible neighbors angularly between left and right
    // (surfel_meshing.cc:1571-1599).
    u32 sel_count = 1;
    for (int ni = 1; ni < neighbor_count; ++ni) {
      if (ni == left || ni == right || !nbr_[ni].visible) continue;
      bool in_range = wrap
          ? (nbr_[ni].angle >= nbr_[left].angle ||
             nbr_[ni].angle <= nbr_[right].angle)
          : (nbr_[ni].angle >= nbr_[left].angle &&
             nbr_[ni].angle <= nbr_[right].angle);
      if (!in_range) continue;
      sel_[sel_count] = nbr_[ni];
      if (sel_[sel_count].angle < wrap_angle) sel_[sel_count].angle += 2 * kPi;
      ++sel_count;
    }
    sel_[0] = nbr_[left];
    sel_[sel_count] = nbr_[right];
    if (sel_[sel_count].angle < wrap_angle) sel_[sel_count].angle += 2 * kPi;
    ++sel_count;

    std::sort(sel_ + 1, sel_ + sel_count - 1,
              [](const NeighborInfo& a, const NeighborInfo& b) {
                return a.angle < b.angle;
              });

    // Classify angular intervals (surfel_meshing.cc:1607-1652).
    int skinny_count = 0;
    for (int i = 0; i < static_cast<int>(sel_count) - 1; ++i) {
      angle_diff[i] = sel_[i + 1].angle - sel_[i].angle;
      if (angle_diff[i] < cfg_.min_triangle_angle) {
        skinny[i] = true;
        gaps[i] = false;
        if (i > 0 && !skinny[i - 1]) {
          skinny_entries[skinny_count++] = {
              static_cast<std::uint8_t>(i),
              static_cast<std::uint8_t>(sel_[i].nn_rank)};
        }
        if (i < static_cast<int>(sel_count) - 2) {
          skinny_entries[skinny_count++] = {
              static_cast<std::uint8_t>(i + 1),
              static_cast<std::uint8_t>(sel_[i + 1].nn_rank)};
        }
      } else if (angle_diff[i] > cfg_.max_triangle_angle) {
        skinny[i] = false;
        gaps[i] = true;
      } else {
        skinny[i] = false;
        gaps[i] = false;
      }
    }
    skinny[sel_count - 1] = false;
    gaps[sel_count - 1] = false;

    // Discard neighbors that would produce skinny triangles, farthest first
    // (surfel_meshing.cc:1713-1868).
    if (skinny_count > 0) {
      u32 erase_count = 0;
      for (u32 i = 0; i < sel_count; ++i) to_erase[i] = false;
      std::sort(skinny_entries, skinny_entries + skinny_count,
                [](const SkinnyEntry& a, const SkinnyEntry& b) {
                  return a.nn_rank > b.nn_rank;
                });

      for (int k = 0; k < skinny_count; ++k) {
        int considered = skinny_entries[k].sel_index;
        int left_nb = considered - 1;
        while (to_erase[left_nb]) --left_nb;
        const int lt = left_nb;
        const int rt = considered;
        if (!skinny[lt] && !skinny[rt]) continue;
        if (gaps[lt]) {
          gaps[rt] = true;
          skinny[rt] = false;
          continue;
        }
        if (gaps[rt]) {
          gaps[lt] = true;
          skinny[lt] = false;
          continue;
        }
        int right_nb = considered + 1;
        while (to_erase[right_nb]) ++right_nb;

        float merged = angle_diff[lt] + angle_diff[rt];
        if (merged > cfg_.max_triangle_angle) continue;

        // The merged triangle must not contain any surviving surfel
        // (surfel_meshing.cc:1792-1832).
        const float* S1 = sel_[lt].uv;
        const float* S2 = sel_[right_nb].uv;
        u32 lrank = sel_[lt].nn_rank;
        u32 rrank = sel_[right_nb].nn_rank;
        bool can_delete = true;
        for (int q = lt + 1; q < right_nb; ++q) {
          if (sel_[q].nn_rank > lrank && sel_[q].nn_rank > rrank) continue;
          if (InFrontOfLine(sel_[q].uv, S1, S2)) {
            can_delete = false;
            break;
          }
        }
        if (!can_delete) continue;

        to_erase[considered] = true;
        ++erase_count;
        angle_diff[lt] = merged;
        skinny[lt] = merged < cfg_.min_triangle_angle;
      }

      if (erase_count > 0) {
        u32 out = 1;
        for (u32 i = 1; i < sel_count; ++i) {
          if (!to_erase[i]) {
            sel_[out] = sel_[i];
            gaps[out] = gaps[i];
            angle_diff[out] = angle_diff[i];
            ++out;
          }
        }
        sel_count -= erase_count;
      }
    }

    // Close small holes that are sealed on the opposite side
    // (surfel_meshing.cc:1870-1946).
    u32 hole_start = kInvalidIndex;
    for (u32 i = 0; i < sel_count; ++i) {
      if (i < sel_count - 1 && gaps[i]) {
        bool closable = angle_diff[i] < kPi;
        if (closable) {
          closable = false;
          const MeshSurfel& lop = surfels_[sel_[i].surfel_index];
          if (lop.state == MeshState::kFront) {
            u32 rop_index = sel_[i + 1].surfel_index;
            if (surfels_[rop_index].state == MeshState::kFront) {
              for (const FrontEdge& f : lop.fronts) {
                if (f.left == rop_index) {
                  closable = true;
                  break;
                }
              }
            }
          }
        }
        if (closable) {
          if (hole_start == kInvalidIndex) hole_start = i;
        } else {
          hole_start = kInvalidIndex;
          ++i;
          while (i < sel_count && gaps[i]) ++i;
          --i;
        }
      } else if (hole_start != kInvalidIndex) {
        while (hole_start < i) {
          gaps[hole_start] = false;
          ++hole_start;
        }
        hole_start = kInvalidIndex;
        ++holes_closed_;
      }
    }

    // Emit triangles + update fronts (surfel_meshing.cc:1948-2013).
    for (int i = 0; i < static_cast<int>(sel_count) - 1; ++i) {
      if (gaps[i]) continue;
      AddTriangle(surfel_index, sel_[i + 1].surfel_index,
                  sel_[i].surfel_index);

      FrontEdge* fm = &fronts[front_index];
      if (fm->left == sel_[i].surfel_index) {
        fm->left = sel_[i + 1].surfel_index;
      } else if (fm->right == sel_[i + 1].surfel_index) {
        fm->right = sel_[i].surfel_index;
      } else if (fm->right == sel_[i].surfel_index) {
        fm->right = sel_[i + 1].surfel_index;
      } else if (fm->left == sel_[i + 1].surfel_index) {
        fm->left = sel_[i].surfel_index;
      } else {
        new_fronts_.push_back(FrontEdge{fm->left, sel_[i].surfel_index});
        fm->left = sel_[i + 1].surfel_index;
      }

      UpdateCornerFronts(sel_[i].surfel_index, surfel_index,
                         sel_[i + 1].surfel_index, sel_[i].angle, surfel_proj,
                         sel_[i].uv, u, v);
      UpdateCornerFronts(sel_[i + 1].surfel_index, sel_[i].surfel_index,
                         surfel_index, sel_[i + 1].angle, surfel_proj,
                         sel_[i + 1].uv, u, v);
    }
  }

  // Drop closed fronts (left == right), append splits, set final state
  // (surfel_meshing.cc:2016-2040).
  std::size_t out = 0;
  for (std::size_t i = 0; i < fronts.size(); ++i) {
    if (fronts[i].left != fronts[i].right) {
      fronts[out++] = fronts[i];
    }
  }
  fronts.resize(out);
  fronts.insert(fronts.end(), new_fronts_.begin(), new_fronts_.end());
  s->state = fronts.empty() ? MeshState::kCompleted : MeshState::kFront;
}

void MeshingEngine::UpdateCornerFronts(u32 corner, u32 left, u32 right,
                                       float corner_angle,
                                       const float* surfel_proj,
                                       const float* corner_uv, const float* u,
                                       const float* v) {
  MeshSurfel& cs = surfels_[corner];
  if (cs.state == MeshState::kCompleted) {
    ++fronts_triangles_inconsistency_;
    return;
  }
  if (cs.state == MeshState::kFree) {
    cs.state = MeshState::kFront;
    cs.fronts.push_back(FrontEdge{left, right});
    return;
  }

  auto& fronts = cs.fronts;
  // Slide an adjacent front over the new triangle (surfel_meshing.cc:2132-2179).
  for (std::size_t i = 0; i < fronts.size(); ++i) {
    FrontEdge& f = fronts[i];
    if (f.right == left) {
      f.right = right;
      if (f.left == f.right) CloseFrontAt(corner, i);
      return;
    }
    if (f.left == right) {
      f.left = left;
      if (f.left == f.right) CloseFrontAt(corner, i);
      return;
    }
    if (f.left == left) {
      f.left = right;
      if (f.left == f.right) CloseFrontAt(corner, i);
      return;
    }
    if (f.right == right) {
      f.right = left;
      if (f.left == f.right) CloseFrontAt(corner, i);
      return;
    }
  }

  // No adjacent front: split the front containing the triangle direction
  // (surfel_meshing.cc:2181-2240).
  float angle_r = corner_angle + kPi;
  while (angle_r >= kPi) angle_r -= 2 * kPi;

  for (std::size_t i = 0; i < fronts.size(); ++i) {
    FrontEdge& f = fronts[i];
    const MeshSurfel& lf = surfels_[f.left];
    float offl[3] = {lf.pos[0] - surfel_proj[0], lf.pos[1] - surfel_proj[1],
                     lf.pos[2] - surfel_proj[2]};
    float left_uv[2] = {Dot3(offl, u), Dot3(offl, v)};
    float angle_left = FastAtan2(left_uv[1] - corner_uv[1],
                                 left_uv[0] - corner_uv[0]);
    const MeshSurfel& rf = surfels_[f.right];
    float offr[3] = {rf.pos[0] - surfel_proj[0], rf.pos[1] - surfel_proj[1],
                     rf.pos[2] - surfel_proj[2]};
    float right_uv[2] = {Dot3(offr, u), Dot3(offr, v)};
    float angle_right = FastAtan2(right_uv[1] - corner_uv[1],
                                  right_uv[0] - corner_uv[0]);

    bool found = false;
    if (angle_left <= angle_right) {
      found = angle_left <= angle_r && angle_r <= angle_right;
    } else {
      found = angle_r >= angle_left || angle_r <= angle_right;
    }
    if (found) {
      u32 old_right = f.right;
      f.right = right;
      fronts.push_back(FrontEdge{left, old_right});
      return;
    }
  }

  ++connected_without_suitable_front_;
}

void MeshingEngine::CloseFrontAt(u32 surfel_index, std::size_t front_pos) {
  MeshSurfel& s = surfels_[surfel_index];
  if (s.fronts.size() == 1) {
    s.state = MeshState::kCompleted;
    s.fronts.clear();
  } else {
    s.fronts.erase(s.fronts.begin() + front_pos);
  }
}

std::size_t MeshingEngine::CollectTriangles(std::vector<u32>* out) const {
  out->clear();
  out->reserve(3 * tris_.size());
  for (const Tri& t : tris_) {
    if (t.valid) {
      out->push_back(t.v[0]);
      out->push_back(t.v[1]);
      out->push_back(t.v[2]);
    }
  }
  return out->size() / 3;
}

std::size_t MeshingEngine::ValidTriangleCount() const {
  std::size_t n = 0;
  for (const Tri& t : tris_) {
    if (t.valid) ++n;
  }
  return n;
}

int MeshingEngine::CheckSurfelState(u32 surfel_index) const {
  const MeshSurfel& s = surfels_[surfel_index];

  // Walk the incident triangles and chain them into boundary components
  // (reference algorithm, surfel_meshing.cc:2524-2700).
  struct Comp {
    u32 a, b;
  };
  std::vector<Comp> comps;
  bool have_closed = false;
  int mismatches = 0;

  for (u32 ti : s.tris) {
    const Tri& tri = tris_[ti];
    u32 a = 0, b = 0;
    for (int i = 0; i < 3; ++i) {
      if (tri.v[i] == surfel_index) {
        a = tri.v[(i + 1) % 3];
        b = tri.v[(i + 2) % 3];
        break;
      }
    }
    bool attached = false;
    for (std::size_t c = 0; c < comps.size(); ++c) {
      Comp& comp = comps[c];
      if (comp.a == a && comp.b == b) {
        have_closed = true;
        comps.erase(comps.begin() + c);
        attached = true;
        break;
      }
      if (comp.a == b && comp.b == a) {
        have_closed = true;
        comps.erase(comps.begin() + c);
        attached = true;
        break;
      }
      if (comp.a == a) {
        comp.a = b;
        attached = true;
        break;
      }
      if (comp.a == b) {
        comp.a = a;
        attached = true;
        break;
      }
      if (comp.b == a) {
        comp.b = b;
        attached = true;
        break;
      }
      if (comp.b == b) {
        comp.b = a;
        attached = true;
        break;
      }
    }
    if (!attached) comps.push_back(Comp{a, b});
  }

  // Merge touching components.
  bool changed = true;
  while (changed) {
    changed = false;
    for (std::size_t c1 = 0; c1 < comps.size() && !changed; ++c1) {
      for (std::size_t c2 = c1 + 1; c2 < comps.size(); ++c2) {
        Comp& x = comps[c1];
        Comp& y = comps[c2];
        bool merged_pair = false;
        if ((x.a == y.a && x.b == y.b) || (x.a == y.b && x.b == y.a)) {
          have_closed = true;
          comps.erase(comps.begin() + c2);
          comps.erase(comps.begin() + c1);
          changed = true;
          break;
        } else if (x.a == y.a) {
          x.a = y.b;
          merged_pair = true;
        } else if (x.a == y.b) {
          x.a = y.a;
          merged_pair = true;
        } else if (x.b == y.a) {
          x.b = y.b;
          merged_pair = true;
        } else if (x.b == y.b) {
          x.b = y.a;
          merged_pair = true;
        }
        if (merged_pair) {
          comps.erase(comps.begin() + c2);
          changed = true;
          break;
        }
      }
    }
  }

  MeshState computed;
  if (!s.tris.empty()) {
    computed = have_closed ? MeshState::kCompleted : MeshState::kFront;
  } else {
    computed = MeshState::kFree;
  }
  if (computed != s.state) ++mismatches;

  // Front surfels: each open component must correspond to stored fronts.
  if (s.state == MeshState::kFront) {
    for (const Comp& comp : comps) {
      bool a_matched = false, b_matched = false;
      for (const FrontEdge& f : s.fronts) {
        if (f.left == comp.a || f.right == comp.a) a_matched = true;
        if (f.left == comp.b || f.right == comp.b) b_matched = true;
      }
      if (!a_matched) ++mismatches;
      if (!b_matched) ++mismatches;
    }
  }
  return mismatches;
}

}  // namespace smt

// ---------------------------------------------------------------------------
// C ABI for ctypes.
// ---------------------------------------------------------------------------

extern "C" {

void* smt_create(float max_angle_between_normals, float min_triangle_angle,
                 float max_triangle_angle,
                 float max_neighbor_search_range_increase_factor,
                 float long_edge_tolerance_factor,
                 int regularization_frame_window_size, float cell_size,
                 int node_capacity) {
  smt::MeshingConfig cfg;
  cfg.max_angle_between_normals = max_angle_between_normals;
  cfg.min_triangle_angle = min_triangle_angle;
  cfg.max_triangle_angle = max_triangle_angle;
  cfg.max_neighbor_search_range_increase_factor =
      max_neighbor_search_range_increase_factor;
  cfg.long_edge_tolerance_factor = long_edge_tolerance_factor;
  cfg.regularization_frame_window_size = regularization_frame_window_size;
  cfg.cell_size = cell_size;
  if (node_capacity > 0) cfg.node_capacity = node_capacity;
  return new smt::MeshingEngine(cfg);
}

void smt_destroy(void* engine) {
  delete static_cast<smt::MeshingEngine*>(engine);
}

void smt_integrate(void* engine, int frame_index, unsigned surfel_count,
                   const float* positions, const float* radii_sq,
                   const float* normals, const unsigned* stamps) {
  static_cast<smt::MeshingEngine*>(engine)->IntegrateSnapshot(
      frame_index, surfel_count, positions, radii_sq, normals, stamps);
}

void smt_integrate_delta(void* engine, int frame_index, unsigned n_rows,
                         const unsigned* indices, const float* positions,
                         const float* radii_sq, const float* normals,
                         const unsigned* stamps,
                         unsigned total_surfel_count) {
  static_cast<smt::MeshingEngine*>(engine)->IntegrateSnapshotDelta(
      frame_index, n_rows, indices, positions, radii_sq, normals, stamps,
      total_surfel_count);
}

void smt_check_remeshing(void* engine) {
  static_cast<smt::MeshingEngine*>(engine)->CheckRemeshing();
}

void smt_triangulate(void* engine) {
  static_cast<smt::MeshingEngine*>(engine)->Triangulate();
}

void smt_full_retriangulation(void* engine) {
  static_cast<smt::MeshingEngine*>(engine)->FullRetriangulation();
}

unsigned long smt_triangle_count(void* engine) {
  return static_cast<smt::MeshingEngine*>(engine)->ValidTriangleCount();
}

unsigned long smt_deleted_triangle_count(void* engine) {
  return static_cast<smt::MeshingEngine*>(engine)->DeletedTriangleCount();
}

unsigned long smt_surfel_count(void* engine) {
  return static_cast<smt::MeshingEngine*>(engine)->SurfelCount();
}

unsigned long smt_merged_surfel_count(void* engine) {
  return static_cast<smt::MeshingEngine*>(engine)->MergedSurfelCount();
}

// Copies up to max_triangles*3 indices; returns the triangle count.
unsigned long smt_get_triangles(void* engine, unsigned* out,
                                unsigned long max_triangles) {
  std::vector<smt::u32> buf;
  static_cast<smt::MeshingEngine*>(engine)->CollectTriangles(&buf);
  unsigned long n = buf.size() / 3;
  if (n > max_triangles) n = max_triangles;
  std::memcpy(out, buf.data(), n * 3 * sizeof(unsigned));
  return n;
}

int smt_find_neighbors(void* engine, const float* pos, float radius_sq,
                       int max_count, int include_completed, int include_free,
                       float* out_dist_sq, unsigned* out_indices) {
  return static_cast<smt::MeshingEngine*>(engine)->FindNeighbors(
      pos, radius_sq, max_count, include_completed != 0, include_free != 0,
      out_dist_sq, out_indices);
}

int smt_check_surfel_state(void* engine, unsigned surfel_index) {
  return static_cast<smt::MeshingEngine*>(engine)->CheckSurfelState(
      surfel_index);
}

int smt_surfel_meshing_state(void* engine, unsigned surfel_index) {
  return static_cast<int>(
      static_cast<smt::MeshingEngine*>(engine)->surfel(surfel_index).state);
}

unsigned smt_inconsistency_count(void* engine) {
  return static_cast<smt::MeshingEngine*>(engine)->inconsistency_count();
}

void smt_queue_for_remesh(void* engine, unsigned surfel_index) {
  static_cast<smt::MeshingEngine*>(engine)->QueueForRemesh(surfel_index);
}

void smt_remesh_triangles_at(void* engine, unsigned surfel_index) {
  static_cast<smt::MeshingEngine*>(engine)->RemeshTrianglesAt(surfel_index);
}

int smt_get_surfel_info(void* engine, unsigned surfel_index, float* out10) {
  return static_cast<smt::MeshingEngine*>(engine)->GetSurfelInfo(
      surfel_index, out10);
}

}  // extern "C"
