// Spatial hash grid for radius-limited nearest-neighbor queries over surfels.
//
// Replaces the reference's CompressedOctree (octree.{h,cc}), which exists to
// answer radius-limited max-k nearest-neighbor queries during triangulation
// (surfel_meshing.cc:421-426).  Design: a uniform grid hashed by packed cell
// coordinates, with intrusive singly-linked per-cell chains over surfel
// indices.  Insert/move/remove are O(1); a ball query visits the cells
// overlapping the ball and insertion-sorts hits into a fixed-size result
// array, which matches the octree's sorted result contract.

#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace smt {

using u32 = std::uint32_t;
using u64 = std::uint64_t;

constexpr u32 kInvalidIndex = 0xFFFFFFFFu;

struct CellKey {
  std::int32_t x, y, z;
  bool operator==(const CellKey& o) const {
    return x == o.x && y == o.y && z == o.z;
  }
};

struct CellKeyHash {
  std::size_t operator()(const CellKey& k) const {
    // 3-D integer hash (large odd constants, xor-fold).
    u64 h = static_cast<u64>(static_cast<u32>(k.x)) * 0x9E3779B185EBCA87ull;
    h ^= static_cast<u64>(static_cast<u32>(k.y)) * 0xC2B2AE3D27D4EB4Full;
    h ^= static_cast<u64>(static_cast<u32>(k.z)) * 0x165667B19E3779F9ull;
    h ^= h >> 29;
    return static_cast<std::size_t>(h);
  }
};

class SpatialHashGrid {
 public:
  explicit SpatialHashGrid(float cell_size = 0.02f) { SetCellSize(cell_size); }

  void SetCellSize(float cell_size) {
    cell_size_ = cell_size;
    inv_cell_size_ = 1.0f / cell_size;
  }
  float cell_size() const { return cell_size_; }

  void Reserve(std::size_t n) {
    next_.reserve(n);
    prev_.reserve(n);
    cell_of_.reserve(n);
  }

  std::size_t size() const { return count_; }

  CellKey KeyFor(const float* pos) const {
    return CellKey{
        static_cast<std::int32_t>(std::floor(pos[0] * inv_cell_size_)),
        static_cast<std::int32_t>(std::floor(pos[1] * inv_cell_size_)),
        static_cast<std::int32_t>(std::floor(pos[2] * inv_cell_size_))};
  }

  void EnsureCapacity(u32 index) {
    if (index >= next_.size()) {
      std::size_t n = index + 1;
      next_.resize(n, kInvalidIndex);
      prev_.resize(n, kInvalidIndex);
      cell_of_.resize(n, CellKey{INT32_MIN, INT32_MIN, INT32_MIN});
      in_grid_.resize(n, 0);
    }
  }

  void Insert(u32 index, const float* pos) {
    EnsureCapacity(index);
    CellKey key = KeyFor(pos);
    InsertWithKey(index, key);
  }

  void Remove(u32 index) {
    if (index >= in_grid_.size() || !in_grid_[index]) return;
    u32 nxt = next_[index];
    u32 prv = prev_[index];
    if (prv != kInvalidIndex) {
      next_[prv] = nxt;
    } else {
      // Head of the chain.
      auto it = cells_.find(cell_of_[index]);
      if (nxt == kInvalidIndex) {
        cells_.erase(it);
      } else {
        it->second = nxt;
      }
    }
    if (nxt != kInvalidIndex) prev_[nxt] = prv;
    in_grid_[index] = 0;
    --count_;
  }

  void Move(u32 index, const float* new_pos) {
    CellKey key = KeyFor(new_pos);
    if (index < in_grid_.size() && in_grid_[index] && key == cell_of_[index]) {
      return;  // same cell, nothing to do
    }
    Remove(index);
    EnsureCapacity(index);
    InsertWithKey(index, key);
  }

  bool Contains(u32 index) const {
    return index < in_grid_.size() && in_grid_[index];
  }

  // Visit every surfel index whose cell overlaps the ball at `pos` with
  // squared radius `radius_sq`.  The callback filters by actual distance.
  template <typename Fn>
  void VisitBall(const float* pos, float radius_sq, Fn&& fn) const {
    float r = std::sqrt(radius_sq);
    std::int32_t x0 = static_cast<std::int32_t>(
        std::floor((pos[0] - r) * inv_cell_size_));
    std::int32_t x1 = static_cast<std::int32_t>(
        std::floor((pos[0] + r) * inv_cell_size_));
    std::int32_t y0 = static_cast<std::int32_t>(
        std::floor((pos[1] - r) * inv_cell_size_));
    std::int32_t y1 = static_cast<std::int32_t>(
        std::floor((pos[1] + r) * inv_cell_size_));
    std::int32_t z0 = static_cast<std::int32_t>(
        std::floor((pos[2] - r) * inv_cell_size_));
    std::int32_t z1 = static_cast<std::int32_t>(
        std::floor((pos[2] + r) * inv_cell_size_));
    for (std::int32_t z = z0; z <= z1; ++z) {
      for (std::int32_t y = y0; y <= y1; ++y) {
        for (std::int32_t x = x0; x <= x1; ++x) {
          auto it = cells_.find(CellKey{x, y, z});
          if (it == cells_.end()) continue;
          for (u32 i = it->second; i != kInvalidIndex; i = next_[i]) {
            fn(i);
          }
        }
      }
    }
  }

  // Rebuild the grid with a new cell size (positions supplied per index).
  template <typename PosFn>
  void Rebuild(float new_cell_size, std::size_t n, PosFn&& pos_of) {
    std::vector<std::uint8_t> was_in(in_grid_);
    cells_.clear();
    std::fill(next_.begin(), next_.end(), kInvalidIndex);
    std::fill(prev_.begin(), prev_.end(), kInvalidIndex);
    std::fill(in_grid_.begin(), in_grid_.end(), 0);
    count_ = 0;
    SetCellSize(new_cell_size);
    for (std::size_t i = 0; i < n && i < was_in.size(); ++i) {
      if (was_in[i]) Insert(static_cast<u32>(i), pos_of(i));
    }
  }

 private:
  void InsertWithKey(u32 index, const CellKey& key) {
    auto res = cells_.emplace(key, index);
    if (!res.second) {
      u32 head = res.first->second;
      next_[index] = head;
      prev_[head] = index;
      res.first->second = index;
    } else {
      next_[index] = kInvalidIndex;
    }
    prev_[index] = kInvalidIndex;
    cell_of_[index] = key;
    in_grid_[index] = 1;
    ++count_;
  }

  float cell_size_ = 0.02f;
  float inv_cell_size_ = 50.0f;
  std::size_t count_ = 0;
  std::unordered_map<CellKey, u32, CellKeyHash> cells_;
  std::vector<u32> next_;
  std::vector<u32> prev_;
  std::vector<CellKey> cell_of_;
  std::vector<std::uint8_t> in_grid_;
};

}  // namespace smt
