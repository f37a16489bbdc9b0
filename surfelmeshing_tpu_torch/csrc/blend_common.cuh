// Row-mask and pixel-list helpers shared by the blending kernels
// (csrc/blend.cu, radius <= 32, and csrc/blend_wide.cu, any larger
// radius).  A block keeps a region of 64 columns in shared memory, so each
// pixel set is one 64-bit mask a row, stored as two uint32 units (row,
// half); pixel index i = 64 * row + x = 32 * unit + lane.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace blend_common {

constexpr int kRegionW = 64;      // region columns: one 64-bit mask a row
constexpr int kHalves = 2;        // 32-pixel units a row

__device__ __forceinline__ uint64_t dilate(uint64_t m) {
  return m | (m << 1) | (m >> 1);
}

// Row `row` of a mask as 64 bits (bit x = column x); 0 outside the region.
__device__ __forceinline__ uint64_t row_mask(const uint32_t* m, int row,
                                             int rows) {
  return (row >= 0 && row < rows)
             ? reinterpret_cast<const uint64_t*>(m)[row] : 0ull;
}

// The pixels of unit u (row u >> 1, half u & 1) next to a pixel of `ring`
// (rows row-1..row+1 of it, dilated by one column).
__device__ __forceinline__ uint32_t next_to(const uint32_t* ring, int u,
                                            int rows) {
  const int row = u >> 1;
  return static_cast<uint32_t>(
      dilate(row_mask(ring, row - 1, rows) | row_mask(ring, row, rows) |
             row_mask(ring, row + 1, rows)) >> ((u & 1) * 32));
}

// The ring bits of pixels x-1, x, x+1 (x = 32*half + lane) of a row mask,
// as bits 0..2; columns outside the region read as 0.
__device__ __forceinline__ uint32_t window(uint64_t m, int half, int lane) {
  return static_cast<uint32_t>((half ? m >> 31 : m << 1) >> lane) & 7u;
}

// Appends the pixels of unit u set in grow | ngrow to `list` (pixel index
// = 32 u + lane, bit 15 set for an ngrow pixel), the warp's units together
// with one atomic on `count`.  Every lane of the warp calls it.
__device__ __forceinline__ void append_pixels(uint32_t grow, uint32_t ngrow,
                                              int u, uint16_t* list,
                                              int* count, int lane) {
  const int n = __popc(grow | ngrow);
  int upto = n;                       // inclusive prefix sum over the warp
  #pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(~0u, upto, o);
    if (lane >= o) upto += t;
  }
  int base = 0;
  if (lane == 31) base = atomicAdd(count, upto);
  base = __shfl_sync(~0u, base, 31) + upto - n;
  for (uint32_t w = grow | ngrow; w; w &= w - 1) {
    const int b = __ffs(w) - 1;
    list[base++] = static_cast<uint16_t>(
        (u << 5) | b | (((ngrow >> b) & 1u) << 15));
  }
}

// Ring average of one growing pixel (row, x = 32*half + lane): the deltas
// `vals` of its neighbours on `ring` (rows row-1..row+1 of the masks),
// summed in _blend_core's neighbour order.
__device__ __forceinline__ float ring_mean(const uint32_t* ring, int rows,
                                           int row, int half, int lane,
                                           const float* vals) {
  const int x = half * 32 + lane;
  float sum = 0.f;
  int cnt = 0;
  #pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    const uint32_t b = window(row_mask(ring, row + dy, rows), half, lane);
    const float* v = vals + (row + dy) * kRegionW + x - 1;
    #pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      if (b & (1u << dx)) sum = __fadd_rn(sum, v[dx]);
    cnt += __popc(b);
  }
  return __fdiv_rn(sum, fmaxf(static_cast<float>(cnt), 1.f));
}

// The pixel at region index i joins its ring with delta `mean`, and its
// depth moves toward it.
__device__ __forceinline__ void grow_to(int i, float mean, float* vals,
                                        float* s_depth, float blend_w) {
  vals[i] = mean;
  s_depth[i] = __fadd_rn(__fadd_rn(s_depth[i], __fmul_rn(blend_w, mean)),
                         0.5f);
}

// The blending weight of ring iteration k, as _blend_core computes it.
__device__ __forceinline__ float blend_weight(int k, int radius,
                                              float scale) {
  const float one_minus = static_cast<float>(
      1.0 - static_cast<double>(k - 1) / static_cast<double>(radius - 1));
  return __fmul_rn(scale, one_minus);
}

}  // namespace blend_common
