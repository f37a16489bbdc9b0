// Measurement blending for Hopper (sm_90a).
//
// Replaces surfelmeshing_tpu/ops/fusion.py::_blend_pallas (:1715, body
// _blend_core :1624): observation-boundary feathering, reference
// kernels.cu:563-738.  Border pixels (3x3 test on the valid / supported
// masks) snap to the supporter average; then radius-2 ring iterations grow
// rings over 8-neighbours and pull depth toward the ring-averaged delta
// with a linearly decaying weight.  It runs once per fused frame.
//
// What bounds it on this card: bytes.  At 640x480 the four f32 maps in and
// the one out are 6,144,000 B, 1.83 us at 3.35 TB/s.  The arithmetic is a
// few f32 operations per ring neighbour of a pixel that grows, at most
// about 28 a pixel and iteration (under 1.3 us at 67 TFLOP/s for radius
// 12 even if every pixel did all of it each iteration; seeded and real
// maps grow far fewer).  What costs time in practice is the latency of the
// chain of radius-2 dependent iterations, each ending in a barrier.
//
// Design (one launch; a block of 8 warps owns a core of (64 - 2*halo) x 32
// output pixels, 42 x 32 at radius 12, and keeps a 64-column region, the
// core plus a halo of radius-1 pixels, in shared memory for the whole
// chain; 240 blocks at 640x480):
// - One row of the region is 64 pixels, so every pixel set the algorithm
//   tests is a 64-bit mask a row: valid, supported, eligible, unsupported
//   target, the rings (dist == it, ndist == it) and the open sets
//   (dist == 255; unsupported target with ndist == 0).  The 3x3 tests are
//   shifts and ORs of three row masks; dist and ndist are never stored.
// - Mask stage, one thread a (row, 32-pixel half) unit: the pixels that
//   grow in iteration it are the open ones next to ring it-1.  It lists
//   them, one u16 index a pixel, with one shared atomic a warp.
// - Float stage, one thread a listed pixel: the ring average and the depth
//   update.  Only pixels that change cost float work: far from observation
//   borders nothing changes after the snap, and on borders a warp carries
//   32 growing pixels, not 32 neighbours of a few.
// - The mask stage of iteration it+1 needs only masks, so it runs beside
//   the float stage of iteration it, one barrier a slot (ring masks triple-
//   buffered, lists double-buffered).  It covers only the rows that can
//   still reach the core (margin radius-1-it).
// - One buffer, updated in place, for depth and the two deltas (12 B a
//   pixel): in iteration it a pixel reads a neighbour's delta only when the
//   neighbour is on ring it-1, a pixel written in it goes from open to ring
//   it, and ring it-1 is never written, so the Jacobi snapshot of
//   _blend_core is redundant.
// - Loads: each warp starts the loads of four units before it stores any
//   (kBatch).  No index is divided at run time: units and pixels are
//   shifts and masks of compile-time tile constants.
// - The dynamic shared-memory limit is raised once a process
//   (blend_configure), never at launch, so a launch can be captured in a
//   CUDA graph.
// The first design (a 32x32 tile recomputing its whole 54x54 region every
// iteration, Jacobi double buffers, 25 B a pixel) was latency-bound at
// about 1% of the bound; PERF.md section 6 has both designs' device times
// (chip_smoke.py).
//
// Arithmetic follows _blend_core operation by operation, with the __f*_rn
// intrinsics so nvcc cannot contract a*b+c into an FMA, and ring sums in
// its neighbour order: the result equals the plain PyTorch version bit for
// bit.  Pixels outside the image read as 0, like the zero fill of
// _blend_core's shifted().  Build without --use_fast_math (the divisions
// must be IEEE divisions).

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_common.cuh"

namespace {

using namespace blend_common;

constexpr int kCoreH = 32;        // output rows a block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 4;         // units a warp loads before it stores
constexpr int kMaxHalo = 31;      // keeps a core column: 64 - 2*31 = 2
constexpr int kMaxRadius = kMaxHalo + 1;
static_assert(kThreads >= kHalves * (kCoreH + 2 * kMaxHalo),
              "one thread a unit for the mask stages");

// Mask arrays, each one uint32 per (row, half) unit; rings of iteration it
// live in buffer it % 3 (the mask stage runs one iteration ahead of the
// float stage, which reads rings it-1 and it).
enum Mask { kValidM, kSupportedM, kEligibleM, kTargetM, kOpen, kNOpen,
            kRing, kNRing = kRing + 3, kMaskCount = kNRing + 3 };

__host__ __device__ inline int halo_for(int radius) {
  return radius > 2 ? radius - 1 : 1;
}

__host__ __device__ inline int region_rows(int halo) {
  return kCoreH + 2 * halo;
}

// Depth, delta and ndelta (f32) and two pixel lists (u16) per pixel; the
// masks per unit; three list counters.
__host__ __device__ inline size_t smem_bytes(int halo) {
  const size_t units = region_rows(halo) * kHalves;
  return units * 32 * (3 * sizeof(float) + 2 * sizeof(uint16_t)) +
         units * kMaskCount * sizeof(uint32_t) + 4 * sizeof(int);
}

__global__ void __launch_bounds__(kThreads, 2)
blend_kernel(const float* __restrict__ depth,
             const float* __restrict__ supported,
             const float* __restrict__ valid,
             const float* __restrict__ avg,
             float* __restrict__ out,
             int height, int width, int radius, int halo, int core_w,
             float scale) {
  const int rows = region_rows(halo);
  const int units = rows * kHalves;
  extern __shared__ uint64_t smem[];
  float* s_depth = reinterpret_cast<float*>(smem);
  float* s_delta = s_depth + rows * kRegionW;
  float* s_ndelta = s_delta + rows * kRegionW;
  uint32_t* masks = reinterpret_cast<uint32_t*>(s_ndelta + rows * kRegionW);
  uint16_t* lists = reinterpret_cast<uint16_t*>(masks + kMaskCount * units);
  int* counts = reinterpret_cast<int*>(lists + 2 * rows * kRegionW);
  auto mask = [&](int k) { return masks + k * units; };
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int x0 = blockIdx.x * core_w - halo;
  const int y0 = blockIdx.y * kCoreH - halo;
  if (tid < 3) counts[tid] = 0;

  // Load the region, kBatch units a warp with all their loads in flight:
  // depth, delta0 = avg - depth / scale (eligible pixels), avg parked in
  // s_ndelta until the snap, and the four pixel-set masks.
  for (int u0 = warp; u0 < units; u0 += kBatch * kWarps) {
    float d[kBatch], a[kBatch], v[kBatch], s[kBatch];
    #pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int u = u0 + j * kWarps;
      const int gy = y0 + (u >> 1), gx = x0 + (u & 1) * 32 + lane;
      const bool in = u < units && gy >= 0 && gy < height && gx >= 0 &&
                      gx < width;
      const int g = in ? gy * width + gx : 0;
      d[j] = in ? depth[g] : 0.f;
      a[j] = in ? avg[g] : 0.f;
      v[j] = in ? valid[g] : 0.f;
      s[j] = in ? supported[g] : 0.f;
    }
    #pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int u = u0 + j * kWarps;
      if (u >= units) break;                 // the same for the whole warp
      const int row = u >> 1, x = (u & 1) * 32 + lane;
      const int gy = y0 + row, gx = x0 + x;
      const bool vb = v[j] > 0.5f, sb = s[j] > 0.5f;   // 0 outside the image
      const bool interior =
          gx >= 1 && gy >= 1 && gx < width - 1 && gy < height - 1;
      const bool eligible = interior && vb && sb;
      const int i = row * kRegionW + x;
      s_depth[i] = d[j];
      s_delta[i] = eligible ? __fsub_rn(a[j], __fdiv_rn(d[j], scale)) : 0.f;
      s_ndelta[i] = a[j];
      const uint32_t vm = __ballot_sync(~0u, vb);
      const uint32_t sm = __ballot_sync(~0u, sb);
      const uint32_t em = __ballot_sync(~0u, eligible);
      const uint32_t tm = __ballot_sync(~0u, interior && vb && !sb);
      if (lane == 0) {
        mask(kValidM)[u] = vm;
        mask(kSupportedM)[u] = sm;
        mask(kEligibleM)[u] = em;
        mask(kTargetM)[u] = tm;
      }
    }
  }
  __syncthreads();

  // Mask stage of iteration 1, one thread a unit: border detection, ring 1
  // (dist and ndist) and the open sets.  Rows outside the region count as
  // not valid, as in _blend_core's zero fill; the region's outermost
  // pixels are wrong either way and never reach the core.  Border pixels
  // are listed for the float stage.
  if (warp * 32 < units) {                 // the same for the whole warp
    const int u = tid, row = u >> 1, shift = (u & 1) * 32;
    uint32_t meas = 0, surf = 0;
    if (u < units) {
      uint64_t not_valid = 0, unsupported = 0;
      #pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
        const uint64_t vm = row_mask(mask(kValidM), row + dy, rows);
        const uint64_t sm = row_mask(mask(kSupportedM), row + dy, rows);
        not_valid |= dilate(~vm);
        unsupported |= dilate(vm & ~sm);
      }
      const uint32_t e = mask(kEligibleM)[u];
      meas = e & static_cast<uint32_t>(not_valid >> shift);
      surf = e & static_cast<uint32_t>(unsupported >> shift);
      mask(kRing + 1)[u] = meas;
      mask(kNRing + 1)[u] = surf;
      mask(kOpen)[u] = e & ~meas;
      mask(kNOpen)[u] = mask(kTargetM)[u];
    }
    append_pixels(meas | surf, 0, u, lists + rows * kRegionW, &counts[1],
                  lane);
  }
  __syncthreads();

  // Slot k runs the float stage of iteration k, one thread a listed pixel
  // (k = 1: the border snap; k >= 2: ring k grows, in place), beside the
  // mask stage of iteration k+1, which needs only masks.  One barrier a
  // slot.
  for (int k = 1; k < max(radius, 2); ++k) {
    const int it = k + 1;
    const int margin = radius - 1 - it;        // rows that reach the core
    const int u_lo = (halo - margin) * kHalves;
    const int zone = (kCoreH + 2 * margin) * kHalves;
    if (it < radius && warp * 32 < zone) {     // the same for the warp
      if (tid == 0) counts[(it + 1) % 3] = 0;  // last read in slot k-1
      const int u = u_lo + tid;
      uint32_t grow = 0, ngrow = 0;
      if (tid < zone) {
        const uint32_t* ring = mask(kRing + k % 3);
        const uint32_t* nring = mask(kNRing + k % 3);
        const uint32_t open = mask(kOpen)[u];
        const uint32_t nopen = mask(kNOpen)[u];
        grow = open & next_to(ring, u, rows);
        ngrow = nopen & next_to(nring, u, rows);
        mask(kRing + it % 3)[u] = grow;
        mask(kNRing + it % 3)[u] = ngrow;
        mask(kOpen)[u] = open & ~grow;
        mask(kNOpen)[u] = nopen & ~ngrow;
      }
      append_pixels(grow, ngrow, u, lists + (it & 1) * rows * kRegionW,
                    &counts[it % 3], lane);
    }

    const int count = counts[k % 3];
    const uint16_t* list = lists + (k & 1) * rows * kRegionW;
    if (k == 1) {
      for (int j = tid; j < count; j += kThreads) {
        const int i = list[j];                 // pixel index = 32 u + lane
        const uint32_t b = 1u << (i & 31);
        if (mask(kRing + 1)[i >> 5] & b)       // avg is still parked in ndelta
          s_depth[i] = floorf(__fadd_rn(__fmul_rn(scale, s_ndelta[i]),
                                        0.5f));
        if (mask(kNRing + 1)[i >> 5] & b) s_ndelta[i] = s_delta[i];
      }
    } else {
      const float blend_w = blend_weight(k, radius, scale);
      const uint32_t* prev = mask(kRing + (k - 1) % 3);
      const uint32_t* nprev = mask(kNRing + (k - 1) % 3);
      for (int j = tid; j < count; j += kThreads) {
        // A pixel grows in dist or in ndist, never both (eligible pixels
        // are supported, targets are not); bit 15 says which.
        const int e = list[j];
        const bool ngrow = e >> 15;
        const int i = e & 0x7fff;
        float* vals = ngrow ? s_ndelta : s_delta;
        grow_to(i, ring_mean(ngrow ? nprev : prev, rows, i >> 6,
                             (i >> 5) & 1, i & 31, vals),
                vals, s_depth, blend_w);
      }
    }
    __syncthreads();
  }

  for (int u = halo * kHalves + warp; u < (halo + kCoreH) * kHalves;
       u += kWarps) {
    const int row = u >> 1;
    const int x = (u & 1) * 32 + lane;
    const int gy = y0 + row, gx = x0 + x;
    if (x >= halo && x < halo + core_w && gy < height && gx < width)
      out[gy * width + gx] = s_depth[row * kRegionW + x];
  }
}

}  // namespace

extern "C" int blend_max_radius() { return kMaxRadius; }

// Raises the kernel's dynamic shared-memory limit to what the largest
// radius needs; call once a process, before the first launch.  Returns 0
// or the CUDA error code.
extern "C" int blend_configure() {
  return static_cast<int>(cudaFuncSetAttribute(
      blend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxHalo))));
}

// Launches the kernel on `stream`; returns 0 or the CUDA error code.
// Callers guarantee 1 <= radius <= blend_max_radius() and contiguous
// (height, width) f32 maps.
extern "C" int blend_core_launch(const void* depth, const void* supported,
                                 const void* valid, const void* avg,
                                 void* out, int height, int width,
                                 int radius, float scale, void* stream) {
  if (radius < 1 || radius > kMaxRadius)
    return static_cast<int>(cudaErrorInvalidValue);
  const int halo = halo_for(radius);
  const int core_w = kRegionW - 2 * halo;
  const dim3 grid((width + core_w - 1) / core_w,
                  (height + kCoreH - 1) / kCoreH);
  blend_kernel<<<grid, dim3(32, kWarps), smem_bytes(halo),
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(depth), static_cast<const float*>(supported),
      static_cast<const float*>(valid), static_cast<const float*>(avg),
      static_cast<float*>(out), height, width, radius, halo, core_w, scale);
  return static_cast<int>(cudaGetLastError());
}
