// Measurement blending at any radius, for Hopper (sm_90a): the "wide" path.
//
// Replaces surfelmeshing_tpu/ops/fusion.py::_blend_pallas (:1715, body
// _blend_core :1624) for the radii csrc/blend.cu does not take (radius >
// 32, where its 64-column region would have no core left).  The default
// radius is 12, so the main path never comes here; a user who raises
// --measurement_blending_radius does.
//
// What bounds it on this card: the chain of radius-2 dependent ring
// iterations, not bytes.  The function's byte bound is that of csrc/
// blend.cu (four f32 maps read and one written, 6,144,000 B at 640x480,
// 1.83 us at 3.35 TB/s).  The first design ran one launch an iteration
// over global maps at about 3.8 us a launch; this one carries T iterations
// a launch in shared memory (temporal blocking), where an iteration costs
// about a microsecond of barrier-separated latency (PERF.md section 6).
//
// Design: ceil((radius-1)/T) launches of one chunk kernel, no other.
// - Chunk c carries ring iterations [it0, it1): the first [2, T+1) after
//   the border iteration (the 3x3 tests and the snap of measurement-border
//   pixels to the supporter average), each later one T iterations.  A core
//   pixel's value after the chunk depends only on pixels within Chebyshev
//   distance T, so a block owning a core of (64 - 2T) x core_h pixels
//   loads a region of core + halo T (64 columns) into shared memory and
//   runs the chunk there with csrc/blend.cu's tools (blend_common.cuh):
//   64-bit row masks for the open sets and the rings it-1 and it, a list
//   of the pixels that grow for the float stage, one buffer of depth and
//   deltas updated in place, one barrier a slot.  In a slot the warps that
//   run the mask stage of it+1 take no listed pixel of it, so both stages
//   run side by side.  The rows and columns worked shrink by one an
//   iteration toward the core.
// - Between chunks the state lives in two sets of global planes: ring
//   numbers dist / ndist (int32; the unsupported-target bit rides in
//   ndist's bit 31), deltas delta / ndelta and depth (f32; ndelta is
//   defined only on pixels of an ndist ring, the only ones it is read
//   at).  Chunk c reads set c % 2 and writes set (c+1) % 2 (the last
//   chunk's depth goes to the output), so no block reads a plane another
//   block of the same launch writes.  A block writes back its core only:
//   the ring numbers of its core as it loads them (the first chunk: after
//   the border iteration) and again for each pixel that grows, deltas and
//   depth at the end.  The launches depend on the radius alone, so a call
//   has no host synchronisation and can be captured in a CUDA graph.
//
// Iteration 256.  dist holds _blend_core's own values (0 untouched,
// 1..radius-1 ring, 255 unknown), because the reference's sentinel
// collides with a ring number: in iteration 256 every pixel at 255, the
// open ones and ring 255 alike, is its own neighbour on "ring 255" and
// grows, open ones gaining blend_w * mean + 0.5 from deltas of +0.0 (an
// open pixel's delta is never written before).  Values keep that across a
// chunk boundary; inside a chunk the mask stage of 256 takes the set S =
// ring 255 | open as both the previous ring and the pixels that grow (over
// the rows and columns of iteration 255, one more than usual, since the
// float stage reads S around its own).  Ring 255 pixels grow again, so
// in-place updates would let a pixel read a neighbour's new delta: that
// one iteration reads a snapshot of the deltas taken in shared memory
// just before it (open pixels' +0.0, ring 255's the means of 255), which
// is _blend_core's Jacobi order.  Only the chunk that holds 256 gets the
// snapshot's shared memory.
//
// Dead work is skipped without a host synchronisation:
// - a block stops iterating once an iteration lists no growing pixel in
//   its rows (ring it-1 empty on both sides means no ring it, and so on);
// - a chunk whose predecessor grew nothing in its last iteration anywhere
//   (one device flag a chunk, set by any block whose core grew then) only
//   copies its blocks' cores from one set to the other.
// Hazard: an empty frontier does not end the work when radius >= 257 and
// open pixels remain, because iteration 256 grows every open pixel from
// nothing.  Neither exit is taken in the chunk that holds iteration 256.
//
// Arithmetic is _blend_core's, operation by operation, with the __f*_rn
// intrinsics (no FMA contraction) and ring sums in its neighbour order, so
// the result equals the plain PyTorch version bit for bit.  Pixels outside
// the image read as 0.  Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "blend_common.cuh"

namespace {

using namespace blend_common;

constexpr int kUnknown = 255;     // _blend_core's dist value for "not reached"
constexpr int kTargetBit = static_cast<int>(0x80000000u);  // in ndist
constexpr int kWarps = 12;        // 2 blocks an SM at most (registers)
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 4;         // units a warp loads before it stores
constexpr int kMaxChunk = 31;     // keeps a core column: 64 - 2*31 = 2

#ifdef BLEND_WIDE_PROFILE
// Clock stamps for tools/blend_wide_profile.py, compiled only into its
// build: kProfileWords words for each block of each of the first
// kProfileChunks chunks; the tool documents the words.
constexpr int kProfileChunks = 16, kProfileBlocks = 1024;
constexpr int kProfileWords = 80;
__device__ long long g_profile[kProfileChunks * kProfileBlocks *
                               kProfileWords];
#define PROFILE(cond, word, value)                                        \
  do {                                                                    \
    const int c_ = it0 == 2 ? 0 : (it0 - 1) / chunk;                      \
    const int b_ = blockIdx.y * gridDim.x + blockIdx.x;                   \
    if ((cond) && c_ < kProfileChunks && b_ < kProfileBlocks &&           \
        (word) < kProfileWords)                                           \
      g_profile[(c_ * kProfileBlocks + b_) * kProfileWords + (word)] =    \
          (value);                                                        \
  } while (0)
#else
#define PROFILE(cond, word, value) \
  do {                             \
  } while (0)
#endif

// Region rows at most: one thread a (row, half) unit in the mask stages.
constexpr int kMaxRows = 128;
static_assert(kThreads > kHalves * kMaxRows,
              "float warps beside the widest mask stage");

// One set of state planes, h*w 4-byte words each.  The scratch that
// ops/blend.py allocates holds two sets (WIDE_SCRATCH_PLANES = 2 *
// kSetPlanes) and then one flag word a chunk.
enum Plane { kDist, kNDist, kDelta, kNDelta, kDepth, kSetPlanes };

struct State {
  int* dist;
  int* ndist;
  float* delta;
  float* ndelta;
  float* depth;
};

// Masks, one uint32 per (row, half) unit; rings of iteration it live in
// buffer it % 3.  The first chunk also keeps the input's pixel sets.
enum Mask { kOpen, kNOpen, kRing, kNRing = kRing + 3, kValidM = kNRing + 3,
            kSupportedM, kEligibleM, kTargetM, kMaskCount };

// The four (H, W) input maps, read by the first chunk.
struct Inputs {
  const float* depth;
  const float* supported;
  const float* valid;
  const float* avg;
};

// Depth, delta and ndelta (f32) and two pixel lists (u16) a pixel, the
// masks a unit, four counters, the chunk's blending weights, and the
// snapshot of the deltas (f32 a pixel) in the chunk that holds iteration
// 256.
__host__ __device__ inline size_t smem_bytes(int rows, bool snapshot) {
  const size_t pixels = static_cast<size_t>(rows) * kRegionW;
  return pixels * (3 * sizeof(float) + 2 * sizeof(uint16_t)) +
         rows * kHalves * kMaskCount * sizeof(uint32_t) +
         4 * sizeof(int) + (kMaxChunk + 1) * sizeof(float) +
         (snapshot ? pixels * sizeof(float) : 0);
}

// Chunk launches of a call: the first carries the border iteration and
// chunk-1 ring iterations, each later one chunk ring iterations.
__host__ __device__ inline int chunk_count(int radius, int chunk) {
  return radius > 2 ? (radius - 1 + chunk - 1) / chunk : 1;
}

// Ring iterations [it0, it1) on the block's region; see the header.  The
// first chunk (it0 = 2) starts from the inputs `in` and runs the border
// iteration first; the others start from the state `src`.  `prev_flag` is
// the previous chunk's flag (null for the first chunk), `flag` this
// chunk's, zeroed by the launcher.
__global__ void __launch_bounds__(kThreads, 2)
wide_chunk_kernel(Inputs in, State src, State dst,
                  float* __restrict__ depth_out,
                  const int* __restrict__ prev_flag, int* __restrict__ flag,
                  int height, int width, int radius, int it0, int it1,
                  int chunk, int core_w, int core_h, float scale) {
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int cx0 = blockIdx.x * core_w, cy0 = blockIdx.y * core_h;
  const bool holds_256 = it0 <= kUnknown + 1 && kUnknown + 1 < it1;
  const bool first = prev_flag == nullptr;

  // Nothing grew anywhere in the previous chunk's last iteration, so
  // nothing grows in this one: carry the core over.
  if (prev_flag != nullptr && *prev_flag == 0 && !holds_256) {
    const int n = core_h * core_w;
    for (int i0 = tid; i0 < n; i0 += kBatch * kThreads) {
      int g[kBatch], d[kBatch], nd[kBatch];
      float dl[kBatch], ndl[kBatch], dp[kBatch];
      #pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * kThreads;
        const int gy = cy0 + i / core_w, gx = cx0 + i % core_w;
        g[j] = i < n && gy < height && gx < width ? gy * width + gx : -1;
        if (g[j] < 0) continue;
        d[j] = src.dist[g[j]];
        nd[j] = src.ndist[g[j]];
        dl[j] = src.delta[g[j]];
        ndl[j] = src.ndelta[g[j]];
        dp[j] = src.depth[g[j]];
      }
      #pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (g[j] < 0) continue;
        dst.dist[g[j]] = d[j];
        dst.ndist[g[j]] = nd[j];
        dst.delta[g[j]] = dl[j];
        dst.ndelta[g[j]] = ndl[j];
        depth_out[g[j]] = dp[j];
      }
    }
    return;
  }

  const int rows = core_h + 2 * chunk;
  const int units = rows * kHalves;
  extern __shared__ uint64_t smem[];
  float* s_depth = reinterpret_cast<float*>(smem);
  float* s_delta = s_depth + rows * kRegionW;
  float* s_ndelta = s_delta + rows * kRegionW;
  uint32_t* masks = reinterpret_cast<uint32_t*>(s_ndelta + rows * kRegionW);
  uint16_t* lists = reinterpret_cast<uint16_t*>(masks + kMaskCount * units);
  int* counts = reinterpret_cast<int*>(lists + 2 * rows * kRegionW);
  float* s_weight = reinterpret_cast<float*>(counts + 4);
  float* s_snap = s_weight + kMaxChunk + 1;
  auto mask = [&](int k) { return masks + k * units; };
  const int x0 = cx0 - chunk, y0 = cy0 - chunk;
  auto in_core = [&](int row, int x, int gy, int gx) {
    return row >= chunk && row < chunk + core_h && x >= chunk &&
           x < chunk + core_w && gy < height && gx < width;
  };
  if (tid < 3) counts[tid] = 0;
  PROFILE(tid == 0, 0, clock64());
  // The weights of iterations it0 .. it1-1, off the slots' chains.
  if (tid < it1 - it0) s_weight[tid] = blend_weight(it0 + tid, radius, scale);

  if (first) {
    // Load the inputs' region, kBatch units a warp with all their loads in
    // flight: depth, avg parked in ndelta until the border snap, deltas 0
    // (an open pixel's stays +0.0, as in _blend_core), the pixel sets.
    for (int u0 = warp; u0 < units; u0 += kBatch * kWarps) {
      float d[kBatch], a[kBatch], v[kBatch], sp[kBatch];
      #pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int u = u0 + j * kWarps;
        const int gy = y0 + (u >> 1), gx = x0 + (u & 1) * 32 + lane;
        const bool inside = u < units && gy >= 0 && gy < height && gx >= 0 &&
                            gx < width;
        const int g = inside ? gy * width + gx : 0;
        d[j] = inside ? in.depth[g] : 0.f;
        a[j] = inside ? in.avg[g] : 0.f;
        v[j] = inside ? in.valid[g] : 0.f;
        sp[j] = inside ? in.supported[g] : 0.f;
      }
      #pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int u = u0 + j * kWarps;
        if (u >= units) break;               // the same for the whole warp
        const int row = u >> 1, x = (u & 1) * 32 + lane;
        const int gy = y0 + row, gx = x0 + x;
        const bool vb = v[j] > 0.5f, sb = sp[j] > 0.5f;  // 0 outside
        const bool interior =
            gx >= 1 && gy >= 1 && gx < width - 1 && gy < height - 1;
        const int i = row * kRegionW + x;
        s_depth[i] = d[j];
        s_delta[i] = 0.f;
        s_ndelta[i] = a[j];
        const uint32_t vm = __ballot_sync(~0u, vb);
        const uint32_t sm = __ballot_sync(~0u, sb);
        const uint32_t em = __ballot_sync(~0u, interior && vb && sb);
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
    // The border iteration's masks, one thread a unit: rings 1 (dist and
    // ndist) and the open sets; its pixels are listed for the snap.  Rows
    // outside the region count as not valid, as in _blend_core's zero
    // fill; the region's outermost pixels are wrong either way and never
    // reach the core.
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
  } else {
    // Load the region, kBatch units a warp with all their loads in flight,
    // and the masks: open sets, rings it0-1.  The core's ring numbers go to
    // the output set now; a pixel that grows overwrites its own later.
    const int r0 = (it0 - 1) % 3;
    for (int u0 = warp; u0 < units; u0 += kBatch * kWarps) {
      int d[kBatch], nd[kBatch];
      float dl[kBatch], ndl[kBatch], dp[kBatch];
      #pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int u = u0 + j * kWarps;
        const int gy = y0 + (u >> 1), gx = x0 + (u & 1) * 32 + lane;
        const bool inside = u < units && gy >= 0 && gy < height &&
                            gx >= 0 && gx < width;
        const int g = inside ? gy * width + gx : 0;
        d[j] = inside ? src.dist[g] : 0;
        nd[j] = inside ? src.ndist[g] : 0;
        dl[j] = inside ? src.delta[g] : 0.f;
        ndl[j] = inside ? src.ndelta[g] : 0.f;
        dp[j] = inside ? src.depth[g] : 0.f;
      }
      #pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int u = u0 + j * kWarps;
        if (u >= units) break;                 // the same for the whole warp
        const int row = u >> 1, x = (u & 1) * 32 + lane;
        const int gy = y0 + row, gx = x0 + x;
        const int i = row * kRegionW + x;
        s_depth[i] = dp[j];
        s_delta[i] = dl[j];
        s_ndelta[i] = ndl[j];
        const int ring = nd[j] & ~kTargetBit;
        const uint32_t open = __ballot_sync(~0u, d[j] == kUnknown);
        const uint32_t nopen =
            __ballot_sync(~0u, (nd[j] & kTargetBit) && ring == 0);
        const uint32_t rm = __ballot_sync(~0u, d[j] == it0 - 1);
        const uint32_t nrm = __ballot_sync(~0u, ring == it0 - 1);
        if (lane == 0) {
          mask(kOpen)[u] = open;
          mask(kNOpen)[u] = nopen;
          mask(kRing + r0)[u] = rm;
          mask(kNRing + r0)[u] = nrm;
        }
        if (in_core(row, x, gy, gx)) {
          dst.dist[gy * width + gx] = d[j];
          dst.ndist[gy * width + gx] = nd[j];
        }
      }
    }
  }
  __syncthreads();
  PROFILE(tid == 0, 1, clock64());

  // Slot k runs the float stage of iteration k (k >= it0) beside the mask
  // stage of iteration k+1 (k+1 < it1), which needs only masks.
  for (int k = it0 - 1; k < it1; ++k) {
    const int it = k + 1;
    int mask_threads = 0;     // the mask stage's warps; the rest float
    if (it < it1) {
      // Rows that can still reach the core by it1-1; iteration 256 covers
      // those of 255, whose S its float stage reads.
      const int margin = it1 - 1 - it + (it == kUnknown + 1);
      const int u_lo = (chunk - margin) * kHalves;
      const int zone = (core_h + 2 * margin) * kHalves;
      // ... and columns: bits chunk-margin .. chunk+core_w+margin-1.
      const int span = core_w + 2 * margin;
      const uint64_t cols = (span >= kRegionW ? ~0ull : (1ull << span) - 1)
                            << (chunk - margin);
      mask_threads = (zone + 31) & ~31;
      if (warp * 32 < zone) {                  // the same for the warp
        if (tid == 0) counts[(it + 1) % 3] = 0;  // last read in slot k-1
        const int u = u_lo + tid;
        uint32_t grow = 0, ngrow = 0;
        if (tid < zone) {
          const uint32_t* ring = mask(kRing + k % 3);
          const uint32_t open = mask(kOpen)[u];
          const uint32_t nopen = mask(kNOpen)[u];
          // In 256, dist == 255 is both ring 255 and the open set, and
          // each of its pixels is its own neighbour.
          const uint32_t zone_cols =
              static_cast<uint32_t>(cols >> ((u & 1) * 32));
          grow = zone_cols & (it == kUnknown + 1
                                  ? open | ring[u]
                                  : open & next_to(ring, u, rows));
          ngrow = zone_cols & nopen & next_to(mask(kNRing + k % 3), u, rows);
          mask(kRing + it % 3)[u] = grow;
          mask(kNRing + it % 3)[u] = ngrow;
          mask(kOpen)[u] = open & ~grow;
          mask(kNOpen)[u] = nopen & ~ngrow;
        }
        if (__ballot_sync(~0u, grow | ngrow))  // the same for the warp
          append_pixels(grow, ngrow, u, lists + (it & 1) * rows * kRegionW,
                        &counts[it % 3], lane);
      }
    }

    PROFILE(tid == 0, 3 + 4 * (k - it0 + 1), clock64());
    if (first && k == 1) {
      // The border snap, one float thread a listed pixel (avg is still
      // parked in ndelta): the deltas of rings 1, the snapped depth.
      const int count = counts[1];
      const uint16_t* list = lists + rows * kRegionW;
      for (int j = tid - mask_threads; j < count && tid >= mask_threads;
           j += kThreads - mask_threads) {
        const int i = list[j];
        const uint32_t b = 1u << (i & 31);
        const float a = s_ndelta[i];
        const float delta0 = __fsub_rn(a, __fdiv_rn(s_depth[i], scale));
        if (mask(kRing + 1)[i >> 5] & b) {
          s_delta[i] = delta0;
          s_depth[i] = floorf(__fadd_rn(__fmul_rn(scale, a), 0.5f));
        }
        s_ndelta[i] = mask(kNRing + 1)[i >> 5] & b ? delta0 : 0.f;
        if (it1 == 2 && in_core(i >> 6, i & 63, y0 + (i >> 6), x0 + (i & 63)))
          *flag = 1;                  // no ring iteration: ring 1 grew last
      }
      // The core's ring numbers; a pixel that grows overwrites its own
      // in a later slot.
      for (int j = tid - mask_threads;
           j < core_h * core_w && tid >= mask_threads;
           j += kThreads - mask_threads) {
        const int row = chunk + j / core_w, x = chunk + j % core_w;
        const int gy = y0 + row, gx = x0 + x;
        if (gy >= height || gx >= width) continue;
        const int u = row * kHalves + (x >> 5);
        const uint32_t b = 1u << (x & 31);
        const int g = gy * width + gx;
        dst.dist[g] = mask(kRing + 1)[u] & b
                          ? 1 : (mask(kEligibleM)[u] & b ? kUnknown : 0);
        dst.ndist[g] = (mask(kNRing + 1)[u] & b ? 1 : 0) |
                       (mask(kTargetM)[u] & b ? kTargetBit : 0);
      }
    } else if (k >= it0) {
      const bool jacobi = k == kUnknown + 1;
      if (jacobi) {                 // the deltas before iteration 256
        for (int i = tid; i < rows * kRegionW; i += kThreads)
          s_snap[i] = s_delta[i];
        __syncthreads();
      }
      const int count = counts[k % 3];
      const float blend_w = s_weight[k - it0];
      const uint16_t* list = lists + (k & 1) * rows * kRegionW;
      // S (ring 255 | open) is the ring that grows in 256.
      const uint32_t* prev = mask(kRing + (jacobi ? k : k - 1) % 3);
      const uint32_t* nprev = mask(kNRing + (k - 1) % 3);
      // The warps of the mask stage take no listed pixel, so that the two
      // stages of a slot run side by side.
      for (int j = tid - mask_threads; j < count && tid >= mask_threads;
           j += kThreads - mask_threads) {
        // A pixel grows in dist or in ndist, never both (eligible pixels
        // are supported, targets are not); bit 15 says which.
        const int e = list[j];
        const bool ngrow = e >> 15;
        const int i = e & 0x7fff;
        float* vals = ngrow ? s_ndelta : s_delta;
        grow_to(i, ring_mean(ngrow ? nprev : prev, rows, i >> 6,
                             (i >> 5) & 1, i & 31,
                             jacobi && !ngrow ? s_snap : vals),
                vals, s_depth, blend_w);
        const int row = i >> 6, x = i & 63;
        const int gy = y0 + row, gx = x0 + x;
        if (in_core(row, x, gy, gx)) {
          if (ngrow)
            dst.ndist[gy * width + gx] = k | kTargetBit;
          else
            dst.dist[gy * width + gx] = k;
          if (k == it1 - 1) *flag = 1;
        }
      }
    }
    PROFILE(tid == kThreads - 1, 4 + 4 * (k - it0 + 1), clock64());
    __syncthreads();
    PROFILE(tid == 0, 5 + 4 * (k - it0 + 1), clock64());
    PROFILE(tid == 0, 6 + 4 * (k - it0 + 1), counts[k % 3]);
    // No pixel of the rows worked grows in iteration it, so none grows
    // later in this chunk, unless it holds 256 (see the header).
    if (!holds_256 && it < it1 && counts[it % 3] == 0) break;
  }

  for (int u = chunk * kHalves + warp; u < (chunk + core_h) * kHalves;
       u += kWarps) {
    const int row = u >> 1;
    const int x = (u & 1) * 32 + lane;
    const int gy = y0 + row, gx = x0 + x;
    if (in_core(row, x, gy, gx)) {
      const int g = gy * width + gx, i = row * kRegionW + x;
      dst.delta[g] = s_delta[i];
      dst.ndelta[g] = s_ndelta[i];
      depth_out[g] = s_depth[i];
    }
  }
  PROFILE(tid == 0, 2, clock64());
}

}  // namespace

extern "C" int blend_wide_max_chunk() { return kMaxChunk; }

#ifdef BLEND_WIDE_PROFILE
// Copies the stamps of the last call to `host` (kProfileChunks x
// kProfileBlocks x kProfileWords int64) and clears them; returns 0 or the
// CUDA error code.
extern "C" int blend_wide_profile_read(void* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_profile, sizeof(g_profile));
  static long long zero[kProfileChunks * kProfileBlocks * kProfileWords];
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_profile, zero, sizeof(g_profile));
  return static_cast<int>(err);
}
#endif

extern "C" int blend_wide_set_planes() { return kSetPlanes; }

// Raises the chunk kernel's dynamic shared-memory limit to what the
// largest chunk with the snapshot needs; call once a process, before the
// first launch.  Returns 0 or the CUDA error code.
extern "C" int blend_wide_configure() {
  return static_cast<int>(cudaFuncSetAttribute(
      wide_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxRows, true))));
}

// Launches chunk_count(radius, chunk) chunk kernels on `stream` with
// cores of (64 - 2 chunk) x core_h pixels, adding one to *kernels (a host
// int) for each kernel it enqueues; returns 0 or the first CUDA error
// code.  Callers guarantee contiguous (height, width) f32 maps and scratch
// of 2 * kSetPlanes planes of h*w words followed by max(radius, 1) words.
extern "C" int blend_wide_launch(const void* depth, const void* supported,
                                 const void* valid, const void* avg,
                                 void* out, void* scratch, int height,
                                 int width, int radius, int chunk,
                                 int core_h, float scale, void* stream,
                                 int* kernels) {
  if (radius < 1 || height < 1 || width < 1 || chunk < 1 ||
      chunk > kMaxChunk || core_h < 1 || core_h + 2 * chunk > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(height) * width;
  int32_t* planes = static_cast<int32_t*>(scratch);
  State set[2];
  for (int k = 0; k < 2; ++k) {
    int32_t* base = planes + k * kSetPlanes * n;
    set[k] = State{base + kDist * n, base + kNDist * n,
                   reinterpret_cast<float*>(base + kDelta * n),
                   reinterpret_cast<float*>(base + kNDelta * n),
                   reinterpret_cast<float*>(base + kDepth * n)};
  }
  int* flags = planes + 2 * kSetPlanes * n;
  const Inputs in{static_cast<const float*>(depth),
                  static_cast<const float*>(supported),
                  static_cast<const float*>(valid),
                  static_cast<const float*>(avg)};
  float* o = static_cast<float*>(out);
  const int chunks = chunk_count(radius, chunk);
  cudaError_t err = cudaMemsetAsync(flags, 0, chunks * sizeof(int),
                                    static_cast<cudaStream_t>(stream));
  const int core_w = kRegionW - 2 * chunk;
  const dim3 grid((width + core_w - 1) / core_w,
                  (height + core_h - 1) / core_h);
  for (int c = 0; c < chunks && err == cudaSuccess; ++c) {
    const int it0 = c == 0 ? 2 : 1 + c * chunk;
    const int it1 = std::max(2, std::min(1 + (c + 1) * chunk, radius));
    const bool snapshot = it0 <= kUnknown + 1 && kUnknown + 1 < it1;
    const State& dst = set[(c + 1) % 2];
    wide_chunk_kernel<<<grid, dim3(32, kWarps),
                        smem_bytes(core_h + 2 * chunk, snapshot),
                        static_cast<cudaStream_t>(stream)>>>(
        in, set[c % 2], dst, c == chunks - 1 ? o : dst.depth,
        c > 0 ? flags + c - 1 : nullptr, flags + c, height, width, radius,
        it0, it1, chunk, core_w, core_h, scale);
    err = cudaGetLastError();
    if (err == cudaSuccess) ++*kernels;
  }
  return static_cast<int>(err);
}
