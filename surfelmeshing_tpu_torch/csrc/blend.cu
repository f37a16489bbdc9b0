// Measurement blending for Hopper (sm_90a).
//
// Replaces surfelmeshing_tpu/ops/fusion.py::_blend_pallas (body
// _blend_core): observation-boundary feathering, reference
// kernels.cu:563-738.  Border pixels (3x3 test on the valid / supported
// masks) snap to the supporter average; then radius-2 Jacobi ring
// iterations grow rings over 8-neighbours and pull depth toward the
// ring-averaged delta with a linearly decaying weight.
//
// What bounds it on this card: the maps are small (five f32 maps at
// 640x480 are about 6 MB, read once and written once), so memory bandwidth
// is not the limit.  The cost is the chain of radius-2 dependent stencil
// passes: launched as separate passes each would pay a launch and a round
// trip through device memory.  Here one launch covers the whole chain.
// Each block owns a 32x32 output tile and keeps the tile plus a halo of
// radius-1 pixels (1 for the 3x3 border test, 1 per ring iteration) in
// shared memory, where every iteration runs with one barrier.  The price
// is redundant halo work: at radius 12 a block computes a 54x54 region for
// 32x32 outputs (2.85x).  A 32x32 tile keeps that factor under 3 while the
// 72.9 KB region still lets two blocks share an SM; a 16x16 tile would
// compute 5.6x its outputs.
//
// Arithmetic follows _blend_core operation by operation, with the
// __f*_rn intrinsics so nvcc cannot contract a*b+c into an FMA: the result
// is meant to equal the plain PyTorch version bit for bit.  Pixels outside
// the image read as 0, like the zero fill of _blend_core's shifted().
// Build without --use_fast_math (the divisions must be IEEE divisions).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr uint8_t kValid = 1;
constexpr uint8_t kSupported = 2;
constexpr uint8_t kInterior = 4;
constexpr uint8_t kUnknown = 255;   // ring not reached yet
// Shared bytes per region pixel: depth, delta x2, new_delta x2 (f32) and
// dist x2, new_dist x2, flags (u8).
constexpr int kBytesPerPixel = 5 * 4 + 5;

__host__ __device__ inline int halo_for(int radius) {
  return radius > 2 ? radius - 1 : 1;
}

__device__ inline bool in_region(int y, int x, int s) {
  return y >= 0 && y < s && x >= 0 && x < s;
}

__global__ void __launch_bounds__(kThreads)
blend_kernel(const float* __restrict__ depth,
             const float* __restrict__ supported,
             const float* __restrict__ valid,
             const float* __restrict__ avg,
             float* __restrict__ out,
             int height, int width, int radius, float scale) {
  const int halo = halo_for(radius);
  const int s = kTile + 2 * halo;
  const int n = s * s;
  const int x0 = blockIdx.x * kTile - halo;
  const int y0 = blockIdx.y * kTile - halo;

  extern __shared__ float4 smem[];
  float* s_depth = reinterpret_cast<float*>(smem);
  float* s_delta[2] = {s_depth + n, s_depth + 2 * n};
  float* s_ndelta[2] = {s_depth + 3 * n, s_depth + 4 * n};
  uint8_t* bytes = reinterpret_cast<uint8_t*>(s_depth + 5 * n);
  uint8_t* s_dist[2] = {bytes, bytes + n};
  uint8_t* s_ndist[2] = {bytes + 2 * n, bytes + 3 * n};
  uint8_t* s_flags = bytes + 4 * n;

  // Load the region; interior is tested in image coordinates.
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int gy = y0 + i / s;
    const int gx = x0 + i % s;
    uint8_t f = 0;
    float d = 0.f;
    if (gy >= 0 && gy < height && gx >= 0 && gx < width) {
      const int g = gy * width + gx;
      d = depth[g];
      if (valid[g] > 0.5f) f |= kValid;
      if (supported[g] > 0.5f) f |= kSupported;
      if (gx >= 1 && gy >= 1 && gx < width - 1 && gy < height - 1)
        f |= kInterior;
    }
    s_depth[i] = d;
    s_flags[i] = f;
  }
  __syncthreads();

  // Border detection, ring initialisation and the border snap.
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int ry = i / s;
    const int rx = i % s;
    const uint8_t f = s_flags[i];
    const bool eligible = f == (kValid | kSupported | kInterior);
    bool meas_border = false;
    bool surf_border = false;
    for (int dy = -1; dy <= 1; ++dy) {
      for (int dx = -1; dx <= 1; ++dx) {
        const int yy = ry + dy, xx = rx + dx;
        const uint8_t nf = in_region(yy, xx, s) ? s_flags[yy * s + xx] : 0;
        const bool nb_valid = (nf & kValid) != 0;
        const bool nb_supported = (nf & kSupported) != 0;
        meas_border |= !nb_valid;
        surf_border |= nb_valid && !nb_supported;
      }
    }
    meas_border &= eligible;
    surf_border &= eligible;
    float delta0 = 0.f;
    float a = 0.f;
    if (eligible) {   // eligible pixels lie inside the image
      a = avg[(y0 + ry) * width + (x0 + rx)];
      delta0 = __fsub_rn(a, __fdiv_rn(s_depth[i], scale));
    }
    s_dist[0][i] = meas_border ? 1 : (eligible ? kUnknown : 0);
    s_delta[0][i] = meas_border ? delta0 : 0.f;
    s_ndist[0][i] = surf_border ? 1 : 0;
    s_ndelta[0][i] = surf_border ? delta0 : 0.f;
    if (meas_border)
      s_depth[i] = floorf(__fadd_rn(__fmul_rn(scale, a), 0.5f));
  }
  __syncthreads();

  // Jacobi ring iterations: ring `it` reads ring it-1 of the previous
  // snapshot (buffer cur) and writes the next one (buffer cur ^ 1).
  int cur = 0;
  for (int it = 2; it < radius; ++it) {
    const uint8_t ring = static_cast<uint8_t>(it - 1);
    const float one_minus =
        static_cast<float>(1.0 - static_cast<double>(it - 1) /
                                     static_cast<double>(radius - 1));
    const float blend_w = __fmul_rn(scale, one_minus);
    const uint8_t* dist = s_dist[cur];
    const float* delta = s_delta[cur];
    const uint8_t* ndist = s_ndist[cur];
    const float* ndelta = s_ndelta[cur];
    uint8_t* dist_next = s_dist[cur ^ 1];
    float* delta_next = s_delta[cur ^ 1];
    uint8_t* ndist_next = s_ndist[cur ^ 1];
    float* ndelta_next = s_ndelta[cur ^ 1];
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int ry = i / s;
      const int rx = i % s;
      float ssum = 0.f, cnt = 0.f, nsum = 0.f, ncnt = 0.f;
      for (int dy = -1; dy <= 1; ++dy) {
        for (int dx = -1; dx <= 1; ++dx) {
          const int yy = ry + dy, xx = rx + dx;
          if (!in_region(yy, xx, s)) continue;   // reads as 0: never a ring
          const int j = yy * s + xx;
          if (dist[j] == ring) {
            ssum = __fadd_rn(ssum, delta[j]);
            cnt += 1.f;
          }
          if (ndist[j] == ring) {
            nsum = __fadd_rn(nsum, ndelta[j]);
            ncnt += 1.f;
          }
        }
      }
      float d = s_depth[i];
      uint8_t dist_i = dist[i];
      float delta_i = delta[i];
      if (dist_i == kUnknown && cnt > 0.f) {
        const float avg_d = __fdiv_rn(ssum, fmaxf(cnt, 1.f));
        dist_i = static_cast<uint8_t>(it);
        delta_i = avg_d;
        d = __fadd_rn(__fadd_rn(d, __fmul_rn(blend_w, avg_d)), 0.5f);
      }
      uint8_t ndist_i = ndist[i];
      float ndelta_i = ndelta[i];
      const bool unsupported_target =
          (s_flags[i] & (kValid | kSupported | kInterior)) ==
          (kValid | kInterior);
      if (unsupported_target && ndist_i == 0 && ncnt > 0.f) {
        const float navg = __fdiv_rn(nsum, fmaxf(ncnt, 1.f));
        ndist_i = static_cast<uint8_t>(it);
        ndelta_i = navg;
        d = __fadd_rn(__fadd_rn(d, __fmul_rn(blend_w, navg)), 0.5f);
      }
      dist_next[i] = dist_i;
      delta_next[i] = delta_i;
      ndist_next[i] = ndist_i;
      ndelta_next[i] = ndelta_i;
      s_depth[i] = d;
    }
    __syncthreads();
    cur ^= 1;
  }

  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int ty = i / kTile, tx = i % kTile;
    const int gy = blockIdx.y * kTile + ty;
    const int gx = blockIdx.x * kTile + tx;
    if (gy < height && gx < width)
      out[gy * width + gx] = s_depth[(ty + halo) * s + (tx + halo)];
  }
}

}  // namespace

// Launches the kernel on `stream`; returns 0 or the CUDA error code.
extern "C" int blend_core_launch(const void* depth, const void* supported,
                                 const void* valid, const void* avg,
                                 void* out, int height, int width,
                                 int radius, float scale, void* stream) {
  const int s = kTile + 2 * halo_for(radius);
  const size_t smem = static_cast<size_t>(s) * s * kBytesPerPixel;
  cudaError_t err = cudaFuncSetAttribute(
      blend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile);
  blend_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(depth), static_cast<const float*>(supported),
      static_cast<const float*>(valid), static_cast<const float*>(avg),
      static_cast<float*>(out), height, width, radius, scale);
  return static_cast<int>(cudaGetLastError());
}
