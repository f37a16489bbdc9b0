// Measurement blending at any radius, for Hopper (sm_90a): the "wide" path.
//
// Replaces surfelmeshing_tpu/ops/fusion.py::_blend_pallas (:1715, body
// _blend_core :1624) for the radii csrc/blend.cu does not take (radius >
// 32, where its 64-column region would have no core left).  The default
// radius is 12, so the main path never comes here; a user who raises
// --measurement_blending_radius does.
//
// Design: global maps, one launch an iteration.
// - An init kernel, one thread a pixel, does the 3x3 border tests, the
//   snap of measurement-border pixels to the supporter average, and writes
//   the ring maps dist / ndist (int32) and deltas delta / ndelta (f32) into
//   scratch that the wrapper allocates.
// - Then one launch of the ring kernel for each iteration it = 2 ..
//   radius-1, one thread a pixel, updating the maps and the output depth in
//   place.  The number of launches depends only on the radius, so the path
//   has no host synchronisation and can be captured in a CUDA graph.
//
// dist and ndist hold _blend_core's own values (0 = untouched, 1..radius-1
// = ring, 255 = unknown), not open/ring bit masks, because the reference's
// sentinel collides with a ring number: in iteration 256 every pixel still
// at 255 reads as ring 255, counts itself, and grows again, gaining
// blend_w * mean + 0.5.  Values reproduce that; masks would not.
//
// In-place updates are exact for every other iteration: iteration it reads
// a neighbour only when it is on ring it-1 and writes only open pixels
// (dist 255, or an unsupported target with ndist 0), which become ring it;
// ring it-1 is never written.  Iteration 256 is the exception on the dist
// side, where ring it-1 and the open set are the same value: the launcher
// snapshots dist and delta first and that one launch reads the snapshot
// (the Jacobi order of _blend_core).
//
// What bounds it on this card: the chain of radius-1 dependent launches,
// not bytes.  Each ring launch reads 12 bytes for a pixel that cannot grow
// and up to about 90 for one that can, from maps that stay in L2 (5 maps of
// 1.2 MB at 640x480), so a launch costs a few L2 round trips and its own
// start.  The function's byte bound is that of csrc/blend.cu (6,144,000 B
// at 640x480); PERF.md has the wide path's device time beside it
// (chip_smoke.py [kernel], radius 48).  Carrying T iterations a launch on a
// tile with a halo of T would cut the launches T-fold; the main path never
// runs this path, so the simple form stays.
//
// Arithmetic is _blend_core's, operation by operation, with the __f*_rn
// intrinsics (no FMA contraction) and ring sums in its neighbour order, so
// the result equals the plain PyTorch version bit for bit.  Pixels outside
// the image read as 0.  Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnknown = 255;   // _blend_core's dist value for "not reached"

// Scratch planes of h*w 4-byte words; ops/blend.py::WIDE_SCRATCH_PLANES
// allocates kPlanes of them.
enum Plane { kDist, kDelta, kNDist, kNDelta, kTarget, kDistSnap, kDeltaSnap,
             kPlanes };

__global__ void wide_init_kernel(const float* __restrict__ depth,
                                 const float* __restrict__ supported,
                                 const float* __restrict__ valid,
                                 const float* __restrict__ avg,
                                 float* __restrict__ out,
                                 int* __restrict__ dist,
                                 float* __restrict__ delta,
                                 int* __restrict__ ndist,
                                 float* __restrict__ ndelta,
                                 int* __restrict__ target,
                                 int height, int width, float scale) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= height * width) return;
  const int y = p / width, x = p - y * width;
  const bool interior = x >= 1 && y >= 1 && x < width - 1 && y < height - 1;
  const bool vb = valid[p] > 0.5f, sb = supported[p] > 0.5f;
  const bool eligible = interior && vb && sb;
  bool meas = false, surf = false;
  for (int dy = -1; dy <= 1; ++dy) {
    for (int dx = -1; dx <= 1; ++dx) {
      const int yy = y + dy, xx = x + dx;
      const bool in = yy >= 0 && yy < height && xx >= 0 && xx < width;
      const int q = yy * width + xx;
      const bool nv = in && valid[q] > 0.5f;
      const bool ns = in && supported[q] > 0.5f;
      meas |= !nv;
      surf |= nv && !ns;
    }
  }
  meas &= eligible;
  surf &= eligible;
  const float d = depth[p], a = avg[p];
  const float delta0 = __fsub_rn(a, __fdiv_rn(d, scale));
  dist[p] = meas ? 1 : (eligible ? kUnknown : 0);
  delta[p] = meas ? delta0 : 0.f;
  ndist[p] = surf ? 1 : 0;
  ndelta[p] = surf ? delta0 : 0.f;
  target[p] = interior && vb && !sb;
  out[p] = meas ? floorf(__fadd_rn(__fmul_rn(scale, a), 0.5f)) : d;
}

// Iteration `it`: a pixel that is open on one side averages the deltas of
// its neighbours on ring it-1 of that side (read from ring_in / vals_in),
// joins ring it and pulls its depth toward the average.  A pixel open on
// the dist side is eligible, hence supported; a target is not: the sides
// never meet in one pixel.
// The loads are issued in two rounds that do not wait on each other within
// a round (the pixel's own three words; its nine neighbours' ring numbers),
// so a pixel that cannot grow costs one L2 round trip and one that can
// three; testing the words one after another was measurably slower.
__global__ void wide_ring_kernel(const int* ring_in, const float* vals_in,
                                 int* dist, float* delta,
                                 int* ndist, float* ndelta,
                                 const int* __restrict__ target,
                                 float* __restrict__ out,
                                 int height, int width, int it, int radius,
                                 float scale) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= height * width) return;
  const int d = dist[p], tg = target[p], nd = ndist[p];
  const bool dist_side = d == kUnknown;
  if (!dist_side && !(tg && nd == 0)) return;
  const int* rd = dist_side ? ring_in : ndist;
  const float* rv = dist_side ? vals_in : ndelta;
  const int y = p / width, x = p - y * width;
  int ring[9];                  // neighbours in _blend_core's order
  #pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int yy = y + k / 3 - 1, xx = x + k % 3 - 1;
    const bool in = yy >= 0 && yy < height && xx >= 0 && xx < width;
    ring[k] = in ? rd[yy * width + xx] : 0;
  }
  float sum = 0.f;              // never -0.0, so skipped +0.0 adds are exact
  int cnt = 0;
  #pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (ring[k] == it - 1) {
      sum = __fadd_rn(sum, rv[(y + k / 3 - 1) * width + x + k % 3 - 1]);
      ++cnt;
    }
  }
  if (cnt == 0) return;
  const float mean = __fdiv_rn(sum, static_cast<float>(cnt));
  const float one_minus = static_cast<float>(
      1.0 - static_cast<double>(it - 1) / static_cast<double>(radius - 1));
  const float blend_w = __fmul_rn(scale, one_minus);
  (dist_side ? dist : ndist)[p] = it;
  (dist_side ? delta : ndelta)[p] = mean;
  out[p] = __fadd_rn(__fadd_rn(out[p], __fmul_rn(blend_w, mean)), 0.5f);
}

}  // namespace

// Launches the init kernel and radius-2 ring kernels on `stream`, adding
// one to *kernels (a host int) for each kernel it enqueues; returns 0 or
// the first CUDA error code.  Callers guarantee radius >= 1, contiguous
// (height, width) f32 maps and kPlanes planes of scratch.
extern "C" int blend_wide_launch(const void* depth, const void* supported,
                                 const void* valid, const void* avg,
                                 void* out, void* scratch, int height,
                                 int width, int radius, float scale,
                                 void* stream, int* kernels) {
  if (radius < 1 || height < 1 || width < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(height) * width;
  int32_t* planes = static_cast<int32_t*>(scratch);
  auto plane = [&](int k) { return planes + k * n; };
  int* dist = plane(kDist);
  float* delta = reinterpret_cast<float*>(plane(kDelta));
  int* ndist = plane(kNDist);
  float* ndelta = reinterpret_cast<float*>(plane(kNDelta));
  const int* target = plane(kTarget);
  float* o = static_cast<float*>(out);
  const unsigned int blocks =
      static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  wide_init_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(depth), static_cast<const float*>(supported),
      static_cast<const float*>(valid), static_cast<const float*>(avg), o,
      dist, delta, ndist, ndelta, plane(kTarget), height, width, scale);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*kernels;
  for (int it = 2; it < radius && err == cudaSuccess; ++it) {
    const int* ring_in = dist;
    const float* vals_in = delta;
    if (it - 1 == kUnknown) {   // ring 255 is also the open set: Jacobi
      err = cudaMemcpyAsync(plane(kDistSnap), dist, n * sizeof(int),
                            cudaMemcpyDeviceToDevice, s);
      if (err == cudaSuccess)
        err = cudaMemcpyAsync(plane(kDeltaSnap), delta, n * sizeof(float),
                              cudaMemcpyDeviceToDevice, s);
      if (err != cudaSuccess) break;
      ring_in = plane(kDistSnap);
      vals_in = reinterpret_cast<const float*>(plane(kDeltaSnap));
    }
    wide_ring_kernel<<<blocks, kThreads, 0, s>>>(
        ring_in, vals_in, dist, delta, ndist, ndelta, target, o, height,
        width, it, radius, scale);
    err = cudaGetLastError();
    if (err == cudaSuccess) ++*kernels;
  }
  return static_cast<int>(err);
}
