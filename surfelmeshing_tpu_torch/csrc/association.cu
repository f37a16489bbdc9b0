// Data association's per-pixel maps for Hopper (sm_90a): phases 1-2 of
// ops/fusion.py::_integrate_body, the reference's RenderMinDepth and the
// supporter claims of Associate (cuda_surfel_reconstruction_kernels.cu:
// 1458-1557, 1586-1854).
//
// Replaces no TPU kernel: the JAX package builds these maps with XLA
// scatters, and the port built them with plain scatter_reduce /
// scatter_add calls (ops/association.py::pixel_map, kept as the CPU route
// and the yardstick).  Each surfel row has two candidate pixels, its own
// (pix_a) and a side pixel (pix_b), either INVALID_INDEX: a row out of
// view, behind the camera, past surfel_count or (for the support maps)
// not a supporter.  The plain version scatters all 2N entries of
// cat([a, b]) with an int64 index built over 2N and sends every invalid
// entry to one extra slot.  Most rows of a map of millions are out of
// view, so millions of atomics a scatter meet at that one address, where
// they serialise in L2 (f32 amin is a compare-and-swap loop that retries
// under contention besides).
//
// What bounds them on this card.  Bytes: a row reads two pixels, z, two
// support flags and its index, ~20 B; at 7.5M rows ~150 MB, ~45 us at
// 3.35 TB/s, plus the (H, W) maps.  Atomics land only on in-image
// entries, a few per pixel, spread over the map's ~1M words.
//
// Design: one thread a row; an entry whose pixel is not in [0, hw) is
// skipped (INVALID_INDEX among them), so nothing meets at a dropped slot
// and no index array is built.  Two launches, since the support tests
// read the complete min-depth map in between:
// - min_depth_kernel: atomicMin of z's bits into first_depth (filled
//   with +inf by the caller).  Every valid entry has z > 0 (a projected
//   row is in front of the camera), and for positive floats, +inf
//   included, the order of the bits as int32 is the order of the values,
//   so the native 32-bit integer min gives the f32 min exactly.
// - support_kernel: atomicMin of the row's index into the supporter map
//   (filled with INVALID_INDEX) and, when `packed` is given, atomicAdd of
//   z_units + (1 << SUM_BITS) into the packed count + depth sum (filled
//   with 0), for the supporting sides only.  z_units is computed as the
//   plain code computes it: round half to even of the f32 product
//   z * depth_scaling (__fmul_rn, rintf), clamped to [0, 2^17 - 1].
//   Without `packed` it builds a min-index map alone (the exact
//   conflictor map).
// Integer min and wrapping integer add are order-independent, so the maps
// equal the plain scatters bit for bit, whatever order the atomics land
// in.  The returned values are unused, so the atomics compile to
// fire-and-forget reductions (RED).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kSumUnit = 1u << 25;       // 1 << SUM_BITS
constexpr float kMaxDepthUnits = 131071.0f;   // (1 << 17) - 1

__device__ __forceinline__ bool in_map(int pix, int hw) {
  return static_cast<unsigned>(pix) < static_cast<unsigned>(hw);
}

__global__ void min_depth_kernel(const int* __restrict__ pix_a,
                                 const int* __restrict__ pix_b,
                                 const float* __restrict__ z, int64_t n,
                                 int* __restrict__ first_depth, int hw) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (i >= n) return;
  const int a = pix_a[i];
  const int b = pix_b[i];
  const bool on_a = in_map(a, hw);
  const bool on_b = in_map(b, hw);
  if (!on_a && !on_b) return;
  const int bits = __float_as_int(z[i]);
  if (on_a) atomicMin(first_depth + a, bits);
  if (on_b) atomicMin(first_depth + b, bits);
}

template <bool kSums>
__global__ void support_kernel(const int* __restrict__ pix_a,
                               const int* __restrict__ pix_b,
                               const uint8_t* __restrict__ on_a,
                               const uint8_t* __restrict__ on_b,
                               const int* __restrict__ idx,
                               const float* __restrict__ z, int64_t n,
                               float depth_scaling,
                               int* __restrict__ min_index,
                               unsigned* __restrict__ packed, int hw) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (i >= n) return;
  const bool sa = on_a[i];
  const bool sb = on_b[i];
  if (!sa && !sb) return;
  const int a = pix_a[i];
  const int b = pix_b[i];
  const bool use_a = sa && in_map(a, hw);
  const bool use_b = sb && in_map(b, hw);
  if (!use_a && !use_b) return;
  const int row = idx[i];
  if (use_a) atomicMin(min_index + a, row);
  if (use_b) atomicMin(min_index + b, row);
  if constexpr (kSums) {
    // z > 0 here, so fmaxf / fminf clamp as torch's clamp does.
    const float units = fminf(fmaxf(rintf(__fmul_rn(z[i], depth_scaling)),
                                    0.0f), kMaxDepthUnits);
    const unsigned add = static_cast<unsigned>(static_cast<int>(units)) +
                         kSumUnit;
    if (use_a) atomicAdd(packed + a, add);
    if (use_b) atomicAdd(packed + b, add);
  }
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>(n > 0 ? (n + kThreads - 1) / kThreads : 1);
}

inline int launched() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Each launcher enqueues its kernel on `stream` and returns 0 or the CUDA
// error code.  Row arrays are contiguous: pixels and indices int32, flags
// one byte (torch.bool), z f32; the maps hold hw words, filled by the
// caller.  depth_scaling comes as a double and is rounded to f32 here, as
// torch rounds a Python float multiplying an f32 tensor.

extern "C" int min_depth_launch(const void* pix_a, const void* pix_b,
                                const void* z, long long n,
                                void* first_depth, int hw, void* stream) {
  if (n < 0 || hw < 0) return static_cast<int>(cudaErrorInvalidValue);
  min_depth_kernel<<<blocks_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pix_a), static_cast<const int*>(pix_b),
      static_cast<const float*>(z), n, static_cast<int*>(first_depth), hw);
  return launched();
}

// `packed` null: the min-index map alone (z and depth_scaling unread).
extern "C" int support_launch(const void* pix_a, const void* pix_b,
                              const void* on_a, const void* on_b,
                              const void* idx, const void* z, long long n,
                              double depth_scaling, void* min_index,
                              void* packed, int hw, void* stream) {
  if (n < 0 || hw < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = packed != nullptr ? support_kernel<true>
                                  : support_kernel<false>;
  kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pix_a), static_cast<const int*>(pix_b),
      static_cast<const uint8_t*>(on_a), static_cast<const uint8_t*>(on_b),
      static_cast<const int*>(idx), static_cast<const float*>(z), n,
      static_cast<float>(depth_scaling), static_cast<int*>(min_index),
      static_cast<unsigned*>(packed), hw);
  return launched();
}
