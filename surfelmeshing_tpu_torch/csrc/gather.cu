// Row gathers for Hopper (sm_90a): out[n, :] = src[clamp(idx[n]), :].
//
// Replaces the three Pallas kernels of tools/gather_probe.py::run:
//   pallas_gather      -> gather_rows   (src (HW, 8), out (N, 8))
//   pallas_gather3     -> gather_rows3  (three sources, one index vector)
//   pallas_gather_lane -> gather_lane   (src (8, HW), out (8, N))
// The Pallas kernels keep the whole source in VMEM and gather with
// take_along_axis in source-sized blocks; their index padding and
// slicing exist for Mosaic's shape rules and have no counterpart here:
// each launch covers exactly N indices.
//
// What bounds them on this card: bytes.  Per index a row kernel reads 4 B
// of index and 32 B of source and writes 32 B; no arithmetic.  At the
// probe's sizes the source (307,200 x 8 f32, 9.8 MB) fits the 50 MB L2, so
// after the first touch the scattered source reads hit L2 and the 16 MB
// output stream goes to device memory.  The design keeps every access as
// wide as the row allows: one thread per output row, two 16-byte vector
// loads and two 16-byte stores (a row is 32 B and 16-B aligned), so
// neighbouring threads write neighbouring 32-B rows and the stores
// coalesce.  The lane form stores coalesced along N but loads one 4-B
// word from each of the 8 planes per index, scattered.
//
// The kernels move bits, never floats: rows go through int4 / uint32
// registers, so NaN payloads (the INVALID_INDEX pattern riding in f32
// lanes), -0.0 and denormals arrive unchanged.  Out-of-range indices clamp
// to [0, HW-1], like the plain versions in ops/gather.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long clamped(const int* idx, long long n,
                                             int hw) {
  const int i = __ldg(idx + n);
  return static_cast<long long>(i < 0 ? 0 : (i >= hw ? hw - 1 : i));
}

__global__ void gather_rows_kernel(const int4* __restrict__ src,
                                   const int* __restrict__ idx,
                                   int4* __restrict__ out, long long n,
                                   int hw) {
  const long long row = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (row >= n) return;
  const int4* s = src + 2 * clamped(idx, row, hw);
  const int4 a = __ldg(s);
  const int4 b = __ldg(s + 1);
  out[2 * row] = a;
  out[2 * row + 1] = b;
}

__global__ void gather_rows3_kernel(const int4* __restrict__ src_a,
                                    const int4* __restrict__ src_b,
                                    const int4* __restrict__ src_c,
                                    const int* __restrict__ idx,
                                    int4* __restrict__ out_a,
                                    int4* __restrict__ out_b,
                                    int4* __restrict__ out_c, long long n,
                                    int hw) {
  const long long row = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (row >= n) return;
  const long long off = 2 * clamped(idx, row, hw);
  // All six loads issue before the first store.
  const int4 a0 = __ldg(src_a + off), a1 = __ldg(src_a + off + 1);
  const int4 b0 = __ldg(src_b + off), b1 = __ldg(src_b + off + 1);
  const int4 c0 = __ldg(src_c + off), c1 = __ldg(src_c + off + 1);
  out_a[2 * row] = a0;
  out_a[2 * row + 1] = a1;
  out_b[2 * row] = b0;
  out_b[2 * row + 1] = b1;
  out_c[2 * row] = c0;
  out_c[2 * row + 1] = c1;
}

__global__ void gather_lane_kernel(const uint32_t* __restrict__ src,
                                   const int* __restrict__ idx,
                                   uint32_t* __restrict__ out, long long n,
                                   int hw, int planes) {
  const long long col = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (col >= n) return;
  const long long i = clamped(idx, col, hw);
  for (int p = 0; p < planes; ++p) {
    out[p * n + col] = __ldg(src + p * static_cast<long long>(hw) + i);
  }
}

inline unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Each launch returns cudaGetLastError() after the launch (0 = launched).
// Callers guarantee n >= 1, hw >= 1, 16-byte aligned row pointers and
// contiguous (HW, 8) / (N, 8) f32 buffers (or (8, HW) / (8, N) for the
// lane form).

extern "C" int gather_rows_launch(const void* src, const void* idx,
                                  void* out, long long n, int hw,
                                  void* stream) {
  gather_rows_kernel<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(src), static_cast<const int*>(idx),
      static_cast<int4*>(out), n, hw);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_rows3_launch(const void* src_a, const void* src_b,
                                   const void* src_c, const void* idx,
                                   void* out_a, void* out_b, void* out_c,
                                   long long n, int hw, void* stream) {
  gather_rows3_kernel<<<blocks_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(src_a), static_cast<const int4*>(src_b),
      static_cast<const int4*>(src_c), static_cast<const int*>(idx),
      static_cast<int4*>(out_a), static_cast<int4*>(out_b),
      static_cast<int4*>(out_c), n, hw);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_lane_launch(const void* src, const void* idx,
                                  void* out, long long n, int hw,
                                  int planes, void* stream) {
  gather_lane_kernel<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<const int*>(idx),
      static_cast<uint32_t*>(out), n, hw, planes);
  return static_cast<int>(cudaGetLastError());
}
