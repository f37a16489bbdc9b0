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
// What bounds them on this card.  Per index a row kernel reads 4 B of
// index and 32 B of each source and writes 32 B of each output; no
// arithmetic.  At the probe's sizes (HW 307,200, N 500,736) one source is
// 9.8 MB and one output 16 MB.  The byte bound (PERF.md section 6) counts
// device-memory bytes; what the kernels meet first depends on the layout:
// - gather_rows: one source and its output (26 MB) fit the 50 MB L2.
//   One thread a row, two 16-B loads and two 16-B stores (a row is 32 B
//   and 16-B aligned), so neighbouring threads write neighbouring rows.
// - gather_rows3: three sources and three outputs, 77.6 MB, do not fit.
//   Bound by device-memory bytes: the 48 MB output stream evicts the
//   sources it must read again, so part of the scattered 32-B source reads
//   go to device memory.  The design: two lanes a row, 16 B each, so a
//   warp's load reads 16 whole 32-B sectors and its store writes 512
//   contiguous bytes; stores are streaming (st.global.cs, evict-first), so
//   the output lines leave L2 before the sources.  More rows a thread (more
//   registers, fewer warps) and an evict-last hint on the source loads did
//   not help on this card, nor did one TMA bulk store a block.
// - gather_lane: the (8, HW) layout puts the 8 words of a row HW apart, so
//   a direct gather touches 8 sectors (256 B) for 32 useful bytes:
//   500,736 x 8 x 32 B = 128.2 MB through L2, bound by the L2-to-SM rate
//   (chip_smoke.py [gather] measures it with csrc/l2_read.cu), far above
//   the byte bound.  The design gathers in two passes in one call: the
//   source is first transposed into (HW, 8) rows in a scratch buffer (9.8
//   MB read and written, coalesced both ways: a warp reads 128 B of each
//   plane and writes 1 KB of rows), then each index reads its row, one
//   sector, and stores the 8 words to the 8 output planes, coalesced along
//   N, with streaming stores.  That is 16 MB of row sectors instead of
//   128.2 MB, for the 19.6 MB of the transpose, which stays in L2: 53.7 MB
//   through L2 with the indices and the output, the design's own L2-level
//   bound (chip_smoke.py [gather] prints both).  The transpose costs the
//   same whatever N is, so the two passes assume N of the order of HW or
//   larger, as the probe's N = 1.6 x HW; at N = 1 they move 19.6 MB to
//   return 32 B.  No caller gathers few indices, so there is no fork by
//   size.
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

// Thread t moves half t & 1 (16 B) of output row t >> 1 of each source.
__global__ void gather_rows3_kernel(const int4* __restrict__ src_a,
                                    const int4* __restrict__ src_b,
                                    const int4* __restrict__ src_c,
                                    const int* __restrict__ idx,
                                    int4* __restrict__ out_a,
                                    int4* __restrict__ out_b,
                                    int4* __restrict__ out_c, long long n,
                                    int hw) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= 2 * n) return;
  const long long off = 2 * clamped(idx, t >> 1, hw) + (t & 1);
  // The three loads issue before the first store.
  const int4 a = __ldg(src_a + off);
  const int4 b = __ldg(src_b + off);
  const int4 c = __ldg(src_c + off);
  __stcs(out_a + t, a);
  __stcs(out_b + t, b);
  __stcs(out_c + t, c);
}

// Lane form, pass 1: the (8, HW) planes into (HW, 8) rows, one row a
// thread.
__global__ void lane_transpose_kernel(const uint32_t* __restrict__ src,
                                      int4* __restrict__ rows, int hw) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= hw) return;
  uint32_t v[8];
  #pragma unroll
  for (int p = 0; p < 8; ++p)
    v[p] = __ldg(src + p * static_cast<long long>(hw) + j);
  rows[2 * j] = make_int4(v[0], v[1], v[2], v[3]);
  rows[2 * j + 1] = make_int4(v[4], v[5], v[6], v[7]);
}

// Lane form, pass 2: one thread an output column, its row gathered from
// the (HW, 8) scratch and stored across the 8 planes of the (8, N) output.
__global__ void lane_gather_kernel(const int4* __restrict__ rows,
                                   const int* __restrict__ idx,
                                   uint32_t* __restrict__ out, long long n,
                                   int hw) {
  const long long col = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (col >= n) return;
  const long long off = 2 * clamped(idx, col, hw);
  const int4 lo = __ldg(rows + off);
  const int4 hi = __ldg(rows + off + 1);
  const uint32_t v[8] = {
      static_cast<uint32_t>(lo.x), static_cast<uint32_t>(lo.y),
      static_cast<uint32_t>(lo.z), static_cast<uint32_t>(lo.w),
      static_cast<uint32_t>(hi.x), static_cast<uint32_t>(hi.y),
      static_cast<uint32_t>(hi.z), static_cast<uint32_t>(hi.w)};
  #pragma unroll
  for (int p = 0; p < 8; ++p) __stcs(out + p * n + col, v[p]);
}

inline unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Each launch returns cudaGetLastError() after the launch (0 = launched).
// Callers guarantee n >= 1, hw >= 1, 16-byte aligned row pointers and
// contiguous (HW, 8) / (N, 8) f32 buffers (or (8, HW) / (8, N) for the
// lane form, with a (HW, 8) scratch buffer for its rows).

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
  gather_rows3_kernel<<<blocks_for(2 * n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(src_a), static_cast<const int4*>(src_b),
      static_cast<const int4*>(src_c), static_cast<const int*>(idx),
      static_cast<int4*>(out_a), static_cast<int4*>(out_b),
      static_cast<int4*>(out_c), n, hw);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_lane_launch(const void* src, const void* idx,
                                  void* out, void* rows, long long n, int hw,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  lane_transpose_kernel<<<blocks_for(hw), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(src), static_cast<int4*>(rows), hw);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lane_gather_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const int4*>(rows), static_cast<const int*>(idx),
      static_cast<uint32_t*>(out), n, hw);
  return static_cast<int>(cudaGetLastError());
}
