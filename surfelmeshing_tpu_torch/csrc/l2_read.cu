// L2 read-rate probe for Hopper (sm_90a): a measurement kernel, not a port
// of a TPU kernel.  It streams a buffer that fits the 50 MB L2 `passes`
// times with 16-byte loads that bypass L1 (ld.global.cg), so after the
// first pass every load is an L2 hit; bytes read over the device time
// (tools/kernel_timing.py::l2_read_bytes_per_s) is the L2-to-SM rate that
// the gathers' sector bounds divide by (PERF.md section 6).
//
// Each thread keeps four loads in flight and folds them into an XOR that
// is stored only if it equals an unlikely constant, so no load is dead.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void l2_read_kernel(const int4* __restrict__ buf, long long nvec,
                               int passes, int4* __restrict__ sink) {
  int4 acc = make_int4(0, 0, 0, 0);
  const long long stride = gridDim.x * static_cast<long long>(kThreads);
  const long long first = blockIdx.x * static_cast<long long>(kThreads) +
                          threadIdx.x;
  for (int r = 0; r < passes; ++r) {
    long long i = first;
    for (; i + 3 * stride < nvec; i += 4 * stride) {
      const int4 a = __ldcg(buf + i), b = __ldcg(buf + i + stride),
                 c = __ldcg(buf + i + 2 * stride),
                 d = __ldcg(buf + i + 3 * stride);
      acc.x ^= a.x ^ b.x ^ c.x ^ d.x;
      acc.y ^= a.y ^ b.y ^ c.y ^ d.y;
      acc.z ^= a.z ^ b.z ^ c.z ^ d.z;
      acc.w ^= a.w ^ b.w ^ c.w ^ d.w;
    }
    for (; i < nvec; i += stride) {
      const int4 a = __ldcg(buf + i);
      acc.x ^= a.x; acc.y ^= a.y; acc.z ^= a.z; acc.w ^= a.w;
    }
    acc.x += r;
  }
  if (acc.x == 0x13572468 && acc.y == 0x2468ace0) sink[0] = acc;
}

}  // namespace

// Streams nvec int4 of `buf` `passes` times with `blocks` blocks of 256
// threads on `stream`; returns cudaGetLastError() after the launch.
extern "C" int l2_read_launch(const void* buf, long long nvec, int passes,
                              void* sink, int blocks, void* stream) {
  l2_read_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(buf), nvec, passes, static_cast<int4*>(sink));
  return static_cast<int>(cudaGetLastError());
}
