// Tile selection of active-set fusion for Hopper (sm_90a): the per-tile
// flags of ops/tiling.py::tile_flags, one launch a tiled frame.
//
// Replaces no TPU kernel: the JAX package flags its tiles with XLA
// elementwise ops (surfelmeshing_tpu/ops/fusion.py::_integrate_tiled), and
// the port ran the plain version (ops/tiling.py::tile_flags_reference,
// kept as the CPU route and the yardstick): ~60 launches over every row of
// the capacity, live or not, with (4, n) gathers of the neighbours'
// positions and stamps.  At the default 20,000,768-row map a live capture
// fills a tenth of, that reads and writes gigabytes a frame.
//
// What bounds it on this card: bytes, and only those of live rows.  A row
// reads its position, stamp and recent-neighbour count (20 B of its 72 B
// pack row) and its 4 neighbour slots (16 B); a row that its own tests do
// not flag reads, for each valid slot, the neighbour's position and stamp
// (and detach flag without fast_neighbor_update): 16-20 B gathered at
// random.  At 1.8M live rows ~0.1-0.2 GB, tens of microseconds at
// 3.35 TB/s; the arithmetic (a 3x4 transform, two divisions a point) is
// far below the card's rates.
//
// Design: a grid-stride loop over the rows below the surfel count, read
// on the device (so a CUDA graph bakes in no count and rows past it cost
// nothing but the loop's bound); one thread a row; a row stops at its
// first test that flags it.  A flagged row stores 1 into its tile's flag
// byte (zeroed by the caller): every store writes the same value, so their
// order does not matter.  The frame index is read through a device pointer
// when the caller passes one.
//
// Bit for bit equal to the plain version as CUDA PyTorch runs it:
// - fusion._transform and fusion._project's f32 operations as __f*_rn
//   intrinsics (no contraction into FMAs), the IEEE division x / safe_z;
// - preprocess.to_i32_trunc: NaN to 0, the value clamped to +-2^30, then
//   truncated toward zero;
// - Python float scalars (fx, fy, cx, cy) arrive as f32, rounded to
//   nearest as torch rounds a wrapped scalar to the tensor's dtype;
// - stamps and slots are int32 bits; the window test is int32
//   arithmetic, as the plain code's on an int32 tensor.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The launcher's arguments (ops/tiling.py::_Args, field for field).
struct TileSelectArgs {
  const float* pack;           // (n, 18), row-major
  const int* neighbors;        // (4, n), slot-major
  const int* count;            // () surfel_count
  const float* local_T_global;  // (3, 4) row-major
  const int* frame;            // () frame index, or null: frame_value
  uint8_t* tile_flags;         // (n / tile_size,), zeroed
  long long n;
  int tile_size;
  int frame_value;
  int window;                  // regularization_frame_window_size
  int width;
  int height;
  int fast;                    // fast_neighbor_update
  float fx;
  float fy;
  float cx;
  float cy;
};

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;
constexpr int kInvalidIndex = 0x7FFFFFFF;
constexpr float kCastLimit = 1073741824.0f;     // 2^30

// Pack columns (ops/fusion.py).
constexpr int kPX = 0, kPY = 1, kPZ = 2, kStamp = 6, kRcnt = 10;
constexpr int kDetach = 11, kWidth = 18;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// preprocess.to_i32_trunc.
__device__ __forceinline__ int to_i32_trunc(float x) {
  if (isnan(x)) return 0;
  return __float2int_rz(fminf(fmaxf(x, -kCastLimit), kCastLimit));
}

// fusion._project(fusion._transform(T, x, y, z))'s in_image.
__device__ __forceinline__ bool in_view(const TileSelectArgs& a,
                                        const float (&T)[12], float x,
                                        float y, float z) {
  const float lx = add(add(add(mul(T[0], x), mul(T[1], y)), mul(T[2], z)),
                       T[3]);
  const float ly = add(add(add(mul(T[4], x), mul(T[5], y)), mul(T[6], z)),
                       T[7]);
  const float lz = add(add(add(mul(T[8], x), mul(T[9], y)), mul(T[10], z)),
                       T[11]);
  const float safe_z = lz > 0.0f ? lz : 1.0f;
  const float u = add(mul(a.fx, __fdiv_rn(lx, safe_z)), a.cx);
  const float v = add(mul(a.fy, __fdiv_rn(ly, safe_z)), a.cy);
  return lz > 0.0f && u >= 0.0f && v >= 0.0f &&
         to_i32_trunc(u) < a.width && to_i32_trunc(v) < a.height;
}

__global__ void __launch_bounds__(kThreads)
tile_select_kernel(const TileSelectArgs a) {
  const long long count = static_cast<long long>(__ldg(a.count));
  const int frame = a.frame != nullptr ? __ldg(a.frame) : a.frame_value;
  const int since = frame - a.window - 1;
  float T[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) T[k] = __ldg(a.local_T_global + k);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long end = count < a.n ? count : a.n;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < end; i += stride) {
    const float* row = a.pack + i * kWidth;
    bool flag = __float_as_int(__ldg(row + kStamp)) >= since ||
                __ldg(row + kRcnt) != 0.0f ||
                in_view(a, T, __ldg(row + kPX), __ldg(row + kPY),
                        __ldg(row + kPZ));
#pragma unroll
    for (int k = 0; k < 4 && !flag; ++k) {
      const int j = __ldg(a.neighbors + k * a.n + i);
      if (j == kInvalidIndex) continue;
      // fusion._safe_idx: an index out of [0, n) reads row 0.
      const long long s = (j < 0 || j >= a.n) ? 0 : j;
      const float* nrow = a.pack + s * kWidth;
      const int stamp = __float_as_int(__ldg(nrow + kStamp));
      flag = stamp >= since || stamp == 0 ||
             (!a.fast && __ldg(nrow + kDetach) > 0.0f) ||
             in_view(a, T, __ldg(nrow + kPX), __ldg(nrow + kPY),
                     __ldg(nrow + kPZ));
    }
    if (flag) a.tile_flags[i / a.tile_size] = 1;
  }
}

}  // namespace

// Enqueues the kernel on `stream`; returns 0 or the CUDA error code.
extern "C" int tile_select_launch(const TileSelectArgs* args, void* stream) {
  if (args->n < 0 || args->tile_size <= 0 || args->n % args->tile_size != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (args->n == 0) return 0;
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long rows_blocks = (args->n + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSM;
  const unsigned blocks =
      static_cast<unsigned>(rows_blocks < cap ? rows_blocks : cap);
  tile_select_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
