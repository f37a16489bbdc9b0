// Regularisation for Hopper (sm_90a): one iteration of phase 8 of the
// fusion step in its symmetric form (ops/regularization.py; the
// reference's RegularizeSurfels kernels, cuda_surfel_reconstruction_
// kernels.cu:2099-2308), one launch a fused frame per iteration.
//
// Replaces no TPU kernel: the JAX package runs phase 8 as XLA ops, and
// the port ran it as plain PyTorch (ops/regularization.py::
// regularize_reference, kept as the CPU route and the yardstick): eight
// (4, N) column gathers of the neighbours' rows, a dozen (4, N)
// differences, dots, masks and slot sums, the clamped step and the
// column writes into a clone of the pack, ~150 launches over every row a
// call.  At the 7.5M rows of a Replica-sized map that was ~19 ms a frame
// and the step's peak device memory.
//
// What bounds it on this card: bytes.  Every row reads its 72 B pack row
// and its 4 neighbour slots (16 B) and writes its row, its slots and,
// with fast_neighbor_update, its slot distances (72 + 16 + 16 B).  Each
// valid slot gathers 8 words of the neighbour's row (SX..RCNT, 32 B at a
// random row; on the full route those rows are the pack's own, read again
// through L1/L2).  At 7.5M rows ~1.4 GB of distinct bytes, ~0.43 ms at
// 3.35 TB/s; the arithmetic (~150 f32 operations and two f64 square roots
// a row) is far below the card's rates.
//
// Design: one thread a row.  A block of 256 rows copies its 18,432 B of
// pack rows into shared memory with coalesced word loads, each thread
// updates its row there, and the block writes the rows out the same way:
// the out-of-place copy of the pack (the plain version's clone) costs one
// coalesced read and one coalesced write, and no thread reads a word that
// another writes (neighbours are read from `gsrc`, which nothing writes).
// A thread loads its 4 slots (slot-major, coalesced), then issues the
// gathers of every slot it needs before using any, so up to 32 loads are
// in flight a thread.  A row outside the window (not "recent") needs no
// step: it gathers only its valid slots and writes RCNT, the slot drops
// and distances.  The frame index is read through a device pointer when
// the caller passes one, so a captured CUDA graph bakes in no frame.
//
// Bit for bit equal to the plain version as CUDA PyTorch runs it, so the
// arithmetic follows its operations one by one:
// - every f32 operation is an __f*_rn intrinsic, so nvcc cannot contract
//   a*b+c into an FMA (the plain code rounds the product and the sum);
//   build without --use_fast_math (IEEE divisions, no flush to zero);
// - fusion._div(c, t) is an IEEE division of the f32 constant c;
//   sqrt_f32 is the f64 square root rounded to f32;
// - slot sums run in slot order, ((x0 + x1) + x2) + x3, over all four
//   slots: a slot that contributes nothing adds +0.0, or for a gradient
//   term +0.0 times the normal of the row the plain gather read (row 0
//   for an invalid or out-of-range index), whose sign a sum of zeros
//   keeps;
// - clamp_min passes NaN through, and comparisons with NaN are false, so
//   a merged row (radius -1: the step limit is NaN) takes the unclamped
//   step, as torch.where selects it;
// - Python float scalars arrive as f32, rounded to nearest as torch
//   rounds a wrapped scalar to the tensor's dtype;
// - stamps and slots are int32 bits; the window test is int32
//   arithmetic, as the plain code's on an int32 tensor; INVALID_INDEX
//   and +inf move as bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The launcher's arguments (ops/regularization.py::_Args, field for
// field).  `dist_out` is null without fast_neighbor_update (the slot
// distances pass through unchanged, and merge tombstones are not
// dropped); `frame` is null when the frame index comes by value.
struct RegularizeArgs {
  const float* pack;         // (n, 18) working rows, row-major
  const float* gsrc;         // (n_src, 18) rows read by global index
  const int* nbr_in;         // (4, n) slots, row k at k * nbr_stride
  long long nbr_stride;
  float* pack_out;           // (n, 18)
  int* nbr_out;              // (4, n)
  int* dist_out;             // (4, n) f32 bits, or null
  const int* frame;          // () frame index, or null: frame_value
  long long n;
  long long n_src;
  int frame_value;
  int window;                // regularization_frame_window_size
  float two_w;               // 2 * regularizer_weight
  float w;                   // regularizer_weight
  float one_plus_w;          // 1 + regularizer_weight
  float reg_factor_sq;       // radius_factor_for_regularization_neighbors^2
};

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 4;
constexpr int kInvalidIndex = 0x7FFFFFFF;
constexpr int kInfBits = 0x7F800000;            // +inf as f32 bits
constexpr float kMinLength = 0x1.4484c0p-100f;  // f32(1e-30)

// Pack columns (ops/fusion.py).
constexpr int kPX = 0, kPY = 1, kPZ = 2, kSX = 3, kSY = 4, kSZ = 5;
constexpr int kStamp = 6, kNX = 7, kNY = 8, kNZ = 9, kRcnt = 10;
constexpr int kRad = 13, kWidth = 18;
// The words a slot gathers: SX, SY, SZ, STAMP, NX, NY, NZ, RCNT.
constexpr int kGather = kRcnt - kSX + 1;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float sqrt_f32(float x) {
  return __double2float_rn(__dsqrt_rn(static_cast<double>(x)));
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
// The plain version's (a0 * b0 + a1 * b1) + a2 * b2.
__device__ __forceinline__ float dot3(float a0, float a1, float a2,
                                      float b0, float b1, float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}
__device__ __forceinline__ float slot_sum(const float (&x)[kSlots]) {
  return add(add(add(x[0], x[1]), x[2]), x[3]);
}
// _div(c, cnt.clamp_min(1.0)) where cnt > 0, else 0.0.
__device__ __forceinline__ float per_count(float c, float cnt) {
  return cnt > 0.0f ? __fdiv_rn(c, clamp_min(cnt, 1.0f)) : 0.0f;
}

// regularize_reference for row i, whose pack row `r` (in shared memory)
// is updated in place.
__device__ __forceinline__ void regularize_row(const RegularizeArgs& a,
                                               float* r, long long i,
                                               int since, bool tombstones) {
  const float sx = r[kSX], sy = r[kSY], sz = r[kSZ];
  const float nx = r[kNX], ny = r[kNY], nz = r[kNZ];
  const bool recent = __float_as_int(r[kStamp]) >= since;
  const float drift_sq = mul(a.reg_factor_sq, r[kRad]);

  int slot[kSlots];
  bool valid[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    slot[k] = __ldg(a.nbr_in + k * a.nbr_stride + i);
    valid[k] = slot[k] != kInvalidIndex;
  }
  // The gathers first, all in flight together: a valid slot's neighbour
  // row, or for a row in the window any slot's (the plain gather reads
  // row 0 for an invalid or out-of-range index).
  float g[kSlots][kGather];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (valid[k] || recent) {
      const long long j = slot[k];
      const float* row = a.gsrc + (j < 0 || j >= a.n_src ? 0 : j) * kWidth;
#pragma unroll
      for (int c = 0; c < kGather; ++c) g[k][c] = __ldg(row + kSX + c);
    } else {
#pragma unroll
      for (int c = 0; c < kGather; ++c) g[k][c] = 0.0f;
    }
  }

  int used = 0, kept = 0;
  float grad_x[kSlots], grad_y[kSlots], grad_z[kSlots], gcount[kSlots];
  float ndot_kept[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const float dx = sub(g[k][kSX - kSX], sx);
    const float dy = sub(g[k][kSY - kSX], sy);
    const float dz = sub(g[k][kSZ - kSX], sz);
    const int stamp = __float_as_int(g[k][kStamp - kSX]);
    const float snx = g[k][kNX - kSX], sny = g[k][kNY - kSX];
    const float snz = g[k][kNZ - kSX];
    const bool use = valid[k] && stamp >= since;
    used += use;
    const float dist_sq = dot3(dx, dy, dz, dx, dy, dz);
    // Neighbours that drifted out of range; with fast_neighbor_update
    // also merge tombstones (stamp 0).
    bool drop = use && dist_sq > drift_sq;
    if (tombstones) drop = drop || (valid[k] && stamp == 0);
    const bool still = valid[k] && !drop;
    kept += still;
    a.nbr_out[k * a.n + i] = drop ? kInvalidIndex : slot[k];
    if (a.dist_out != nullptr)
      a.dist_out[k * a.n + i] = still ? __float_as_int(dist_sq) : kInfBits;

    // Cross terms: the edge from neighbour i (its normal and stored
    // count) is on when the slot is valid and this row is recent.
    float contrib = 0.0f, wcnt = 0.0f;
    if (valid[k] && recent) {
      const float cnt_i = g[k][kRcnt - kSX];
      const float in_dot = -dot3(snx, sny, snz, dx, dy, dz);
      contrib = mul(per_count(a.two_w, cnt_i), in_dot);
      wcnt = per_count(a.w, cnt_i);
    }
    grad_x[k] = mul(contrib, snx);
    grad_y[k] = mul(contrib, sny);
    grad_z[k] = mul(contrib, snz);
    gcount[k] = wcnt;
    ndot_kept[k] = still ? dot3(nx, ny, nz, dx, dy, dz) : 0.0f;
  }
  r[kRcnt] = static_cast<float>(used);
  if (!recent) return;

  // The step over the updated neighbour list, clamped to the radius.
  const float factor2 = per_count(a.two_w, static_cast<float>(kept));
  const float neg_sum = -slot_sum(ndot_kept);
  const float gx = add(add(mul(2.0f, sub(sx, r[kPX])), slot_sum(grad_x)),
                       mul(factor2, mul(neg_sum, nx)));
  const float gy = add(add(mul(2.0f, sub(sy, r[kPY])), slot_sum(grad_y)),
                       mul(factor2, mul(neg_sum, ny)));
  const float gz = add(add(mul(2.0f, sub(sz, r[kPZ])), slot_sum(grad_z)),
                       mul(factor2, mul(neg_sum, nz)));
  const float step = __fdiv_rn(0.5f, add(a.one_plus_w, slot_sum(gcount)));
  const float max_step = sqrt_f32(r[kRad]);   // NaN for merged rows
  const float grad_len = mul(step, sqrt_f32(dot3(gx, gy, gz, gx, gy, gz)));
  const float factor =
      grad_len > max_step
          ? mul(__fdiv_rn(max_step, clamp_min(grad_len, kMinLength)), step)
          : step;
  r[kSX] = sub(sx, mul(factor, gx));
  r[kSY] = sub(sy, mul(factor, gy));
  r[kSZ] = sub(sz, mul(factor, gz));
}

__global__ void __launch_bounds__(kThreads)
regularize_kernel(const RegularizeArgs a) {
  __shared__ float rows[kThreads * kWidth];
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const int count = static_cast<int>(
      min(static_cast<long long>(kThreads), a.n - first));
  const float* src = a.pack + first * kWidth;
  for (int w = threadIdx.x; w < count * kWidth; w += kThreads)
    rows[w] = __ldg(src + w);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < count) {
    const int frame = a.frame != nullptr ? __ldg(a.frame) : a.frame_value;
    // frame - window in int32 arithmetic (wrapping, as torch's).
    const int since = static_cast<int>(static_cast<unsigned>(frame) -
                                       static_cast<unsigned>(a.window));
    regularize_row(a, rows + threadIdx.x * kWidth, first + threadIdx.x,
                   since, a.dist_out != nullptr && frame > 0);
  }
  __syncthreads();
  float* dst = a.pack_out + first * kWidth;
  for (int w = threadIdx.x; w < count * kWidth; w += kThreads)
    dst[w] = rows[w];
}

}  // namespace

// Enqueues the kernel on `stream`; returns 0 or the CUDA error code.
extern "C" int regularize_launch(const RegularizeArgs* args, void* stream) {
  if (args->n < 0 || (args->n > 0 && args->n_src <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (args->n == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((args->n + kThreads - 1) / kThreads);
  regularize_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
