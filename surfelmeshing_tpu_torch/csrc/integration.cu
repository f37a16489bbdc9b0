// Surfel integration for Hopper (sm_90a): phase 5 of the fusion step,
// "Integrate measurements" (ops/integration.py; the reference's
// IntegrateMeasurements, cuda_surfel_reconstruction_kernels.cu:741-1142),
// one launch a fused frame.
//
// Replaces no TPU kernel: the JAX package runs phase 5 as XLA elementwise
// ops, and the port ran it as plain PyTorch: for each of the two candidate
// pixels of a row (its own, then its side pixel) ~100 elementwise launches
// over every row of the bucket, 18 column rewrites and a torch.stack of
// the 18 columns back into an (N, 18) pack, with the pixel maps gathered
// into N-long tensors first (ops/integration.py::integrate_reference, kept
// as the CPU route and the yardstick).  At the 7.5M rows of a Replica-sized
// map that was ~400 launches, two N x 18 stacks and tens of N-long
// temporaries a frame.
//
// What bounds it on this card: bytes.  Every row reads its one-byte
// active-and-in-image flag and copies its 4 neighbour slots and slot
// distances (32 B in, 32 B out: the outputs are new tensors).  A row in
// view also reads its 72 B pack row, phase 1's values (~37 B) and a few
// words of each pixel map (~1 MB a map at 1200x680, so they stay in L2),
// and writes its pack row back (72 B).  At 7.5M rows with a third in view
// that is ~0.7 GB, ~0.2 ms at 3.35 TB/s.  The arithmetic is ~200 f32
// operations and one f64 square root a side, far below the card's rates.
//
// Design: one thread a row does side a, then side b, on its pack row held
// in registers, and writes the row once, only when a side changed it.  A
// row out of view (most of a large map) reads its flag and copies its
// neighbour slots, nothing more.  The pixel maps are read by pixel index,
// so nothing is gathered into N-long tensors.  The pack is updated in
// place: the caller's pack is the copy phase 3 made for this frame.  The
// two poses and the frame index are read through device pointers, so a
// captured CUDA graph bakes in no per-frame value.  Out-of-view rows never
// reach the pack, so a warp's row loads are at most 18 strided words over
// 2,304 contiguous bytes, which L1 serves; the neighbour copies are
// slot-major and coalesced.
//
// Bit for bit equal to the plain version as CUDA PyTorch runs it, so the
// arithmetic follows its operations one by one:
// - every f32 operation is an __f*_rn intrinsic, so nvcc cannot contract
//   a*b+c into an FMA (the plain code rounds the product and the sum);
//   build without --use_fast_math (IEEE divisions, no flush to zero);
// - tensor-by-tensor divisions are IEEE divisions; `1.0 / t`
//   (Tensor.__rtruediv__) is torch's reciprocal times 1.0, __frcp_rn here;
// - sqrt_f32 is the f64 square root rounded to f32;
// - floorf for the colour channels, as torch.floor;
// - clamp_min / clamp_max pass NaN through and torch.minimum returns a NaN
//   operand, as torch's CUDA kernels do; torch.where is a select, which
//   keeps the bits of what it selects: the unchanged columns of a row are
//   written back with the bits they were read with;
// - the `first == z` conflict test reads the same f32 z (phase 1's
//   tensor) that the min-depth map was built from;
// - Python float scalars arrive as f32, rounded to nearest as torch rounds
//   a wrapped scalar to the tensor's dtype;
// - the int32 columns (update and creation stamps) and the neighbour
//   slots move as bits; INVALID_INDEX is an f32 NaN pattern and never
//   passes through float arithmetic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The launcher's arguments (ops/integration.py::_Args, field for field).
// Row arrays hold n entries (on / side_ok one byte each, torch.bool),
// maps hw; `conflictor` is null unless exact_conflict_arbitration is on,
// `frame` null when the frame index comes by value.
struct IntegrateArgs {
  float* pack;
  long long n;
  const int* nbr_in;
  long long nbr_stride;
  const int* dist_in;        // f32 bits
  long long dist_stride;
  int* nbr_out;              // (4, n)
  int* dist_out;             // (4, n) f32 bits
  const uint8_t* on;
  const uint8_t* side_ok;
  const int* idx;
  const float* lx;
  const float* ly;
  const float* z;
  const float* dist;
  const int* px;
  const int* py;
  const int* sx;
  const int* sy;
  const float* meas;
  const float* premeas;
  const float* first;
  const int* counts;
  const float* rgb;
  const float* mnx;
  const float* mny;
  const float* mnz;
  const float* radius;
  const int* conflictor;
  const float* local_T_global;   // (3, 4) row-major
  const float* global_T_local;
  const int* frame;
  int frame_value;
  int width;
  int hw;
  float one_minus_noise;
  float one_plus_noise;
  float fx_inv;
  float fy_inv;
  float cx_inv;
  float cy_inv;
  float cos_compat;
  float max_confidence;
  float view_threshold;
};

namespace {

constexpr int kThreads = 256;
constexpr int kInvalidIndex = 0x7FFFFFFF;
constexpr int kInfBits = 0x7F800000;        // +inf as f32 bits
constexpr float kMinLength = 0x1.4484c0p-100f;  // f32(1e-30)

// Pack columns (ops/fusion.py).
constexpr int kPX = 0, kPY = 1, kPZ = 2, kSX = 3, kSY = 4, kSZ = 5;
constexpr int kStamp = 6, kNX = 7, kNY = 8, kNZ = 9, kDetach = 11;
constexpr int kConf = 12, kRad = 13, kCR = 14, kCG = 15, kCB = 16;
constexpr int kCreation = 17, kWidth = 18;

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
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// fusion._transform's row r of T[:, :3] @ (x, y, z), in its order.
__device__ __forceinline__ float rotate_row(const float* T, int r, float x,
                                            float y, float z) {
  return add(add(mul(T[4 * r], x), mul(T[4 * r + 1], y)),
             mul(T[4 * r + 2], z));
}

struct Pose {
  float m[12];
};

__device__ __forceinline__ Pose load_pose(const float* T) {
  Pose p;
#pragma unroll
  for (int k = 0; k < 12; ++k) p.m[k] = __ldg(T + k);
  return p;
}

// The row's values that both sides read.
struct RowIn {
  float lx, ly, z, dist;
  int idx, frame;
};

// integrate_reference's integrate_at for one row at pixel `pix` (whose
// float coordinates are pxf, pyf); `r` is the row's pack row, updated.
// Sets *reinit when the row is re-initialised; returns whether `r`
// changed.
__device__ __forceinline__ bool integrate_at(const IntegrateArgs& a,
                                             float (&r)[kWidth], int pix,
                                             float pxf, float pyf,
                                             const RowIn& row,
                                             const Pose& Tl, const Pose& Tg,
                                             bool* reinit_out) {
  const float meas = a.meas[pix];
  const float first = a.first[pix];
  bool on = meas > 0.0f;
  const bool conflict_zone = first < mul(a.one_minus_noise, meas);
  bool conflicting = on && conflict_zone && first == row.z;
  if (a.conflictor != nullptr) {
    conflicting = conflicting && a.conflictor[pix] == row.idx;
  } else {
    conflicting = conflicting &&
                  first < mul(a.one_minus_noise, a.premeas[pix]);
  }
  on = on && !conflict_zone;
  on = on && !(row.z > mul(a.one_plus_noise, meas));
  if (!on && !conflicting) return false;

  const float p_mnx = a.mnx[pix], p_mny = a.mny[pix], p_mnz = a.mnz[pix];
  const float p_rad = a.radius[pix];
  const float m_plx = mul(meas, add(mul(a.fx_inv, pxf), a.cx_inv));
  const float m_ply = mul(meas, add(mul(a.fy_inv, pyf), a.cy_inv));
  const float g_px = add(rotate_row(Tg.m, 0, m_plx, m_ply, meas), Tg.m[3]);
  const float g_py = add(rotate_row(Tg.m, 1, m_plx, m_ply, meas), Tg.m[7]);
  const float g_pz = add(rotate_row(Tg.m, 2, m_plx, m_ply, meas), Tg.m[11]);
  const float g_nx = rotate_row(Tg.m, 0, p_mnx, p_mny, p_mnz);
  const float g_ny = rotate_row(Tg.m, 1, p_mnx, p_mny, p_mnz);
  const float g_nz = rotate_row(Tg.m, 2, p_mnx, p_mny, p_mnz);
  const float rgb = a.rgb[pix];
  const float m_cb = floorf(mul(rgb, 1.0f / 65536.0f));
  const float rem = sub(rgb, mul(m_cb, 65536.0f));
  const float m_cg = floorf(mul(rem, 1.0f / 256.0f));
  const float m_cr = sub(rem, mul(m_cg, 256.0f));

  // Conflict handling: confidence - 1; at zero, re-initialisation.
  const float new_conf = sub(r[kConf], 1.0f);
  const bool reinit = conflicting && new_conf <= 0.0f;
  if (reinit) {
    r[kPX] = r[kSX] = g_px;
    r[kPY] = r[kSY] = g_py;
    r[kPZ] = r[kSZ] = g_pz;
    r[kNX] = g_nx;
    r[kNY] = g_ny;
    r[kNZ] = g_nz;
    r[kCR] = m_cr;
    r[kCG] = m_cg;
    r[kCB] = m_cb;
    r[kRad] = p_rad;
    r[kConf] = 1.0f;
    r[kDetach] = 1.0f;
    r[kStamp] = r[kCreation] = __int_as_float(row.frame);
    *reinit_out = true;
  } else if (conflicting) {
    r[kConf] = new_conf;
  }

  // Same-surface checks with the (possibly re-initialised) attributes.
  const float lsnx = rotate_row(Tl.m, 0, r[kNX], r[kNY], r[kNZ]);
  const float lsny = rotate_row(Tl.m, 1, r[kNX], r[kNY], r[kNZ]);
  const float lsnz = rotate_row(Tl.m, 2, r[kNX], r[kNY], r[kNZ]);
  const float dot_view = __fdiv_rn(
      add(add(mul(row.lx, lsnx), mul(row.ly, lsny)), mul(row.z, lsnz)),
      clamp_min(row.dist, kMinLength));
  on = on && dot_view <= a.view_threshold;
  const bool compat_needed = meas < row.z;
  const bool compat = add(add(mul(lsnx, p_mnx), mul(lsny, p_mny)),
                          mul(lsnz, p_mnz)) >= a.cos_compat;
  on = on && (!compat_needed || compat);
  on = on && r[kRad] >= 0.0f;
  on = on && __float_as_int(r[kCreation]) < row.frame;
  if (!on) return conflicting;

  const float counts = static_cast<float>(a.counts[pix]);
  const float weight = __frcp_rn(clamp_min(counts, 1.0f));
  const float conf = r[kConf];
  const float norm = __frcp_rn(add(conf, weight));
  r[kConf] = clamp_max(add(conf, weight), a.max_confidence);
  r[kPX] = mul(add(mul(conf, r[kPX]), mul(weight, g_px)), norm);
  r[kPY] = mul(add(mul(conf, r[kPY]), mul(weight, g_py)), norm);
  r[kPZ] = mul(add(mul(conf, r[kPZ]), mul(weight, g_pz)), norm);
  const float bnx = add(mul(conf, r[kNX]), mul(weight, g_nx));
  const float bny = add(mul(conf, r[kNY]), mul(weight, g_ny));
  const float bnz = add(mul(conf, r[kNZ]), mul(weight, g_nz));
  const float bl = clamp_min(
      sqrt_f32(add(add(mul(bnx, bnx), mul(bny, bny)), mul(bnz, bnz))),
      kMinLength);
  r[kNX] = __fdiv_rn(bnx, bl);
  r[kNY] = __fdiv_rn(bny, bl);
  r[kNZ] = __fdiv_rn(bnz, bl);
  r[kRad] = minimum(r[kRad], p_rad);
  r[kCR] = floorf(add(mul(add(mul(conf, r[kCR]), mul(weight, m_cr)), norm),
                      0.5f));
  r[kCG] = floorf(add(mul(add(mul(conf, r[kCG]), mul(weight, m_cg)), norm),
                      0.5f));
  r[kCB] = floorf(add(mul(add(mul(conf, r[kCB]), mul(weight, m_cb)), norm),
                      0.5f));
  r[kDetach] = 0.0f;
  r[kStamp] = __int_as_float(row.frame);
  return true;
}

// The plain version's gather index: the pixel, clamped into the map.
__device__ __forceinline__ int pixel(int x, int y, int width, int hw) {
  return min(max(y * width + x, 0), hw - 1);
}

__global__ void __launch_bounds__(kThreads)
integrate_kernel(const IntegrateArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= a.n) return;
  bool reinit = false;
  if (a.on[i]) {
    float* row_ptr = a.pack + i * kWidth;
    float r[kWidth];
#pragma unroll
    for (int k = 0; k < kWidth; ++k) r[k] = row_ptr[k];
    // The base condition of both sides: a merged-away row (radius -1 after
    // phase 3) is not integrated.
    if (r[kRad] >= 0.0f) {
      RowIn row;
      row.lx = a.lx[i];
      row.ly = a.ly[i];
      row.z = a.z[i];
      row.dist = a.dist[i];
      row.idx = a.idx[i];
      row.frame = a.frame != nullptr ? *a.frame : a.frame_value;
      const Pose Tl = load_pose(a.local_T_global);
      const Pose Tg = load_pose(a.global_T_local);
      const int px = a.px[i], py = a.py[i];
      bool changed = integrate_at(
          a, r, pixel(px, py, a.width, a.hw), static_cast<float>(px),
          static_cast<float>(py), row, Tl, Tg, &reinit);
      if (a.side_ok[i]) {
        const int sx = a.sx[i], sy = a.sy[i];
        changed |= integrate_at(
            a, r, pixel(sx, sy, a.width, a.hw), static_cast<float>(sx),
            static_cast<float>(sy), row, Tl, Tg, &reinit);
      }
      if (changed) {
#pragma unroll
        for (int k = 0; k < kWidth; ++k) row_ptr[k] = r[k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a.nbr_out[k * a.n + i] = reinit ? kInvalidIndex
                                    : a.nbr_in[k * a.nbr_stride + i];
    a.dist_out[k * a.n + i] = reinit ? kInfBits
                                     : a.dist_in[k * a.dist_stride + i];
  }
}

}  // namespace

// Enqueues the kernel on `stream`; returns 0 or the CUDA error code.
extern "C" int integrate_launch(const IntegrateArgs* args, void* stream) {
  if (args->n < 0 || args->hw <= 0 || args->width <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (args->n == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((args->n + kThreads - 1) / kThreads);
  integrate_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
