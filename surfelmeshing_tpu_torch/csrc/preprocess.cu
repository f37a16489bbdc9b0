// Depth preprocessing for Hopper (sm_90a): the five passes of
// ops/preprocess.py::preprocess_frame, one kernel a pass, one thread a
// pixel.
//
// Replaces no TPU kernel: the JAX package runs these passes as XLA stencils
// (surfelmeshing_tpu/ops/preprocess.py), and the port ran them as plain
// PyTorch over (H, W) maps, several hundred launches a frame (113 shifted
// (H, W) slices stacked and summed one tap a launch in the bilateral
// filter, ~30 ops for each of the K outlier frames, ~15 for each of the 8
// neighbours of the radii pass).  The plain versions stay in
// ops/preprocess.py (`*_reference`) as the CPU route and the yardstick.
//
// What bounds them on this card.  Bytes: a 640x480 frame reads the depth
// map and the K = 8 window maps (int32, 11.1 MB) and the five passes write
// 7.4 MB of maps, a few microseconds at 3.35 TB/s.  The bilateral filter's
// arithmetic is larger: each of up to 113 taps a pixel evaluates exp_f32,
// whose eight fused multiply-adds are f64 products and sums rounded to
// f32, 16 f64 operations a tap.  Conversions between f32 and f64 (16 a
// clock an SM, a quarter of the f64 rate) would set its pace: rounded
// naively, a tap takes 19 and an int-to-float conversion.  The polynomial's
// five values stay in f64 and are rounded to f32 there (round_f32_in), and
// samples convert by their mantissa bits: 9 conversions a tap remain.  The
// other passes are a few dozen f32 operations a pixel.
//
// Design: one thread a pixel, 32 x 8 blocks, so a warp reads 32
// neighbouring words of each stencil row (served by L1 after the first
// warp of a row).  Pixels that the plain code zeroes whatever their
// neighbours hold return at once (outside the valid-region circle, depth
// 0 or beyond max_depth, outside the erosion border).  The bilateral
// filter's spatial terms -(dx^2 + dy^2) / denom_xy, one f64 division
// each, are built once a block into shared memory, indexed by dx^2 + dy^2.
//
// Bit for bit equal to the plain passes as CUDA PyTorch runs them, so the
// arithmetic follows their operations one by one:
// - every f32 operation is an __f*_rn intrinsic, so nvcc cannot contract
//   a*b+c into an FMA (the plain code rounds the product and the sum);
//   build without --use_fast_math (IEEE divisions, no flush to zero);
// - sqrt_f32 is the f64 square root rounded to f32;
// - _fma_f32 is an f64 product (exact for two f32 values) plus an f64 sum,
//   rounded once to f32: not fmaf, since the plain code rounds twice;
// - exp_f32 keeps XLA's clamp, floor, polynomial, 2^n exponent bits and
//   flush below 2^-126, with NaN passed through as torch's clamp does;
// - tensor-by-tensor divisions are IEEE divisions; `scalar / tensor`
//   (Tensor.__rtruediv__) is torch's reciprocal times the scalar, so it is
//   __frcp_rn times the scalar here;
// - Python float scalars reach the kernels as doubles and are rounded to
//   f32 here, as torch rounds a wrapped scalar to the tensor's dtype;
// - float to int32 casts truncate (cvt.rzi, NaN to 0) as torch's casts do
//   on the card; to_i32_trunc's saturation to +-2^30 comes first;
// - sums run in the plain code's order: bilateral taps row-major, outlier
//   frames in order, the 8 neighbours row-major.  A tap whose sample is 0
//   (or off the image) adds +0 to sums that are never -0, so it is
//   skipped.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kMaxBilateralRadius = 64;   // spatial terms: 16 KB of smem

// exp_f32's constants (ops/preprocess.py: _EXP_LO .. _EXP_POLY), the f32
// values the plain code rounds its decimal constants to.
constexpr float kExpLo = -0x1.5f3334p+6f;    // -87.8
constexpr float kExpHi = 0x1.633334p+6f;     // 88.8
constexpr double kLog2e = 0x1.715476p+0;     // log2(e)
constexpr double kNegLn2Hi = -0x1.63p-1;     // -0.693359375
constexpr double kNegLn2Lo = 0x1.bd0106p-13;  // 2.12194440e-4
constexpr double kP0 = 0x1.a0d2cep-13;
constexpr double kP1 = 0x1.6e879cp-10;
constexpr double kP2 = 0x1.111210p-7;
constexpr double kP3 = 0x1.555382p-5;
constexpr double kP4 = 0x1.555554p-3;
constexpr double kP5 = 0x1.0p-1;
constexpr float kMinNormal = 0x1.0p-126f;
constexpr float kMinWeight = 0x1.4484c0p-100f;  // f32(1e-30)
constexpr float kMinNormalLength = 0x1.0c6f7ap-20f;  // f32(1e-6)
constexpr float kCastLimit = 1073741824.0f;  // 2^30 (_CAST_LIMIT)

__device__ __forceinline__ float f32(double x) {
  return __double2float_rn(x);
}

// torch.clamp on the card: NaN passes through.
__device__ __forceinline__ float clamp_f(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// _fma_f32(a, b, c) with a, b, c held in f64 (exact f32 values).
__device__ __forceinline__ float fma_f32(double a, double b, double c) {
  return f32(__dadd_rn(__dmul_rn(a, b), c));
}

__device__ __forceinline__ float sqrt_f32(float x) {
  return f32(__dsqrt_rn(static_cast<double>(x)));
}

__device__ __forceinline__ double fma_f64(double a, double b, double c) {
  return __dadd_rn(__dmul_rn(a, b), c);
}

// RN32(s), kept in f64, for s in [2^e, 2^(e+1)) with c = 1.5 * 2^(e+29):
// s + c lies in c's binade, whose f64 ulp is 2^(e-23), f32's ulp in s's
// binade, so RN64(s + c) rounds s to f32 precision (ties to even: c has no
// bits below 2^(e+28)) and subtracting c is exact.  Two f64 additions
// instead of two conversions.
__device__ __forceinline__ double round_f32_in(double s, double c) {
  return __dsub_rn(__dadd_rn(s, c), c);
}

// exp_f32 (ops/preprocess.py), operation by operation, for x <= 0 or NaN
// (the bilateral weights' exponents).  Then n = floor(x log2(e) + 0.5) is
// in [-127, 0] without clamping and |r| <= ln(2)/2 + 2^-16 < 0.3467, so
// each polynomial value y1 .. y5 stays in one binade whatever r is: y1 in
// [1.329e-3, 1.468e-3] (2^-10), y2 [7.824e-3, 8.843e-3] (2^-7), y3
// [3.860e-2, 4.474e-2] (2^-5), y4 [0.1511, 0.1822] (2^-3), y5 [0.4368,
// 0.5632] (2^-2 below 0.5, else 2^-1), and round_f32_in rounds them.
__device__ __forceinline__ float exp_f32_nonpositive(float x) {
  x = clamp_f(x, kExpLo, kExpHi);
  const double xd = x;
  float n = floorf(fma_f32(xd, kLog2e, 0.5));
  n = clamp_f(n, -127.0f, 127.0f);
  const double nd = n;
  float r = fma_f32(nd, kNegLn2Hi, xd);
  r = fma_f32(nd, kNegLn2Lo, r);
  const double rd = r;
  double y = round_f32_in(fma_f64(rd, kP0, kP1), 0x1.8p+19);
  y = round_f32_in(fma_f64(y, rd, kP2), 0x1.8p+22);
  y = round_f32_in(fma_f64(y, rd, kP3), 0x1.8p+24);
  y = round_f32_in(fma_f64(y, rd, kP4), 0x1.8p+26);
  const double y5 = fma_f64(y, rd, kP5);
  y = round_f32_in(y5, y5 < 0.5 ? 0x1.8p+27 : 0x1.8p+28);
  const float e = __fadd_rn(1.0f, fma_f32(y, __fmul_rn(r, r), rd));
  // n.to(int32): cvt.rzi, NaN -> 0.
  const float pow2 = __int_as_float((static_cast<int>(n) + 127) << 23);
  const float out = __fmul_rn(e, pow2);
  return out < kMinNormal ? 0.0f : out;
}

// (float)v: exact below 2^23 by the mantissa bits of 2^23 + v, without
// the int-to-float conversion unit (depths are u16 values).
__device__ __forceinline__ float int_to_f32(int v) {
  return static_cast<unsigned>(v) < (1u << 23)
             ? __fsub_rn(__int_as_float(0x4B000000 | v), 8388608.0f)
             : static_cast<float>(v);
}

// to_i32_trunc: NaN -> 0, +-inf and beyond -> +-2^30, then truncation.
__device__ __forceinline__ int to_i32_trunc(float x) {
  if (isnan(x)) x = 0.0f;
  return static_cast<int>(fminf(fmaxf(x, -kCastLimit), kCastLimit));
}

// fx_inv * px + cx_inv, the pixel-corner ray coordinate.
__device__ __forceinline__ float ray(float f_inv, float p, float c_inv) {
  return __fadd_rn(__fmul_rn(f_inv, p), c_inv);
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
bilateral_kernel(const int* __restrict__ depth, int* __restrict__ out,
                 int height, int width, int radius, double denom_xy,
                 float value_factor, int max_depth, float region_sq) {
  extern __shared__ float s_grid[];   // (radius^2 + 1) spatial terms
  const int terms = radius * radius + 1;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  for (int d2 = tid; d2 < terms; d2 += kBlockX * kBlockY)
    s_grid[d2] = f32(__ddiv_rn(static_cast<double>(-d2), denom_xy));
  __syncthreads();

  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= width || y >= height) return;
  const int p = y * width + x;
  const int d = depth[p];
  const int cdx = x - width / 2, cdy = y - height / 2;
  const float center_dist_sq = static_cast<float>(cdx * cdx + cdy * cdy);
  if (!(center_dist_sq <= region_sq) || d == 0 || d > max_depth) {
    out[p] = 0;
    return;
  }
  const float center = static_cast<float>(d);
  const float sigma = __fmul_rn(center, value_factor);
  const float denom = __fmul_rn(__fmul_rn(2.0f, sigma), sigma);
  float sum = 0.0f, weight = 0.0f;
  int half = radius;   // the circle's half-width in row dy
  for (int dy = -radius; dy <= radius; ++dy) {
    while (half * half + dy * dy > radius * radius) --half;
    while ((half + 1) * (half + 1) + dy * dy <= radius * radius) ++half;
    const int yy = y + dy;
    if (yy < 0 || yy >= height) continue;
    const int* row = depth + yy * width;
    for (int dx = -half; dx <= half; ++dx) {
      const int d2 = dx * dx + dy * dy;
      const int xx = x + dx;
      if (xx < 0 || xx >= width) continue;
      const int sv = __ldg(row + xx);
      if (sv == 0) continue;
      const float s = int_to_f32(sv);
      const float diff = __fsub_rn(center, s);
      const float w = exp_f32_nonpositive(
          __fsub_rn(s_grid[d2], __fdiv_rn(__fmul_rn(diff, diff), denom)));
      sum = __fadd_rn(sum, __fmul_rn(w, s));
      weight = __fadd_rn(weight, w);
    }
  }
  const float filtered =
      weight == 0.0f ? 0.0f
                     : __fadd_rn(__fdiv_rn(sum, clamp_f(weight, kMinWeight,
                                                        INFINITY)),
                                 0.5f);
  out[p] = static_cast<int>(filtered);
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
outlier_kernel(const int* __restrict__ depth, const int* __restrict__ others,
               const float* __restrict__ transforms, int* __restrict__ out,
               int height, int width, int frames, int required, float fx,
               float fy, float cx, float cy, float fx_inv, float fy_inv,
               float cx_inv, float cy_inv, float max_tol, float min_tol) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= width || y >= height) return;
  const int p = y * width + x;
  const int d = depth[p];
  if (d == 0) {
    out[p] = 0;
    return;
  }
  const float df = static_cast<float>(d);
  const float px = __fmul_rn(df, ray(fx_inv, static_cast<float>(x), cx_inv));
  const float py = __fmul_rn(df, ray(fy_inv, static_cast<float>(y), cy_inv));
  const float pz = df;
  const size_t plane = static_cast<size_t>(height) * width;
  int ok = 0;
  for (int i = 0; i < frames; ++i) {
    const float* t = transforms + 12 * i;
    float o[3];
    for (int r = 0; r < 3; ++r) {
      const float* tr = t + 4 * r;
      o[r] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(__ldg(tr), px),
                                           __fmul_rn(__ldg(tr + 1), py)),
                                 __fmul_rn(__ldg(tr + 2), pz)),
                       __ldg(tr + 3));
    }
    if (!(o[2] > 0.0f)) continue;
    const int ui = to_i32_trunc(__fadd_rn(__fmul_rn(fx, __fdiv_rn(o[0], o[2])),
                                          cx));
    const int vi = to_i32_trunc(__fadd_rn(__fmul_rn(fy, __fdiv_rn(o[1], o[2])),
                                          cy));
    if (ui < 0 || vi < 0 || ui >= width || vi >= height) continue;
    const float s = static_cast<float>(
        __ldg(others + i * plane + static_cast<size_t>(vi) * width + ui));
    if (s > 0.0f && s <= __fmul_rn(max_tol, o[2]) &&
        s >= __fmul_rn(min_tol, o[2]))
      ++ok;
  }
  out[p] = ok >= required ? d : 0;
}

// erode_depth; radius 0 is copy_without_border (a 1-pixel border).
__global__ void __launch_bounds__(kBlockX * kBlockY)
erode_kernel(const int* __restrict__ depth, int* __restrict__ out,
             int height, int width, int radius) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= width || y >= height) return;
  const int p = y * width + x;
  const int border = radius > 0 ? radius : 1;
  if (x < border || y < border || x >= width - border ||
      y >= height - border) {
    out[p] = 0;
    return;
  }
  bool all_valid = true;
  for (int dy = -radius; dy <= radius; ++dy)
    for (int dx = -radius; dx <= radius; ++dx)
      all_valid &= __ldg(depth + p + dy * width + dx) != 0;
  out[p] = all_valid ? depth[p] : 0;
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
normals_kernel(const int* __restrict__ depth, int* __restrict__ out,
               float* __restrict__ normals, int height, int width,
               float fx_inv, float fy_inv, float cx_inv, float cy_inv,
               float inv_scaling, float sign, float dot_threshold) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= width || y >= height) return;
  const int p = y * width + x;
  const int c = depth[p];
  const int right = x + 1 < width ? depth[p + 1] : 0;
  const int left = x > 0 ? depth[p - 1] : 0;
  const int bottom = y + 1 < height ? depth[p + width] : 0;
  const int top = y > 0 ? depth[p - width] : 0;
  const bool valid = c != 0 && right != 0 && left != 0 && bottom != 0 &&
                     top != 0;
  const float xs = static_cast<float>(x), ys = static_cast<float>(y);

  // unproject(px, py, d_int) -> (X, Y, Z).
  auto unproject = [&](float px, float py, int d_int, float* v) {
    const float d = __fmul_rn(inv_scaling, static_cast<float>(d_int));
    v[0] = __fmul_rn(d, ray(fx_inv, px, cx_inv));
    v[1] = __fmul_rn(d, ray(fy_inv, py, cy_inv));
    v[2] = d;
  };
  float l[3], t[3], r[3], b[3];
  unproject(__fsub_rn(xs, 1.0f), ys, left, l);
  unproject(xs, __fsub_rn(ys, 1.0f), top, t);
  unproject(__fadd_rn(xs, 1.0f), ys, right, r);
  unproject(xs, __fadd_rn(ys, 1.0f), bottom, b);
  const float ax = __fsub_rn(r[0], l[0]), ay = __fsub_rn(r[1], l[1]),
              az = __fsub_rn(r[2], l[2]);
  const float ux = __fsub_rn(t[0], b[0]), uy = __fsub_rn(t[1], b[1]),
              uz = __fsub_rn(t[2], b[2]);
  float nx = __fsub_rn(__fmul_rn(ay, uz), __fmul_rn(az, uy));
  float ny = __fsub_rn(__fmul_rn(az, ux), __fmul_rn(ax, uz));
  float nz = __fsub_rn(__fmul_rn(ax, uy), __fmul_rn(ay, ux));
  const float length = sqrt_f32(__fadd_rn(
      __fadd_rn(__fmul_rn(nx, nx), __fmul_rn(ny, ny)), __fmul_rn(nz, nz)));
  const bool degenerate = !(length > kMinNormalLength);
  const float inv_len = __fmul_rn(__frcp_rn(degenerate ? 1.0f : length),
                                  sign);
  nx = degenerate ? 0.0f : __fmul_rn(nx, inv_len);
  ny = degenerate ? 0.0f : __fmul_rn(ny, inv_len);
  nz = degenerate ? -1.0f : __fmul_rn(nz, inv_len);

  const float vx = ray(fx_inv, xs, cx_inv), vy = ray(fy_inv, ys, cy_inv);
  const float inv_dir_len = __frcp_rn(sqrt_f32(__fadd_rn(
      __fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)), 1.0f)));
  const float dot = __fmul_rn(
      inv_dir_len,
      __fadd_rn(__fadd_rn(__fmul_rn(vx, nx), __fmul_rn(vy, ny)), nz));
  out[p] = valid && dot < dot_threshold ? c : 0;
  normals[p] = valid ? nx : 0.0f;
  normals[static_cast<size_t>(height) * width + p] = valid ? ny : 0.0f;
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
radii_kernel(const int* __restrict__ depth, int* __restrict__ out,
             float* __restrict__ radius_sq, int height, int width,
             float fx_inv, float fy_inv, float cx_inv, float cy_inv,
             float inv_scaling, float ext_sq, int clamped, float clamp_term) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= width || y >= height) return;
  const int p = y * width + x;
  const int c = depth[p];
  if (c == 0) {
    out[p] = 0;
    radius_sq[p] = 0.0f;
    return;
  }
  const float xs = static_cast<float>(x), ys = static_cast<float>(y);
  const float dc = __fmul_rn(inv_scaling, static_cast<float>(c));
  const float px = __fmul_rn(dc, ray(fx_inv, xs, cx_inv));
  const float py = __fmul_rn(dc, ray(fy_inv, ys, cy_inv));
  const float pz = dc;
  int count = 0;
  float max_d = 0.0f, min_d = INFINITY;
  for (int dy = -1; dy <= 1; ++dy) {
    for (int dx = -1; dx <= 1; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const int xx = x + dx, yy = y + dy;
      if (xx < 0 || yy < 0 || xx >= width || yy >= height) continue;
      const int nd = __ldg(depth + p + dy * width + dx);
      if (nd == 0) continue;
      const float dn = __fmul_rn(inv_scaling, static_cast<float>(nd));
      const float ex = __fsub_rn(
          __fmul_rn(dn, ray(fx_inv, __fadd_rn(xs, static_cast<float>(dx)),
                            cx_inv)), px);
      const float ey = __fsub_rn(
          __fmul_rn(dn, ray(fy_inv, __fadd_rn(ys, static_cast<float>(dy)),
                            cy_inv)), py);
      const float ez = __fsub_rn(dn, pz);
      const float dist_sq = __fadd_rn(
          __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), __fmul_rn(ez, ez));
      ++count;
      if (dist_sq > max_d) max_d = dist_sq;
      if (dist_sq < min_d) min_d = dist_sq;
    }
  }
  float r = __fmul_rn(max_d, ext_sq);
  if (clamped) {
    // torch.minimum: NaN from either side propagates.
    const float cap = __fmul_rn(clamp_term, min_d);
    r = isnan(r) ? r : isnan(cap) ? cap : fminf(r, cap);
  }
  radius_sq[p] = r;
  out[p] = count >= 8 ? c : 0;
}

inline dim3 grid_for(int height, int width) {
  return dim3((width + kBlockX - 1) / kBlockX,
              (height + kBlockY - 1) / kBlockY);
}

inline int launched() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Each launcher enqueues its kernel on `stream` and returns 0 or the CUDA
// error code.  Maps are contiguous int32 (height, width) planes (outputs
// allocated by the caller); scalars the plain code takes as Python floats
// come as doubles and are rounded to f32 here, as torch rounds them.

extern "C" int preprocess_max_bilateral_radius() {
  return kMaxBilateralRadius;
}

extern "C" int bilateral_launch(const void* depth, void* out, int height,
                                int width, int radius, double denom_xy,
                                double value_factor, int max_depth,
                                double region_sq, void* stream) {
  if (radius < 0 || radius > kMaxBilateralRadius)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(radius) * radius + 1) *
                      sizeof(float);
  bilateral_kernel<<<grid_for(height, width), dim3(kBlockX, kBlockY), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(depth), static_cast<int*>(out), height, width,
      radius, denom_xy, static_cast<float>(value_factor), max_depth,
      static_cast<float>(region_sq));
  return launched();
}

extern "C" int outlier_launch(const void* depth, const void* others,
                              const void* transforms, void* out, int height,
                              int width, int frames, int required, double fx,
                              double fy, double cx, double cy, double fx_inv,
                              double fy_inv, double cx_inv, double cy_inv,
                              double max_tol, double min_tol, void* stream) {
  outlier_kernel<<<grid_for(height, width), dim3(kBlockX, kBlockY), 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(depth), static_cast<const int*>(others),
      static_cast<const float*>(transforms), static_cast<int*>(out), height,
      width, frames, required, static_cast<float>(fx),
      static_cast<float>(fy), static_cast<float>(cx), static_cast<float>(cy),
      static_cast<float>(fx_inv), static_cast<float>(fy_inv),
      static_cast<float>(cx_inv), static_cast<float>(cy_inv),
      static_cast<float>(max_tol), static_cast<float>(min_tol));
  return launched();
}

extern "C" int erode_launch(const void* depth, void* out, int height,
                            int width, int radius, void* stream) {
  if (radius < 0) return static_cast<int>(cudaErrorInvalidValue);
  erode_kernel<<<grid_for(height, width), dim3(kBlockX, kBlockY), 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(depth), static_cast<int*>(out), height, width,
      radius);
  return launched();
}

extern "C" int normals_launch(const void* depth, void* out, void* normals,
                              int height, int width, double fx_inv,
                              double fy_inv, double cx_inv, double cy_inv,
                              double inv_scaling, double sign,
                              double dot_threshold, void* stream) {
  normals_kernel<<<grid_for(height, width), dim3(kBlockX, kBlockY), 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(depth), static_cast<int*>(out),
      static_cast<float*>(normals), height, width,
      static_cast<float>(fx_inv), static_cast<float>(fy_inv),
      static_cast<float>(cx_inv), static_cast<float>(cy_inv),
      static_cast<float>(inv_scaling), static_cast<float>(sign),
      static_cast<float>(dot_threshold));
  return launched();
}

extern "C" int radii_launch(const void* depth, void* out, void* radius_sq,
                            int height, int width, double fx_inv,
                            double fy_inv, double cx_inv, double cy_inv,
                            double inv_scaling, double ext_sq, int clamped,
                            double clamp_term, void* stream) {
  radii_kernel<<<grid_for(height, width), dim3(kBlockX, kBlockY), 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(depth), static_cast<int*>(out),
      static_cast<float*>(radius_sq), height, width,
      static_cast<float>(fx_inv), static_cast<float>(fy_inv),
      static_cast<float>(cx_inv), static_cast<float>(cy_inv),
      static_cast<float>(inv_scaling), static_cast<float>(ext_sq), clamped,
      static_cast<float>(clamp_term));
  return launched();
}
