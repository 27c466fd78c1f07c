// Device code the three tile compositors share: the forward K1
// (composite_fwd.cu), the backward K2 (composite_bwd.cu) and the fused
// train kernel K3 (composite_train.cu).  One copy, so that the footprint
// box's proved margins and the warp reduction's lane map cannot drift apart
// between them.  Included by each source; everything here is internal to
// the source that includes it.
//
// The layout the three share.  A block composites one tile with min(tile^2,
// 256) threads, PPT pixels each (4 at tile 32, else 1), pixel p = warp 32
// PPT + 32 k + lane, so a warp owns rows_w = 32 PPT / tile whole rows of the
// tile (4 rows of 32 at tile 32, 2 of 16 at tile 16, 4 of 8 at tile 8).
// Duplicates are staged through shared memory as three float4 each (below),
// with the mask of the warps whose patch meets the duplicate's footprint
// box; a warp outside the box skips the duplicate.
//
// The footprint box.  With Q = a dx^2 + 2 b dx dy + c dy^2 the exact
// power is -Q/2 (power = -0.5 (a dx^2 + c dy^2) - b dx dy), and a pixel can
// reach alpha >= 1/255 only where Q <= 2 L, L = ln(op / kAlphaMin), an
// ellipse within |dx| <= sqrt(2 L c / (a c - b^2)), |dy| <= sqrt(2 L a /
// (a c - b^2)) for a positive-definite conic.  The box is computed in
// double from the float inputs, with these margins (u = 2^-24):
//   (1) the computed power.  Its six float operations give -2 power_hat
//       >= (1 - u) (Q - 5.0001 u A), A = a dx^2 + c dy^2 >= |2 b dx dy|
//       (a, c > 0 and the three terms of A rounded as non-negatives), so
//       -2 power_hat >= (1 - u) Q_d with Q_d = (1 - d)(a dx^2 + c dy^2) + 2
//       b dx dy, d = 2^-18 > 5.0001 u: the box is Q_d's, from a (1 - d),
//       c (1 - d).  Subnormal products add under 2^-120 here;
//   (2) expf (2 ulp) and alpha's product: alpha_hat <= op e^power_hat
//       (1 + 2^-20), so alpha_hat < kAlphaMin wherever -power_hat > L +
//       2^-20; the threshold is Lm = max((L + d)(1 + d), 2^-40), and (1)
//       gives -power_hat >= (1 - u) Lm > L + 2^-20 outside the box;
//   (3) dx and dy are rounded (|dx_hat| >= |dx| (1 - u)), det' = a'c' - b^2
//       is rounded in double (relative error below 2^-23 once det' > 2^-30
//       a'c', and a conic below that never skips), so the half-extents are
//       widened by (1 + 2^-16), plus 2^-40 |centre| for the double
//       subtraction, and the box's edges rounded outward to float.
// Lm < 0 means op e^0 (1 + 2^-20) < kAlphaMin, and op <= 0 that alpha <=
// 0: no pixel reaches the threshold and the box is empty.  A conic that is
// not positive definite, and any input that is NaN or infinite, gives the
// whole plane: it never skips.  A NaN edge compares false and never skips.
// So a skipped pair is one every compositor's per-pixel rules skip (the
// Gaussian evaluated with gauss_power and expf, as all three do), and every
// result, every decision included, is the one without it.
// ops/raster_tiled.py::footprint_box is the plain twin of this arithmetic.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 9;  // mx, my, conic a, b, c, r, g, b, opacity
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;
// the footprint box's margins (the proof above)
constexpr double kShrink = 0x1p-18;
constexpr double kWiden = 0x1p-16;
constexpr double kAbs = 0x1p-40;
constexpr double kDetMin = 0x1p-30;
constexpr double kLMin = 0x1p-40;

struct Splat {
  float mx, my, ca, cb, cc, r, g, b, op;
};

// A staged duplicate: three float4, (mx, my, a, b), (c, r, g, b),
// (op, warp mask as bits, -, -).
__device__ __forceinline__ Splat load_splat(const float4* st, unsigned& mask) {
  const float4 q0 = st[0], q1 = st[1], q2 = st[2];
  mask = __float_as_uint(q2.y);
  return Splat{q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x};
}

__device__ __forceinline__ void store_splat(float4* st, const float (&v)[kRows], unsigned mask) {
  st[0] = make_float4(v[0], v[1], v[2], v[3]);
  st[1] = make_float4(v[4], v[5], v[6], v[7]);
  st[2] = make_float4(v[8], __uint_as_float(mask), 0.0f, 0.0f);
}

// power = -0.5 (a dx^2 + c dy^2) - b dx dy, in K1's order of operations
__device__ __forceinline__ float gauss_power(const Splat& s, float dx, float dy) {
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(s.ca, dx), dx),
                               __fmul_rn(__fmul_rn(s.cc, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(s.cb, dx), dy));
}

struct Box {
  float xlo, xhi, ylo, yhi;
};

// The footprint box of a duplicate (the proof above); double operations
// rounded one by one, as the plain twin does them.
__device__ Box footprint(float mx, float my, float a, float b, float c, float op) {
  const float inf = __int_as_float(0x7f800000);
  const Box whole{-inf, inf, -inf, inf};
  const Box none{inf, -inf, inf, -inf};
  if (!(isfinite(mx) && isfinite(my) && isfinite(a) && isfinite(b) && isfinite(c) &&
        isfinite(op))) {
    return whole;
  }
  if (!(op > 0.0f)) return none;  // alpha <= 0
  const double l = __dsub_rn(log(static_cast<double>(op)), log(static_cast<double>(kAlphaMin)));
  double lm = __dmul_rn(__dadd_rn(l, kShrink), 1.0 + kShrink);
  if (lm < 0.0) return none;
  lm = fmax(lm, kLMin);
  const double a1 = __dmul_rn(a, 1.0 - kShrink);
  const double c1 = __dmul_rn(c, 1.0 - kShrink);
  const double ac = __dmul_rn(a1, c1);
  const double det = __dsub_rn(ac, __dmul_rn(b, b));
  if (!(a1 > 0.0 && det > __dmul_rn(ac, kDetMin))) return whole;
  const double t = __dmul_rn(2.0, lm);
  const double ex = __dsqrt_rn(__ddiv_rn(__dmul_rn(t, c1), det));
  const double ey = __dsqrt_rn(__ddiv_rn(__dmul_rn(t, a1), det));
  const double exw = __dadd_rn(__dmul_rn(ex, 1.0 + kWiden), __dmul_rn(fabs(mx), kAbs));
  const double eyw = __dadd_rn(__dmul_rn(ey, 1.0 + kWiden), __dmul_rn(fabs(my), kAbs));
  return Box{__double2float_rd(__dsub_rn(mx, exw)), __double2float_ru(__dadd_rn(mx, exw)),
             __double2float_rd(__dsub_rn(my, eyw)), __double2float_ru(__dadd_rn(my, eyw))};
}

// Bit w: warp w's patch, columns [x0, x1] and rows [y0 + w rows_w, y0 +
// (w + 1) rows_w - 1], meets the box.  A NaN edge compares false: kept.
__device__ __forceinline__ unsigned warp_mask(const Box& bx, float x0, float x1, float y0,
                                              int rows_w, int nwarps) {
  if (x1 < bx.xlo || x0 > bx.xhi) return 0u;
  unsigned m = 0u;
  for (int w = 0; w < nwarps; ++w) {
    const float lo = y0 + static_cast<float>(w * rows_w);
    const float hi = lo + static_cast<float>(rows_w - 1);
    if (!(hi < bx.ylo || lo > bx.yhi)) m |= 1u << w;
  }
  return m;
}

__device__ __forceinline__ void stage_dup(float4* st, const float* __restrict__ feat,
                                          long long num_dup, int j, float x0, float x1,
                                          float y0, int rows_w, int nwarps) {
  float v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) v[r] = feat[r * num_dup + j];
  const Box bx = footprint(v[0], v[1], v[2], v[3], v[4], v[8]);
  store_splat(st, v, warp_mask(bx, x0, x1, y0, rows_w, nwarps));
}

// One step of the reduce-scatter: a lane of `bit` clear keeps v[0, N) and
// sends v[N, 2N); a lane of `bit` set keeps v[N, 2N) and sends v[0, N);
// slots past LEN are 0.  out[i] = kept + partner's sent.
template <int N, int LEN>
__device__ __forceinline__ void scatter_step(const float (&v)[LEN], float (&out)[N], int lane,
                                             int bit) {
  const bool up = lane & bit;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float lo = v[i];
    const float hi = N + i < LEN ? v[N + i] : 0.0f;
    out[i] = (up ? hi : lo) + __shfl_xor_sync(kFull, up ? lo : hi, bit);
  }
}

// The row whose warp sum lane `lane` stores after warp_reduce9 (below), or
// -1: the slot a lane keeps at each step, read back from its lane bits.
__device__ __forceinline__ int reduced_row(int lane) {
  const int b1 = (lane >> 1) & 1, b2 = (lane >> 2) & 1, b3 = (lane >> 3) & 1;
  const int b4 = (lane >> 4) & 1;
  const int s2 = b2 ? 2 + b1 : b1;  // slot of b[] (3)
  const int s1 = b3 ? 3 + s2 : s2;  // slot of a[] (5)
  const int row = b4 ? 5 + s1 : s1;
  return ((lane & 1) == 0 && s2 < 3 && s1 < 5 && row < kRows) ? row : -1;
}

// The warp's sums of the nine rows of g by a reduce-scatter butterfly: at
// xor distance 16 a lane keeps five rows (or four) and sends the others to
// its partner, at 8 three, at 4 two, at 2 one, and a last xor 1 sums the
// pair; 5 + 3 + 2 + 1 + 1 = 12 shuffles, where nine separate xor
// reductions take 45.  Each pair adds the same two values, so both hold the
// same sum.  The lane whose reduced_row is r >= 0 returns row r's.
__device__ __forceinline__ float warp_reduce9(const float (&g)[kRows], int lane) {
  float a[5], b[3], c[2], d[1];
  scatter_step<5, 9>(g, a, lane, 16);
  scatter_step<3, 5>(a, b, lane, 8);
  scatter_step<2, 3>(b, c, lane, 4);
  scatter_step<1, 2>(c, d, lane, 2);
  return d[0] + __shfl_xor_sync(kFull, d[0], 1);
}

}  // namespace
