// Backward tile compositor of the splat rasterizer, for Hopper (sm_90a):
// the vector-Jacobian product of the forward compositor (composite_fwd.cu)
// with respect to the nine feature rows of every duplicate.
//
// Replaces gaussian_splatterer_tpu/ops/raster_tiled.py::_bwd_kernel and
// _bwd_body, the Pallas TPU kernel that _make_composite.run_bwd launches
// over a work list of (tile, chunk) items, carrying the replay state in
// VMEM between grid steps and emitting one gradient slab per item that is
// segment-summed outside (two tiles can share a chunk block).  This kernel
// computes the same thing without the work list: one thread block per tile
// walks its own [tile_start, tile_end) range of depth-ordered duplicates.
// Each duplicate column belongs to exactly one tile, so one block writes
// it: no atomics, no segment sum.
//
// Inputs per pixel: gin = (g_r, g_g, g_b, g_t), the gradient with respect
// to the forward output (r, g, b, T_final), and that output itself, so
// C_total and T_final are read, not recomputed.  Per pixel, once:
//   g_ctot = g . C_total,  gtn = g_t T_final.
// Then the forward is replayed front to back in K1's order of operations
// with the same expf, so every skip and stop decision is the forward's
// (T is never rebuilt by dividing T_final by 1 - alpha: that flips
// decisions near 1e-4).  For a kept duplicate k with t_k = T before it and
// w = alpha t_k:
//   gc      = g . c_k
//   S_k.g   = g_ctot - sum_{j<=k} w_j gc_j          (a running sum)
//   d_alpha = gc t_k - (S_k.g + gtn) / (1 - alpha),
//             zero where alpha_raw >= 0.99 (the clamp)
//   d_power = d_alpha alpha_raw
// and nine sums over the tile's pixels, as in composite_train.cu:
//   d_mx = sum d_power (ca dx + cb dy),  d_my = sum d_power (cc dy + cb dx)
//   d_ca = -1/2 sum d_power dx^2,  d_cc = -1/2 sum d_power dy^2
//   d_cb = -sum d_power dx dy
//   d_c  = sum g w (per channel),  d_op = sum d_alpha exp(power)
// An empty tile writes nothing; d_feat is zeroed by the caller.
//
// What bounds it: per (pixel, duplicate) pair visited before the pixel
// terminates, one evaluation of the Gaussian (one expf) and, for a kept
// pair, about 55 FP32 operations; the bytes (36 per duplicate in, 36 out,
// 32 per pixel in) are few beside that.  What the design does about it:
//   * K3's thread layout: each thread owns PPT pixels of its tile, so one
//     shared-memory read of a duplicate feeds PPT pixels; a 32 x 32 tile
//     runs on 256 threads of up to 255 registers;
//   * duplicates are staged through shared memory kBatch at a time, and
//     the block leaves its range once __syncthreads_count says every pixel
//     terminated (the forward's early exit, replayed);
//   * the sums over pixels: each thread sums its PPT pixels, a warp by xor
//     shuffles (skipped when no lane kept the duplicate), one partial per
//     warp to shared memory, added in warp order and stored straight to
//     d_feat.  The order is fixed: the kernel is deterministic.
//
// Numerics: every operation is rounded on its own (__fmul_rn and friends,
// no FMA contraction) in the order of the plain PyTorch version
// (composite_bwd_reference), which differs only in the order of the pixel
// sums.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 9;  // mx, my, conic a, b, c, r, g, b, opacity
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kBatch = 32;  // duplicates per staged batch
constexpr unsigned kFull = 0xffffffffu;

struct Splat {
  float mx, my, ca, cb, cc, r, g, b, op;
};

__device__ __forceinline__ Splat load_splat(const float* stage, int i) {
  return Splat{stage[0 * kBatch + i], stage[1 * kBatch + i], stage[2 * kBatch + i],
               stage[3 * kBatch + i], stage[4 * kBatch + i], stage[5 * kBatch + i],
               stage[6 * kBatch + i], stage[7 * kBatch + i], stage[8 * kBatch + i]};
}

// power = -0.5 (a dx^2 + c dy^2) - b dx dy, in K1's order of operations
__device__ __forceinline__ float gauss_power(const Splat& s, float dx, float dy) {
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(s.ca, dx), dx),
                               __fmul_rn(__fmul_rn(s.cc, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(s.cb, dx), dy));
}

// PPT pixels per thread: pixel p = threadIdx.x + k * blockDim.x, k < PPT
template <int PPT>
__global__ void __launch_bounds__(kMaxThreads) composite_bwd_kernel(
    const float* __restrict__ feat,  // (9, num_dup) rows, contiguous
    long long num_dup,
    const int* __restrict__ tile_start,  // (T,) into feat's columns
    const int* __restrict__ tile_end,
    const float4* __restrict__ fwd,  // (T, tile*tile) of (r, g, b, T_final)
    const float4* __restrict__ gin,  // (T, tile*tile) of (d r, d g, d b, d T_final)
    float* __restrict__ d_feat,  // out (9, num_dup), zeroed by the caller
    int tile, int tx_tiles) {
  __shared__ float stage[kRows * kBatch];
  __shared__ float part[kMaxWarps * kBatch * kRows];
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const int t = blockIdx.x;
  const int start = tile_start[t];
  const int end = tile_end[t];
  if (start >= end) return;  // the whole block leaves: no barrier is pending
  const int ox = (t % tx_tiles) * tile;
  const int oy = (t / tx_tiles) * tile;

  float px[PPT], py[PPT], gr[PPT], gg[PPT], gb[PPT], g_ctot[PPT], gtn[PPT];
  float T[PPT], acc[PPT];  // acc: running sum of w gc over kept duplicates
  bool done[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = tid + k * nthr;
    px[k] = static_cast<float>(ox + p % tile);
    py[k] = static_cast<float>(oy + p / tile);
    const long long pix = static_cast<long long>(t) * (tile * tile) + p;
    const float4 g = gin[pix];
    const float4 o = fwd[pix];
    gr[k] = g.x;
    gg[k] = g.y;
    gb[k] = g.z;
    g_ctot[k] = __fadd_rn(__fadd_rn(__fmul_rn(g.x, o.x), __fmul_rn(g.y, o.y)),
                          __fmul_rn(g.z, o.z));
    gtn[k] = __fmul_rn(g.w, o.w);
    T[k] = 1.0f;
    acc[k] = 0.0f;
    done[k] = false;
  }

  bool all_done = false;
  for (int base = start; base < end; base += kBatch) {
    // also the barrier that keeps the previous batch's partials and stage
    // reads ahead of this batch's writes
    if (__syncthreads_count(all_done) == nthr) break;
    const int n = min(kBatch, end - base);
    for (int q = tid; q < kRows * n; q += nthr) {
      const int r = q / n;
      const int i = q - r * n;
      stage[r * kBatch + i] = feat[r * num_dup + base + i];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const Splat s = load_splat(stage, i);
      float g[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) g[r] = 0.0f;
      bool kept = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (done[k]) continue;
        const float dx = __fsub_rn(px[k], s.mx);
        const float dy = __fsub_rn(py[k], s.my);
        const float power = gauss_power(s, dx, dy);
        if (!(power <= 0.0f)) continue;
        const float expp = expf(power);
        const float alpha_raw = __fmul_rn(s.op, expp);
        const float alpha = alpha_raw > kAlphaMax ? kAlphaMax : alpha_raw;
        if (!(alpha >= kAlphaMin)) continue;
        const float t_k = T[k];
        const float test_t = __fmul_rn(t_k, __fsub_rn(1.0f, alpha));
        if (test_t < kTEps) {
          done[k] = true;
          continue;
        }
        kept = true;
        const float w = __fmul_rn(alpha, t_k);
        const float gc = __fadd_rn(__fadd_rn(__fmul_rn(gr[k], s.r), __fmul_rn(gg[k], s.g)),
                                   __fmul_rn(gb[k], s.b));
        acc[k] = __fadd_rn(acc[k], __fmul_rn(w, gc));
        const float g_s = __fsub_rn(g_ctot[k], acc[k]);
        const float inv = __frcp_rn(__fsub_rn(1.0f, alpha));
        float d_alpha = __fsub_rn(__fmul_rn(gc, t_k), __fmul_rn(__fadd_rn(g_s, gtn[k]), inv));
        if (!(alpha_raw < kAlphaMax)) d_alpha = 0.0f;
        const float d_power = __fmul_rn(d_alpha, alpha_raw);
        g[0] = __fadd_rn(g[0], __fmul_rn(d_power, __fadd_rn(__fmul_rn(s.ca, dx),
                                                             __fmul_rn(s.cb, dy))));
        g[1] = __fadd_rn(g[1], __fmul_rn(d_power, __fadd_rn(__fmul_rn(s.cc, dy),
                                                             __fmul_rn(s.cb, dx))));
        g[2] = __fadd_rn(g[2], __fmul_rn(__fmul_rn(d_power, dx), dx));
        g[3] = __fadd_rn(g[3], __fmul_rn(__fmul_rn(d_power, dx), dy));
        g[4] = __fadd_rn(g[4], __fmul_rn(__fmul_rn(d_power, dy), dy));
        g[5] = __fadd_rn(g[5], __fmul_rn(gr[k], w));
        g[6] = __fadd_rn(g[6], __fmul_rn(gg[k], w));
        g[7] = __fadd_rn(g[7], __fmul_rn(gb[k], w));
        g[8] = __fadd_rn(g[8], __fmul_rn(d_alpha, expp));
        T[k] = test_t;
      }
      float* slot = part + (warp * kBatch + i) * kRows;
      if (__any_sync(kFull, kept)) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float v = g[r];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
          g[r] = v;
        }
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) slot[r] = g[r];
        }
      } else if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) slot[r] = 0.0f;
      }
    }
    __syncthreads();
    // partials -> d_feat, summed in warp order; coalesced along duplicates
    for (int q = tid; q < kRows * n; q += nthr) {
      const int r = q / n;
      const int i = q - r * n;
      float sum = 0.0f;
      for (int w = 0; w < nwarps; ++w) sum += part[(w * kBatch + i) * kRows + r];
      if (r == 2 || r == 4) sum = -0.5f * sum;
      if (r == 3) sum = -sum;
      d_feat[r * num_dup + base + i] = sum;
    }
    all_done = true;
#pragma unroll
    for (int k = 0; k < PPT; ++k) all_done = all_done && done[k];
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream`, does not
// synchronise, and returns the cudaError_t of the launch (0 on success).
// d_feat must be zeroed: empty tiles, and duplicates past the batch in
// which every pixel of their tile terminated, are not written.
extern "C" int composite_bwd(const float* feat, long long num_dup,
                             const int* tile_start, const int* tile_end,
                             const float* out, const float* gin, float* d_feat,
                             int num_tiles, int tile, int tx_tiles, void* stream) {
  if (tile != 8 && tile != 16 && tile != 32) return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles <= 0) return 0;
  const int p_count = tile * tile;
  const int threads = p_count < kMaxThreads ? p_count : kMaxThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* fwd4 = reinterpret_cast<const float4*>(out);
  const float4* gin4 = reinterpret_cast<const float4*>(gin);
  if (p_count == threads) {
    composite_bwd_kernel<1><<<num_tiles, threads, 0, s>>>(
        feat, num_dup, tile_start, tile_end, fwd4, gin4, d_feat, tile, tx_tiles);
  } else {  // tile 32: 1024 pixels on 256 threads
    composite_bwd_kernel<4><<<num_tiles, threads, 0, s>>>(
        feat, num_dup, tile_start, tile_end, fwd4, gin4, d_feat, tile, tx_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
