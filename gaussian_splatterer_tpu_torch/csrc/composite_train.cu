// Fused training compositor of the splat rasterizer, for Hopper (sm_90a):
// forward composite, signed residual against the truth tile, and the
// backward replay into per-duplicate gradients, in one launch.
//
// Replaces gaussian_splatterer_tpu/ops/raster_tiled.py::_train_kernel, the
// Pallas TPU kernel that _composite_train_flat launches over a bit-packed
// work list of (frame, tile, window) items, carrying the compositing state
// in VMEM between grid steps and emitting lo/hi gradient slabs that are
// segment-summed outside.  This kernel computes the same thing without the
// work list: one thread block per (frame, tile), walking its own
// [tile_start, tile_end) range of depth-ordered duplicates twice.
//
// Per pixel (the tile's pixels are spread over the block's threads):
//   pass 1   K1's forward loop exactly (csrc/composite_fwd.cu): same
//            operations in the same order, the same skip and stop rules;
//            gives C (rgb) and T_final.
//   residual res = truth - (C + T_final bg[frame]), written as
//            (r, g, b, T_final); g_t = res.bg, g_ctot = res.C.
//   pass 2   front-to-back replay with the same decisions.  For a kept
//            duplicate k with t_k = T before k and w = alpha t_k:
//              gc      = res.c_k
//              S_k.res = g_ctot - sum_{j<=k} w_j gc_j
//              d_alpha = gc t_k - (S_k.res + g_t T_final) / (1 - alpha),
//                        zero where alpha_raw >= 0.99 (the clamp)
//              d_power = d_alpha alpha_raw
//            and nine sums over the tile's pixels:
//              d_mx = sum d_power (ca dx + cb dy)
//              d_my = sum d_power (cc dy + cb dx)
//              d_ca = -1/2 sum d_power dx^2,  d_cc = -1/2 sum d_power dy^2
//              d_cb = -sum d_power dx dy
//              d_c  = sum res w (per channel),  d_op = sum d_alpha exp(power)
//            This is J^T residual, the reference's sign convention.
// An empty tile writes res = truth - bg, T = 1 and no gradients.
//
// What bounds it: per (pixel, duplicate) pair visited before the pixel
// terminates, two evaluations of the Gaussian (one expf each) and about 90
// FP32 operations in all; the bytes (36 per duplicate in, 36 out, 28 per
// pixel) are few beside that.  What the design does about it:
//   * each thread owns PPT pixels of its tile, so one shared-memory read of
//     a duplicate's features feeds PPT pixels, and a tile of 32 x 32 needs
//     256 threads of up to 255 registers instead of 1024 threads capped at
//     64 (the pass-2 state does not fit 64 without spills);
//   * early exit: pass 1 leaves its range once __syncthreads_count says
//     every pixel terminated, and pass 2 stops at the last duplicate any
//     pixel of the tile reached;
//   * the reduction over pixels: each thread sums its PPT pixels, a warp
//     sums by xor shuffles (skipped when no lane of the warp kept the
//     duplicate), and one partial per warp goes to shared memory; the
//     partials are added in warp order and stored straight to d_feat.  A
//     duplicate belongs to exactly one (frame, tile) block, so no atomics,
//     and the sum order is fixed: the kernel is deterministic.
//
// Numerics: every operation is rounded on its own (__fmul_rn and friends,
// no FMA contraction) in the order the plain PyTorch version
// (composite_train_reference) evaluates it, with the full-precision expf,
// so the two take the same skip and stop decisions and differ only in the
// order of the pixel sums.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 9;  // mx, my, conic a, b, c, r, g, b, opacity
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kBatch2 = 32;  // duplicates per staged batch of pass 2
constexpr unsigned kFull = 0xffffffffu;

struct Splat {
  float mx, my, ca, cb, cc, r, g, b, op;
};

__device__ __forceinline__ Splat load_splat(const float* stage, int stride, int i) {
  return Splat{stage[0 * stride + i], stage[1 * stride + i], stage[2 * stride + i],
               stage[3 * stride + i], stage[4 * stride + i], stage[5 * stride + i],
               stage[6 * stride + i], stage[7 * stride + i], stage[8 * stride + i]};
}

// power = -0.5 (a dx^2 + c dy^2) - b dx dy, in K1's order of operations
__device__ __forceinline__ float gauss_power(const Splat& s, float dx, float dy) {
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(s.ca, dx), dx),
                               __fmul_rn(__fmul_rn(s.cc, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(s.cb, dx), dy));
}

// PPT pixels per thread: pixel p = threadIdx.x + k * blockDim.x, k < PPT
template <int PPT>
__global__ void __launch_bounds__(kMaxThreads) composite_train_kernel(
    const float* __restrict__ feat,  // (9, num_dup) rows, contiguous
    long long num_dup,
    const int* __restrict__ tile_start,  // (F*T,) into feat's columns
    const int* __restrict__ tile_end,
    const float* __restrict__ truth,  // (F*T, tile*tile, 3)
    const float* __restrict__ bg,  // (F, 3)
    float4* __restrict__ res,  // out (F*T, tile*tile) of (r, g, b, T_final)
    float* __restrict__ d_feat,  // out (9, num_dup), zeroed by the caller
    int tile, int tx_tiles, int tiles_frame) {
  __shared__ float stage[kRows * kMaxThreads];
  __shared__ float part[kMaxWarps * kBatch2 * kRows];
  __shared__ int s_lim;
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const int blk = blockIdx.x;  // (frame, tile) id, frame-major
  const int frame = blk / tiles_frame;
  const int t = blk - frame * tiles_frame;
  const int p_count = tile * tile;
  const int ox = (t % tx_tiles) * tile;
  const int oy = (t / tx_tiles) * tile;
  const int start = tile_start[blk];
  const int end = tile_end[blk];

  float px[PPT], py[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = tid + k * nthr;
    px[k] = static_cast<float>(ox + p % tile);
    py[k] = static_cast<float>(oy + p / tile);
  }

  // ---- pass 1: forward composite (K1's loop) ----
  float T[PPT], cr[PPT], cg[PPT], cb[PPT];
  bool done[PPT];
  int lim = start;  // one past the last duplicate any of my pixels reached
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    T[k] = 1.0f;
    cr[k] = cg[k] = cb[k] = 0.0f;
    done[k] = false;
  }
  bool all_done = false;
  for (int base = start; base < end; base += nthr) {
    // also the barrier that keeps the previous batch's readers ahead of
    // this batch's writers
    if (__syncthreads_count(all_done) == nthr) break;
    const int j = base + tid;
    if (j < end) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) stage[r * nthr + tid] = feat[r * num_dup + j];
    }
    __syncthreads();
    const int n = min(nthr, end - base);
    for (int i = 0; i < n && !all_done; ++i) {
      const Splat s = load_splat(stage, nthr, i);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (done[k]) continue;
        const float dx = __fsub_rn(px[k], s.mx);
        const float dy = __fsub_rn(py[k], s.my);
        const float power = gauss_power(s, dx, dy);
        if (!(power <= 0.0f)) continue;
        float alpha = __fmul_rn(s.op, expf(power));
        alpha = alpha > kAlphaMax ? kAlphaMax : alpha;
        if (!(alpha >= kAlphaMin)) continue;
        const float test_t = __fmul_rn(T[k], __fsub_rn(1.0f, alpha));
        if (test_t < kTEps) {
          done[k] = true;
          lim = max(lim, base + i);
          continue;
        }
        const float w = __fmul_rn(alpha, T[k]);
        cr[k] = __fadd_rn(cr[k], __fmul_rn(w, s.r));
        cg[k] = __fadd_rn(cg[k], __fmul_rn(w, s.g));
        cb[k] = __fadd_rn(cb[k], __fmul_rn(w, s.b));
        T[k] = test_t;
      }
      all_done = true;
#pragma unroll
      for (int k = 0; k < PPT; ++k) all_done = all_done && done[k];
    }
  }
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if (!done[k]) lim = end;
  }

  // ---- residual ----
  const float bg_r = bg[3 * frame + 0];
  const float bg_g = bg[3 * frame + 1];
  const float bg_b = bg[3 * frame + 2];
  float rr[PPT], rg[PPT], rb[PPT], g_ctot[PPT], gtn[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const long long pix = static_cast<long long>(blk) * p_count + tid + k * nthr;
    const float* tr = truth + 3 * pix;
    rr[k] = __fsub_rn(tr[0], __fadd_rn(cr[k], __fmul_rn(T[k], bg_r)));
    rg[k] = __fsub_rn(tr[1], __fadd_rn(cg[k], __fmul_rn(T[k], bg_g)));
    rb[k] = __fsub_rn(tr[2], __fadd_rn(cb[k], __fmul_rn(T[k], bg_b)));
    res[pix] = make_float4(rr[k], rg[k], rb[k], T[k]);
    const float g_t = __fadd_rn(__fadd_rn(__fmul_rn(rr[k], bg_r), __fmul_rn(rg[k], bg_g)),
                                __fmul_rn(rb[k], bg_b));
    g_ctot[k] = __fadd_rn(__fadd_rn(__fmul_rn(rr[k], cr[k]), __fmul_rn(rg[k], cg[k])),
                          __fmul_rn(rb[k], cb[k]));
    gtn[k] = __fmul_rn(g_t, T[k]);
  }

  if (tid == 0) s_lim = start;
  __syncthreads();
  atomicMax(&s_lim, lim);
  __syncthreads();
  const int stop = s_lim;

  // ---- pass 2: backward replay ----
  float acc[PPT];  // running sum of w gc over kept duplicates
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    T[k] = 1.0f;
    acc[k] = 0.0f;
    done[k] = false;
  }
  for (int base = start; base < stop; base += kBatch2) {
    const int n = min(kBatch2, stop - base);
    __syncthreads();  // the previous batch's partials are consumed
    for (int q = tid; q < kRows * n; q += nthr) {
      const int r = q / n;
      const int i = q - r * n;
      stage[r * kBatch2 + i] = feat[r * num_dup + base + i];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const Splat s = load_splat(stage, kBatch2, i);
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
        const float gc = __fadd_rn(__fadd_rn(__fmul_rn(rr[k], s.r), __fmul_rn(rg[k], s.g)),
                                   __fmul_rn(rb[k], s.b));
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
        g[5] = __fadd_rn(g[5], __fmul_rn(rr[k], w));
        g[6] = __fadd_rn(g[6], __fmul_rn(rg[k], w));
        g[7] = __fadd_rn(g[7], __fmul_rn(rb[k], w));
        g[8] = __fadd_rn(g[8], __fmul_rn(d_alpha, expp));
        T[k] = test_t;
      }
      float* slot = part + (warp * kBatch2 + i) * kRows;
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
      for (int w = 0; w < nwarps; ++w) sum += part[(w * kBatch2 + i) * kRows + r];
      if (r == 2 || r == 4) sum = -0.5f * sum;
      if (r == 3) sum = -sum;
      d_feat[r * num_dup + base + i] = sum;
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream`, does not
// synchronise, and returns the cudaError_t of the launch (0 on success).
// d_feat must be zeroed: duplicates past the last one any pixel of their
// tile reached are not written.
extern "C" int composite_train(const float* feat, long long num_dup,
                               const int* tile_start, const int* tile_end,
                               const float* truth, const float* bg,
                               float* res, float* d_feat,
                               int num_blocks, int tile, int tx_tiles, int tiles_frame,
                               void* stream) {
  if (tile != 8 && tile != 16 && tile != 32) return static_cast<int>(cudaErrorInvalidValue);
  if (num_blocks <= 0) return 0;
  const int p_count = tile * tile;
  const int threads = p_count < kMaxThreads ? p_count : kMaxThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* res4 = reinterpret_cast<float4*>(res);
  if (p_count == threads) {
    composite_train_kernel<1><<<num_blocks, threads, 0, s>>>(
        feat, num_dup, tile_start, tile_end, truth, bg, res4, d_feat, tile, tx_tiles,
        tiles_frame);
  } else {  // tile 32: 1024 pixels on 256 threads
    composite_train_kernel<4><<<num_blocks, threads, 0, s>>>(
        feat, num_dup, tile_start, tile_end, truth, bg, res4, d_feat, tile, tx_tiles,
        tiles_frame);
  }
  return static_cast<int>(cudaGetLastError());
}
