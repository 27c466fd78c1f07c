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
// pair, about 47 FP32 operations more; the bytes (36 per duplicate in, 36
// out, 32 per pixel in) are few beside that.  The work that needs doing is
// the pairs inside a duplicate's footprint.  The design is K3's pass 2
// (composite_train.cu), with (gin, out) in place of the residual:
//   * compact warp patches (composite_common.cuh): min(tile^2, 256)
//     threads, PPT pixels each, a warp owning whole rows of the tile, so
//     its gin and out loads run along a row, and at tile 32 a thread's four
//     pixels share one column (dx is computed once a duplicate);
//   * the footprint skip: a duplicate is staged with its footprint box's
//     mask of warps (composite_common.cuh, under the proof there); a warp
//     outside the box skips it, writes a 0 partial and runs no shuffle;
//   * the nine pixel sums of a warp by warp_reduce9's reduce-scatter, 12
//     shuffles a duplicate (45 for nine separate xor reductions);
//   * FMA where no decision depends on it: gc, d_power's products and the
//     nine sums contract; acc, g_s = g_ctot - acc (which cancels), 1/(1 -
//     alpha) (which amplifies by up to 100) and d_alpha stay rounded op by
//     op, like every operation of the skip and stop decisions;
//   * early exit: the block leaves its range once __syncthreads_count says
//     every pixel terminated (the forward's early exit, replayed);
//   * occupancy: 256 threads and three blocks an SM (__launch_bounds__(256,
//     3): 76 registers, no spills), duplicates staged in batches of 64,
//     three barriers a batch.  Faster, measured, than four blocks (64
//     registers, 44 bytes spilled), two or five, and than batches of 32 or
//     128 (PERF.md).
//
// Sum order: a pixel's terms in duplicate order; a thread's PPT pixels in
// k order; the warp's lanes by the fixed butterfly; the warps in warp
// order, skipped warps adding 0.  The kernel is deterministic.  It differs
// from the plain PyTorch version (composite_bwd_reference) only in the
// order of the pixel sums and in the FMA contractions above.

#include "composite_common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 3;  // blocks an SM: at most 80 registers a thread
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kBatch = 64;  // duplicates per staged batch

// PPT pixels per thread: pixel p = warp * 32 PPT + 32 k + lane, k < PPT;
// PPT == 4 only at tile 32, so pixel k of a thread is row k of its patch.
template <int PPT>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) composite_bwd_kernel(
    const float* __restrict__ feat,  // (9, num_dup) rows, contiguous
    long long num_dup,
    const int* __restrict__ tile_start,  // (T,) into feat's columns
    const int* __restrict__ tile_end,
    const float4* __restrict__ fwd,  // (T, tile*tile) of (r, g, b, T_final)
    const float4* __restrict__ gin,  // (T, tile*tile) of (d r, d g, d b, d T_final)
    float* __restrict__ d_feat,  // out (9, num_dup), zeroed by the caller
    int tile, int tx_tiles) {
  __shared__ float4 stage[3 * kBatch];
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
  const int rows_w = 32 * PPT / tile;  // whole rows of the tile a warp owns
  const float x0 = static_cast<float>(ox);
  const float x1 = static_cast<float>(ox + tile - 1);
  const float y0 = static_cast<float>(oy);
  const unsigned my_bit = 1u << warp;
  const int my_row = reduced_row(lane);

  const int p0 = warp * 32 * PPT + lane;
  const float px = static_cast<float>(ox + p0 % tile);
  const float py0 = static_cast<float>(oy + p0 / tile);  // pixel k: py0 + k

  float gr[PPT], gg[PPT], gb[PPT], g_ctot[PPT], gtn[PPT];
  float T[PPT], acc[PPT];  // acc: running sum of w gc over kept duplicates
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const long long pix = static_cast<long long>(t) * (tile * tile) + p0 + 32 * k;
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
  }
  unsigned done = 0u;  // bit k: pixel k terminated
  constexpr unsigned kAll = (1u << PPT) - 1u;

  bool all_done = false;
  for (int base = start; base < end; base += kBatch) {
    // also the barrier that keeps the previous batch's partials and stage
    // reads ahead of this batch's writes
    if (__syncthreads_count(all_done) == nthr) break;
    const int n = min(kBatch, end - base);
    for (int q = tid; q < n; q += nthr) {
      stage_dup(stage + 3 * q, feat, num_dup, base + q, x0, x1, y0, rows_w, nwarps);
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      unsigned mask;
      const Splat s = load_splat(stage + 3 * i, mask);
      float* slot = part + (warp * kBatch + i) * kRows;
      if (!(mask & my_bit)) {
        if (my_row >= 0) slot[my_row] = 0.0f;
        continue;
      }
      float g[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) g[r] = 0.0f;
      bool kept = false;
      const float dx = __fsub_rn(px, s.mx);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (done & (1u << k)) continue;
        const float dy = __fsub_rn(py0 + static_cast<float>(k), s.my);
        const float power = gauss_power(s, dx, dy);
        if (!(power <= 0.0f)) continue;
        const float expp = expf(power);
        const float alpha_raw = __fmul_rn(s.op, expp);
        const float alpha = alpha_raw > kAlphaMax ? kAlphaMax : alpha_raw;
        if (!(alpha >= kAlphaMin)) continue;
        const float t_k = T[k];
        const float test_t = __fmul_rn(t_k, __fsub_rn(1.0f, alpha));
        if (test_t < kTEps) {
          done |= 1u << k;
          continue;
        }
        kept = true;
        const float w = __fmul_rn(alpha, t_k);
        const float gc = fmaf(gb[k], s.b, fmaf(gg[k], s.g, gr[k] * s.r));
        acc[k] = __fadd_rn(acc[k], __fmul_rn(w, gc));
        const float g_s = __fsub_rn(g_ctot[k], acc[k]);
        const float inv = __frcp_rn(__fsub_rn(1.0f, alpha));
        float d_alpha = __fsub_rn(__fmul_rn(gc, t_k), __fmul_rn(__fadd_rn(g_s, gtn[k]), inv));
        if (!(alpha_raw < kAlphaMax)) d_alpha = 0.0f;
        const float d_power = d_alpha * alpha_raw;
        const float pdx = d_power * dx;
        const float pdy = d_power * dy;
        g[0] = fmaf(s.cb, pdy, fmaf(s.ca, pdx, g[0]));
        g[1] = fmaf(s.cb, pdx, fmaf(s.cc, pdy, g[1]));
        g[2] = fmaf(pdx, dx, g[2]);
        g[3] = fmaf(pdx, dy, g[3]);
        g[4] = fmaf(pdy, dy, g[4]);
        g[5] = fmaf(gr[k], w, g[5]);
        g[6] = fmaf(gg[k], w, g[6]);
        g[7] = fmaf(gb[k], w, g[7]);
        g[8] = fmaf(d_alpha, expp, g[8]);
        T[k] = test_t;
      }
      if (__any_sync(kFull, kept)) {
        const float v = warp_reduce9(g, lane);
        if (my_row >= 0) slot[my_row] = v;
      } else if (my_row >= 0) {
        slot[my_row] = 0.0f;
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
    all_done = done == kAll;
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

// Blocks of the tile-32 kernel an SM holds, or -1 on error: registers and
// shared memory decide it (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int composite_bwd_blocks_per_sm() {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, composite_bwd_kernel<4>,
                                                    kMaxThreads, 0) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return per_sm;
}
