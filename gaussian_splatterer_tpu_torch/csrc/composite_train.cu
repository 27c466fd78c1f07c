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
// Per pixel:
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
// FP32 operations in all (an FMA counted as two); the bytes (36 per
// duplicate in, 36 out, 28 per pixel) are few beside that.  The work that
// needs doing is the pairs inside a duplicate's footprint; the rest of a
// tile's pixels need only be shown to lie outside it.  What the design does:
//   * compact warp patches: the block has min(tile^2, 256) threads, PPT
//     pixels each, pixel p = warp 32 PPT + 32 k + lane, so a warp owns
//     32 PPT / tile whole rows of the tile (4 rows of 32 at tile 32, 2 of
//     16 at tile 16, 4 of 8 at tile 8), its truth loads and residual stores
//     run along a row, and at tile 32 its four pixels share one column (dx
//     and its products are computed once a duplicate);
//   * the footprint skip: when a duplicate is staged, one thread computes
//     its footprint box (below) and a mask of the warps whose patch meets
//     it; a warp outside the box skips the duplicate in both passes, with
//     no evaluation and no reduction.  The skip is warp-uniform;
//   * the pixel reduction of pass 2 is a reduce-scatter butterfly over the
//     nine rows: at xor distance 16 a lane keeps five rows (or four) and
//     sends the others to its partner, at 8 three, at 4 two, at 2 one,
//     and a last xor 1 sums the pair; 5 + 3 + 2 + 1 + 1 = 12 shuffles a
//     duplicate a warp, where nine separate xor reductions take 45; then
//     nine lanes each hold one row's warp sum (reduced_row) and store it;
//   * FMA where no decision depends on it: gc, d_power's products and the
//     nine sums contract; acc, g_s = g_ctot - acc (which cancels), 1/(1 -
//     alpha) (which amplifies by up to 100) and d_alpha stay rounded op by
//     op, like every operation of both passes' skip and stop decisions;
//   * early exit: pass 1 leaves its range once __syncthreads_count says
//     every pixel terminated, and pass 2 stops at the last duplicate any
//     pixel of the tile reached;
//   * occupancy: 256 threads and four blocks an SM (__launch_bounds__(256,
//     4): at most 64 registers, a few bytes spilled), 32 warps to hide the
//     barriers, and pass 2 staged in batches of 64 duplicates, three
//     barriers a batch.  Faster, measured, than three blocks (80 registers, no
//     spills) or two, and than batches of 32 (PERF.md).
//
// Sum order: a pixel's terms in duplicate order; a thread's PPT pixels in
// k order; the warp's lanes by the fixed butterfly (each pair adds the
// same two values, so both hold the same sum); the warps in warp order,
// skipped warps adding 0.  A duplicate belongs to exactly one (frame,
// tile) block: no atomics, and the kernel is deterministic.
//
// The footprint box and its proof, the staging, gauss_power and the
// reduce-scatter are composite_common.cuh's, shared with K1 and K2.

#include "composite_common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 4;  // blocks an SM: at most 64 registers a thread
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kBatch2 = 64;  // duplicates per staged batch of pass 2

// PPT pixels per thread: pixel p = warp * 32 PPT + 32 k + lane, k < PPT;
// PPT == 4 only at tile 32, so pixel k of a thread is row k of its patch.
template <int PPT>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) composite_train_kernel(
    const float* __restrict__ feat,  // (9, num_dup) rows, contiguous
    long long num_dup,
    const int* __restrict__ tile_start,  // (F*T,) into feat's columns
    const int* __restrict__ tile_end,
    const float* __restrict__ truth,  // (F*T, tile*tile, 3)
    const float* __restrict__ bg,  // (F, 3)
    float4* __restrict__ res,  // out (F*T, tile*tile) of (r, g, b, T_final)
    float* __restrict__ d_feat,  // out (9, num_dup), zeroed by the caller
    int tile, int tx_tiles, int tiles_frame) {
  __shared__ float4 stage[3 * kMaxThreads];
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
  const int rows_w = 32 * PPT / tile;  // whole rows of the tile a warp owns
  const float x0 = static_cast<float>(ox);
  const float x1 = static_cast<float>(ox + tile - 1);
  const float y0 = static_cast<float>(oy);
  const unsigned my_bit = 1u << warp;
  const int my_row = reduced_row(lane);

  const int p0 = warp * 32 * PPT + lane;
  const float px = static_cast<float>(ox + p0 % tile);
  const float py0 = static_cast<float>(oy + p0 / tile);  // pixel k: py0 + k

  // ---- pass 1: forward composite (K1's loop) ----
  float T[PPT], cr[PPT], cg[PPT], cb[PPT];
  unsigned done = 0u;  // bit k: pixel k terminated
  constexpr unsigned kAll = (1u << PPT) - 1u;
  int lim = start;  // one past the last duplicate any of my pixels reached
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    T[k] = 1.0f;
    cr[k] = cg[k] = cb[k] = 0.0f;
  }
  bool all_done = false;
  for (int base = start; base < end; base += nthr) {
    // also the barrier that keeps the previous batch's readers ahead of
    // this batch's writers
    if (__syncthreads_count(all_done) == nthr) break;
    if (base + tid < end) {
      stage_dup(stage + 3 * tid, feat, num_dup, base + tid, x0, x1, y0, rows_w, nwarps);
    }
    __syncthreads();
    const int n = min(nthr, end - base);
    for (int i = 0; i < n && !all_done; ++i) {
      unsigned mask;
      const Splat s = load_splat(stage + 3 * i, mask);
      if (!(mask & my_bit)) continue;
      const float dx = __fsub_rn(px, s.mx);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (done & (1u << k)) continue;
        const float dy = __fsub_rn(py0 + static_cast<float>(k), s.my);
        const float power = gauss_power(s, dx, dy);
        if (!(power <= 0.0f)) continue;
        float alpha = __fmul_rn(s.op, expf(power));
        alpha = alpha > kAlphaMax ? kAlphaMax : alpha;
        if (!(alpha >= kAlphaMin)) continue;
        const float test_t = __fmul_rn(T[k], __fsub_rn(1.0f, alpha));
        if (test_t < kTEps) {
          done |= 1u << k;
          lim = max(lim, base + i);
          continue;
        }
        const float w = __fmul_rn(alpha, T[k]);
        cr[k] = __fadd_rn(cr[k], __fmul_rn(w, s.r));
        cg[k] = __fadd_rn(cg[k], __fmul_rn(w, s.g));
        cb[k] = __fadd_rn(cb[k], __fmul_rn(w, s.b));
        T[k] = test_t;
      }
      all_done = done == kAll;
    }
  }
  if (done != kAll) lim = end;

  // ---- residual ----
  const float bg_r = bg[3 * frame + 0];
  const float bg_g = bg[3 * frame + 1];
  const float bg_b = bg[3 * frame + 2];
  float rr[PPT], rg[PPT], rb[PPT], g_ctot[PPT], gtn[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const long long pix = static_cast<long long>(blk) * p_count + p0 + 32 * k;
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
  }
  done = 0u;
  for (int base = start; base < stop; base += kBatch2) {
    const int n = min(kBatch2, stop - base);
    __syncthreads();  // the previous batch's partials are consumed
    if (tid < n) stage_dup(stage + 3 * tid, feat, num_dup, base + tid, x0, x1, y0, rows_w, nwarps);
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      unsigned mask;
      const Splat s = load_splat(stage + 3 * i, mask);
      float* slot = part + (warp * kBatch2 + i) * kRows;
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
        const float gc = fmaf(rb[k], s.b, fmaf(rg[k], s.g, rr[k] * s.r));
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
        g[5] = fmaf(rr[k], w, g[5]);
        g[6] = fmaf(rg[k], w, g[6]);
        g[7] = fmaf(rb[k], w, g[7]);
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

// Blocks of the tile-32 kernel an SM holds, or -1 on error: registers and
// shared memory decide it (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int composite_train_blocks_per_sm() {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, composite_train_kernel<4>,
                                                    kMaxThreads, 0) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return per_sm;
}
