// Forward tile compositor of the splat rasterizer, for Hopper (sm_90a).
//
// Replaces gaussian_splatterer_tpu/ops/raster_tiled.py::_fwd_kernel, the
// Pallas TPU kernel that _make_composite.run_fwd launches over a work list
// of (tile, chunk) items.  This kernel computes the same thing without the
// work list: one thread block per tile, each block walking its own
// [tile_start, tile_end) range of depth-ordered duplicates.
//
// Per pixel, front to back (INRIA rules, as the Pallas kernel applies them):
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy; skip if power > 0;
//   alpha = min(0.99, opacity * exp(power));  skip if alpha < 1/255;
//   if T (1 - alpha) < 1e-4 the pixel stops, without this duplicate;
//   else C += alpha T rgb and T *= 1 - alpha.
// Output per pixel: (r, g, b, T_final) as (T, tile*tile, 4) float32; the
// caller adds T_final * background.  An empty tile writes C = 0, T = 1.
//
// What bounds it: one expf and about a dozen FP32 operations per (pixel,
// duplicate) pair visited before the pixel terminates; the feature bytes
// are few beside that (36 per duplicate, read once per tile).  The work
// that needs doing is the pairs inside a duplicate's footprint.  The design
// is the fused train kernel's pass 1 (composite_train.cu) without the
// residual:
//   * compact warp patches (composite_common.cuh): min(tile^2, 256)
//     threads, PPT pixels each (4 at tile 32, else 1), a warp owning whole
//     rows of the tile, so one shared-memory read of a duplicate feeds PPT
//     pixels, dx is computed once a duplicate, and the output stores run
//     along a row;
//   * the footprint skip: a duplicate is staged with its footprint box's
//     mask of warps (composite_common.cuh, under the proof there); a warp
//     outside the box skips it;
//   * early exit: a block leaves its range once __syncthreads_count says
//     every pixel of the tile has terminated, which at real scene coverage
//     skips most of the deep duplicates of opaque tiles;
//   * occupancy: 256 threads and four blocks an SM (__launch_bounds__(256,
//     4): 64 registers, 8 bytes spilled, the footprint box's double
//     arithmetic the largest user), duplicates staged in batches of 256.
//     Three blocks (71 registers, no spills) is faster on a 1024^2 frame of
//     the bench scene but slower at 2048^2; two, five or eight blocks and
//     batches of 32, 64 or 128 are slower (PERF.md).
//
// Numerics: each operation is rounded on its own (__fmul_rn and friends,
// no FMA contraction) in the order the plain PyTorch version evaluates
// them, and expf is the full-precision library function (no fast math), so
// every pixel's arithmetic is the plain version's and the image is equal to
// it bit for bit.  The skip changes no result (the proof).

#include "composite_common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 4;  // blocks an SM: at most 64 registers a thread
constexpr int kBatch = 256;  // duplicates per staged batch

// PPT pixels per thread: pixel p = warp * 32 PPT + 32 k + lane, k < PPT;
// PPT == 4 only at tile 32, so pixel k of a thread is row k of its patch.
template <int PPT>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) composite_fwd_kernel(
    const float* __restrict__ feat,  // (9, num_dup) rows, contiguous
    long long num_dup,
    const int* __restrict__ tile_start,
    const int* __restrict__ tile_end,
    float4* __restrict__ out,  // (num_tiles, tile*tile) of (r, g, b, T)
    int tile,
    int tx_tiles) {
  __shared__ float4 stage[3 * kBatch];
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const int t = blockIdx.x;
  const int ox = (t % tx_tiles) * tile;
  const int oy = (t / tx_tiles) * tile;
  const int start = tile_start[t];
  const int end = tile_end[t];
  const int rows_w = 32 * PPT / tile;  // whole rows of the tile a warp owns
  const float x0 = static_cast<float>(ox);
  const float x1 = static_cast<float>(ox + tile - 1);
  const float y0 = static_cast<float>(oy);
  const unsigned my_bit = 1u << warp;

  const int p0 = warp * 32 * PPT + lane;
  const float px = static_cast<float>(ox + p0 % tile);
  const float py0 = static_cast<float>(oy + p0 / tile);  // pixel k: py0 + k

  float T[PPT], cr[PPT], cg[PPT], cb[PPT];
  unsigned done = 0u;  // bit k: pixel k terminated
  constexpr unsigned kAll = (1u << PPT) - 1u;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    T[k] = 1.0f;
    cr[k] = cg[k] = cb[k] = 0.0f;
  }
  bool all_done = false;
  for (int base = start; base < end; base += kBatch) {
    // also the barrier that keeps the previous batch's readers ahead of
    // this batch's writers
    if (__syncthreads_count(all_done) == nthr) break;
    const int n = min(kBatch, end - base);
    for (int q = tid; q < n; q += nthr) {
      stage_dup(stage + 3 * q, feat, num_dup, base + q, x0, x1, y0, rows_w, nwarps);
    }
    __syncthreads();
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
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    out[static_cast<long long>(t) * (tile * tile) + p0 + 32 * k] =
        make_float4(cr[k], cg[k], cb[k], T[k]);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream`, does not
// synchronise, and returns the cudaError_t of the launch (0 on success).
extern "C" int composite_fwd(const float* feat, long long num_dup,
                             const int* tile_start, const int* tile_end,
                             float* out, int num_tiles, int tile, int tx_tiles,
                             void* stream) {
  if (tile != 8 && tile != 16 && tile != 32) return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles <= 0) return 0;
  const int p_count = tile * tile;
  const int threads = p_count < kMaxThreads ? p_count : kMaxThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* out4 = reinterpret_cast<float4*>(out);
  if (p_count == threads) {
    composite_fwd_kernel<1><<<num_tiles, threads, 0, s>>>(
        feat, num_dup, tile_start, tile_end, out4, tile, tx_tiles);
  } else {  // tile 32: 1024 pixels on 256 threads
    composite_fwd_kernel<4><<<num_tiles, threads, 0, s>>>(
        feat, num_dup, tile_start, tile_end, out4, tile, tx_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the tile-32 kernel an SM holds, or -1 on error: registers and
// shared memory decide it (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int composite_fwd_blocks_per_sm() {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, composite_fwd_kernel<4>,
                                                    kMaxThreads, 0) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return per_sm;
}
