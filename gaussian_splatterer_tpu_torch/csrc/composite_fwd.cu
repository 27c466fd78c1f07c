// Forward tile compositor of the splat rasterizer, for Hopper (sm_90a).
//
// Replaces gaussian_splatterer_tpu/ops/raster_tiled.py::_fwd_kernel, the
// Pallas TPU kernel that _make_composite.run_fwd launches over a work list
// of (tile, chunk) items.  This kernel computes the same thing without the
// work list: one thread block per tile, one thread per pixel, each block
// walking its own [tile_start, tile_end) range of depth-ordered duplicates.
//
// Per pixel, front to back (INRIA rules, as the Pallas kernel applies them):
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy; skip if power > 0;
//   alpha = min(0.99, opacity * exp(power));  skip if alpha < 1/255;
//   if T (1 - alpha) < 1e-4 the pixel stops, without this duplicate;
//   else C += alpha T rgb and T *= 1 - alpha.
// Output per pixel: (r, g, b, T_final) as (T, tile*tile, 4) float32; the
// caller adds T_final * background.  An empty tile writes C = 0, T = 1.
//
// What bounds it: one expf and about a dozen FMA-class operations per
// (pixel, duplicate) pair; the feature bytes are few beside that (36 per
// duplicate, read once per tile).  What the design does about it:
//   * early exit: a block leaves its range once __syncthreads_count says
//     every pixel of the tile has terminated, which at real scene coverage
//     skips most of the deep duplicates of opaque tiles;
//   * shared-memory staging: each batch of blockDim duplicates is read
//     from device memory once, coalesced from the SoA (9, D) rows, and then
//     broadcast from shared memory to every pixel of the tile.
//
// Numerics: each operation is rounded on its own (__fmul_rn and friends,
// no FMA contraction) in the order the plain PyTorch version evaluates
// them, and expf is the full-precision library function (no fast math), so
// the alpha >= 1/255 and T >= 1e-4 decisions agree with the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 9;  // mx, my, conic a, b, c, r, g, b, opacity
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

__global__ void __launch_bounds__(1024) composite_fwd_kernel(
    const float* __restrict__ feat,  // (9, num_dup) rows, contiguous
    long long num_dup,
    const int* __restrict__ tile_start,
    const int* __restrict__ tile_end,
    float4* __restrict__ out,  // (num_tiles, tile*tile) of (r, g, b, T)
    int tile,
    int tx_tiles) {
  extern __shared__ float stage[];  // kRows x blockDim.x
  const int nthr = blockDim.x;
  const int p = threadIdx.x;
  const int t = blockIdx.x;
  const float px = static_cast<float>((t % tx_tiles) * tile + p % tile);
  const float py = static_cast<float>((t / tx_tiles) * tile + p / tile);
  const int start = tile_start[t];
  const int end = tile_end[t];

  float T = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  int done = 0;
  for (int base = start; base < end; base += nthr) {
    // also the barrier that keeps the previous batch's readers ahead of
    // this batch's writers
    if (__syncthreads_count(done) == nthr) break;
    const int j = base + p;
    if (j < end) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) stage[k * nthr + p] = feat[k * num_dup + j];
    }
    __syncthreads();
    const int n = min(nthr, end - base);
    for (int i = 0; i < n && !done; ++i) {
      const float dx = __fsub_rn(px, stage[0 * nthr + i]);
      const float dy = __fsub_rn(py, stage[1 * nthr + i]);
      const float ca = stage[2 * nthr + i];
      const float cb = stage[3 * nthr + i];
      const float cc = stage[4 * nthr + i];
      const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                                   __fmul_rn(__fmul_rn(cc, dy), dy));
      const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                    __fmul_rn(__fmul_rn(cb, dx), dy));
      if (!(power <= 0.0f)) continue;
      float alpha = __fmul_rn(stage[8 * nthr + i], expf(power));
      alpha = alpha > kAlphaMax ? kAlphaMax : alpha;
      if (!(alpha >= kAlphaMin)) continue;
      const float test_t = __fmul_rn(T, __fsub_rn(1.0f, alpha));
      if (test_t < kTEps) {
        done = 1;
        break;
      }
      const float w = __fmul_rn(alpha, T);
      r = __fadd_rn(r, __fmul_rn(w, stage[5 * nthr + i]));
      g = __fadd_rn(g, __fmul_rn(w, stage[6 * nthr + i]));
      b = __fadd_rn(b, __fmul_rn(w, stage[7 * nthr + i]));
      T = test_t;
    }
  }
  out[static_cast<long long>(t) * nthr + p] = make_float4(r, g, b, T);
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
  const int threads = tile * tile;
  const size_t smem = sizeof(float) * kRows * threads;
  composite_fwd_kernel<<<num_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      feat, num_dup, tile_start, tile_end, reinterpret_cast<float4*>(out), tile, tx_tiles);
  return static_cast<int>(cudaGetLastError());
}
