// First-hit Möller-Trumbore intersector of the path tracer, for Hopper (sm_90a).
//
// Replaces gaussian_splatterer_tpu/rt/tracer.py::_intersect_mxu_fused, the
// Pallas TPU kernel (its inner `kernel`) that evaluates, per (ray block,
// triangle chunk) grid step, the (10, Rb)^T x (10, 4 Tc) product of the ray
// features [d, o x d, o, 1] with the per-triangle "feat10" columns
// [det | u_num | v_num | t_num], applies the guards and folds the first
// minimum across chunks with a strict <.  Its plain twin is
// rt/tracer.py::intersect_reference.
//
// Contract, per ray (o, d), over all triangles:
//   det = d . fdet, inv = 1 / (|det| < 1e-12 ? +1e-12 : det);
//   u = u_num inv, v = v_num inv, t = t_num inv;
//   hit: valid, u >= 0, v >= 0, u + v <= 1, t > 1e-3;
//   the nearest hit, ties to the lowest triangle index;
//   a miss returns t = inf, idx = 0, u = v = 0.
// One thread walks the triangles in index order and keeps a hit only when
// its t is strictly below the best so far: exactly the first minimum.
//
// What bounds it: arithmetic.  Per (ray, triangle) pair, 40 FMAs (four
// dot products of length 10) and an epilogue of about a dozen operations
// (the guard, one division, three products, five comparisons, the running
// minimum); the bytes are 24 a ray in, 16 a ray out and 161 a triangle,
// read by every block from L2.  What the design does about it:
//   * one thread per ray, its ten features and its running best in
//     registers;
//   * the triangles staged kTriTile at a time in shared memory by the whole
//     block, read from the scene's feat10 table (10, 4 T) by column, which
//     for triangle i = ck Tc + j and quantity q is ck 4 Tc + q Tc + j;
//     consecutive threads read consecutive columns, and the tile is laid
//     out triangle by triangle, so that every thread then reads the same
//     triangle at the same time, a shared-memory broadcast, as ten 16-byte
//     loads;
//   * FP32 FMAs only: no TF32 and no tensor cores, since t_num cancels for
//     bounce origins on the mesh.  Skipping triangle chunks by their AABB
//     and a wgmma / 3xTF32 product are later levers.
//
// Numerics: the ray features o x d are rounded product by product, as the
// plain version forms them; the dot products are FMA chains, where the plain
// version's float32 matrix product sums in its own order, so t, u, v agree
// to float32 rounding and a hit can flip only where a guard sits within
// rounding of its bound.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;  // rays per block, one per thread
// five blocks an SM caps a thread at 51 registers; the staging from feat10
// took it to 64 and four blocks, a wave more on a 1024^2 frame's 4,096
constexpr int kMinBlocks = 5;
constexpr int kTriTile = 128;  // triangles staged in shared memory per step
constexpr int kFeat = 40;      // 4 quantities x 10 ray features per triangle
constexpr int kStagers = kThreads / kTriTile;  // threads staging each triangle of a tile
static_assert(kThreads % kTriTile == 0, "every triangle of a tile has kStagers threads");
constexpr float kTMin = 1e-3f;
constexpr float kDetEps = 1e-12f;

__global__ void __launch_bounds__(kThreads, kMinBlocks) mt_intersect_kernel(
    const float* __restrict__ orig,   // (R, 3)
    const float* __restrict__ dir,    // (R, 3)
    int num_rays,
    const float* __restrict__ feat10,        // (10, 4 T): per chunk [det | u | v | t]
    const unsigned char* __restrict__ valid,  // (T,) 1 for a triangle, 0 for padding
    int num_tris, int tri_chunk,              // T, a multiple of the chunk Tc
    float* __restrict__ out_t, int* __restrict__ out_idx,
    float* __restrict__ out_u, float* __restrict__ out_v) {
  __shared__ __align__(16) float s_feat[kTriTile * kFeat];  // [triangle][q][feature]
  __shared__ unsigned char s_valid[kTriTile];
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ray < num_rays;

  float f[10];
  if (live) {
    const float ox = orig[3 * ray], oy = orig[3 * ray + 1], oz = orig[3 * ray + 2];
    const float dx = dir[3 * ray], dy = dir[3 * ray + 1], dz = dir[3 * ray + 2];
    f[0] = dx;
    f[1] = dy;
    f[2] = dz;
    f[3] = __fsub_rn(__fmul_rn(oy, dz), __fmul_rn(oz, dy));
    f[4] = __fsub_rn(__fmul_rn(oz, dx), __fmul_rn(ox, dz));
    f[5] = __fsub_rn(__fmul_rn(ox, dy), __fmul_rn(oy, dx));
    f[6] = ox;
    f[7] = oy;
    f[8] = oz;
    f[9] = 1.0f;
  }

  float best_t = CUDART_INF_F, best_u = 0.0f, best_v = 0.0f;
  int best_i = 0;
  for (int base = 0; base < num_tris; base += kTriTile) {
    const int n = min(kTriTile, num_tris - base);
    __syncthreads();  // the previous tile's readers are done
    // a thread stages one triangle jj of the tile, every kStagers-th of its
    // 40 (feature, quantity) columns; one division per tile
    const int jj = threadIdx.x % kTriTile;
    if (jj < n) {
      const int i = base + jj, ck = i / tri_chunk;
      const long long col = 4LL * ck * tri_chunk + (i - ck * tri_chunk);
      for (int kq = threadIdx.x / kTriTile; kq < kFeat; kq += kStagers) {
        const int k = kq >> 2, q = kq & 3;
        s_feat[jj * kFeat + 10 * q + k] =
            feat10[4LL * num_tris * k + col + static_cast<long long>(q) * tri_chunk];
      }
    }
    for (int k = threadIdx.x; k < n; k += kThreads) s_valid[k] = valid[base + k];
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      // the triangle's 40 columns as ten 16-byte shared-memory loads
      float g[kFeat];
      const float4* g4 = reinterpret_cast<const float4*>(s_feat + j * kFeat);
#pragma unroll
      for (int k = 0; k < kFeat / 4; ++k) {
        const float4 x = g4[k];
        g[4 * k] = x.x;
        g[4 * k + 1] = x.y;
        g[4 * k + 2] = x.z;
        g[4 * k + 3] = x.w;
      }
      float q[4];
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        float acc = __fmul_rn(f[0], g[10 * qq]);
#pragma unroll
        for (int k = 1; k < 10; ++k) acc = __fmaf_rn(f[k], g[10 * qq + k], acc);
        q[qq] = acc;
      }
      const float den = fabsf(q[0]) < kDetEps ? kDetEps : q[0];
      const float inv = __fdiv_rn(1.0f, den);
      const float u = __fmul_rn(q[1], inv);
      const float v = __fmul_rn(q[2], inv);
      const float t = __fmul_rn(q[3], inv);
      const bool hit = s_valid[j] != 0 && u >= 0.0f && v >= 0.0f &&
                       __fadd_rn(u, v) <= 1.0f && t > kTMin;
      if (hit && t < best_t) {
        best_t = t;
        best_u = u;
        best_v = v;
        best_i = base + j;
      }
    }
  }
  if (live) {
    out_t[ray] = best_t;
    out_idx[ray] = best_i;
    out_u[ray] = best_u;
    out_v[ray] = best_v;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream`, does not
// synchronise, and returns the cudaError_t of the launch (0 on success).
extern "C" int mt_intersect(const float* orig, const float* dir, int num_rays,
                            const float* feat10, const unsigned char* valid, int num_tris,
                            int tri_chunk, float* out_t, int* out_idx, float* out_u,
                            float* out_v, void* stream) {
  if (num_rays <= 0) return 0;
  const int blocks = (num_rays + kThreads - 1) / kThreads;
  mt_intersect_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      orig, dir, num_rays, feat10, valid, num_tris, tri_chunk, out_t, out_idx, out_u, out_v);
  return static_cast<int>(cudaGetLastError());
}
