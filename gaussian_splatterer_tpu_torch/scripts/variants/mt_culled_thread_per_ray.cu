// The first design of csrc/mt_culled.cu (K9), kept whole as a design
// variant: one thread a ray marching its own chunks, every visited chunk's
// triangles streamed from tri12 by that thread.  Its C entry point takes
// the arguments of the first wrapper (no group boxes, no scratch), so
// scripts/redesign_variants.py (--only k9) and chip_smoke.py's phase 20
// call it through redesign_variants.first_design_intersect, beside the
// shipped chunk-binned kernel, on the same rays.  Not built by the package.
//
// Culled first-hit intersector of the path tracer (Morton-chunk AABB march),
// for Hopper (sm_90a).
//
// Replaces gaussian_splatterer_tpu/rt/tracer.py::_intersect_culled, which the
// JAX package's _intersect takes for every bounce on a mesh of accel_min
// triangles or more.  It is plain JAX, not a Pallas kernel: every ray
// slab-tests all chunk AABBs at once ((R, NC) planes), sorts its chunks by
// entry distance, and the batch marches the sorted lists in lockstep with
// one (10, R x Tc) gather a step, until no ray's next entry comes before its
// best hit.  Its plain twin here is rt/tracer.py::intersect_culled_reference.
//
// Contract, per ray (o, d), over the scene's NC Morton chunks of Tc
// triangles (rt/tracer.py::scene_tables: per-chunk AABBs bb_min*/bb_max*;
// tri12 (NC Tc, 12) = [a, e1, e2, valid, 0, 0] triangle by triangle, the
// values of the JAX package's geo10 table, which the plain twin reads):
//   inv = 1 / (|d| < 1e-12 ? +1e-12 : d) per axis; per chunk the slabs
//   t0 = (min - o) inv, t1 = (max - o) inv, entry = max(min(t0, t1) over the
//   axes, 1e-3), exit = min(max(t0, t1) over the axes); its key is the entry
//   where entry <= exit, else inf;
//   the chunks are visited in ascending (key, chunk id), a chunk only while
//   its key is below the ray's best t;
//   in a chunk, the Möller-Trumbore of the JAX package's _mt_hit on every
//   triangle: p = d x e2, det = e1 . p, inv = 1 / (|det| < 1e-12 ? +1e-12 :
//   det), w = o - a, u = (w . p) inv, q = w x e1, v = (d . q) inv,
//   t = (e2 . q) inv; hit: valid, u >= 0, v >= 0, u + v <= 1, t > 1e-3;
//   a hit replaces the best only when strictly closer (so the first minimum
//   in a chunk, and across chunks the chunk visited first, win ties);
//   a miss returns t = inf, idx = 0, u = v = 0.
// Every product, sum and difference is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn: no contraction into FMAs), in the plain twin's
// order, and the reciprocals are correctly rounded, so the keys, the order
// of visits and the hits equal the plain twin's.
//
// What bounds it: operations.  A visited (ray, triangle) pair costs about
// 60 FP32 operations (the cross and dot products, the reciprocal, the tests)
// and the data is small: 40 B a triangle (48 B with the padding: 50 MB at
// a million triangles, about the L2's size), the AABBs 24 B a chunk.  The
// work depends on the data: a ray that misses every box tests no triangle;
// a ray that hits the mesh tests the chunks whose boxes it enters before
// its hit.
//
// The design, simple and right first:
//   * one thread a ray, the rays of a block contiguous (a camera's
//     neighbouring rays march the same chunks, so a warp's loads of a
//     triangle are one broadcast); blocks persistent over ray tiles.  A
//     small launch (a few thousand rays) is bound by the latency of one
//     ray's march (below); its blocks are made smaller, down to a warp, to
//     spread it over the SMs (2.92 against 3.38 ms at 2^10 rays);
//   * the AABBs, 24 B a chunk, staged in shared memory once a block when
//     they fit (2,044 chunks = 49 KB at a million triangles; the opt-in
//     limit is about 9,600 chunks), else read from global memory;
//   * no sorted list: each step scans the NC keys again and takes the
//     smallest (key, chunk id) above the last chunk visited and below the
//     best t, which is the sorted order, ties to the lower chunk id as a
//     stable sort gives them, and stops when there is none;
//   * a visited chunk's Tc triangles read from tri12, a triangle as three
//     16-byte loads, the loop unrolled 4 times.  The first form read
//     geo10's ten component rows: a warp of bounce rays, whose lanes march
//     different chunks, then touched 320 sectors a triangle and kept 40 KB
//     of lines live, which the L1 could not hold.  On the mesh-res 256
//     mushroom, 2^20 bounce rays took 292 ms that way and take 63.5 ms
//     this way, 2^10 6.48 and 2.92 ms (scripts/redesign_variants.py --only
//     k9; NVIDIA H100 80GB HBM3, 700 W).
// A ray's march is one thread's chain of dependent work, so a launch of a
// few thousand rays takes about 3 ms whatever its size: the latency of
// its longest march (22 chunks of 512 triangles at 2^10 bounce rays).
// Finer leaves, a hierarchy over the chunks (which would cut the key scans,
// NC a step) and a warp a ray are later levers.

#include <cuda_runtime.h>

#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // the most threads a block; small launches take fewer
constexpr float kTMin = 1e-3f;
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float guarded_rcp(float x) {
  return __frcp_rn(fabsf(x) < kEps ? kEps : x);  // the value of __fdiv_rn(1.0f, x)
}

// a . b over three components, as ((a0 b0 + a1 b1) + a2 b2)
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

// a x - b y, each product rounded
__device__ __forceinline__ float diff2(float a, float x, float b, float y) {
  return __fsub_rn(__fmul_rn(a, x), __fmul_rn(b, y));
}

__global__ void __launch_bounds__(kThreads) mt_culled_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir, int num_rays,
    const float4* __restrict__ tri12, int num_chunks, int tri_chunk,
    const float* __restrict__ bb0, const float* __restrict__ bb1, const float* __restrict__ bb2,
    const float* __restrict__ bb3, const float* __restrict__ bb4, const float* __restrict__ bb5,
    int stage_boxes, float* __restrict__ out_t, int* __restrict__ out_idx,
    float* __restrict__ out_u, float* __restrict__ out_v) {
  extern __shared__ float s_bb[];  // 6 x num_chunks when stage_boxes
  const float* bb[6] = {bb0, bb1, bb2, bb3, bb4, bb5};
  if (stage_boxes) {
    for (int k = 0; k < 6; ++k) {
      for (int c = threadIdx.x; c < num_chunks; c += blockDim.x) {
        s_bb[k * num_chunks + c] = bb[k][c];
      }
    }
    __syncthreads();
    for (int k = 0; k < 6; ++k) bb[k] = s_bb + k * num_chunks;
  }
  // no barrier below: a thread whose ray is past the end leaves at once
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long ray = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       ray < num_rays; ray += stride) {
    const float ox = orig[3 * ray], oy = orig[3 * ray + 1], oz = orig[3 * ray + 2];
    const float dx = dir[3 * ray], dy = dir[3 * ray + 1], dz = dir[3 * ray + 2];
    const float ix = guarded_rcp(dx), iy = guarded_rcp(dy), iz = guarded_rcp(dz);
    float best_t = CUDART_INF_F, best_u = 0.0f, best_v = 0.0f;
    int best_i = 0;
    float last_k = -CUDART_INF_F;
    int last_c = -1;
    for (;;) {
      // the next chunk: the smallest (key, id) above (last_k, last_c), key < best_t
      float cand_k = best_t;
      int cand_c = -1;
      for (int c = 0; c < num_chunks; ++c) {
        const float x0 = __fmul_rn(__fsub_rn(bb[0][c], ox), ix);
        const float x1 = __fmul_rn(__fsub_rn(bb[3][c], ox), ix);
        const float y0 = __fmul_rn(__fsub_rn(bb[1][c], oy), iy);
        const float y1 = __fmul_rn(__fsub_rn(bb[4][c], oy), iy);
        const float z0 = __fmul_rn(__fsub_rn(bb[2][c], oz), iz);
        const float z1 = __fmul_rn(__fsub_rn(bb[5][c], oz), iz);
        const float enter = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)),
                                  fmaxf(fminf(z0, z1), kTMin));
        const float exit = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
        const float key = enter <= exit ? enter : CUDART_INF_F;
        const bool above = key > last_k || (key == last_k && c > last_c);
        if (above && key < cand_k) {
          cand_k = key;
          cand_c = c;
        }
      }
      if (cand_c < 0) break;
      last_k = cand_k;
      last_c = cand_c;
      const int first = cand_c * tri_chunk;
#pragma unroll 4
      for (int j = 0; j < tri_chunk; ++j) {
        const int i = first + j;
        const float4 g0 = __ldg(tri12 + 3 * i), g1 = __ldg(tri12 + 3 * i + 1),
                     g2 = __ldg(tri12 + 3 * i + 2);
        const float ax = g0.x, ay = g0.y, az = g0.z, e1x = g0.w;
        const float e1y = g1.x, e1z = g1.y, e2x = g1.z, e2y = g1.w;
        const float e2z = g2.x;
        const bool valid = g2.y > 0.5f;
        const float px = diff2(dy, e2z, dz, e2y);
        const float py = diff2(dz, e2x, dx, e2z);
        const float pz = diff2(dx, e2y, dy, e2x);
        const float inv = guarded_rcp(dot3(e1x, e1y, e1z, px, py, pz));
        const float tx = __fsub_rn(ox, ax), ty = __fsub_rn(oy, ay), tz = __fsub_rn(oz, az);
        const float u = __fmul_rn(dot3(tx, ty, tz, px, py, pz), inv);
        const float qx = diff2(ty, e1z, tz, e1y);
        const float qy = diff2(tz, e1x, tx, e1z);
        const float qz = diff2(tx, e1y, ty, e1x);
        const float v = __fmul_rn(dot3(dx, dy, dz, qx, qy, qz), inv);
        const float t = __fmul_rn(dot3(e2x, e2y, e2z, qx, qy, qz), inv);
        const bool hit = valid && u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f && t > kTMin;
        if (hit && t < best_t) {
          best_t = t;
          best_u = u;
          best_v = v;
          best_i = i;
        }
      }
    }
    out_t[ray] = best_t;
    out_idx[ray] = best_i;
    out_u[ray] = best_u;
    out_v[ray] = best_v;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  orig, dir (R, 3) float32; tri12
// (num_chunks x tri_chunk, 12) float32, 16-byte aligned; the six AABB arrays (num_chunks,)
// float32 in the order min x, y, z, max x, y, z; out_* (R,).  Launches on
// `stream`, does not synchronise, and returns the cudaError_t of the
// shared-memory request or of the launch (0 on success).
extern "C" int mt_culled(const float* orig, const float* dir, int num_rays, const float* tri12,
                         int num_chunks, int tri_chunk, const float* bb_min_x,
                         const float* bb_min_y, const float* bb_min_z, const float* bb_max_x,
                         const float* bb_max_y, const float* bb_max_z, float* out_t,
                         int* out_idx, float* out_u, float* out_v, void* stream) {
  if (num_rays <= 0) return 0;
  if (num_chunks <= 0 || tri_chunk <= 0 || 12LL * num_chunks * tri_chunk >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(tri12) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t box_bytes = static_cast<size_t>(num_chunks) * 6 * sizeof(float);
  const int stage = box_bytes <= static_cast<size_t>(max_smem);
  const size_t smem = stage ? box_bytes : 0;
  err = cudaFuncSetAttribute(mt_culled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mt_culled_kernel, kThreads,
                                                        smem);
  }
  if (err == cudaSuccess && per_sm == 0) err = cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused request must not fail a later launch
    return static_cast<int>(err);
  }
  // threads a block: enough blocks for every SM, from a warp up to kThreads
  const long long per = (static_cast<long long>(num_rays) + sms - 1) / sms;
  const int threads = per >= kThreads ? kThreads : static_cast<int>((per + 31) / 32 * 32);
  const long long tiles = (static_cast<long long>(num_rays) + threads - 1) / threads;
  const long long slots = static_cast<long long>(sms) * per_sm * (kThreads / threads);
  const unsigned grid = static_cast<unsigned>(tiles < slots ? tiles : slots);
  mt_culled_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      orig, dir, num_rays, reinterpret_cast<const float4*>(tri12), num_chunks, tri_chunk,
      bb_min_x, bb_min_y, bb_min_z,
      bb_max_x, bb_max_y, bb_max_z, stage, out_t, out_idx, out_u, out_v);
  return static_cast<int>(cudaGetLastError());
}
