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
//   hit: u >= 0, v >= 0, u + v <= 1, t > 1e-3;
//   the nearest hit, ties to the lowest triangle index;
//   a miss returns t = inf, idx = 0, u = v = 0.
//
// Input: the scene's "tri40" table (rt/tracer.py::scene_tables), the real
// triangles only (no padding), in index order, 40 floats each: the ten
// feature weights of det, u_num, v_num and t_num; and tri_ids, each row's
// triangle index.  Each pair runs the arithmetic of the first port of this
// kernel operation for operation (the ray features rounded product by
// product, four FMA chains of length 10 in feature order, 1 / den correctly
// rounded, u, v and t as single products), so the hits equal its hits.
//
// What bounds it: instruction issue.  Per (ray, triangle) pair the four
// chains are 40 FP32 multiply-adds, and every other instruction a pair
// issues takes an issue slot from them.  The first port spent about 88
// instructions a pair in its loop (its SASS): ten 16-byte shared-memory
// loads (one triangle for one ray), a correctly rounded division, three
// products, five comparisons and the running minimum, for every pair.  What
// this design does:
//   * register blocking over rays: a thread holds kRT = 4 rays (2 and 8
//     were slower on the H100) and every triangle it reads from shared
//     memory serves kRT pairs: 10 / kRT loads a pair, and the loop's own
//     instructions are shared by kRT pairs;
//   * a conservative reject before the reciprocal (below): when no lane of
//     a warp can survive it, the warp skips the division, the products and
//     the selects; a warp with a survivor runs the unchanged epilogue.  The
//     vote keeps the branch from diverging.  It pays on coherent rays (a
//     camera's, where neighbouring lanes miss the same triangles); on
//     scattered bounce rays the vote rarely passes and the wrapper's caller
//     turns it off (rt/tracer.py).  Tests of t against 1e-3 and the ray's
//     best hit were tried in the reject too, and cost more than they saved;
//   * only real triangles: no padding is walked and no valid byte is read;
//   * the table staged in shared memory by the copy engine (cp.async.bulk on
//     an mbarrier).  When a block's triangles fit (the mushroom's 960 x 160 B
//     = 150 KiB do), they are loaded once and the block is persistent over
//     ray tiles; a larger slice goes through a ring of two tiles of
//     kRingTris triangles, the next tile landing while the block computes
//     on this one, so any mesh runs;
//   * a split over triangles for small launches (a compacted bounce of a few
//     thousand rays fills only a few blocks): the triangles are cut into S
//     contiguous slices over blockIdx.y, each slice writes its first minimum
//     (t, idx, u, v) to scratch, and merge_slices_kernel folds the slices in
//     slice order with a strict <.  A slice's first minimum is the
//     sequential first minimum over its triangles, and folding them in order
//     with a strict < keeps the lowest index of equal t: exactly the
//     sequential first minimum over all triangles, whatever S;
//   * FP32 FMAs only: no TF32 and no tensor cores, since t_num cancels for
//     bounce origins on the mesh.  A 3xTF32 wgmma product and skipping
//     triangle chunks by their AABB are later levers.
//
// The reject, and why it never changes a result.  den is the clamped value
// (|det| < 1e-12 -> +1e-12), so |den| >= 1e-12 and inv = rn(1 / den) has
// den's sign and |inv| within 2^-22 of 1 / |den| (also where 1 / |den| is
// subnormal, since |den| < 2^128).  Write q' = q x sign(den) (a sign-bit
// flip, exact) and m = |den| 2^-60 (exact: a normal number).  A lane may
// skip when u_num' <= -m or v_num' <= -m.  Then u_num and den have strictly
// opposite signs and |u_num inv| >= 2^-60 (1 - 2^-22), far above the 2^-150
// under which the product would round to -0.0 and pass u >= 0; so u < 0 (or
// v < 0) and the epilogue refuses the pair.  An infinite |den| makes m
// infinite, and only an infinite numerator can then skip, whose product with
// inv = 0 is a NaN the epilogue refuses; a NaN fails every test and goes to
// the epilogue.  The skip also enters the epilogue's hit test, so a lane
// that may skip never takes a hit even where its warp runs the epilogue.
// A result never depends on the reject.

#include <cuda_runtime.h>

#include <cstdint>

#include <math_constants.h>

namespace {

constexpr int kFeat = 40;                      // 4 quantities x 10 ray features a triangle
constexpr int kTriBytes = kFeat * 4;           // 160 bytes, a multiple of 16
constexpr int kRingTris = 256;                 // triangles a ring stage holds (40 KiB)
constexpr float kTMin = 1e-3f;
constexpr float kDetEps = 1e-12f;
constexpr float kSignMargin = 0x1p-60f;
constexpr int kMergeThreads = 256;
constexpr int kRT = 4;                         // rays a thread
constexpr int kThreads = 512;
constexpr int kRaysPerBlock = kThreads * kRT;  // rt/tracer.py's K5_RAYS_PER_BLOCK

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// thread 0: bring `bytes` from global memory into shared memory with the
// copy engine, completion counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  // shared memory that the block read before this copy overwrites it
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Wait for the copy counted on `bar` to land.  A copy that never lands
// traps after about 2^27 tries (seconds) instead of hanging the card: the
// launch then fails, and the next synchronisation reports the error.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 27)) __trap();
  }
}

// One block: kThreads threads x kRT rays = one ray tile at a time, over
// the ray tiles blockIdx.x, blockIdx.x + gridDim.x, ...; the triangles of
// slice blockIdx.y.  stages == 1: the slice is resident (one tile, loaded
// once); stages == 2: a ring of tile_tris-triangle tiles.
template <bool REJECT>
__global__ void __launch_bounds__(kThreads, 1) mt_intersect_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir, int num_rays,
    const float* __restrict__ tri40, const int* __restrict__ tri_ids, int num_tris,
    int slice_len, int tile_tris, int stages,
    float* __restrict__ out_t, int* __restrict__ out_idx, float* __restrict__ out_u,
    float* __restrict__ out_v) {
  extern __shared__ float4 s_tri[];  // stages x tile_tris x 10 float4
  __shared__ __align__(8) uint64_t s_bar[2];

  const int lo = blockIdx.y * slice_len;
  const int hi = min(num_tris, lo + slice_len);
  const int n_tiles = hi > lo ? (hi - lo + tile_tris - 1) / tile_tris : 0;
  const int ray_tiles = (num_rays + kRaysPerBlock - 1) / kRaysPerBlock;
  const int my_ray_tiles = (ray_tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;
  const long long total = static_cast<long long>(my_ray_tiles) * n_tiles;  // ring loads
  const bool resident = stages == 1;
  const long long slot = static_cast<long long>(blockIdx.y) * num_rays;
  out_t += slot;
  out_idx += slot;
  out_u += slot;
  out_v += slot;

  auto issue = [&](long long h) {  // tile h of the block's sequence into its stage
    const int k = static_cast<int>(h % n_tiles);
    const int first = lo + k * tile_tris;
    const int cnt = min(tile_tris, hi - first);
    const int stage = static_cast<int>(h % stages);
    bulk_load(s_tri + static_cast<long long>(stage) * tile_tris * (kFeat / 4),
              tri40 + static_cast<long long>(first) * kFeat,
              static_cast<uint32_t>(cnt) * kTriBytes, &s_bar[stage]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&s_bar[s]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_tiles > 0) {
    issue(0);
    if (!resident && total > 1) issue(1);
  }

  long long h = 0;  // the block's next tile in sequence
  for (int tile_r = blockIdx.x; tile_r < ray_tiles; tile_r += gridDim.x) {
    float f[kRT][9];  // the features but the last, which is 1
    bool live[kRT];
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      const int ray = tile_r * kRaysPerBlock + r * kThreads + threadIdx.x;
      live[r] = ray < num_rays;
      const int i = live[r] ? ray : 0;
      const float ox = orig[3 * i], oy = orig[3 * i + 1], oz = orig[3 * i + 2];
      const float dx = dir[3 * i], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
      f[r][0] = dx;
      f[r][1] = dy;
      f[r][2] = dz;
      f[r][3] = __fsub_rn(__fmul_rn(oy, dz), __fmul_rn(oz, dy));
      f[r][4] = __fsub_rn(__fmul_rn(oz, dx), __fmul_rn(ox, dz));
      f[r][5] = __fsub_rn(__fmul_rn(ox, dy), __fmul_rn(oy, dx));
      f[r][6] = ox;
      f[r][7] = oy;
      f[r][8] = oz;
    }
    float best_t[kRT], best_u[kRT], best_v[kRT];
    int best_row[kRT];
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      best_t[r] = CUDART_INF_F;
      best_u[r] = 0.0f;
      best_v[r] = 0.0f;
      best_row[r] = -1;
    }

    for (int k = 0; k < n_tiles; ++k, ++h) {
      const int stage = resident ? 0 : static_cast<int>(h & 1);
      mbar_wait(&s_bar[stage], resident ? 0u : static_cast<uint32_t>((h >> 1) & 1));
      const int base = lo + k * tile_tris;
      const int cnt = min(tile_tris, hi - base);
      const float4* tile = s_tri + static_cast<long long>(stage) * tile_tris * (kFeat / 4);
      for (int j = 0; j < cnt; ++j) {
        float g[kFeat];
        const float4* g4 = tile + j * (kFeat / 4);
#pragma unroll
        for (int c = 0; c < kFeat / 4; ++c) {
          const float4 x = g4[c];
          g[4 * c] = x.x;
          g[4 * c + 1] = x.y;
          g[4 * c + 2] = x.z;
          g[4 * c + 3] = x.w;
        }
#pragma unroll
        for (int r = 0; r < kRT; ++r) {
          float q[4];
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {
            float acc = __fmul_rn(f[r][0], g[10 * qq]);
#pragma unroll
            for (int c = 1; c < 9; ++c) acc = __fmaf_rn(f[r][c], g[10 * qq + c], acc);
            q[qq] = __fmaf_rn(1.0f, g[10 * qq + 9], acc);
          }
          const float den = fabsf(q[0]) < kDetEps ? kDetEps : q[0];
          // the reject: skip the epilogue when every lane of the warp may
          // (a warp-wide vote, so that the branch never diverges)
          bool skip = false;
          if (REJECT) {
            const float m = __fmul_rn(fabsf(den), kSignMargin);
            const uint32_t sgn = __float_as_uint(den) & 0x80000000u;
            skip = __uint_as_float(__float_as_uint(q[1]) ^ sgn) <= -m ||
                   __uint_as_float(__float_as_uint(q[2]) ^ sgn) <= -m;
            if (__all_sync(0xffffffffu, skip)) continue;
          }
          const float inv = __frcp_rn(den);  // the value of __fdiv_rn(1.0f, den)
          const float u = __fmul_rn(q[1], inv);
          const float v = __fmul_rn(q[2], inv);
          const float t = __fmul_rn(q[3], inv);
          const bool hit =
              !skip && u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f && t > kTMin;
          if (hit && t < best_t[r]) {
            best_t[r] = t;
            best_u[r] = u;
            best_v[r] = v;
            best_row[r] = base + j;
          }
        }
      }
      if (!resident) {
        __syncthreads();  // every thread is done with this stage
        if (threadIdx.x == 0 && h + 2 < total) issue(h + 2);
      }
    }
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      if (!live[r]) continue;
      const int ray = tile_r * kRaysPerBlock + r * kThreads + threadIdx.x;
      out_t[ray] = best_t[r];
      out_idx[ray] = best_row[r] >= 0 ? tri_ids[best_row[r]] : 0;
      out_u[ray] = best_u[r];
      out_v[ray] = best_v[r];
    }
  }
}

// The slices' first minima (S, R) folded in slice order with a strict <:
// the first minimum over all triangles.
__global__ void __launch_bounds__(kMergeThreads) merge_slices_kernel(
    const float* __restrict__ st, const int* __restrict__ si, const float* __restrict__ su,
    const float* __restrict__ sv, int slices, int num_rays, float* __restrict__ out_t,
    int* __restrict__ out_idx, float* __restrict__ out_u, float* __restrict__ out_v) {
  const int ray = blockIdx.x * kMergeThreads + threadIdx.x;
  if (ray >= num_rays) return;
  int best = ray;
  float bt = st[ray];
  for (int s = 1; s < slices; ++s) {
    const long long at = static_cast<long long>(s) * num_rays + ray;
    const float t = st[at];
    if (t < bt) {
      bt = t;
      best = static_cast<int>(at);
    }
  }
  out_t[ray] = bt;
  out_idx[ray] = si[best];
  out_u[ray] = su[best];
  out_v[ray] = sv[best];
}

template <bool REJECT>
int launch(const float* orig, const float* dir, int num_rays, const float* tri40,
           const int* tri_ids, int num_tris, int slices, int slice_len, float* out_t,
           int* out_idx, float* out_u, float* out_v, float* scr_t, int* scr_idx, float* scr_u,
           float* scr_v, cudaStream_t stream) {
  int device = 0, sms = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // the static mbarriers come out of the same shared memory
  const int fit = (max_smem - 64) / kTriBytes;
  int tile, stages;
  if (slice_len <= fit) {
    tile = slice_len > 0 ? slice_len : 1;
    stages = 1;
  } else {
    tile = kRingTris;
    stages = 2;
  }
  const size_t smem = static_cast<size_t>(stages) * tile * kTriBytes;
  auto kernel = mt_intersect_kernel<REJECT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  if (err == cudaSuccess && per_sm == 0) err = cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused request must not fail a later launch
    return static_cast<int>(err);
  }
  const long long ray_tiles = (static_cast<long long>(num_rays) + kRaysPerBlock - 1) /
                              kRaysPerBlock;
  const long long gx = ray_tiles < static_cast<long long>(sms) * per_sm
                           ? ray_tiles : static_cast<long long>(sms) * per_sm;
  const bool split = slices > 1;
  kernel<<<dim3(static_cast<unsigned>(gx), slices), kThreads, smem, stream>>>(
      orig, dir, num_rays, tri40, tri_ids, num_tris, slice_len, tile, stages,
      split ? scr_t : out_t, split ? scr_idx : out_idx, split ? scr_u : out_u,
      split ? scr_v : out_v);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return static_cast<int>(err);
  merge_slices_kernel<<<(num_rays + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0,
                        stream>>>(scr_t, scr_idx, scr_u, scr_v, slices, num_rays, out_t,
                                  out_idx, out_u, out_v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blocks of the kernel that the current device runs at once: its SMs
// (cudaDevAttrMultiProcessorCount) times the blocks an SM holds, which
// registers limit.  The wrapper chooses its slices by it; 0 on error.
extern "C" int mt_intersect_slots() {
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mt_intersect_kernel<true>,
                                                    kThreads, 0) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return sms * (per_sm > 0 ? per_sm : 1);
}

// Plain C entry point (loaded with ctypes).  orig, dir (R, 3) float32; tri40
// (T, 40) float32 and tri_ids (T,) int32; reject != 0 turns the reject on;
// slices S >= 1 of slice_len triangles each (the last may be shorter, none
// empty), each resident in shared memory when it fits and streamed through
// the ring when it does not.  With S > 1 the scratch arrays hold (S, R)
// each and a second kernel merges them into out_*.  Launches on `stream`,
// does not synchronise, and returns the cudaError_t of the shared-memory
// request or of a launch (0 on success).
extern "C" int mt_intersect(const float* orig, const float* dir, int num_rays,
                            const float* tri40, const int* tri_ids, int num_tris, int reject,
                            int slices, int slice_len, float* out_t, int* out_idx, float* out_u,
                            float* out_v, float* scr_t, int* scr_idx, float* scr_u,
                            float* scr_v, void* stream) {
  if (num_rays <= 0) return 0;
  if (slices < 1 || slices > 65535 || slice_len < 0 || num_tris < 0 ||
      static_cast<long long>(slices - 1) * slice_len >= (num_tris > 0 ? num_tris : 1) ||
      (slices > 1 && !(scr_t && scr_idx && scr_u && scr_v))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return reject ? launch<true>(orig, dir, num_rays, tri40, tri_ids, num_tris, slices, slice_len,
                               out_t, out_idx, out_u, out_v, scr_t, scr_idx, scr_u, scr_v, s)
                : launch<false>(orig, dir, num_rays, tri40, tri_ids, num_tris, slices,
                                slice_len, out_t, out_idx, out_u, out_v, scr_t, scr_idx, scr_u,
                                scr_v, s);
}
