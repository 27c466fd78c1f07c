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
// 54 FP32 operations (about 67 instructions with the three shared-memory
// loads, the correctly rounded reciprocal and the tests) and the data is
// small: 48 B a triangle in tri12 (3.1 MB at 65,024 triangles, in the 50 MB
// L2), 24 B a chunk's box.  The first design (kept whole as
// scripts/variants/mt_culled_thread_per_ray.cu) ran one thread a ray, each thread
// streaming its visited chunks' triangles from tri12 and rescanning all NC
// boxes every step.  A warp of bounce rays marches 32 different chunks, so
// no load was shared: at 2^20 bounce rays on the mesh-res 256 mushroom it
// took 64.0 ms, 8.5e10 pairs/s, 4.1 TB/s of triangle reads from L1 and L2.
// The same rays sorted by their first chunk took 45.7 ms (chip_smoke.py
// phase 20; NVIDIA H100 80GB HBM3, 700 W): the coherence a sort gives the
// first steps fades, so the cure is to share each staged chunk among all
// the rays that visit it in a step, not to sort rays once.
//
// The design: a chunk-binned march, one cooperative launch of a persistent
// grid (as many blocks as can be resident; grid-wide barriers between the
// phases), over a scratch buffer of about 26 B a ray from the wrapper.
//   * init: each ray finds its first chunk with the key scan;
//   * a step: (1) one block turns the bins' counts into offsets (a counting
//     sort: a histogram over NC, its scan) and cuts the bins into slices of
//     256 rays, or of 128 down to 8 where that many would leave blocks idle;
//     (2) every ray that goes on is scattered into its chunk's bin; (3) a
//     block takes a slice, stages the chunk's triangles in shared memory
//     (24 KB at Tc = 512) and tests its rays against them, each triangle a
//     shared-memory broadcast to every ray of the slice; then each ray finds
//     its next chunk and counts itself into that bin (an atomic add whose
//     old value is its place in the bin).  The launch ends when no ray has a
//     next chunk.  A ray sits in one bin a step, so its best (t, idx, u, v),
//     kept in the outputs, and its last (key, chunk) need no lock.  Its
//     sequence of visits and updates is the first design's: only the
//     schedule changes, and the outputs are bit-equal.
//   * a slice of fewer than 256 rays (a small launch, a large mesh whose
//     bins are small, a launch's last steps) splits each ray's work over 2
//     to 32 threads, each testing every so many of the chunk's triangles and
//     scanning every so many groups, the parts folded by the lexicographic
//     minimum of (t, triangle) and of (key, chunk): the first minimum, as one
//     thread walking them in order finds it.  So a step's latency, which
//     sets a small launch's time, is a fraction of one chunk's test.
//   * the key scan in two levels: a group box over G consecutive chunks
//     (scene_tables' bg_*, the exact float32 min and max of its members) is
//     tested first, and its members only when its key is below the scan's
//     candidate and its exit is not below the last key.  The slab arithmetic
//     is monotone in the box's planes under round-to-nearest, so a group's
//     key is at most each member's, its exit at least each member's, and a
//     ray that misses a group misses its members: the skips drop no chunk
//     the flat scan would pick, and the visits stay the first design's.
//   * the boxes in shared memory when they fit beside the staged triangles
//     (the opt-in limit), else read from global memory.
// At 2^20 bounce rays it takes 19.5-20.9 ms (0.21-0.23 of the bound, near
// the instruction rate of its ~67 instructions a pair) against the first design's
// 64.0 ms; a 32-sample 1024^2 capture frame 0.72-0.90 s against 1.69-1.83 s
// at 65,024 triangles, 2.2-2.55 s against 4.7-4.8 s at 1,046,528
// (chip_smoke.py phase 20 and scripts/redesign_variants.py --only k9, the
// two designs in one call; NVIDIA H100 80GB HBM3, 700 W).  What remains at
// the large mesh is the small slices' fixed cost (a bin holds ~20 rays
// there, and a ray takes twice the steps) and the key scan (~260 box tests
// a step of a ray at G = 16).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math_constants.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // threads a block, and the most rays a slice of a bin
constexpr int kTile = 512;     // the most triangles staged at once (24 KB)
constexpr int kSizes = 6;      // slices of kThreads >> k rays, k < kSizes (256 down to 8)
constexpr int kMinSlots = 8;   // the fewest threads a part of a slice: at most 32 threads a ray
constexpr float kTMin = 1e-3f;
constexpr float kEps = 1e-12f;

struct Params {
  const float* orig;
  const float* dir;
  int num_rays;
  const float4* tri12;
  int num_chunks, tri_chunk, tile;
  const float* bb[6];  // chunk boxes, min x, y, z, max x, y, z
  const float* bg[6];  // group boxes, the same order
  int num_groups, group;
  int stage_boxes, stage_groups;
  float* out_t;
  int* out_idx;
  float* out_u;
  float* out_v;
  // scratch: per ray the last (key, chunk) visited, the next chunk, its place
  // in that chunk's bin, and the two bin lists; per chunk the bin's count and
  // the offset of its rays; the step's slices; the step's rays and slices
  float* last_k;
  int* last_c;
  int* next;
  int* slot;
  int* list_a;
  int* list_b;
  int* count;
  int* offset;
  int4* slices;  // per slice of a step: its chunk, its first place in the list, its rays
  int* header;
  // steps, bins, rays, slices summed over the steps, and the nanoseconds of
  // the init, offsets, scatter and test phases, each to the end of its
  // barrier (block 0's clock); may be null
  long long* stats;
};

constexpr int kStats = 8;

__device__ __forceinline__ long long now_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

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

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ Ray load_ray(const Params& p, int ray) {
  Ray r;
  r.ox = __ldg(p.orig + 3 * ray);
  r.oy = __ldg(p.orig + 3 * ray + 1);
  r.oz = __ldg(p.orig + 3 * ray + 2);
  r.dx = __ldg(p.dir + 3 * ray);
  r.dy = __ldg(p.dir + 3 * ray + 1);
  r.dz = __ldg(p.dir + 3 * ray + 2);
  r.ix = guarded_rcp(r.dx);
  r.iy = guarded_rcp(r.dy);
  r.iz = guarded_rcp(r.dz);
  return r;
}

// the entry key of box c of the six plane arrays b, and its exit distance
__device__ __forceinline__ float box_key(const float* const (&b)[6], int c, const Ray& r,
                                         float& exit) {
  const float x0 = __fmul_rn(__fsub_rn(b[0][c], r.ox), r.ix);
  const float x1 = __fmul_rn(__fsub_rn(b[3][c], r.ox), r.ix);
  const float y0 = __fmul_rn(__fsub_rn(b[1][c], r.oy), r.iy);
  const float y1 = __fmul_rn(__fsub_rn(b[4][c], r.oy), r.iy);
  const float z0 = __fmul_rn(__fsub_rn(b[2][c], r.oz), r.iz);
  const float z1 = __fmul_rn(__fsub_rn(b[5][c], r.oz), r.iz);
  const float enter = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fmaxf(fminf(z0, z1), kTMin));
  exit = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
  return enter <= exit ? enter : CUDART_INF_F;
}

// The next chunk over the groups g = part, part + parts, ...: the smallest
// (key, id) above (last_k, last_c) with key below the incoming cand_k (the
// best t), ties to the lower id.  A group whose key is not below the
// candidate holds no chunk that could replace it, and neither does one
// whose exit is below last_k: a member's key is at most its exit, which is
// at most the group's (the ray has passed the group).
__device__ __forceinline__ void scan_next(const float* const (&bb)[6],
                                          const float* const (&bg)[6], int num_chunks,
                                          int num_groups, int group, int part, int parts,
                                          const Ray& r, float last_k, int last_c,
                                          float& cand_k, int& cand_c) {
  for (int g = part; g < num_groups; g += parts) {
    float exit;
    if (!(box_key(bg, g, r, exit) < cand_k) || exit < last_k) continue;
    const int c1 = min(num_chunks, (g + 1) * group);
    for (int c = g * group; c < c1; ++c) {
      const float key = box_key(bb, c, r, exit);
      const bool above = key > last_k || (key == last_k && c > last_c);
      if (above && key < cand_k) {
        cand_k = key;
        cand_c = c;
      }
    }
  }
}

// (t, j) before (t2, j2) in the order that walks a chunk's triangles or
// chunks one at a time with a strict-less update keeps
__device__ __forceinline__ bool lex_less(float t, int j, float t2, int j2) {
  return t < t2 || (t == t2 && j < j2);
}

// a ray's first chunk, its place in that bin, and the miss as its best
__device__ void init_rays(const Params& p, const float* const (&bb)[6],
                          const float* const (&bg)[6]) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < p.num_rays; i += stride) {
    const int ray = static_cast<int>(i);
    const Ray r = load_ray(p, ray);
    float cand_k = CUDART_INF_F;
    int cand_c = -1;
    scan_next(bb, bg, p.num_chunks, p.num_groups, p.group, 0, 1, r, -CUDART_INF_F, -1, cand_k,
              cand_c);
    __stcg(p.out_t + ray, CUDART_INF_F);
    __stcg(p.out_idx + ray, 0);
    __stcg(p.out_u + ray, 0.0f);
    __stcg(p.out_v + ray, 0.0f);
    __stcg(p.next + ray, cand_c);
    if (cand_c >= 0) {
      __stcg(p.slot + ray, atomicAdd(p.count + cand_c, 1));
      __stcg(p.last_k + ray, cand_k);
      __stcg(p.last_c + ray, cand_c);
    }
  }
}

// exclusive sum over the block of one int a thread; the block's total in *total
__device__ __forceinline__ int block_exclusive_sum(int x, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kThreads / 32 ? s_warp[lane] : 0;
    int wi = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, off);
      if (lane >= off) wi += y;
    }
    if (lane < kThreads / 32) s_warp[lane] = wi - w;
    if (lane == kThreads / 32 - 1) *total = wi;
  }
  __syncthreads();
  const int out = s_warp[warp] + incl - x;
  __syncthreads();  // s_warp may be reused
  return out;
}

// One block: the bins' counts into the offsets of their rays, and the bins
// cut into slices of the largest size (256, 128, ..., 8 rays) that gives
// every block of the grid a slice, else of 8; the step's totals into the
// header, the counts back to zero for the next step.
__device__ void scan_bins(const Params& p, int* s_warp, int* s_tot, int* s_red) {
  const int nc = p.num_chunks;
  const int per = (nc + kThreads - 1) / kThreads;
  const int c0 = min(nc, static_cast<int>(threadIdx.x) * per), c1 = min(nc, c0 + per);
  if (threadIdx.x <= kSizes) s_red[threadIdx.x] = 0;
  __syncthreads();
  int rays = 0, bins = 0, items[kSizes] = {};
  for (int c = c0; c < c1; ++c) {
    const int n = __ldcg(p.count + c);
    rays += n;
    bins += n > 0;
#pragma unroll
    for (int k = 0; k < kSizes; ++k) items[k] += (n + (kThreads >> k) - 1) / (kThreads >> k);
  }
#pragma unroll
  for (int k = 0; k < kSizes; ++k) {
    if (items[k] != 0) atomicAdd(s_red + k, items[k]);
  }
  if (bins != 0) atomicAdd(s_red + kSizes, bins);
  int run_r = block_exclusive_sum(rays, s_warp, s_tot);  // its barriers complete s_red
  const int total_r = s_tot[0];
  int size = kThreads >> (kSizes - 1);
  for (int k = 0; k < kSizes; ++k) {
    if (s_red[k] >= static_cast<int>(gridDim.x)) {
      size = kThreads >> k;
      break;
    }
  }
  int mine = 0;
  for (int c = c0; c < c1; ++c) mine += (__ldcg(p.count + c) + size - 1) / size;
  int run_i = block_exclusive_sum(mine, s_warp, s_tot);
  const int total_i = s_tot[0];
  for (int c = c0; c < c1; ++c) {
    const int n = __ldcg(p.count + c);
    __stcg(p.offset + c, run_r);
    for (int k = 0; k * size < n; ++k) {
      __stcg(p.slices + run_i + k, make_int4(c, run_r + k * size, min(size, n - k * size), 0));
    }
    __stcg(p.count + c, 0);
    run_r += n;
    run_i += (n + size - 1) / size;
  }
  if (threadIdx.x == 0) {
    __stcg(p.header, total_r);
    __stcg(p.header + 1, total_i);
    if (p.stats != nullptr && total_r > 0) {
      p.stats[0] += 1;
      p.stats[1] += s_red[kSizes];
      p.stats[2] += total_r;
      p.stats[3] += total_i;
    }
  }
  __syncthreads();  // s_red is read before the next step clears it
}

// The ray's first minimum, below acc_t, over the triangles part, part +
// parts, ... of the tile of tl triangles at chunk offset t0 in s_tri.
__device__ __forceinline__ void test_tile(const float4* s_tri, int t0, int tl, int part,
                                          int parts, const Ray& r, float& acc_t, float& acc_u,
                                          float& acc_v, int& acc_j) {
#pragma unroll 4
  for (int j = part; j < tl; j += parts) {
    const float4 g0 = s_tri[3 * j], g1 = s_tri[3 * j + 1], g2 = s_tri[3 * j + 2];
    const float ax = g0.x, ay = g0.y, az = g0.z, e1x = g0.w;
    const float e1y = g1.x, e1z = g1.y, e2x = g1.z, e2y = g1.w;
    const float e2z = g2.x;
    const bool valid = g2.y > 0.5f;
    const float px = diff2(r.dy, e2z, r.dz, e2y);
    const float py = diff2(r.dz, e2x, r.dx, e2z);
    const float pz = diff2(r.dx, e2y, r.dy, e2x);
    const float inv = guarded_rcp(dot3(e1x, e1y, e1z, px, py, pz));
    const float tx = __fsub_rn(r.ox, ax), ty = __fsub_rn(r.oy, ay), tz = __fsub_rn(r.oz, az);
    const float u = __fmul_rn(dot3(tx, ty, tz, px, py, pz), inv);
    const float qx = diff2(ty, e1z, tz, e1y);
    const float qy = diff2(tz, e1x, tx, e1z);
    const float qz = diff2(tx, e1y, ty, e1x);
    const float v = __fmul_rn(dot3(r.dx, r.dy, r.dz, qx, qy, qz), inv);
    const float t = __fmul_rn(dot3(e2x, e2y, e2z, qx, qy, qz), inv);
    const bool hit = valid && u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f && t > kTMin;
    if (hit && t < acc_t) {
      acc_t = t;
      acc_u = u;
      acc_v = v;
      acc_j = t0 + j;
    }
  }
}

// One slice of a bin: its chunk's triangles staged tile by tile and tested
// against its rays, then each ray's next chunk.  A slice of n rays gives
// each ray parts = kThreads / slots threads, slots = max(n, kMinSlots):
// part q tests the triangles q, q + parts, ... of each tile (neighbouring
// triangles, so the parts in a warp read other banks) and scans the groups
// q, q + parts, ...
__device__ void test_slice(const Params& p, const float* const (&bb)[6],
                           const float* const (&bg)[6], const int* list, int chunk, int first,
                           int n, float4* s_tri, float* s_ft, int* s_fi, float* s_fu,
                           float* s_fv) {
  const int slots = max(n, kMinSlots), parts = kThreads / slots;
  const int part = threadIdx.x / slots, lane = threadIdx.x - part * slots;
  const bool active = lane < n && part < parts;
  const int ray = active ? __ldcg(list + first + lane) : 0;
  Ray r = {};
  float best_t = CUDART_INF_F;
  if (active) {
    r = load_ray(p, ray);
    best_t = __ldcg(p.out_t + ray);
  }
  // this thread's first minimum over its triangles, below the incoming best
  float acc_t = best_t, acc_u = 0.0f, acc_v = 0.0f;
  int acc_j = -1;
  const int tc = p.tri_chunk;
  const float4* src = p.tri12 + 3LL * chunk * tc;
  for (int t0 = 0; t0 < tc; t0 += p.tile) {
    const int tl = min(p.tile, tc - t0);
    __syncthreads();  // the last tile's readers are done
    for (int q = threadIdx.x; q < 3 * tl; q += kThreads) s_tri[q] = __ldg(src + 3 * t0 + q);
    __syncthreads();
    if (active) test_tile(s_tri, t0, tl, part, parts, r, acc_t, acc_u, acc_v, acc_j);
  }
  if (parts > 1) {  // fold the parts in order: every thread of a ray gets the same
    s_ft[threadIdx.x] = acc_t;
    s_fi[threadIdx.x] = acc_j;
    s_fu[threadIdx.x] = acc_u;
    s_fv[threadIdx.x] = acc_v;
    __syncthreads();
    if (active) {
      for (int q = 0; q < parts; ++q) {
        const int k = q * slots + lane;
        const float t = s_ft[k];
        const int j = s_fi[k];
        if (lex_less(t, j, acc_t, acc_j)) {
          acc_t = t;
          acc_j = j;
          acc_u = s_fu[k];
          acc_v = s_fv[k];
        }
      }
    }
    __syncthreads();
  }
  float cand_k = acc_t;
  int cand_c = -1;
  if (active) {
    scan_next(bb, bg, p.num_chunks, p.num_groups, p.group, part, parts, r,
              __ldcg(p.last_k + ray), __ldcg(p.last_c + ray), cand_k, cand_c);
  }
  if (parts > 1) {
    s_ft[threadIdx.x] = cand_k;
    s_fi[threadIdx.x] = cand_c;
    __syncthreads();
    if (active && part == 0) {
      for (int q = 1; q < parts; ++q) {
        const int k = q * slots + lane;
        if (lex_less(s_ft[k], s_fi[k], cand_k, cand_c)) {
          cand_k = s_ft[k];
          cand_c = s_fi[k];
        }
      }
    }
  }
  if (active && part == 0) {
    if (acc_j >= 0) {
      __stcg(p.out_t + ray, acc_t);
      __stcg(p.out_idx + ray, chunk * tc + acc_j);
      __stcg(p.out_u + ray, acc_u);
      __stcg(p.out_v + ray, acc_v);
    }
    __stcg(p.next + ray, cand_c);
    if (cand_c >= 0) {
      __stcg(p.slot + ray, atomicAdd(p.count + cand_c, 1));
      __stcg(p.last_k + ray, cand_k);
      __stcg(p.last_c + ray, cand_c);
    }
  }
}

// At least 3 blocks an SM, so at most 85 registers: left to itself ptxas
// allots 80 with spills or ~120 (2 blocks an SM) as the code around moves;
// the bound keeps 80 without spills, faster than the unbounded build at
// every launch size timed (redesign_variants, "no register bound").  Where
// the boxes take the shared memory (2,044 chunks), 2 blocks fit and the
// occupancy query sizes the grid so.
__global__ void __launch_bounds__(kThreads, 3) mt_culled_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 s_dyn[];
  __shared__ float s_ft[kThreads], s_fu[kThreads], s_fv[kThreads];
  __shared__ int s_fi[kThreads];
  __shared__ int s_warp[kThreads / 32], s_tot[1], s_red[kSizes + 1];
  float4* s_tri = s_dyn;
  float* s_box = reinterpret_cast<float*>(s_tri + 3 * p.tile);
  const float* bg[6] = {p.bg[0], p.bg[1], p.bg[2], p.bg[3], p.bg[4], p.bg[5]};
  const float* bb[6] = {p.bb[0], p.bb[1], p.bb[2], p.bb[3], p.bb[4], p.bb[5]};
  if (p.stage_groups) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      for (int g = threadIdx.x; g < p.num_groups; g += blockDim.x) {
        s_box[k * p.num_groups + g] = __ldg(p.bg[k] + g);
      }
      bg[k] = s_box + k * p.num_groups;
    }
    s_box += 6 * p.num_groups;
  }
  if (p.stage_boxes) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      for (int c = threadIdx.x; c < p.num_chunks; c += blockDim.x) {
        s_box[k * p.num_chunks + c] = __ldg(p.bb[k] + c);
      }
      bb[k] = s_box + k * p.num_chunks;
    }
  }
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < p.num_chunks;
       c += gridDim.x * blockDim.x) {
    p.count[c] = 0;
  }
  const bool timer = blockIdx.x == 0 && threadIdx.x == 0 && p.stats != nullptr;
  if (timer) {
    for (int k = 0; k < kStats; ++k) p.stats[k] = 0;
  }
  __syncthreads();  // the staged boxes
  grid.sync();      // the counts
  long long t0 = timer ? now_ns() : 0;
  // the nanoseconds since the last mark into stats[k]
  auto mark = [&](int k) {
    if (timer) {
      const long long t = now_ns();
      p.stats[k] += t - t0;
      t0 = t;
    }
  };
  init_rays(p, bb, bg);
  grid.sync();
  mark(4);
  const int* list_in = nullptr;  // step 0 scatters every ray, in index order
  int* list_out = p.list_a;
  int n_in = p.num_rays;
  for (;;) {
    if (blockIdx.x == 0) scan_bins(p, s_warp, s_tot, s_red);
    grid.sync();
    mark(5);
    const int rays = __ldcg(p.header), items = __ldcg(p.header + 1);
    if (rays == 0) break;
    // the rays of the last step that go on, into the bins of their next chunks
    const int stride = gridDim.x * blockDim.x;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_in; i += stride) {
      const int ray = list_in != nullptr ? __ldcg(list_in + i) : i;
      const int c = __ldcg(p.next + ray);
      if (c >= 0) __stcg(list_out + __ldcg(p.offset + c) + __ldcg(p.slot + ray), ray);
    }
    grid.sync();
    mark(6);
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int4 slice = __ldcg(p.slices + it);
      test_slice(p, bb, bg, list_out, slice.x, slice.y, slice.z, s_tri, s_ft, s_fi, s_fu, s_fv);
    }
    grid.sync();
    mark(7);
    list_in = list_out;
    list_out = list_out == p.list_a ? p.list_b : p.list_a;
    n_in = rays;
  }
}

}  // namespace

// Words of the int32 scratch buffer a launch over num_rays rays and
// num_chunks chunks needs.
extern "C" long long mt_culled_scratch_words(int num_rays, int num_chunks) {
  // a step's slices hold 8 rays or more, or a whole bin: fewer than R / 8 + NC
  return 4 * (num_rays / 8LL + num_chunks) + 6LL * num_rays + 2LL * num_chunks + 4;
}

// Plain C entry point (loaded with ctypes).  orig, dir (R, 3) float32; tri12
// (num_chunks x tri_chunk, 12) float32, 16-byte aligned; the six chunk box
// arrays (num_chunks,) and the six group box arrays (num_groups,) float32 in
// the order min x, y, z, max x, y, z, group g the boxes of chunks
// [g group, (g + 1) group); scratch mt_culled_scratch_words int32; stats
// eight int64 (Params::stats) or null;
// scratch 16-byte aligned; out_* (R,).  Launches as many blocks as can be
// resident on `stream`, does not synchronise, and returns the cudaError_t of
// the shared-memory request or of the launch (0 on success).
extern "C" int mt_culled(const float* orig, const float* dir, int num_rays, const float* tri12,
                         int num_chunks, int tri_chunk, const float* bb_min_x,
                         const float* bb_min_y, const float* bb_min_z, const float* bb_max_x,
                         const float* bb_max_y, const float* bb_max_z, const float* bg_min_x,
                         const float* bg_min_y, const float* bg_min_z, const float* bg_max_x,
                         const float* bg_max_y, const float* bg_max_z, int num_groups,
                         int group, int* scratch, long long* stats,
                         float* out_t, int* out_idx, float* out_u, float* out_v, void* stream) {
  if (num_rays <= 0) return 0;
  if (num_chunks <= 0 || tri_chunk <= 0 || group <= 0 ||
      num_groups != (num_chunks + group - 1) / group ||
      12LL * num_chunks * tri_chunk >= (1LL << 31) || 6LL * num_rays >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(tri12) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0, max_smem = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  }
  cudaFuncAttributes attr{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, mt_culled_kernel);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  const int tile = tri_chunk < kTile ? tri_chunk : kTile;
  const size_t room = static_cast<size_t>(max_smem) - attr.sharedSizeBytes;
  size_t smem = static_cast<size_t>(tile) * 3 * sizeof(float4);
  const size_t group_bytes = static_cast<size_t>(num_groups) * 6 * sizeof(float);
  const size_t box_bytes = static_cast<size_t>(num_chunks) * 6 * sizeof(float);
  const int stage_groups = smem + group_bytes <= room;
  if (stage_groups) smem += group_bytes;
  const int stage_boxes = stage_groups && smem + box_bytes <= room;
  if (stage_boxes) smem += box_bytes;
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
  Params p{};
  p.orig = orig;
  p.dir = dir;
  p.num_rays = num_rays;
  p.tri12 = reinterpret_cast<const float4*>(tri12);
  p.num_chunks = num_chunks;
  p.tri_chunk = tri_chunk;
  p.tile = tile;
  const float* bbs[6] = {bb_min_x, bb_min_y, bb_min_z, bb_max_x, bb_max_y, bb_max_z};
  const float* bgs[6] = {bg_min_x, bg_min_y, bg_min_z, bg_max_x, bg_max_y, bg_max_z};
  for (int k = 0; k < 6; ++k) {
    p.bb[k] = bbs[k];
    p.bg[k] = bgs[k];
  }
  p.num_groups = num_groups;
  p.group = group;
  p.stage_boxes = stage_boxes;
  p.stage_groups = stage_groups;
  p.out_t = out_t;
  p.out_idx = out_idx;
  p.out_u = out_u;
  p.out_v = out_v;
  const long long r = num_rays;
  p.slices = reinterpret_cast<int4*>(scratch);  // first: 16-byte aligned as the buffer
  int* rest = scratch + 4 * (r / 8 + num_chunks);
  p.last_k = reinterpret_cast<float*>(rest);
  p.last_c = rest + r;
  p.next = rest + 2 * r;
  p.slot = rest + 3 * r;
  p.list_a = rest + 4 * r;
  p.list_b = rest + 5 * r;
  p.count = rest + 6 * r;
  p.offset = p.count + num_chunks;
  p.header = p.offset + num_chunks;
  p.stats = stats;
  const int grid = per_sm * sms;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)mt_culled_kernel, dim3(grid),
                                    dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
