// Per-frame inclusive scan of a (K, F, D) float32 array along D, for Hopper
// (sm_90a): the scan of the fused training step's cumsum reduction route.
//
// Replaces gaussian_splatterer_tpu/ops/raster_tiled.py::_cumsum_carry_kernel,
// the Pallas TPU kernel that cumsum_frames launches: one sequential grid over
// lane blocks of D, every (k, f) row scanned in a block with a log-shift scan
// and a (K, F) running carry in VMEM scratch.  Hopper has no sequential grid
// and no scratch that survives from one block to the next, and one block per
// row would fill only K * F = 72 of the 132 SMs at the fused step's 9 x 8.
//
// What bounds it: bytes.  One add an element; each element of x is read
// once and each of y written once, 2 * 4 * K * F * D bytes: 117 MB, about
// 0.035 ms at 3.35 TB/s, for the fused step's (9, 8, ~202,689) group.
//
// The design: one pass, one launch (after one memset of the scratch).
//   1. Ticketed chunks.  The K * F rows are cut into chunks of kChunk
//      elements.  A block takes a ticket t (one atomicAdd on the scratch's
//      counter) and scans chunk t / rows of row t % rows, so every
//      predecessor of a chunk in its row holds an earlier ticket: it is
//      resident or done, whatever order the hardware starts blocks in, and
//      no block waits on one that never started.  The rows move side by side.
//   2. The chunk is loaded once into shared memory: its 16-byte aligned body
//      by one cp.async.bulk copy completed on an mbarrier (kBulkLoad; else
//      coalesced float4 loads), a head and a tail of under 4 elements by
//      scalar loads.  A row starts at r * D floats, so when D % 4 != 0 (or
//      x's data_ptr is off the 16-byte grid) a chunk starts off the grid;
//      element i sits at buf[xm + i], xm the start's offset in floats, which
//      puts the aligned body on an aligned shared address.
//   3. Its total is summed in a fixed order (each lane down its column of
//      its warp's segment, an xor tree over the lanes, the warps in
//      sequence), in double (Acc), and published at once, before its prefix
//      is known: one 64-bit word, st.release.gpu, the double's bits with
//      the lowest mantissa bit set as the ready flag (the memset's zero is
//      "not ready"; the flag moves a total by at most 2^-52 of itself).
//   4. Each warp scans its segment of kChunk / kWarps elements in place,
//      in warp-strided steps of 32 (lane l holds element l of the step; a
//      shuffle scan; a carry across steps): no transpose, no bank
//      conflicts.
//   5. Warp 0 forms the chunk's exclusive prefix from its predecessors'
//      published totals, 32 at a time (acquire loads, spinning until the
//      flag is set), each group by an xor tree, the groups in sequence, in
//      double.  A block waits only on totals that its predecessors publish
//      straight after their loads: the chain is one step deep.  Its cost
//      grows with the chunk's index c (c / 32 groups; 25 chunks a row at
//      the fused step's D), linear in the row, and is right at any length.
//   6. y = hi + (lo + the warp-local scan), where hi + lo is the double
//      base (the prefix + the warp's offset in the chunk) split into two
//      floats: the one rounding at the prefix's size is y's own.  Written
//      once, by streaming float4 stores where y's chunk has x's
//      alignment (scalar stores at its head and tail), by scalar streaming
//      stores where it has not.
// Bytes from the code: the loads of step 2 read n floats of x and the
// stores of step 6 write n floats of y for each chunk of n elements, so
// 2 * 4 * K * F * D in all, the bound's; besides, 8 bytes a chunk of
// status (written once, read by the row's later chunks from L2) and the
// memset of the scratch, (rows * chunks + 1) * 8 bytes.
//
// Scratch: (rows * chunks + 1) 64-bit words, allocated by the wrapper and
// zeroed by one cudaMemsetAsync in the C entry on the launch's stream:
// word 0 the ticket counter, then one status word per (row, chunk).
//
// Numerics: every sum is in an order fixed by the shapes alone, never by
// timing or alignment: no decoupled look-back (its association depends on
// how far a block's predecessors have got), no atomics on values.  So two
// launches on the same input are bit-equal.  The in-warp scans are float
// at a chunk's scale; the totals, the prefixes and the bases are double,
// so the error at the prefix's scale is about y's own rounding (on an
// H100, on chip_smoke.k4_input: 0.51 ulp of the largest prefix against 2.2
// with float totals, scripts/redesign_variants.py --only k4).  Any D is
// taken: the last chunk of a row is ragged and reads zeros past its end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8192;             // elements a block scans
constexpr int kSeg = kChunk / kWarps;    // elements a warp scans
constexpr int kSteps = kSeg / 32;        // warp-strided steps of 32
constexpr bool kBulkLoad = true;         // cp.async.bulk body, else float4 loads
using Acc = double;                      // the totals', prefixes' and bases' type
constexpr int kSmemBytes = (kChunk + 4) * 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int log2i(int v) { return v > 1 ? 1 + log2i(v / 2) : 0; }
constexpr int kSegShift = log2i(kSeg);  // element i lies in warp i >> kSegShift's segment
static_assert(kSeg % 32 == 0 && (1 << kSegShift) == kSeg, "a warp's segment is 2^k steps of 32");

__device__ __forceinline__ void publish(unsigned long long* p, Acc v) {
  const unsigned long long w =
      static_cast<unsigned long long>(__double_as_longlong(static_cast<double>(v))) | 1ull;
  asm volatile("st.release.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(w) : "memory");
}

// a predecessor's total, once published; a word that never becomes ready
// traps (a fault, never a hang)
__device__ __forceinline__ Acc wait_total(const unsigned long long* p) {
  unsigned long long w;
  for (unsigned tries = 0;; ++tries) {
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
    if (w != 0) break;
    if (tries == (1u << 24)) __trap();
    __nanosleep(64);
  }
  return static_cast<Acc>(__longlong_as_double(static_cast<long long>(w)));
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;  // the same bits in every lane
}

// the exclusive prefix of chunk c of a row: its predecessors' totals, 32 at
// a time, each group summed by an xor tree, the groups in sequence
__device__ Acc exclusive_prefix(const unsigned long long* status, int c, int lane) {
  Acc p = 0;
  for (int g = 0; g < c; g += 32) {
    const Acc v = g + lane < c ? wait_total(status + g + lane) : Acc(0);
    p += warp_sum(v);
  }
  return p;
}

// the chunk's 16-byte aligned body, body4 float4s from src to dst, by one
// bulk copy on an mbarrier; every thread returns once it has landed
__device__ __forceinline__ void bulk_load(float* dst, const float* src, int body4,
                                          unsigned long long* bar) {
  const uint32_t b = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  const uint32_t bytes = 16u * static_cast<uint32_t>(body4);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(b), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src), "r"(bytes),
           "r"(b) : "memory");
  }
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {  // a copy that never lands traps
    asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0; "
                 "selp.u32 %0, 1, 0, p; }" : "=r"(done) : "r"(b) : "memory");
    if (tries == (1u << 27)) __trap();
  }
}

// y's element i of a chunk from its warp-local scan v: hi + (lo + v)
__device__ __forceinline__ float out(const float2* base, int i, float v) {
  const float2 b = base[i >> kSegShift];
  return b.x + (b.y + v);
}

__global__ void __launch_bounds__(kThreads) scan_chunks(
    const float* __restrict__ x, float* __restrict__ y, unsigned long long* __restrict__ scratch,
    int rows, long long d, int chunks) {
  extern __shared__ __align__(16) float buf[];
  __shared__ Acc warp_off[kWarps];
  __shared__ float2 warp_base[kWarps];  // (hi, lo) of prefix + warp_off
  __shared__ unsigned s_ticket;
  __shared__ Acc s_prefix;
  __shared__ __align__(8) unsigned long long bar;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    s_ticket = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
    if (kBulkLoad) {
      const uint32_t b = static_cast<uint32_t>(__cvta_generic_to_shared(&bar));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  __syncthreads();
  const int r = static_cast<int>(s_ticket % static_cast<unsigned>(rows));
  const int c = static_cast<int>(s_ticket / static_cast<unsigned>(rows));
  const long long first = static_cast<long long>(c) * kChunk;
  const int n = static_cast<int>(min(static_cast<long long>(kChunk), d - first));
  const float* xc = x + static_cast<long long>(r) * d + first;
  float* yc = y + static_cast<long long>(r) * d + first;
  unsigned long long* status = scratch + 1 + static_cast<long long>(r) * chunks;

  // 2. load: element i at chunk[i]; chunk + head is 16-byte aligned
  const int xm = static_cast<int>((reinterpret_cast<uintptr_t>(xc) >> 2) & 3);
  const int head = min(n, (4 - xm) & 3);
  const int body4 = (n - head) >> 2;
  float* chunk = buf + xm;
  if (threadIdx.x < head) chunk[threadIdx.x] = xc[threadIdx.x];
  const int tail = head + 4 * body4;
  if (tail + static_cast<int>(threadIdx.x) < n) chunk[tail + threadIdx.x] = xc[tail + threadIdx.x];
  if (kBulkLoad) {
    if (body4 > 0) bulk_load(chunk + head, xc + head, body4, &bar);
  } else {
    const float4* src = reinterpret_cast<const float4*>(xc + head);
    float4* dst = reinterpret_cast<float4*>(chunk + head);
#pragma unroll 8
    for (int j = threadIdx.x; j < body4; j += kThreads) dst[j] = __ldcs(src + j);
  }
  __syncthreads();

  // 3. the chunk's total, in a fixed order, published at once
  const int seg0 = warp * kSeg;
  Acc col = 0;
#pragma unroll 8
  for (int k = 0; k < kSteps; ++k) {
    const int i = seg0 + 32 * k + lane;
    if (i < n) col += static_cast<Acc>(chunk[i]);
  }
  col = warp_sum(col);
  if (lane == 0) warp_off[warp] = col;
  __syncthreads();
  if (threadIdx.x == 0) {
    Acc total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const Acc t = warp_off[w];
      warp_off[w] = total;  // the warp's offset in the chunk
      total += t;
    }
    publish(status + c, total);
  }

  // 4. each warp's segment, scanned in place in steps of 32
  float carry = 0.0f;
#pragma unroll 4
  for (int k = 0; k < kSteps; ++k) {
    const int i = seg0 + 32 * k + lane;
    float v = i < n ? chunk[i] : 0.0f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(kFull, v, off);
      if (lane >= off) v += up;
    }
    const float step = __shfl_sync(kFull, v, 31);
    if (i < n) chunk[i] = carry + v;
    carry += step;
  }

  // 5. the chunk's exclusive prefix from its predecessors' totals
  if (warp == 0) {
    const Acc p = exclusive_prefix(status, c, lane);
    if (lane == 0) s_prefix = p;
  }
  __syncthreads();
  if (threadIdx.x < kWarps) {
    const Acc b = s_prefix + warp_off[threadIdx.x];
    const float hi = static_cast<float>(b);
    warp_base[threadIdx.x] = make_float2(hi, static_cast<float>(b - static_cast<Acc>(hi)));
  }
  __syncthreads();

  // 6. y, written once
  const int ym = static_cast<int>((reinterpret_cast<uintptr_t>(yc) >> 2) & 3);
  if (ym == xm) {
    const int t = threadIdx.x;
    if (t < head) __stcs(yc + t, out(warp_base, t, chunk[t]));
    if (tail + t < n) __stcs(yc + tail + t, out(warp_base, tail + t, chunk[tail + t]));
    const float4* src = reinterpret_cast<const float4*>(chunk + head);
    float4* dst = reinterpret_cast<float4*>(yc + head);
#pragma unroll 4
    for (int j = t; j < body4; j += kThreads) {
      const int i = head + 4 * j;
      const float4 v = src[j];
      __stcs(dst + j, make_float4(out(warp_base, i, v.x), out(warp_base, i + 1, v.y),
                                  out(warp_base, i + 2, v.z), out(warp_base, i + 3, v.w)));
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) __stcs(yc + i, out(warp_base, i, chunk[i]));
  }
}

}  // namespace

extern "C" int cumsum_frames_chunk() { return kChunk; }

// the launch's shared memory above the default 48 KB cap (for larger
// chunks), and all of the SM's shared memory preferred over L1
static cudaError_t configure() {
  const cudaError_t err = cudaFuncSetAttribute(
      scan_chunks, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(scan_chunks, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// resident blocks an SM at the launch's shared memory (0 if a query fails)
extern "C" int cumsum_frames_blocks_per_sm() {
  int blocks = 0;
  if (configure() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, scan_chunks, kThreads,
                                                    kSmemBytes) != cudaSuccess) {
    return 0;
  }
  return blocks;
}

// Plain C entry point (loaded with ctypes).  x and y are (rows, d) float32,
// contiguous; scratch holds rows * ceil(d / kChunk) + 1 64-bit words.
// Zeroes the scratch and launches the scan on `stream`, does not
// synchronise, and returns the first cudaError_t (0 on success).
extern "C" int cumsum_frames(const float* x, float* y, void* scratch, long long rows,
                             long long d, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  const long long chunks = (d + kChunk - 1) / kChunk;
  if (rows * chunks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(rows * chunks + 1) * 8, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_chunks<<<static_cast<int>(rows * chunks), kThreads, kSmemBytes, s>>>(
      x, y, static_cast<unsigned long long*>(scratch), static_cast<int>(rows), d,
      static_cast<int>(chunks));
  return static_cast<int>(cudaGetLastError());
}
