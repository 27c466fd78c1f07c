// The earlier three-pass design of csrc/cumsum_frames.cu, kept whole as a
// design variant for scripts/redesign_variants.py (--only k4), which times
// it beside the shipped one-pass kernel through the same wrapper: the C
// entry point and its arguments are the same, and the wrapper's scratch
// (one 8-byte word a chunk of its size, plus one) holds more than the
// rows * chunks floats this design uses.  Not built by the package.
//
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
// What bounds it: bytes.  The scan reads each element once and writes it
// once (one add an element); at the fused step's ~60 MB group that is about
// 0.036 ms at 3.35 TB/s.  What the design does about it: the K * F rows are
// cut into chunks of kChunk elements, and three passes run over every chunk
// of every row at once, so the grid fills the card at any K * F:
//   1. chunk_totals: one block per (row, chunk) sums its chunk;
//   2. chunk_carries: one block per row scans its chunk totals into each
//      chunk's exclusive prefix (in place);
//   3. chunk_scan: one block per (row, chunk) scans its chunk in shared
//      memory (8 consecutive elements a thread, then warp shuffles, then the
//      warps' totals) and adds the chunk's prefix.
// Passes 1 and 3 read x (two reads and one write an element: 1.5 times the
// bound's bytes, a price of the fixed order below).
//
// Numerics: every sum is taken in an order fixed by the shapes alone, never
// by timing (no atomics, no decoupled look-back, whose association depends
// on how far a block's predecessors have published), so two launches on the
// same input are bit-equal.  Any D is taken: the last chunk of a row is
// ragged and zero-filled in shared memory; D < kChunk is one chunk a row.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kChunk = kThreads * kPerThread;  // 2048 elements a chunk
constexpr int kWarps = kThreads / 32;

// shared-memory index of element i of a chunk: one pad word every 32, so
// that a warp reading 8 consecutive elements a thread hits 32 banks
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// pass 1: sum of each (row, chunk), in a fixed order
__global__ void __launch_bounds__(kThreads) chunk_totals(
    const float* __restrict__ x, float* __restrict__ totals, long long d, int chunks) {
  __shared__ float warp_sum[kWarps];
  const long long row = blockIdx.x / chunks;
  const int c = blockIdx.x % chunks;
  const long long base = row * d + static_cast<long long>(c) * kChunk;
  const int n = static_cast<int>(min(static_cast<long long>(kChunk),
                                     d - static_cast<long long>(c) * kChunk));
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = i * kThreads + threadIdx.x;
    if (e < n) s += x[base + e];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int w = 0; w < kWarps; ++w) t += warp_sum[w];
    totals[blockIdx.x] = t;
  }
}

// pass 2: per row, the chunk totals -> each chunk's exclusive prefix, in
// place.  Thread t owns a run of consecutive chunks.
__global__ void __launch_bounds__(kThreads) chunk_carries(float* __restrict__ totals,
                                                          int chunks) {
  __shared__ float warp_sum[kWarps];
  float* row = totals + static_cast<long long>(blockIdx.x) * chunks;
  const int per = (chunks + kThreads - 1) / kThreads;
  const int lo = min(chunks, threadIdx.x * per);
  const int hi = min(chunks, lo + per);
  float own = 0.0f;
  for (int i = lo; i < hi; ++i) own += row[i];
  // inclusive scan of the threads' sums: warp shuffles, then the warps'
  float incl = own;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  if (lane == 31) warp_sum[threadIdx.x >> 5] = incl;
  __syncthreads();
  float prefix = 0.0f;
  for (int w = 0; w < (threadIdx.x >> 5); ++w) prefix += warp_sum[w];
  float run = prefix + excl;
  for (int i = lo; i < hi; ++i) {
    const float t = row[i];
    row[i] = run;
    run += t;
  }
}

// pass 3: the in-chunk inclusive scan plus the chunk's prefix
__global__ void __launch_bounds__(kThreads) chunk_scan(
    const float* __restrict__ x, const float* __restrict__ carries, float* __restrict__ y,
    long long d, int chunks) {
  __shared__ float buf[kChunk + kChunk / 32];
  __shared__ float warp_sum[kWarps];
  const long long row = blockIdx.x / chunks;
  const int c = blockIdx.x % chunks;
  const long long base = row * d + static_cast<long long>(c) * kChunk;
  const int n = static_cast<int>(min(static_cast<long long>(kChunk),
                                     d - static_cast<long long>(c) * kChunk));
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = i * kThreads + threadIdx.x;
    buf[padded(e)] = e < n ? x[base + e] : 0.0f;
  }
  __syncthreads();
  float v[kPerThread];
  const int first = threadIdx.x * kPerThread;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) v[i] = buf[padded(first + i)];
#pragma unroll
  for (int i = 1; i < kPerThread; ++i) v[i] += v[i - 1];
  const float own = v[kPerThread - 1];
  float incl = own;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  if (lane == 31) warp_sum[threadIdx.x >> 5] = incl;
  __syncthreads();
  float prefix = carries[blockIdx.x];
  for (int w = 0; w < (threadIdx.x >> 5); ++w) prefix += warp_sum[w];
  prefix += excl;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) buf[padded(first + i)] = prefix + v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = i * kThreads + threadIdx.x;
    if (e < n) y[base + e] = buf[padded(e)];
  }
}

}  // namespace

extern "C" int cumsum_frames_chunk() { return kChunk; }

// Plain C entry point (loaded with ctypes).  x and y are (rows, d) float32,
// contiguous; scratch holds rows * ceil(d / kChunk) floats.  Launches the
// three passes on `stream`, does not synchronise, and returns the first
// cudaError_t (0 on success).
extern "C" int cumsum_frames(const float* x, float* y, float* scratch, long long rows,
                             long long d, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  const long long chunks = (d + kChunk - 1) / kChunk;
  if (rows * chunks >= (1LL << 31) || rows >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = static_cast<int>(rows * chunks);
  chunk_totals<<<blocks, kThreads, 0, s>>>(x, scratch, d, static_cast<int>(chunks));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_carries<<<static_cast<int>(rows), kThreads, 0, s>>>(scratch, static_cast<int>(chunks));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_scan<<<blocks, kThreads, 0, s>>>(x, scratch, y, d, static_cast<int>(chunks));
  return static_cast<int>(cudaGetLastError());
}
