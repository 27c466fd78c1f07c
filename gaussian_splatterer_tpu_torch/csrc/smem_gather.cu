// Column gather out[k, j] = tab[k, ids[j]] from a table staged in shared
// memory, for Hopper (sm_90a): the resident-table gather probe.
//
// Replaces scripts/vmem_gather_probe.py::take_kernel and ::tala_kernel, the
// Pallas TPU kernels of take_axis1 and take_along: a (16, 4096) table
// resident in VMEM and a dynamic gather along its lanes, for indices laid
// out as (D/128, 128) or as (D,).  Both layouts are one kernel here: the
// indices are read flat, and the wrapper gives the output the indices'
// shape.  An index outside [0, cols) writes NaN.
//
// The table does not fit one block: the reference's (16, 4096) float32
// table is 256 KiB, a block holds at most 227 KB of shared memory (above
// 48 KB only after cudaFuncSetAttribute).  So the rows are split over
// blockIdx.y, rows_per_block rows a block (8 rows of 4096 are 128 KiB, one
// block an SM), and every row group walks the same grid-stride share of the
// indices.  A request the card refuses returns its error: the launch never
// runs short.
//
// What bounds it, at D = 2^21 on the reference's table: the 134 MB of
// output written (the ids' 8 MB and the table's 256 KiB are small beside
// it), 40 us at 3.35 TB/s; then the shared-memory reads, one (row, id) a
// lane at random banks, about 3.5 wavefronts a warp load (the largest of
// 32 random draws over 32 banks), 16 x 2^21 / 32 x 3.5 wavefronts over 132
// SMs, about 14 us of the SMs at 1.98 GHz.  What the design does about it:
//   * four ids a thread: the ids are read as one int4 (when the pointer is
//     16-byte aligned and D % 4 == 0; else one id a thread), each row's
//     four outputs leave as one 16-byte streaming store (__stcs: the output
//     is never read back here), and the next group's ids are loaded before
//     this group's stores, so two groups are in flight a thread;
//   * a thread's first ids are loaded before the block stages its rows, so
//     they arrive while the staging loop runs.  Staging is not what bounds
//     the kernel: a copy by cp.async.bulk on an mbarrier, overlapped with
//     the first loads, measured no faster (PERF.md);
//   * the row groups of one id range run side by side (every block is
//     resident at once), so the second group's read of the ids hits L2.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float pick(const float* row, int id, int cols) {
  return static_cast<unsigned>(id) < static_cast<unsigned>(cols) ? row[id]
                                                                  : __int_as_float(0x7fc00000);
}

// VEC: four ids a thread (ids 16-byte aligned, d % 4 == 0); else one.
template <bool VEC>
__global__ void __launch_bounds__(kThreads) smem_gather_kernel(
    const float* __restrict__ tab, int cols, const int* __restrict__ ids,
    float* __restrict__ out, long long d, int rows, int rows_per_block) {
  extern __shared__ float stage[];  // rows_per_block x cols
  const int r0 = blockIdx.y * rows_per_block;
  const int nr = min(rows_per_block, rows - r0);
  const float* src = tab + static_cast<long long>(r0) * cols;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float* dst = out + static_cast<long long>(r0) * d;
  if (VEC) {
    const int4* ids4 = reinterpret_cast<const int4*>(ids);
    const long long n4 = d >> 2;
    int4 cur = g < n4 ? __ldg(ids4 + g) : make_int4(0, 0, 0, 0);
    for (int i = threadIdx.x; i < nr * cols; i += kThreads) stage[i] = src[i];
    __syncthreads();
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (; g < n4; g += stride) {
      const long long gn = g + stride;
      const int4 nxt = gn < n4 ? __ldg(ids4 + gn) : make_int4(0, 0, 0, 0);
#pragma unroll 4
      for (int r = 0; r < nr; ++r) {
        const float* row = stage + r * cols;
        __stcs(dst4 + r * n4 + g, make_float4(pick(row, cur.x, cols), pick(row, cur.y, cols),
                                              pick(row, cur.z, cols), pick(row, cur.w, cols)));
      }
      cur = nxt;
    }
  } else {
    int cur = g < d ? __ldg(ids + g) : 0;
    for (int i = threadIdx.x; i < nr * cols; i += kThreads) stage[i] = src[i];
    __syncthreads();
    for (; g < d; g += stride) {
      const long long gn = g + stride;
      const int nxt = gn < d ? __ldg(ids + gn) : 0;
#pragma unroll 4
      for (int r = 0; r < nr; ++r) __stcs(dst + r * d + g, pick(stage + r * cols, cur, cols));
      cur = nxt;
    }
  }
}

template <bool VEC>
int launch(const float* tab, int cols, const int* ids, float* out, long long d, int rows,
           int rows_per_block, size_t smem, cudaStream_t stream) {
  auto kernel = smem_gather_kernel<VEC>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  if (err == cudaSuccess && per_sm == 0) err = cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused request must not fail a later launch
    return static_cast<int>(err);
  }
  const int groups = (rows + rows_per_block - 1) / rows_per_block;
  const long long items = VEC ? d / 4 : d;
  const long long want = (items + kThreads - 1) / kThreads;
  const long long fit = static_cast<long long>(sms) * per_sm / groups;
  const long long gx = want < fit ? want : (fit > 0 ? fit : 1);
  kernel<<<dim3(static_cast<unsigned>(gx), groups), kThreads, smem, stream>>>(
      tab, cols, ids, out, d, rows, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most dynamic shared memory a block of `device` may ask for.
extern "C" int smem_gather_max_bytes(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess) {
    return -1;
  }
  return bytes;
}

// Plain C entry point (loaded with ctypes).  tab (rows, cols) float32, ids
// (d,) int32 and out (rows, d) float32, contiguous; rows_per_block rows a
// block.  The grid fills the card: the blocks an SM holds times its SMs,
// shared among the row groups.  Returns the cudaError_t of the
// shared-memory request or of the launch (0 on success); does not
// synchronise.
extern "C" int smem_gather(const float* tab, int cols, const int* ids, float* out, long long d,
                           int rows, int rows_per_block, void* stream) {
  if (d <= 0 || rows <= 0) return 0;
  if (rows_per_block <= 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(rows_per_block) * cols;
  if (smem > (1u << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (reinterpret_cast<uintptr_t>(ids) & 15) == 0 && (d & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(tab, cols, ids, out, d, rows, rows_per_block, smem, s)
             : launch<false>(tab, cols, ids, out, d, rows, rows_per_block, smem, s);
}
