// Column gather out[k, j] = tab[k, ids[j]] from a table staged in shared
// memory, for Hopper (sm_90a): the resident-table gather probe.
//
// Replaces scripts/vmem_gather_probe.py::take_kernel and ::tala_kernel, the
// Pallas TPU kernels of take_axis1 and take_along: a (16, 4096) table
// resident in VMEM and a dynamic gather along its lanes, for indices laid
// out as (D/128, 128) or as (D,).  Both layouts are one kernel here: the
// indices are read flat, and the wrapper gives the output the indices'
// shape.
//
// What bounds it: bytes (indices in, the table once, output out), like the
// device-memory gather of gather_cols.cu; the question the probe answers is
// whether a gather from a resident table beats that one on this card.  The
// trouble: the reference's (16, 4096) float32 table is 256 KiB, and a block
// holds at most 227 KB of shared memory (anything above 48 KB only after
// cudaFuncSetAttribute).  What the design does about it: the rows are split
// over blockIdx.y, rows_per_block rows a block (8 rows of 4096 are 128 KiB);
// one block per SM stages its rows once, coalesced, and then walks a
// grid-stride share of the indices, reading the table from shared memory.
// A request the card refuses returns its error: the launch never runs
// short.  An index outside [0, cols) writes NaN.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads) smem_gather_kernel(
    const float* __restrict__ tab, int cols, const int* __restrict__ ids,
    float* __restrict__ out, long long d, int rows, int rows_per_block) {
  extern __shared__ float stage[];  // rows_per_block x cols
  const int r0 = blockIdx.y * rows_per_block;
  const int nr = min(rows_per_block, rows - r0);
  const float* src = tab + static_cast<long long>(r0) * cols;
  for (int i = threadIdx.x; i < nr * cols; i += kThreads) stage[i] = src[i];
  __syncthreads();
  for (long long j = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; j < d;
       j += static_cast<long long>(gridDim.x) * kThreads) {
    const int id = ids[j];
    const bool ok = id >= 0 && id < cols;
    for (int r = 0; r < nr; ++r) {
      out[(r0 + r) * d + j] = ok ? stage[r * cols + id] : __int_as_float(0x7fc00000);
    }
  }
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
// (d,) int32 and out (rows, d) float32, contiguous; blocks_x blocks per row
// group.  Returns the cudaError_t of the shared-memory request or of the
// launch (0 on success); does not synchronise.
extern "C" int smem_gather(const float* tab, int cols, const int* ids, float* out, long long d,
                           int rows, int rows_per_block, int blocks_x, void* stream) {
  if (d <= 0 || rows <= 0) return 0;
  if (rows_per_block <= 0 || blocks_x <= 0 || cols <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * static_cast<size_t>(rows_per_block) * cols;
  if (smem > (1u << 30)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      smem_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused request must not fail a later launch
    return static_cast<int>(err);
  }
  const dim3 grid(blocks_x, (rows + rows_per_block - 1) / rows_per_block);
  smem_gather_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tab, cols, ids, out, d, rows, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}
