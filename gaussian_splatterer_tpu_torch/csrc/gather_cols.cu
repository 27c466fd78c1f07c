// Column gather out[k, j] = tab[k, ids[j]] from device memory, for Hopper
// (sm_90a): the bench-scale gather probe.
//
// Replaces scripts/gather_probe.py::take_kernel, the Pallas TPU kernel that
// take_pallas launches: a (16, 2^19) table held whole in VMEM and jnp.take
// along its lanes for 4,096 indices a grid step.  On the H100 the table's
// nine real rows (18.9 MB) fit in the 50 MB L2, which is this card's
// counterpart of "resident in VMEM"; the kernel reads them from device
// memory and lets L2 keep them.
//
// What bounds it.  DRAM bytes: the indices in, the table once and the
// output out, about 0.031 ms for 9 rows, 2^19 columns and 2^21 indices at
// 3.35 TB/s.  And, on random indices, L2 sectors: the rows lie 2 MB apart,
// so every (row, index) reads its own 32-byte sector, 32 B x 9 x 2^21 =
// 604 MB of L2 traffic, six times the DRAM bytes.
// What the design does about it: one thread per (index, group of kRows
// rows) reads its index once, coalesced, and writes kRows outputs, each
// coalesced across the warp; only the table reads are scattered, and they
// hit L2.  Nothing here lowers the sector count.  Two other forms were
// timed on the H100 and were no faster than this one: one thread per four
// indices (an int4) with every row in the thread, and L2 evict_last loads
// of the table with streaming stores (PERF.md §6).  An index outside
// [0, cols) writes NaN instead of reading out of bounds.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // rows a thread gathers for its index

__global__ void __launch_bounds__(kThreads) gather_cols_kernel(
    const float* __restrict__ tab, long long cols, const int* __restrict__ ids,
    float* __restrict__ out, long long d, int rows) {
  const long long j = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (j >= d) return;
  const int r0 = blockIdx.y * kRows;
  const int r1 = min(rows, r0 + kRows);
  const int id = ids[j];
  const bool ok = id >= 0 && id < cols;
  for (int r = r0; r < r1; ++r) {
    out[r * d + j] = ok ? tab[r * cols + id] : __int_as_float(0x7fc00000);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  tab (rows, cols) float32, ids
// (d,) int32 and out (rows, d) float32, contiguous.  Launches on `stream`,
// does not synchronise, and returns the cudaError_t of the launch.
extern "C" int gather_cols(const float* tab, long long cols, const int* ids, float* out,
                           long long d, int rows, void* stream) {
  if (d <= 0 || rows <= 0) return 0;
  const long long bx = (d + kThreads - 1) / kThreads;
  if (bx >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(bx), (rows + kRows - 1) / kRows);
  gather_cols_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tab, cols, ids, out, d, rows);
  return static_cast<int>(cudaGetLastError());
}
