// Peak-rate probe of the FP32 pipes and the transcendental units, for
// Hopper (sm_90a).
//
// Replaces scripts/peak_probe.py::kern, the Pallas TPU kernel that the
// probe's run() launches over (256, 1024, 256) blocks resident in VMEM: a
// chain of KK = 64 FMAs (or 8 interleaved chains, or 16 exps or logs) on
// every element.  Here one thread keeps one element, and its chains, in
// registers; a grid-stride loop covers the array.
//
// What bounds it: at the reference's shape, bytes.  64 FMAs an element on
// (256, 1024, 256) float32 is 8.6 GFLOP against 537 MB in and out, 16 FLOP a
// byte, under the H100's FP32 ridge of 67e12 / 3.35e12 = 20: there the probe
// measures device memory, not the FMA pipes.  What the design does about it:
// the chain length kk is an argument read at run time (so that nvcc cannot
// fold the chain), and the probe also runs a register-resident form, a few
// million elements with kk in the thousands, whose rate is the pipes'.
//
// Forms (each step on y, x the element's input, y = x at the start):
//   0 fma           y = y * x + 0.3, kk dependent steps (fmaf)
//   1 fma_ilp       8 chains a_i = y (0.9 + 0.01 i), kk / 8 steps each, summed
//   2 exp           y = expf(-y) * 0.5, kk dependent steps
//   3 exp_ilp       4 chains, kk / 4 steps each of expf, summed
//   4 fast_exp_ilp  the same with __expf (ex2.approx after a multiply)
//   5 log           y = logf(y * 0.5 + 1.5), kk dependent steps
//   6 exp_bf16      y = hexp(-y) * 0.5 in bf16
//   7 log_bf16      y = hlog(y * 0.5 + 1.5) in bf16
// (The TPU script's log chain adds 0.8, which has no fixed point: it leaves
// the domain of log after 12 steps.  1.5 keeps every step finite.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int Form>
__device__ __forceinline__ float chain_f32(float x, int kk) {
  float y = x;
  if (Form == 0) {
#pragma unroll 8
    for (int k = 0; k < kk; ++k) y = fmaf(y, x, 0.3f);
  } else if (Form == 1) {
    float a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = y * (0.9f + 0.01f * i);
#pragma unroll 4
    for (int k = 0; k < kk / 8; ++k) {
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = fmaf(a[i], x, 0.3f);
    }
    y = a[0];
#pragma unroll
    for (int i = 1; i < 8; ++i) y += a[i];
  } else if (Form == 2) {
#pragma unroll 4
    for (int k = 0; k < kk; ++k) y = expf(-y) * 0.5f;
  } else if (Form == 3 || Form == 4) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = y * (0.9f + 0.01f * i);
#pragma unroll 4
    for (int k = 0; k < kk / 4; ++k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = (Form == 3 ? expf(-a[i]) : __expf(-a[i])) * 0.5f;
    }
    y = a[0] + a[1] + a[2] + a[3];
  } else {
#pragma unroll 4
    for (int k = 0; k < kk; ++k) y = logf(y * 0.5f + 1.5f);
  }
  return y;
}

template <int Form>
__global__ void __launch_bounds__(kThreads) peak_f32(const float* __restrict__ x,
                                                     float* __restrict__ y, long long n, int kk) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    y[i] = chain_f32<Form>(x[i], kk);
  }
}

template <int Form>
__global__ void __launch_bounds__(kThreads) peak_bf16(const __nv_bfloat16* __restrict__ x,
                                                      __nv_bfloat16* __restrict__ y, long long n,
                                                      int kk) {
  const __nv_bfloat16 half = __float2bfloat16(0.5f);
  const __nv_bfloat16 c = __float2bfloat16(1.5f);
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    __nv_bfloat16 v = x[i];
#pragma unroll 4
    for (int k = 0; k < kk; ++k) {
      v = Form == 6 ? __hmul(hexp(__hneg(v)), half) : hlog(__hadd(__hmul(v, half), c));
    }
    y[i] = v;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  x and y hold n elements,
// float32 for forms 0-5 and bf16 for forms 6-7, contiguous.  Launches on
// `stream`, does not synchronise, and returns the cudaError_t of the launch
// (0 on success).
extern "C" int peak_run(const void* x, void* y, long long n, int form, int kk, void* stream) {
  if (n <= 0) return 0;
  if (kk < 0 || (form == 1 && kk % 8) || ((form == 3 || form == 4) && kk % 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < (1LL << 30) ? want : (1LL << 30));
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  switch (form) {
    case 0: peak_f32<0><<<blocks, kThreads, 0, s>>>(xf, yf, n, kk); break;
    case 1: peak_f32<1><<<blocks, kThreads, 0, s>>>(xf, yf, n, kk); break;
    case 2: peak_f32<2><<<blocks, kThreads, 0, s>>>(xf, yf, n, kk); break;
    case 3: peak_f32<3><<<blocks, kThreads, 0, s>>>(xf, yf, n, kk); break;
    case 4: peak_f32<4><<<blocks, kThreads, 0, s>>>(xf, yf, n, kk); break;
    case 5: peak_f32<5><<<blocks, kThreads, 0, s>>>(xf, yf, n, kk); break;
    case 6: peak_bf16<6><<<blocks, kThreads, 0, s>>>(xb, yb, n, kk); break;
    case 7: peak_bf16<7><<<blocks, kThreads, 0, s>>>(xb, yb, n, kk); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
