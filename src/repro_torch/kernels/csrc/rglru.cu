// RG-LRU linear recurrence (recurrentgemma) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rglru.py::rglru_kernel (:62, body _rglru_kernel :32)
// and computes the same function over (B, T, W) f32:
//   h_t = a_t * h_{t-1} + b_t,  h_0 given,
// returning every h_t and the last one. The gates that make a and b are
// elementwise PyTorch work around the call (models/hybrid.py), as they are
// XLA work around the TPU kernel.
//
// Layout: a, b, h_seq are contiguous (B, T, W); h0 and h_final (B, W).
//
// Design. The TPU kernel streams (chunk, W-block) tiles through VMEM with
// the running h in scratch, on a grid whose chunk axis runs in order. Here
// one thread owns one (b, w) channel and walks T itself, h in a register;
// the 64 threads of a block take 64 neighbouring channels, so every load
// and store of a step is one coalesced 256-byte row. The loads of U = 8
// steps are issued before their updates, so each thread keeps 16 loads in
// flight instead of waiting on one per step.
//
// Bound at recurrentgemma-9b's prefill shape (B=2, T=1024, W=4096): a and b
// read once and h_seq written once, 12 bytes per element, 101 MB: 30 us at
// 3.35 TB/s (the 2 FLOP per element are nothing). Bound by bytes. At that
// shape there are only B*W = 8192 threads (128 blocks, about one per SM),
// so the bytes in flight, not the HBM rate, limit this version. Measured by
// chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 0.139 ms at that
// shape, 4.6x the bound.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int U = 8;        // time steps whose loads are issued together

__global__ void __launch_bounds__(THREADS)
rglru_fwd(const float* __restrict__ a, const float* __restrict__ b,
          const float* __restrict__ h0, float* __restrict__ y,
          float* __restrict__ h_out, int T, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int bi = blockIdx.y;
  if (w >= W) return;
  const long long base = (long long)bi * T * W + w;
  float h = h0[(long long)bi * W + w];
  int t = 0;
  for (; t + U <= T; t += U) {
    float av[U], bv[U];
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const long long off = base + (long long)(t + s) * W;
      av[s] = a[off];
      bv[s] = b[off];
    }
#pragma unroll
    for (int s = 0; s < U; ++s) {
      h = fmaf(av[s], h, bv[s]);
      y[base + (long long)(t + s) * W] = h;
    }
  }
  for (; t < T; ++t) {
    const long long off = base + (long long)t * W;
    h = fmaf(a[off], h, b[off]);
    y[off] = h;
  }
  h_out[(long long)bi * W + w] = h;
}

}  // namespace

// C entry, bound with ctypes. Returns the cudaError_t of the launch (0 when
// the launch was accepted); the wrapper raises on anything else.
extern "C" int rglru_fwd(const void* a, const void* b, const void* h0,
                         void* y, void* h_out, int B, int T, int W,
                         void* stream) {
  if (B <= 0 || T <= 0 || W <= 0 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_fwd<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_out), T, W);
  return cudaGetLastError();
}
