// WKV6 recurrence (RWKV-6 time mix) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6_scan.py::wkv6_kernel (:89, body _wkv6_kernel :38)
// and computes the same function, per (batch, head) with state S (hs x hs):
//   y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
// from s0, returning every y_t and the final state, all in f32. This is the
// model's own step recurrence (src/repro/models/rwkv6.py::_wkv_scan); the
// TPU kernel's chunked log-space form exists for its matrix unit and is not
// carried over.
//
// Layout: r, k, v, w, y are contiguous (B, T, H, hs) tensors read and
// written in place (offset ((b*T + t)*H + h)*hs + i): no transpose to
// (B*H, T, hs), no padding of T to a chunk. u is (H, hs); s0 and s_final
// are (B, H, hs, hs), row i, column j.
//
// Design. The TPU kernel walks chunks of T as a sequential grid axis and
// carries S in VMEM scratch. Here ONE CUDA block owns one (b, h) and loops
// over T itself; S lives in registers for the whole sequence. The block
// has hs * R threads (R = 4): thread (j, g) holds column j of S at rows
// i = q*R + g (q < hs/R), so each step is hs/R independent FMA chains per
// thread and the R partial sums of y_j meet in two warp shuffles (the R
// threads of a column are neighbouring lanes). r, k, v and w of CH = 32
// steps are staged in shared memory with coalesced loads (two barriers
// per 32 steps, none per step); the R lanes of a warp that read r_i, k_i,
// w_i at one step read R neighbouring words, so no bank conflicts.
//
// Bound at rwkv6-7b's prefill shape (B=2, T=1024, H=64, hs=64): the bytes
// are r, k, v, w read once (134 MB), y written once (33.6 MB) and the
// state read and written (4.2 MB): 172 MB, 51 us at 3.35 TB/s; the work,
// about 5 FLOP per (t, i, j), is 2.1 GFLOP, 32 us at the f32 rate of
// 67 TFLOP/s. Bound by bytes. This version has only B*H = 128 blocks of
// 256 threads (one per SM), so it is bound instead by the latency of the
// per-step FMA chain: a later version splits columns across blocks.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 0.42-0.43
// ms at that shape, 8.3x the bound.

#include <cuda_runtime.h>

namespace {

constexpr int R = 4;     // threads per state column
constexpr int CH = 32;   // time steps staged in shared memory at once

template <int HS>
__global__ void __launch_bounds__(HS * R)
wkv6_fwd(const float* __restrict__ r, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ w,
         const float* __restrict__ u, const float* __restrict__ s0,
         float* __restrict__ y, float* __restrict__ s_out, int T, int H) {
  constexpr int NT = HS * R;
  constexpr int Q = HS / R;   // state rows per thread
  __shared__ float rs[CH][HS], ks[CH][HS], vs[CH][HS], ws[CH][HS];
  __shared__ float us[HS];

  const int tid = threadIdx.x;
  const int j = tid / R, g = tid % R;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const long long row = (long long)H * HS;              // stride of t
  const long long base = (long long)b * T * row + (long long)h * HS;
  const float* s_in = s0 + (long long)bh * HS * HS;

  float S[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) S[q] = s_in[(q * R + g) * HS + j];
  if (tid < HS) us[tid] = u[h * HS + tid];

  for (int t0 = 0; t0 < T; t0 += CH) {
    const int n = min(CH, T - t0);
    __syncthreads();            // last chunk's readers are done
    for (int e = tid; e < n * HS; e += NT) {
      const int tt = e / HS, i = e % HS;
      const long long off = base + (long long)(t0 + tt) * row + i;
      rs[tt][i] = r[off];
      ks[tt][i] = k[off];
      vs[tt][i] = v[off];
      ws[tt][i] = w[off];
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt][j];
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int i = q * R + g;
        const float kv = ks[tt][i] * vj;
        acc = fmaf(rs[tt][i], S[q] + us[i] * kv, acc);
        S[q] = fmaf(ws[tt][i], S[q], kv);
      }
#pragma unroll
      for (int m = 1; m < R; m <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, m);
      if (g == 0) y[base + (long long)(t0 + tt) * row + j] = acc;
    }
  }

  float* so = s_out + (long long)bh * HS * HS;
#pragma unroll
  for (int q = 0; q < Q; ++q) so[(q * R + g) * HS + j] = S[q];
}

template <int HS>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s0, float* y,
                   float* s_out, int B, int T, int H, cudaStream_t st) {
  wkv6_fwd<HS><<<B * H, HS * R, 0, st>>>(r, k, v, w, u, s0, y, s_out, T, H);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. Returns the cudaError_t of the launch (0 when
// the launch was accepted); the wrapper raises on anything else.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0, void* y,
                        void* s_out, int B, int T, int H, int hs,
                        void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *rp = static_cast<const float*>(r),
              *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v),
              *wp = static_cast<const float*>(w),
              *up = static_cast<const float*>(u),
              *sp = static_cast<const float*>(s0);
  float* yp = static_cast<float*>(y);
  float* op = static_cast<float*>(s_out);
  switch (hs) {
    case 16: return launch<16>(rp, kp, vp, wp, up, sp, yp, op, B, T, H, st);
    case 32: return launch<32>(rp, kp, vp, wp, up, sp, yp, op, B, T, H, st);
    case 64: return launch<64>(rp, kp, vp, wp, up, sp, yp, op, B, T, H, st);
    default: return cudaErrorInvalidValue;
  }
}
