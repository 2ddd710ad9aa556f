// Flash-style (online-softmax) attention forward for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_kernel (:91, body
//   _flash_kernel :36)
// and computes the same function: scores q.k^T / sqrt(Dh) in f32, masked by
// causal (kv <= q), an optional sliding window (q - kv < window) and a key
// validity bound (kv < s_valid); running max m, denominator l and numerator
// acc kept in f32; p cast to v's dtype before the PV product; the output
// acc / max(l, 1e-30) written in q's dtype. KV tiles that the causal,
// window or s_valid structure masks completely are skipped, as on the TPU.
//
// Layout: q, k, v, o are contiguous (B, S, H, Dh) tensors (k/v already
// expanded to H heads), read in place: no transpose, no padding. The
// kernel masks the ragged edge of S itself.
//
// Design. The TPU kernel walks the KV blocks as a sequential grid axis and
// carries (m, l, acc) in VMEM scratch between grid steps. Blocks on a GPU
// run in no order, so here ONE CUDA block owns one (b*h, 64-query tile)
// and a loop inside it walks the KV tiles. Per tile: load K/V (converted
// to f32) into shared memory; each of 256 threads computes a 4x4 patch of
// the 64x64 score tile with FMAs; four threads per query row reduce the
// row max and sum with warp shuffles and rescale; each thread then adds
// its 4 x Dh/16 patch of P.V into registers. The numerator lives in
// registers for the whole KV loop; m, l and the per-row correction live in
// shared memory. No tensor cores: this is the simple, exact first version
// (wgmma/TMA come later).
//
// Bound at the slice's prefill shape (B=2, S=1024, H=14, Dh=64, bf16,
// causal): the work is 4*B*H*Dh*S*(S+1)/2 = 3.76 GFLOP (3.80 us at 989
// TFLOP/s bf16) and the bytes are q, k, v read once and o written once,
// 4*B*S*H*Dh*2 = 14.7 MB (4.38 us at 3.35 TB/s): bound by bytes, 4.38 us.
// This FMA version is bound instead by the f32 FMA rate (67 TFLOP/s, 56 us)
// and by shared-memory bandwidth (one shared load per two FMAs).
//
// Head dims 16, 32, 64, 128 and 256. At Dh=256 (recurrentgemma's local
// attention) the tiles take 214,272 bytes of shared memory, under the
// 232,448 a block may opt in to, so one block runs per SM; each thread's
// numerator is acc[4][16] (128 registers, no spills). Measured by
// chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W at B=2, S=1024, H=16,
// Dh=256: 1.93-2.17 ms, slower than the plain version (1.47 ms); a
// tensor-core redesign is owed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // key rows per KV tile
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as astype does
}

template <int DH>
constexpr size_t smem_floats() {
  return BQ * DH + BK * (DH + 1) + BK * DH + BQ * (BK + 1) + 3 * BQ;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int H,
          int causal, int window, int s_valid, float scale) {
  static_assert(DH % 16 == 0, "Dh must be a multiple of 16");
  constexpr int CT = DH / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // BQ x DH
  float* Ks = Qs + BQ * DH;            // BK x (DH+1), padded: no bank conflicts
  float* Vs = Ks + BK * (DH + 1);      // BK x DH
  float* Ps = Vs + BK * DH;            // BQ x (BK+1): scores, then p
  float* m_s = Ps + BQ * (BK + 1);     // running max per row
  float* l_s = m_s + BQ;               // running denominator per row
  float* c_s = l_s + BQ;               // this tile's rescale per row

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const long long row_stride = (long long)H * DH;
  const long long base = (long long)b * S * row_stride + (long long)h * DH;
  const int q_lo = blockIdx.x * BQ;
  const int q_hi = q_lo + BQ - 1;

  for (int e = tid; e < BQ * DH; e += THREADS) {
    const int r = e / DH, d = e % DH, qr = q_lo + r;
    Qs[e] = qr < S ? to_f32(q[base + qr * row_stride + d]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  // score / PV patch owned by this thread: rows ty*4+i, cols tx+16*j
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][CT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[i][c] = 0.f;

  const int n_kv = (S + BK - 1) / BK;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k_lo = kt * BK, k_hi = k_lo + BK - 1;
    bool live = k_lo < s_valid;
    if (causal) live = live && k_lo <= q_hi;
    if (window > 0) live = live && (q_lo - k_hi) < window;
    if (!live) continue;        // uniform over the block

    __syncthreads();            // last tile's readers are done with Ks/Vs/Ps
    for (int e = tid; e < BK * DH; e += THREADS) {
      const int r = e / DH, d = e % DH, kr = k_lo + r;
      float kk = 0.f, vv = 0.f;
      if (kr < S) {
        const long long off = base + kr * row_stride + d;
        kk = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      Ks[r * (DH + 1) + d] = kk;
      Vs[r * DH + d] = vv;
    }
    __syncthreads();

    // S = Q K^T for this thread's 4x4 patch
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * DH + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Ks[(tx + 16 * j) * (DH + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_lo + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k_lo + tx + 16 * j;
        bool ok = kp < s_valid;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && (qp - kp) < window;
        Ps[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = ok ? s[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes per row, 16 columns each
    {
      const int r = tid / 4, part = tid % 4;
      float* row = Ps + r * (BK + 1);
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < BK / 4; ++c) mx = fmaxf(mx, row[part + 4 * c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < BK / 4; ++c) {
        const float p = expf(row[part + 4 * c] - m_new);
        sum += p;                                   // l sums the f32 p
        row[part + 4 * c] = to_f32(from_f32<T>(p)); // PV uses p in v's dtype
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[i][c] *= corr;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[4], vv[CT];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < CT; ++c) vv[c] = Vs[j * DH + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CT; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qr = q_lo + r;
    if (qr >= S) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < CT; ++c)
      o[base + qr * row_stride + tx + 16 * c] = from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int causal, int window, int s_valid,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<DH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd<T, DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, causal, window,
      s_valid, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int Dh, int causal, int window,
                        int s_valid, float scale, cudaStream_t st) {
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, causal, window, s_valid, scale, st);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, causal, window, s_valid, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, causal, window, s_valid, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, causal, window, s_valid, scale, st);
    case 256: return launch<T, 256>(q, k, v, o, B, S, H, causal, window, s_valid, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry, bound with ctypes. Returns the cudaError_t of the launch (0 when
// the launch was accepted); the wrapper raises on anything else.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int S, int H, int Dh,
                                   int is_bf16, int causal, int window,
                                   int s_valid, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B * H > 65535) return cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)Dh));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_dh<__nv_bfloat16>(q, k, v, o, B, S, H, Dh, causal, window,
                                      s_valid, scale, st);
  return dispatch_dh<float>(q, k, v, o, B, S, H, Dh, causal, window, s_valid,
                            scale, st);
}
