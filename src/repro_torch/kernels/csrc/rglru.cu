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
// Design. The recurrence stays one thread per (b, w) channel walking T with
// h in a register: one FMA a step, never the limit. What limits a kernel
// that is bound by bytes is how many bytes it keeps in flight, so each
// block of WB = 64 channels streams (CH = 32 steps x WB channels) tiles of a
// and b through a ring of STAGES = 4 stages in shared memory (16 KB a
// stage): the loads of the next three tiles are in flight while a tile is
// consumed, 48 KB a block, ~6 MB on the card at recurrentgemma-9b's shape.
// One kernel, two ways to fill the same ring, chosen by the C entry from
// the shape (each call is one launch):
//
// * TMA (W % 4 == 0 and 16-byte-aligned a and b, so the row stride W * 4
//   is a multiple of 16 as a tensor map needs): 3-D maps over (W, T, B),
//   one box of WB x CH x 1 per tensor and stage, one mbarrier per stage;
//   thread 0 refills a stage after a block barrier shows it consumed.
//   Boxes past W or T are zero-filled and never read the next batch row.
// * cp.async (any other W or base, e.g. W = 4099, 65, 7): each thread
//   copies its own channel's CH steps with 4-byte cp.async (LDGSTS) into
//   the same ring, one commit group per stage, and waits for its own
//   copies only, so no block barrier is needed.
//
// h_seq is written with coalesced stores straight from the loop (a warp
// writes 128 contiguous bytes a step).
//
// Bound at recurrentgemma-9b's prefill shape (B=2, T=1024, W=4096): a and b
// read once and h_seq written once, 12 bytes per element, 101 MB: 30 us at
// 3.35 TB/s (the 2 FLOP per element are nothing). Bound by bytes.
// Measured by chip_smoke.py on an "NVIDIA H100 80GB HBM3, 700.00 W" card
// (PERF.md, kernel table row 5): 0.0385 ms, 78% of the bound (an earlier
// version, each thread loading 8 steps ahead without a ring: 0.139 ms).

#include "tma.cuh"

namespace {

constexpr int WB = 64;        // channels per block (threads)
constexpr int CH = 32;        // time steps per tile
constexpr int STAGES = 4;     // tiles in the ring
constexpr int TILE = CH * WB * 4;            // bytes of one tensor's tile
constexpr int STAGE = 2 * TILE;              // a, then b
constexpr int SMEM = STAGES * STAGE + 8 * STAGES + 128;   // + alignment

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}

template <bool TMA>
__global__ void __launch_bounds__(WB)
rglru_fwd(const __grid_constant__ CUtensorMap tm_a,
          const __grid_constant__ CUtensorMap tm_b,
          const float* __restrict__ a, const float* __restrict__ b,
          const float* __restrict__ h0, float* __restrict__ y,
          float* __restrict__ h_out, int T, int W) {
  extern __shared__ unsigned char smem_raw[];
  // aligned to 128 bytes for TMA by an offset from smem_raw (not through
  // an integer cast), so the compiler keeps shared loads (LDS), not
  // generic ones
  unsigned char* smem =
      smem_raw + ((128 - (tma::smem_addr(smem_raw) & 127)) & 127);
  const uint32_t base = tma::smem_addr(smem);
  const uint32_t bars = base + STAGES * STAGE;
  const int tid = threadIdx.x;
  const int w0 = blockIdx.x * WB, bi = blockIdx.y;
  const int w = w0 + tid;
  const bool live = w < W;
  const int n_chunks = (T + CH - 1) / CH;
  const long long seq = (long long)bi * T * W + w;    // (bi, t = 0, w)

  // TMA: thread 0 loads both tiles of chunk c. cp.async: every thread
  // copies its own channel of chunk c, as one commit group (empty past
  // the last chunk, so the group count stays one per chunk)
  auto load = [&](int c) {
    const int st = c % STAGES;
    const uint32_t dst = base + st * STAGE;
    if constexpr (TMA) {
      const uint32_t bar = bars + 8 * st;
      tma::mbar_expect_tx(bar, STAGE);
      tma::load_3d(dst, &tm_a, bar, w0, c * CH, bi);
      tma::load_3d(dst + TILE, &tm_b, bar, w0, c * CH, bi);
    } else {
      if (live && c < n_chunks) {
        const int n = min(CH, T - c * CH);
        const float* pa = a + seq + (long long)c * CH * W;
        const float* pb = b + seq + (long long)c * CH * W;
        for (int tt = 0; tt < n; ++tt) {
          cp_async4(dst + (tt * WB + tid) * 4, pa + (long long)tt * W);
          cp_async4(dst + TILE + (tt * WB + tid) * 4, pb + (long long)tt * W);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  };
  if constexpr (TMA) {
    if (tid == 0) {
      for (int st = 0; st < STAGES; ++st) tma::mbar_init(bars + 8 * st, 1);
      tma::mbar_init_fence();
    }
    __syncthreads();
    if (tid == 0)
      for (int c = 0; c < STAGES && c < n_chunks; ++c) load(c);
  } else {
    for (int c = 0; c < STAGES; ++c) load(c);
  }

  float h = live ? h0[(long long)bi * W + w] : 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % STAGES;
    if constexpr (TMA) {
      tma::mbar_wait(bars + 8 * st, (c / STAGES) & 1);
    } else {
      // chunk c's group is complete once at most STAGES - 1 newer ones
      // are pending
      asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 1)
                   : "memory");
    }
    const float* sa = reinterpret_cast<const float*>(smem + st * STAGE) + tid;
    const float* sb = sa + TILE / 4;
    float* yp = y + seq + (long long)c * CH * W;
    const int n = min(CH, T - c * CH);
    if (n == CH) {
#pragma unroll
      for (int tt = 0; tt < CH; ++tt) {
        h = fmaf(sa[tt * WB], h, sb[tt * WB]);
        if (live) yp[(long long)tt * W] = h;
      }
    } else {
      for (int tt = 0; tt < n; ++tt) {
        h = fmaf(sa[tt * WB], h, sb[tt * WB]);
        if (live) yp[(long long)tt * W] = h;
      }
    }
    if constexpr (TMA) {
      __syncthreads();          // every thread is done with stage st
      if (tid == 0 && c + STAGES < n_chunks) load(c + STAGES);
    } else {
      load(c + STAGES);         // this thread's own slots of stage st
    }
  }
  if (live) h_out[(long long)bi * W + w] = h;
}

// TMA when the tensor maps can describe a and b, else cp.async
bool tma_path(const void* a, const void* b, int W) {
  return W % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0
         && reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

}  // namespace

// C entry, bound with ctypes. Returns the cudaError_t of the launch (0 when
// it was accepted) or one of tma.cuh's own codes (ERR_*); the wrapper
// raises on anything but 0.
extern "C" int rglru_fwd(const void* a, const void* b, const void* h0,
                         void* y, void* h_out, int B, int T, int W,
                         void* stream) {
  if (B <= 0 || T <= 0 || W <= 0 || B > 65535) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + WB - 1) / WB, B);
  const float *ap = static_cast<const float*>(a),
              *bp = static_cast<const float*>(b),
              *hp = static_cast<const float*>(h0);
  float* yp = static_cast<float*>(y);
  float* op = static_cast<float*>(h_out);
  CUtensorMap ma = {}, mb = {};
  if (tma_path(a, b, W)) {
    const tma::EncodeTiled encode = tma::encode_tiled();
    if (encode == nullptr) return tma::ERR_NO_ENCODE;
    // (W, T, B) in boxes of WB channels x CH steps
    if (!tma::map_3d(encode, &ma, a, W, T, B, WB, CH)
        || !tma::map_3d(encode, &mb, b, W, T, B, WB, CH))
      return tma::ERR_TENSOR_MAP;
    const cudaError_t attr = cudaFuncSetAttribute(
        rglru_fwd<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (attr != cudaSuccess) return attr;
    rglru_fwd<true><<<grid, WB, SMEM, st>>>(ma, mb, ap, bp, hp, yp, op, T, W);
  } else {
    const cudaError_t attr = cudaFuncSetAttribute(
        rglru_fwd<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (attr != cudaSuccess) return attr;
    rglru_fwd<false><<<grid, WB, SMEM, st>>>(ma, mb, ap, bp, hp, yp, op, T, W);
  }
  return cudaGetLastError();
}

// The tile length, for the launcher's constant to be checked against, and
// which path the entry takes for these base addresses and W (1: TMA).
extern "C" void rglru_constants(int* chunk) { *chunk = CH; }
extern "C" int rglru_uses_tma(const void* a, const void* b, int W) {
  return tma_path(a, b, W) ? 1 : 0;
}
