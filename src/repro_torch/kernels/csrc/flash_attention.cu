// Flash-style (online-softmax) attention forward for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_kernel (:91, body
//   _flash_kernel :36)
// and computes the same function: scores q.k^T / sqrt(Dh) in f32, the scale
// applied after the dot, masked by causal (kv <= q), an optional sliding
// window (q - kv < window) and a key validity bound (kv < s_valid) to the
// finite NEG_INF = -1e30 (never -inf: a row whose first live tile is fully
// masked must give exp(m_prev - m_new) = 1, not NaN); running max m,
// denominator l (a sum of the f32 p) and numerator acc in f32; p cast to
// v's dtype before the PV product; the output acc / max(l, 1e-30) written
// in q's dtype. KV tiles that the causal, window or s_valid structure masks
// completely are skipped, as on the TPU: the KV loop runs from the first
// live tile to the last.
//
// Layout: q and o are contiguous (B, S, H, Dh); k and v are contiguous
// (B, S, KV, Dh) with H % KV == 0, and query head h reads KV head
// h / (H / KV), as attention.expand_kv does, so GQA/MQA heads are read in
// place. Nothing is transposed or padded in device memory; the kernel masks
// the ragged edge of S itself.
//
// Two kernels, chosen by dtype in the C entry (not a fallback):
//
// * bf16 -> flash_fwd_tc, the tensor-core kernel below.
// * f32  -> flash_fwd_f32, the exact FMA kernel. The tensor cores would run
//   f32 as TF32 (about 1e-3 relative), where the f32 checks hold 2e-4.
//
// flash_fwd_tc: one block per (query tile, h, b), with NWG warpgroups of
// 128 threads, each owning 64 query rows (the wgmma M). The grid is 1-D
// with the query tile slowest, from the last tile (the longest causal KV
// range) to the first, so blocks start in order of their work and the short
// ones fill the card's tail (the largest single gain while this kernel was
// designed on the card: without it the long blocks started late).
// * Q (BQ x Dh) arrives once by TMA and stays in shared memory.
// * K and V tiles (BK x Dh) stream by TMA (cp.async.bulk.tensor, 4-D maps
//   over (Dh, heads, S, B)) into a ring of two stages, one mbarrier per
//   stage with the byte count as its transaction count: tile j+1 is in
//   flight while the warpgroups compute on tile j. Each warp, once past its
//   reads of a stage, adds one to the stage's release count; the warp that
//   completes it issues the refill, so the warpgroups of a block wait for
//   each other only through the data.
// * Rows of 64 bf16 (128 bytes) are one 128-byte-swizzled box; Dh = 128
//   and 256 are 2 and 4 boxes per row, each box a separate region of
//   shared memory. Dh = 16 and 32 take one box of 64 columns whose columns
//   past Dh TMA fills with zeros (the box reaches past the tensor), so one
//   swizzle and one descriptor layout serve every head dim; the zeros add
//   nothing to q.k and the extra output columns are not stored. This costs
//   4x and 2x tensor-core work at Dh 16 and 32, which no served model uses.
// * S = Q K^T: wgmma.mma_async m64nBKk16, bf16 in, f32 accumulator in
//   registers; A = Q and B = K from shared memory, both K-major as they lie.
//   A product of two bf16 values is exact in f32, so only the order of the
//   sums differs from the reference's f32 dot.
// * Online softmax on the accumulator fragment: each thread holds two rows
//   (warp*16 + lane/4 and +8); the row max is taken with two quad shuffles;
//   l is kept per thread and summed over the quad once, at the end. The
//   element mask is applied only on tiles that cross the diagonal, the
//   window edge or s_valid; a tile that none of a warpgroup's rows can see
//   costs that warpgroup nothing. exp(x) is computed as exp2f(x * log2(e))
//   on the difference s - m, which changes rounding only.
// * O += P V: wgmma m64n64k16 with A = P from registers (the S fragment,
//   rounded to bf16 pairs, is already the A-register layout) and B = the V
//   tile from shared memory, which is MN-major (Dh contiguous), so the
//   transpose bit is set. Dh > 64 issues one wgmma per 64-column box.
//
// Tiles and resources per head dim (chosen by timing the main path's shapes
// on the card, tools/flash_ab.py; shared memory per block includes 1 KB of
// alignment slack; registers are ptxas' report, no spills; blocks/SM is the
// smaller of what shared memory and registers allow):
//
//   Dh   BQ   BK   threads  shared memory  registers  blocks/SM
//   16   64   128  128      73 KB          130        3
//   32   64   128  128      73 KB          130        3
//   64   64   128  128      73 KB          130        3
//   128  64   64   128      81 KB          130        2
//   256  128  64   256      193 KB         219        1
//
// At Dh=256 the two warpgroups of a block share every K/V tile, which
// halves the tiles pulled through L2 against one warpgroup per block.
//
// What bounds it. At the main path's shapes (bf16, causal, S = 1024) the
// work is 4*B*H*Dh*(kept pairs) FLOP on the tensor cores and q, o at H
// heads plus k, v at KV heads in bytes: Dh=64, B=2, H=14, KV=2: 3.76 GFLOP
// (3.8 us at 989 TFLOP/s) against 8.4 MB (2.5 us at 3.35 TB/s); Dh=256,
// B=2, H=16, KV=1: 17.2 GFLOP (17.4 us) against 35.7 MB (10.7 us). Both
// are bound by operations. This kernel reaches about a sixth (Dh=64) and a
// third (Dh=256) of that: each warpgroup runs a serial chain (S wgmma, then
// the softmax on the CUDA cores with exp2 on the SFU, then the PV wgmma),
// and only other warpgroups fill its gaps. Overlapping the softmax of one
// tile with the products of the next inside a warpgroup, a producer warp
// with setmaxnreg, and ping-pong between consumer warpgroups are the next
// step.
//
// flash_fwd_f32: one block of 256 threads per (b*h, 64-query tile) walking
// its KV tiles; f32 tiles in shared memory, 4x4 score patches per thread
// with FMAs, four lanes per row for the softmax, the numerator in registers.
// Bound by the f32 FMA rate (67 TFLOP/s) and shared-memory loads; it exists
// for the f32 parity checks, and no f32 tensor reaches it on the main path.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
// the C entry's own error codes, beside cudaError_t's
constexpr int ERR_NO_ENCODE = 1001;    // cuTensorMapEncodeTiled not found
constexpr int ERR_TENSOR_MAP = 1002;   // a tensor map was refused

// ===========================================================================
// f32: the exact FMA kernel
// ===========================================================================

namespace simt {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // key rows per KV tile
constexpr int THREADS = 256;

template <int DH>
constexpr size_t smem_floats() {
  return BQ * DH + BK * (DH + 1) + BK * DH + BQ * (BK + 1) + 3 * BQ;
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int S,
              int H, int KV, int causal, int window, int s_valid,
              float scale) {
  static_assert(DH % 16 == 0, "Dh must be a multiple of 16");
  constexpr int CT = DH / 16;   // output columns per thread
  // loop unrolling: at Dh=256 the 64 numerators leave room for fewer
  // loads in flight, so both loops unroll less there (no spills)
  constexpr int QK_UNROLL = DH >= 256 ? 4 : 8;
  constexpr int PV_UNROLL = DH >= 256 ? 2 : 4;
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
  // row strides, and offsets inside one batch, fit in 32 bits (the launch
  // checks S * H * Dh < 2^31)
  const int q_stride = H * DH, kv_stride = KV * DH;
  const long long kv_off = (long long)b * S * kv_stride + (h / (H / KV)) * DH;
  q += (long long)b * S * q_stride + h * DH;
  o += (long long)b * S * q_stride + h * DH;
  k += kv_off;
  v += kv_off;
  const int q_lo = blockIdx.x * BQ;
  const int q_hi = q_lo + BQ - 1;

  for (int e = tid; e < BQ * DH; e += THREADS) {
    const int r = e / DH, d = e % DH, qr = q_lo + r;
    Qs[e] = qr < S ? q[qr * q_stride + d] : 0.f;
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
        kk = k[kr * kv_stride + d];
        vv = v[kr * kv_stride + d];
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
#pragma unroll QK_UNROLL
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
        sum += p;
        row[part + 4 * c] = p;
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
#pragma unroll PV_UNROLL
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
      o[qr * q_stride + tx + 16 * c] = acc[i][c] / denom;
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KV, int causal, int window,
                   int s_valid, float scale, cudaStream_t stream) {
  if (B * H > 65535 || (long long)S * H * DH >= (1ll << 31))
    return cudaErrorInvalidValue;
  const size_t smem = smem_floats<DH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_f32<DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KV, causal,
      window, s_valid, scale);
  return cudaGetLastError();
}

}  // namespace simt

// ===========================================================================
// bf16: the tensor-core kernel (wgmma, TMA, mbarrier)
// ===========================================================================

namespace tc {

constexpr int WG_ROWS = 64;      // query rows per warpgroup: the wgmma M
constexpr int BOX = 64;          // bf16 columns per 128-byte swizzled row
constexpr int ROW = 128;         // bytes per box row
constexpr int SWIZZLE_SPAN = 1024;  // 8 rows x 128 bytes: one swizzle atom
constexpr float LOG2E = 1.4426950408889634f;

constexpr int STAGES = 2;        // depth of the K/V ring

// per Dh: KV rows per tile and warpgroups per block (see the note at the
// top; tools/flash_ab.py times other tables)
template <int BK_, int NWG_> struct TileOf {
  static constexpr int BK = BK_, NWG = NWG_;
};
template <int DH> struct Tile;
template <> struct Tile<16> : TileOf<128, 1> {};
template <> struct Tile<32> : TileOf<128, 1> {};
template <> struct Tile<64> : TileOf<128, 1> {};
template <> struct Tile<128> : TileOf<64, 1> {};
template <> struct Tile<256> : TileOf<64, 2> {};

template <int DH> struct Layout {
  static constexpr int BK = Tile<DH>::BK, NWG = Tile<DH>::NWG;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int BQ = WG_ROWS * NWG;             // query rows per block
  static constexpr int NB = DH < BOX ? 1 : DH / BOX;   // boxes per row
  static constexpr int Q_BOX = BQ * ROW;               // one box of Q
  static constexpr int KV_BOX = BK * ROW;              // one box of K or V
  static constexpr int Q_BYTES = NB * Q_BOX;
  static constexpr int KV_BYTES = NB * KV_BOX;         // a K (or V) tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;     // K then V
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  // barriers (Q, then one per stage), a release count per stage, then the
  // slack that aligns the base
  static constexpr int SMEM = BAR_OFF + 8 * (1 + STAGES) + 4 * STAGES
                              + SWIZZLE_SPAN;
  static_assert(KV_BOX % SWIZZLE_SPAN == 0, "boxes must keep 1 KB alignment");
  static_assert(SMEM <= 232448, "over the 227 KB a block may use");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// waits for the phase of ``bar`` with this parity to complete. A load that
// never completes (a fault in a tensor map) traps after 2^26 polls, seconds
// on the card, instead of hanging it
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on ``bar``
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset, stride byte offset (8-row groups are one
// swizzle atom, 1024 bytes, apart), layout type 1 = 128-byte swizzle
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
       | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
       | ((uint64_t)(SWIZZLE_SPAN >> 4) << 32)
       | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of wgmma registers across
// the asynchronous instructions
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D (64 x 64, f32) (+)= A (64 x 16, smem) * B (64 x 16, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"

      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, f32) (+)= A (64 x 16, smem) * B (128 x 16, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"

      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) (+)= A (64 x 16, bf16 registers) * B (16 x 64, smem,
// MN-major: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"

      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&t);
}

// the S product of a tile of BK keys: m64nBKk16
template <int BK> struct ScoreMma;
template <> struct ScoreMma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
    wgmma_ss_n64(d, da, db, acc);
  }
};
template <> struct ScoreMma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da,
                                             uint64_t db, int acc) {
    wgmma_ss_n128(d, da, db, acc);
  }
};

template <int DH>
__global__ void __launch_bounds__(Layout<DH>::THREADS)
flash_fwd_tc(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             __nv_bfloat16* __restrict__ o, int B, int S, int H, int KV,
             int causal, int window, int s_valid, float scale) {
  using L = Layout<DH>;
  constexpr int BK = L::BK, NB = L::NB, BQ = L::BQ;
  constexpr int QK_STEPS = NB * (BOX / 16);   // k16 steps over the boxes
  constexpr int PV_STEPS = BK / 16;           // k16 steps over the KV rows
  constexpr int SN = BK / 2;                  // score registers per thread

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + SWIZZLE_SPAN - 1)
                        & ~uint32_t(SWIZZLE_SPAN - 1);
  const uint32_t sq = base;
  const uint32_t bar_q = base + L::BAR_OFF;

  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  // a 1-D grid with the query tile slowest, from the last (the longest
  // causal KV range) to the first: blocks start in order of their work,
  // so the short ones fill the card's tail
  const int n_qt = (S + BQ - 1) / BQ;
  const int qt = n_qt - 1 - (int)(blockIdx.x / (H * B));
  const int h = (blockIdx.x / B) % H, b = blockIdx.x % B;
  const int kvh = h / (H / KV);
  const int q_lo = qt * BQ, q_hi = q_lo + BQ - 1;   // the block's rows
  // this warpgroup's 64 rows; its share of Q starts 64 rows into each box
  const int w_lo = q_lo + wg * WG_ROWS, w_hi = w_lo + WG_ROWS - 1;
  const uint32_t sq_w = sq + wg * WG_ROWS * ROW;

  // the live KV tiles [kt_begin, kt_end)
  int kt_end = (min(S, s_valid) + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_hi / BK + 1);
  const int kt_begin = window > 0 ? max(0, q_lo - window + 1) / BK : 0;
  const int n_t = max(0, kt_end - kt_begin);

  // stage st holds K then V of one tile; full[st] counts its bytes in.
  // released[st] counts the warps that are done with the stage's tile: the
  // warp that completes the count refills the stage, so no warpgroup waits
  // for another except through the data itself
  auto full = [&](int st) { return bar_q + 8 * (1 + st); };
  auto stage_k = [&](int st) {
    return base + L::Q_BYTES + st * L::STAGE_BYTES;
  };
  int* released = reinterpret_cast<int*>(
      smem_raw + (bar_q + 8 * (1 + STAGES) - smem_addr(smem_raw)));
  auto load_kv = [&](int st, int t) {
    const uint32_t sk = stage_k(st), sv = sk + L::KV_BYTES;
    const int row = (kt_begin + t) * BK;
    mbar_expect_tx(full(st), L::STAGE_BYTES);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      tma_load(sk + c * L::KV_BOX, &tm_k, full(st), c * BOX, kvh, row, b);
      tma_load(sv + c * L::KV_BOX, &tm_v, full(st), c * BOX, kvh, row, b);
    }
  };

  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(bar_q + 8 * i, 1);
    for (int st = 0; st < STAGES; ++st) released[st] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::Q_BYTES);
#pragma unroll
    for (int c = 0; c < NB; ++c)
      tma_load(sq + c * L::Q_BOX, &tm_q, bar_q, c * BOX, h, q_lo, b);
    for (int t = 0; t < STAGES && t < n_t; ++t) load_kv(t, t);
  }

  // this thread's two rows of the warpgroup's 64, and its column pair in
  // each group of 8 columns of a wgmma fragment
  const int r0 = w_lo + warp * 16 + lane / 4, r1 = r0 + 8;
  const int cq = 2 * (lane % 4);

  float acc[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_t; ++j) {
    const int stage = j % STAGES;
    const int k_lo = (kt_begin + j) * BK;
    const uint32_t sk = stage_k(stage), sv = sk + L::KV_BYTES;
    mbar_wait(full(stage), (j / STAGES) & 1);

    // a tile that this warpgroup's rows cannot see at all (past its
    // diagonal or its window, or rows past S) costs it nothing
    const bool live = w_lo < S && (!causal || k_lo <= w_hi)
                      && (window <= 0 || w_lo - (k_lo + BK - 1) < window);
    if (live) {
      // S = Q K^T, K-major A and B; a k16 step advances 32 bytes inside a
      // swizzled row, a box is a separate region
      float s[SN];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < QK_STEPS; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        ScoreMma<BK>::run(
            s, make_desc(sq_w + (kk / 4) * L::Q_BOX + off, 16),
            make_desc(sk + (kk / 4) * L::KV_BOX + off, 16), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      reg_fence(s);

      // scale after the dot; the element mask only where the tile crosses the
      // diagonal, the window edge or s_valid
      const bool whole = k_lo + BK <= s_valid
                         && (!causal || k_lo + BK - 1 <= w_lo)
                         && (window <= 0 || w_hi - k_lo < window);
#pragma unroll
      for (int i = 0; i < SN; ++i) {
        float x = s[i] * scale;
        if (!whole) {
          const int qp = (i % 4) < 2 ? r0 : r1;
          const int kp = k_lo + 8 * (i / 4) + cq + (i % 2);
          bool ok = kp < s_valid;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && (qp - kp) < window;
          x = ok ? x : NEG_INF;
        }
        s[i] = x;
      }

      // online softmax on the fragment: quad shuffles for the row max
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < SN; i += 4) {
        mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float corr0 = exp2f((m0 - mx0) * LOG2E);
      const float corr1 = exp2f((m1 - mx1) * LOG2E);
      m0 = mx0;
      m1 = mx1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int i = 0; i < SN; i += 4) {
        s[i] = exp2f((s[i] - m0) * LOG2E);
        s[i + 1] = exp2f((s[i + 1] - m0) * LOG2E);
        s[i + 2] = exp2f((s[i + 2] - m1) * LOG2E);
        s[i + 3] = exp2f((s[i + 3] - m1) * LOG2E);
        ps0 += s[i] + s[i + 1];
        ps1 += s[i + 2] + s[i + 3];
      }
      l0 = l0 * corr0 + ps0;   // this thread's part of the row sum
      l1 = l1 * corr1 + ps1;
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int i = 0; i < 32; i += 4) {
          acc[c][i] *= corr0;
          acc[c][i + 1] *= corr0;
          acc[c][i + 2] *= corr1;
          acc[c][i + 3] *= corr1;
        }

      // P in bf16: k16 step kk of the PV product takes score registers
      // 8kk..8kk+7 as its four A registers
      uint32_t pa[PV_STEPS][4];
#pragma unroll
      for (int kk = 0; kk < PV_STEPS; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      // O += P V; V is MN-major: a k16 step is two 8-row groups (2048 bytes)
#pragma unroll
      for (int c = 0; c < NB; ++c) reg_fence(acc[c]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < PV_STEPS; ++kk)
#pragma unroll
        for (int c = 0; c < NB; ++c)
          wgmma_rs_n64_tb(acc[c], pa[kk],
                          make_desc(sv + c * L::KV_BOX + kk * 2 * SWIZZLE_SPAN,
                                    SWIZZLE_SPAN), 1);
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int c = 0; c < NB; ++c) reg_fence(acc[c]);
    }

    // this warp is past its reads of the stage (its wgmma groups are
    // complete); the last warp to say so refills it with tile j + STAGES
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&released[stage], 1) == L::THREADS / 32 - 1) {
        released[stage] = 0;
        __threadfence_block();
        if (j + STAGES < n_t) load_kv(stage, j + STAGES);
      }
    }
  }

  // epilogue: acc / max(l, 1e-30) in bf16, rows < S, columns < Dh
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const long long stride = (long long)H * DH;
  __nv_bfloat16* ob = o + (long long)b * S * stride + (long long)h * DH;
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = c * BOX + 8 * i + cq;
      if (col >= DH) continue;
      if (r0 < S)
        *reinterpret_cast<uint32_t*>(ob + r0 * stride + col) =
            pack_bf16(acc[c][4 * i] / d0, acc[c][4 * i + 1] / d0);
      if (r1 < S)
        *reinterpret_cast<uint32_t*>(ob + r1 * stride + col) =
            pack_bf16(acc[c][4 * i + 2] / d1, acc[c][4 * i + 3] / d1);
    }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and the launch
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: fetched once through the
// runtime, so the library needs no -lcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// 4-D map over a contiguous (B, S, heads, Dh) bf16 tensor, innermost first,
// read in boxes of 64 columns x 1 head x ``rows`` rows x 1 batch
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B,
              int S, int heads, int dh, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)dh * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {(cuuint32_t)BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KV, int causal, int window,
                   int s_valid, float scale, cudaStream_t stream) {
  using L = Layout<DH>;
  if (H > 65535 || B > 65535) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<cudaError_t>(ERR_NO_ENCODE);
  CUtensorMap mq, mk, mv;
  if (!make_map(encode, &mq, q, B, S, H, DH, L::BQ)
      || !make_map(encode, &mk, k, B, S, KV, DH, L::BK)
      || !make_map(encode, &mv, v, B, S, KV, DH, L::BK))
    return static_cast<cudaError_t>(ERR_TENSOR_MAP);
  // set on every launch: the attribute belongs to the current device
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_tc<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (attr != cudaSuccess) return attr;
  const long long blocks = (long long)((S + L::BQ - 1) / L::BQ) * H * B;
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  flash_fwd_tc<DH><<<grid, L::THREADS, L::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), B, S, H, KV, causal,
      window, s_valid, scale);
  return cudaGetLastError();
}

}  // namespace tc

cudaError_t dispatch(bool bf16, const void* q, const void* k, const void* v,
                     void* o, int B, int S, int H, int KV, int Dh, int causal,
                     int window, int s_valid, float scale, cudaStream_t st) {
#define FLASH_CASE(D)                                                       \
  case D:                                                                   \
    return bf16 ? tc::launch<D>(q, k, v, o, B, S, H, KV, causal, window,   \
                                s_valid, scale, st)                         \
                : simt::launch<D>(q, k, v, o, B, S, H, KV, causal, window,  \
                                 s_valid, scale, st);
  switch (Dh) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

// C entry, bound with ctypes. bf16 runs the tensor-core kernel, f32 the FMA
// kernel. Returns the cudaError_t of the launch (0 when it was accepted) or
// one of this file's own codes (ERR_*); the wrapper raises on anything but 0.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int S, int H, int KV,
                                   int Dh, int is_bf16, int causal, int window,
                                   int s_valid, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)Dh));
  return dispatch(is_bf16 != 0, q, k, v, o, B, S, H, KV, Dh, causal, window,
                  s_valid, scale, static_cast<cudaStream_t>(stream));
}
