// WKV6 recurrence (RWKV-6 time mix) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6_scan.py::wkv6_kernel (:89, body _wkv6_kernel :38)
// and computes the same function, per (batch, head) with state S (hs x hs):
//   y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
// from s0, returning every y_t and the final state, all in f32. This is the
// model's own step recurrence (src/repro/models/rwkv6.py::_wkv_scan) in
// direct products: the TPU kernel's chunked log-space form exists for its
// matrix unit and is not carried over, so decays near 0 and near 1 stay
// exact.
//
// Layout: r, k, v, w, y are contiguous (B, T, H, hs) tensors read and
// written in place (offset ((b*T + t)*H + h)*hs + i): no transpose, no
// padding of T. u is (H, hs); s0 and s_final are (B, H, hs, hs), row i,
// column j. r, k, v, w need 16-byte-aligned base addresses (TMA).
//
// The bonus term factors out of the sum over rows:
//   y_t[j] = sum_i r_i S_ij + v_j c_t,   c_t = sum_i r_i u_i k_i,
// so a step costs three FP instructions per state element (the y FMA, the
// k_i v_j product and the decay FMA) instead of four.
//
// Two kernels; the C entry picks one from T, and a call is one launch:
//
// * wkv6_chunked (T > DECODE_MAX_T). One block per (b, h) walks T; S lives in
//   registers as a GEMM accumulator does: each thread owns a tile of RI rows x
//   CJ columns (8 x 2 at hs = 64: 256 threads, two warps on each of the SM's
//   four schedulers), so a step reads its rows' r, k, w and its columns' v
//   with 128- and 64-bit shared loads (7 loads for 48 FP instructions; an
//   earlier version with one state column a thread read 65 words for 64), and
//   the next step's operands are loaded before this step's partials are
//   stored, so their latency hides behind a step of FMAs. r, k, v and w arrive
//   by TMA (3-D tensor maps over (H*hs, T, B), boxes of hs x CH steps x 1, so
//   the box of a chunk past T is zero-filled and never reads the next batch
//   row) into a ring of STAGES chunks with one mbarrier each; thread 0 refills
//   a stage once the block barrier of the next chunk shows that every thread
//   is done with it, so the loads run STAGES - 1 chunks ahead. The step loop
//   stops at T: a zero-filled w would multiply the state to zero. The y
//   partials of a thread's RI rows go to shared memory each step (one store,
//   padded so that a quarter warp hits no bank twice); once per chunk, behind
//   the one barrier the chunk needs anyway, the block sums them over the row
//   groups, adds v_j c_t (c_t from each thread's four rows and a shuffle over
//   the 16 lanes of a step) and writes y with 128-bit stores. No shuffle and
//   no reduction sits on the per-step chain (summing y by shuffles every step
//   measured 1.8x slower).
// * wkv6_decode (T <= DECODE_MAX_T, the served decode step at T = 1). Moving
//   the state is the work: a grid over (b, h, 32-column group), 256 blocks
//   of 128 threads at rwkv6-7b's shape, each thread 4 rows x 4 columns
//   loaded and stored as 128 bits; y and c_t are summed over rows in the
//   thread, by shuffles, then over warps through shared memory.
//
// Bound at rwkv6-7b's prefill shape (B=2, T=1024, H=64, hs=64): the bytes
// are r, k, v, w read once (134 MB), y written once (33.6 MB) and the
// state read and written (4.2 MB): 172 MB, 51 us at 3.35 TB/s. The work is
// 3 instructions per (t, i, j), 1.6 G FP32 instructions: 54 us at the
// issue rate of the 128 SMs that the 128 (b, h) blocks occupy, so this
// kernel is bound by FP issue about as much as by bytes. Decode at (B=2,
// T=1, H=64, hs=64): 4.2 MB of state, 1.3 us.
// Measured by chip_smoke.py on an "NVIDIA H100 80GB HBM3, 700.00 W" card
// (PERF.md, kernel table row 4): prefill 0.118 ms, 43% of the bound (the
// one-column version: 0.418 ms); decode 0.0029 ms (0.0033).

#include "tma.cuh"

namespace {

constexpr int CH = 16;           // time steps per staged chunk
constexpr int STAGES = 4;        // chunks in the ring
constexpr int DECODE_MAX_T = 4;  // T up to this runs wkv6_decode

// the state tile of one thread: RI rows x CJ columns
template <int HS> struct Tile;
template <> struct Tile<16> { static constexpr int RI = 4, CJ = 2; };
template <> struct Tile<32> { static constexpr int RI = 8, CJ = 4; };
template <> struct Tile<64> { static constexpr int RI = 8, CJ = 2; };

template <int HS>
struct Layout {
  static constexpr int RI = Tile<HS>::RI, CJ = Tile<HS>::CJ;
  static constexpr int RG = HS / RI;          // row groups
  static constexpr int CGW = 32 / RG;         // column groups in a warp
  static constexpr int NT = RG * (HS / CJ);   // threads
  static constexpr int NQ = HS / 4;           // column quads of y
  static constexpr int BOX = CH * HS * 4;     // bytes of one tensor's chunk
  static constexpr int STAGE = 4 * BOX;       // r, k, v, w
  // a row group's partial y row, padded by the floats that one row group
  // of a warp stores (CGW * CJ), so that the row groups of a quarter warp
  // store to different banks
  static constexpr int YSTRIDE = HS + CGW * CJ;
  static constexpr int YBUF = CH * RG * YSTRIDE * 4;
  static constexpr int OFF_Y = STAGES * STAGE;
  static constexpr int OFF_BAR = OFF_Y + 2 * YBUF;
  static constexpr int SMEM = OFF_BAR + 8 * STAGES + 128;   // + alignment
  static_assert(32 % RG == 0 && NT % 32 == 0, "row groups must tile a warp");
  static_assert(NT % NQ == 0 && CH % (NT / NQ) == 0, "y pass must tile CH");
  static_assert(SMEM <= 232448, "over the 227 KB a block may use");
};

// N floats from 16-byte- (N % 4 == 0) or 8-byte-aligned memory, shared or
// global, as 128- or 64-bit loads
template <int N>
__device__ __forceinline__ void lds(float (&d)[N], const float* p) {
  static_assert(N % 2 == 0, "128- or 64-bit loads");
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      d[4 * q] = x.x; d[4 * q + 1] = x.y; d[4 * q + 2] = x.z;
      d[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const float2 x = reinterpret_cast<const float2*>(p)[q];
      d[2 * q] = x.x; d[2 * q + 1] = x.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void sts(float* p, const float (&s)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < N / 2; ++q)
      reinterpret_cast<float2*>(p)[q] = make_float2(s[2 * q], s[2 * q + 1]);
  }
}

// ---------------------------------------------------------------------------
// wkv6_chunked: one block per (b, h), the state in register tiles
// ---------------------------------------------------------------------------

template <int HS>
__global__ void __launch_bounds__(Layout<HS>::NT, 1)
wkv6_chunked(const __grid_constant__ CUtensorMap tm_r,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_w,
             const float* __restrict__ u, const float* __restrict__ s0,
             float* __restrict__ y, float* __restrict__ s_out, int T, int H) {
  using L = Layout<HS>;
  constexpr int RI = L::RI, CJ = L::CJ, RG = L::RG, CGW = L::CGW;
  constexpr int NT = L::NT, NQ = L::NQ;
  extern __shared__ unsigned char smem_raw[];
  // aligned to 128 bytes for TMA by an offset from smem_raw (not through
  // an integer cast), so the compiler keeps shared loads (LDS), not
  // generic ones
  unsigned char* smem =
      smem_raw + ((128 - (tma::smem_addr(smem_raw) & 127)) & 127);
  const uint32_t base = tma::smem_addr(smem);
  const uint32_t bars = base + L::OFF_BAR;
  // tensor x (r, k, v, w = 0..3) of stage st
  auto tile = [&](int st, int x) {
    return reinterpret_cast<const float*>(smem + st * L::STAGE + x * L::BOX);
  };
  auto ybuf = [&](int c) {
    return reinterpret_cast<float*>(smem + L::OFF_Y + (c & 1) * L::YBUF);
  };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = lane / CGW, cl = lane % CGW;
  const int i0 = rg * RI, j0 = (warp * CGW + cl) * CJ;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_chunks = (T + CH - 1) / CH;

  auto load = [&](int c) {
    const int st = c % STAGES;
    const uint32_t bar = bars + 8 * st, dst = base + st * L::STAGE;
    tma::mbar_expect_tx(bar, L::STAGE);
    tma::load_3d(dst, &tm_r, bar, h * HS, c * CH, b);
    tma::load_3d(dst + L::BOX, &tm_k, bar, h * HS, c * CH, b);
    tma::load_3d(dst + 2 * L::BOX, &tm_v, bar, h * HS, c * CH, b);
    tma::load_3d(dst + 3 * L::BOX, &tm_w, bar, h * HS, c * CH, b);
  };
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) tma::mbar_init(bars + 8 * st, 1);
    tma::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < STAGES && c < n_chunks; ++c) load(c);

  // the state tile, while the first chunks are in flight
  const float* s_in = s0 + (long long)bh * HS * HS;
  float S[RI][CJ];
#pragma unroll
  for (int e = 0; e < RI; ++e) lds(S[e], s_in + (i0 + e) * HS + j0);
  // this thread's column quad in the y pass, and u on it
  const int jq = tid % NQ;
  float u4[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) u4[e] = u[h * HS + 4 * jq + e];
  const long long row = (long long)H * HS;     // stride of t in r, k, v, w, y

  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % STAGES;
    tma::mbar_wait(bars + 8 * st, (c / STAGES) & 1);
    const float *rs = tile(st, 0), *ks = tile(st, 1), *vs = tile(st, 2),
                *ws = tile(st, 3);
    float* yb = ybuf(c);
    const int n = min(CH, T - c * CH);

    // a step's operands: its rows' r, k, w and its columns' v. The next
    // step's are loaded before this step's partials are stored (two sets,
    // A and B, in turn), so their latency hides behind a step of FMAs
    struct Operands { float r[RI], k[RI], w[RI], v[CJ]; };
    auto fetch = [&](Operands& o, int tt) {
      lds(o.r, rs + tt * HS + i0);
      lds(o.k, ks + tt * HS + i0);
      lds(o.w, ws + tt * HS + i0);
      lds(o.v, vs + tt * HS + j0);
    };
    auto step = [&](const Operands& o, int tt) {
      // two partial sums per column halve the y chain
      float acc[CJ], acc2[CJ];
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) {
        acc[jj] = o.r[0] * S[0][jj];
        acc2[jj] = o.r[RI / 2] * S[RI / 2][jj];
      }
#pragma unroll
      for (int e = 1; e < RI / 2; ++e)
#pragma unroll
        for (int jj = 0; jj < CJ; ++jj) {
          acc[jj] = fmaf(o.r[e], S[e][jj], acc[jj]);
          acc2[jj] = fmaf(o.r[RI / 2 + e], S[RI / 2 + e][jj], acc2[jj]);
        }
#pragma unroll
      for (int e = 0; e < RI; ++e)
#pragma unroll
        for (int jj = 0; jj < CJ; ++jj)
          S[e][jj] = fmaf(o.w[e], S[e][jj], o.k[e] * o.v[jj]);
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) acc[jj] += acc2[jj];
      sts(yb + (tt * RG + rg) * L::YSTRIDE + j0, acc);
    };
    Operands A, B;
    fetch(A, 0);
    if (n == CH) {
#pragma unroll
      for (int tt = 0; tt < CH; tt += 2) {
        fetch(B, tt + 1);
        step(A, tt);
        if (tt + 2 < CH) fetch(A, tt + 2);
        step(B, tt + 1);
      }
    } else {
      for (int tt = 0; tt < n; tt += 2) {
        if (tt + 1 < n) fetch(B, tt + 1);
        step(A, tt);
        if (tt + 1 < n) {
          if (tt + 2 < n) fetch(A, tt + 2);
          step(B, tt + 1);
        }
      }
    }
    // every thread is done with chunk c - 1's stage (its y pass ran before
    // this barrier) and chunk c's partials are in yb
    __syncthreads();
    if (tid == 0 && c >= 1 && c - 1 + STAGES < n_chunks)
      load(c - 1 + STAGES);

    // y of chunk c: NT / NQ steps at a time, 4 columns a thread
#pragma unroll
    for (int tt = tid / NQ; tt < CH; tt += NT / NQ) {
      float r4[4], k4[4], v4[4], acc[4];
      lds(r4, rs + tt * HS + 4 * jq);
      lds(k4, ks + tt * HS + 4 * jq);
      float cpart = r4[0] * (u4[0] * k4[0]);
#pragma unroll
      for (int e = 1; e < 4; ++e) cpart = fmaf(r4[e], u4[e] * k4[e], cpart);
      // the NQ lanes of step tt are neighbours in one warp
#pragma unroll
      for (int m = 1; m < NQ; m <<= 1)
        cpart += __shfl_xor_sync(0xffffffffu, cpart, m);
      lds(acc, yb + tt * RG * L::YSTRIDE + 4 * jq);
#pragma unroll
      for (int g = 1; g < RG; ++g) {
        float p[4];
        lds(p, yb + (tt * RG + g) * L::YSTRIDE + 4 * jq);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += p[e];
      }
      lds(v4, vs + tt * HS + 4 * jq);
      if (tt < n) {
        const long long off = ((long long)b * T + c * CH + tt) * row
                              + (long long)h * HS + 4 * jq;
        *reinterpret_cast<float4*>(y + off) = make_float4(
            fmaf(v4[0], cpart, acc[0]), fmaf(v4[1], cpart, acc[1]),
            fmaf(v4[2], cpart, acc[2]), fmaf(v4[3], cpart, acc[3]));
      }
    }
  }

  float* so = s_out + (long long)bh * HS * HS;
#pragma unroll
  for (int e = 0; e < RI; ++e) sts(so + (i0 + e) * HS + j0, S[e]);
}

// ---------------------------------------------------------------------------
// wkv6_decode: a few steps; one block per (b, h, 8 columns)
// ---------------------------------------------------------------------------

constexpr int DEC_COLS = 32;     // state columns per block (up to hs)
constexpr int DEC_ROWS = 4;      // state rows per thread (at most)

template <int HS>
struct Dec {
  static constexpr int DC = DEC_COLS < HS ? DEC_COLS : HS;
  static constexpr int QPR = DC / 4;          // column quads of a row
  // rows per thread, and the row slots: a thread holds rows ii + m * RS
  static constexpr int RPT = DEC_ROWS < HS * QPR / 32 ? DEC_ROWS
                                                      : HS * QPR / 32;
  static constexpr int RS = HS / RPT;
  static constexpr int NT = RS * QPR;         // threads
  static constexpr int NW = NT / 32;          // warps
  static_assert(DC % 4 == 0 && HS % DC == 0 && HS % RPT == 0
                && NT % 32 == 0 && NT <= 1024, "decode tiling");
};

template <int HS>
__global__ void __launch_bounds__(Dec<HS>::NT)
wkv6_decode(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out, int T, int H) {
  using D = Dec<HS>;
  constexpr int QPR = D::QPR, NW = D::NW, RPT = D::RPT, RS = D::RS;
  // [step parity][warp][quad][y0..y3, c]
  __shared__ float part[2][NW][QPR][5];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ii = tid / QPR, q = tid % QPR;    // row slot, column quad
  constexpr int NG = HS / D::DC;
  const int g = blockIdx.x % NG, bh = blockIdx.x / NG;
  const int b = bh / H, h = bh % H;
  const int j0 = g * D::DC + 4 * q;
  const float* s_in = s0 + (long long)bh * HS * HS + j0;
  float4 S[RPT];
  float ui[RPT];
#pragma unroll
  for (int m = 0; m < RPT; ++m) {
    S[m] = *reinterpret_cast<const float4*>(s_in + (ii + m * RS) * HS);
    ui[m] = u[h * HS + ii + m * RS];
  }
  const long long row = (long long)H * HS;

  for (int t = 0; t < T; ++t) {
    const long long off = ((long long)b * T + t) * row + (long long)h * HS;
    float ri[RPT], ki[RPT], wi[RPT];
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      ri[m] = r[off + ii + m * RS];
      ki[m] = k[off + ii + m * RS];
      wi[m] = w[off + ii + m * RS];
    }
    const float4 vj = *reinterpret_cast<const float4*>(v + off + j0);
    float p[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      p[0] = fmaf(ri[m], S[m].x, p[0]);
      p[1] = fmaf(ri[m], S[m].y, p[1]);
      p[2] = fmaf(ri[m], S[m].z, p[2]);
      p[3] = fmaf(ri[m], S[m].w, p[3]);
      p[4] = fmaf(ri[m], ui[m] * ki[m], p[4]);
    }
    // over the row slots of this warp that share this quad
#pragma unroll
    for (int mask = QPR; mask < 32; mask <<= 1)
#pragma unroll
      for (int e = 0; e < 5; ++e)
        p[e] += __shfl_xor_sync(0xffffffffu, p[e], mask);
    if (lane < QPR)
#pragma unroll
      for (int e = 0; e < 5; ++e) part[t & 1][warp][q][e] = p[e];
    __syncthreads();
    if (tid < QPR) {      // tid == q here: this quad's y over all warps
      float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ww = 0; ww < NW; ++ww)
#pragma unroll
        for (int e = 0; e < 5; ++e) s[e] += part[t & 1][ww][tid][e];
      *reinterpret_cast<float4*>(y + off + j0) =
          make_float4(fmaf(vj.x, s[4], s[0]), fmaf(vj.y, s[4], s[1]),
                      fmaf(vj.z, s[4], s[2]), fmaf(vj.w, s[4], s[3]));
    }
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      S[m].x = fmaf(wi[m], S[m].x, ki[m] * vj.x);
      S[m].y = fmaf(wi[m], S[m].y, ki[m] * vj.y);
      S[m].z = fmaf(wi[m], S[m].z, ki[m] * vj.z);
      S[m].w = fmaf(wi[m], S[m].w, ki[m] * vj.w);
    }
  }
  float* so = s_out + (long long)bh * HS * HS + j0;
#pragma unroll
  for (int m = 0; m < RPT; ++m)
    *reinterpret_cast<float4*>(so + (ii + m * RS) * HS) = S[m];
}

// ---------------------------------------------------------------------------
// host side: tensor maps and the launches
// ---------------------------------------------------------------------------

template <int HS>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s0, float* y,
                   float* s_out, int B, int T, int H, cudaStream_t st) {
  const long long bh = (long long)B * H;
  if (T <= DECODE_MAX_T) {
    const long long blocks = bh * (HS / Dec<HS>::DC);
    if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
    wkv6_decode<HS><<<(unsigned)blocks, Dec<HS>::NT, 0, st>>>(
        r, k, v, w, u, s0, y, s_out, T, H);
    return cudaGetLastError();
  }
  using L = Layout<HS>;
  if (bh >= (1ll << 31)) return cudaErrorInvalidValue;
  const tma::EncodeTiled encode = tma::encode_tiled();
  if (encode == nullptr)
    return static_cast<cudaError_t>(tma::ERR_NO_ENCODE);
  // (H*hs, T, B) in boxes of hs x CH steps: a box past T is zero-filled
  CUtensorMap mr, mk, mv, mw;
  const long long d0 = (long long)H * HS;
  if (!tma::map_3d(encode, &mr, r, d0, T, B, HS, CH)
      || !tma::map_3d(encode, &mk, k, d0, T, B, HS, CH)
      || !tma::map_3d(encode, &mv, v, d0, T, B, HS, CH)
      || !tma::map_3d(encode, &mw, w, d0, T, B, HS, CH))
    return static_cast<cudaError_t>(tma::ERR_TENSOR_MAP);
  // set on every launch: the attribute belongs to the current device
  const cudaError_t attr = cudaFuncSetAttribute(
      wkv6_chunked<HS>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (attr != cudaSuccess) return attr;
  wkv6_chunked<HS><<<(unsigned)bh, L::NT, L::SMEM, st>>>(
      mr, mk, mv, mw, u, s0, y, s_out, T, H);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes: T <= DECODE_MAX_T runs wkv6_decode, longer T
// wkv6_chunked. Returns the cudaError_t of the launch (0 when it was
// accepted) or one of tma.cuh's own codes (ERR_*); the wrapper raises on
// anything but 0.
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

// The chunk length and the decode kernel's longest T, for the launcher's
// constants to be checked against.
extern "C" void wkv6_constants(int* chunk, int* decode_max_t) {
  *chunk = CH;
  *decode_max_t = DECODE_MAX_T;
}
