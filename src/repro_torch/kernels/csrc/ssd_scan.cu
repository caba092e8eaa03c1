// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a),
// written by hand in CUDA C++.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:61 `ssd_scan`
// (pallas_call :71, body `_ssd_kernel` :22).  For each (batch, head), over
// chunks of L tokens, with cum = cumsum(dt * A) inside the chunk and the
// (P, N) f32 state S carried from chunk to chunk:
//   y[l]  = sum_{s <= l} (C_l . B_s) exp(cum_l - cum_s) dt_s x_s     (intra)
//         + exp(cum_l) C_l . S                                        (inter)
//   S'    = exp(cum_last) S + sum_s exp(cum_last - cum_s) dt_s x_s B_s^T
// in the segment-difference form of `_ssd_kernel` :35-52, so exp() never
// sees a sum that grows over the chunk.  Inputs: x (B,S,H,P), dt (B,S,H)
// f32, A (H,) f32, Bm/Cm (B,S,G,N) with head h reading group h / (H/G);
// x, Bm, Cm f32 or bf16, contiguous.  Outputs: y (B,S,H,P) in x's type
// and the final state (B,H,P,N) f32; on request the f32 state at each
// chunk's start (B, S/L, H, P, N), which the backward (ssd_scan_bwd.cu)
// reuses.  S is a multiple of L; the caller pads with dt = 0, which is
// state-exact.  Unlike the TPU kernel, B and C stay grouped (its wrapper
// broadcasts them to every head, 64 copies at G = 1) and L is any length
// up to 256.
//
// What bounds it on the H100, at mamba2-1.3b's prefill (B8 S2048 H64 P64
// N128 G1 L256, bf16).  Bytes: x, y, B, C, dt and the final state once,
// about 297 MB, 0.089 ms at 3.35 TB/s.  Operations: the causal half of
// C B^T once per (b, group, chunk) (L(L+1) N), of the scores times x per
// head (L(L+1) P), and 4 L P N per head for the chunk state and the
// inter-chunk output: about 52 GFLOP, 0.053 ms at 989 TFLOP/s.  Bound by
// bytes.
//
// What the design does about it (bf16): three passes, so the grid is
// (b, h, chunk) wide rather than one block per (b, h) walking its chunks.
//  1. `chunk_state_wgmma` (ssd_common.cuh): each chunk's own state
//     sum_s x_s (w_s B_s)^T on wgmma, x exact as the MN-major A, B scaled
//     by w_s = exp(cum_last - cum_s) dt_s in shared memory as the one
//     rounded operand; tiles by TMA.
//  2. `state_scan`: the f32 scan of the states across chunks, in place,
//     which leaves each chunk's start state (kept for the backward), its
//     bf16 hi + lo split and the final state.
//  3. `chunk_out_wgmma`: per (b, chunk, 64-row l tile, slice of HS heads
//     of one group) C B^T is computed once on wgmma and kept in shared
//     memory; for each head of the slice it is decayed, masked and scaled
//     by dt_s in registers, rounded to bf16 once (the score side, as P in
//     the attention kernels) and multiplied with x (exact, by TMA) as a
//     register-A wgmma, after the inter-chunk term C (S_hi + S_lo), which
//     keeps S to about 2^-16 and is scaled by exp(cum_l) per row.  The
//     next head's x and state tiles load by TMA while this one computes.
// The f32 route keeps the CUDA-core kernel `ssd_kernel` below (one block
// per (b, h) walking the chunks in f32; wgmma takes f32 only as TF32),
// which writes the state it carries at each chunk's start when the start
// states are wanted.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace {

using ssd::MAX_CHUNK;
using ssd::TL;                  // tokens per tile (query rows, key rows)
using ssd::put;
using ssd::to_f;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
static_assert(MAX_CHUNK <= THREADS, "the decay scan takes one token a thread");

// shared memory, in floats; rows padded by one so that 16 threads reading
// one column of 16 different rows hit 16 banks
template <int P, int N>
struct Smem {
  static constexpr int NS = N + 1, PS = P + 1, MS = TL + 1;
  static constexpr int St = 0;                    // [P][NS] chunk-start state
  static constexpr int Cq = St + P * NS;          // [TL][NS] C, query tile
  static constexpr int Bk = Cq + TL * NS;         // [TL][NS] B, key tile
  static constexpr int Xk = Bk + TL * NS;         // [TL][PS] x, key tile
  static constexpr int Mt = Xk + TL * PS;         // [TL][MS] decayed scores
  static constexpr int Cum = Mt + TL * MS;        // [MAX_CHUNK]
  static constexpr int Dt = Cum + MAX_CHUNK;      // [MAX_CHUNK]
  static constexpr int W = Dt + MAX_CHUNK;        // [TL] state-update weights
  static constexpr int Wsum = W + TL;             // [WARPS] scan partials
  static constexpr int total = Wsum + WARPS;
  static constexpr size_t bytes = total * sizeof(float);
};

// the first TL rows of a (tokens, cols) slab with row stride `stride` into
// dst[TL][cols + 1]; rows at or past `nrows` are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long stride, int cols, int nrows) {
  for (int e = threadIdx.x; e < TL * cols; e += THREADS) {
    const int r = e / cols, c = e - r * cols;
    dst[r * (cols + 1) + c] = r < nrows ? to_f(src[r * stride + c]) : 0.f;
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y,
           float* __restrict__ final_state, float* __restrict__ starts,
           int S, int H, int G, int L) {
  using SM = Smem<P, N>;
  constexpr int NS = SM::NS, PS = SM::PS, MS = SM::MS;
  constexpr int PJ = P / 16;    // output columns (p) per thread
  constexpr int SA = P / 16;    // state rows (p) per thread
  constexpr int SJ = N / 16;    // state columns (n) per thread
  extern __shared__ float sm[];
  float* St = sm + SM::St;
  float* Cq = sm + SM::Cq;
  float* Bk = sm + SM::Bk;
  float* Xk = sm + SM::Xk;
  float* Mt = sm + SM::Mt;
  float* Cum = sm + SM::Cum;
  float* Dts = sm + SM::Dt;
  float* Ws = sm + SM::W;
  float* Wsum = sm + SM::Wsum;

  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / G);
  const float a = A[h];
  const long xs = (long)H * P;  // token stride of x and y
  const long bs = (long)G * N;  // token stride of B and C
  const T* xb = x + (long)b * S * xs + (long)h * P;
  T* yb = y + (long)b * S * xs + (long)h * P;
  const float* dtb = dt + (long)b * S * H + h;
  const T* Bb = Bm + (long)b * S * bs + (long)g * N;
  const T* Cb = Cm + (long)b * S * bs + (long)g * N;

  for (int e = tid; e < P * N; e += THREADS) St[(e / N) * NS + e % N] = 0.f;

  for (int c0 = 0; c0 < S; c0 += L) {
    // dt and the cumulative log-decay of this chunk: a block-wide
    // inclusive scan, one token per thread
    __syncthreads();            // the previous chunk is done with smem
    if (starts != nullptr) {    // this chunk's start state, for the backward
      float* dst = starts + (((long)b * (S / L) + c0 / L) * H + h) * P * N;
      for (int e = tid; e < P * N; e += THREADS)
        dst[e] = St[(e / N) * NS + e % N];
    }
    {
      const float v0 = tid < L ? dtb[(long)(c0 + tid) * H] : 0.f;
      if (tid < L) Dts[tid] = v0;
      float v = v0 * a;
      const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += o;
      }
      if (lane == 31) Wsum[warp] = v;
      __syncthreads();
      float pre = 0.f;
      for (int w = 0; w < warp; ++w) pre += Wsum[w];
      if (tid < L) Cum[tid] = pre + v;
    }
    __syncthreads();
    const float cum_last = Cum[L - 1];

    // ---- outputs, one query tile at a time
    for (int q0 = 0; q0 < L; q0 += TL) {
      __syncthreads();          // Cq is free
      load_tile(Cq, Cb + (long)(c0 + q0) * bs, bs, N, min(TL, L - q0));
      __syncthreads();
      // inter-chunk term: exp(cum_l) * C_l . S[p]
      float acc[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cq[(rg * 4 + i) * NS + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) sv[j] = St[(cg + 16 * j) * NS + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] += cv[i] * sv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = q0 + rg * 4 + i;
        const float dec = l < L ? expf(Cum[l]) : 0.f;
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] *= dec;
      }
      // intra-chunk term over the key tiles at or before this one
      for (int k0 = 0; k0 <= q0; k0 += TL) {
        const int nk = min(TL, L - k0);
        __syncthreads();        // Bk, Xk and Mt are free
        load_tile(Bk, Bb + (long)(c0 + k0) * bs, bs, N, nk);
        load_tile(Xk, xb + (long)(c0 + k0) * xs, xs, P, nk);
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cq[(rg * 4 + i) * NS + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bk[(cg + 16 * j) * NS + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] += cv[i] * bv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = q0 + rg * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = k0 + cg + 16 * j;
            float m = 0.f;
            if (s <= l && l < L)
              m = sc[i][j] * expf(Cum[l] - Cum[s]) * Dts[s];
            Mt[(rg * 4 + i) * MS + cg + 16 * j] = m;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int s = 0; s < TL; ++s) {
          float mv[4], xv[PJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) mv[i] = Mt[(rg * 4 + i) * MS + s];
#pragma unroll
          for (int j = 0; j < PJ; ++j) xv[j] = Xk[s * PS + cg + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j) acc[i][j] += mv[i] * xv[j];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = q0 + rg * 4 + i;
        if (l < L) {
#pragma unroll
          for (int j = 0; j < PJ; ++j)
            put(&yb[(long)(c0 + l) * xs + cg + 16 * j], acc[i][j]);
        }
      }
    }

    // ---- state update over the chunk's key tiles, in registers
    float st[SA][SJ];
    const float chunk_decay = expf(cum_last);
#pragma unroll
    for (int i = 0; i < SA; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j)
        st[i][j] = chunk_decay * St[(rg * SA + i) * NS + cg + 16 * j];
    for (int k0 = 0; k0 < L; k0 += TL) {
      const int nk = min(TL, L - k0);
      __syncthreads();          // Bk, Xk and Ws are free
      load_tile(Bk, Bb + (long)(c0 + k0) * bs, bs, N, nk);
      load_tile(Xk, xb + (long)(c0 + k0) * xs, xs, P, nk);
      if (tid < TL)
        Ws[tid] = tid < nk ? expf(cum_last - Cum[k0 + tid]) * Dts[k0 + tid]
                           : 0.f;
      __syncthreads();
      for (int s = 0; s < nk; ++s) {
        const float w = Ws[s];
        float xv[SA], bv[SJ];
#pragma unroll
        for (int i = 0; i < SA; ++i) xv[i] = Xk[s * PS + rg * SA + i] * w;
#pragma unroll
        for (int j = 0; j < SJ; ++j) bv[j] = Bk[s * NS + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < SA; ++i)
#pragma unroll
          for (int j = 0; j < SJ; ++j) st[i][j] += xv[i] * bv[j];
      }
    }
    __syncthreads();            // every thread has read the old state
#pragma unroll
    for (int i = 0; i < SA; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j)
        St[(rg * SA + i) * NS + cg + 16 * j] = st[i][j];
  }
  __syncthreads();
  float* fs = final_state + (long)bh * P * N;
  for (int e = tid; e < P * N; e += THREADS) fs[e] = St[(e / N) * NS + e % N];
}

// the f32 route: one block per (b, h) walking its chunks, writing each
// chunk's start state to `starts` where that is not null
template <int P, int N>
int launch_f32(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, void* y, void* state, float* starts,
               int batch, int S, int H, int G, int L, cudaStream_t st) {
  const size_t smem = Smem<P, N>::bytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_kernel<float, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  ssd_kernel<float, P, N><<<batch * H, THREADS, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(state), starts, S, H, G, L);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// pass 3 (bf16): the chunks' outputs on wgmma
// ---------------------------------------------------------------------------
template <int P, int N>
struct OutPlan {
  using CT = hopper::RowTile<N, ssd::TL>;  // the C tile and each B s-tile
  using XT = hopper::RowTile<P, ssd::TL>;  // one s-tile of x
  using ST = hopper::RowTile<N, P>;        // S hi or lo (P rows)
  static constexpr int NST = ssd::MAX_CHUNK / ssd::TL;
  static constexpr int XBYTES = NST * XT::BYTES;
  static constexpr int CD = 2 * ssd::MAX_CHUNK * 4;   // cum, dt of a head
  static constexpr int BUF0 = (XBYTES + 2 * ST::BYTES + CD + 1023) / 1024 *
                              1024;
  // one head's x, state and cum/dt; the second also holds the B tiles
  // before the first head starts
  static constexpr int BUF = BUF0 > NST * CT::BYTES ? BUF0 : NST * CT::BYTES;
  static constexpr int CB = NST * 32 * 128;   // floats: C B^T, per thread
  static constexpr size_t SMEM = 1024 + CT::BYTES + 2 * BUF + CB * 4 + 3 * 8;
  static_assert(SMEM <= 232448, "fits a block's shared memory");
};

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(hopper::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(hopper::smem_u32(bar))
      : "memory");
}

// one thread: head h's x s-tiles, after the first chunk its start
// state's hi and lo halves, and its cum and dt, into one buffer
// completing on `bar`
template <int P, int N>
__device__ __forceinline__ void load_head(const CUtensorMap* tm_x,
                                          const CUtensorMap* tm_hi,
                                          const CUtensorMap* tm_lo,
                                          const float* cumdt, uint8_t* buf,
                                          uint64_t* bar, int h, int c,
                                          int nc, int b, int H, int nst,
                                          int L) {
  using PL = OutPlan<P, N>;
  using XT = typename PL::XT;
  using ST = typename PL::ST;
  const int row = (b * nc + c) * H + h;
  hopper::mbar_expect_tx(bar, nst * XT::BYTES + PL::CD +
                                  (c > 0 ? 2 * ST::BYTES : 0));
  for (int j = 0; j < nst; ++j)
    hopper::tma_load_4d(buf + j * XT::BYTES, tm_x, bar, 0, h,
                        c * L + j * ssd::TL, b);
  if (c > 0) {
    for (int q = 0; q < ST::NB; ++q) {
      hopper::tma_load_4d(buf + PL::XBYTES + q * ST::BOX, tm_hi, bar,
                          q * ST::DB, 0, 0, row);
      hopper::tma_load_4d(buf + PL::XBYTES + ST::BYTES + q * ST::BOX, tm_lo,
                          bar, q * ST::DB, 0, 0, row);
    }
  }
  bulk_load(buf + PL::XBYTES + 2 * ST::BYTES, cumdt + (long)row * 2 *
            ssd::MAX_CHUNK, PL::CD, bar);
}

// Block (l tile and head slice, chunk, batch), two warpgroups.  Both
// compute C B^T for the slice (alternate s tiles), then take the slice's
// heads in turns, each from its own buffer: while one computes a head,
// the other's next head loads.  Accumulator element e of a thread sits at
// row r + 8 ((e / 2) % 2), column 8 (e / 4) + 2 (t % 4) + e % 2, with
// r = 16 (t / 32) + (t % 32) / 4 and t its index in the warpgroup
// (csrc/hopper.cuh, WgmmaSS).
template <int P, int N>
__global__ void __launch_bounds__(256)
chunk_out_wgmma(const __grid_constant__ CUtensorMap tm_c,
                const __grid_constant__ CUtensorMap tm_b,
                const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_hi,
                const __grid_constant__ CUtensorMap tm_lo,
                const float* __restrict__ cumdt,
                __nv_bfloat16* __restrict__ y, int S, int H, int G, int L,
                int HS) {
  using PL = OutPlan<P, N>;
  using CT = typename PL::CT;
  using XT = typename PL::XT;
  using ST = typename PL::ST;
  constexpr int TL = ssd::TL;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align1024(smem_raw);
  uint8_t* ct = sm;
  uint8_t* bufs[2] = {ct + CT::BYTES, ct + CT::BYTES + PL::BUF};
  float* cbs = reinterpret_cast<float*>(bufs[1] + PL::BUF);
  uint64_t* bars = reinterpret_cast<uint64_t*>(cbs + PL::CB);  // C+B, 2 bufs

  const int nlt = (L + TL - 1) / TL;
  const int lt = nlt - 1 - (int)(blockIdx.x % nlt);   // long tiles first
  const int h0 = (blockIdx.x / nlt) * HS;
  const int c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y;
  const int g = h0 / (H / G);
  const int l0 = lt * TL;
  const int lend = min(L, l0 + TL);      // the tile reads tokens s < lend
  const int nst = (lend + TL - 1) / TL;
  const int c0 = c * L;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(&bars[0], (1 + nst) * CT::BYTES);
    for (int q = 0; q < CT::NB; ++q) {
      hopper::tma_load_4d(ct + q * CT::BOX, &tm_c, &bars[0], q * CT::DB, g,
                          c0 + l0, b);
      for (int j = 0; j < nst; ++j)
        hopper::tma_load_4d(bufs[1] + j * CT::BYTES + q * CT::BOX, &tm_b,
                            &bars[0], q * CT::DB, g, c0 + j * TL, b);
    }
    load_head<P, N>(&tm_x, &tm_hi, &tm_lo, cumdt, bufs[0], &bars[1], h0, c,
                    nc, b, H, nst, L);
  }

  // C B^T once for the slice, one 64-column s tile at a time, kept in
  // shared memory in the accumulator's own order (conflict-free)
  hopper::mbar_wait(&bars[0], 0);
  for (int j = wg; j < nst; j += 2) {
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    hopper::fence_regs<32>(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      hopper::WgmmaSS<64, 0, 0>::run(acc, CT::kmajor(ct, kk),
                                     CT::kmajor(bufs[1] + j * CT::BYTES, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<32>(acc);
#pragma unroll
    for (int e = 0; e < 32; ++e) cbs[(j * 32 + e) * 128 + t] = acc[e];
  }
  __syncthreads();              // C B^T is whole; the B tiles are free
  if (threadIdx.x == 128 && HS > 1)
    load_head<P, N>(&tm_x, &tm_hi, &tm_lo, cumdt, bufs[1], &bars[2], h0 + 1,
                    c, nc, b, H, nst, L);

  uint8_t* buf = bufs[wg];
  const float* cum = reinterpret_cast<const float*>(buf + PL::XBYTES +
                                                    2 * ST::BYTES);
  const float* dts = cum + ssd::MAX_CHUNK;
  const int r = 16 * (t / 32) + (t % 32) / 4, cq = 2 * (t % 4);
  for (int i = wg; i < HS; i += 2) {
    const int h = h0 + i;
    hopper::mbar_wait(&bars[1 + wg], (i >> 1) & 1);

    float yacc[P / 2];
#pragma unroll
    for (int e = 0; e < P / 2; ++e) yacc[e] = 0.f;
    if (c > 0) {
      // inter-chunk: exp(cum_l) C_l (S_hi + S_lo)
      hopper::fence_regs<P / 2>(yacc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        hopper::WgmmaSS<P, 0, 0>::run(yacc, CT::kmajor(ct, kk),
                                      ST::kmajor(buf + PL::XBYTES, kk));
        hopper::WgmmaSS<P, 0, 0>::run(
            yacc, CT::kmajor(ct, kk),
            ST::kmajor(buf + PL::XBYTES + ST::BYTES, kk));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<P / 2>(yacc);
#pragma unroll
      for (int e = 0; e < P / 2; ++e) {
        const int l = l0 + r + 8 * ((e >> 1) & 1);
        yacc[e] *= l < L ? expf(cum[l]) : 0.f;
      }
    }
    // intra-chunk: (C B^T o exp(cum_l - cum_s) dt_s, s <= l) x
    for (int j = 0; j < nst; ++j) {
      float m[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int l = l0 + r + 8 * ((e >> 1) & 1);
        const int s = j * TL + 8 * (e >> 2) + cq + (e & 1);
        m[e] = (s <= l && l < L)
                   ? cbs[(j * 32 + e) * 128 + t] * expf(cum[l] - cum[s]) *
                         dts[s]
                   : 0.f;
      }
      uint32_t a[TL / 16][4];
      hopper::to_a_fragments<TL>(m, a);
      hopper::fence_regs<P / 2>(yacc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TL / 16; ++kk)
        hopper::WgmmaRS<P, 1>::run(yacc, a[kk],
                                   XT::mnmajor(buf + j * XT::BYTES, kk));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<P / 2>(yacc);
    }
    // y rows of this head, bf16 pairs along p
    __nv_bfloat16* yb = y + ((long)b * S + c0) * H * P + (long)h * P;
#pragma unroll
    for (int e = 0; e < P / 2; e += 2) {
      const int l = l0 + r + 8 * ((e >> 1) & 1);
      const int p = 8 * (e >> 2) + cq;
      if (l < L)
        *reinterpret_cast<__nv_bfloat162*>(yb + (long)l * H * P + p) =
            __floats2bfloat162_rn(yacc[e], yacc[e + 1]);
    }
    // this warpgroup is done with its buffer: load its next head
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    if (t == 0 && i + 2 < HS)
      load_head<P, N>(&tm_x, &tm_hi, &tm_lo, cumdt, buf, &bars[1 + wg],
                      h + 2, c, nc, b, H, nst, L);
  }
}

// the state tensor map of (B * nc * H, P, N) bf16: one head's P rows
inline int encode_state(CUtensorMap* map, const void* base, int rows, int P,
                        int N) {
  return hopper::encode_bshd(map, base, rows, P, 1, N, P);
}

// heads per block of the output pass: all of one group, at most 8, fewer
// where the grid would fill the card less than twice
inline int heads_per_block(int B, int nc, int H, int G, int nlt) {
  const long tiles = (long)B * nc * nlt * H;
  for (int hs = 8; hs > 1; hs >>= 1)
    if ((H / G) % hs == 0 && tiles / hs >= 264) return hs;
  return 1;
}

template <int P, int N>
int launch_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, void* y, void* final_state, float* states,
                void* hilo, float* cum_last, float* cumdt, int keep, int B,
                int S, int H, int G, int L, cudaStream_t st) {
  using PL = OutPlan<P, N>;
  const int nc = S / L, PN = P * N;
  const long per = (long)B * nc * H * PN;
  __nv_bfloat16* hi = static_cast<__nv_bfloat16*>(hilo);
  int rc = ssd::launch_state_wgmma<P, N, 0>(x, dt, A, Bm, states, cum_last,
                                            cumdt, B, S, H, G, L, st);
  if (rc != 0) return rc;
  rc = ssd::launch_scan<false>(states, cum_last, nullptr,
                               static_cast<float*>(final_state), hi,
                               hi + per, B, nc, H, PN, st, keep);
  if (rc != 0) return rc;
  CUtensorMap tm_c, tm_b, tm_x, tm_hi, tm_lo;
  rc = hopper::encode_bshd(&tm_c, Cm, B, S, G, N, ssd::TL);
  if (rc == 0) rc = hopper::encode_bshd(&tm_b, Bm, B, S, G, N, ssd::TL);
  if (rc == 0) rc = hopper::encode_bshd(&tm_x, x, B, S, H, P, ssd::TL);
  if (rc == 0) rc = encode_state(&tm_hi, hi, B * nc * H, P, N);
  if (rc == 0) rc = encode_state(&tm_lo, hi + per, B * nc * H, P, N);
  if (rc != 0) return rc;
  static const cudaError_t attr = cudaFuncSetAttribute(
      chunk_out_wgmma<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)PL::SMEM);
  if (attr != cudaSuccess) return attr;
  const int nlt = (L + ssd::TL - 1) / ssd::TL;
  const int hs = heads_per_block(B, nc, H, G, nlt);
  chunk_out_wgmma<P, N><<<dim3(nlt * (H / hs), nc, B), 256, PL::SMEM, st>>>(
      tm_c, tm_b, tm_x, tm_hi, tm_lo, cumdt, static_cast<__nv_bfloat16*>(y),
      S, H, G, L, hs);
  return cudaGetLastError();
}

template <int P, int N>
int run(int dtype, const void* x, const void* dt, const void* A,
        const void* Bm, const void* Cm, void* y, void* final_state,
        float* states, void* hilo, float* cum_last, float* cumdt, int keep,
        int B, int S, int H, int G, int L, cudaStream_t st) {
  if (dtype == 1)
    return launch_bf16<P, N>(x, dt, A, Bm, Cm, y, final_state, states, hilo,
                             cum_last, cumdt, keep, B, S, H, G, L, st);
  return launch_f32<P, N>(x, dt, A, Bm, Cm, y, final_state, states, B, S, H,
                          G, L, st);
}

}  // namespace

// dtype of x, Bm, Cm and y: 0 = f32, 1 = bf16 (dt, A and the states are
// f32).  head_dim P in {32, 64}, d_state N in {32, 64, 128}, 1 <= L <=
// 256, S % L == 0, H % G == 0.  Scratch from the caller: `states` (B,
// S/L, H, P, N) f32, left holding each chunk's start state when `keep`
// (bf16: always given; f32: only where the start states are wanted, else
// null); for bf16 also `cum_last` (B, S/L, H) f32, `hilo` 2 x (B, S/L,
// H, P, N) bf16 and `cumdt` (B, S/L, H, 2, 256) f32 (f32: null).
// Returns a cudaError_t (0 on success), hopper::ERR_MISALIGNED for a bf16
// input whose base is not 16-byte aligned, or hopper::ERR_TENSOR_MAP + a
// CUresult when a TMA tensor map cannot be encoded.
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, void* y, void* state,
                        void* states, void* hilo, void* cum_last,
                        void* cumdt, int batch, int S, int H, int G, int P,
                        int N, int L, int dtype, int keep, void* stream) {
  if (batch < 1 || S < 1 || H < 1 || G < 1 || H % G || L < 1 ||
      L > MAX_CHUNK || S % L || batch > 65535 || S / L > 65535)
    return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (dtype == 1 && (states == nullptr || cum_last == nullptr ||
                     hilo == nullptr || cumdt == nullptr))
    return cudaErrorInvalidValue;
  if (dtype == 1 && !(hopper::aligned16(x) && hopper::aligned16(Bm) &&
                      hopper::aligned16(Cm) && hopper::aligned16(hilo) &&
                      hopper::aligned16(cumdt)))
    return hopper::ERR_MISALIGNED;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sts = static_cast<float*>(states);
  float* cl = static_cast<float*>(cum_last);
  float* cd = static_cast<float*>(cumdt);
#define SSD_CASE(PP, NN)                                                   \
  if (P == PP && N == NN)                                                  \
    return run<PP, NN>(dtype, x, dt, A, Bm, Cm, y, state, sts, hilo, cl,    \
                       cd, keep, batch, S, H, G, L, st);
  SSD_CASE(32, 32)
  SSD_CASE(32, 64)
  SSD_CASE(32, 128)
  SSD_CASE(64, 32)
  SSD_CASE(64, 64)
  SSD_CASE(64, 128)
#undef SSD_CASE
  return cudaErrorInvalidValue;
}
