// Backward of the Mamba2 SSD chunked scan (csrc/ssd_scan.cu) for Hopper
// (sm_90a), written by hand in CUDA C++.
//
// The TPU package has no backward kernel for `ssd_scan`
// (repro/kernels/ssd_scan.py:61): its models differentiate the plain
// chunked SSD (`ssd_chunked`, repro/models/ssm.py:73).  This is the
// explicit backward of the same chunked form (kernels/ref.py,
// `ssd_scan_bwd_ref`).  For one (b, h) and chunk c, with cum, xdt_s =
// dt_s x_s, S the state at the chunk's start and dS the gradient reaching
// the state at its end:
//   dS_prev = e^{cum_L} dS + sum_l e^{cum_l} dy_l C_l^T        (reverse scan)
//   dC_l   = sum_{s<=l} (dy_l.xdt_s) e^{cum_l-cum_s} B_s + e^{cum_l} S^T dy_l
//   dB_s   = sum_{l>=s} (dy_l.xdt_s) e^{cum_l-cum_s} C_l + e^{cum_L-cum_s} dS^T xdt_s
//   dxdt_s = sum_{l>=s} (C_l.B_s) e^{cum_l-cum_s} dy_l + e^{cum_L-cum_s} dS B_s
// dx = dt dxdt; ddt_s = x_s.dxdt_s + a rc_s and dA = sum dt_s rc_s, where
// rc is the reverse cumsum of dcum: each exp term's share (+ at l, - at s;
// the state terms at the chunk's last token).
//
// Launches: (1) each chunk's own share of the state gradient (the
// forward's pass 1 with dy, C and e^{cum_l}: wgmma for bf16, CUDA cores
// for f32; ssd_common.cuh); (2) the reverse scan across chunks, seeded by
// the final state's gradient, which leaves dS per chunk; (3) the chunk
// pass, reusing the start states the forward's pass 2 kept; (4) the sums
// of each group's per-head dB and dC, in head order, and of dA over
// (b, chunk), in order.  No float atomics: two launches give the same
// bits.
//
// What bounds it on the H100.  Per (b, h, chunk) the causal halves of
// C B^T and dy xdt^T (L(L+1)(N+P) operations), their products into dC,
// dB, dxdt (L(L+1)(2N+P)) and 8 L P N for the state terms; at B4 S1024
// H64 P64 N128 L256 about 43 GFLOP on about 185 MB: bound by the bf16
// tensor-core rate (0.044 ms), by bytes within a few per cent.
//
// The chunk pass, bf16 (`chunk_bwd_l`, `chunk_bwd_s`, `chunk_dcum`): on
// wgmma, as the attention backward splits dQ from dK/dV; see the comment
// above `BwdPlan`.  f32 (`chunk_bwd`): one block per (chunk, head, batch)
// on the CUDA cores, since wgmma takes f32 only as TF32.  The L x L scores
// do not fit, so 64-token tiles: sweep 1 walks the l tiles (C_l, dy_l in
// shared memory), starts dC from the inter-chunk term and adds
// (dy.xdt o E) B over the s tiles at or before it, collecting the row and
// column sums of T = (dy.xdt)(C.B) E into dcum; sweep 2 walks the s tiles
// (B_s, xdt_s), starts dB and dxdt from the state terms and adds the l
// tiles at or after it.  256 threads, each a 4 x 4 block of a 64 x 64
// score tile and 4 rows of each output.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace {

using ssd::TL;
using ssd::to_f;
using ssd::put;
constexpr int THREADS = 256;

template <int P, int N>
struct BwdSmem {
  static constexpr int NS = N + 1, PS = P + 1, MS = TL + 1;
  static constexpr int Sm = 0;                  // [P][NS] S, then dS
  static constexpr int Ct = Sm + P * NS;        // [TL][NS] C, l tile
  static constexpr int Bt = Ct + TL * NS;       // [TL][NS] B, s tile
  static constexpr int Dy = Bt + TL * NS;       // [TL][PS] dy, l tile
  static constexpr int Xd = Dy + TL * PS;       // [TL][PS] xdt, s tile
  static constexpr int Ge = Xd + TL * PS;       // [TL][MS] (dy.xdt) E
  static constexpr int Ce = Ge + TL * MS;       // [TL][MS] (C.B) E
  static constexpr int Cp = Ce + TL * MS;       // [16][TL] column partials
  static constexpr int Cum = Cp + 16 * TL;      // [MAX_CHUNK]
  static constexpr int Dt = Cum + ssd::MAX_CHUNK;
  static constexpr int Dcum = Dt + ssd::MAX_CHUNK;
  static constexpr int Vs = Dcum + ssd::MAX_CHUNK;   // V_s
  static constexpr int Xdx = Vs + ssd::MAX_CHUNK;    // x_s . dxdt_s
  static constexpr int Red = Xdx + ssd::MAX_CHUNK;   // [16]
  static constexpr int total = Red + 16;
  static constexpr size_t bytes = total * sizeof(float);
};

// rows [r0, r0 + TL) of a (tokens, cols) slab, row stride `stride`, into
// dst[TL][cols + 1] as f32 (times w[r] when w is given); rows at or past
// nrows are zero
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long stride, int cols, int nrows,
                                          const float* w = nullptr) {
  for (int e = threadIdx.x; e < TL * cols; e += THREADS) {
    const int r = e / cols, c = e - r * cols;
    float v = r < nrows ? to_f(src[r * stride + c]) : 0.f;
    if (w != nullptr) v *= r < nrows ? w[r] : 0.f;
    dst[r * (cols + 1) + c] = v;
  }
}

// sum over the 16 threads of one row group (lanes cg = 0..15 of a half
// warp), in a fixed order
__device__ __forceinline__ float row_group_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
chunk_bwd(const T* __restrict__ x, const float* __restrict__ dt,
          const float* __restrict__ A, const T* __restrict__ Bm,
          const T* __restrict__ Cm, const T* __restrict__ dy,
          const float* __restrict__ states, const float* __restrict__ dstates,
          T* __restrict__ dx, float* __restrict__ ddt,
          float* __restrict__ dBh, float* __restrict__ dCh,
          float* __restrict__ da_part, int S, int H, int G, int L) {
  using SM = BwdSmem<P, N>;
  constexpr int NS = SM::NS, PS = SM::PS, MS = SM::MS;
  constexpr int NJ = N / 16, PJ = P / 16;
  extern __shared__ float sm[];
  float* Sm = sm + SM::Sm;
  float* Ct = sm + SM::Ct;
  float* Bt = sm + SM::Bt;
  float* Dy = sm + SM::Dy;
  float* Xd = sm + SM::Xd;
  float* Ge = sm + SM::Ge;
  float* Ce = sm + SM::Ce;
  float* Cp = sm + SM::Cp;
  float* cum = sm + SM::Cum;
  float* dts = sm + SM::Dt;
  float* dcum = sm + SM::Dcum;
  float* vs = sm + SM::Vs;
  float* xdx = sm + SM::Xdx;
  float* red = sm + SM::Red;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int g = h / (H / G);
  const int c0 = c * L;
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const float a = A[h];
  const long xs = (long)H * P, bs = (long)G * N;
  const T* xb = x + ((long)b * S + c0) * xs + (long)h * P;
  const T* dyb = dy + ((long)b * S + c0) * xs + (long)h * P;
  const T* Bb = Bm + ((long)b * S + c0) * bs + (long)g * N;
  const T* Cb = Cm + ((long)b * S + c0) * bs + (long)g * N;
  const long so = (((long)b * nc + c) * H + h) * P * N;
  const float* Sg = states + so;
  const float* dSg = dstates + so;
  const int nlt = (L + TL - 1) / TL;

  ssd::chunk_cumsum<THREADS>(dt + ((long)b * S + c0) * H + h, H, a, L, cum,
                             dts, red);
  for (int e = tid; e < ssd::MAX_CHUNK; e += THREADS) dcum[e] = 0.f;
  for (int e = tid; e < P * N; e += THREADS)
    Sm[(e / N) * NS + e % N] = Sg[e];
  __syncthreads();
  const float cum_last = cum[L - 1];

  // 64 x 64 tiles of C.B and dy.xdt at (l0 + rg 4 + i, s0 + cg + 16 j),
  // and their decay E (zero off the causal half); T's row sums into
  // dcum[l], column sums out of dcum[s] (two barriers apart: the diagonal
  // tile touches both)
  auto score_tiles = [&](int l0, int s0, bool sums) {
    float sc[4][4], gg[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = gg[i][j] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = Ct[(rg * 4 + i) * NS + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bt[(cg + 16 * j) * NS + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += cv[i] * bv[j];
    }
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      float dv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[i] = Dy[(rg * 4 + i) * PS + p];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = Xd[(cg + 16 * j) * PS + p];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) gg[i][j] += dv[i] * xv[j];
    }
    float rs[4] = {0.f, 0.f, 0.f, 0.f}, cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + cg + 16 * j;
        const float e = (s <= l && l < L) ? expf(cum[l] - cum[s]) : 0.f;
        const float ge = gg[i][j] * e;
        Ge[(rg * 4 + i) * MS + cg + 16 * j] = ge;
        Ce[(rg * 4 + i) * MS + cg + 16 * j] = sc[i][j] * e;
        const float t = ge * sc[i][j];
        rs[i] += t;
        cs[j] += t;
      }
    }
    if (sums) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = row_group_sum(rs[i]);
        const int l = l0 + rg * 4 + i;
        if (cg == 0 && l < L) dcum[l] += v;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) Cp[rg * TL + cg + 16 * j] = cs[j];
      __syncthreads();
      if (tid < TL && s0 + tid < L) {
        float v = 0.f;
        for (int k = 0; k < 16; ++k) v += Cp[k * TL + tid];
        dcum[s0 + tid] -= v;
      }
    }
    __syncthreads();
  };

  // ---- sweep 1: dC over the l tiles
  for (int lt = 0; lt < nlt; ++lt) {
    const int l0 = lt * TL, nl = min(TL, L - l0);
    __syncthreads();
    load_rows(Ct, Cb + (long)l0 * bs, bs, N, nl);
    load_rows(Dy, dyb + (long)l0 * xs, xs, P, nl);
    __syncthreads();
    // inter-chunk: e^{cum_l} S^T dy_l, and U_l = C_l . that
    float dc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) dc[i][j] = 0.f;
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      float dv[4], sv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[i] = Dy[(rg * 4 + i) * PS + p];
#pragma unroll
      for (int j = 0; j < NJ; ++j) sv[j] = Sm[p * NS + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dc[i][j] += dv[i] * sv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + rg * 4 + i;
      const float w = l < L ? expf(cum[l]) : 0.f;
      float u = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dc[i][j] *= w;
        u += dc[i][j] * Ct[(rg * 4 + i) * NS + cg + 16 * j];
      }
      u = row_group_sum(u);
      if (cg == 0 && l < L) dcum[l] += u;
    }
    for (int st = 0; st <= lt; ++st) {
      const int s0 = st * TL, ns = min(TL, L - s0);
      __syncthreads();
      load_rows(Bt, Bb + (long)s0 * bs, bs, N, ns);
      load_rows(Xd, xb + (long)s0 * xs, xs, P, ns, dts + s0);
      __syncthreads();
      score_tiles(l0, s0, true);
#pragma unroll 4
      for (int s = 0; s < TL; ++s) {
        float gv[4], bv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] = Ge[(rg * 4 + i) * MS + s];
#pragma unroll
        for (int j = 0; j < NJ; ++j) bv[j] = Bt[s * NS + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) dc[i][j] += gv[i] * bv[j];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + rg * 4 + i;
      if (l < L) {
        float* o = dCh + (((long)b * S + c0 + l) * H + h) * N;
#pragma unroll
        for (int j = 0; j < NJ; ++j) o[cg + 16 * j] = dc[i][j];
      }
    }
  }

  // ---- between the sweeps: W = e^{cum_L} <dS, S>, then dS replaces S
  __syncthreads();
  float wpart = 0.f;
  for (int e = tid; e < P * N; e += THREADS) {
    const float d = dSg[e];
    float* sp = &Sm[(e / N) * NS + e % N];
    wpart += d * *sp;
    *sp = d;
  }
  const float W = expf(cum_last) * ssd::block_sum<THREADS>(wpart, red);

  // ---- sweep 2: dB and dxdt over the s tiles
  for (int st = 0; st < nlt; ++st) {
    const int s0 = st * TL, ns = min(TL, L - s0);
    __syncthreads();
    load_rows(Bt, Bb + (long)s0 * bs, bs, N, ns);
    load_rows(Xd, xb + (long)s0 * xs, xs, P, ns, dts + s0);
    __syncthreads();
    // state terms: e^{cum_L - cum_s} dS^T xdt_s and e^{cum_L - cum_s} dS B_s
    float db[4][NJ], dxd[4][PJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) db[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < PJ; ++j) dxd[i][j] = 0.f;
    }
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      float xv[4], sv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = Xd[(rg * 4 + i) * PS + p];
#pragma unroll
      for (int j = 0; j < NJ; ++j) sv[j] = Sm[p * NS + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) db[i][j] += xv[i] * sv[j];
    }
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float bv[4], sv[PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) bv[i] = Bt[(rg * 4 + i) * NS + n];
#pragma unroll
      for (int j = 0; j < PJ; ++j) sv[j] = Sm[(cg + 16 * j) * NS + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) dxd[i][j] += bv[i] * sv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + rg * 4 + i;
      const float w = s < L ? expf(cum_last - cum[s]) : 0.f;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) db[i][j] *= w;
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        dxd[i][j] *= w;
        v += dxd[i][j] * Xd[(rg * 4 + i) * PS + cg + 16 * j];
      }
      v = row_group_sum(v);
      if (cg == 0 && s < L) vs[s] = v;
    }
    for (int lt = st; lt < nlt; ++lt) {
      const int l0 = lt * TL, nl = min(TL, L - l0);
      __syncthreads();
      load_rows(Ct, Cb + (long)l0 * bs, bs, N, nl);
      load_rows(Dy, dyb + (long)l0 * xs, xs, P, nl);
      __syncthreads();
      score_tiles(l0, s0, false);
      // rows s of this thread: columns rg 4 + i of Ge and Ce
#pragma unroll 4
      for (int l = 0; l < TL; ++l) {
        float gv[4], cv[4], ctv[NJ], dyv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          gv[i] = Ge[l * MS + rg * 4 + i];
          cv[i] = Ce[l * MS + rg * 4 + i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) ctv[j] = Ct[l * NS + cg + 16 * j];
#pragma unroll
        for (int j = 0; j < PJ; ++j) dyv[j] = Dy[l * PS + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) db[i][j] += gv[i] * ctv[j];
#pragma unroll
          for (int j = 0; j < PJ; ++j) dxd[i][j] += cv[i] * dyv[j];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + rg * 4 + i;
      float xd = 0.f;
      if (s < L) {
        float* o = dBh + (((long)b * S + c0 + s) * H + h) * N;
#pragma unroll
        for (int j = 0; j < NJ; ++j) o[cg + 16 * j] = db[i][j];
        T* dxo = dx + ((long)b * S + c0 + s) * xs + (long)h * P;
        const T* xr = xb + (long)s * xs;
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int p = cg + 16 * j;
          put(&dxo[p], dts[s] * dxd[i][j]);
          xd += to_f(xr[p]) * dxd[i][j];
        }
      }
      xd = row_group_sum(xd);
      if (cg == 0 && s < L) xdx[s] = xd;
    }
  }

  // ---- dcum's state terms, then ddt and dA through the reverse cumsum
  __syncthreads();
  for (int s = tid; s < L; s += THREADS) dcum[s] -= vs[s];
  __syncthreads();
  if (tid == 0) {
    float v = W;
    for (int s = 0; s < L; ++s) v += vs[s];
    dcum[L - 1] += v;
  }
  __syncthreads();
  const int j = L - 1 - tid;                    // reversed: one token each
  const float rc = ssd::block_scan<THREADS>(j >= 0 ? dcum[j] : 0.f, red);
  float dap = 0.f;
  if (j >= 0) {
    ddt[((long)b * S + c0 + j) * H + h] = xdx[j] + a * rc;
    dap = dts[j] * rc;
  }
  const float da = ssd::block_sum<THREADS>(dap, red);
  if (tid == 0) da_part[((long)b * nc + c) * H + h] = da;
}

// ---------------------------------------------------------------------------
// bf16: the chunk pass on wgmma
// ---------------------------------------------------------------------------
// Two kernels, one block (a warpgroup) per (64-token tile, head, batch x
// chunk), as the attention backward splits dK/dV from dQ:
//  * `chunk_bwd_l` owns an l tile: dC_l = e^{cum_l} dy_l S (S as bf16
//    hi + lo) + sum_{s <= l} GE_ls B_s, and the row sums of T into dcum_l
//    (plus U_l = C_l . the first term);
//  * `chunk_bwd_s` owns an s tile: dB_s and dxdt_s from their state
//    terms (dS as hi + lo) plus sum_{l >= s} GE_ls C_l and CBE_ls dy_l, the
//    column sums of T and V_s out of dcum_s, dx, and x_s . dxdt_s;
// where G'_ls = dy_l . x_s and C_l . B_s come from wgmma in f32 (x, dy, B,
// C exact), GE = G' dt_s e^{cum_l - cum_s} and CBE = C.B e^{cum_l - cum_s}
// (masked to s <= l) are rounded to bf16 once as register A operands, as
// P and dS in the attention backward.  `chunk_dcum` then adds the pieces
// of dcum per (b, h, chunk), with W = e^{cum_L} <dS, S>, and writes ddt and
// the dA partial.  Tiles by TMA: the block's own tiles once, the other
// side's through a ring of two stages (110 KB at P64 N128: 2 blocks an
// SM).
template <int P, int N>
struct BwdPlan {
  using NT = hopper::RowTile<N, TL>;   // B and C tiles
  using PT = hopper::RowTile<P, TL>;   // x and dy tiles
  using ST = hopper::RowTile<N, P>;    // S or dS, hi or lo
  static constexpr int FIX = NT::BYTES + PT::BYTES + 2 * ST::BYTES;
  static constexpr int STAGE = NT::BYTES + PT::BYTES;
  static constexpr int CD = 2 * ssd::MAX_CHUNK * 4;   // cum, dt
  static constexpr size_t SMEM = 1024 + FIX + 2 * STAGE + CD + 3 * 8;
};

// per-(b, chunk, h) token rows of the scratch `tok`: T's row sums (+ U),
// T's column sums (+ V), V, x . dxdt
constexpr int ROWSUM = 0, COLSUM = 1, VS = 2, XDX = 3;

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(hopper::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(hopper::smem_u32(bar))
      : "memory");
}

// one thread: a 64-row tile of an (B, S, NH, D) tensor, box by box
template <int D>
__device__ __forceinline__ void load_rows_tma(uint8_t* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int hd, int row,
                                              int b) {
  using T = hopper::RowTile<D, TL>;
  for (int q = 0; q < T::NB; ++q)
    hopper::tma_load_4d(dst + q * T::BOX, map, bar, q * T::DB, hd, row, b);
}

// one thread: a state's hi and lo tiles (row `r` of (B nc H, P, N))
template <int P, int N>
__device__ __forceinline__ void load_state(uint8_t* dst,
                                           const CUtensorMap* hi,
                                           const CUtensorMap* lo,
                                           uint64_t* bar, int r) {
  using ST = hopper::RowTile<N, P>;
  for (int q = 0; q < ST::NB; ++q) {
    hopper::tma_load_4d(dst + q * ST::BOX, hi, bar, q * ST::DB, 0, 0, r);
    hopper::tma_load_4d(dst + ST::BYTES + q * ST::BOX, lo, bar, q * ST::DB,
                        0, 0, r);
  }
}

// the rows of a thread in the accumulator layout (csrc/hopper.cuh) and
// the sum over the 4 threads that share them
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

template <int P, int N>
__global__ void __launch_bounds__(128)
chunk_bwd_l(const __grid_constant__ CUtensorMap tm_c,
            const __grid_constant__ CUtensorMap tm_b,
            const __grid_constant__ CUtensorMap tm_x,
            const __grid_constant__ CUtensorMap tm_dy,
            const __grid_constant__ CUtensorMap tm_shi,
            const __grid_constant__ CUtensorMap tm_slo,
            const __nv_bfloat16* __restrict__ Cm,
            const float* __restrict__ cumdt, float* __restrict__ dCh,
            float* __restrict__ tok, int S, int H, int G, int L) {
  using BP = BwdPlan<P, N>;
  using NT = typename BP::NT;
  using PT = typename BP::PT;
  using ST = typename BP::ST;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align1024(smem_raw);
  uint8_t* ct = sm;
  uint8_t* dyt = ct + NT::BYTES;
  uint8_t* sst = dyt + PT::BYTES;
  uint8_t* stages = sm + BP::FIX;
  float* cum = reinterpret_cast<float*>(stages + 2 * BP::STAGE);
  const float* dts = cum + ssd::MAX_CHUNK;
  uint64_t* bars = reinterpret_cast<uint64_t*>(cum + 2 * ssd::MAX_CHUNK);

  const int nlt = (L + TL - 1) / TL;
  const int lt = nlt - 1 - (int)blockIdx.x;            // long tiles first
  const int h = blockIdx.y;
  const int nc = S / L;
  const int b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int g = h / (H / G);
  const int l0 = lt * TL, c0 = c * L;
  const int nst = lt + 1;
  const int row = (b * nc + c) * H + h;
  const int t = threadIdx.x;

  if (t == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (t == 0) {
    hopper::mbar_expect_tx(&bars[0], BP::FIX + BP::CD);
    load_rows_tma<N>(ct, &tm_c, &bars[0], g, c0 + l0, b);
    load_rows_tma<P>(dyt, &tm_dy, &bars[0], h, c0 + l0, b);
    load_state<P, N>(sst, &tm_shi, &tm_slo, &bars[0], row);
    bulk_load(cum, cumdt + (long)row * 2 * ssd::MAX_CHUNK, BP::CD, &bars[0]);
    for (int j = 0; j < nst && j < 2; ++j) {
      uint8_t* st = stages + j * BP::STAGE;
      hopper::mbar_expect_tx(&bars[1 + j], BP::STAGE);
      load_rows_tma<N>(st, &tm_b, &bars[1 + j], g, c0 + j * TL, b);
      load_rows_tma<P>(st + NT::BYTES, &tm_x, &bars[1 + j], h, c0 + j * TL,
                       b);
    }
  }
  const int r = 16 * (t / 32) + (t % 32) / 4, cq = 2 * (t % 4);
  hopper::mbar_wait(&bars[0], 0);

  // inter-chunk: e^{cum_l} dy_l (S_hi + S_lo), and U_l = C_l . that
  float dc[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) dc[e] = 0.f;
  float rs[2] = {0.f, 0.f};
  if (c > 0) {
    hopper::fence_regs<N / 2>(dc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) {
      hopper::WgmmaSS<N, 0, 1>::run(dc, PT::kmajor(dyt, kk),
                                    ST::mnmajor(sst, kk));
      hopper::WgmmaSS<N, 0, 1>::run(dc, PT::kmajor(dyt, kk),
                                    ST::mnmajor(sst + ST::BYTES, kk));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<N / 2>(dc);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      const int half = (e >> 1) & 1, l = l0 + r + 8 * half;
      const int n = 8 * (e >> 2) + cq + (e & 1);
      dc[e] *= l < L ? expf(cum[l]) : 0.f;
      if (l < L)
        rs[half] += dc[e] * __bfloat162float(
            Cm[(((long)b * S + c0 + l) * G + g) * N + n]);
    }
  }
  // intra-chunk over the s tiles at or before this one
  for (int j = 0; j < nst; ++j) {
    uint8_t* st = stages + (j & 1) * BP::STAGE;
    hopper::mbar_wait(&bars[1 + (j & 1)], (j >> 1) & 1);
    float cb[32], gg[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) cb[e] = gg[e] = 0.f;
    hopper::fence_regs<32>(cb);
    hopper::fence_regs<32>(gg);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      hopper::WgmmaSS<64, 0, 0>::run(cb, NT::kmajor(ct, kk),
                                     NT::kmajor(st, kk));
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk)
      hopper::WgmmaSS<64, 0, 0>::run(gg, PT::kmajor(dyt, kk),
                                     PT::kmajor(st + NT::BYTES, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<32>(cb);
    hopper::fence_regs<32>(gg);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int half = (e >> 1) & 1, l = l0 + r + 8 * half;
      const int s = j * TL + 8 * (e >> 2) + cq + (e & 1);
      // cum and dt past the chunk are not written: mask before reading
      const bool in = s <= l && l < L;
      const float ge = in ? gg[e] * dts[s] * expf(cum[l] - cum[s]) : 0.f;
      rs[half] += ge * cb[e];
      gg[e] = ge;
    }
    uint32_t a[TL / 16][4];
    hopper::to_a_fragments<TL>(gg, a);
    hopper::fence_regs<N / 2>(dc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TL / 16; ++kk)
      hopper::WgmmaRS<N, 1>::run(dc, a[kk], NT::mnmajor(st, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<N / 2>(dc);
    __syncthreads();            // every warp is done with this stage
    if (t == 0 && j + 2 < nst) {
      hopper::mbar_expect_tx(&bars[1 + (j & 1)], BP::STAGE);
      load_rows_tma<N>(st, &tm_b, &bars[1 + (j & 1)], g, c0 + (j + 2) * TL,
                       b);
      load_rows_tma<P>(st + NT::BYTES, &tm_x, &bars[1 + (j & 1)], h,
                       c0 + (j + 2) * TL, b);
    }
  }
  float* trow = tok + ((long)row * 4 + ROWSUM) * ssd::MAX_CHUNK;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float v = quad_sum(rs[half]);
    const int l = l0 + r + 8 * half;
    if ((t & 3) == 0 && l < L) trow[l] = v;
  }
#pragma unroll
  for (int e = 0; e < N / 2; e += 2) {
    const int l = l0 + r + 8 * ((e >> 1) & 1);
    const int n = 8 * (e >> 2) + cq;
    if (l < L)
      *reinterpret_cast<float2*>(
          dCh + (((long)b * S + c0 + l) * H + h) * N + n) =
          make_float2(dc[e], dc[e + 1]);
  }
}

template <int P, int N>
__global__ void __launch_bounds__(128)
chunk_bwd_s(const __grid_constant__ CUtensorMap tm_c,
            const __grid_constant__ CUtensorMap tm_b,
            const __grid_constant__ CUtensorMap tm_x,
            const __grid_constant__ CUtensorMap tm_dy,
            const __grid_constant__ CUtensorMap tm_dhi,
            const __grid_constant__ CUtensorMap tm_dlo,
            const __nv_bfloat16* __restrict__ x,
            const float* __restrict__ cumdt, float* __restrict__ dBh,
            __nv_bfloat16* __restrict__ dx, float* __restrict__ tok, int S,
            int H, int G, int L) {
  using BP = BwdPlan<P, N>;
  using NT = typename BP::NT;
  using PT = typename BP::PT;
  using ST = typename BP::ST;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align1024(smem_raw);
  uint8_t* bt = sm;
  uint8_t* xt = bt + NT::BYTES;
  uint8_t* dst = xt + PT::BYTES;
  uint8_t* stages = sm + BP::FIX;
  float* cum = reinterpret_cast<float*>(stages + 2 * BP::STAGE);
  const float* dts = cum + ssd::MAX_CHUNK;
  uint64_t* bars = reinterpret_cast<uint64_t*>(cum + 2 * ssd::MAX_CHUNK);

  const int nlt = (L + TL - 1) / TL;
  const int sti = (int)blockIdx.x;                     // long tiles first
  const int h = blockIdx.y;
  const int nc = S / L;
  const int b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int g = h / (H / G);
  const int s0 = sti * TL, c0 = c * L;
  const int nl = nlt - sti;                            // l tiles >= s tile
  const int row = (b * nc + c) * H + h;
  const int t = threadIdx.x;

  if (t == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (t == 0) {
    hopper::mbar_expect_tx(&bars[0], BP::FIX + BP::CD);
    load_rows_tma<N>(bt, &tm_b, &bars[0], g, c0 + s0, b);
    load_rows_tma<P>(xt, &tm_x, &bars[0], h, c0 + s0, b);
    load_state<P, N>(dst, &tm_dhi, &tm_dlo, &bars[0], row);
    bulk_load(cum, cumdt + (long)row * 2 * ssd::MAX_CHUNK, BP::CD, &bars[0]);
    for (int j = 0; j < nl && j < 2; ++j) {
      uint8_t* st = stages + j * BP::STAGE;
      hopper::mbar_expect_tx(&bars[1 + j], BP::STAGE);
      load_rows_tma<N>(st, &tm_c, &bars[1 + j], g, c0 + s0 + j * TL, b);
      load_rows_tma<P>(st + NT::BYTES, &tm_dy, &bars[1 + j], h,
                       c0 + s0 + j * TL, b);
    }
  }
  const int r = 16 * (t / 32) + (t % 32) / 4, cq = 2 * (t % 4);
  hopper::mbar_wait(&bars[0], 0);
  const float cum_last = cum[L - 1];

  // state terms: dB_s = e^{cum_L - cum_s} dt_s x_s dS, dxdt_s =
  // e^{cum_L - cum_s} B_s dS^T (dS as hi + lo), and V_s = xdt_s . dxdt_s
  float db[N / 2], dxd[P / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) db[e] = 0.f;
#pragma unroll
  for (int e = 0; e < P / 2; ++e) dxd[e] = 0.f;
  hopper::fence_regs<N / 2>(db);
  hopper::fence_regs<P / 2>(dxd);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk) {
    hopper::WgmmaSS<N, 0, 1>::run(db, PT::kmajor(xt, kk),
                                  ST::mnmajor(dst, kk));
    hopper::WgmmaSS<N, 0, 1>::run(db, PT::kmajor(xt, kk),
                                  ST::mnmajor(dst + ST::BYTES, kk));
  }
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    hopper::WgmmaSS<P, 0, 0>::run(dxd, NT::kmajor(bt, kk),
                                  ST::kmajor(dst, kk));
    hopper::WgmmaSS<P, 0, 0>::run(dxd, NT::kmajor(bt, kk),
                                  ST::kmajor(dst + ST::BYTES, kk));
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs<N / 2>(db);
  hopper::fence_regs<P / 2>(dxd);
  const __nv_bfloat16* xb = x + ((long)b * S + c0) * H * P + (long)h * P;
  float vs[2] = {0.f, 0.f}, cs[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < N / 2; ++e) {
    const int s = s0 + r + 8 * ((e >> 1) & 1);
    db[e] *= s < L ? expf(cum_last - cum[s]) * dts[s] : 0.f;
  }
#pragma unroll
  for (int e = 0; e < P / 2; ++e) {
    const int half = (e >> 1) & 1, s = s0 + r + 8 * half;
    const int p = 8 * (e >> 2) + cq + (e & 1);
    dxd[e] *= s < L ? expf(cum_last - cum[s]) : 0.f;
    if (s < L)
      vs[half] += dts[s] * dxd[e] *
                  __bfloat162float(xb[(long)s * H * P + p]);
  }
  // intra-chunk over the l tiles at or after this one
  for (int j = 0; j < nl; ++j) {
    uint8_t* st = stages + (j & 1) * BP::STAGE;
    const int l0 = s0 + j * TL;
    hopper::mbar_wait(&bars[1 + (j & 1)], (j >> 1) & 1);
    float cb[32], gg[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) cb[e] = gg[e] = 0.f;
    hopper::fence_regs<32>(cb);
    hopper::fence_regs<32>(gg);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      hopper::WgmmaSS<64, 0, 0>::run(cb, NT::kmajor(bt, kk),
                                     NT::kmajor(st, kk));
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk)
      hopper::WgmmaSS<64, 0, 0>::run(gg, PT::kmajor(xt, kk),
                                     PT::kmajor(st + NT::BYTES, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<32>(cb);
    hopper::fence_regs<32>(gg);
    // transposed tiles: rows s, columns l
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int half = (e >> 1) & 1, s = s0 + r + 8 * half;
      const int l = l0 + 8 * (e >> 2) + cq + (e & 1);
      const bool in = s <= l && l < L;
      const float E = in ? expf(cum[l] - cum[s]) : 0.f;
      const float ge = in ? gg[e] * dts[s] * E : 0.f;
      cs[half] += ge * cb[e];
      gg[e] = ge;
      cb[e] *= E;
    }
    uint32_t ag[TL / 16][4], ac[TL / 16][4];
    hopper::to_a_fragments<TL>(gg, ag);
    hopper::to_a_fragments<TL>(cb, ac);
    hopper::fence_regs<N / 2>(db);
    hopper::fence_regs<P / 2>(dxd);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TL / 16; ++kk) {
      hopper::WgmmaRS<N, 1>::run(db, ag[kk], NT::mnmajor(st, kk));
      hopper::WgmmaRS<P, 1>::run(dxd, ac[kk],
                                 PT::mnmajor(st + NT::BYTES, kk));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<N / 2>(db);
    hopper::fence_regs<P / 2>(dxd);
    __syncthreads();            // every warp is done with this stage
    if (t == 0 && j + 2 < nl) {
      hopper::mbar_expect_tx(&bars[1 + (j & 1)], BP::STAGE);
      load_rows_tma<N>(st, &tm_c, &bars[1 + (j & 1)], g,
                       c0 + s0 + (j + 2) * TL, b);
      load_rows_tma<P>(st + NT::BYTES, &tm_dy, &bars[1 + (j & 1)], h,
                       c0 + s0 + (j + 2) * TL, b);
    }
  }
  // dx = dt dxdt and x . dxdt; dB per head; T's column sums and V
  float xd[2] = {0.f, 0.f};
  __nv_bfloat16* dxb = dx + ((long)b * S + c0) * H * P + (long)h * P;
#pragma unroll
  for (int e = 0; e < P / 2; e += 2) {
    const int half = (e >> 1) & 1, s = s0 + r + 8 * half;
    const int p = 8 * (e >> 2) + cq;
    if (s < L) {
      const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
          xb + (long)s * H * P + p);
      const float2 xf = __bfloat1622float2(xv);
      xd[half] += xf.x * dxd[e] + xf.y * dxd[e + 1];
      *reinterpret_cast<__nv_bfloat162*>(dxb + (long)s * H * P + p) =
          __floats2bfloat162_rn(dts[s] * dxd[e], dts[s] * dxd[e + 1]);
    }
  }
#pragma unroll
  for (int e = 0; e < N / 2; e += 2) {
    const int s = s0 + r + 8 * ((e >> 1) & 1);
    const int n = 8 * (e >> 2) + cq;
    if (s < L)
      *reinterpret_cast<float2*>(
          dBh + (((long)b * S + c0 + s) * H + h) * N + n) =
          make_float2(db[e], db[e + 1]);
  }
  float* tb = tok + (long)row * 4 * ssd::MAX_CHUNK;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float v = quad_sum(vs[half]), col = quad_sum(cs[half]);
    const float x_dx = quad_sum(xd[half]);
    const int s = s0 + r + 8 * half;
    if ((t & 3) == 0 && s < L) {
      tb[COLSUM * ssd::MAX_CHUNK + s] = col + v;
      tb[VS * ssd::MAX_CHUNK + s] = v;
      tb[XDX * ssd::MAX_CHUNK + s] = x_dx;
    }
  }
}

// per (chunk, head, batch): dcum = T's row sums + U - T's column sums - V,
// plus sum V + e^{cum_L} <dS, S> at the last token; then ddt = x.dxdt +
// a rc and the dA partial sum_j dt_j rc_j, rc the reverse cumsum of dcum
template <int P, int N>
__global__ void __launch_bounds__(256)
chunk_dcum(const float* __restrict__ A, const float* __restrict__ cumdt,
           const float* __restrict__ tok, const float* __restrict__ states,
           const float* __restrict__ dstates, float* __restrict__ ddt,
           float* __restrict__ da_part, int S, int H, int L) {
  __shared__ float red[16], dcum[ssd::MAX_CHUNK];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int row = (b * nc + c) * H + h;
  const int tid = threadIdx.x;
  const float* cd = cumdt + (long)row * 2 * ssd::MAX_CHUNK;
  const float* tb = tok + (long)row * 4 * ssd::MAX_CHUNK;
  const long so = (long)row * P * N;
  float w = 0.f;
  for (int e = tid; e < P * N; e += THREADS) w += dstates[so + e] * states[so + e];
  float vsum = 0.f;
  for (int s = tid; s < L; s += THREADS) {
    dcum[s] = tb[ROWSUM * ssd::MAX_CHUNK + s] - tb[COLSUM * ssd::MAX_CHUNK + s];
    vsum += tb[VS * ssd::MAX_CHUNK + s];
  }
  const float W = expf(cd[L - 1]) * ssd::block_sum<THREADS>(w, red);
  const float V = ssd::block_sum<THREADS>(vsum, red);
  if (tid == 0) dcum[L - 1] += V + W;
  __syncthreads();
  const int j = L - 1 - tid;
  const float rc = ssd::block_scan<THREADS>(j >= 0 ? dcum[j] : 0.f, red);
  float dap = 0.f;
  if (j >= 0) {
    ddt[((long)b * S + c * L + j) * H + h] =
        tb[XDX * ssd::MAX_CHUNK + j] + A[h] * rc;
    dap = cd[ssd::MAX_CHUNK + j] * rc;
  }
  const float da = ssd::block_sum<THREADS>(dap, red);
  if (tid == 0) da_part[row] = da;
}

// hi + lo bf16 halves of an f32 array
__global__ void __launch_bounds__(256)
split_hilo(const float* __restrict__ src, __nv_bfloat16* __restrict__ hi,
           __nv_bfloat16* __restrict__ lo, long n) {
  const long i = (long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const float v = src[i];
  const __nv_bfloat16 h = __float2bfloat16(v);
  hi[i] = h;
  lo[i] = __float2bfloat16(v - __bfloat162float(h));
}

// dB, dC (B,S,G,N) = the sums of dBh, dCh (B,S,H,N) over each group's
// heads, in head order
template <typename T>
__global__ void __launch_bounds__(256)
group_sum(const float* __restrict__ dBh, const float* __restrict__ dCh,
          T* __restrict__ dB, T* __restrict__ dC, long rows, int H, int G,
          int N) {
  const long e = (long)blockIdx.x * 256 + threadIdx.x;
  if (e >= rows * G * N) return;
  const int rep = H / G;
  const int n = e % N;
  const long bg = e / N;                       // (b s) G + g
  const int g = bg % G;
  const long bs_ = bg / G;
  const long base = (bs_ * H + (long)g * rep) * N + n;
  float sb = 0.f, sc = 0.f;
  for (int r = 0; r < rep; ++r) {
    sb += dBh[base + (long)r * N];
    sc += dCh[base + (long)r * N];
  }
  put(&dB[e], sb);
  put(&dC[e], sc);
}

// dA (H,) = the sum of the (B, nc, H) partials over b and the chunks, in
// order
__global__ void __launch_bounds__(256)
da_sum(const float* __restrict__ part, float* __restrict__ da, int rows,
       int H) {
  for (int h = threadIdx.x; h < H; h += 256) {
    float v = 0.f;
    for (int r = 0; r < rows; ++r) v += part[(long)r * H + h];
    da[h] = v;
  }
}

// the per-head dB, dC summed over each group's heads, and dA's partials
template <typename T>
int finish(float* dBCh, float* da_part, void* dB, void* dC, void* da,
           int batch, int S, int H, int G, int N, int nc, cudaStream_t st) {
  const long bshn = (long)batch * S * H * N;
  const long n_out = (long)batch * S * G * N;
  group_sum<T><<<(unsigned)((n_out + 255) / 256), 256, 0, st>>>(
      dBCh, dBCh + bshn, static_cast<T*>(dB), static_cast<T*>(dC),
      (long)batch * S, H, G, N);
  int rc = cudaGetLastError();
  if (rc != 0) return rc;
  da_sum<<<1, 256, 0, st>>>(da_part, static_cast<float*>(da), batch * nc, H);
  return cudaGetLastError();
}

// f32: the chunk pass on the CUDA cores
template <int P, int N>
int run_f32(const void* x, const void* dt, const void* A, const void* Bm,
            const void* Cm, const void* dy, const void* dstate,
            const void* states, void* dx, void* ddt, void* da, void* dB,
            void* dC, float* dstates, float* cum_last, float* dBCh,
            float* da_part, int batch, int S, int H, int G, int L,
            cudaStream_t st) {
  const int nc = S / L;
  int rc = ssd::chunk_states<P, N, 1>(0, dy, dt, A, Cm, dstates, cum_last,
                                      batch, S, H, G, L, st);
  if (rc != 0) return rc;
  rc = ssd::launch_scan<true>(dstates, cum_last,
                              static_cast<const float*>(dstate), nullptr,
                              nullptr, nullptr, batch, nc, H, P * N, st);
  if (rc != 0) return rc;
  using SM = BwdSmem<P, N>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      chunk_bwd<float, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SM::bytes);
  if (attr != cudaSuccess) return attr;
  const long bshn = (long)batch * S * H * N;
  chunk_bwd<float, P, N><<<dim3(nc, H, batch), THREADS, SM::bytes, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(dy),
      static_cast<const float*>(states), dstates, static_cast<float*>(dx),
      static_cast<float*>(ddt), dBCh, dBCh + bshn, da_part, S, H, G, L);
  rc = cudaGetLastError();
  if (rc != 0) return rc;
  return finish<float>(dBCh, da_part, dB, dC, da, batch, S, H, G, N, nc, st);
}

// bf16: the chunk pass on wgmma.  `work` holds cum and dt (B nc H, 2,
// 256) f32, the token rows (B nc H, 4, 256) f32, and S and dS as bf16 hi
// and lo (4 x B nc H P N).
template <int P, int N>
int run_bf16(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* dy, const void* dstate,
             const void* states, void* dx, void* ddt, void* da, void* dB,
             void* dC, float* dstates, float* cum_last, float* dBCh,
             float* da_part, uint8_t* work, int batch, int S, int H, int G,
             int L, cudaStream_t st) {
  using BP = BwdPlan<P, N>;
  const int nc = S / L, PN = P * N;
  const long rows = (long)batch * nc * H;
  float* cumdt = reinterpret_cast<float*>(work);
  float* tok = cumdt + rows * 2 * ssd::MAX_CHUNK;
  __nv_bfloat16* shi = reinterpret_cast<__nv_bfloat16*>(
      tok + rows * 4 * ssd::MAX_CHUNK);
  __nv_bfloat16* slo = shi + rows * PN;
  __nv_bfloat16* dhi = slo + rows * PN;
  __nv_bfloat16* dlo = dhi + rows * PN;
  int rc = ssd::chunk_states<P, N, 1>(1, dy, dt, A, Cm, dstates, cum_last,
                                      batch, S, H, G, L, st, cumdt);
  if (rc != 0) return rc;
  rc = ssd::launch_scan<true>(dstates, cum_last,
                              static_cast<const float*>(dstate), nullptr,
                              dhi, dlo, batch, nc, H, PN, st);
  if (rc != 0) return rc;
  split_hilo<<<(unsigned)((rows * PN + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(states), shi, slo, rows * PN);
  rc = cudaGetLastError();
  if (rc != 0) return rc;
  CUtensorMap tm_c, tm_b, tm_x, tm_dy, tm_shi, tm_slo, tm_dhi, tm_dlo;
  rc = hopper::encode_bshd(&tm_c, Cm, batch, S, G, N, TL);
  if (rc == 0) rc = hopper::encode_bshd(&tm_b, Bm, batch, S, G, N, TL);
  if (rc == 0) rc = hopper::encode_bshd(&tm_x, x, batch, S, H, P, TL);
  if (rc == 0) rc = hopper::encode_bshd(&tm_dy, dy, batch, S, H, P, TL);
  const void* halves[4] = {shi, slo, dhi, dlo};
  CUtensorMap* maps[4] = {&tm_shi, &tm_slo, &tm_dhi, &tm_dlo};
  for (int i = 0; i < 4 && rc == 0; ++i)
    rc = hopper::encode_bshd(maps[i], halves[i], (int)rows, P, 1, N, P);
  if (rc != 0) return rc;
  static const cudaError_t attr_l = cudaFuncSetAttribute(
      chunk_bwd_l<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BP::SMEM);
  static const cudaError_t attr_s = cudaFuncSetAttribute(
      chunk_bwd_s<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BP::SMEM);
  if (attr_l != cudaSuccess) return attr_l;
  if (attr_s != cudaSuccess) return attr_s;
  const long bshn = (long)batch * S * H * N;
  const dim3 grid((L + TL - 1) / TL, H, batch * nc);
  chunk_bwd_l<P, N><<<grid, 128, BP::SMEM, st>>>(
      tm_c, tm_b, tm_x, tm_dy, tm_shi, tm_slo,
      static_cast<const __nv_bfloat16*>(Cm), cumdt, dBCh + bshn, tok, S, H,
      G, L);
  rc = cudaGetLastError();
  if (rc != 0) return rc;
  chunk_bwd_s<P, N><<<grid, 128, BP::SMEM, st>>>(
      tm_c, tm_b, tm_x, tm_dy, tm_dhi, tm_dlo,
      static_cast<const __nv_bfloat16*>(x), cumdt, dBCh,
      static_cast<__nv_bfloat16*>(dx), tok, S, H, G, L);
  rc = cudaGetLastError();
  if (rc != 0) return rc;
  chunk_dcum<P, N><<<dim3(nc, H, batch), THREADS, 0, st>>>(
      static_cast<const float*>(A), cumdt, tok,
      static_cast<const float*>(states), dstates, static_cast<float*>(ddt),
      da_part, S, H, L);
  rc = cudaGetLastError();
  if (rc != 0) return rc;
  return finish<__nv_bfloat16>(dBCh, da_part, dB, dC, da, batch, S, H, G, N,
                               nc, st);
}

}  // namespace

// dtype of x, Bm, Cm, dy, dx, dB, dC: 0 = f32, 1 = bf16; dt, A, ddt, dA,
// the states and dstate (the final state's gradient, or null) are f32.
// `states` (B, S/L, H, P, N) are the chunk-start states the forward kept.
// Scratch from the caller: dstates (B, S/L, H, P, N) f32, cum_last (B,
// S/L, H) f32, dBCh 2 x (B, S, H, N) f32, da_part (B, S/L, H) f32, and for
// bf16 `work`, ssd_scan_bwd_work_bytes() bytes.  P in {32, 64}, N in {32,
// 64, 128}, 1 <= L <= 256, S % L == 0, H % G == 0.  Returns a cudaError_t
// (0 on success), hopper::ERR_MISALIGNED for a bf16 input whose base is
// not 16-byte aligned, or hopper::ERR_TENSOR_MAP + a CUresult when a TMA
// tensor map cannot be encoded.
extern "C" long ssd_scan_bwd_work_bytes(int batch, int S, int H, int P,
                                        int N, int L) {
  const long rows = (long)batch * (S / L) * H;
  return rows * (6 * ssd::MAX_CHUNK * 4 + 4L * P * N * 2);
}

extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* dy,
                            const void* dstate, const void* states, void* dx,
                            void* ddt, void* da, void* dB, void* dC,
                            void* dstates, void* cum_last, void* dBCh,
                            void* da_part, void* work, int batch, int S,
                            int H, int G, int P, int N, int L, int dtype,
                            void* stream) {
  if (batch < 1 || S < 1 || H < 1 || G < 1 || H % G || L < 1 ||
      L > ssd::MAX_CHUNK || S % L || batch > 65535 || S / L > 65535 ||
      (long)batch * (S / L) > 65535)
    return cudaErrorInvalidValue;
  if (dtype == 1 && work == nullptr) return cudaErrorInvalidValue;
  if (dtype == 1 && !(hopper::aligned16(x) && hopper::aligned16(dy) &&
                      hopper::aligned16(Bm) && hopper::aligned16(Cm) &&
                      hopper::aligned16(work)))
    return hopper::ERR_MISALIGNED;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ds = static_cast<float*>(dstates);
  float* cl = static_cast<float*>(cum_last);
  float* bc = static_cast<float*>(dBCh);
  float* dp = static_cast<float*>(da_part);
  uint8_t* wk = static_cast<uint8_t*>(work);
#define SSD_CASE(PP, NN)                                                    \
  if (P == PP && N == NN)                                                   \
    return dtype == 1                                                       \
               ? run_bf16<PP, NN>(x, dt, A, Bm, Cm, dy, dstate, states, dx, \
                                  ddt, da, dB, dC, ds, cl, bc, dp, wk,      \
                                  batch, S, H, G, L, st)                    \
               : run_f32<PP, NN>(x, dt, A, Bm, Cm, dy, dstate, states, dx,  \
                                 ddt, da, dB, dC, ds, cl, bc, dp, batch, S, \
                                 H, G, L, st);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  SSD_CASE(32, 32)
  SSD_CASE(32, 64)
  SSD_CASE(32, 128)
  SSD_CASE(64, 32)
  SSD_CASE(64, 64)
  SSD_CASE(64, 128)
#undef SSD_CASE
  return cudaErrorInvalidValue;
}
