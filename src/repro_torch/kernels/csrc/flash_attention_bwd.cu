// Flash-attention backward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the TPU kernels of repro/kernels/flash_attention_bwd.py:273
// `flash_attention_bwd`: the dK/dV kernel (pallas_call :293, body
// `_dkv_kernel` :179) and the dQ kernel (pallas_call :331, body
// `_dq_kernel` :229).  Both recompute p = exp(s - lse) tile by tile from
// the saved q, k, v, the forward's lse rows (flash_attention.cu with
// LSE = true) and delta = rowsum(do * o), so memory stays O(S):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta) * scale,
//   dK = dS^T Q,  dQ = dS K.
// q, do (B,S,H,D); k, v (B,S,KH,D), f32 or bf16, contiguous; lse, delta
// (B,H,S) f32.  Gradients come out in q's dtype; accumulation is f32.
//
// What bounds it on the H100.  At the training shape (B8 S1024 H16 D64)
// the causal backward is 3.5x the forward's work (8 D and 6 D operations
// a visible pair for dK/dV and dQ: each recomputes S and dP), bound by
// the bf16 tensor-core rate: 0.035 + 0.026 ms.
//
// What the design does about it.
//  * The TPU grid's sequential axis (query tiles for dK/dV, key tiles for
//    dQ) becomes a loop inside the block, over only the tiles the causal
//    mask and the window allow.  Each block owns its output rows, so no
//    atomics are needed and the result does not depend on block order:
//    two launches on the same inputs give the same bits.
//  * The ragged tail is masked by S inside the kernel (kpos < S and
//    qpos < S), where the TPU caller pads S to lcm(block_q, block_k):
//    padded queries and keys contribute exactly nothing in both.
//
// bf16 on the tensor cores (`dkv_wgmma`, `dq_wgmma`): one warpgroup per
// block, every product a wgmma with f32 accumulators in registers, the
// tiles loaded by TMA into shared memory with the forward's boxes and
// swizzles (csrc/hopper.cuh: RowTile, encode_bshd) and completing on
// mbarriers.
//  * dK/dV: grid (ceil(S/64), B*KH), the causal-heavy key tiles (small
//    k0) first.  K and V are loaded once; Q and dO come through a
//    two-stage ring, one step per (query tile, query head of the group),
//    the next step's tiles in flight while this one computes.  lse and
//    delta are plain loads staged in shared memory a step ahead (a
//    (B,H,S) f32 row has a stride of 4 S bytes, which TMA takes only
//    when S is a multiple of 4).  Per step, on the transposed products:
//    S^T = K Q^T and dP^T = V dO^T (keys on M, queries on N, all
//    K-major); P^T and dS^T in registers, lse and delta indexed by the
//    accumulator's column; then dV += P^T dO and dK += dS^T Q with P^T
//    and dS^T as the register A operand (the accumulator's layout is the
//    A fragment's), dO and Q read MN-major from the same tiles.  The
//    products are committed in groups so that the register work overlaps
//    the tensor cores: P^T is computed while dP^T runs, dS^T while dV
//    does.
//  * dQ: grid (ceil(S/64), B*H), the causal-heavy query tiles (large q0)
//    first.  Q and dO are loaded once and lse and delta held per row;
//    K and V come through a two-stage ring.  S = Q K^T and dP = dO V^T,
//    P and dS in registers, dQ += dS K with K read MN-major.
//  * P and dS are rounded to bf16 before their products, where the TPU
//    kernel multiplies f32: about 2^-9 relative per term, inside the bf16
//    gradient tolerance of 2e-2 of the largest gradient.
// TMA needs 16-byte aligned base addresses: for a bf16 q, k, v or do
// that is not, the entry points return hopper::ERR_MISALIGNED, which the
// wrapper raises on.
//
// Head dims 192 and 256 (gemma-2b, nemotron-4-340b).  One warpgroup
// holding dK, dV, S^T and dP^T in f32 registers needs D + 64 of them a
// thread: 256 at D 192 and 320 at D 256, past the 255 a thread may have.
// So there dK/dV runs as two launches over the columns of dK and dV, the
// first 128 and the rest (`dkv_wgmma<D, C0, NC>`): each recomputes S^T
// and dP^T over the full D and accumulates only its NC columns, NC / 2
// registers each, as at D 128 (1.5x the tensor-core products of one pass
// at D 256, 1.5x at D 192).  Column chunks start on a 64-column box, so
// the MN-major operands of the chunk are the tile's own boxes.  dQ holds
// D / 2 + 64 registers a thread and stays one pass, its dS K product
// issued as wgmmas of at most 128 columns (`rs_columns`).
//
// f32 keeps the CUDA-core kernels (`dkv_kernel`, `dq_kernel`): wgmma takes
// f32 only as TF32, which would break the f32 bar of 1e-4 against the
// plain version.  256 threads a block; the tiles staged in shared memory
// as f32 with padded rows; scalar FMAs.  dK/dV: one block per 64-key tile
// and (B, KH); K and V stay in shared memory, dK and dV accumulate in
// registers over the query tiles and the G = H/KH query heads of the
// group, as `_dkv_kernel` :205-221 does.  dQ: one block per 64-query
// tile and (B, H); Q, dO, lse and delta stay in shared memory.  At D 256
// four 64-row tiles of 257 floats pass the 232,448 bytes a block may
// have, so the rows a block owns (keys for dK/dV, queries for dQ) come
// in tiles of 32 there (`f32_rows`).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int THREADS = 256;
constexpr int PP = BK + 1;      // padded row of a 64-key score tile
// the most shared memory a block may have on the H100
constexpr size_t MAX_SMEM = 232448;

// rows a block owns in the f32 kernels: 64, or 32 at D 256
template <int D>
__host__ __device__ constexpr int f32_rows() { return D <= 192 ? 64 : 32; }

// rows [s0, s0 + ROWS) of one head of a (B,S,NH,D) tensor into a
// ROWS x (D+1) tile; rows past S are zero
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          int s0, int S, long row_stride) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
    const int r = i / D, c = i % D, s = s0 + r;
    dst[r * DP + c] = s < S ? base[(long)s * row_stride + c] : 0.f;
  }
}

// The two products of a (query tile of 16 NA rows, key tile of 16 NJ
// keys) pair: thread owns query rows rg*NA + a and key columns cg + 16*jj.
// Returns, in p and ds, P = exp(s*scale - lse) and dS = P * (dP - delta)
// * scale (0 where masked).
template <int D, int NA, int NJ>
__device__ __forceinline__ void p_and_ds(const float* Qs, const float* dOs,
                                         const float* Ks, const float* Vs,
                                         const float* lse_s,
                                         const float* delta_s, int q0, int k0,
                                         int S, int causal, int window,
                                         float scale, float p[NA][NJ],
                                         float ds[NA][NJ]) {
  constexpr int DP = D + 1;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  float s[NA][NJ], dp[NA][NJ];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) s[a][jj] = dp[a][jj] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[NA], ov[NA], kv[NJ], vv[NJ];
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      qv[a] = Qs[(rg * NA + a) * DP + d];
      ov[a] = dOs[(rg * NA + a) * DP + d];
    }
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      kv[jj] = Ks[(cg + 16 * jj) * DP + d];
      vv[jj] = Vs[(cg + 16 * jj) * DP + d];
    }
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        s[a][jj] += qv[a] * kv[jj];
        dp[a][jj] += ov[a] * vv[jj];
      }
  }
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int rr = rg * NA + a, qpos = q0 + rr;
    const float l = lse_s[rr], dl = delta_s[rr];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int kpos = k0 + cg + 16 * jj;
      bool ok = kpos < S && qpos < S;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      const float pv = ok ? expf(s[a][jj] * scale - l) : 0.f;
      p[a][jj] = pv;
      ds[a][jj] = pv * (dp[a][jj] - dl) * scale;
    }
  }
}

// K, V (KR rows), Q, dO (64 rows), P and dS (64 x KR+1), lse and delta
template <int D>
constexpr size_t dkv_smem_bytes() {
  constexpr int KR = f32_rows<D>();
  return sizeof(float) *
         (2 * KR * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * (KR + 1) + 2 * BQ);
}

// Q, dO (QR rows), K, V (64 rows), dS (QR x 65), lse and delta
template <int D>
constexpr size_t dq_smem_bytes() {
  constexpr int QR = f32_rows<D>();
  return sizeof(float) * (2 * QR * (D + 1) + 2 * BK * (D + 1) + QR * PP +
                          2 * QR);
}

// grid (ceil(S/KR), B*KH)
template <int D>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dk, float* __restrict__ dv, int S, int H,
           int KH, int causal, int window, float scale) {
  constexpr int KR = f32_rows<D>();     // keys a block
  constexpr int KP = KR + 1;            // padded row of a score tile
  constexpr int TPR = THREADS / KR;     // threads a key row of dK and dV
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  float* Ks = smem;                 // KR x DP
  float* Vs = Ks + KR * DP;         // KR x DP
  float* Qs = Vs + KR * DP;         // BQ x DP
  float* dOs = Qs + BQ * DP;        // BQ x DP
  float* Ps = dOs + BQ * DP;        // BQ x KP
  float* dSs = Ps + BQ * KP;        // BQ x KP
  float* lse_s = dSs + BQ * KP;     // BQ
  float* delta_s = lse_s + BQ;      // BQ

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * KR;
  const int b = blockIdx.y / KH;
  const int kh = blockIdx.y % KH;
  const int G = H / KH;
  const long q_stride = (long)H * D;
  const long k_stride = (long)KH * D;

  load_tile<D, KR>(Ks, k + ((long)b * S * KH + kh) * D, k0, S, k_stride);
  load_tile<D, KR>(Vs, v + ((long)b * S * KH + kh) * D, k0, S, k_stride);

  // query tiles that reach this key tile
  const int k_last = min(k0 + KR, S) - 1;
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  const int q_end = window > 0 ? min(S, k_last + window) : S;   // exclusive

  // accumulator ownership: key row j, columns cq + TPR*cc
  const int j = tid / TPR, cq = tid % TPR;
  float dk_acc[D / TPR], dv_acc[D / TPR];
#pragma unroll
  for (int cc = 0; cc < D / TPR; ++cc) dk_acc[cc] = dv_acc[cc] = 0.f;
  const int rg = tid >> 4, cg = tid & 15;

  for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
    for (int g = 0; g < G; ++g) {
      const int h = kh * G + g;
      __syncthreads();            // previous tiles fully consumed
      load_tile<D, BQ>(Qs, q + ((long)b * S * H + h) * D, q0, S, q_stride);
      load_tile<D, BQ>(dOs, dout + ((long)b * S * H + h) * D, q0, S,
                       q_stride);
      if (tid < BQ) {
        const int s = q0 + tid;
        const long row = ((long)b * H + h) * S + s;
        lse_s[tid] = s < S ? lse[row] : 0.f;
        delta_s[tid] = s < S ? delta[row] : 0.f;
      }
      __syncthreads();
      float p[4][KR / 16], ds[4][KR / 16];
      p_and_ds<D, 4, KR / 16>(Qs, dOs, Ks, Vs, lse_s, delta_s, q0, k0, S,
                              causal, window, scale, p, ds);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int jj = 0; jj < KR / 16; ++jj) {
          Ps[(rg * 4 + a) * KP + cg + 16 * jj] = p[a][jj];
          dSs[(rg * 4 + a) * KP + cg + 16 * jj] = ds[a][jj];
        }
      __syncthreads();
      for (int i = 0; i < BQ; ++i) {
        const float pv = Ps[i * KP + j], dsv = dSs[i * KP + j];
        const float* orow = dOs + i * DP + cq;
        const float* qrow = Qs + i * DP + cq;
#pragma unroll
        for (int cc = 0; cc < D / TPR; ++cc) {
          dv_acc[cc] += pv * orow[TPR * cc];
          dk_acc[cc] += dsv * qrow[TPR * cc];
        }
      }
    }
  }

  const int s = k0 + j;
  if (s < S) {
    const long base = (((long)b * S + s) * KH + kh) * D + cq;
#pragma unroll
    for (int cc = 0; cc < D / TPR; ++cc) {
      dk[base + TPR * cc] = dk_acc[cc];
      dv[base + TPR * cc] = dv_acc[cc];
    }
  }
}

// grid (ceil(S/QR), B*H)
template <int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int S, int H, int KH, int causal, int window,
          float scale) {
  constexpr int QR = f32_rows<D>();     // queries a block
  constexpr int TPR = THREADS / QR;     // threads a query row of dQ
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  float* Qs = smem;                 // QR x DP
  float* dOs = Qs + QR * DP;        // QR x DP
  float* Ks = dOs + QR * DP;        // BK x DP
  float* Vs = Ks + BK * DP;         // BK x DP
  float* dSs = Vs + BK * DP;        // QR x PP
  float* lse_s = dSs + QR * PP;     // QR
  float* delta_s = lse_s + QR;      // QR

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QR;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kh = h / (H / KH);
  const long q_stride = (long)H * D;
  const long k_stride = (long)KH * D;

  load_tile<D, QR>(Qs, q + ((long)b * S * H + h) * D, q0, S, q_stride);
  load_tile<D, QR>(dOs, dout + ((long)b * S * H + h) * D, q0, S, q_stride);
  if (tid < QR) {
    const int s = q0 + tid;
    const long row = ((long)b * H + h) * S + s;
    lse_s[tid] = s < S ? lse[row] : 0.f;
    delta_s[tid] = s < S ? delta[row] : 0.f;
  }

  // key tiles that this query tile attends to
  const int q_last = min(q0 + QR, S) - 1;
  const int k_end = causal ? q_last + 1 : S;                  // exclusive
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_begin = (k_first / BK) * BK;

  // accumulator ownership: query row i, columns cq + TPR*cc
  const int i = tid / TPR, cq = tid % TPR;
  float dq_acc[D / TPR];
#pragma unroll
  for (int cc = 0; cc < D / TPR; ++cc) dq_acc[cc] = 0.f;
  const int rg = tid >> 4, cg = tid & 15;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();              // previous tiles fully consumed
    load_tile<D, BK>(Ks, k + ((long)b * S * KH + kh) * D, k0, S, k_stride);
    load_tile<D, BK>(Vs, v + ((long)b * S * KH + kh) * D, k0, S, k_stride);
    __syncthreads();
    float p[QR / 16][4], ds[QR / 16][4];
    p_and_ds<D, QR / 16, 4>(Qs, dOs, Ks, Vs, lse_s, delta_s, q0, k0, S,
                            causal, window, scale, p, ds);
#pragma unroll
    for (int a = 0; a < QR / 16; ++a)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        dSs[(rg * (QR / 16) + a) * PP + cg + 16 * jj] = ds[a][jj];
    __syncthreads();
    const float* dsrow = dSs + i * PP;
    for (int jk = 0; jk < BK; ++jk) {
      const float dsv = dsrow[jk];
      const float* krow = Ks + jk * DP + cq;
#pragma unroll
      for (int cc = 0; cc < D / TPR; ++cc) dq_acc[cc] += dsv * krow[TPR * cc];
    }
  }

  const int s = q0 + i;
  if (s < S) {
    float* out = dq + (((long)b * S + s) * H + h) * D + cq;
#pragma unroll
    for (int cc = 0; cc < D / TPR; ++cc) out[TPR * cc] = dq_acc[cc];
  }
}

template <int D>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dk, void* dv, int B,
                           int S, int H, int KH, int causal, int window,
                           cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static_assert(smem <= MAX_SMEM, "dkv_kernel: shared memory past a block");
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int KR = f32_rows<D>();
  const dim3 grid((S + KR - 1) / KR, B * KH);
  dkv_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), S, H, KH,
      causal, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, void* dq, int B, int S, int H,
                          int KH, int causal, int window,
                          cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static_assert(smem <= MAX_SMEM, "dq_kernel: shared memory past a block");
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int QR = f32_rows<D>();
  const dim3 grid((S + QR - 1) / QR, B * H);
  dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), S, H, KH, causal, window,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr float LOG2E = 1.4426950408889634f;

// a 64-row tile of q, k, v or do (BQ = BK = 64)
template <int D>
using Tile = hopper::RowTile<D, BK>;

// six tiles, the mbarriers, and for dK/dV two stages of lse and delta
template <int D>
constexpr size_t wgmma_smem() {
  return 1024 + 6 * Tile<D>::BYTES + 4 * 8 + 2 * 2 * BQ * sizeof(float);
}

// the columns of dK and dV that one dkv_wgmma launch accumulates: all D
// up to D 128; at D 192 and 256 the first 128, then the rest
template <int D>
constexpr int dkv_cols() { return D <= 128 ? D : 128; }

// acc (64 x NC, f32) += A (64 x 16, the bf16 fragment a) B, B the
// columns [C0, C0 + NC) of the k16 step kk of an MN-major tile: one wgmma
// of at most 128 columns a piece, each piece starting on a 64-column box
template <int D, int C0, int NC>
__device__ __forceinline__ void rs_columns(float* acc, const uint32_t* a,
                                           const uint8_t* tile, int kk) {
  using T = Tile<D>;
  constexpr int N = NC < 128 ? NC : 128;
  static_assert(C0 % T::DB == 0, "a piece starts on a box");
  hopper::WgmmaRS<N, 1>::run(acc, a,
                             T::mnmajor(tile + (C0 / T::DB) * T::BOX, kk));
  if constexpr (NC > N) rs_columns<D, C0 + N, NC - N>(acc + N / 2, a, tile, kk);
}

// TMA loads of the tiles (rows s0.., head `head`, batch `batch`) of two
// tensors of one shape into one stage, completing on `bar`
template <int D>
__device__ __forceinline__ void load_pair(uint8_t* a, const CUtensorMap* ma,
                                          uint8_t* b, const CUtensorMap* mb,
                                          uint64_t* bar, int head, int s0,
                                          int batch) {
  using T = Tile<D>;
  hopper::mbar_expect_tx(bar, 2 * T::BYTES);
  for (int nb = 0; nb < T::NB; ++nb) {
    hopper::tma_load_4d(a + nb * T::BOX, ma, bar, nb * T::DB, head, s0,
                        batch);
    hopper::tma_load_4d(b + nb * T::BOX, mb, bar, nb * T::DB, head, s0,
                        batch);
  }
}

// rows r0 and r0 + 8 of a 64 x N accumulator into rows row0 + r0.. of a
// bf16 tensor of row stride `stride` elements, rows below `rows` only
template <int N>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long stride,
                                           const float* acc, int row0,
                                           int r0, int c0, int rows) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r0 + 8 * r;
    if (row >= rows) continue;
    __nv_bfloat16* dst = out + (long)row * stride + c0;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// grid (ceil(S/BK), B*KH), 128 threads: one warpgroup per 64-key tile,
// accumulating the columns [C0, C0 + NC) of dK and dV
template <int D, int C0, int NC>
__global__ void __launch_bounds__(128)
dkv_wgmma(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          const __grid_constant__ CUtensorMap tm_do,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
          int S, int H, int KH, int causal, int window, float scale) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = hopper::align1024(smem_raw);
  uint8_t* vs = ks + T::BYTES;
  uint8_t* qs = vs + T::BYTES;              // two stages
  uint8_t* dos = qs + 2 * T::BYTES;         // two stages
  uint64_t* bar = reinterpret_cast<uint64_t*>(dos + 2 * T::BYTES);
  // bar[0]: K and V; bar[1 + s]: the Q and dO tiles of stage s
  float* rows = reinterpret_cast<float*>(bar + 4);
  // rows[2 BQ s + i]: log2(e) lse of query i of stage s; + BQ: its delta

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / KH;
  const int kh = blockIdx.y % KH;
  const int G = H / KH;

  // query tiles that reach this key tile, each for the G heads of the
  // group: step it takes tile it / G and head kh G + it % G
  const int k_last = min(k0 + BK, S) - 1;
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  const int q_end = window > 0 ? min(S, k_last + window) : S;  // exclusive
  const int steps = (q_end - q_begin + BQ - 1) / BQ * G;

  // what this thread stages for step `it`: one query's lse or delta
  auto row_value = [&](int it) {
    const int qpos = q_begin + (it / G) * BQ + tid % BQ;
    if (tid >= 2 * BQ || qpos >= S) return 0.f;
    const long row = ((long)b * H + kh * G + it % G) * S + qpos;
    return tid < BQ ? lse[row] * LOG2E : delta[row];
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bar[i], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    load_pair<D>(ks, &tm_k, vs, &tm_v, &bar[0], kh, k0, b);
    load_pair<D>(qs, &tm_q, dos, &tm_do, &bar[1], kh * G, q_begin, b);
  }
  if (tid < 2 * BQ) rows[tid] = row_value(0);
  __syncthreads();

  // this thread's accumulator rows r0 and r0 + 8, columns 8 j + c0 + 0..1
  const int r0 = warp * 16 + lane / 4, c0 = 2 * (lane % 4);
  const float scale_log2 = scale * LOG2E;
  float acc_dk[NC / 2], acc_dv[NC / 2], acc_s[BQ / 2], acc_dp[BQ / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  hopper::mbar_wait(&bar[0], 0);
  for (int it = 0; it < steps; ++it) {
    const int st = it & 1;
    const int q0 = q_begin + (it / G) * BQ;
    float staged = 0.f;
    if (it + 1 < steps) {
      // the other stage was freed by the barrier that ended the last step
      if (tid == 0)
        load_pair<D>(qs + (st ^ 1) * T::BYTES, &tm_q,
                     dos + (st ^ 1) * T::BYTES, &tm_do, &bar[2 - st],
                     kh * G + (it + 1) % G, q_begin + (it + 1) / G * BQ, b);
      staged = row_value(it + 1);
    }
    hopper::mbar_wait(&bar[1 + st], (it >> 1) & 1);
    const uint8_t* qst = qs + st * T::BYTES;
    const uint8_t* dost = dos + st * T::BYTES;

    // S^T = K Q^T and dP^T = V dO^T, keys on M and queries on N, all
    // K-major, committed as two groups: P^T is computed while dP^T is on
    // the tensor cores, and dS^T while dV is
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) acc_s[i] = acc_dp[i] = 0.f;
    hopper::fence_regs<BQ / 2>(acc_s);
    hopper::fence_regs<BQ / 2>(acc_dp);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::WgmmaSS<BQ, 0, 0>::run(acc_s, T::kmajor(ks, kk),
                                     T::kmajor(qst, kk));
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::WgmmaSS<BQ, 0, 0>::run(acc_dp, T::kmajor(vs, kk),
                                     T::kmajor(dost, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();              // S^T is done
    hopper::fence_regs<BQ / 2>(acc_s);

    // P^T = exp(scale S^T - lse), lse by column (query); masks only where
    // the tile needs them
    const float* lse2 = rows + st * 2 * BQ;
    const float* dl = lse2 + BQ;
    const bool inside = k0 + BK <= S && q0 + BQ <= S &&
                        (!causal || k0 + BK - 1 <= q0) &&
                        (window <= 0 || k0 > q0 + BQ - 1 - window);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, col = 8 * j + c0 + (e & 1);
        bool ok = true;
        if (!inside) {
          const int kpos = k0 + r0 + (e >> 1) * 8, qpos = q0 + col;
          ok = kpos < S && qpos < S;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
        }
        acc_s[i] = ok ? exp2f(acc_s[i] * scale_log2 - lse2[col]) : 0.f;
      }
    }
    uint32_t pa[BQ / 16][4];
    hopper::to_a_fragments<BQ>(acc_s, pa);

    // dV += P^T dO: queries are the reduction, so dO is an MN-major B
    hopper::fence_regs<NC / 2>(acc_dv);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      rs_columns<D, C0, NC>(acc_dv, pa[kk], dost, kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();              // dP^T is done; dV may run on
    hopper::fence_regs<BQ / 2>(acc_dp);

    // dS^T = P^T (dP^T - delta) scale, delta by column: 0 where P^T is
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc_dp[4 * j + e] = acc_s[4 * j + e] *
                            (acc_dp[4 * j + e] - dl[8 * j + c0 + (e & 1)]) *
                            scale;
    uint32_t da[BQ / 16][4];
    hopper::to_a_fragments<BQ>(acc_dp, da);

    // dK += dS^T Q, Q an MN-major B of the same tile
    hopper::fence_regs<NC / 2>(acc_dk);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      rs_columns<D, C0, NC>(acc_dk, da[kk], qst, kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<NC / 2>(acc_dv);
    hopper::fence_regs<NC / 2>(acc_dk);
    if (it + 1 < steps && tid < 2 * BQ) rows[(st ^ 1) * 2 * BQ + tid] = staged;
    __syncthreads();            // this stage is consumed: it may be reloaded
  }

  const long base = ((long)b * S * KH + kh) * D + C0;
  store_rows<NC>(dk + base, (long)KH * D, acc_dk, k0, r0, c0, S);
  store_rows<NC>(dv + base, (long)KH * D, acc_dv, k0, r0, c0, S);
}

// grid (ceil(S/BQ), B*H), 128 threads: one warpgroup per 64-query tile
template <int D>
__global__ void __launch_bounds__(128)
dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
         const __grid_constant__ CUtensorMap tm_k,
         const __grid_constant__ CUtensorMap tm_v,
         const __grid_constant__ CUtensorMap tm_do,
         const float* __restrict__ lse, const float* __restrict__ delta,
         __nv_bfloat16* __restrict__ dq, int S, int H, int KH, int causal,
         int window, float scale) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = hopper::align1024(smem_raw);
  uint8_t* dos = qs + T::BYTES;
  uint8_t* ks = dos + T::BYTES;         // two stages
  uint8_t* vs = ks + 2 * T::BYTES;      // two stages
  uint64_t* bar = reinterpret_cast<uint64_t*>(vs + 2 * T::BYTES);
  // bar[0]: Q and dO; bar[1 + s]: the K and V tiles of stage s

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kh = h / (H / KH);

  // key tiles that the causal mask and the window leave
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;                  // exclusive
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_begin = (k_first / BK) * BK;
  const int ntiles = (k_end - k_begin + BK - 1) / BK;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bar[i], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    load_pair<D>(qs, &tm_q, dos, &tm_do, &bar[0], h, q0, b);
    load_pair<D>(ks, &tm_k, vs, &tm_v, &bar[1], kh, k_begin, b);
  }

  // this thread's rows r0 and r0 + 8: their log2(e) lse and delta
  const int r0 = warp * 16 + lane / 4, c0 = 2 * (lane % 4);
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + r0 + 8 * r;
    const long row = ((long)b * H + h) * S + qpos;
    lse2[r] = qpos < S ? lse[row] * LOG2E : 0.f;
    dl[r] = qpos < S ? delta[row] : 0.f;
  }
  const float scale_log2 = scale * LOG2E;
  float acc_dq[D / 2], acc_s[BK / 2], acc_dp[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dq[i] = 0.f;

  hopper::mbar_wait(&bar[0], 0);
  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    const int kt = k_begin + it * BK;
    if (tid == 0 && it + 1 < ntiles)
      // the other stage was freed by the barrier that ended the last tile
      load_pair<D>(ks + (st ^ 1) * T::BYTES, &tm_k, vs + (st ^ 1) * T::BYTES,
                   &tm_v, &bar[2 - st], kh, kt + BK, b);
    hopper::mbar_wait(&bar[1 + st], (it >> 1) & 1);
    const uint8_t* kst = ks + st * T::BYTES;
    const uint8_t* vst = vs + st * T::BYTES;

    // S = Q K^T and dP = dO V^T: queries on M, keys on N, all K-major
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) acc_s[i] = acc_dp[i] = 0.f;
    hopper::fence_regs<BK / 2>(acc_s);
    hopper::fence_regs<BK / 2>(acc_dp);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::WgmmaSS<BK, 0, 0>::run(acc_s, T::kmajor(qs, kk),
                                     T::kmajor(kst, kk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::WgmmaSS<BK, 0, 0>::run(acc_dp, T::kmajor(dos, kk),
                                     T::kmajor(vst, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<BK / 2>(acc_s);
    hopper::fence_regs<BK / 2>(acc_dp);

    // P and dS = P (dP - delta) scale, masks only where the tile needs them
    const bool inside = kt + BK <= S && q0 + BQ <= S &&
                        (!causal || kt + BK - 1 <= q0) &&
                        (window <= 0 || kt > q0 + BQ - 1 - window);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, r = e >> 1;
        bool ok = true;
        if (!inside) {
          const int qpos = q0 + r0 + 8 * r, kpos = kt + 8 * j + c0 + (e & 1);
          ok = kpos < S && qpos < S;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
        }
        const float p = ok ? exp2f(acc_s[i] * scale_log2 - lse2[r]) : 0.f;
        acc_dp[i] = p * (acc_dp[i] - dl[r]) * scale;
      }
    }
    uint32_t da[BK / 16][4];
    hopper::to_a_fragments<BK>(acc_dp, da);

    // dQ += dS K: keys are the reduction, K an MN-major B
    hopper::fence_regs<D / 2>(acc_dq);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      rs_columns<D, 0, D>(acc_dq, da[kk], kst, kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<D / 2>(acc_dq);
    __syncthreads();            // this stage is consumed: it may be reloaded
  }

  store_rows<D>(dq + ((long)b * S * H + h) * D, (long)H * D, acc_dq, q0, r0,
                c0, S);
}

// the 64-row tensor maps of q, k, v and do
int encode_maps(CUtensorMap* tm_q, CUtensorMap* tm_k, CUtensorMap* tm_v,
                CUtensorMap* tm_do, const void* q, const void* k,
                const void* v, const void* dout, int B, int S, int H, int KH,
                int D) {
  int rc = hopper::encode_bshd(tm_q, q, B, S, H, D, BQ);
  if (rc == 0) rc = hopper::encode_bshd(tm_do, dout, B, S, H, D, BQ);
  if (rc == 0) rc = hopper::encode_bshd(tm_k, k, B, S, KH, D, BK);
  if (rc == 0) rc = hopper::encode_bshd(tm_v, v, B, S, KH, D, BK);
  return rc;
}

// dkv_wgmma over the columns [C0, D), dkv_cols<D>() columns a launch
template <int D, int C0>
int launch_dkv_columns(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                       const CUtensorMap& tm_v, const CUtensorMap& tm_do,
                       const float* lse, const float* delta, void* dk,
                       void* dv, int B, int S, int H, int KH, int causal,
                       int window, cudaStream_t stream) {
  constexpr int NC = D - C0 < dkv_cols<D>() ? D - C0 : dkv_cols<D>();
  constexpr size_t smem = wgmma_smem<D>();
  static_assert(smem <= MAX_SMEM, "dkv_wgmma: shared memory past a block");
  // once per instantiation (a thread-safe static)
  static const cudaError_t attr = cudaFuncSetAttribute(
      dkv_wgmma<D, C0, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + BK - 1) / BK, B * KH);
  dkv_wgmma<D, C0, NC><<<grid, 128, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, H, KH, causal, window,
      1.0f / sqrtf((float)D));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (C0 + NC < D)
    return launch_dkv_columns<D, C0 + NC>(tm_q, tm_k, tm_v, tm_do, lse,
                                          delta, dk, dv, B, S, H, KH, causal,
                                          window, stream);
  return 0;
}

template <int D>
int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dk, void* dv, int B, int S, int H, int KH,
                     int causal, int window, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int rc = encode_maps(&tm_q, &tm_k, &tm_v, &tm_do, q, k, v, dout, B, S, H,
                       KH, D);
  if (rc != 0) return rc;
  return launch_dkv_columns<D, 0>(tm_q, tm_k, tm_v, tm_do, lse, delta, dk,
                                  dv, B, S, H, KH, causal, window, stream);
}

template <int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq, int B, int S, int H, int KH, int causal,
                    int window, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int rc = encode_maps(&tm_q, &tm_k, &tm_v, &tm_do, q, k, v, dout, B, S, H,
                       KH, D);
  if (rc != 0) return rc;
  constexpr size_t smem = wgmma_smem<D>();
  static_assert(smem <= MAX_SMEM, "dq_wgmma: shared memory past a block");
  static const cudaError_t attr = cudaFuncSetAttribute(
      dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  dq_wgmma<D><<<grid, 128, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<__nv_bfloat16*>(dq),
      S, H, KH, causal, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

// f(std::integral_constant<int, D>) for D in {32, 64, 128, 192, 256}
template <typename F>
int by_head_dim(int D, F f) {
  switch (D) {
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    case 192: return f(std::integral_constant<int, 192>());
    case 256: return f(std::integral_constant<int, 256>());
    default: return cudaErrorInvalidValue;
  }
}

// 0 to go on, else the entry point's return code
int check_args(const void* q, const void* k, const void* v,
               const void* dout, int B, int S, int H, int KH, int dtype) {
  if (B < 1 || S < 1 || KH < 1 || H % KH != 0) return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (dtype == 1 && !(hopper::aligned16(q) && hopper::aligned16(k) &&
                      hopper::aligned16(v) && hopper::aligned16(dout)))
    return hopper::ERR_MISALIGNED;
  return 0;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  window <= 0: no window.  Each returns a
// cudaError_t (0 on success), hopper::ERR_MISALIGNED for a bf16 q, k, v or
// do whose base is not 16-byte aligned, or hopper::ERR_TENSOR_MAP + a
// CUresult when a TMA tensor map cannot be encoded.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int S,
                                       int H, int KH, int D, int causal,
                                       int window, int dtype, void* stream) {
  const int rc = check_args(q, k, v, dout, B, S, H, KH, dtype);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  return by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return dtype == 0
               ? (int)launch_dkv_f32<kD>(q, k, v, dout, l, dl, dk, dv, B, S,
                                         H, KH, causal, window, st)
               : launch_dkv_wgmma<kD>(q, k, v, dout, l, dl, dk, dv, B, S, H,
                                      KH, causal, window, st);
  });
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int B, int S, int H, int KH,
                                      int D, int causal, int window,
                                      int dtype, void* stream) {
  const int rc = check_args(q, k, v, dout, B, S, H, KH, dtype);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  return by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return dtype == 0
               ? (int)launch_dq_f32<kD>(q, k, v, dout, l, dl, dq, B, S, H, KH,
                                        causal, window, st)
               : launch_dq_wgmma<kD>(q, k, v, dout, l, dl, dq, B, S, H, KH,
                                     causal, window, st);
  });
}
