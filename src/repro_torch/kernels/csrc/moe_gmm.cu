// Per-expert batched GEMM for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the TPU kernel repro/kernels/moe_gmm.py:38 `expert_gemm`
// (pallas_call :49, body `_gmm_kernel` :20): out[e] = x[e] @ w[e] for
// x (E,C,d), w (E,d,f), out (E,C,f), with an f32 accumulator, as
// `_gmm_kernel` :26-29 accumulates.  x and w f32 or bf16 (one type),
// contiguous; out in their type.
//
// What bounds it on the H100.  2 E C d f operations on E (C d + d f) + E C f
// elements.  At the MoE layer's decode step (E60 C8 d2048 f1408, bf16) the
// expert weights are 346 MB and the operations 2.8 GFLOP: bound by bytes
// (0.10 ms), since the dense dispatch is dropless over every expert.  The
// routing prefix (C 21) is bound by the same bytes.  At a long prefill
// (C 1360, 470 GFLOP) it is bound by the bf16 tensor-core rate (0.48 ms).
//
// What the design does about it (bf16: `gmm_wgmma_kernel`).
//  * A and B are swapped so that f lies on wgmma's 64-row M and C on its
//    N: D (f x C) = w[e]^T x[e]^T.  The weight tile (64 d rows of 64
//    contiguous f) is an MN-major A (wgmma's transpose bit), the x tile
//    (N rows of 64 contiguous d) a K-major B.  N, a multiple of 8 up to
//    256, covers all of C when C <= 256 (8 at a decode step, 24 at C 21),
//    so each weight byte is read once for all of C; above 256, C is cut
//    into tiles of 128 or 256, whichever pads less (1360 -> 11 x 128),
//    and the re-reads of a weight tile come from L2.
//  * One producer warp issues TMA loads of the tiles into a ring of
//    shared-memory stages, completing on mbarriers; the consumer
//    warpgroups run wgmma on the stages that have arrived and free each
//    stage once the next one's wgmma is in flight.  Up to N 96 (a decode
//    step, the routing prefix) one consumer warpgroup and 4 stages:
//    small blocks (37 KB at N 8), several per SM, keep the weight stream
//    in flight.  From N 128 two warpgroups, each on its own 64 f rows,
//    share each x tile in 3 stages (a 128 x N block; two per SM at
//    N 128), which halves the shared-memory reads of x per operation.
//  * 128-byte swizzle in both the TMA boxes and the wgmma descriptors.
//    The tensor maps are 3-D (over E), so the ragged edges of C and d
//    read zeros inside each expert; C and f are masked in the epilogue.
//  * Epilogue: the (f, C) accumulator is staged through the drained ring
//    and written as 16-byte stores along f rows of out, coalesced.
//  * Grid (ceil(f / (64 WGS)), ceil(C/N), E): 1,320 blocks at a decode
//    step on 132 SMs, so no split of d is needed.
// TMA needs 16-byte strides and base addresses.  bf16 inputs with d or f
// not a multiple of 8 (no expert width of the configurations; the card
// test's case E2 C33 d50 f30) go to the CUDA-core kernel; for a base that
// is not 16-byte aligned (a view that starts inside a row) the entry
// point returns hopper::ERR_MISALIGNED, which the wrapper raises on.
//
// The backward (no TPU kernel: the TPU package differentiates the
// einsum) reuses `gmm_wgmma_kernel` with the operand majors as template
// parameters, so no transposed copy of w (346 MB at full width) is made:
// dX = dY W^T (entry `expert_gemm_dx`) reads w as a K-major A (d rows of
// contiguous f) and dy as the K-major B; dW = X^T dY (`expert_gemm_dw`)
// takes K = C, dy as an MN-major A (C rows of contiguous f) and x as an
// MN-major B in 64-column boxes.  Each dW block owns its output tile and
// walks C in order with f32 sums, so two launches give the same bits.
// f32 and widths that are not multiples of 8 take `gmm_kernel` with
// strides.  At qwen2-moe's training products (E60 C340 d2048 f1408) each
// reads the 346 MB weight or writes its gradient once: bound by bytes.
//
// f32 keeps the CUDA-core kernel (`gmm_kernel`): wgmma takes f32 inputs
// only as TF32, about 3 decimal digits, which would break the f32 bar of
// 1e-4 against the plain version and the f32 token identity of the
// reference.  It runs one block per (expert, C tile, f tile) and loops
// over d in steps of 32 with its tile's sums in registers: 256 threads,
// each 4 (BM 64) or 1 (BM 16) rows by 4 columns of a 64-column tile.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BN = 64;          // output columns (f) per block
constexpr int BK = 32;          // reduction depth (d) per step
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes of w as floats
__device__ __forceinline__ void unpack(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}
__device__ __forceinline__ void unpack(const __nv_bfloat16* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// out[e] (M x F, row-major) = X[e] (M x K) W[e] (K x F), where element
// (r, k) of X[e] is x[e xe + r xr + k xk] and (k, f) of W[e] is
// w[e we + k wk + f wf]: the forward (X = x, W = w), dX (X = dy, W = w^T)
// and dW (X = x^T, W = dy) with strides, no transposed copy.  VEC: W's
// rows are contiguous (wf = 1), 16-byte aligned, F a multiple of 16 bytes.
struct Strides {
  long xe, xr, xk, we, wk, wf;
};

template <typename T, int BM, bool VEC>
__global__ void __launch_bounds__(THREADS)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ out, int M, int K, int F, Strides st) {
  constexpr int RM = BM / 16;                 // rows per thread
  constexpr int V = 16 / sizeof(T);           // elements per 16-byte load
  __shared__ float Xs[BM][BK + 1];
  __shared__ float Ws[BK][BN];
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const T* xe = x + e * st.xe;
  const T* we = w + e * st.we;

  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();            // the previous step's tiles are consumed
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i - r * BK;
      const int row = m0 + r, k = k0 + kk;
      Xs[r][kk] = (row < M && k < K)
                      ? to_f(xe[row * st.xr + k * st.xk]) : 0.f;
    }
    if (VEC) {
      // F % V == 0, so a group of V columns is all inside F or all past it
      for (int i = tid * V; i < BK * BN; i += THREADS * V) {
        const int kk = i / BN, c = i - kk * BN;
        const int k = k0 + kk, col = n0 + c;
        if (k < K && col < F) {
          unpack(we + k * st.wk + col, &Ws[kk][c]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) Ws[kk][c + v] = 0.f;
        }
      }
    } else {
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int kk = i / BN, c = i - kk * BN;
        const int k = k0 + kk, col = n0 + c;
        Ws[kk][c] = (k < K && col < F)
                        ? to_f(we[k * st.wk + col * st.wf]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float xv[RM], wv[4];
#pragma unroll
      for (int i = 0; i < RM; ++i) xv[i] = Xs[rg * RM + i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = Ws[kk][cg + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += xv[i] * wv[j];
    }
  }

  T* oe = out + (long)e * M * F;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = m0 + rg * RM + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + cg + 16 * j;
      if (col < F) put(&oe[(long)row * F + col], acc[i][j]);
    }
  }
}

template <typename T, int BM>
int launch(const void* x, const void* w, void* out, int E, int M, int K,
           int F, const Strides& s, cudaStream_t st) {
  const dim3 grid((F + BN - 1) / BN, (M + BM - 1) / BM, E);
  const int V = 16 / sizeof(T);
  const bool vec = s.wf == 1 && s.wk % V == 0 && F % V == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vec)
    gmm_kernel<T, BM, true><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), M, K, F, s);
  else
    gmm_kernel<T, BM, false><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), M, K, F, s);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, void* out, int E, int M, int K,
             int F, const Strides& s, cudaStream_t st) {
  if (M <= 32) return launch<T, 16>(x, w, out, E, M, K, F, s, st);
  return launch<T, 64>(x, w, out, E, M, K, F, s, st);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int WM = 64;               // f rows per consumer warpgroup
constexpr int WK = 64;               // d per stage: one 128-byte row
constexpr int A_BYTES = WM * WK * 2;  // one warpgroup's weight tile

// WGS consumer warpgroups, each on its own 64 f rows of the same x tile,
// and STAGES stages in the ring.
template <int N, int WGS, int STAGES>
struct GemmPlan {
  static constexpr int THREADS = 128 * WGS + 32;   // + the producer warp
  static constexpr int STAGE = WGS * A_BYTES + N * WK * 2;
  static constexpr int OP = WM * WGS + 8;          // staged out row, padded
  static constexpr size_t SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
  static_assert(N * OP * 2 <= STAGES * STAGE, "the epilogue fits the ring");
};

// D (M x N, M = 64 WGS a block) = A (M x K) B (K x N) per expert, out
// rows along N: out[e][n][m].  TA = 1: A is stored (K, M) with M
// contiguous (MN-major), else (M, K) with K contiguous; TB = 1: B is
// stored (K, N) with N contiguous, in 64-column boxes (N a multiple of
// 64), else (N, K).  The forward is (TA, TB) = (1, 0) with A = w, B = x;
// dX (0, 0) with A = w read as (d, f), B = dy; dW (1, 1) with A = dy read
// as (C, f), B = x read as (C, d).
template <int N, int WGS, int STAGES, int TA, int TB>
__global__ void __launch_bounds__(GemmPlan<N, WGS, STAGES>::THREADS)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_a,
                 __nv_bfloat16* __restrict__ out, int NT, int K, int MT) {
  using P = GemmPlan<N, WGS, STAGES>;
  static_assert(TB == 0 || N % 64 == 0, "MN-major B in 64-column boxes");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * P::STAGE);
  uint64_t* empty = full + STAGES;

  const int e = blockIdx.z;
  const int n0 = blockIdx.y * N, m0 = blockIdx.x * WM * WGS;
  const int ktiles = (K + WK - 1) / WK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * WGS);   // one arrival per warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * WGS) {
    // producer: one thread keeps up to STAGES tile sets in flight
    if (lane == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) hopper::mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
        uint8_t* a = smem + s * P::STAGE;
        uint8_t* b = a + WGS * A_BYTES;
        hopper::mbar_expect_tx(&full[s], P::STAGE);
        for (int g = 0; g < WGS; ++g) {
          if (TA)
            hopper::tma_load_3d(a + g * A_BYTES, &tm_a, &full[s],
                                m0 + g * WM, kt * WK, e);
          else
            hopper::tma_load_3d(a + g * A_BYTES, &tm_a, &full[s], kt * WK,
                                m0 + g * WM, e);
        }
        if (TB) {
          for (int j = 0; j < N / 64; ++j)
            hopper::tma_load_3d(b + j * WK * 128, &tm_b, &full[s],
                                n0 + j * 64, kt * WK, e);
        } else {
          hopper::tma_load_3d(b, &tm_b, &full[s], kt * WK, n0, e);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: M rows m0 + 64 wg .. + 63
  const int wg = warp / 4;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % STAGES;
    hopper::mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint8_t* a = smem + s * P::STAGE;
    const uint8_t* b = a + WGS * A_BYTES;
    hopper::fence_regs<N / 2>(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) {
      // MN-major: 16 K rows of 128 bytes per k16 step (B: LBO between its
      // 64-column boxes); K-major: 32 bytes along the swizzled row
      const uint64_t da =
          TA ? hopper::make_desc(a + wg * A_BYTES + kk * 2048, 16, 1024,
                                 hopper::SW128)
             : hopper::make_desc(a + wg * A_BYTES + kk * 32, 16, 1024,
                                 hopper::SW128);
      const uint64_t db =
          TB ? hopper::make_desc(b + kk * 2048, WK * 128, 1024,
                                 hopper::SW128)
             : hopper::make_desc(b + kk * 32, 16, 1024, hopper::SW128);
      hopper::WgmmaSS<N, TA, TB>::run(acc, da, db);
    }
    hopper::wgmma_commit();
    if (kt > 0) {
      // the previous stage's products are done: hand it back
      hopper::wgmma_wait<1>();
      hopper::fence_regs<N / 2>(acc);
      if (lane == 0) hopper::mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs<N / 2>(acc);

  // Every stage has landed and been consumed: once all consumer
  // warpgroups are done with the ring, it holds D (M x N) staged as out
  // rows (N x M).
  asm volatile("bar.sync 1, %0;\n" :: "n"(128 * WGS) : "memory");
  __nv_bfloat16* ot = reinterpret_cast<__nv_bfloat16*>(smem);
  const int fr = wg * WM + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = j * 8 + (lane % 4) * 2;
    ot[c * P::OP + fr] = __float2bfloat16(acc[4 * j]);
    ot[(c + 1) * P::OP + fr] = __float2bfloat16(acc[4 * j + 1]);
    ot[c * P::OP + fr + 8] = __float2bfloat16(acc[4 * j + 2]);
    ot[(c + 1) * P::OP + fr + 8] = __float2bfloat16(acc[4 * j + 3]);
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(128 * WGS) : "memory");
  // 16-byte stores along M; MT % 8 == 0, so a group of 8 columns is all
  // inside M or all past it
  constexpr int G = WM * WGS / 8;      // 16-byte groups per out row
  __nv_bfloat16* oe = out + (long)e * NT * MT;
  for (int i = threadIdx.x; i < N * G; i += 128 * WGS) {
    const int r = i / G, g = i % G;
    const int n = n0 + r, m = m0 + g * 8;
    if (n < NT && m < MT)
      *reinterpret_cast<uint4*>(oe + (long)n * MT + m) =
          *reinterpret_cast<const uint4*>(ot + r * P::OP + g * 8);
  }
}

// A (E, rows, cols) bf16 tensor map with boxes of `box_rows` rows by 64
// columns, 128-byte swizzle
inline int encode_3d(CUtensorMap* map, const void* base, int E, int rows,
                     int cols, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {WK, (cuuint32_t)box_rows, 1};
  return hopper::encode_bf16(map, base, 3, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B);
}

// The product of one (TA, TB) kind: `a` and `b` are the A and B operands
// as stored ((E, ar, ac) and (E, br, bc) bf16), out (E, NT, MT).
template <int N, int WGS, int STAGES, int TA, int TB>
int launch_wgmma(const void* a, int ar, int ac, const void* b, int br,
                 int bc, void* out, int E, int NT, int K, int MT,
                 cudaStream_t st) {
  using P = GemmPlan<N, WGS, STAGES>;
  CUtensorMap tm_a, tm_b;
  // A boxes: 64 x 64; B boxes: N rows by 64 (K-major) or 64 by 64
  int rc = encode_3d(&tm_a, a, E, ar, ac, WM);
  if (rc == 0) rc = encode_3d(&tm_b, b, E, br, bc, TB ? WK : N);
  if (rc != 0) return rc;
  // once per instantiation (a thread-safe static)
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmm_wgmma_kernel<N, WGS, STAGES, TA, TB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((MT + WM * WGS - 1) / (WM * WGS), (NT + N - 1) / N, E);
  gmm_wgmma_kernel<N, WGS, STAGES, TA, TB><<<grid, P::THREADS, P::SMEM, st>>>(
      tm_b, tm_a, static_cast<__nv_bfloat16*>(out), NT, K, MT);
  return cudaGetLastError();
}

// The N of the wgmma tile for NT columns: the smallest width that covers
// NT when NT <= 256 (one A stream per expert), else 128 or 256,
// whichever pads NT less; an MN-major B (mn) takes multiples of 64 only.
int pick_n(int NT, bool mn) {
  constexpr int widths[] = {8, 16, 24, 32, 48, 64, 96, 128, 192, 256};
  for (int n : widths)
    if (NT <= n && (!mn || n % 64 == 0)) return n;
  const int pad128 = (NT + 127) / 128 * 128, pad256 = (NT + 255) / 256 * 256;
  return pad128 < pad256 ? 128 : 256;
}

// Up to N 96 (a decode step, the routing prefix) one consumer warpgroup
// and 4 stages: small blocks, many in flight per SM for the A stream.
// From N 128 two warpgroups share each B tile (a 128 x N block) in 3
// stages, two such blocks per SM at N 128.
template <int TA, int TB>
int dispatch_wgmma(const void* a, int ar, int ac, const void* b, int br,
                   int bc, void* out, int E, int NT, int K, int MT,
                   cudaStream_t st) {
#define GMM_ARGS a, ar, ac, b, br, bc, out, E, NT, K, MT, st
  switch (pick_n(NT, TB == 1)) {
    case 64: return launch_wgmma<64, 1, 4, TA, TB>(GMM_ARGS);
    case 128: return launch_wgmma<128, 2, 3, TA, TB>(GMM_ARGS);
    case 192: return launch_wgmma<192, 2, 3, TA, TB>(GMM_ARGS);
    case 256: return launch_wgmma<256, 2, 3, TA, TB>(GMM_ARGS);
    default: break;
  }
  if constexpr (TB == 0) {
    switch (pick_n(NT, false)) {
      case 8: return launch_wgmma<8, 1, 4, TA, TB>(GMM_ARGS);
      case 16: return launch_wgmma<16, 1, 4, TA, TB>(GMM_ARGS);
      case 24: return launch_wgmma<24, 1, 4, TA, TB>(GMM_ARGS);
      case 32: return launch_wgmma<32, 1, 4, TA, TB>(GMM_ARGS);
      case 48: return launch_wgmma<48, 1, 4, TA, TB>(GMM_ARGS);
      case 96: return launch_wgmma<96, 1, 4, TA, TB>(GMM_ARGS);
      default: break;
    }
  }
#undef GMM_ARGS
  return cudaErrorInvalidValue;
}

// checks shared by the three entry points: -> -1 to go on, else the code
int check(int E, int C, int D, int F, int dtype) {
  if (E < 1 || C < 1 || D < 1 || F < 1 || E > 65535 ||
      (C + 15) / 16 > 65535 || (D + 15) / 16 > 65535)
    return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  return -1;
}

// bf16 with rows of 16-byte strides (d and f multiples of 8) go to the
// tensor cores; f32, or other widths, to the CUDA-core kernel
bool tensor_cores(int dtype, int D, int F) {
  return dtype == 1 && D % 8 == 0 && F % 8 == 0;
}

}  // namespace

// dtype of x, w and out: 0 = f32, 1 = bf16.  E <= 65535 and
// ceil(C / 16) <= 65535 (grid).  Returns a cudaError_t (0 on success),
// hopper::ERR_MISALIGNED for a bf16 input whose base is not 16-byte
// aligned, or hopper::ERR_TENSOR_MAP + a CUresult when a TMA tensor map
// cannot be encoded.
extern "C" int expert_gemm(const void* x, const void* w, void* out, int E,
                           int C, int D, int F, int dtype, void* stream) {
  const int bad = check(E, C, D, F, dtype);
  if (bad >= 0) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides s{(long)C * D, D, 1, (long)D * F, F, 1};
  if (!tensor_cores(dtype, D, F)) {
    if (dtype == 0) return dispatch<float>(x, w, out, E, C, D, F, s, st);
    return dispatch<__nv_bfloat16>(x, w, out, E, C, D, F, s, st);
  }
  if (!hopper::aligned16(x) || !hopper::aligned16(w) ||
      !hopper::aligned16(out))
    return hopper::ERR_MISALIGNED;
  // D (f x C) = w^T x^T: A = w (d, f) MN-major, B = x (C, d) K-major
  return dispatch_wgmma<1, 0>(w, D, F, x, C, D, out, E, C, D, F, st);
}

// The backward's dX = dY W^T per expert: dy (E, C, f), w (E, d, f) ->
// dx (E, C, d), in their dtype, f32 accumulation.  Codes as expert_gemm.
extern "C" int expert_gemm_dx(const void* dy, const void* w, void* dx, int E,
                              int C, int D, int F, int dtype, void* stream) {
  const int bad = check(E, C, D, F, dtype);
  if (bad >= 0) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides s{(long)C * F, F, 1, (long)D * F, 1, F};
  if (!tensor_cores(dtype, D, F)) {
    if (dtype == 0) return dispatch<float>(dy, w, dx, E, C, F, D, s, st);
    return dispatch<__nv_bfloat16>(dy, w, dx, E, C, F, D, s, st);
  }
  if (!hopper::aligned16(dy) || !hopper::aligned16(w) ||
      !hopper::aligned16(dx))
    return hopper::ERR_MISALIGNED;
  // D (d x C) = w dy^T: A = w (d, f) K-major, B = dy (C, f) K-major
  return dispatch_wgmma<0, 0>(w, D, F, dy, C, F, dx, E, C, F, D, st);
}

// The backward's dW = X^T dY per expert, summed over C in one fixed order
// (each block owns its tile of dW and walks C in sequence): x (E, C, d),
// dy (E, C, f) -> dw (E, d, f).  Codes as expert_gemm.
extern "C" int expert_gemm_dw(const void* x, const void* dy, void* dw, int E,
                              int C, int D, int F, int dtype, void* stream) {
  const int bad = check(E, C, D, F, dtype);
  if (bad >= 0) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides s{(long)C * D, 1, D, (long)C * F, F, 1};
  if (!tensor_cores(dtype, D, F)) {
    if (dtype == 0) return dispatch<float>(x, dy, dw, E, D, C, F, s, st);
    return dispatch<__nv_bfloat16>(x, dy, dw, E, D, C, F, s, st);
  }
  if (!hopper::aligned16(x) || !hopper::aligned16(dy) ||
      !hopper::aligned16(dw))
    return hopper::ERR_MISALIGNED;
  // D (f x d) = dy^T x: A = dy (C, f) MN-major, B = x (C, d) MN-major
  return dispatch_wgmma<1, 1>(dy, C, F, x, C, D, dw, E, D, C, F, st);
}
