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
// einsum) has two kernels of its own, `gmm_dx_kernel` and
// `gmm_dw_kernel`, for the shapes a training step gives them: K = f long
// (1408-14336) for dX, K = C short (240-340, 4-6 64-row tiles) for dW.
// Their tiling is chosen by `backward_plan` in kernels/moe_gmm.py, whose
// numbers the entry points check.  Bounds (bf16, 3.35 TB/s, 989
// TFLOP/s): qwen2-moe's E60 C340 d2048 f1408 (and down, d and f swapped)
// reads or writes the 346 MB weight once, 487 MB in all: bytes, 0.1454
// ms (operations 0.119); moonshot's E64 C240, 475 MB: bytes, 0.1419
// (0.090); jamba's E16 C320 d4096 f14336, 2.07 GB and 601 GFLOP: bytes
// 0.617 ms and operations 0.608, both.
//
// dX = dY W^T (`gmm_dx_kernel`; M = d on wgmma's rows, N = C, K = f).
//  * What held the forward's tiling back here: C 320 / 340 cut into three
//    128-wide tiles (384 columns computed) of 128 x 128 blocks, so each w
//    tile was read into shared memory once per C tile.
//  * A block takes 128 d rows (two consumer warpgroups of 64) and N
//    columns of C, N a multiple of 8 up to 216, in as few groups along C
//    as pad it by fewer than 16 columns: 2 x 160 at C 320, 2 x 176 at 340,
//    2 x 120 at 240.  Each consumer thread holds N / 2 f32 sums; from
//    N 224 ptxas spills within the 168 registers a 288-thread block
//    leaves a thread.  wgmma has N 120, 160, 176 and 240 besides the
//    forward's widths; any other N is two or three instructions
//    (`hopper::wgmma_kmajor_b`).
//  * 3-5 stages 64 deep (3 up to N 128, 4 up to 160, 5 above), as they
//    measured fastest on the H100 at K 1408 and 14,336.  The epilogue
//    stages the (d, C) sums through the drained ring and writes 16-byte
//    rows of dx.
//  * The last k-tile is issued and waited for outside the k loop: with
//    the wait after the loop ptxas moved the epilogue's conversions of the
//    sums above it (wrong sums, different bits a launch).
//  * What still holds it back: each k-tile of a block is 36 KB of TMA
//    loads (at N 160) for 1.3 M multiply-adds, and with those loads in
//    flight the tensor cores run well below their rate even while data is
//    waiting; clusters that multicast w or dy to 2 or 4 blocks, and a
//    persistent grid that stores by TMA, were tried and made no shape
//    faster.
//
// dW = X^T dY (`gmm_dw_kernel`; M = d, N = f, K = C).
//  * What held the forward's tiling back here: 4-6 k-tiles a block, a
//    grid of 217 waves at jamba, each block filling its ring from cold
//    and then writing its tile with nothing overlapping, with 3.7x the
//    output's bytes filled from L2.
//  * A persistent grid of one block per SM takes the (expert, 256 d rows)
//    units in turn (unit b, b + grid, ...), so the blocks that run at once
//    walk the same experts' dy tiles together.  A block holds x's whole C
//    panel for its 256 d rows in shared memory (256 x C rounded up to 32,
//    176 KB at C 340) while the f tiles of dy stream through a ring of
//    64-row stages, so the fills are about C / 256 of the output's bytes
//    (1.3x).  The panel loads as two halves of C rows with barriers of
//    their own, so the next unit's first half loads under the old unit's
//    last tile.
//  * The producer runs ahead into the next tile's dy while the consumers
//    write the last tile's sums straight from registers; the four lanes
//    that hold one output row trade their column pairs by shuffles, so
//    each writes 16 bytes (with 4-byte stores the writes took longer than
//    the products).
//  * C above 384 (no panel fits) takes the forward's kernel with both
//    operands MN-major, one block a 128 x 256 tile.
//
// Both: every output element is one block's, summed over K in one fixed
// order in f32, so two launches give the same bits (no split-K, no
// atomics).  f32, and widths that are not multiples of 8, take
// `gmm_kernel` with strides.
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
// dW at C above DW_MAX_KP (1, 1) with A = dy read as (C, f), B = x read
// as (C, d).
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

// ---------------------------------------------------------------------------
// The backward's own kernels.  Both take two consumer warpgroups; dX a
// producer warpgroup, which gives its registers to the consumers, dW one
// producer warp.  The numbers below are the ones kernels/moe_gmm.py's
// `backward_plan` mirrors.
// ---------------------------------------------------------------------------
constexpr int DX_THREADS = 3 * 128;
constexpr int DW_THREADS = 2 * 128 + 32;
// dX's registers a thread: 168 at launch (65,536 over 384 threads); the
// producer warpgroup drops to 40 and the consumers take 232: up to
// 2 x 184 / 2 f32 sums and 48 more
constexpr int DX_PRODUCER_REGS = 40;
constexpr int DX_CONSUMER_REGS = 232;
constexpr int MAX_STAGES = 8;
constexpr int SMEM_MAX = 232448;     // dynamic shared memory a block may take
constexpr int BARRIERS = 256;        // bytes kept for the mbarriers
constexpr int DX_ROWS = 2 * WM;      // d rows a dX block takes
constexpr int DX_MAX_N = 184;        // dX's tile width, two tiles a block
constexpr int DW_PANEL = 256;        // d rows of x a dW block holds
constexpr int DW_TILE = 128;         // f columns of a dW output tile
constexpr int DW_K = 64;             // C rows of a dW ring stage
constexpr int DW_STAGE = DW_TILE * DW_K * 2;   // two 64-column boxes
constexpr int DW_MAX_KP = 384;       // the largest panel next to 2 stages

// one dX stage: the two warpgroups' w tiles (64 d rows of 64 f each) and
// the block's 2 N rows of dy (64 f each)
__host__ __device__ constexpr int dx_stage(int n) {
  return 2 * A_BYTES + 2 * n * WK * 2;
}
constexpr size_t bwd_smem(int payload) {
  return 1024 + static_cast<size_t>(payload) + BARRIERS;
}
// a dW block: the panel of 256 d rows by kp C rows and the ring
constexpr size_t dw_smem(int kp, int stages) {
  return bwd_smem(DW_PANEL * kp * 2 + stages * DW_STAGE);
}

// dX's products of k-tile kt for consumer warpgroup wg: wait for its
// stage, then D (64 x 2N) += w tile (64 x 64) dy tile^T (64 x 2N) as four
// k16 steps of two N-column wgmmas (tile t's sums at acc + t N / 2), both
// operands K-major, committed as one group
template <int N>
__device__ __forceinline__ void dx_mma(float* acc, const uint8_t* smem,
                                       uint64_t* full, int kt, int stages,
                                       int wg) {
  const int s = kt % stages;
  hopper::mbar_wait(&full[s], (kt / stages) & 1);
  const uint8_t* a = smem + s * dx_stage(N) + wg * A_BYTES;
  const uint8_t* b = smem + s * dx_stage(N) + 2 * A_BYTES;
  hopper::fence_regs<N>(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < WK / 16; ++kk) {
    // 32 bytes along the swizzled row a step
    const uint64_t da = hopper::make_desc(a + kk * 32, 16, 1024,
                                          hopper::SW128);
#pragma unroll
    for (int t = 0; t < 2; ++t)
      hopper::wgmma_kmajor_b<N, 0>(
          acc + t * N / 2, da,
          hopper::make_desc(b + t * N * 128 + kk * 32, 16, 1024,
                            hopper::SW128));
  }
  hopper::wgmma_commit();
}

// dx[e] (C x D, row-major) = dy[e] (C x F) w[e]^T for the block's 128 d
// rows (blockIdx.x) and its 2 N columns of C (blockIdx.y), as two tiles
// of N.  The producer is a warpgroup of its own, which gives its
// registers to the two consumer warpgroups (setmaxnreg): 2 x N / 2 f32
// sums a consumer thread.
template <int N>
__global__ void __launch_bounds__(DX_THREADS, 1)
gmm_dx_kernel(const __grid_constant__ CUtensorMap tm_w,
              const __grid_constant__ CUtensorMap tm_dy,
              __nv_bfloat16* __restrict__ dx, int C, int D, int F,
              int stages) {
  constexpr int STAGE = dx_stage(N);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * STAGE);
  uint64_t* empty = full + MAX_STAGES;

  const int e = blockIdx.z;
  const int m0 = blockIdx.x * DX_ROWS, c0 = blockIdx.y * 2 * N;
  const int ktiles = (F + WK - 1) / WK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);         // one arrival per warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // each warpgroup stays in its branch to the end, so that ptxas keeps
  // its register budget
  if (warp >= 8) {
    // producer warpgroup: one thread keeps up to `stages` k-tiles in
    // flight
    hopper::setmaxnreg_dec<DX_PRODUCER_REGS>();
    if (warp == 8 && lane == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % stages;
        if (kt >= stages) hopper::mbar_wait(&empty[s], (kt / stages - 1) & 1);
        uint8_t* a = smem + s * STAGE;
        hopper::mbar_expect_tx(&full[s], STAGE);
        for (int g = 0; g < 2; ++g)
          hopper::tma_load_3d(a + g * A_BYTES, &tm_w, &full[s], kt * WK,
                              m0 + g * WM, e);
        for (int t = 0; t < 2; ++t)
          hopper::tma_load_3d(a + 2 * A_BYTES + t * N * 128, &tm_dy,
                              &full[s], kt * WK, c0 + t * N, e);
      }
    }
  } else {
    // consumer warpgroup wg: d rows m0 + 64 wg .. + 63 by the 2 N columns
    hopper::setmaxnreg_inc<DX_CONSUMER_REGS>();
    const int wg = warp / 4;
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
    // every k-tile but the last keeps one group in flight and then frees
    // the stage before it.  (Waiting at kt = 0 too keeps the loop free of
    // a branch around the wait, where ptxas serialises the wgmmas: C7514.)
    for (int kt = 0; kt + 1 < ktiles; ++kt) {
      dx_mma<N>(acc, smem, full, kt, stages, wg);
      hopper::wgmma_wait<1>();
      hopper::fence_regs<N>(acc);
      if (kt > 0 && lane == 0)
        hopper::mbar_arrive(&empty[(kt - 1) % stages]);
    }
    // the last k-tile is waited for in straight-line code: waited for
    // after the loop, ptxas moved the epilogue's reads of the sums above
    // the final wait (wrong sums, other bits each launch)
    dx_mma<N>(acc, smem, full, ktiles - 1, stages, wg);
    hopper::wgmma_wait<0>();
    hopper::fence_regs<N>(acc);

    // Every k-tile has landed here and been consumed: once both
    // warpgroups are done, the ring holds the (d, C) sums staged as dx
    // rows (2 N x 128 d).
    constexpr int OP = DX_ROWS + 8;    // staged row, padded
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    __nv_bfloat16* ot = reinterpret_cast<__nv_bfloat16*>(smem);
    const int fr = wg * WM + (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int c = t * N + j * 8 + (lane % 4) * 2;
        const float* v = acc + t * N / 2 + 4 * j;
        ot[c * OP + fr] = __float2bfloat16(v[0]);
        ot[(c + 1) * OP + fr] = __float2bfloat16(v[1]);
        ot[c * OP + fr + 8] = __float2bfloat16(v[2]);
        ot[(c + 1) * OP + fr + 8] = __float2bfloat16(v[3]);
      }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    // 16-byte stores along d; D % 8 == 0, so a group of 8 is all inside
    // D or all past it
    constexpr int G = DX_ROWS / 8;
    __nv_bfloat16* oe = dx + (long)e * C * D;
    for (int i = threadIdx.x; i < 2 * N * G; i += 256) {
      const int r = i / G, g = i % G;
      const int n = c0 + r, m = m0 + g * 8;
      if (n < C && m < D)
        *reinterpret_cast<uint4*>(oe + (long)n * D + m) =
            *reinterpret_cast<const uint4*>(ot + r * OP + g * 8);
    }
  }
}

// dW's products of one ring stage for consumer warpgroup wg: its 128 d
// rows (two 64-row tiles of the panel) by the 128 f columns of the stage,
// over STEPS k16 steps from C row 64 kc (4, or 2 for a last stage of 32
// rows), committed as one group.  Both operands MN-major: a k16 step is
// 16 rows of 128 bytes; B's two 64-column boxes are DW_K rows apart
// (LBO).
template <int STEPS>
__device__ __forceinline__ void dw_mma(float (*acc)[DW_TILE / 2],
                                       const uint8_t* panel,
                                       const uint8_t* b, int kp, int kc,
                                       int wg) {
  hopper::fence_regs<DW_TILE / 2>(acc[0]);
  hopper::fence_regs<DW_TILE / 2>(acc[1]);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
    const uint64_t db = hopper::make_desc(b + kk * 2048, DW_K * 128, 1024,
                                          hopper::SW128);
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
      hopper::WgmmaSS<DW_TILE, 1, 1>::run(
          acc[mb],
          hopper::make_desc(
              panel + ((2 * wg + mb) * kp + kc * DW_K + kk * 16) * 128, 16,
              1024, hopper::SW128),
          db);
  }
  hopper::wgmma_commit();
}

// dw[e] (D x F, row-major) = x[e]^T (D x C) dy[e] (C x F).  The work
// comes in units, one an (expert, 256 d rows) panel of x, E ceil(D / 256)
// of them; block b of the persistent grid takes units b, b + grid, ...
// (d panel fastest), so the blocks that run at once are on the same
// experts and walk the same f tiles of dy together, which L2 then serves
// to all of them.  A block holds its unit's panel (four 64-column blocks
// of kp rows of C, kp = C rounded up to 32) in shared memory and streams
// the unit's ceil(F / 128) f tiles of dy through the ring in stages of 64
// C rows (the last of a tile 32 when kp is an odd number of 32s).  The
// panel is loaded as two halves of C rows, each with its own barriers:
// the next unit's first half loads once the last tile has passed it, the
// second while the consumers write that tile and start on the next unit.
__global__ void __launch_bounds__(DW_THREADS, 1)
gmm_dw_kernel(const __grid_constant__ CUtensorMap tm_x0,
              const __grid_constant__ CUtensorMap tm_x1,
              const __grid_constant__ CUtensorMap tm_dy,
              __nv_bfloat16* __restrict__ dw, int E, int D, int F, int kp,
              int stages) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* panel = hopper::align1024(smem_raw);
  uint8_t* ring = panel + DW_PANEL * kp * 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * DW_STAGE);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* panel_full = empty + MAX_STAGES;       // [2]: one a half
  uint64_t* panel_empty = panel_full + 2;          // [2]

  const int np = (D + DW_PANEL - 1) / DW_PANEL;
  const int nf = (F + DW_TILE - 1) / DW_TILE;
  const int units = E * np;
  const int chunks = (kp + DW_K - 1) / DW_K;      // ring stages a tile
  const bool short_last = kp % DW_K != 0;         // of 32 rows
  // the panel's halves: stages [0, h0) and [h0, chunks), rows [0, rows0)
  // and [rows0, kp); no second half when the tile is one stage
  const int h0 = (chunks + 1) / 2, h1 = chunks - h0;
  const int rows0 = min(h0 * DW_K, kp);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);         // one arrival per warp
    }
    for (int h = 0; h < 2; ++h) {
      hopper::mbar_init(&panel_full[h], 1);
      hopper::mbar_init(&panel_empty[h], 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    if (lane == 0) {
      long it = 0;                             // ring loads so far
      for (int u = blockIdx.x, i = 0; u < units; u += gridDim.x, ++i) {
        const int e = u / np, d0 = (u % np) * DW_PANEL;
        for (int ft = 0; ft < nf; ++ft) {
          for (int kc = 0; kc < chunks; ++kc, ++it) {
            if (ft == 0 && (kc == 0 || kc == h0)) {
              // a half of the panel, once the last unit is done with it
              const int h = kc == 0 ? 0 : 1;
              const int r = h == 0 ? 0 : rows0;
              if (i > 0) hopper::mbar_wait(&panel_empty[h], (i - 1) & 1);
              hopper::mbar_expect_tx(&panel_full[h],
                                     DW_PANEL * (h == 0 ? rows0 : kp - rows0)
                                     * 2);
              for (int j = 0; j < DW_PANEL / 64; ++j)
                hopper::tma_load_3d(panel + (j * kp + r) * 128,
                                    h == 0 ? &tm_x0 : &tm_x1, &panel_full[h],
                                    d0 + j * 64, r, e);
            }
            const int s = static_cast<int>(it % stages);
            if (it >= stages)
              hopper::mbar_wait(&empty[s], (it / stages - 1) & 1);
            hopper::mbar_expect_tx(&full[s], DW_STAGE);
            for (int j = 0; j < DW_TILE / 64; ++j)
              hopper::tma_load_3d(ring + s * DW_STAGE + j * DW_K * 128,
                                  &tm_dy, &full[s], ft * DW_TILE + j * 64,
                                  kc * DW_K, e);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: d rows 128 wg .. + 127 of the panel, as two
  // 64-row wgmma tiles, by all 128 f columns of the tile
  const int wg = warp / 4;
  float acc[2][DW_TILE / 2];
  long it = 0;
  for (int u = blockIdx.x, i = 0; u < units; u += gridDim.x, ++i) {
    const int e = u / np;
    const int r0 = (u % np) * DW_PANEL + wg * 128 + (warp % 4) * 16 +
                   lane / 4;
    __nv_bfloat16* oe = dw + (long)e * D * F;
    for (int ft = 0; ft < nf; ++ft) {
      const bool last = ft == nf - 1;
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int c = 0; c < DW_TILE / 2; ++c) acc[mb][c] = 0.f;
      // the stage of chunk kc has landed (and, on the unit's first tile,
      // the panel half it reads)
      auto ready = [&](int kc) -> const uint8_t* {
        if (ft == 0 && (kc == 0 || kc == h0))
          hopper::mbar_wait(&panel_full[kc == 0 ? 0 : 1], i & 1);
        const int s = static_cast<int>((it + kc) % stages);
        hopper::mbar_wait(&full[s], ((it + kc) / stages) & 1);
        return ring + s * DW_STAGE;
      };
      // every stage but the last keeps one group in flight and frees the
      // stage before it (and, past the unit's last reads of the first
      // half, that half); the last is waited for in straight-line code,
      // as dX's
      for (int kc = 0; kc + 1 < chunks; ++kc) {
        dw_mma<DW_K / 16>(acc, panel, ready(kc), kp, kc, wg);
        hopper::wgmma_wait<1>();
        hopper::fence_regs<DW_TILE / 2>(acc[0]);
        hopper::fence_regs<DW_TILE / 2>(acc[1]);
        if (kc > 0 && lane == 0) {
          hopper::mbar_arrive(&empty[(it + kc - 1) % stages]);
          if (last && kc == h0) hopper::mbar_arrive(&panel_empty[0]);
        }
      }
      const uint8_t* b = ready(chunks - 1);
      if (short_last)
        dw_mma<DW_K / 32>(acc, panel, b, kp, chunks - 1, wg);
      else
        dw_mma<DW_K / 16>(acc, panel, b, kp, chunks - 1, wg);
      hopper::wgmma_wait<0>();
      hopper::fence_regs<DW_TILE / 2>(acc[0]);
      hopper::fence_regs<DW_TILE / 2>(acc[1]);
      if (lane == 0) {
        if (chunks > 1)
          hopper::mbar_arrive(&empty[(it + chunks - 2) % stages]);
        hopper::mbar_arrive(&empty[(it + chunks - 1) % stages]);
        if (last && h0 >= chunks - 1) hopper::mbar_arrive(&panel_empty[0]);
        if (last && h1 > 0) hopper::mbar_arrive(&panel_empty[1]);
      }
      it += chunks;
      // epilogue straight from the registers, while the producer loads
      // the next tile: the four lanes that share a row trade their column
      // pairs (a 4 x 4 transpose in two shuffle steps), so that each lane
      // writes 16 bytes, 8 f columns (F % 8 == 0: all inside F or all
      // past it)
      const int q = lane % 4;
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + mb * 64 + h * 8;
#pragma unroll
          for (int g = 0; g < DW_TILE / 32; ++g) {
            // m[k]: this lane's pair of columns in 8-column chunk 4 g + k
            uint32_t m[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              m[k] = hopper::pack_bf16(acc[mb][4 * (4 * g + k) + 2 * h],
                                       acc[mb][4 * (4 * g + k) + 2 * h + 1]);
#pragma unroll
            for (int t = 0; t < 2; ++t) {      // lanes q ^ 1: bit 0 of k
              const uint32_t got = __shfl_xor_sync(
                  0xffffffffu, (q & 1) ? m[2 * t] : m[2 * t + 1], 1);
              if (q & 1) m[2 * t] = got; else m[2 * t + 1] = got;
            }
#pragma unroll
            for (int t = 0; t < 2; ++t) {      // lanes q ^ 2: bit 1 of k
              const uint32_t got = __shfl_xor_sync(
                  0xffffffffu, (q & 2) ? m[t] : m[t + 2], 2);
              if (q & 2) m[t] = got; else m[t + 2] = got;
            }
            // now chunk 4 g + q of the row, columns in order
            const int col = ft * DW_TILE + (4 * g + q) * 8;
            if (row < D && col < F)
              *reinterpret_cast<uint4*>(oe + (long)row * F + col) =
                  make_uint4(m[0], m[1], m[2], m[3]);
          }
        }
    }
  }
}

template <int N>
int launch_dx(const void* dy, const void* w, void* dx, int E, int C, int D,
              int F, int groups, int stages, cudaStream_t st) {
  CUtensorMap tm_w, tm_dy;
  // w: boxes of 64 d rows by 64 f; dy: boxes of N C rows (a tile) by 64 f
  int rc = encode_3d(&tm_w, w, E, D, F, WM);
  if (rc == 0) rc = encode_3d(&tm_dy, dy, E, C, F, N);
  if (rc != 0) return rc;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmm_dx_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((D + DX_ROWS - 1) / DX_ROWS, groups, E);
  gmm_dx_kernel<N><<<grid, DX_THREADS, bwd_smem(stages * dx_stage(N)), st>>>(
      tm_w, tm_dy, static_cast<__nv_bfloat16*>(dx), C, D, F, stages);
  return cudaGetLastError();
}

int launch_dw(const void* x, const void* dy, void* dw, int E, int C, int D,
              int F, int kp, int grid, int stages, cudaStream_t st) {
  // the panel's two halves of C rows as the kernel cuts them (a box holds
  // <= 256 rows; a second half of 0 rows gets a box of 32, unused)
  const int chunks = (kp + DW_K - 1) / DW_K, h0 = (chunks + 1) / 2;
  const int rows0 = h0 * DW_K < kp ? h0 * DW_K : kp;
  CUtensorMap tm_x0, tm_x1, tm_dy;
  int rc = encode_3d(&tm_x0, x, E, C, D, rows0);
  if (rc == 0) rc = encode_3d(&tm_x1, x, E, C, D, kp > rows0 ? kp - rows0
                                                             : 32);
  if (rc == 0) rc = encode_3d(&tm_dy, dy, E, C, F, DW_K);
  if (rc != 0) return rc;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmm_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  gmm_dw_kernel<<<grid, DW_THREADS, dw_smem(kp, stages), st>>>(
      tm_x0, tm_x1, tm_dy, static_cast<__nv_bfloat16*>(dw), E, D, F, kp,
      stages);
  return cudaGetLastError();
}

#define DX_WIDTHS(X)                                                      \
  X(8) X(16) X(24) X(32) X(40) X(48) X(56) X(64) X(72) X(80) X(88) X(96)  \
  X(104) X(112) X(120) X(128) X(136) X(144) X(152) X(160) X(168) X(176)  \
  X(184)

int dispatch_dx(const void* dy, const void* w, void* dx, int E, int C, int D,
                int F, int n, int groups, int stages, cudaStream_t st) {
  switch (n) {
#define DX_CASE(w_)                                                       \
  case w_:                                                                \
    return launch_dx<w_>(dy, w, dx, E, C, D, F, groups, stages, st);
    DX_WIDTHS(DX_CASE)
#undef DX_CASE
    default: return cudaErrorInvalidValue;
  }
}

// The plan's numbers as `backward_plan` gives them, checked: true if the
// kernels can run them.  dX: blocks of two tiles of n columns, `groups` of
// them covering C, none empty; the ring within shared memory.
bool dx_plan_ok(int C, int n, int groups, int stages) {
  if (n < 8 || n > DX_MAX_N || n % 8 != 0 || groups < 1 || groups > 65535 ||
      (long)2 * n * groups < C || (long)2 * n * (groups - 1) >= C)
    return false;
  // the epilogue stages 2 n rows of 136 bf16 in the ring
  return stages >= 2 && stages <= MAX_STAGES &&
         bwd_smem(stages * dx_stage(n)) <= (size_t)SMEM_MAX &&
         2 * n * (DX_ROWS + 8) * 2 <= stages * dx_stage(n);
}

// dW: grid 0 is the streaming kernel (kp and stages unused); else a
// panel of kp >= C rows (a multiple of 32, at most DW_MAX_KP) and at most
// one block per unit (expert, d panel)
bool dw_plan_ok(int E, int C, int D, int kp, int grid, int stages) {
  if (grid == 0) return true;
  const long units = (long)E * ((D + DW_PANEL - 1) / DW_PANEL);
  return grid > 0 && grid <= units && kp >= C && kp % 32 == 0 &&
         kp <= DW_MAX_KP && stages >= 2 && stages <= MAX_STAGES &&
         dw_smem(kp, stages) <= (size_t)SMEM_MAX;
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
// dx (E, C, d), in their dtype, f32 accumulation.  n, groups and stages
// are `backward_plan`'s dX tiling (used on the tensor-core path only); a
// plan the kernel cannot run returns cudaErrorInvalidValue.  Other codes
// as expert_gemm.
extern "C" int expert_gemm_dx(const void* dy, const void* w, void* dx, int E,
                              int C, int D, int F, int dtype, int n,
                              int groups, int stages, void* stream) {
  const int bad = check(E, C, D, F, dtype);
  if (bad >= 0) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides s{(long)C * F, F, 1, (long)D * F, 1, F};
  if (!tensor_cores(dtype, D, F)) {
    if (dtype == 0) return dispatch<float>(dy, w, dx, E, C, F, D, s, st);
    return dispatch<__nv_bfloat16>(dy, w, dx, E, C, F, D, s, st);
  }
  if (!dx_plan_ok(C, n, groups, stages)) return cudaErrorInvalidValue;
  if (!hopper::aligned16(dy) || !hopper::aligned16(w) ||
      !hopper::aligned16(dx))
    return hopper::ERR_MISALIGNED;
  return dispatch_dx(dy, w, dx, E, C, D, F, n, groups, stages, st);
}

// The backward's dW = X^T dY per expert, summed over C in one fixed order
// (each output tile is one block's, which walks C in sequence): x (E, C,
// d), dy (E, C, f) -> dw (E, d, f).  kp, grid and stages are
// `backward_plan`'s dW tiling (grid 0: the streaming kernel, for C above
// DW_MAX_KP); a plan the kernel cannot run returns cudaErrorInvalidValue.
// Other codes as expert_gemm.
extern "C" int expert_gemm_dw(const void* x, const void* dy, void* dw, int E,
                              int C, int D, int F, int dtype, int kp,
                              int grid, int stages, void* stream) {
  const int bad = check(E, C, D, F, dtype);
  if (bad >= 0) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides s{(long)C * D, 1, D, (long)C * F, F, 1};
  if (!tensor_cores(dtype, D, F)) {
    if (dtype == 0) return dispatch<float>(x, dy, dw, E, D, C, F, s, st);
    return dispatch<__nv_bfloat16>(x, dy, dw, E, D, C, F, s, st);
  }
  if (!dw_plan_ok(E, C, D, kp, grid, stages)) return cudaErrorInvalidValue;
  if (!hopper::aligned16(x) || !hopper::aligned16(dy) ||
      !hopper::aligned16(dw))
    return hopper::ERR_MISALIGNED;
  if (grid > 0) return launch_dw(x, dy, dw, E, C, D, F, kp, grid, stages, st);
  // D (f x d) = dy^T x: A = dy (C, f) MN-major, B = x (C, d) MN-major
  return dispatch_wgmma<1, 1>(dy, C, F, x, C, D, dw, E, D, C, F, st);
}
