// k-means routing assignment (paper Eq. 1) for Hopper (sm_90a), written by
// hand in CUDA C++.
//
// Replaces the TPU kernel repro/kernels/router_assign.py:29 `router_assign`
// (pallas_call :39, body `_assign_kernel` :18): for each feature row z,
// argmin_k ||z - c_k||^2 and the minimum itself, with the distance in the
// expanded form (||z||^2 - 2 z.c) + ||c||^2 accumulated in f32, as
// `_assign_kernel` :21-24 computes it.  Ties go to the first index, as
// jnp.argmin does; a row with no finite distance (NaN or inf input) gets
// index 0 and min d2 +inf.  z (N,D), centroids (K,D), f32 or bf16,
// contiguous; out: assign (N,) int32, mind2 (N,) f32.
//
// What bounds it on the H100.  2 N K D operations on N D + K D inputs: at
// N 65536, D 896, K 256 that is 30 GFLOP on 235 MB (f32).  On the CUDA
// cores (67 TFLOP/s f32) that is 0.45 ms of arithmetic; on the tensor
// cores, as three TF32 products (495 TFLOP/s), 0.18 ms, above the 0.07 ms
// of bytes.  At the training slice's K = 4 it is bound by reading z.
//
// What the design does about it (`assign_wgmma_kernel`).
//  * The z.c products run on wgmma with f32 accumulators.  bf16 inputs:
//    m64nNk16 bf16 (bf16 x bf16 products are exact in f32, so this is the
//    TPU kernel's f32-upcast product up to summation order).  f32 inputs
//    (what k-means passes): 3xTF32 on m64nNk8 tf32, hi = tf32(x),
//    lo = tf32(x - hi), z.c ~ lo_z.hi_c + hi_z.lo_c + hi_z.hi_c, each
//    product within about 2^-22 of its f32 value (one TF32 product keeps
//    about 3 digits, which the f32 bar of the plain version would not
//    pass).  Both halves are computed explicitly; nothing relies on the
//    hardware ignoring low mantissa bits.
//  * Rows of z lie on wgmma's 64-row M: two consumer warpgroups a block,
//    each on its own 64 rows.  When the centroid tile is 32 or narrower
//    the block's work is the z stream alone, and four warpgroups share
//    one 64-row tile, taking its D chunks in turn and summing their
//    accumulators at the end (K = 4 at N 2048: 0.015 ms replayed from a
//    CUDA graph on an H100 at 700 W, 0.020 with one warpgroup).
//    Centroids lie on N: a tile of K
//    rounded up to 8 (8, 16, 32, then multiples of 64 up to 256, as n64
//    products); K > 256 walks tiles of at most 256 and keeps a running
//    (min, index) per row.  D is the reduction, in 128-byte chunks (32 f32
//    or 64 bf16) with the 128-byte swizzle, loaded by TMA into a ring of
//    stages by a producer warp and completing on mbarriers.
//  * z is A, read from its staged tile into registers (where f32 splits
//    into hi and lo, and ||z||^2 is summed in f32 from the same values);
//    two fragment sets alternate, so the loads of one half-chunk overlap
//    the products of the other.  The centroids are B: a small kernel
//    first writes their TF32 hi and lo tables (f32) and ||c||^2 into the
//    caller's workspace, once per call, and the ring streams them (bf16
//    streams the centroids as they are).
//  * Epilogue: d2 = (||z||^2 - 2 acc) + ||c||^2 for every accumulator
//    element, each thread scanning its columns in increasing index (strict
//    <, so ties keep the first), then the four lanes that share a row
//    combine with ties to the lower index.
// TMA needs 16-byte row strides and bases.  D not a multiple of 4 (f32)
// or 8 (bf16) takes the CUDA-core kernel (`assign_kernel`, below), as
// expert_gemm does for odd widths; a z (or bf16 centroid) base that is not
// 16-byte aligned returns hopper::ERR_MISALIGNED.  There is no fallback
// on any other failure.
//
// The CUDA-core kernel: one block per 64 rows of z walks the centroids in
// tiles of 64 and D in chunks of 32, staging one z chunk and one centroid
// chunk in shared memory; each thread owns 4 rows x 4 centroids and keeps
// a running (min, index) per row; the 16 threads of a row combine with
// shuffles.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {


constexpr int BR = 64;          // rows of z per block
constexpr int BC = 64;          // centroids per tile
constexpr int DC = 32;          // feature columns per chunk
constexpr int THREADS = 256;
constexpr int CP = DC + 1;      // padded chunk row
static_assert(BR == BC, "one staging loop fills both tiles");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// (d, i) is better than (bd, bi): smaller distance, ties to the first index
__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
assign_kernel(const T* __restrict__ z, const T* __restrict__ c,
              int* __restrict__ assign, float* __restrict__ mind2, int N,
              int K, int D) {
  __shared__ float Zs[BR * CP];
  __shared__ float Cs[BC * CP];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * BR;
  const int rg = tid >> 4, cg = tid & 15;   // rows rg*4+a, centroids cg+16*jj

  float zz[4] = {0.f, 0.f, 0.f, 0.f};
  float best_d[4];
  int best_i[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    best_d[a] = CUDART_INF_F;
    best_i[a] = K;
  }

  for (int c0 = 0; c0 < K; c0 += BC) {
    float dot[4][4], cc[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      cc[jj] = 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a) dot[a][jj] = 0.f;
    }
    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();            // previous chunk fully consumed
      for (int e = tid; e < BR * DC; e += THREADS) {
        const int r = e / DC, col = e % DC;
        const int row = r0 + r, dd = d0 + col;
        Zs[r * CP + col] =
            (row < N && dd < D) ? to_f(z[(long)row * D + dd]) : 0.f;
        const int ci = c0 + r;
        Cs[r * CP + col] =
            (ci < K && dd < D) ? to_f(c[(long)ci * D + dd]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int col = 0; col < DC; ++col) {
        float zv[4], cv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) zv[a] = Zs[(rg * 4 + a) * CP + col];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) cv[jj] = Cs[(cg + 16 * jj) * CP + col];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) cc[jj] += cv[jj] * cv[jj];
        if (c0 == 0) {
#pragma unroll
          for (int a = 0; a < 4; ++a) zz[a] += zv[a] * zv[a];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) dot[a][jj] += zv[a] * cv[jj];
      }
    }
    // this thread's centroids in increasing index: a strict < keeps the
    // first of equal distances
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int ci = c0 + cg + 16 * jj;
      if (ci >= K) continue;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float d2 = (zz[a] - 2.0f * dot[a][jj]) + cc[jj];
        if (d2 < best_d[a]) {
          best_d[a] = d2;
          best_i[a] = ci;
        }
      }
    }
  }

  // combine the 16 threads of each row group (lanes differ in bits 0-3)
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, best_d[a], off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i[a], off);
      if (better(od, oi, best_d[a], best_i[a])) {
        best_d[a] = od;
        best_i[a] = oi;
      }
    }
    const int row = r0 + rg * 4 + a;
    if (cg == 0 && row < N) {
      // no finite distance at all (NaN or inf input): index 0, as
      // jnp.argmin gives for a row of NaNs
      assign[row] = best_i[a] < K ? best_i[a] : 0;
      mind2[row] = best_d[a];
    }
  }
}


// ---------------------------------------------------------------------------
// Tensor cores
// ---------------------------------------------------------------------------
constexpr int ROW = 128;          // bytes of one staged row of D
constexpr int PREP_THREADS = 128;

template <typename T>
struct Elem {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int PER_ROW = ROW / sizeof(T);   // 32 f32, 64 bf16
  static constexpr int TABLES = F32 ? 2 : 1;        // hi and lo, or c
  static constexpr int HALF_FRAGS = F32 ? 16 : 8;   // A registers a half
};

// Up to N 32, DS = 4 warpgroups take turns at the D chunks of one 64-row
// tile; from N 64, two warpgroups on their own 64 rows share each chunk.
template <typename T, int N>
struct Plan {
  static constexpr int WGS = N <= 32 ? 1 : 2;       // row tiles a block
  static constexpr int DS = N <= 32 ? 4 : 1;        // warpgroups along D
  static constexpr int CWG = WGS * DS;              // consumer warpgroups
  static constexpr int BM = 64 * WGS;               // rows of z a block
  static constexpr int THREADS = 128 * CWG + 32;    // + the producer warp
  static constexpr int W = N < 64 ? N : 64;         // width of one wgmma
  static constexpr int ZB = BM * ROW;               // staged z bytes
  static constexpr int CB = N * ROW;                // one centroid table
  static constexpr int STAGE = ZB + Elem<T>::TABLES * CB;
  static constexpr int FIT = 200 * 1024 / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr size_t SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
  // the D split's partial sums, staged through the drained ring
  static constexpr int RED = 128 * CWG * (N / 2 + 2) * 4;
  static_assert(STAGES >= 2, "two stages fit");
  static_assert(DS == 1 || RED <= STAGES * STAGE, "the D split's sums fit");
  // a warpgroup of the D split waits on a stage's next phase only after
  // it consumed the phase before it
  static_assert(STAGES % DS == 0, "each stage has one consumer warpgroup");
};

// ||c||^2 in f32 for each centroid and, for f32, its TF32 hi and lo
// tables: one block per centroid
template <typename T>
__global__ void __launch_bounds__(PREP_THREADS)
centroid_prep_kernel(const T* __restrict__ c, float* __restrict__ hi,
                     float* __restrict__ lo, float* __restrict__ cc, int D) {
  __shared__ float part[PREP_THREADS / 32];
  const long base = (long)blockIdx.x * D;
  float s = 0.f;
  for (int d = threadIdx.x; d < D; d += PREP_THREADS) {
    const float x = to_f(c[base + d]);
    s += x * x;
    if (Elem<T>::F32) {
      const float h = __uint_as_float(hopper::to_tf32(x));
      hi[base + d] = h;
      lo[base + d] = __uint_as_float(hopper::to_tf32(x - h));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < PREP_THREADS / 32; ++w) t += part[w];
    cc[blockIdx.x] = t;
  }
}

// The A fragment of k step kk (32 bytes of the staged row) for rows R and
// R + 8: (R, 4t), (R + 8, 4t), (R, 16 + 4t), (R + 8, 16 + 4t) bytes into
// the step, through the 128-byte swizzle (16-byte chunk c of row R sits at
// chunk c ^ (R % 8); the tile starts on a 1024-byte boundary).  For f32
// these are columns t and t + 4 of the k8 step, for bf16 the pairs at
// 2t and 8 + 2t of the k16 step: the layouts of WgmmaTF32RS and WgmmaRS.
__device__ __forceinline__ void load_a(const uint8_t* tile, int R, int t,
                                       int kk, uint32_t* x) {
  const uint8_t* r0 = tile + R * ROW + 4 * t;
  const uint8_t* r1 = r0 + 8 * ROW;
  const int o0 = ((2 * kk) ^ (R & 7)) << 4;
  const int o1 = ((2 * kk + 1) ^ (R & 7)) << 4;
  x[0] = *reinterpret_cast<const uint32_t*>(r0 + o0);
  x[1] = *reinterpret_cast<const uint32_t*>(r1 + o0);
  x[2] = *reinterpret_cast<const uint32_t*>(r0 + o1);
  x[3] = *reinterpret_cast<const uint32_t*>(r1 + o1);
}

__device__ __forceinline__ uint64_t b_desc(const uint8_t* table, int j,
                                           int w, int kk) {
  return hopper::make_desc(table + j * w * ROW + kk * 32, 16, 1024,
                           hopper::SW128);
}

// Half a staged chunk: k steps 2h and 2h + 1.  load() fills the A
// registers (and adds this lane's share of ||z||^2 when `norms`);
// mma() runs the products into acc.
template <typename T, int N> struct Half;

template <int N>
struct Half<float, N> {
  static constexpr int W = Plan<float, N>::W;
  // f[8 i + 0..3]: hi of k step 2h + i; f[8 i + 4..7]: its lo
  static __device__ __forceinline__ void load(const uint8_t* z, int R,
                                              int t, int h, uint32_t* f,
                                              float& zz0, float& zz1,
                                              bool norms) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t x[4];
      load_a(z, R, t, 2 * h + i, x);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = __uint_as_float(x[q]);
        const uint32_t hi = hopper::to_tf32(v);
        f[8 * i + q] = hi;
        f[8 * i + 4 + q] = hopper::to_tf32(v - __uint_as_float(hi));
      }
      if (norms) {
        const float v0 = __uint_as_float(x[0]), v1 = __uint_as_float(x[1]);
        const float v2 = __uint_as_float(x[2]), v3 = __uint_as_float(x[3]);
        zz0 += v0 * v0 + v2 * v2;
        zz1 += v1 * v1 + v3 * v3;
      }
    }
  }
  static __device__ __forceinline__ void mma(float* acc, const uint32_t* f,
                                             const uint8_t* chi,
                                             const uint8_t* clo, int h) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kk = 2 * h + i;
#pragma unroll
      for (int j = 0; j < N / W; ++j) {
        const uint64_t dhi = b_desc(chi, j, W, kk);
        // the small products first, then hi . hi
        hopper::WgmmaTF32RS<W>::run(acc + j * W / 2, f + 8 * i + 4, dhi);
        hopper::WgmmaTF32RS<W>::run(acc + j * W / 2, f + 8 * i,
                                    b_desc(clo, j, W, kk));
        hopper::WgmmaTF32RS<W>::run(acc + j * W / 2, f + 8 * i, dhi);
      }
    }
  }
};

template <int N>
struct Half<__nv_bfloat16, N> {
  static constexpr int W = Plan<__nv_bfloat16, N>::W;
  static __device__ __forceinline__ float sq2(uint32_t x) {
    const float a = __uint_as_float(x << 16);
    const float b = __uint_as_float(x & 0xffff0000u);
    return a * a + b * b;
  }
  // f[4 i + 0..3]: k step 2h + i
  static __device__ __forceinline__ void load(const uint8_t* z, int R,
                                              int t, int h, uint32_t* f,
                                              float& zz0, float& zz1,
                                              bool norms) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      load_a(z, R, t, 2 * h + i, f + 4 * i);
      if (norms) {
        zz0 += sq2(f[4 * i]) + sq2(f[4 * i + 2]);
        zz1 += sq2(f[4 * i + 1]) + sq2(f[4 * i + 3]);
      }
    }
  }
  static __device__ __forceinline__ void mma(float* acc, const uint32_t* f,
                                             const uint8_t* c,
                                             const uint8_t*, int h) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < N / W; ++j)
        hopper::WgmmaRS<W, 0>::run(acc + j * W / 2, f + 4 * i,
                                   b_desc(c, j, W, 2 * h + i));
  }
};

template <typename T, int N>
__global__ void __launch_bounds__(Plan<T, N>::THREADS, 1)
assign_wgmma_kernel(const __grid_constant__ CUtensorMap tm_z,
                    const __grid_constant__ CUtensorMap tm_c,
                    const __grid_constant__ CUtensorMap tm_lo,
                    const float* __restrict__ cc, int* __restrict__ assign,
                    float* __restrict__ mind2, int rows, int K, int D) {
  using P = Plan<T, N>;
  using E = Elem<T>;
  constexpr int S = P::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * P::STAGE);
  uint64_t* empty = full + S;

  const int r0 = blockIdx.x * P::BM;
  const int chunks = (D + E::PER_ROW - 1) / E::PER_ROW;
  const int tiles = (K + N - 1) / N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * P::WGS);   // one arrival per warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * P::CWG) {
    // producer: one thread keeps up to S chunks in flight
    if (lane == 0) {
      int it = 0;
      for (int ct = 0; ct < tiles; ++ct)
        for (int kc = 0; kc < chunks; ++kc, ++it) {
          const int s = it % S;
          if (it >= S) hopper::mbar_wait(&empty[s], (it / S - 1) & 1);
          uint8_t* st = smem + s * P::STAGE;
          hopper::mbar_expect_tx(&full[s], P::STAGE);
          const int col = kc * E::PER_ROW;
          hopper::tma_load_2d(st, &tm_z, &full[s], col, r0);
          hopper::tma_load_2d(st + P::ZB, &tm_c, &full[s], col, ct * N);
          if (E::F32)
            hopper::tma_load_2d(st + P::ZB + P::CB, &tm_lo, &full[s], col,
                                ct * N);
        }
    }
    return;
  }

  // consumer warpgroup wg: rows R and R + 8 of the block's z tile, and
  // the chunks kc with kc % DS == dg
  const int wg = warp / 4, dg = wg % P::DS;
  const int R = (wg / P::DS) * 64 + (warp % 4) * 16 + lane / 4;
  const int t = lane % 4;
  float acc[N / 2];
  uint32_t f0[E::HALF_FRAGS], f1[E::HALF_FRAGS];
  float zz0 = 0.f, zz1 = 0.f;
  float bd0 = CUDART_INF_F, bd1 = CUDART_INF_F;
  int bi0 = K, bi1 = K;
  int it = 0;
  for (int ct = 0; ct < tiles; ++ct) {
    const bool norms = ct == 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    int pending = -1;         // the chunk whose stage is still held
    for (int kc = 0; kc < chunks; ++kc, ++it) {
      if (P::DS > 1 && kc % P::DS != dg) continue;
      const int s = it % S;
      hopper::mbar_wait(&full[s], (it / S) & 1);
      const uint8_t* st = smem + s * P::STAGE;
      const uint8_t* c = st + P::ZB;
      // first half: its fragment set was last read by the previous
      // chunk's first half, complete since that chunk's second wait
      Half<T, N>::load(st, R, t, 0, f0, zz0, zz1, norms);
      hopper::fence_regs<N / 2>(acc);
      hopper::wgmma_fence();
      Half<T, N>::mma(acc, f0, c, c + P::CB, 0);
      hopper::wgmma_commit();
      if (pending >= 0) {
        // the previous chunk's second half is done: its stage is free
        hopper::wgmma_wait<1>();
        if (lane == 0) hopper::mbar_arrive(&empty[pending % S]);
      }
      Half<T, N>::load(st, R, t, 1, f1, zz0, zz1, norms);
      hopper::wgmma_fence();
      Half<T, N>::mma(acc, f1, c, c + P::CB, 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();      // this chunk's first half is done
      pending = it;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs<N / 2>(acc);
    if (pending >= 0 && lane == 0) hopper::mbar_arrive(&empty[pending % S]);

    if (P::DS > 1) {
      // one centroid tile (N <= 32 covers K): warpgroup 0 adds the other
      // warpgroups' sums in order, through the drained ring
      constexpr int STRIDE = N / 2 + 2;
      float* red = reinterpret_cast<float*>(smem);
      asm volatile("bar.sync 1, %0;\n" :: "n"(128 * P::CWG) : "memory");
      if (dg > 0) {
        float* mine = red + threadIdx.x * STRIDE;
#pragma unroll
        for (int i = 0; i < N / 2; ++i) mine[i] = acc[i];
        mine[N / 2] = zz0;
        mine[N / 2 + 1] = zz1;
      }
      asm volatile("bar.sync 1, %0;\n" :: "n"(128 * P::CWG) : "memory");
      if (dg > 0) return;
#pragma unroll
      for (int g = 1; g < P::DS; ++g) {
        const float* other = red + (threadIdx.x + 128 * g) * STRIDE;
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[i] += other[i];
        zz0 += other[N / 2];
        zz1 += other[N / 2 + 1];
      }
    }

    if (norms) {
      // the four lanes of a row hold its columns t, t + 4 of every step
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        zz0 += __shfl_xor_sync(0xffffffffu, zz0, off);
        zz1 += __shfl_xor_sync(0xffffffffu, zz1, off);
      }
    }
    // this thread's columns in increasing index: a strict < keeps the
    // first of equal distances
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ci = ct * N + 8 * j + 2 * t + e;
        if (ci < K) {
          const float c2 = __ldg(cc + ci);
          const float d0 = (zz0 - 2.0f * acc[4 * j + e]) + c2;
          const float d1 = (zz1 - 2.0f * acc[4 * j + 2 + e]) + c2;
          if (d0 < bd0) { bd0 = d0; bi0 = ci; }
          if (d1 < bd1) { bd1 = d1; bi1 = ci; }
        }
      }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float o0 = __shfl_xor_sync(0xffffffffu, bd0, off);
    const int i0 = __shfl_xor_sync(0xffffffffu, bi0, off);
    const float o1 = __shfl_xor_sync(0xffffffffu, bd1, off);
    const int i1 = __shfl_xor_sync(0xffffffffu, bi1, off);
    if (better(o0, i0, bd0, bi0)) { bd0 = o0; bi0 = i0; }
    if (better(o1, i1, bd1, bi1)) { bd1 = o1; bi1 = i1; }
  }
  if (t == 0) {
    // no finite distance (NaN or inf input): index 0, as jnp.argmin
    // gives for a row of NaNs
    const int row0 = r0 + R, row1 = row0 + 8;
    if (row0 < rows) {
      assign[row0] = bi0 < K ? bi0 : 0;
      mind2[row0] = bd0;
    }
    if (row1 < rows) {
      assign[row1] = bi1 < K ? bi1 : 0;
      mind2[row1] = bd1;
    }
  }
}

template <typename T, int N>
int launch_wgmma(const void* z, const void* c, int* assign, float* mind2,
                 float* work, int rows, int K, int D, cudaStream_t st) {
  using P = Plan<T, N>;
  using E = Elem<T>;
  const CUtensorMapDataType type = E::F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  float* hi = work;                                 // f32: (K, D) each
  float* lo = work + (long)K * D;
  float* cc = E::F32 ? work + 2L * K * D : work;    // (K,)
  const cuuint64_t zd[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t cd[2] = {(cuuint64_t)D, (cuuint64_t)K};
  const cuuint64_t stride[1] = {(cuuint64_t)D * sizeof(T)};
  const cuuint32_t zb[2] = {E::PER_ROW, P::BM};
  const cuuint32_t cb[2] = {E::PER_ROW, N};
  CUtensorMap tm_z, tm_c, tm_lo;
  int rc = hopper::encode(&tm_z, type, z, 2, zd, stride, zb,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = hopper::encode(&tm_c, type, E::F32 ? (const void*)hi : c, 2, cd,
                        stride, cb, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0 && E::F32)
    rc = hopper::encode(&tm_lo, type, lo, 2, cd, stride, cb,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  if (!E::F32) tm_lo = tm_c;                        // unused
  centroid_prep_kernel<T><<<K, PREP_THREADS, 0, st>>>(
      static_cast<const T*>(c), hi, lo, cc, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // once per instantiation (a thread-safe static)
  static const cudaError_t attr = cudaFuncSetAttribute(
      assign_wgmma_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)P::SMEM);
  if (attr != cudaSuccess) return attr;
  assign_wgmma_kernel<T, N><<<(rows + P::BM - 1) / P::BM, P::THREADS,
                              P::SMEM, st>>>(tm_z, tm_c, tm_lo, cc, assign,
                                             mind2, rows, K, D);
  return cudaGetLastError();
}

// The centroid tile: K in ceil(K / 256) tiles of equal share, each share
// rounded up to a width of 8, 16, 32 or a multiple of 64
int tile_width(int K) {
  const int tiles = (K + 255) / 256;
  const int share = (K + tiles - 1) / tiles;
  constexpr int widths[] = {8, 16, 32, 64, 128, 192, 256};
  for (int n : widths)
    if (share <= n) return n;
  return 256;
}

template <typename T>
int dispatch_wgmma(const void* z, const void* c, int* assign, float* mind2,
                   float* work, int rows, int K, int D, cudaStream_t st) {
  switch (tile_width(K)) {
    case 8: return launch_wgmma<T, 8>(z, c, assign, mind2, work, rows, K, D, st);
    case 16: return launch_wgmma<T, 16>(z, c, assign, mind2, work, rows, K, D, st);
    case 32: return launch_wgmma<T, 32>(z, c, assign, mind2, work, rows, K, D, st);
    case 64: return launch_wgmma<T, 64>(z, c, assign, mind2, work, rows, K, D, st);
    case 128: return launch_wgmma<T, 128>(z, c, assign, mind2, work, rows, K, D, st);
    case 192: return launch_wgmma<T, 192>(z, c, assign, mind2, work, rows, K, D, st);
    default: return launch_wgmma<T, 256>(z, c, assign, mind2, work, rows, K, D, st);
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  `work`: f32 scratch of 2 K D + K floats
// for f32, K for bf16 (the centroid tables and norms), 16-byte aligned.
// Returns a cudaError_t (0 on success), hopper::ERR_MISALIGNED for a base
// that TMA cannot load, or hopper::ERR_TENSOR_MAP + a CUresult when a TMA
// tensor map cannot be encoded.
extern "C" int router_assign(const void* z, const void* c, void* assign,
                             void* mind2, void* work, int N, int K, int D,
                             int dtype, void* stream) {
  if (N < 1 || K < 1 || D < 1 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* a = static_cast<int*>(assign);
  float* m = static_cast<float*>(mind2);
  float* w = static_cast<float*>(work);
  // rows of z or c that are not 16-byte strides: no TMA
  if (D % (dtype == 0 ? 4 : 8) != 0) {
    const dim3 grid((N + BR - 1) / BR);
    if (dtype == 0)
      assign_kernel<float><<<grid, THREADS, 0, st>>>(
          static_cast<const float*>(z), static_cast<const float*>(c), a, m,
          N, K, D);
    else
      assign_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
          static_cast<const __nv_bfloat16*>(z),
          static_cast<const __nv_bfloat16*>(c), a, m, N, K, D);
    return cudaGetLastError();
  }
  if (!hopper::aligned16(z) || (dtype == 1 && !hopper::aligned16(c)) ||
      !hopper::aligned16(work))
    return hopper::ERR_MISALIGNED;
  if (dtype == 0) return dispatch_wgmma<float>(z, c, a, m, w, N, K, D, st);
  return dispatch_wgmma<__nv_bfloat16>(z, c, a, m, w, N, K, D, st);
}
