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
// (0.10 ms), since the dense dispatch is dropless over every expert.  At a
// long prefill (C 1360) it is bound by arithmetic.
//
// What the design does about it.  The TPU grid walks d as a sequential
// axis into a VMEM accumulator; here one block per (expert, C tile, f tile)
// loops over d in steps of 32 and keeps its tile's sums in registers: 256
// threads, each 4 (BM 64) or 1 (BM 16) rows by 4 columns of the 64-column
// tile.  BM is 16 when C <= 32 (a decode step, the routing prefix), so a
// block reads its weight slab once for few rows without idle threads; 64
// otherwise.  The weight tile (32 x 64) is read with one 16-byte load a
// thread when f is a multiple of 16 bytes, else element by element; the
// ragged edges of C, d and f are masked.  CUDA cores in f32: tensor cores
// (wgmma, TMA) come later.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

template <typename T, int BM, bool VEC>
__global__ void __launch_bounds__(THREADS)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ out, int C, int D, int F) {
  constexpr int RM = BM / 16;                 // rows per thread
  constexpr int V = 16 / sizeof(T);           // elements per 16-byte load
  __shared__ float Xs[BM][BK + 1];
  __shared__ float Ws[BK][BN];
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const T* xe = x + (long)e * C * D;
  const T* we = w + (long)e * D * F;

  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    __syncthreads();            // the previous step's tiles are consumed
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i - r * BK;
      const int row = m0 + r, k = k0 + kk;
      Xs[r][kk] = (row < C && k < D) ? to_f(xe[(long)row * D + k]) : 0.f;
    }
    if (VEC) {
      // f % V == 0, so a group of V columns is all inside f or all past it
      for (int i = tid * V; i < BK * BN; i += THREADS * V) {
        const int kk = i / BN, c = i - kk * BN;
        const int k = k0 + kk, col = n0 + c;
        if (k < D && col < F) {
          unpack(we + (long)k * F + col, &Ws[kk][c]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) Ws[kk][c + v] = 0.f;
        }
      }
    } else {
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int kk = i / BN, c = i - kk * BN;
        const int k = k0 + kk, col = n0 + c;
        Ws[kk][c] = (k < D && col < F) ? to_f(we[(long)k * F + col]) : 0.f;
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

  T* oe = out + (long)e * C * F;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = m0 + rg * RM + i;
    if (row >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + cg + 16 * j;
      if (col < F) put(&oe[(long)row * F + col], acc[i][j]);
    }
  }
}

template <typename T, int BM>
int launch(const void* x, const void* w, void* out, int E, int C, int D,
           int F, cudaStream_t st) {
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  const int V = 16 / sizeof(T);
  const bool aligned =
      F % V == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (aligned)
    gmm_kernel<T, BM, true><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), C, D, F);
  else
    gmm_kernel<T, BM, false><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), C, D, F);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, void* out, int E, int C, int D,
             int F, cudaStream_t st) {
  if (C <= 32) return launch<T, 16>(x, w, out, E, C, D, F, st);
  return launch<T, 64>(x, w, out, E, C, D, F, st);
}

}  // namespace

// dtype of x, w and out: 0 = f32, 1 = bf16.  E, C <= 65535 * BM (grid),
// E <= 65535.  Returns a cudaError_t (0 on success).
extern "C" int expert_gemm(const void* x, const void* w, void* out, int E,
                           int C, int D, int F, int dtype, void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1 || E > 65535 ||
      (C + 15) / 16 > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, w, out, E, C, D, F, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, w, out, E, C, D, F, st);
  return cudaErrorInvalidValue;
}
