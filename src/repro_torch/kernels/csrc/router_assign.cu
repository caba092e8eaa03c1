// k-means routing assignment (paper Eq. 1) for Hopper (sm_90a), written by
// hand in CUDA C++.
//
// Replaces the TPU kernel repro/kernels/router_assign.py:29 `router_assign`
// (pallas_call :39, body `_assign_kernel` :18): for each feature row z,
// argmin_k ||z - c_k||^2 and the minimum itself, with the distance in the
// expanded form ||z||^2 - 2 z.c + ||c||^2 accumulated in f32, as
// `_assign_kernel` :21-24 computes it.  Ties go to the first index, as
// jnp.argmin does.  z (N,D), centroids (K,D), f32 or bf16, contiguous;
// out: assign (N,) int32, mind2 (N,) f32.
//
// What bounds it on the H100.  2*N*K*D operations on N*D + K*D inputs:
// at N 65536, D 896, K 256 that is 30 GFLOP on 235 MB, bound by
// arithmetic (f32 on the CUDA cores: this kernel keeps the reference's
// f32 accumulation).  At the slice's K = 4 it is bound by reading z.
//
// What the design does about it.  The TPU kernel keeps the whole centroid
// table resident (256 x 1024 f32 = 1 MiB), more than a block's 227 KB of
// shared memory here, so the kernel tiles K as well as N: one block per
// 64 rows of z walks the centroids in tiles of 64, and D in chunks of 32,
// staging one z chunk and one centroid chunk in shared memory.  Each
// thread owns 4 rows x 4 centroids of the 64x64 distance tile and keeps a
// running (min, index) per row across the centroid tiles; the 16 threads
// of a row combine with shuffles at the end.  ||z||^2 is summed during
// the first centroid tile, ||c||^2 with each tile's dot products.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

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

}  // namespace

// dtype: 0 = f32, 1 = bf16.  Returns a cudaError_t (0 on success).
extern "C" int router_assign(const void* z, const void* c, void* assign,
                             void* mind2, int N, int K, int D, int dtype,
                             void* stream) {
  if (N < 1 || K < 1 || D < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BR - 1) / BR);
  if (dtype == 0) {
    assign_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(z), static_cast<const float*>(c),
        static_cast<int*>(assign), static_cast<float*>(mind2), N, K, D);
  } else if (dtype == 1) {
    assign_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(z),
        static_cast<const __nv_bfloat16*>(c), static_cast<int*>(assign),
        static_cast<float*>(mind2), N, K, D);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
