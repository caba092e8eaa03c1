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
// the causal backward is about 2.5x the forward's work, arithmetic-bound
// on the card's bf16 tensor-core rate.  This first version computes on
// the CUDA cores in f32 (no wgmma, no TMA): the simple, right version.
//
// What the design does about it.
//  * The TPU grid's sequential axis (query tiles for dK/dV, key tiles for
//    dQ) becomes a loop inside the block, over only the tiles the causal
//    mask and the window allow.  Each block owns its output rows, so no
//    atomics are needed and the result does not depend on block order.
//  * dK/dV: one block per 64-key tile and (B, KH).  K and V stay in shared
//    memory for the whole loop; dK and dV accumulate in registers over
//    the query tiles and over the G = H/KH query heads of the group, as
//    `_dkv_kernel` :205-221 does.
//  * dQ: one block per 64-query tile and (B, H); Q, dO, lse and delta stay
//    in shared memory, dQ accumulates in registers over the key tiles.
//  * The ragged tail is masked by S inside the kernel (kpos < S and
//    qpos < S), where the TPU caller pads S to lcm(block_q, block_k):
//    padded queries and keys contribute exactly nothing in both.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;
constexpr int PP = BK + 1;      // padded row of a score tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// rows [s0, s0 + 64) of one head of a (B,S,NH,D) tensor into a 64 x (D+1)
// f32 tile; rows past S are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int s0,
                                          int S, long row_stride) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D, s = s0 + r;
    dst[r * DP + c] = s < S ? to_f(base[(long)s * row_stride + c]) : 0.f;
  }
}

// The two 64x64 products of a (query tile, key tile) pair: thread owns
// query rows rg*4 + a and key columns cg + 16*jj.  Returns, in p and ds,
// P = exp(s*scale - lse) and dS = P * (dP - delta) * scale (0 where masked).
template <int D>
__device__ __forceinline__ void p_and_ds(const float* Qs, const float* dOs,
                                         const float* Ks, const float* Vs,
                                         const float* lse_s,
                                         const float* delta_s, int q0, int k0,
                                         int S, int causal, int window,
                                         float scale, float p[4][4],
                                         float ds[4][4]) {
  constexpr int DP = D + 1;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) s[a][jj] = dp[a][jj] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qv[a] = Qs[(rg * 4 + a) * DP + d];
      ov[a] = dOs[(rg * 4 + a) * DP + d];
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      kv[jj] = Ks[(cg + 16 * jj) * DP + d];
      vv[jj] = Vs[(cg + 16 * jj) * DP + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[a][jj] += qv[a] * kv[jj];
        dp[a][jj] += ov[a] * vv[jj];
      }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int rr = rg * 4 + a, qpos = q0 + rr;
    const float l = lse_s[rr], dl = delta_s[rr];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
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

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * BQ * PP + 2 * BQ);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * 64 * (D + 1) + BQ * PP + 2 * BQ);
}

// grid (ceil(S/BK), B*KH)
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int S, int H, int KH,
           int causal, int window, float scale) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  float* Ks = smem;                 // BK x DP
  float* Vs = Ks + 64 * DP;         // BK x DP
  float* Qs = Vs + 64 * DP;         // BQ x DP
  float* dOs = Qs + 64 * DP;        // BQ x DP
  float* Ps = dOs + 64 * DP;        // BQ x PP
  float* dSs = Ps + BQ * PP;        // BQ x PP
  float* lse_s = dSs + BQ * PP;     // BQ
  float* delta_s = lse_s + BQ;      // BQ

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / KH;
  const int kh = blockIdx.y % KH;
  const int G = H / KH;
  const long q_stride = (long)H * D;
  const long k_stride = (long)KH * D;

  load_tile<T, D>(Ks, k + ((long)b * S * KH + kh) * D, k0, S, k_stride);
  load_tile<T, D>(Vs, v + ((long)b * S * KH + kh) * D, k0, S, k_stride);

  // query tiles that reach this key tile
  const int k_last = min(k0 + BK, S) - 1;
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  const int q_end = window > 0 ? min(S, k_last + window) : S;   // exclusive

  // accumulator ownership: key row j, columns cq + 4*cc
  const int j = tid >> 2, cq = tid & 3;
  float dk_acc[D / 4], dv_acc[D / 4];
#pragma unroll
  for (int cc = 0; cc < D / 4; ++cc) dk_acc[cc] = dv_acc[cc] = 0.f;
  const int rg = tid >> 4, cg = tid & 15;

  for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
    for (int g = 0; g < G; ++g) {
      const int h = kh * G + g;
      __syncthreads();            // previous tiles fully consumed
      load_tile<T, D>(Qs, q + ((long)b * S * H + h) * D, q0, S, q_stride);
      load_tile<T, D>(dOs, dout + ((long)b * S * H + h) * D, q0, S,
                      q_stride);
      if (tid < BQ) {
        const int s = q0 + tid;
        const long row = ((long)b * H + h) * S + s;
        lse_s[tid] = s < S ? lse[row] : 0.f;
        delta_s[tid] = s < S ? delta[row] : 0.f;
      }
      __syncthreads();
      float p[4][4], ds[4][4];
      p_and_ds<D>(Qs, dOs, Ks, Vs, lse_s, delta_s, q0, k0, S, causal, window,
                  scale, p, ds);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          Ps[(rg * 4 + a) * PP + cg + 16 * jj] = p[a][jj];
          dSs[(rg * 4 + a) * PP + cg + 16 * jj] = ds[a][jj];
        }
      __syncthreads();
      for (int i = 0; i < BQ; ++i) {
        const float pv = Ps[i * PP + j], dsv = dSs[i * PP + j];
        const float* orow = dOs + i * DP + cq;
        const float* qrow = Qs + i * DP + cq;
#pragma unroll
        for (int cc = 0; cc < D / 4; ++cc) {
          dv_acc[cc] += pv * orow[4 * cc];
          dk_acc[cc] += dsv * qrow[4 * cc];
        }
      }
    }
  }

  const int s = k0 + j;
  if (s < S) {
    const long base = (((long)b * S + s) * KH + kh) * D + cq;
#pragma unroll
    for (int cc = 0; cc < D / 4; ++cc) {
      dk[base + 4 * cc] = from_f<T>(dk_acc[cc]);
      dv[base + 4 * cc] = from_f<T>(dv_acc[cc]);
    }
  }
}

// grid (ceil(S/BQ), B*H)
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int S, int H, int KH, int causal, int window,
          float scale) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  float* Qs = smem;                 // BQ x DP
  float* dOs = Qs + 64 * DP;        // BQ x DP
  float* Ks = dOs + 64 * DP;        // BK x DP
  float* Vs = Ks + 64 * DP;         // BK x DP
  float* dSs = Vs + 64 * DP;        // BQ x PP
  float* lse_s = dSs + BQ * PP;     // BQ
  float* delta_s = lse_s + BQ;      // BQ

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kh = h / (H / KH);
  const long q_stride = (long)H * D;
  const long k_stride = (long)KH * D;

  load_tile<T, D>(Qs, q + ((long)b * S * H + h) * D, q0, S, q_stride);
  load_tile<T, D>(dOs, dout + ((long)b * S * H + h) * D, q0, S, q_stride);
  if (tid < BQ) {
    const int s = q0 + tid;
    const long row = ((long)b * H + h) * S + s;
    lse_s[tid] = s < S ? lse[row] : 0.f;
    delta_s[tid] = s < S ? delta[row] : 0.f;
  }

  // key tiles that this query tile attends to
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;                  // exclusive
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_begin = (k_first / BK) * BK;

  // accumulator ownership: query row i, columns cq + 4*cc
  const int i = tid >> 2, cq = tid & 3;
  float dq_acc[D / 4];
#pragma unroll
  for (int cc = 0; cc < D / 4; ++cc) dq_acc[cc] = 0.f;
  const int rg = tid >> 4, cg = tid & 15;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();              // previous tiles fully consumed
    load_tile<T, D>(Ks, k + ((long)b * S * KH + kh) * D, k0, S, k_stride);
    load_tile<T, D>(Vs, v + ((long)b * S * KH + kh) * D, k0, S, k_stride);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_and_ds<D>(Qs, dOs, Ks, Vs, lse_s, delta_s, q0, k0, S, causal, window,
                scale, p, ds);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        dSs[(rg * 4 + a) * PP + cg + 16 * jj] = ds[a][jj];
    __syncthreads();
    const float* dsrow = dSs + i * PP;
    for (int jk = 0; jk < BK; ++jk) {
      const float dsv = dsrow[jk];
      const float* krow = Ks + jk * DP + cq;
#pragma unroll
      for (int cc = 0; cc < D / 4; ++cc) dq_acc[cc] += dsv * krow[4 * cc];
    }
  }

  const int s = q0 + i;
  if (s < S) {
    T* out = dq + (((long)b * S + s) * H + h) * D + cq;
#pragma unroll
    for (int cc = 0; cc < D / 4; ++cc) out[4 * cc] = from_f<T>(dq_acc[cc]);
  }
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int S, int H, int KH,
                       int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BK - 1) / BK, B * KH);
  dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, KH, causal, window,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int S, int H, int KH, int causal,
                      int window, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), S, H, KH, causal, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dkv_d(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, int B, int S, int H, int KH, int D,
                  int causal, int window, cudaStream_t st) {
  switch (D) {
    case 32: return launch_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, B,
                                      S, H, KH, causal, window, st);
    case 64: return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, B,
                                      S, H, KH, causal, window, st);
    case 128: return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, B,
                                        S, H, KH, causal, window, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dq_d(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, int B, int S, int H, int KH, int D, int causal,
                 int window, cudaStream_t st) {
  switch (D) {
    case 32: return launch_dq<T, 32>(q, k, v, dout, lse, delta, dq, B, S, H,
                                     KH, causal, window, st);
    case 64: return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, B, S, H,
                                     KH, causal, window, st);
    case 128: return launch_dq<T, 128>(q, k, v, dout, lse, delta, dq, B, S,
                                       H, KH, causal, window, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  window <= 0: no window.  Each returns a
// cudaError_t (0 on success).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int S,
                                       int H, int KH, int D, int causal,
                                       int window, int dtype, void* stream) {
  if (B < 1 || S < 1 || KH < 1 || H % KH != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0)
    return dkv_d<float>(q, k, v, dout, l, dl, dk, dv, B, S, H, KH, D, causal,
                        window, st);
  if (dtype == 1)
    return dkv_d<__nv_bfloat16>(q, k, v, dout, l, dl, dk, dv, B, S, H, KH, D,
                                causal, window, st);
  return cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int B, int S, int H, int KH,
                                      int D, int causal, int window,
                                      int dtype, void* stream) {
  if (B < 1 || S < 1 || KH < 1 || H % KH != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0)
    return dq_d<float>(q, k, v, dout, l, dl, dq, B, S, H, KH, D, causal,
                       window, st);
  if (dtype == 1)
    return dq_d<__nv_bfloat16>(q, k, v, dout, l, dl, dq, B, S, H, KH, D,
                               causal, window, st);
  return cudaErrorInvalidValue;
}
