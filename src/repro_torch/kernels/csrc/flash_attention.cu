// Flash-attention forward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:81
// `flash_attention` (pallas_call :96, body `_flash_kernel` :27): causal,
// sliding-window GQA attention forward with an online softmax over key
// tiles.  q (B,S,H,D), k and v (B,S,KH,D), f32 or bf16, row-major and
// contiguous; the output has q's shape and dtype.  Accumulation is f32.
//
// The same kernel, instantiated with LSE = true, replaces the training
// forward repro/kernels/flash_attention_bwd.py:116 `_fwd_with_lse_aligned`
// (pallas_call :126, body `_fwd_lse_kernel` :32): it also writes the
// log-sum-exp row lse (B,H,S) f32 = m + log(max(l, 1e-30)) that the
// backward kernels (flash_attention_bwd.cu) recompute p from.
//
// What bounds it on the H100.  At the serving path's routing shapes
// (S = 32) the work is a few MFLOP and the kernel is bound by launch and
// by reading q, k and v once.  At long S the causal work grows as S^2
// and the bound is arithmetic: the card's bf16 tensor-core rate.  This
// first version computes on the CUDA cores in f32 (no wgmma, no TMA), so
// it sits well above that bound at long S; it is the simple, right
// version, and the tensor-core version is later work.
//
// What the design does about it.
//  * Grid (ceil(S/BM), B*H): one block per 64-query tile and head, so
//    every SM has blocks at the serving batch.  The TPU kernel's
//    sequential key axis becomes a loop inside the block.
//  * The key loop runs only over the tiles that the causal mask and the
//    window allow, so fully masked tiles are never loaded.
//  * K and V tiles are staged once in shared memory (as f32) and reused
//    by all 64 query rows; the score tile never leaves shared memory.
//  * The ragged tail is masked by S (keys and queries past S are never
//    read or written): no padding copy, unlike the TPU caller, which
//    pads S to a multiple of 128.
//  * The masks use NEG_INF = -1e30 and the output divides by
//    max(l, 1e-30), as the reference does, so a masked row gives 0.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // query rows per block
constexpr int BN = 64;          // keys per tile
constexpr int THREADS = 128;    // 2 threads per query row
constexpr int PP = BN + 1;      // padded score-tile row
constexpr float NEG_INF = -1e30f;

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
  return __float2bfloat16(x);   // round to nearest even, like astype
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BM * (D + 1) + BN * (D + 1) + BN * D + BM * PP);
}

template <typename T, int D, bool LSE>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int KH, int causal,
                 int window, float scale) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;     // padded row: no bank conflicts on columns
  float* Qs = smem;             // BM x DP
  float* Ks = Qs + BM * DP;     // BN x DP
  float* Vs = Ks + BN * DP;     // BN x D
  float* Ps = Vs + BN * D;      // BM x PP   scores, then probabilities

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BM;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kh = h / (H / KH);
  const long q_stride = (long)H * D;     // between sequence positions
  const long k_stride = (long)KH * D;
  const T* qb = q + ((long)b * S * H + h) * D;
  const T* kb = k + ((long)b * S * KH + kh) * D;
  const T* vb = v + ((long)b * S * KH + kh) * D;
  T* ob = o + ((long)b * S * H + h) * D;

  for (int i = tid; i < BM * D; i += THREADS) {
    const int r = i / D, c = i % D, s = q0 + r;
    Qs[r * DP + c] = s < S ? to_f(qb[(long)s * q_stride + c]) : 0.f;
  }

  // key tiles that the causal mask and the window leave
  const int q_last = min(q0 + BM, S) - 1;
  const int k_end = causal ? q_last + 1 : S;                  // exclusive
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_begin = (k_first / BN) * BN;

  // softmax / output ownership: row r, half of the columns
  const int r = tid >> 1, half = tid & 1;
  float m_i = NEG_INF, l_i = 0.f;
  float acc[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) acc[c] = 0.f;
  // score ownership: rows rg*4 .. rg*4+3, columns cg + 8*jj
  const int rg = tid >> 3, cg = tid & 7;

  for (int kt = k_begin; kt < k_end; kt += BN) {
    __syncthreads();            // previous tile fully consumed
    for (int i = tid; i < BN * D; i += THREADS) {
      const int j = i / D, c = i % D, s = kt + j;
      float kv = 0.f, vv = 0.f;
      if (s < S) {
        kv = to_f(kb[(long)s * k_stride + c]);
        vv = to_f(vb[(long)s * k_stride + c]);
      }
      Ks[j * DP + c] = kv;
      Vs[j * D + c] = vv;
    }
    __syncthreads();

    float sacc[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) sacc[a][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = Qs[(rg * 4 + a) * DP + d];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) kv[jj] = Ks[(cg + 8 * jj) * DP + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) sacc[a][jj] += qv[a] * kv[jj];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int rr = rg * 4 + a, qpos = q0 + rr;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int cc = cg + 8 * jj, kpos = kt + cc;
        bool ok = kpos < S;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        Ps[rr * PP + cc] = ok ? sacc[a][jj] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax over this tile: the two threads of a row share the
    // columns and combine with one shuffle
    float* prow = Ps + r * PP;
    float* mine = prow + half * (BN / 2);
    float mx = NEG_INF;
    for (int j = 0; j < BN / 2; ++j) mx = fmaxf(mx, mine[j]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    float sum = 0.f;
    for (int j = 0; j < BN / 2; ++j) {
      const float p = expf(mine[j] - m_new);
      mine[j] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = expf(m_i - m_new);
    l_i = l_i * alpha + sum;
    m_i = m_new;
    __syncwarp();               // the partner's half of the row is written

#pragma unroll
    for (int c = 0; c < D / 2; ++c) acc[c] *= alpha;
    for (int j = 0; j < BN; ++j) {
      const float p = prow[j];
      const float* vrow = Vs + j * D + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; ++c) acc[c] += p * vrow[c];
    }
  }

  if (q0 + r < S) {
    const float denom = fmaxf(l_i, 1e-30f);
    T* orow = ob + (long)(q0 + r) * q_stride + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) orow[c] = from_f<T>(acc[c] / denom);
    if (LSE && half == 0)
      lse[((long)b * H + h) * S + q0 + r] = m_i + logf(denom);
  }
}

template <typename T, int D, bool LSE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int H, int KH, int causal,
                   int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BM - 1) / BM, B * H);
  const float scale = 1.0f / sqrtf((float)D);
  flash_fwd_kernel<T, D, LSE><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, KH, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T, bool LSE>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int S, int H, int KH, int D,
                       int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32, LSE>(q, k, v, o, lse, B, S, H, KH, causal,
                                       window, stream);
    case 64: return launch<T, 64, LSE>(q, k, v, o, lse, B, S, H, KH, causal,
                                       window, stream);
    case 128: return launch<T, 128, LSE>(q, k, v, o, lse, B, S, H, KH,
                                         causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool LSE>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int S, int H, int KH, int D, int causal,
             int window, int dtype, void* stream) {
  if (B < 1 || S < 1 || KH < 1 || H % KH != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float, LSE>(q, k, v, o, lse, B, S, H, KH, D, causal,
                                  window, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, LSE>(q, k, v, o, lse, B, S, H, KH, D,
                                          causal, window, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  window <= 0: no window.  Returns a
// cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int H, int KH, int D, int causal,
                                   int window, int dtype, void* stream) {
  return dispatch<false>(q, k, v, o, nullptr, B, S, H, KH, D, causal, window,
                         dtype, stream);
}

// The training forward: as flash_attention_fwd, and also lse (B,H,S) f32.
extern "C" int flash_attention_fwd_lse(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int S, int H, int KH, int D,
                                       int causal, int window, int dtype,
                                       void* stream) {
  return dispatch<true>(q, k, v, o, static_cast<float*>(lse), B, S, H, KH,
                        D, causal, window, dtype, stream);
}
