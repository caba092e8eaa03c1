// Flash-decode for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:103
// `flash_decode` (pallas_call :154, body `_decode_kernel` :41): one new
// token's GQA attention over the ring KV cache.  q (B,H,D); caches
// (B,T,KH,D) in f32, bf16 or int8, with per-(token, head) f32 scales
// (B,T,KH) for int8; cache_index (B,) int32 on the device.  Output
// (B,H,D) in q's dtype.
//
// What bounds it on the H100.  Each step reads every valid cache slot of
// K and V once and does 4*D flops per slot and query head: about one
// flop per byte for MHA, far below the ~295 flops per byte at which the
// card stops being bound by memory.  So the bound is bytes: the valid
// part of the cache over 3.35 TB/s.  At serving batch sizes the TPU
// kernel's sequential walk over the cache would also leave most SMs
// idle.
//
// What the design does about it.
//  * Split-K: grid (B*KH, num_splits).  The wrapper picks num_splits so
//    that the card has about two blocks per SM; each split walks its own
//    stretch of the cache length and writes a partial (m, l, acc), and a
//    second small kernel combines the splits.
//  * Every block reads its row's cache_index from device memory and
//    rebuilds each ring slot's absolute position (decode_attention.py:
//    57-67), so cache_index never goes to the host.  Unwritten, future
//    and window-expired slots are masked; a slot that is masked is never
//    loaded, and a warp whose slots are all masked skips the pass.
//  * Loads are 16 bytes per thread (8 elements of bf16, 8 of int8 in an
//    8-byte load, 8 of f32 in two loads); the D/8 threads of a key read
//    one contiguous row.  The G query heads of a KV head live in the
//    block's registers and share every K/V load.
//  * int8 K/V are dequantized with their scales in registers, so the
//    quantized cache is read once and never expanded in memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int VEC = 8;          // cache elements per thread per key
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
  return __float2bfloat16(x);
}

// 8 consecutive cache elements -> f32
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(e[i]);
}
__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const int2 raw = *reinterpret_cast<const int2*>(p);
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = (float)e[i];
}

template <typename TQ, typename TKV, int D, int GMAX>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kc,
                    const TKV* __restrict__ vc,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ cache_index,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int T, int KH, int G,
                    int window, int chunk, float scale) {
  constexpr int TPK = D / VEC;            // threads per key: 4, 8 or 16
  constexpr int KPP = THREADS / TPK;      // keys per pass: 32, 16 or 8
  constexpr bool QUANT = sizeof(TKV) == 1;
  __shared__ float sm_m[KPP * GMAX];
  __shared__ float sm_l[KPP * GMAX];
  __shared__ float sm_acc[KPP * GMAX * D];

  const int tid = threadIdx.x;
  const int kg = tid / TPK;               // this thread's key in a pass
  const int sub = tid % TPK;              // its 8 dims: sub*8 .. sub*8+7
  const int b = blockIdx.x / KH;
  const int kh = blockIdx.x % KH;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int H = KH * G;
  const int ci = cache_index[b];
  const int idx_last = ((ci % T) + T) % T;

  float qr[GMAX][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[g][e] = 0.f;
    if (g < G) {
      const TQ* qp = q + ((long)b * H + kh * G + g) * D + sub * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[g][e] = to_f(qp[e]);
    }
  }
  float m[GMAX], l[GMAX], acc[GMAX][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  const int t_begin = split * chunk;
  const int t_end = min(T, t_begin + chunk);
  for (int t0 = t_begin; t0 < t_end; t0 += KPP) {
    const int t = t0 + kg;
    // absolute position held by ring slot t (decode_attention.py:63-67)
    const int pos = t <= idx_last ? ci - idx_last + t : ci - idx_last - T + t;
    const bool valid = t < t_end && pos >= 0 && pos <= ci &&
                       (window <= 0 || pos > ci - window);
    if (!__any_sync(0xffffffffu, valid)) continue;   // warp-uniform skip
    float kf[VEC], vf[VEC];
    if (valid) {
      const long row = ((long)b * T + t) * KH + kh;
      load8(kc + row * D + sub * VEC, kf);
      load8(vc + row * D + sub * VEC, vf);
      if (QUANT) {
        const float ks = k_scale[row], vs = v_scale[row];
#pragma unroll
        for (int e = 0; e < VEC; ++e) { kf[e] *= ks; vf[e] *= vs; }
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) { kf[e] = 0.f; vf[e] = 0.f; }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) s += qr[g][e] * kf[e];
#pragma unroll
      for (int off = TPK / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (valid && g < G) {
        s *= scale;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = acc[g][e] * alpha + p * vf[e];
        m[g] = m_new;
      }
    }
  }

  // combine the KPP keys-in-flight of this block into one partial
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (sub == 0) {
      sm_m[kg * GMAX + g] = m[g];
      sm_l[kg * GMAX + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      sm_acc[(kg * GMAX + g) * D + sub * VEC + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float M = NEG_INF;
    for (int kk = 0; kk < KPP; ++kk) M = fmaxf(M, sm_m[kk * GMAX + g]);
    float L = 0.f, A = 0.f;
    for (int kk = 0; kk < KPP; ++kk) {
      const float w = expf(sm_m[kk * GMAX + g] - M);
      L += sm_l[kk * GMAX + g] * w;
      A += sm_acc[(kk * GMAX + g) * D + d] * w;
    }
    const long prow = ((long)b * H + kh * G + g) * nsplit + split;
    part_acc[prow * D + d] = A;
    if (d == 0) {
      part_m[prow] = M;
      part_l[prow] = L;
    }
  }
}

// one block per (b, h) row, one thread per output dim
template <typename TO>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      TO* __restrict__ out, int nsplit,
                                      int D) {
  const long row = blockIdx.x;
  const int d = threadIdx.x;
  float M = NEG_INF;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, part_m[row * nsplit + s]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(part_m[row * nsplit + s] - M);
    L += part_l[row * nsplit + s] * w;
    A += part_acc[(row * nsplit + s) * D + d] * w;
  }
  out[row * D + d] = from_f<TO>(A / fmaxf(L, 1e-30f));
}

struct Args {
  const void *q, *kc, *vc, *ks, *vs, *ci;
  float *pm, *pl, *pa;
  void* out;
  int B, T, H, KH, D, window, nsplit;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D, int GMAX>
cudaError_t launch(const Args& a) {
  const int G = a.H / a.KH;
  const int chunk = (a.T + a.nsplit - 1) / a.nsplit;
  const dim3 grid(a.B * a.KH, a.nsplit);
  decode_split_kernel<TQ, TKV, D, GMAX><<<grid, THREADS, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.kc),
      static_cast<const TKV*>(a.vc), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.ci), a.pm,
      a.pl, a.pa, a.T, a.KH, G, a.window, chunk, 1.0f / sqrtf((float)D));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<TQ><<<a.B * a.H, D, 0, a.stream>>>(
      a.pm, a.pl, a.pa, static_cast<TQ*>(a.out), a.nsplit, D);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t dispatch_g(const Args& a) {
  const int G = a.H / a.KH;
  if (G <= 1) return launch<TQ, TKV, D, 1>(a);
  if (G <= 2) return launch<TQ, TKV, D, 2>(a);
  if (G <= 4) return launch<TQ, TKV, D, 4>(a);
  if (G <= 8) return launch<TQ, TKV, D, 8>(a);
  return cudaErrorInvalidValue;
}

template <typename TQ, typename TKV>
cudaError_t dispatch_d(const Args& a) {
  switch (a.D) {
    case 32: return dispatch_g<TQ, TKV, 32>(a);
    case 64: return dispatch_g<TQ, TKV, 64>(a);
    case 128: return dispatch_g<TQ, TKV, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype: 0 = f32, 1 = bf16.  kv_dtype: 0 = f32, 1 = bf16, 2 = int8
// (then k_scale / v_scale are (B,T,KH) f32).  The partial buffers are
// f32: part_m and part_l (B*H*num_splits), part_acc (B*H*num_splits*D).
// window <= 0: no window.  Returns a cudaError_t (0 on success).
extern "C" int flash_decode(const void* q, const void* k_cache,
                            const void* v_cache, const void* k_scale,
                            const void* v_scale, const void* cache_index,
                            void* part_m, void* part_l, void* part_acc,
                            void* out, int B, int T, int H, int KH, int D,
                            int window, int num_splits, int q_dtype,
                            int kv_dtype, void* stream) {
  if (B < 1 || T < 1 || KH < 1 || H % KH != 0 || num_splits < 1)
    return cudaErrorInvalidValue;
  Args a{q, k_cache, v_cache, k_scale, v_scale, cache_index,
         static_cast<float*>(part_m), static_cast<float*>(part_l),
         static_cast<float*>(part_acc), out, B, T, H, KH, D, window,
         num_splits, static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && kv_dtype == 0) return dispatch_d<float, float>(a);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(a);
  if (q_dtype == 0 && kv_dtype == 2) return dispatch_d<float, int8_t>(a);
  if (q_dtype == 1 && kv_dtype == 2)
    return dispatch_d<__nv_bfloat16, int8_t>(a);
  return cudaErrorInvalidValue;
}
