// Pieces of the Mamba2 SSD scan shared by its forward (ssd_scan.cu) and
// its backward (ssd_scan_bwd.cu), for Hopper (sm_90a).
//
// Both directions run the same two passes over the chunks of L tokens of
// each (batch, head), with cum = cumsum(dt * A) inside a chunk:
//  * `chunk_state_*`: each chunk's own (P, N) state in parallel,
//      D[p, n] = sum_s u_s[p] w_s V_s[n]
//    forward (MODE 0): u = x, V = B, w_s = exp(cum_last - cum_s) dt_s;
//    backward (MODE 1): u = dy, V = C, w_s = exp(cum_s), the chunk's own
//    share of the gradient reaching the state at its start.  Also writes
//    cum_last, the chunk's summed log-decay.  The CUDA-core version runs
//    for the f32 backward only: the f32 forward's `ssd_kernel` carries
//    its states itself.
//  * `state_scan`: the short f32 scan across chunks, in place: slot c of
//    the (B, nc, H, P, N) buffer goes from chunk c's own term to the
//    carried value at the chunk's start (forward, c ascending:
//    S_c = exp(cum_last_c) S_{c-1} + D_c) or at its end (backward, c
//    descending, seeded by the final state's gradient).
// Every sum has one fixed order: two launches give the same bits.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace ssd {

constexpr int MAX_CHUNK = 256;
constexpr int TL = 64;          // tokens per tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// makes the threads' generic-proxy writes to shared memory visible to
// the async proxy (wgmma operands, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// sum over the block, in one fixed order (a warp tree, then the warps
// in turn); every thread gets the total.  red: [THREADS / 32 + 1].
template <int THREADS>
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();              // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) t += red[w];
    red[THREADS / 32] = t;
  }
  __syncthreads();
  return red[THREADS / 32];
}

// inclusive scan over the block, one value a thread; red: [THREADS / 32]
template <int THREADS>
__device__ __forceinline__ float block_scan(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  __syncthreads();              // red is free
  if (lane == 31) red[warp] = v;
  __syncthreads();
  float pre = 0.f;
  for (int w = 0; w < warp; ++w) pre += red[w];
  return pre + v;
}

// dt of the first n tokens of a chunk (stride `stride` between tokens)
// into dts[], and their cumulative log-decay cumsum(dt * a) into cum[];
// each thread takes 2 tokens, so THREADS >= MAX_CHUNK / 2
template <int THREADS>
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dt,
                                             long stride, float a, int n,
                                             float* cum, float* dts,
                                             float* red) {
  static_assert(2 * THREADS >= MAX_CHUNK, "two tokens a thread");
  const int t0 = 2 * threadIdx.x;
  const float d0 = t0 < n ? dt[(long)t0 * stride] : 0.f;
  const float d1 = t0 + 1 < n ? dt[(long)(t0 + 1) * stride] : 0.f;
  const float v1 = d1 * a;
  const float incl = block_scan<THREADS>(d0 * a + v1, red);
  if (t0 < n) {
    cum[t0] = incl - v1;
    dts[t0] = d0;
  }
  if (t0 + 1 < n) {
    cum[t0 + 1] = incl;
    dts[t0 + 1] = d1;
  }
}

// the weight of token s in a chunk's own state
template <int MODE>
__device__ __forceinline__ float state_weight(const float* cum,
                                              const float* dts, int s,
                                              int L) {
  if (s >= L) return 0.f;
  return MODE == 0 ? expf(cum[L - 1] - cum[s]) * dts[s] : expf(cum[s]);
}

// ---------------------------------------------------------------------------
// chunk states on the tensor cores (bf16 u and V)
// ---------------------------------------------------------------------------
// One block (one warpgroup) per (chunk, head, batch).  A is the u tile as
// loaded (s rows of 64 contiguous columns h P .. h P + 63, MN-major: at
// P 32 the upper 32 rows of D belong to the next head and are dropped), B
// is V w_s split into bf16 hi (in place: the same swizzled bytes, row by
// row) and lo (a second copy), two products, so u enters exact and the
// state keeps about 2^-16 of V w.  D (64 x N) f32 in registers, K = the
// chunk's tokens, 64 at a time through a ring of two TMA stages (83 KB
// at N 128: two blocks an SM).  With `cumdt` it also writes the chunk's
// cum and dt ((B, nc, H, 2, 256) f32), which the output pass loads by one
// bulk copy a head.
template <int N>
struct StatePlan {
  using VT = hopper::RowTile<N, TL>;
  static constexpr int UT = TL * 128;                   // one u tile
  static constexpr int STAGE = UT + 2 * VT::BYTES;      // u, V hi, V lo
  static constexpr size_t SMEM = 1024 + 2 * STAGE +
                                 (2 * MAX_CHUNK + 8) * 4 + 2 * 8;
};

// thread 0: s tile j of u (columns u0 ..) and V (group g) into stage j % 2
template <int N>
__device__ __forceinline__ void load_state_tile(const CUtensorMap* tm_u,
                                                const CUtensorMap* tm_v,
                                                uint8_t* sm, uint64_t* full,
                                                int j, int u0, int g, int c0,
                                                int b) {
  using SP = StatePlan<N>;
  using VT = typename SP::VT;
  uint8_t* st = sm + (j & 1) * SP::STAGE;
  uint64_t* bar = &full[j & 1];
  hopper::mbar_expect_tx(bar, SP::UT + VT::BYTES);
  hopper::tma_load_3d(st, tm_u, bar, u0, c0 + j * TL, b);
  for (int q = 0; q < VT::NB; ++q)
    hopper::tma_load_4d(st + SP::UT + q * VT::BOX, tm_v, bar, q * VT::DB, g,
                        c0 + j * TL, b);
}

template <int P, int N, int MODE>
__global__ void __launch_bounds__(128)
chunk_state_wgmma(const __grid_constant__ CUtensorMap tm_u,
                  const __grid_constant__ CUtensorMap tm_v,
                  const float* __restrict__ dt, const float* __restrict__ A,
                  float* __restrict__ out, float* __restrict__ cum_last,
                  float* __restrict__ cumdt, int S, int H, int G, int L) {
  using SP = StatePlan<N>;
  using VT = typename SP::VT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = hopper::align1024(smem_raw);
  float* cum = reinterpret_cast<float*>(sm + 2 * SP::STAGE);
  float* dts = cum + MAX_CHUNK;
  float* red = dts + MAX_CHUNK;
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 8);

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int g = h / (H / G);
  const int c0 = c * L;
  const int nst = (L + TL - 1) / TL;
  const int tid = threadIdx.x;

  if (tid == 0) {
    hopper::mbar_init(&full[0], 1);
    hopper::mbar_init(&full[1], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < nst && j < 2; ++j)
      load_state_tile<N>(&tm_u, &tm_v, sm, full, j, h * P, g, c0, b);
  chunk_cumsum<128>(dt + ((long)b * S + c0) * H + h, H, A[h], L, cum, dts,
                    red);
  __syncthreads();
  if (cumdt != nullptr) {
    float* o = cumdt + (((long)b * nc + c) * H + h) * 2 * MAX_CHUNK;
    for (int t = tid; t < L; t += 128) {
      o[t] = cum[t];
      o[MAX_CHUNK + t] = dts[t];
    }
  }

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int j = 0; j < nst; ++j) {
    uint8_t* ut = sm + (j & 1) * SP::STAGE;
    uint8_t* vt = ut + SP::UT;
    uint8_t* vlo = vt + VT::BYTES;
    hopper::mbar_wait(&full[j & 1], (j >> 1) & 1);
    // V w -> hi (in place) + lo, 16 bytes (8 values of one row) at a time
    for (int i = tid; i < VT::BYTES / 16; i += 128) {
      const int o = i * 16;
      const int s = j * TL + (o % VT::BOX) / VT::ROW;
      const float w = state_weight<MODE>(cum, dts, s, L);
      uint4* p = reinterpret_cast<uint4*>(vt + o);
      uint4 v = *p, vl;
      __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&v);
      __nv_bfloat162* lv = reinterpret_cast<__nv_bfloat162*>(&vl);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(hv[k]);
        const float2 e = make_float2(f.x * w, f.y * w);
        hv[k] = __floats2bfloat162_rn(e.x, e.y);
        const float2 r = __bfloat1622float2(hv[k]);
        lv[k] = __floats2bfloat162_rn(e.x - r.x, e.y - r.y);
      }
      *p = v;
      *reinterpret_cast<uint4*>(vlo + o) = vl;
    }
    fence_proxy_async();
    __syncthreads();
    hopper::fence_regs<N / 2>(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TL / 16; ++kk) {
      const uint64_t da = hopper::make_desc(ut + kk * 2048, 16, 1024,
                                            hopper::SW128);
      hopper::WgmmaSS<N, 1, 1>::run(acc, da, VT::mnmajor(vt, kk));
      hopper::WgmmaSS<N, 1, 1>::run(acc, da, VT::mnmajor(vlo, kk));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<N / 2>(acc);
    __syncthreads();            // every warp is done with this stage
    if (tid == 0 && j + 2 < nst)
      load_state_tile<N>(&tm_u, &tm_v, sm, full, j + 2, h * P, g, c0, b);
  }

  const int warp = tid / 32, lane = tid % 32;
  const int row = warp * 16 + lane / 4;
  float* o = out + (((long)b * nc + c) * H + h) * P * N;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int n = j * 8 + (lane % 4) * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = row + 8 * half;
      if (p < P)
        *reinterpret_cast<float2*>(o + (long)p * N + n) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
  if (tid == 0) cum_last[((long)b * nc + c) * H + h] = cum[L - 1];
}

// ---------------------------------------------------------------------------
// chunk states on the CUDA cores (f32, or any type), f32 throughout
// ---------------------------------------------------------------------------
template <typename T, int P, int N, int MODE>
__global__ void __launch_bounds__(256)
chunk_state_simt(const T* __restrict__ u, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ V,
                 float* __restrict__ out, float* __restrict__ cum_last,
                 int S, int H, int G, int L) {
  constexpr int NS = N + 1, PS = P + 1;
  constexpr int SA = P / 16, SJ = N / 16;
  constexpr int KT = 32;        // tokens per tile (static shared memory)
  __shared__ float Vt[KT * NS];
  __shared__ float Ut[KT * PS];
  __shared__ float cum[MAX_CHUNK], dts[MAX_CHUNK], wts[KT], red[8];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int g = h / (H / G);
  const int c0 = c * L;
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const long us = (long)H * P, vs = (long)G * N;
  const T* ub = u + ((long)b * S + c0) * us + (long)h * P;
  const T* vb = V + ((long)b * S + c0) * vs + (long)g * N;

  chunk_cumsum<256>(dt + ((long)b * S + c0) * H + h, H, A[h], L, cum, dts,
                    red);
  __syncthreads();
  float st[SA][SJ];
#pragma unroll
  for (int i = 0; i < SA; ++i)
#pragma unroll
    for (int j = 0; j < SJ; ++j) st[i][j] = 0.f;
  for (int k0 = 0; k0 < L; k0 += KT) {
    const int nk = min(KT, L - k0);
    __syncthreads();
    for (int e = tid; e < KT * N; e += 256) {
      const int r = e / N, col = e - r * N;
      Vt[r * NS + col] = r < nk ? to_f(vb[(long)(k0 + r) * vs + col]) : 0.f;
    }
    for (int e = tid; e < KT * P; e += 256) {
      const int r = e / P, col = e - r * P;
      Ut[r * PS + col] = r < nk ? to_f(ub[(long)(k0 + r) * us + col]) : 0.f;
    }
    if (tid < KT) wts[tid] = state_weight<MODE>(cum, dts, k0 + tid, L);
    __syncthreads();
    for (int s = 0; s < nk; ++s) {
      const float w = wts[s];
      float uv[SA], vv[SJ];
#pragma unroll
      for (int i = 0; i < SA; ++i) uv[i] = Ut[s * PS + rg * SA + i] * w;
#pragma unroll
      for (int j = 0; j < SJ; ++j) vv[j] = Vt[s * NS + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < SA; ++i)
#pragma unroll
        for (int j = 0; j < SJ; ++j) st[i][j] += uv[i] * vv[j];
    }
  }
  float* o = out + (((long)b * nc + c) * H + h) * P * N;
#pragma unroll
  for (int i = 0; i < SA; ++i)
#pragma unroll
    for (int j = 0; j < SJ; ++j)
      o[(long)(rg * SA + i) * N + cg + 16 * j] = st[i][j];
  if (tid == 0) cum_last[((long)b * nc + c) * H + h] = cum[L - 1];
}

// ---------------------------------------------------------------------------
// the scan across chunks, in place, one float4 of (P, N) a thread
// ---------------------------------------------------------------------------
template <bool REVERSE>
__global__ void __launch_bounds__(256)
state_scan(float* __restrict__ buf, const float* __restrict__ cum_last,
           const float* __restrict__ seed, float* __restrict__ final_state,
           __nv_bfloat16* __restrict__ hi, __nv_bfloat16* __restrict__ lo,
           int nc, int H, int PN, int keep) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int idx = (blockIdx.x * 256 + threadIdx.x) * 4;
  if (idx >= PN) return;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (seed != nullptr)
    s = *reinterpret_cast<const float4*>(seed + ((long)b * H + h) * PN + idx);
  for (int it = 0; it < nc; ++it) {
    const int c = REVERSE ? nc - 1 - it : it;
    const long off = (((long)b * nc + c) * H + h) * PN + idx;
    float4* slot = reinterpret_cast<float4*>(buf + off);
    const float4 own = *slot;
    if (keep) *slot = s;
    if (hi != nullptr) {
      // the carried state as bf16 hi + lo, for the output pass
      const __nv_bfloat162 h01 = __floats2bfloat162_rn(s.x, s.y);
      const __nv_bfloat162 h23 = __floats2bfloat162_rn(s.z, s.w);
      const float2 f01 = __bfloat1622float2(h01);
      const float2 f23 = __bfloat1622float2(h23);
      const __nv_bfloat162 l01 = __floats2bfloat162_rn(s.x - f01.x,
                                                       s.y - f01.y);
      const __nv_bfloat162 l23 = __floats2bfloat162_rn(s.z - f23.x,
                                                       s.w - f23.y);
      __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(hi + off);
      __nv_bfloat162* lp = reinterpret_cast<__nv_bfloat162*>(lo + off);
      hp[0] = h01;
      hp[1] = h23;
      lp[0] = l01;
      lp[1] = l23;
    }
    const float d = expf(cum_last[((long)b * nc + c) * H + h]);
    s = make_float4(d * s.x + own.x, d * s.y + own.y, d * s.z + own.z,
                    d * s.w + own.w);
  }
  if (final_state != nullptr)
    *reinterpret_cast<float4*>(final_state + ((long)b * H + h) * PN + idx) =
        s;
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------
// (B, S, H * P) bf16 as 64-column boxes of 64 rows (the u tile)
inline int encode_u(CUtensorMap* map, const void* base, int B, int S,
                    int HP) {
  const cuuint64_t dims[3] = {(cuuint64_t)HP, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)HP * 2,
                                 (cuuint64_t)S * HP * 2};
  const cuuint32_t box[3] = {64, TL, 1};
  return hopper::encode_bf16(map, base, 3, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int P, int N, int MODE>
int launch_state_wgmma(const void* u, const void* dt, const void* A,
                       const void* V, float* out, float* cum_last,
                       float* cumdt, int B, int S, int H, int G, int L,
                       cudaStream_t st) {
  CUtensorMap tm_u, tm_v;
  int rc = encode_u(&tm_u, u, B, S, H * P);
  if (rc == 0) rc = hopper::encode_bshd(&tm_v, V, B, S, G, N, TL);
  if (rc != 0) return rc;
  static const cudaError_t attr = cudaFuncSetAttribute(
      chunk_state_wgmma<P, N, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)StatePlan<N>::SMEM);
  if (attr != cudaSuccess) return attr;
  chunk_state_wgmma<P, N, MODE>
      <<<dim3(S / L, H, B), 128, StatePlan<N>::SMEM, st>>>(
          tm_u, tm_v, static_cast<const float*>(dt),
          static_cast<const float*>(A), out, cum_last, cumdt, S, H, G, L);
  return cudaGetLastError();
}

template <typename T, int P, int N, int MODE>
int launch_state_simt(const void* u, const void* dt, const void* A,
                      const void* V, float* out, float* cum_last, int B,
                      int S, int H, int G, int L, cudaStream_t st) {
  chunk_state_simt<T, P, N, MODE><<<dim3(S / L, H, B), 256, 0, st>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(V), out, cum_last,
      S, H, G, L);
  return cudaGetLastError();
}

// chunk states of u (B,S,H,P) and V (B,S,G,N): bf16 on the tensor cores
// (dtype 1; with the chunks' cum and dt when `cumdt` is given), f32 on the
// CUDA cores (dtype 0)
template <int P, int N, int MODE>
int chunk_states(int dtype, const void* u, const void* dt, const void* A,
                 const void* V, float* out, float* cum_last, int B, int S,
                 int H, int G, int L, cudaStream_t st,
                 float* cumdt = nullptr) {
  if (dtype == 1)
    return launch_state_wgmma<P, N, MODE>(u, dt, A, V, out, cum_last, cumdt,
                                          B, S, H, G, L, st);
  return launch_state_simt<float, P, N, MODE>(u, dt, A, V, out, cum_last, B,
                                              S, H, G, L, st);
}

// keep = 0: the carried values go to hi / lo (and the final state) only,
// and the buffer keeps each chunk's own term
template <bool REVERSE>
int launch_scan(float* buf, const float* cum_last, const float* seed,
                float* final_state, void* hi, void* lo, int B, int nc,
                int H, int PN, cudaStream_t st, int keep = 1) {
  state_scan<REVERSE><<<dim3((PN / 4 + 255) / 256, H, B), 256, 0, st>>>(
      buf, cum_last, seed, final_state, static_cast<__nv_bfloat16*>(hi),
      static_cast<__nv_bfloat16*>(lo), nc, H, PN, keep);
  return cudaGetLastError();
}

}  // namespace ssd
