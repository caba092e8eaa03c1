// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a),
// written by hand in CUDA C++.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:61 `ssd_scan`
// (pallas_call :71, body `_ssd_kernel` :22).  For each (batch, head), over
// chunks of L tokens, with cum = cumsum(dt * A) inside the chunk and the
// (P, N) f32 state S carried from chunk to chunk:
//   y[l]  = sum_{s <= l} (C_l . B_s) exp(cum_l - cum_s) dt_s x_s     (intra)
//         + exp(cum_l) C_l . S                                        (inter)
//   S'    = exp(cum_last) S + sum_s exp(cum_last - cum_s) dt_s x_s B_s^T
// all in f32, in the segment-difference form of `_ssd_kernel` :35-52, so
// exp() never sees a sum that grows over the chunk.  Inputs: x (B,S,H,P),
// dt (B,S,H) f32, A (H,) f32, Bm/Cm (B,S,G,N) with head h reading group
// h / (H/G); x, Bm, Cm f32 or bf16, contiguous.  Outputs: y (B,S,H,P) in
// x's type and the final state (B,H,P,N) f32.  S is a multiple of L; the
// caller pads with dt = 0, which is state-exact.
//
// Three differences from the TPU kernel: B and C stay grouped (the TPU
// wrapper broadcasts them to every head, 64 copies at G = 1); the final
// state is written, for prefill; L is any length up to 256.
//
// What bounds it on the H100.  Per (b, h, chunk) 2 L^2 N (scores) +
// 2 L^2 P (scores x values) + 4 L P N (inter-chunk output and state)
// operations, on B S (H P + 2 G N) inputs: at B8 S2048 H64 P64 N128 L256
// about 137 GFLOP on 285 MB (bf16), bound by arithmetic.  This kernel
// computes in f32 on the CUDA cores (the causal half of the scores only).
//
// What the design does about it.  The TPU walks chunks as a sequential
// grid axis with the state in VMEM.  Here one block per (b, h) walks the
// chunks in a loop and keeps the state in shared memory (P x N f32, 32 KB
// at P64 N128).  The L x L scores (256 KB at L 256) and the chunk's B and C
// (128 KB each) do not fit a block's 227 KB, so each chunk is tiled into
// 64-token tiles: for each query tile, the inter-chunk term from the state,
// then for each key tile at or before it a 64 x 64 score tile (C B^T over
// N, decayed and masked, with dt folded in) times the key tile's x.  A
// last pass over the key tiles updates the state in registers.  256
// threads; each owns 4 x (P/16) outputs of a tile and (P/16) x (N/16)
// entries of the state.  The cumulative decay is one block-wide scan.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TL = 64;          // tokens per tile (query rows, key rows)
constexpr int THREADS = 256;
constexpr int MAX_CHUNK = 256;  // == THREADS: one token per thread in the scan
constexpr int WARPS = THREADS / 32;
static_assert(MAX_CHUNK <= THREADS, "the decay scan takes one token a thread");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// shared memory, in floats; rows padded by one so that 16 threads reading
// one column of 16 different rows hit 16 banks
template <int P, int N>
struct Smem {
  static constexpr int NS = N + 1, PS = P + 1, MS = TL + 1;
  static constexpr int St = 0;                    // [P][NS] chunk-start state
  static constexpr int Cq = St + P * NS;          // [TL][NS] C, query tile
  static constexpr int Bk = Cq + TL * NS;         // [TL][NS] B, key tile
  static constexpr int Xk = Bk + TL * NS;         // [TL][PS] x, key tile
  static constexpr int Mt = Xk + TL * PS;         // [TL][MS] decayed scores
  static constexpr int Cum = Mt + TL * MS;        // [MAX_CHUNK]
  static constexpr int Dt = Cum + MAX_CHUNK;      // [MAX_CHUNK]
  static constexpr int W = Dt + MAX_CHUNK;        // [TL] state-update weights
  static constexpr int Wsum = W + TL;             // [WARPS] scan partials
  static constexpr int total = Wsum + WARPS;
  static constexpr size_t bytes = total * sizeof(float);
};

// the first TL rows of a (tokens, cols) slab with row stride `stride` into
// dst[TL][cols + 1]; rows at or past `nrows` are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long stride, int cols, int nrows) {
  for (int e = threadIdx.x; e < TL * cols; e += THREADS) {
    const int r = e / cols, c = e - r * cols;
    dst[r * (cols + 1) + c] = r < nrows ? to_f(src[r * stride + c]) : 0.f;
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y,
           float* __restrict__ final_state, int S, int H, int G, int L) {
  using SM = Smem<P, N>;
  constexpr int NS = SM::NS, PS = SM::PS, MS = SM::MS;
  constexpr int PJ = P / 16;    // output columns (p) per thread
  constexpr int SA = P / 16;    // state rows (p) per thread
  constexpr int SJ = N / 16;    // state columns (n) per thread
  extern __shared__ float sm[];
  float* St = sm + SM::St;
  float* Cq = sm + SM::Cq;
  float* Bk = sm + SM::Bk;
  float* Xk = sm + SM::Xk;
  float* Mt = sm + SM::Mt;
  float* Cum = sm + SM::Cum;
  float* Dts = sm + SM::Dt;
  float* Ws = sm + SM::W;
  float* Wsum = sm + SM::Wsum;

  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / G);
  const float a = A[h];
  const long xs = (long)H * P;  // token stride of x and y
  const long bs = (long)G * N;  // token stride of B and C
  const T* xb = x + (long)b * S * xs + (long)h * P;
  T* yb = y + (long)b * S * xs + (long)h * P;
  const float* dtb = dt + (long)b * S * H + h;
  const T* Bb = Bm + (long)b * S * bs + (long)g * N;
  const T* Cb = Cm + (long)b * S * bs + (long)g * N;

  for (int e = tid; e < P * N; e += THREADS) St[(e / N) * NS + e % N] = 0.f;

  for (int c0 = 0; c0 < S; c0 += L) {
    // dt and the cumulative log-decay of this chunk: a block-wide
    // inclusive scan, one token per thread
    __syncthreads();            // the previous chunk is done with smem
    {
      const float v0 = tid < L ? dtb[(long)(c0 + tid) * H] : 0.f;
      if (tid < L) Dts[tid] = v0;
      float v = v0 * a;
      const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += o;
      }
      if (lane == 31) Wsum[warp] = v;
      __syncthreads();
      float pre = 0.f;
      for (int w = 0; w < warp; ++w) pre += Wsum[w];
      if (tid < L) Cum[tid] = pre + v;
    }
    __syncthreads();
    const float cum_last = Cum[L - 1];

    // ---- outputs, one query tile at a time
    for (int q0 = 0; q0 < L; q0 += TL) {
      __syncthreads();          // Cq is free
      load_tile(Cq, Cb + (long)(c0 + q0) * bs, bs, N, min(TL, L - q0));
      __syncthreads();
      // inter-chunk term: exp(cum_l) * C_l . S[p]
      float acc[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cq[(rg * 4 + i) * NS + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) sv[j] = St[(cg + 16 * j) * NS + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] += cv[i] * sv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = q0 + rg * 4 + i;
        const float dec = l < L ? expf(Cum[l]) : 0.f;
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] *= dec;
      }
      // intra-chunk term over the key tiles at or before this one
      for (int k0 = 0; k0 <= q0; k0 += TL) {
        const int nk = min(TL, L - k0);
        __syncthreads();        // Bk, Xk and Mt are free
        load_tile(Bk, Bb + (long)(c0 + k0) * bs, bs, N, nk);
        load_tile(Xk, xb + (long)(c0 + k0) * xs, xs, P, nk);
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cq[(rg * 4 + i) * NS + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bk[(cg + 16 * j) * NS + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] += cv[i] * bv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = q0 + rg * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = k0 + cg + 16 * j;
            float m = 0.f;
            if (s <= l && l < L)
              m = sc[i][j] * expf(Cum[l] - Cum[s]) * Dts[s];
            Mt[(rg * 4 + i) * MS + cg + 16 * j] = m;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int s = 0; s < TL; ++s) {
          float mv[4], xv[PJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) mv[i] = Mt[(rg * 4 + i) * MS + s];
#pragma unroll
          for (int j = 0; j < PJ; ++j) xv[j] = Xk[s * PS + cg + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j) acc[i][j] += mv[i] * xv[j];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = q0 + rg * 4 + i;
        if (l < L) {
#pragma unroll
          for (int j = 0; j < PJ; ++j)
            put(&yb[(long)(c0 + l) * xs + cg + 16 * j], acc[i][j]);
        }
      }
    }

    // ---- state update over the chunk's key tiles, in registers
    float st[SA][SJ];
    const float chunk_decay = expf(cum_last);
#pragma unroll
    for (int i = 0; i < SA; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j)
        st[i][j] = chunk_decay * St[(rg * SA + i) * NS + cg + 16 * j];
    for (int k0 = 0; k0 < L; k0 += TL) {
      const int nk = min(TL, L - k0);
      __syncthreads();          // Bk, Xk and Ws are free
      load_tile(Bk, Bb + (long)(c0 + k0) * bs, bs, N, nk);
      load_tile(Xk, xb + (long)(c0 + k0) * xs, xs, P, nk);
      if (tid < TL)
        Ws[tid] = tid < nk ? expf(cum_last - Cum[k0 + tid]) * Dts[k0 + tid]
                           : 0.f;
      __syncthreads();
      for (int s = 0; s < nk; ++s) {
        const float w = Ws[s];
        float xv[SA], bv[SJ];
#pragma unroll
        for (int i = 0; i < SA; ++i) xv[i] = Xk[s * PS + rg * SA + i] * w;
#pragma unroll
        for (int j = 0; j < SJ; ++j) bv[j] = Bk[s * NS + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < SA; ++i)
#pragma unroll
          for (int j = 0; j < SJ; ++j) st[i][j] += xv[i] * bv[j];
      }
    }
    __syncthreads();            // every thread has read the old state
#pragma unroll
    for (int i = 0; i < SA; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j)
        St[(rg * SA + i) * NS + cg + 16 * j] = st[i][j];
  }
  __syncthreads();
  float* fs = final_state + (long)bh * P * N;
  for (int e = tid; e < P * N; e += THREADS) fs[e] = St[(e / N) * NS + e % N];
}

template <typename T, int P, int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* state, int batch, int S, int H,
           int G, int L, cudaStream_t st) {
  const size_t smem = Smem<P, N>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssd_kernel<T, P, N><<<batch * H, THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(state), S, H, G, L);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int P, int N, const void* x, const void* dt, const void* A,
             const void* Bm, const void* Cm, void* y, void* state, int batch,
             int S, int H, int G, int L, cudaStream_t st) {
#define SSD_CASE(PP, NN)                                                   \
  if (P == PP && N == NN)                                                  \
    return launch<T, PP, NN>(x, dt, A, Bm, Cm, y, state, batch, S, H, G, L, \
                             st);
  SSD_CASE(32, 32)
  SSD_CASE(32, 64)
  SSD_CASE(32, 128)
  SSD_CASE(64, 32)
  SSD_CASE(64, 64)
  SSD_CASE(64, 128)
#undef SSD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype of x, Bm, Cm and y: 0 = f32, 1 = bf16 (dt, A and state are f32).
// head_dim P in {32, 64}, d_state N in {32, 64, 128}, 1 <= L <= 256,
// S % L == 0, H % G == 0.  Returns a cudaError_t (0 on success).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, void* y, void* state,
                        int batch, int S, int H, int G, int P, int N, int L,
                        int dtype, void* stream) {
  if (batch < 1 || S < 1 || H < 1 || G < 1 || H % G || L < 1 ||
      L > MAX_CHUNK || S % L)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(P, N, x, dt, A, Bm, Cm, y, state, batch, S, H, G,
                           L, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(P, N, x, dt, A, Bm, Cm, y, state, batch,
                                   S, H, G, L, st);
  return cudaErrorInvalidValue;
}
