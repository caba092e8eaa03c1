// Flash-attention forward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:81
// `flash_attention` (pallas_call :96, body `_flash_kernel` :27): causal,
// sliding-window GQA attention forward with an online softmax over key
// tiles.  q (B,S,H,D), k and v (B,S,KH,D), f32 or bf16, row-major and
// contiguous, D in {32, 64, 128, 192, 256}; the output has q's shape and
// dtype.
// Accumulation is f32.
//
// The same kernels, instantiated with LSE = true, replace the training
// forward repro/kernels/flash_attention_bwd.py:116 `_fwd_with_lse_aligned`
// (pallas_call :126, body `_fwd_lse_kernel` :32): they also write the
// log-sum-exp row lse (B,H,S) f32 = m + log(max(l, 1e-30)) that the
// backward kernels (flash_attention_bwd.cu) recompute p from.
//
// What bounds it on the H100.  At the serving path's routing shapes
// (S = 32) the work is a few MFLOP: bound by the launch and by reading q,
// k and v once.  At long S the causal work grows as S^2 and the bound is
// the bf16 tensor-core rate: 4 D H B (pairs) operations, 17 GFLOP or
// 0.017 ms at B2 S2048 H16 D64, 0.020 ms at the training shape B8 S1024.
//
// What the design does about it (bf16: `flash_fwd_wgmma`).
//  * Grid (ceil(S/64), B*H): one warpgroup per 64-query tile of one head,
//    the tiles with the most causal keys first.  The TPU kernel's
//    sequential key axis becomes a loop inside the block; it visits only
//    the 64-key tiles that the causal mask and the window allow.
//  * TMA loads Q once and the K and V tiles through a ring of two stages
//    (mbarrier completion), so the next tile's loads are in flight while
//    the tensor cores work on this one.  The boxes are 64 rows of one
//    head over the (B, S, H, D) layout (4-D tensor maps): rows past S
//    read zeros and are masked.  A row is one 128-byte box under the
//    128-byte swizzle at D 64, two at D 128, one 64-byte box under the
//    64-byte swizzle at D 32; the wgmma descriptors use the same swizzle.
//  * S = Q K^T on wgmma (both K-major in shared memory, f32 accumulator in
//    registers), then the scale and the causal, window and S-tail masks
//    as NEG_INF = -1e30, as the reference does.  The online softmax runs
//    in registers: a row's max and sum over the 4 threads that share it.
//  * O += P V on wgmma with P as the register A operand: the S
//    accumulator's layout is the A fragment's, k16 chunk by k16 chunk.  V
//    is an MN-major B.  P is rounded to bf16 before PV, where the TPU
//    kernel multiplies f32 P: about 2^-9 relative per term, well inside
//    the bf16 tolerance of 2e-2; l sums the f32 p.
//  * D 192 and 256 (gemma-2b, nemotron-4-340b) keep the same tiles: a
//    row is 3 or 4 boxes of 64 columns, the 5 tiles 120 or 160 KB of
//    shared memory (one block an SM), and O stays in the warpgroup's
//    registers, D/2 floats a thread beside S's 32.  PV runs one m64n64
//    wgmma a box of V (the accumulator of box j is O's registers
//    32j .. 32j + 31, the same layout as one m64nD), all committed as one
//    group.
//  * The output divides by max(l, 1e-30), as the reference does.
// TMA needs 16-byte aligned base addresses: for a bf16 input that is not
// (a view that starts inside a row), the entry points return
// hopper::ERR_MISALIGNED, which the wrapper raises on.
//
// f32 keeps the CUDA-core kernel (`flash_fwd_kernel`): wgmma takes f32
// inputs only as TF32, about 3 decimal digits, which would break the f32
// bar of 1e-4 against the plain version and the f32 token identity of the
// reference.  It runs 128 threads per 64-query tile: K and V tiles staged
// in shared memory as f32, the score tile in shared memory, scalar FMAs,
// the ragged tail masked by S.  Its shared memory, smem_bytes<D>, is
// 161 KB at D 192 and 209 KB at D 256, under the 227 KB a block may
// take.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;          // query rows per block
constexpr int BN = 64;          // keys per tile
constexpr int THREADS = 128;    // 2 threads per query row
constexpr int PP = BN + 1;      // padded score-tile row
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BM * (D + 1) + BN * (D + 1) + BN * D + BM * PP);
}
static_assert(smem_bytes<256>() <= 232448, "over a block's shared memory");

template <int D, bool LSE>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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
  const float* qb = q + ((long)b * S * H + h) * D;
  const float* kb = k + ((long)b * S * KH + kh) * D;
  const float* vb = v + ((long)b * S * KH + kh) * D;
  float* ob = o + ((long)b * S * H + h) * D;

  for (int i = tid; i < BM * D; i += THREADS) {
    const int r = i / D, c = i % D, s = q0 + r;
    Qs[r * DP + c] = s < S ? qb[(long)s * q_stride + c] : 0.f;
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
        kv = kb[(long)s * k_stride + c];
        vv = vb[(long)s * k_stride + c];
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
    float* orow = ob + (long)(q0 + r) * q_stride + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) orow[c] = acc[c] / denom;
    if (LSE && half == 0)
      lse[((long)b * H + h) * S + q0 + r] = m_i + logf(denom);
  }
}

template <int D, bool LSE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int H, int KH, int causal,
                   int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BM - 1) / BM, B * H);
  const float scale = 1.0f / sqrtf((float)D);
  flash_fwd_kernel<D, LSE><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, H, KH, causal,
      window, scale);
  return cudaGetLastError();
}

template <bool LSE>
cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int S, int H, int KH, int D,
                       int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<32, LSE>(q, k, v, o, lse, B, S, H, KH, causal,
                                       window, stream);
    case 64: return launch<64, LSE>(q, k, v, o, lse, B, S, H, KH, causal,
                                       window, stream);
    case 128: return launch<128, LSE>(q, k, v, o, lse, B, S, H, KH,
                                         causal, window, stream);
    case 192: return launch<192, LSE>(q, k, v, o, lse, B, S, H, KH,
                                         causal, window, stream);
    case 256: return launch<256, LSE>(q, k, v, o, lse, B, S, H, KH,
                                         causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
using Tile = hopper::RowTile<D, BM>;

template <int D>
constexpr size_t wgmma_smem() {
  return 1024 + 5 * Tile<D>::BYTES + 3 * 8;
}
static_assert(wgmma_smem<256>() <= 232448, "over a block's shared memory");

template <int D, bool LSE>
__global__ void __launch_bounds__(128)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int S, int H, int KH, int causal, int window, float scale) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = hopper::align1024(smem_raw);
  uint8_t* ks = qs + T::BYTES;          // two stages
  uint8_t* vs = ks + 2 * T::BYTES;      // two stages
  uint64_t* bar = reinterpret_cast<uint64_t*>(vs + 2 * T::BYTES);
  // bar[0]: Q; bar[1 + s]: the K and V tiles of stage s

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kh = h / (H / KH);

  // key tiles that the causal mask and the window leave
  const int q_last = min(q0 + BM, S) - 1;
  const int k_end = causal ? q_last + 1 : S;                  // exclusive
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_begin = (k_first / BN) * BN;
  const int ntiles = (k_end - k_begin + BN - 1) / BN;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bar[i], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(&bar[0], T::BYTES);
    for (int nb = 0; nb < T::NB; ++nb)
      hopper::tma_load_4d(qs + nb * T::BOX, &tm_q, &bar[0], nb * T::DB, h,
                          q0, b);
    hopper::mbar_expect_tx(&bar[1], 2 * T::BYTES);
    for (int nb = 0; nb < T::NB; ++nb) {
      hopper::tma_load_4d(ks + nb * T::BOX, &tm_k, &bar[1], nb * T::DB, kh,
                          k_begin, b);
      hopper::tma_load_4d(vs + nb * T::BOX, &tm_v, &bar[1], nb * T::DB, kh,
                          k_begin, b);
    }
  }

  // this thread's rows of the tile: r0 and r0 + 8
  const int r0 = warp * 16 + lane / 4;
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};
  float acc_o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
  float acc_s[BN / 2];

  hopper::mbar_wait(&bar[0], 0);
  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    const int kt = k_begin + it * BN;
    if (tid == 0 && it + 1 < ntiles) {
      // the other stage was freed by the barrier that ended the last tile
      const int ns = st ^ 1;
      hopper::mbar_expect_tx(&bar[1 + ns], 2 * T::BYTES);
      for (int nb = 0; nb < T::NB; ++nb) {
        hopper::tma_load_4d(ks + ns * T::BYTES + nb * T::BOX, &tm_k,
                            &bar[1 + ns], nb * T::DB, kh, kt + BN, b);
        hopper::tma_load_4d(vs + ns * T::BYTES + nb * T::BOX, &tm_v,
                            &bar[1 + ns], nb * T::DB, kh, kt + BN, b);
      }
    }
    hopper::mbar_wait(&bar[1 + st], (it >> 1) & 1);
    const uint8_t* kst = ks + st * T::BYTES;
    const uint8_t* vst = vs + st * T::BYTES;

    // S = Q K^T, both K-major: a k16 step moves 32 bytes along a box row
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc_s[i] = 0.f;
    hopper::fence_regs<BN / 2>(acc_s);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::WgmmaSS<BN, 0, 0>::run(acc_s, T::kmajor(qs, kk),
                                     T::kmajor(kst, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<BN / 2>(acc_s);

    // scale and mask; the row max over the 4 threads that share a row
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = q0 + r0 + (e >> 1) * 8;
        const int kpos = kt + j * 8 + (lane % 4) * 2 + (e & 1);
        bool ok = kpos < S;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        const float sv = ok ? acc_s[4 * j + e] * scale : NEG_INF;
        acc_s[4 * j + e] = sv;
        mx[e >> 1] = fmaxf(mx[e >> 1], sv);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      alpha[r] = exp2f((m_i[r] - m_new) * LOG2E);
      m_i[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((acc_s[4 * j + e] - m_i[e >> 1]) * LOG2E);
        acc_s[4 * j + e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_i[r] = l_i[r] * alpha[r] + sum[r];
    }

    // P as bf16 A fragments, one per k16 chunk of keys
    uint32_t pa[BN / 16][4];
    hopper::to_a_fragments<BN>(acc_s, pa);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc_o[4 * j] *= alpha[0];
      acc_o[4 * j + 1] *= alpha[0];
      acc_o[4 * j + 2] *= alpha[1];
      acc_o[4 * j + 3] *= alpha[1];
    }

    // O += P V, V MN-major; from D 192 one m64n64 a box of V
    hopper::fence_regs<D / 2>(acc_o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      if constexpr (D <= 128) {
        hopper::WgmmaRS<D, 1>::run(acc_o, pa[kk], T::mnmajor(vst, kk));
      } else {
#pragma unroll
        for (int nb = 0; nb < T::NB; ++nb)
          hopper::WgmmaRS<64, 1>::run(acc_o + 32 * nb, pa[kk],
                                      T::mnmajor(vst + nb * T::BOX, kk));
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<D / 2>(acc_o);
    __syncthreads();            // this stage is consumed: it may be reloaded
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + r0 + r * 8;
    if (qpos >= S) continue;
    const float denom = fmaxf(l_i[r], 1e-30f);
    __nv_bfloat16* orow = o + (((long)b * S + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + (lane % 4) * 2) =
          __floats2bfloat162_rn(acc_o[4 * j + 2 * r] / denom,
                                acc_o[4 * j + 2 * r + 1] / denom);
    if (LSE && lane % 4 == 0)
      lse[((long)b * H + h) * S + qpos] = m_i[r] + logf(denom);
  }
}

template <int D, bool LSE>
int launch_wgmma(const void* q, const void* k, const void* v,
                 void* o, float* lse, int B, int S, int H, int KH,
                 int causal, int window, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  int rc = hopper::encode_bshd(&tm_q, q, B, S, H, D, BM);
  if (rc == 0) rc = hopper::encode_bshd(&tm_k, k, B, S, KH, D, BN);
  if (rc == 0) rc = hopper::encode_bshd(&tm_v, v, B, S, KH, D, BN);
  if (rc != 0) return rc;
  constexpr size_t smem = wgmma_smem<D>();
  // once per instantiation (a thread-safe static)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma<D, LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + BM - 1) / BM, B * H);
  const float scale = 1.0f / sqrtf((float)D);
  flash_fwd_wgmma<D, LSE><<<grid, 128, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, S, H, KH,
      causal, window, scale);
  return cudaGetLastError();
}

template <bool LSE>
int dispatch_wgmma(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int H, int KH, int D, int causal,
                   int window, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_wgmma<32, LSE>(q, k, v, o, lse, B, S, H, KH,
                                          causal, window, stream);
    case 64: return launch_wgmma<64, LSE>(q, k, v, o, lse, B, S, H, KH,
                                          causal, window, stream);
    case 128: return launch_wgmma<128, LSE>(q, k, v, o, lse, B, S, H, KH,
                                            causal, window, stream);
    case 192: return launch_wgmma<192, LSE>(q, k, v, o, lse, B, S, H, KH,
                                            causal, window, stream);
    case 256: return launch_wgmma<256, LSE>(q, k, v, o, lse, B, S, H, KH,
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
    return dispatch_f32<LSE>(q, k, v, o, lse, B, S, H, KH, D, causal, window,
                             st);
  if (dtype != 1) return cudaErrorInvalidValue;
  if (!hopper::aligned16(q) || !hopper::aligned16(k) || !hopper::aligned16(v))
    return hopper::ERR_MISALIGNED;
  return dispatch_wgmma<LSE>(q, k, v, o, lse, B, S, H, KH, D, causal, window,
                             st);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  window <= 0: no window.  Returns a
// cudaError_t (0 on success), hopper::ERR_MISALIGNED for a bf16 input
// whose base is not 16-byte aligned, or hopper::ERR_TENSOR_MAP + a CUresult
// when a TMA tensor map cannot be encoded.
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
