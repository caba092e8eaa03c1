// Flash-decode for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:103
// `flash_decode` (pallas_call :154, body `_decode_kernel` :41): one new
// token's GQA attention over the ring KV cache.  q (B,H,D); caches
// (B,T,KH,D) in f32, bf16 or int8, with per-(token, head) f32 scales
// (B,T,KH) for int8; cache_index (B,) int32 on the device.  Output
// (B,H,D) in q's dtype.  D in {32, 64, 128, 192, 256}; any number G of
// query heads a KV head (G divides H).
//
// What bounds it on the H100.  Each step reads every valid cache slot of
// K and V once and does 4*D flops per slot and query head: about one
// flop per byte for MHA (G flops per byte under GQA), far below the ~295
// flops per byte at which the card stops being bound by memory.  So the
// bound is bytes: the valid part of the cache over 3.35 TB/s.  At the
// serving shape (B8, 80 slots) those bytes take less than one kernel
// launch, so there the launch count is the cost.
//
// What the design does about it.
//  * One kernel per call.  Grid (B*KH*NG, num_splits): the G query heads
//    of each (b, kh) row in NG = ceil(G / 2) head groups of at most 2,
//    one block each, so that a block's accumulators stay in registers at
//    any G.  At the serving shapes (B8 over 80 slots) two heads a block
//    were faster than four or eight at every query group and head dim of
//    the families, where eight spilled registers (PERF.md section 6).
//    The NG blocks of a (b, kh) are neighbours in the grid and read the
//    same K/V tiles, the later ones mostly from L2.  The wrapper picks
//    num_splits so that the card has about two blocks per SM.  With one
//    split (every serving step) a block writes its output directly.  With
//    several, each block writes its partial (m, l, acc) to the workspace
//    and bumps an arrival counter for its (b, kh, group) row; the last
//    block to arrive combines the splits in split order (so the result
//    does not depend on which block came last), writes the output and
//    resets the counter to 0, which the wrapper's counter buffer holds at
//    rest.
//  * K and V reach shared memory by TMA: a 4-D tensor map over
//    (B, T, KH, D) with a box of TILE slots of one (b, kh) row (about
//    4 KB of K, 32-64 slots; at least 32 slots, so up to 32 KB at f32
//    D 256), loaded by a producer warp into a ring of 3 stages that
//    complete on mbarriers, so the next tiles' loads overlap the current
//    tile's math.  Small stages keep several blocks (rows) on each SM: 8
//    math warps a block with 3 stages of 4 KB tiles took 0.155 ms at B64
//    T2048 bf16 on an H100 (700 W), 4 warps with 4 stages of 8 KB 0.178.
//    Only tiles that hold a valid slot are requested (after a ring wrap
//    the valid slots form up to two stretches).  int8 scales have a 4 KH
//    byte slot stride (no TMA box at KH 1): each thread loads its slots'
//    scales a tile ahead with plain loads.
//  * Every block reads its row's cache_index from device memory and
//    rebuilds the valid ring slots (decode_attention.py:57-67): the
//    positions [max(0, ci - T + 1, ci - window + 1), ci] mapped mod T.
//    Nothing goes to the host, so a decode step can be captured in a
//    CUDA graph.  Masked slots are never used; a warp whose slots in a
//    pass are all masked skips it.
//  * The math stays f32 on the CUDA cores: with at most 2 query heads a
//    block, a 64-row wgmma tile would be at most 1/32 used, and
//    the kernel is bound by bytes.  The D/8 threads of a key each take 8
//    elements from shared memory (16 bytes of bf16); the query heads of
//    the block live in registers and share every K/V element; int8 is
//    dequantized with its scales in registers.  A key's threads are a
//    power of two inside one warp, so the score is summed by shuffles:
//    at D 192 (24 threads of 8) a key takes a whole warp, its last 8
//    lanes idle (they load nothing and add zeros; the kernel is bound by
//    bytes, so they cost little).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int STAGES = 3;
constexpr int TILE_BYTES = 4096;          // of K (and of V) a stage
constexpr int VEC = 8;                    // cache elements per thread per key
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

// 8 consecutive cache elements (in shared memory) -> f32
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

// the least power of two >= n
constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// GMAX: the query heads a block holds, 1 or 2 (MAX_GROUP in
// decode_attention.py)
template <typename TKV, int D, int GMAX>
struct Plan {
  static constexpr int CONSUMERS = 256;               // 8 warps of math
  static constexpr int THREADS = CONSUMERS + 32;      // + the producer warp
  static constexpr int ROWB = D * (int)sizeof(TKV);   // bytes of one slot
  static constexpr int LANES = D / VEC;               // busy threads a key
  static constexpr int TPK = pow2_at_least(LANES);    // threads per key
  static constexpr int KPP = CONSUMERS / TPK;         // keys per pass
  static constexpr int RAW = TILE_BYTES / ROWB;
  static constexpr int LO = KPP > 32 ? KPP : 32, HI = KPP > 64 ? KPP : 64;
  static constexpr int TILE = RAW < LO ? LO : (RAW > HI ? HI : RAW);
  static constexpr int TB = TILE * ROWB;              // one K or V tile
  static constexpr int STAGE = 2 * TB;
  static constexpr int PASSES = TILE / KPP;
  // the block's partials of its KPP keys in flight, staged through the
  // drained ring: m and l (KPP x GMAX), acc (KPP x GMAX x D)
  static constexpr int COMBINE = KPP * GMAX * (D + 2) * 4;
  static constexpr int RING = STAGES * STAGE;
  static constexpr size_t SMEM =
      1024 + (RING > COMBINE ? RING : COMBINE) + 2 * STAGES * 8;
  static_assert(TILE % KPP == 0, "a tile is whole passes");
  static_assert(TPK <= 32 && LANES * VEC == D, "a key is in one warp");
  static_assert(SMEM <= 232448, "over the H100's shared memory a block");
};

// The ring slots of one (b, kh) row that hold a valid position: the
// positions [lo, ci] map to the slots s0, s0 + 1, ... (mod T), nv of them
// (nv <= 0: none, for ci < 0).
struct Valid {
  int s0, nv, T;
  __device__ Valid(int ci, int T_, int window) : T(T_) {
    int lo = max(0, ci - T + 1);
    if (window > 0) lo = max(lo, ci - window + 1);
    nv = ci - lo + 1;
    s0 = nv > 0 ? lo % T : 0;
  }
  __device__ bool slot(int t) const {
    return nv > 0 && (t - s0 + T) % T < nv;
  }
  // does [a, b) (0 <= a, b <= T) hold a valid slot?
  __device__ bool any(int a, int b) const {
    if (nv <= 0 || a >= b) return false;
    const int e = s0 + nv;
    if (a < min(e, T) && b > s0) return true;
    return e > T && a < e - T;
  }
};

// the first tile at or after `tile` (of this split's [t0, t1)) that holds
// a valid slot; `tiles` when none does
template <int TILE>
__device__ __forceinline__ int next_tile(const Valid& v, int tile, int tiles,
                                         int t0, int t1) {
  for (; tile < tiles; ++tile) {
    const int a = max(t0, tile * TILE), b = min(t1, (tile + 1) * TILE);
    if (v.any(a, b)) return tile;
  }
  return tiles;
}

template <typename TQ, typename TKV, int D, int GMAX>
__global__ void __launch_bounds__(Plan<TKV, D, GMAX>::THREADS)
decode_kernel(const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              const TQ* __restrict__ q, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const int* __restrict__ cache_index, float* __restrict__ part,
              int* __restrict__ counters, TQ* __restrict__ out, int T,
              int KH, int G, int NG, int GS, int window, int chunk,
              float scale) {
  using P = Plan<TKV, D, GMAX>;
  constexpr int CONSUMERS = P::CONSUMERS;
  constexpr bool QUANT = sizeof(TKV) == 1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + (P::RING > P::COMBINE ? P::RING : P::COMBINE));
  uint64_t* empty = full + STAGES;
  __shared__ int last_block;

  const int tid = threadIdx.x;
  // blockIdx.x = (b KH + kh) NG + group: the query heads g0 .. g0 + gn - 1
  // of KV head kh
  const int b = blockIdx.x / NG / KH;
  const int kh = blockIdx.x / NG % KH;
  const int g0 = blockIdx.x % NG * GS;
  const int gn = min(GS, G - g0);
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int H = KH * G;
  const Valid valid(cache_index[b], T, window);
  const int t0 = min(T, split * chunk);
  const int t1 = min(T, t0 + chunk);
  const int tiles = (t1 + P::TILE - 1) / P::TILE;
  const int first = t0 / P::TILE;         // chunk is a multiple of TILE

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: one thread keeps up to STAGES tiles of K and V in flight
    if (tid == CONSUMERS) {
      int n = 0;
      for (int tile = next_tile<P::TILE>(valid, first, tiles, t0, t1);
           tile < tiles;
           tile = next_tile<P::TILE>(valid, tile + 1, tiles, t0, t1), ++n) {
        const int s = n % STAGES;
        if (n >= STAGES) hopper::mbar_wait(&empty[s], (n / STAGES - 1) & 1);
        uint8_t* st = smem + s * P::STAGE;
        hopper::mbar_expect_tx(&full[s], P::STAGE);
        hopper::tma_load_4d(st, &tm_k, &full[s], 0, kh, tile * P::TILE, b);
        hopper::tma_load_4d(st + P::TB, &tm_v, &full[s], 0, kh,
                            tile * P::TILE, b);
      }
    }
    return;
  }

  const int kg = tid / P::TPK;             // this thread's key in a pass
  const int sub = tid % P::TPK;            // its 8 dims: sub*8 .. sub*8+7
  const bool busy = sub < P::LANES;        // false: an idle lane (D 192)
  const int lane = tid % 32;
  const long head0 = (long)b * H + kh * G + g0;   // the block's first head

  float qr[GMAX][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[g][e] = 0.f;
    if (g < gn && busy) {
      const TQ* qp = q + (head0 + g) * D + sub * VEC;
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

  // int8: this thread's scales of the current tile, and of the next
  // needed tile loaded a tile ahead
  float sk[P::PASSES], sv[P::PASSES];
  auto load_scales = [&](int at, float* to_k, float* to_v) {
#pragma unroll
    for (int p = 0; p < P::PASSES; ++p) {
      const int t = at * P::TILE + p * P::KPP + kg;
      to_k[p] = to_v[p] = 0.f;
      if (t >= t0 && t < t1 && valid.slot(t)) {
        const long row = ((long)b * T + t) * KH + kh;
        to_k[p] = k_scale[row];
        to_v[p] = v_scale[row];
      }
    }
  };
  int tile = next_tile<P::TILE>(valid, first, tiles, t0, t1);
  if (QUANT && tile < tiles) load_scales(tile, sk, sv);
  for (int n = 0; tile < tiles; ++n) {
    const int nxt = next_tile<P::TILE>(valid, tile + 1, tiles, t0, t1);
    float next_k[P::PASSES], next_v[P::PASSES];
    if (QUANT && nxt < tiles) load_scales(nxt, next_k, next_v);
    const int s = n % STAGES;
    hopper::mbar_wait(&full[s], (n / STAGES) & 1);
    const TKV* ks = reinterpret_cast<const TKV*>(smem + s * P::STAGE);
    const TKV* vs = reinterpret_cast<const TKV*>(smem + s * P::STAGE + P::TB);
#pragma unroll
    for (int p = 0; p < P::PASSES; ++p) {
      const int r = p * P::KPP + kg;       // row of the tile
      const int t = tile * P::TILE + r;
      const bool ok = t >= t0 && t < t1 && valid.slot(t);
      if (!__any_sync(0xffffffffu, ok)) continue;   // warp-uniform skip
      float kf[VEC] = {}, vf[VEC] = {};
      if (busy) {
        load8(ks + r * D + sub * VEC, kf);
        load8(vs + r * D + sub * VEC, vf);
      }
      if (QUANT) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) { kf[e] *= sk[p]; vf[e] *= sv[p]; }
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float sc = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) sc += qr[g][e] * kf[e];
#pragma unroll
        for (int off = P::TPK / 2; off > 0; off >>= 1)
          sc += __shfl_xor_sync(0xffffffffu, sc, off);
        if (ok && g < gn) {
          sc *= scale;
          const float m_new = fmaxf(m[g], sc);
          const float alpha = expf(m[g] - m_new);
          const float pr = expf(sc - m_new);
          l[g] = l[g] * alpha + pr;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[g][e] = acc[g][e] * alpha + pr * vf[e];
          m[g] = m_new;
        }
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
    if (QUANT) {
#pragma unroll
      for (int p = 0; p < P::PASSES; ++p) {
        sk[p] = next_k[p];
        sv[p] = next_v[p];
      }
    }
    tile = nxt;
  }

  // combine the KPP keys in flight of this block into one partial, staged
  // through the ring (every tile has been consumed once all consumers
  // pass the barrier)
  asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");
  float* sm_m = reinterpret_cast<float*>(smem);
  float* sm_l = sm_m + P::KPP * GMAX;
  float* sm_acc = sm_l + P::KPP * GMAX;
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (sub == 0) {
      sm_m[kg * GMAX + g] = m[g];
      sm_l[kg * GMAX + g] = l[g];
    }
    if (busy) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        sm_acc[(kg * GMAX + g) * D + sub * VEC + e] = acc[g][e];
    }
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");
  const long rows = (long)gridDim.x / (KH * NG) * H * nsplit;  // B H nsplit
  float* part_m = part;
  float* part_l = part + rows;
  float* part_acc = part + 2 * rows;
  for (int i = tid; i < gn * D; i += CONSUMERS) {
    const int g = i / D, d = i % D;
    float M = NEG_INF;
    for (int kk = 0; kk < P::KPP; ++kk) M = fmaxf(M, sm_m[kk * GMAX + g]);
    float L = 0.f, A = 0.f;
    for (int kk = 0; kk < P::KPP; ++kk) {
      const float w = expf(sm_m[kk * GMAX + g] - M);
      L += sm_l[kk * GMAX + g] * w;
      A += sm_acc[(kk * GMAX + g) * D + d] * w;
    }
    const long orow = head0 + g;
    if (nsplit == 1) {
      out[orow * D + d] = from_f<TQ>(A / fmaxf(L, 1e-30f));
    } else {
      const long prow = orow * nsplit + split;
      part_acc[prow * D + d] = A;
      if (d == 0) {
        part_m[prow] = M;
        part_l[prow] = L;
      }
    }
  }
  if (nsplit == 1) return;

  // the last split of this (b, kh, group) row to arrive combines them all
  __threadfence();
  asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");
  if (tid == 0)
    last_block = atomicAdd(&counters[blockIdx.x], 1) == nsplit - 1;
  asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");
  if (!last_block) return;
  __threadfence();
  for (int i = tid; i < gn * D; i += CONSUMERS) {
    const int g = i / D, d = i % D;
    const long prow = (head0 + g) * nsplit;
    float M = NEG_INF;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, __ldcg(part_m + prow + s));
    float L = 0.f, A = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float w = expf(__ldcg(part_m + prow + s) - M);
      L += __ldcg(part_l + prow + s) * w;
      A += __ldcg(part_acc + (prow + s) * D + d) * w;
    }
    out[(head0 + g) * D + d] = from_f<TQ>(A / fmaxf(L, 1e-30f));
  }
  if (tid == 0) counters[blockIdx.x] = 0;
}

struct Args {
  const void *q, *kc, *vc, *ks, *vs, *ci;
  float* part;
  int* counters;
  void* out;
  int B, T, H, KH, D, window, nsplit;
  int NG, GS;               // head groups a KV head, and their size
  cudaStream_t stream;
};

template <typename TKV>
constexpr CUtensorMapDataType tma_type() {
  return sizeof(TKV) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
         : sizeof(TKV) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

template <typename TQ, typename TKV, int D, int GMAX>
int launch(const Args& a) {
  using P = Plan<TKV, D, GMAX>;
  // (B, T, KH, D) innermost first; a box of TILE slots of one (b, kh)
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)a.KH,
                              (cuuint64_t)a.T, (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {(cuuint64_t)P::ROWB,
                                 (cuuint64_t)a.KH * P::ROWB,
                                 (cuuint64_t)a.T * a.KH * P::ROWB};
  const cuuint32_t box[4] = {(cuuint32_t)D, 1, (cuuint32_t)P::TILE, 1};
  CUtensorMap tm_k, tm_v;
  int rc = hopper::encode(&tm_k, tma_type<TKV>(), a.kc, 4, dims, strides,
                          box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc == 0)
    rc = hopper::encode(&tm_v, tma_type<TKV>(), a.vc, 4, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;
  // once per instantiation (a thread-safe static)
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_kernel<TQ, TKV, D, GMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::SMEM);
  if (attr != cudaSuccess) return attr;
  // whole tiles a split, so a tile never straddles two splits
  const int per = (a.T + a.nsplit - 1) / a.nsplit;
  const int chunk = (per + P::TILE - 1) / P::TILE * P::TILE;
  const dim3 grid(a.B * a.KH * a.NG, a.nsplit);
  decode_kernel<TQ, TKV, D, GMAX><<<grid, P::THREADS, P::SMEM, a.stream>>>(
      tm_k, tm_v, static_cast<const TQ*>(a.q),
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int*>(a.ci), a.part, a.counters,
      static_cast<TQ*>(a.out), a.T, a.KH, a.H / a.KH, a.NG, a.GS, a.window,
      chunk, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

// by the size of a head group (1 or 2)
template <typename TQ, typename TKV, int D>
int dispatch_g(const Args& a) {
  return a.GS == 1 ? launch<TQ, TKV, D, 1>(a) : launch<TQ, TKV, D, 2>(a);
}

template <typename TQ, typename TKV>
int dispatch_d(const Args& a) {
  switch (a.D) {
    case 32: return dispatch_g<TQ, TKV, 32>(a);
    case 64: return dispatch_g<TQ, TKV, 64>(a);
    case 128: return dispatch_g<TQ, TKV, 128>(a);
    case 192: return dispatch_g<TQ, TKV, 192>(a);
    case 256: return dispatch_g<TQ, TKV, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TKV, int D>
int smem_d(int group) {
  return group == 1 ? (int)Plan<TKV, D, 1>::SMEM : (int)Plan<TKV, D, 2>::SMEM;
}

template <typename TKV>
int smem_of(int D, int group) {
  switch (D) {
    case 32: return smem_d<TKV, 32>(group);
    case 64: return smem_d<TKV, 64>(group);
    case 128: return smem_d<TKV, 128>(group);
    case 192: return smem_d<TKV, 192>(group);
    case 256: return smem_d<TKV, 256>(group);
    default: return -1;
  }
}

}  // namespace

// The dynamic shared memory (bytes) a block of the kernel takes at head
// dim D, kv_dtype (as below) and `group` (1 or 2) query heads a block;
// -1 for an instantiation that does not exist.
extern "C" int flash_decode_smem(int D, int kv_dtype, int group) {
  if (group != 1 && group != 2) return -1;
  if (kv_dtype == 0) return smem_of<float>(D, group);
  if (kv_dtype == 1) return smem_of<__nv_bfloat16>(D, group);
  if (kv_dtype == 2) return smem_of<int8_t>(D, group);
  return -1;
}

// q_dtype: 0 = f32, 1 = bf16.  kv_dtype: 0 = f32, 1 = bf16, 2 = int8
// (then k_scale / v_scale are (B,T,KH) f32).  With num_splits > 1:
// `part` is f32 scratch of B H num_splits (D + 2) floats, and `counters`
// B KH head_groups int32 that are 0 (the kernel leaves them 0).  The G
// = H / KH query heads of a KV head go to head_groups blocks of GS =
// ceil(G / head_groups) heads (the last may hold fewer, none may be
// empty; GS at most 2).  window <= 0: no window.
// Returns a cudaError_t (0 on success), hopper::ERR_MISALIGNED for a
// cache whose base is not 16-byte aligned, or hopper::ERR_TENSOR_MAP + a
// CUresult when a TMA tensor map cannot be encoded.
extern "C" int flash_decode(const void* q, const void* k_cache,
                            const void* v_cache, const void* k_scale,
                            const void* v_scale, const void* cache_index,
                            void* part, void* counters, void* out, int B,
                            int T, int H, int KH, int D, int window,
                            int num_splits, int head_groups, int q_dtype,
                            int kv_dtype, void* stream) {
  if (B < 1 || T < 1 || KH < 1 || H % KH != 0 || num_splits < 1 ||
      head_groups < 1 || head_groups > H / KH ||
      (num_splits > 1 && (part == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const int G = H / KH, GS = (G + head_groups - 1) / head_groups;
  if (GS > 2 || (head_groups - 1) * GS >= G) return cudaErrorInvalidValue;
  if (!hopper::aligned16(k_cache) || !hopper::aligned16(v_cache))
    return hopper::ERR_MISALIGNED;
  Args a{q, k_cache, v_cache, k_scale, v_scale, cache_index,
         static_cast<float*>(part), static_cast<int*>(counters), out,
         B, T, H, KH, D, window, num_splits, head_groups, GS,
         static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && kv_dtype == 0) return dispatch_d<float, float>(a);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(a);
  if (q_dtype == 0 && kv_dtype == 2) return dispatch_d<float, int8_t>(a);
  if (q_dtype == 1 && kv_dtype == 2)
    return dispatch_d<__nv_bfloat16, int8_t>(a);
  return cudaErrorInvalidValue;
}
