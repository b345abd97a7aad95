// Online-softmax (flash) attention: GQA, causal, sliding window, logit
// softcap and a query offset, all as runtime arguments.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::attention
// (_attn_kernel).  q (B,Hq,S,D), k/v (B,Hkv,T,D), out (B,Hq,S,D), all bf16
// (or all fp32) and contiguous; query head h reads kv head h / (Hq/Hkv)
// straight from the index, so K/V are never repeated.  When the caller asks
// for it (training), each row's log-sum-exp of its scaled, capped scores is
// written too, fp32 (B,Hq,S), -inf on a row with no visible key: the
// backward kernel (flash_attention_bwd.cu) recomputes the probabilities
// from it.  A row with no visible key writes zeros.
//
// What bounds it: a prefill chunk (q (1,14,128,64) against T = 512) reads
// ~0.3 MB and does ~0.1 GFLOP, so on this card it is bound by latency: 28
// query tiles walking 8 key tiles each in turn.  The bf16 kernel keeps
// every product on the tensor cores and the walk short:
//
// - One warpgroup (128 threads) owns 64 query rows of one query head; its
//   Q tile is loaded once into shared memory, 128-byte swizzled.
// - K and V move in 64-key tiles aligned at absolute key 0 through a ring
//   of three shared-memory stages, fed by cp.async (16 bytes a thread, the
//   ragged end of T and S zero-filled per head); two tiles are in flight
//   while the third is used.  No tensor map is encoded per call.
// - S = Q·Kᵀ on wgmma m64n64k16 (both operands K-major in shared memory,
//   fp32 accumulator); the scale multiplies the fp32 score after the
//   product, then the softcap, then the mask.
// - The online softmax keeps m and l in registers, in wgmma's accumulator
//   layout (a row lives in the four lanes of a quad: max and sum are two
//   xor shuffles), in log2 units; P = 2^(s - m) is rounded to bf16 in
//   registers, where it already is the A fragment of the next product.
// - O += P·V on wgmma m64nDk16 with A = P from registers and B = the V tile
//   from shared memory, MN-major (the transposed descriptor).
// - Key tiles wholly outside the query tile's causal/window horizon are
//   skipped; the mask is applied only on tiles that straddle the horizon
//   or the end of T.
// - Row invariance: a row's result depends on its query, the keys and the
//   arguments only, never on S, its query tile or which chunk it sits in.
//   Key tiles are aligned at key 0 in every call, every row's reductions
//   run in the same order, and a tile fully masked for a row leaves its m,
//   l and accumulator bitwise unchanged (alpha = 2^0 = 1, P = 0).
// - Any head dim D <= 256 runs on the tile of the next width DT of 32, 64,
//   128 and 256: the columns past D load as zeros, which leave QKᵀ exact,
//   and P·V's columns past D are not stored (the scale is the caller's,
//   1/sqrt(D) of the real D).  A D that is a multiple of 8 loads by 16-byte
//   cp.async; any other D element by element (load_chunk8).  DT = 32 rows
//   are padded to 64 in shared memory (the padding is never read by QKᵀ,
//   and P·V's padded output columns are not stored); DT = 128 rows are two
//   64-wide boxes, DT = 256 rows (gemma-2b) four.  At D = 256
//   the Q tile and three K/V stages take 230,400 of the 232,448 bytes a
//   block may have, and the O accumulator 128 of a thread's registers
//   (64 x 256 fp32 over 128 threads; ptxas: 255 in all, 124 bytes
//   spilled); P·V is two m64n128k16 products on
//   the same P fragment (hopper.cuh's wgmma_rs<256>), each output column
//   summed over the keys as one product would, so rows stay invariant.
//
// fp32 q/k/v take the CUDA-core kernel (flash_attention_f32_kernel): each
// query row owned by 4 neighbouring lanes, scores and P·V as scalar FMAs
// from fp32 shared memory, 32-query tiles (172,544 bytes of it at D = 256).
#include <math.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---- bf16: wgmma -------------------------------------------------------------

constexpr int BM = 64;                 // query rows per block
constexpr int BN = 64;                 // keys per tile
constexpr int BOX = 64 * 64 * 2;       // one 64 x 64 bf16 tile, 8 KB
constexpr int STAGES = 3;              // K/V ring

template <int DT>
struct Dims {
  static constexpr int NB = DT > 64 ? DT / 64 : 1;  // 64-wide boxes per row
  static constexpr int DP = 64 * NB;              // row width in smem
  static constexpr int TILE = NB * BOX;           // one 64-row tile
  static constexpr int SMEM = 1024 + TILE + STAGES * 2 * TILE;
  static_assert(SMEM <= 232448, "a block's shared memory on sm_90");
};

// Rows [r0, r0 + 64) of a (rows, D) bf16 array into a swizzled tile DT
// wide; rows at or past ``nrows`` and columns at or past D read as zeros.
template <int DT>
__device__ __forceinline__ void load_tile(uint8_t* dst, const bf16* src,
                                          int r0, int nrows, int tid, int D) {
  constexpr int CPR = DT / 8;          // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < CPR / 2; ++it) {
    const int e = tid + 128 * it;
    const int r = e / CPR, c = e % CPR;
    const bool ok = r0 + r < nrows;
    load_chunk8(dst + (c / 8) * BOX + swz128(r, c % 8),
                src + (size_t)(ok ? r0 + r : 0) * D, c * 8, D, ok);
  }
}

template <int DT, bool EXACT>
__global__ void __launch_bounds__(128)
flash_attention_wgmma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             bf16* __restrict__ o, float* __restrict__ lse,
                             int Hq, int Hkv, int S, int T, int d_arg,
                             int causal, int window, float softcap,
                             float scale, int q_offset) {
  const int D = EXACT ? DT : d_arg;    // a tile's own width: constant
  using Dm = Dims<DT>;
  constexpr int DP = Dm::DP, TILE = Dm::TILE;
  constexpr int NO = DP / 2;           // O accumulator floats per thread
  extern __shared__ uint8_t dyn[];
  uint8_t* Qs = dyn + ((1024 - (smem_u32(dyn) & 1023)) & 1023);
  uint8_t* ring = Qs + TILE;           // stage s: K, then V

  const int bh = blockIdx.y;           // b * Hq + h
  const int b = bh / Hq;
  const int hk = (bh % Hq) / (Hq / Hkv);
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const bf16* kb = k + (size_t)(b * Hkv + hk) * T * D;
  const bf16* vb = v + (size_t)(b * Hkv + hk) * T * D;

  // the key tiles the query tile's horizon reaches, aligned at key 0
  const int q_last = min(S, q0 + BM) - 1;
  const int kv_end = causal ? min(T, q_offset + q_last + 1) : T;
  int kv_begin = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  kv_begin = (kv_begin / BN) * BN;
  const int ntiles = kv_end > kv_begin ? (kv_end - kv_begin + BN - 1) / BN
                                       : 0;

  // Q and the first STAGES - 1 K/V tiles, one commit group each (Q rides
  // with the first); empty groups keep the count uniform
  load_tile<DT>(Qs, q + (size_t)bh * S * D, q0, S, tid, D);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) {
      load_tile<DT>(ring + 2 * s * TILE, kb, kv_begin + s * BN, T, tid, D);
      load_tile<DT>(ring + (2 * s + 1) * TILE, vb, kv_begin + s * BN, T, tid,
                    D);
    }
    cp_async_commit();
  }

  // this thread's rows of the tile: r0 and r0 + 8 (wgmma's fragment)
  const int r0 = 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  float m[2] = {-INFINITY, -INFINITY};     // running max, log2 units
  float l[2] = {0.0f, 0.0f};
  float oacc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) oacc[i] = 0.0f;
  float sacc[32];
  uint32_t pa[16];

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();       // tile t (and Q) landed
    fence_proxy_async();
    __syncthreads();                   // everyone's copies; tile t-1 done
    {
      const int tn = t + STAGES - 1;   // into the stage tile t-1 used
      if (tn < ntiles) {
        uint8_t* st = ring + 2 * (tn % STAGES) * TILE;
        load_tile<DT>(st, kb, kv_begin + tn * BN, T, tid, D);
        load_tile<DT>(st + TILE, vb, kv_begin + tn * BN, T, tid, D);
      }
      cp_async_commit();
    }
    const uint8_t* Ks = ring + 2 * (t % STAGES) * TILE;
    const uint8_t* Vs = Ks + TILE;
    const int j0 = kv_begin + t * BN;

    // S = Q Kᵀ
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      const int off = (kk / 4) * BOX + (kk % 4) * 32;
      wgmma<64, 0, 0>(sacc, make_desc(Qs + off, 16, 1024),
                      make_desc(Ks + off, 16, 1024), kk > 0 ? 1 : 0);
    }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(sacc[i]);

    // scale, cap, mask; log2 units
    const bool edge = j0 + BN > T ||
                      (causal && j0 + BN - 1 > q_offset + q0) ||
                      (window > 0 && j0 <= q_offset + q_last - window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float s = sacc[i] * scale;
      if (softcap > 0.0f) s = softcap * tanhf(s / softcap);
      s *= LOG2E;
      if (edge) {
        const int qpos = q_offset + q0 + r0 + ((i & 2) ? 8 : 0);
        const int j = j0 + 8 * (i / 4) + c0 + (i & 1);
        bool ok = j < T;
        if (causal) ok = ok && j <= qpos;
        if (window > 0) ok = ok && j > qpos - window;
        if (!ok) s = -INFINITY;
      }
      sacc[i] = s;
    }

    // online softmax, per row: register i holds row r0 + 8 * ((i >> 1) & 1)
    float mu[2], alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int g = 0; g < 8; ++g)
        mx = fmaxf(mx, fmaxf(sacc[4 * g + 2 * rr], sacc[4 * g + 2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      // while a row has seen no visible key its max stays -inf; 0 in its
      // place keeps exp2 away from -inf - -inf
      mu[rr] = m_new == -INFINITY ? 0.0f : m_new;
      alpha[rr] = exp2f(m[rr] - mu[rr]);
      m[rr] = m_new;
    }
    float ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i >> 1) & 1;
      const float p = exp2f(sacc[i] - mu[rr]);     // 2^-inf = 0
      sacc[i] = p;
      ps[rr] += p;
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      ps[rr] += __shfl_xor_sync(0xffffffffu, ps[rr], 1);
      ps[rr] += __shfl_xor_sync(0xffffffffu, ps[rr], 2);
      l[rr] = l[rr] * alpha[rr] + ps[rr];
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) oacc[i] *= alpha[(i >> 1) & 1];
    // P as the A fragments of the four k16 steps of P·V
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[4 * kk + e] = pack_bf16(sacc[8 * kk + 2 * e],
                                   sacc[8 * kk + 2 * e + 1]);

    // O += P V
#pragma unroll
    for (int i = 0; i < NO; ++i) fence_reg(oacc[i]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DP, 1>(oacc, pa + 4 * kk, make_desc(Vs + kk * 2048, BOX, 1024),
                      1);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int i = 0; i < NO; ++i) fence_reg(oacc[i]);
#pragma unroll
    for (int i = 0; i < 16; ++i) fence_u32(pa[i]);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + r0 + 8 * rr;
    if (qi >= S) continue;
    const float inv = l[rr] > 0.0f ? 1.0f / l[rr] : 0.0f;
    bf16* ob = o + ((size_t)bh * S + qi) * D;
#pragma unroll
    for (int g = 0; g < DP / 8; ++g) {
      const int col = 8 * g + c0;
      const float x = oacc[4 * g + 2 * rr] * inv;
      const float y = oacc[4 * g + 2 * rr + 1] * inv;
      if ((D & 1) == 0) {              // the pair is 4-byte aligned
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(ob + col) =
              __floats2bfloat162_rn(x, y);
      } else {
        if (col < D) ob[col] = __float2bfloat16(x);
        if (col + 1 < D) ob[col + 1] = __float2bfloat16(y);
      }
    }
    if (lse != nullptr && lane % 4 == 0)
      lse[(size_t)bh * S + qi] =
          l[rr] > 0.0f ? (m[rr] + log2f(l[rr])) * LN2 : -INFINITY;
  }
}

template <int DT, bool EXACT>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int Hq, int Hkv, int S, int T, int D,
                int causal, int window, float softcap, float scale,
                int q_offset, cudaStream_t s) {
  constexpr int SMEM = Dims<DT>::SMEM;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_wgmma_kernel<DT, EXACT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const dim3 grid((S + BM - 1) / BM, B * Hq);
  flash_attention_wgmma_kernel<DT, EXACT><<<grid, 128, SMEM, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), Hq, Hkv, S, T, D, causal, window, softcap,
      scale, q_offset);
  return static_cast<int>(cudaGetLastError());
}

// ---- fp32: CUDA cores ----------------------------------------------------------

constexpr int F_BQ = 32;
constexpr int F_BKV = 64;
constexpr int F_THREADS = 128;
constexpr int TPR = F_THREADS / F_BQ;   // lanes per query row

// DT, one of 32, 64, 128 and 256, is the tile's width: the real head dim
// D <= DT strides the global rows, and columns past it are zeros in shared
// memory (they add exact zeros to the scores and are not stored).
template <int DT>
constexpr size_t f32_smem_bytes() {
  // Qs (BQ x DT+1) + Ks (BKV x DT+1) + Vs (BKV x DT) + Ps (BQ x BKV+1), fp32
  return sizeof(float) * (F_BQ * (DT + 1) + F_BKV * (DT + 1) + F_BKV * DT +
                          F_BQ * (F_BKV + 1));
}

template <int DT, bool EXACT>
__global__ void __launch_bounds__(F_THREADS)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ o, float* __restrict__ lse,
                           int Hq, int Hkv, int S, int T, int d_arg,
                           int causal, int window, float softcap, float scale,
                           int q_offset) {
  const int D = EXACT ? DT : d_arg;    // a tile's own width: constant
  constexpr int DP = DT + 1;
  constexpr int PP = F_BKV + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + F_BQ * DP;
  float* Vs = Ks + F_BKV * DP;
  float* Ps = Vs + F_BKV * DT;

  const int bh = blockIdx.y;                 // b * Hq + h
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * F_BQ;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int sub = tid % TPR;

  const float* qb = q + (size_t)bh * S * D;
  const float* kb = k + (size_t)(b * Hkv + hk) * T * D;
  const float* vb = v + (size_t)(b * Hkv + hk) * T * D;

  for (int idx = tid; idx < F_BQ * DT; idx += F_THREADS) {
    const int rr = idx / DT;
    const int d = idx % DT;
    const int qi = q0 + rr;
    Qs[rr * DP + d] =
        qi < S && d < D ? qb[(size_t)qi * D + d] * scale : 0.0f;
  }

  const int qi = q0 + r;
  const int qpos = q_offset + qi;
  const int q_last = min(S, q0 + F_BQ) - 1;
  int kv_end = T;
  if (causal) kv_end = min(T, q_offset + q_last + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q_offset + q0 - window + 1);
  kv_begin = (kv_begin / F_BKV) * F_BKV;

  float m = -INFINITY;
  float l = 0.0f;
  float acc[DT / TPR];
#pragma unroll
  for (int e = 0; e < DT / TPR; ++e) acc[e] = 0.0f;

  for (int j0 = kv_begin; j0 < kv_end; j0 += F_BKV) {
    __syncthreads();            // Qs written / last tile's readers done
    for (int idx = tid; idx < F_BKV * DT; idx += F_THREADS) {
      const int jj = idx / DT;
      const int d = idx % DT;
      const int j = j0 + jj;
      float kx = 0.0f, vx = 0.0f;
      if (j < T && d < D) {
        kx = kb[(size_t)j * D + d];
        vx = vb[(size_t)j * D + d];
      }
      Ks[jj * DP + d] = kx;
      Vs[jj * DT + d] = vx;
    }
    __syncthreads();

    // Scores for keys jj = c * TPR + sub (lanes of a row on adjacent keys).
    float s[F_BKV / TPR];
    float tmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < F_BKV / TPR; ++c) {
      const int jj = c * TPR + sub;
      const int j = j0 + jj;
      float dot = 0.0f;
#pragma unroll 16
      for (int d = 0; d < DT; ++d) dot += Qs[r * DP + d] * Ks[jj * DP + d];
      if (softcap > 0.0f) dot = softcap * tanhf(dot / softcap);
      bool ok = (j < T) && (qi < S);
      if (causal) ok = ok && (j <= qpos);
      if (window > 0) ok = ok && (j > qpos - window);
      s[c] = ok ? dot : -INFINITY;
      tmax = fmaxf(tmax, s[c]);
    }
#pragma unroll
    for (int off = 1; off < TPR; off *= 2)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    const float m_new = fmaxf(m, tmax);
    // While a row has seen no visible key its max stays -inf; subtracting
    // 0 instead keeps exp() away from inf - inf.
    const float m_use = (m_new == -INFINITY) ? 0.0f : m_new;
    const float alpha = expf(m - m_use);
    float psum = 0.0f;
#pragma unroll
    for (int c = 0; c < F_BKV / TPR; ++c) {
      const float p = (s[c] == -INFINITY) ? 0.0f : expf(s[c] - m_use);
      Ps[r * PP + c * TPR + sub] = p;
      psum += p;
    }
#pragma unroll
    for (int off = 1; off < TPR; off *= 2)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();               // the row's Ps entries come from its 4 lanes

#pragma unroll
    for (int e = 0; e < DT / TPR; ++e) {
      const int d = e * TPR + sub;
      float a = acc[e] * alpha;
#pragma unroll 16
      for (int jj = 0; jj < F_BKV; ++jj) a += Ps[r * PP + jj] * Vs[jj * DT + d];
      acc[e] = a;
    }
  }

  if (qi < S) {
    const float inv = l > 0.0f ? 1.0f / l : 0.0f;
    float* ob = o + ((size_t)bh * S + qi) * D;
#pragma unroll
    for (int e = 0; e < DT / TPR; ++e)
      if (e * TPR + sub < D) ob[e * TPR + sub] = acc[e] * inv;
    if (lse != nullptr && sub == 0)
      lse[(size_t)bh * S + qi] = l > 0.0f ? m + logf(l) : -INFINITY;
  }
}

template <int DT, bool EXACT>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int Hq, int Hkv, int S, int T, int D,
               int causal, int window, float softcap, float scale,
               int q_offset, cudaStream_t s) {
  constexpr size_t bytes = f32_smem_bytes<DT>();
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_f32_kernel<DT, EXACT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const dim3 grid((S + F_BQ - 1) / F_BQ, B * Hq);
  flash_attention_f32_kernel<DT, EXACT><<<grid, F_THREADS, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), Hq, Hkv, S, T, D, causal, window, softcap,
      scale, q_offset);
  return static_cast<int>(cudaGetLastError());
}

typedef int (*Launch)(const void*, const void*, const void*, void*, void*,
                      int, int, int, int, int, int, int, int, float, float,
                      int, cudaStream_t);

// The launch for head dim D: a power-of-two D on its own tile with D a
// compile-time constant (strides, masks and the 16-byte loads fold away),
// any other D <= 256 on the tile of the next width with the columns past
// it masked.
template <Launch (*PICK)(int, bool)>
int dispatch(const void* q, const void* k, const void* v, void* o,
             void* lse, int B, int Hq, int Hkv, int S, int T, int D,
             int causal, int window, float softcap, float scale, int q_offset,
             void* stream) {
  const int width = D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
  const Launch fn = D <= 0 || D > 256 ? nullptr : PICK(width, D == width);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, o, lse, B, Hq, Hkv, S, T, D, causal, window, softcap,
            scale, q_offset, static_cast<cudaStream_t>(stream));
}

Launch pick_bf16(int width, bool exact) {
  switch (width) {
    case 32: return exact ? launch_bf16<32, true> : launch_bf16<32, false>;
    case 64: return exact ? launch_bf16<64, true> : launch_bf16<64, false>;
    case 128:
      return exact ? launch_bf16<128, true> : launch_bf16<128, false>;
    default:
      return exact ? launch_bf16<256, true> : launch_bf16<256, false>;
  }
}

Launch pick_f32(int width, bool exact) {
  switch (width) {
    case 32: return exact ? launch_f32<32, true> : launch_f32<32, false>;
    case 64: return exact ? launch_f32<64, true> : launch_f32<64, false>;
    case 128: return exact ? launch_f32<128, true> : launch_f32<128, false>;
    default: return exact ? launch_f32<256, true> : launch_f32<256, false>;
  }
}

}  // namespace

// window <= 0 means no sliding window; softcap <= 0 means no softcap; lse
// may be null (serving).
extern "C" int dmath_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int B, int Hq, int Hkv, int S,
                                          int T, int D,
                                          int causal, int window,
                                          float softcap, float scale,
                                          int q_offset, void* stream) {
  return dispatch<pick_bf16>(q, k, v, o, lse, B, Hq, Hkv, S, T, D, causal,
                             window, softcap, scale, q_offset, stream);
}

// The same for fp32 q, k, v and out, on CUDA cores.
extern "C" int dmath_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int B, int Hq, int Hkv, int S,
                                         int T, int D,
                                         int causal, int window,
                                         float softcap, float scale,
                                         int q_offset, void* stream) {
  return dispatch<pick_f32>(q, k, v, o, lse, B, Hq, Hkv, S, T, D, causal,
                            window, softcap, scale, q_offset, stream);
}
