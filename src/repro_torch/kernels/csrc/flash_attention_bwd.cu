// Backward of flash attention: dQ, dK, dV from the forward's per-row
// log-sum-exp, with GQA, causal masking, a sliding window, a tanh logit
// softcap and a query offset as runtime arguments.
//
// The TPU reference has no backward kernel (its model trains through
// layers.flash_attention_jnp); this is the port's own, the backward of
// csrc/flash_attention.cu.  q/dq (B,Hq,S,D), k/v/dk/dv (B,Hkv,T,D), o/do
// (B,Hq,S,D), all bf16 and contiguous; lse and delta (B,Hq,S) fp32.
// Four launches, none with atomics, so the result is bitwise the same from
// run to run:
//
// 1. delta[row] = sum_d dO[row,d] * O[row,d], one warp per query row.
// 2. dK/dV: one block (one warpgroup) per (batch, query head, 64-key
//    tile, parity).  Its K and V tiles stay in shared memory and its dK
//    and dV in fp32 registers while it walks the 64-query tiles of its
//    head that can see its keys and whose index has its parity (Q, dO, lse
//    and delta through a ring of two stages fed by cp.async):
//      Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ   (wgmma, the 64 keys on the M side)
//      Pᵀ = exp(Sᵀ - lse),  dSᵀ = Pᵀ ∘ (dPᵀ - delta)
//      dV += Pᵀ·dO,  dK += dSᵀ·Q   (A = Pᵀ, dSᵀ as bf16 register fragments;
//                                    B = dO, Q MN-major from shared memory)
//    Each (query head, parity) writes its share to an fp32 scratch, so a
//    kv head's g query heads and both halves of each walk run in parallel
//    blocks (the walk, and so the chain of dependent products, is half as
//    long).
// 3. dQ: one block per (batch, query head, 64-query tile, parity), Q and dO
//    held in shared memory, walking the 64-key tiles of its horizon with
//    its parity (K and V through a ring of three stages): S = Q·Kᵀ,
//    dP = dO·Vᵀ, dQ += dS·K (A = dS from registers, B = K MN-major); each
//    parity's share to fp32 scratch.
// 4. The ordered sums, elementwise: dK, dV of kv head hk = its g query
//    heads' shares in head order, each head's two parities in order; dQ =
//    scale (even share + odd share).
//
// s = scale q.k (the scale multiplies the fp32 product), capped as
// softcap tanh(s / softcap) when a softcap is given, whose derivative
// 1 - tanh^2 multiplies dS; the scale multiplies dK and dQ once, at the
// end.  P and dS are rounded to bf16 before their products (the tensor
// cores' operand type).  A row with no visible key (lse = -inf) has every
// key masked, so its P is 0 and its gradients are zero; no exp of
// -inf - -inf is formed.  Masks are applied only on tile pairs that
// straddle the causal/window horizon or the end of S or T.  Tiles are
// 128-byte-swizzled 64 x 64 bf16 boxes (hopper.cuh); D = 32 rows are padded
// to 64 in shared memory and the padding's output columns not stored.
//
// What bounds it: at the train shape (q (2,14,512,64), causal) its five
// products are ~2.4 µs of bf16 tensor-core work and its bytes ~1.3 µs, so
// like the forward it is bound by latency: the tile walk of each block,
// which the parity split halves.
#include <math.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BOX = 64 * 64 * 2;       // one 64 x 64 bf16 tile, 8 KB
constexpr int BT = 64;                 // rows of every tile (keys, queries)

template <int D>
struct Dims {
  static constexpr int NB = D > 64 ? D / 64 : 1;  // 64-wide boxes per row
  static constexpr int DP = 64 * NB;              // row width in smem
  static constexpr int TILE = NB * BOX;
};

__device__ __forceinline__ bool visible(int j, int qpos, int T, int causal,
                                        int window) {
  bool ok = j < T;
  if (causal) ok = ok && (j <= qpos);
  if (window > 0) ok = ok && (j > qpos - window);
  return ok;
}

// Whether a pair of tiles (64 keys from j0, 64 queries from i0) holds a
// masked pair: the ragged end of S or T, or the causal/window horizon.
__device__ __forceinline__ bool straddles(int j0, int i0, int S, int T,
                                          int causal, int window,
                                          int q_offset) {
  return j0 + BT > T || i0 + BT > S ||
         (causal && j0 + BT - 1 > q_offset + i0) ||
         (window > 0 && j0 <= q_offset + i0 + BT - 1 - window);
}

// cp.async rows [r0, r0 + 64) of a (rows, D) bf16 array into a swizzled
// tile; rows at or past ``nrows`` read as zeros.
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const bf16* src,
                                          int r0, int nrows, int tid) {
  constexpr int CPR = D / 8;           // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < CPR / 2; ++it) {
    const int e = tid + 128 * it;
    const int r = e / CPR, c = e % CPR;
    const bool ok = r0 + r < nrows;
    cp_async16(dst + (c / 8) * BOX + swz128(r, c % 8),
               src + (size_t)(ok ? r0 + r : 0) * D + c * 8, ok);
  }
}

// A = X·Yᵀ for two 64-row tiles in shared memory (both K-major, depth D):
// 32 fp32 per thread, wgmma's m64n64 fragment.
template <int D>
__device__ __forceinline__ void issue_xyt(float* acc, const uint8_t* x,
                                          const uint8_t* y) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * BOX + (kk % 4) * 32;
    wgmma<64, 0, 0>(acc, make_desc(x + off, 16, 1024),
                    make_desc(y + off, 16, 1024), kk > 0 ? 1 : 0);
  }
}

// acc (64 x DP) += A (64 x 64, bf16 fragments a[16]) · Y (a 64-row tile:
// its rows the product's depth, MN-major).
template <int DP>
__device__ __forceinline__ void issue_ay(float* acc, const uint32_t* a,
                                         const uint8_t* y) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<DP, 1>(acc, a + 4 * kk, make_desc(y + kk * 2048, BOX, 1024), 1);
}

// The 32 fp32 of an m64n64 fragment as the A fragments of the four k16
// steps of a product over its 64 columns.
__device__ __forceinline__ void to_frag(const float* x, uint32_t* a) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[4 * kk + e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

__global__ void attn_bwd_delta_kernel(const bf16* __restrict__ o,
                                      const bf16* __restrict__ dout,
                                      float* __restrict__ delta, int rows,
                                      int D) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;             // uniform across the warp
  const bf16* a = o + (size_t)row * D;
  const bf16* b = dout + (size_t)row * D;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32)
    acc += __bfloat162float(a[d]) * __bfloat162float(b[d]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---- dK, dV ----------------------------------------------------------------

constexpr int KV_STAGES = 2;

// one stage of the ring: Q, dO, then lse and delta
template <int D>
__host__ __device__ constexpr int dkdv_stage() {
  return 2 * Dims<D>::TILE + 1024;
}

template <int D>
__host__ __device__ constexpr int dkdv_smem() {
  return 1024 + 2 * Dims<D>::TILE + KV_STAGES * dkdv_stage<D>();
}

template <int D>
__global__ void __launch_bounds__(128, D > 64 ? 1 : 3)
attn_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ part_k, float* __restrict__ part_v,
                     int Hq, int Hkv, int S, int T, int causal, int window,
                     float softcap, float scale, int q_offset) {
  using Dm = Dims<D>;
  constexpr int DP = Dm::DP, TILE = Dm::TILE, NO = DP / 2;
  constexpr int STAGE = dkdv_stage<D>();
  extern __shared__ uint8_t dyn[];
  uint8_t* Ks = dyn + ((1024 - (smem_u32(dyn) & 1023)) & 1023);
  uint8_t* Vs = Ks + TILE;
  uint8_t* ring = Vs + TILE;             // stage s: Q, dO, lse, delta

  const int bh = blockIdx.y;                  // b * Hq + h
  const int b = bh / Hq;
  const int bkv = b * Hkv + (bh % Hq) / (Hq / Hkv);
  const int j0 = blockIdx.x * BT;
  const int par = blockIdx.z;                 // the query tiles' parity
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const bf16* qb = q + (size_t)bh * S * D;
  const bf16* dob = dout + (size_t)bh * S * D;
  const float* lb = lse + (size_t)bh * S;
  const float* db = delta + (size_t)bh * S;

  // The query tiles [tau0, tau1) that can see a key of this tile (causal
  // needs qpos >= j0, a window qpos < j_last + window); this block takes
  // those of its parity.
  const int j_last = min(T, j0 + BT) - 1;
  const int qi_begin = causal ? max(0, j0 - q_offset) : 0;
  const int qi_end =
      window > 0 ? max(0, min(S, j_last + window - q_offset)) : S;
  const int tau0 = qi_begin / BT;
  const int tau1 = qi_end > qi_begin ? (qi_end + BT - 1) / BT : tau0;
  const int first = tau0 + (par - tau0 % 2 + 2) % 2;
  const int ntiles = first < tau1 ? (tau1 - first + 1) / 2 : 0;

  auto load_stage = [&](int s, int i0) {
    uint8_t* st = ring + s * STAGE;
    load_tile<D>(st, qb, i0, S, tid);
    load_tile<D>(st + TILE, dob, i0, S, tid);
    float* rows = reinterpret_cast<float*>(st + 2 * TILE);
    const int ii = tid % 64;
    const bool ok = i0 + ii < S;
    const float* src = (tid < 64 ? lb : db) + (ok ? i0 + ii : 0);
    cp_async4(rows + tid, src, ok);      // lse[0..64), then delta[0..64)
  };

  load_tile<D>(Ks, k + (size_t)bkv * T * D, j0, T, tid);
  load_tile<D>(Vs, v + (size_t)bkv * T * D, j0, T, tid);
  if (ntiles > 0) load_stage(0, first * BT);
  cp_async_commit();

  const int r0 = 16 * warp + lane / 4;   // keys j0 + r0, j0 + r0 + 8
  const int c0 = 2 * (lane % 4);
  float dk[NO], dv[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.0f;
  float sacc[32], pacc[32];
  uint32_t pf[16], sf[16];

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();                  // query tile t (and K, V) landed
    fence_proxy_async();
    __syncthreads();                     // everyone's copies; tile t-1 done
    if (t + 1 < ntiles)
      load_stage((t + 1) % KV_STAGES, (first + 2 * (t + 1)) * BT);
    cp_async_commit();
    const uint8_t* st = ring + (t % KV_STAGES) * STAGE;
    const uint8_t* Qs = st;
    const uint8_t* dOs = st + TILE;
    const float* lse_s = reinterpret_cast<const float*>(st + 2 * TILE);
    const float* delta_s = lse_s + 64;
    const int i0 = (first + 2 * t) * BT;

    // Sᵀ = K Qᵀ, dPᵀ = V dOᵀ
    wg_fence();
    issue_xyt<D>(sacc, Ks, Qs);
    issue_xyt<D>(pacc, Vs, dOs);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      fence_reg(sacc[i]);
      fence_reg(pacc[i]);
    }

    const bool edge = straddles(j0, i0, S, T, causal, window, q_offset);
    // register i: key j0 + r0 + 8 ((i >> 1) & 1), query i0 + 8 (i / 4) +
    // c0 + (i & 1)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int ii = 8 * (i / 4) + c0 + (i & 1);
      float s = sacc[i] * scale;
      float dcap = 1.0f;
      if (softcap > 0.0f) {
        const float th = tanhf(s / softcap);
        s = softcap * th;
        dcap = 1.0f - th * th;
      }
      bool ok = true;
      if (edge) {
        const int j = j0 + r0 + ((i & 2) ? 8 : 0);
        ok = i0 + ii < S && visible(j, q_offset + i0 + ii, T, causal, window);
      }
      const float p = ok ? exp2f((s - lse_s[ii]) * LOG2E) : 0.0f;
      sacc[i] = p;
      pacc[i] = p * (pacc[i] - delta_s[ii]) * dcap;
    }
    to_frag(sacc, pf);
    to_frag(pacc, sf);

    // dV += Pᵀ dO, dK += dSᵀ Q
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      fence_reg(dv[i]);
      fence_reg(dk[i]);
    }
    wg_fence();
    issue_ay<DP>(dv, pf, dOs);
    issue_ay<DP>(dk, sf, Qs);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      fence_reg(dv[i]);
      fence_reg(dk[i]);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      fence_u32(pf[i]);
      fence_u32(sf[i]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int j = j0 + r0 + 8 * rr;
    if (j >= T) continue;
    const size_t shares = (size_t)gridDim.y * T * D;   // per output, parity
    float* pk = part_k + par * shares + ((size_t)bh * T + j) * D;
    float* pv = part_v + par * shares + ((size_t)bh * T + j) * D;
#pragma unroll
    for (int g = 0; g < DP / 8; ++g) {
      const int col = 8 * g + c0;
      if (col < D) {
        *reinterpret_cast<float2*>(pk + col) = make_float2(
            dk[4 * g + 2 * rr] * scale, dk[4 * g + 2 * rr + 1] * scale);
        *reinterpret_cast<float2*>(pv + col) =
            make_float2(dv[4 * g + 2 * rr], dv[4 * g + 2 * rr + 1]);
      }
    }
  }
}

// The ordered sums, elementwise: dK, dV (B,Hkv,T,D) bf16 = over each kv
// head's g query heads in head order, and for each over the two parities
// of its query tiles, their fp32 shares; dQ (B,Hq,S,D) bf16 = scale (the
// even key tiles' share + the odd ones').
__global__ void attn_bwd_sum_kernel(const float* __restrict__ part_k,
                                    const float* __restrict__ part_v,
                                    const float* __restrict__ part_q,
                                    bf16* __restrict__ dk,
                                    bf16* __restrict__ dv,
                                    bf16* __restrict__ dq, int Hq, int Hkv,
                                    size_t per_head, size_t n_kv,
                                    size_t n_q, float scale) {
  const int g = Hq / Hkv;
  const size_t shares = n_kv * g;              // one parity's (B,Hq,T,D)
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_kv + n_q; i += (size_t)gridDim.x * blockDim.x) {
    if (i >= n_kv) {
      const size_t e = i - n_kv;
      dq[e] = __float2bfloat16((part_q[e] + part_q[n_q + e]) * scale);
      continue;
    }
    const size_t bkv = i / per_head;
    const size_t rest = i % per_head;
    const size_t h0 = (bkv / Hkv) * Hq + (bkv % Hkv) * g;
    float sk = 0.0f, sv = 0.0f;
    for (int hh = 0; hh < g; ++hh) {
      const size_t e = (h0 + hh) * per_head + rest;
      sk += part_k[e];
      sk += part_k[shares + e];
      sv += part_v[e];
      sv += part_v[shares + e];
    }
    dk[i] = __float2bfloat16(sk);
    dv[i] = __float2bfloat16(sv);
  }
}

// ---- dQ --------------------------------------------------------------------

constexpr int DQ_STAGES = 3;

template <int D>
__host__ __device__ constexpr int dq_smem() {
  return 1024 + 2 * Dims<D>::TILE + DQ_STAGES * 2 * Dims<D>::TILE;
}

template <int D>
__global__ void __launch_bounds__(128)
attn_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   float* __restrict__ part_q, int Hq, int Hkv, int S, int T,
                   int causal, int window, float softcap, float scale,
                   int q_offset) {
  using Dm = Dims<D>;
  constexpr int DP = Dm::DP, TILE = Dm::TILE, NO = DP / 2;
  extern __shared__ uint8_t dyn[];
  uint8_t* Qs = dyn + ((1024 - (smem_u32(dyn) & 1023)) & 1023);
  uint8_t* dOs = Qs + TILE;
  uint8_t* ring = dOs + TILE;            // stage s: K, then V

  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int bkv = b * Hkv + (bh % Hq) / (Hq / Hkv);
  const int q0 = blockIdx.x * BT;
  const int par = blockIdx.z;                 // the key tiles' parity
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const bf16* kb = k + (size_t)bkv * T * D;
  const bf16* vb = v + (size_t)bkv * T * D;

  // the key tiles [tau0, tau1) of the query tile's horizon; this block
  // takes those of its parity
  const int q_last = min(S, q0 + BT) - 1;
  const int kv_end = causal ? min(T, q_offset + q_last + 1) : T;
  const int kv_begin = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  const int tau0 = kv_begin / BT;
  const int tau1 = kv_end > kv_begin ? (kv_end + BT - 1) / BT : tau0;
  const int first = tau0 + (par - tau0 % 2 + 2) % 2;
  const int ntiles = first < tau1 ? (tau1 - first + 1) / 2 : 0;

  load_tile<D>(Qs, q + (size_t)bh * S * D, q0, S, tid);
  load_tile<D>(dOs, dout + (size_t)bh * S * D, q0, S, tid);
#pragma unroll
  for (int s = 0; s < DQ_STAGES - 1; ++s) {
    if (s < ntiles) {
      const int j0 = (first + 2 * s) * BT;
      load_tile<D>(ring + 2 * s * TILE, kb, j0, T, tid);
      load_tile<D>(ring + (2 * s + 1) * TILE, vb, j0, T, tid);
    }
    cp_async_commit();
  }

  const int r0 = 16 * warp + lane / 4;   // rows q0 + r0, q0 + r0 + 8
  const int c0 = 2 * (lane % 4);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + r0 + 8 * rr;
    row_lse[rr] = qi < S ? lse[(size_t)bh * S + qi] : 0.0f;
    row_delta[rr] = qi < S ? delta[(size_t)bh * S + qi] : 0.0f;
  }
  float dqa[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dqa[i] = 0.0f;
  float sacc[32], pacc[32];
  uint32_t sf[16];

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<DQ_STAGES - 2>();      // key tile t (and Q, dO) landed
    fence_proxy_async();
    __syncthreads();
    {
      const int tn = t + DQ_STAGES - 1;
      if (tn < ntiles) {
        uint8_t* st = ring + 2 * (tn % DQ_STAGES) * TILE;
        load_tile<D>(st, kb, (first + 2 * tn) * BT, T, tid);
        load_tile<D>(st + TILE, vb, (first + 2 * tn) * BT, T, tid);
      }
      cp_async_commit();
    }
    const uint8_t* Ks = ring + 2 * (t % DQ_STAGES) * TILE;
    const uint8_t* Vs = Ks + TILE;
    const int j0 = (first + 2 * t) * BT;

    // S = Q Kᵀ, dP = dO Vᵀ
    wg_fence();
    issue_xyt<D>(sacc, Qs, Ks);
    issue_xyt<D>(pacc, dOs, Vs);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      fence_reg(sacc[i]);
      fence_reg(pacc[i]);
    }

    const bool edge = straddles(j0, q0, S, T, causal, window, q_offset);
    // register i: query q0 + r0 + 8 ((i >> 1) & 1), key j0 + 8 (i / 4) +
    // c0 + (i & 1)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i >> 1) & 1;
      float s = sacc[i] * scale;
      float dcap = 1.0f;
      if (softcap > 0.0f) {
        const float th = tanhf(s / softcap);
        s = softcap * th;
        dcap = 1.0f - th * th;
      }
      bool ok = true;
      if (edge) {
        const int qi = q0 + r0 + 8 * rr;
        const int j = j0 + 8 * (i / 4) + c0 + (i & 1);
        ok = qi < S && visible(j, q_offset + qi, T, causal, window);
      }
      const float p = ok ? exp2f((s - row_lse[rr]) * LOG2E) : 0.0f;
      pacc[i] = p * (pacc[i] - row_delta[rr]) * dcap;
    }
    to_frag(pacc, sf);

    // dQ += dS K
#pragma unroll
    for (int i = 0; i < NO; ++i) fence_reg(dqa[i]);
    wg_fence();
    issue_ay<DP>(dqa, sf, Ks);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int i = 0; i < NO; ++i) fence_reg(dqa[i]);
#pragma unroll
    for (int i = 0; i < 16; ++i) fence_u32(sf[i]);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + r0 + 8 * rr;
    if (qi >= S) continue;
    float* out = part_q + par * ((size_t)gridDim.y * S * D) +
                 ((size_t)bh * S + qi) * D;
#pragma unroll
    for (int g = 0; g < DP / 8; ++g) {
      const int col = 8 * g + c0;
      if (col < D)
        *reinterpret_cast<float2*>(out + col) =
            make_float2(dqa[4 * g + 2 * rr], dqa[4 * g + 2 * rr + 1]);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& ready) {
  if (ready) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  ready = err == cudaSuccess;
  return err;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* part,
           void* dq, void* dk, void* dv, int B, int Hq, int Hkv, int S,
           int T,
           int causal, int window, float softcap, float scale, int q_offset,
           cudaStream_t s) {
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  const bf16* dO = static_cast<const bf16*>(dout);
  const float* L = static_cast<const float*>(lse);
  float* Dl = static_cast<float*>(delta);

  const int rows = B * Hq * S;
  attn_bwd_delta_kernel<<<(rows + 7) / 8, 256, 0, s>>>(
      static_cast<const bf16*>(o), dO, Dl, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  static bool kv_ready = false, q_ready = false;
  err = allow_smem(attn_bwd_dkdv_kernel<D>, dkdv_smem<D>(), kv_ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* part_k = static_cast<float*>(part);
  float* part_v = part_k + 2 * (size_t)B * Hq * T * D;
  float* part_q = part_v + 2 * (size_t)B * Hq * T * D;
  attn_bwd_dkdv_kernel<D><<<dim3((T + BT - 1) / BT, B * Hq, 2), 128,
                            dkdv_smem<D>(), s>>>(
      Q, K, V, dO, L, Dl, part_k, part_v, Hq, Hkv, S, T, causal, window,
      softcap, scale, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = allow_smem(attn_bwd_dq_kernel<D>, dq_smem<D>(), q_ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_kernel<D><<<dim3((S + BT - 1) / BT, B * Hq, 2), 128,
                          dq_smem<D>(), s>>>(
      Q, K, V, dO, L, Dl, part_q, Hq, Hkv, S, T, causal, window, softcap,
      scale, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t per_head = (size_t)T * D;
  const size_t n_kv = (size_t)B * Hkv * per_head;
  const size_t n_q = (size_t)B * Hq * S * D;
  const size_t n = n_kv + n_q;
  const int sum_blocks = static_cast<int>(
      n / 256 + 1 < 132 * 16 ? n / 256 + 1 : 132 * 16);
  attn_bwd_sum_kernel<<<sum_blocks, 256, 0, s>>>(
      part_k, part_v, part_q, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<bf16*>(dq), Hq, Hkv, per_head, n_kv, n_q, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// window <= 0 means no sliding window; softcap <= 0 means no softcap.
// The caller allocates the fp32 scratch: delta (B,Hq,S) and part, the
// shares the last pass adds: dK's and dV's of each query head and parity,
// 2 x 2 x (B,Hq,T,D), then dQ's of each parity, 2 x (B,Hq,S,D).
extern "C" int dmath_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* part, void* dq,
    void* dk, void* dv, int B, int Hq, int Hkv, int S, int T, int D,
    int causal, int window, float softcap, float scale, int q_offset,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, o, dout, lse, delta, part, dq, dk, dv, B, Hq,
                        Hkv, S, T, causal, window, softcap, scale, q_offset,
                        s);
    case 64:
      return launch<64>(q, k, v, o, dout, lse, delta, part, dq, dk, dv, B, Hq,
                        Hkv, S, T, causal, window, softcap, scale, q_offset,
                        s);
    case 128:
      return launch<128>(q, k, v, o, dout, lse, delta, part, dq, dk, dv, B, Hq,
                         Hkv, S, T, causal, window, softcap, scale, q_offset,
                         s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
