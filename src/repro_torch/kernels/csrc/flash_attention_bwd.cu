// Backward of flash attention: dQ, dK, dV from the forward's per-row
// log-sum-exp, with GQA, causal masking, a sliding window, a tanh logit
// softcap and a query offset as runtime arguments.
//
// The TPU reference has no backward kernel (its model trains through
// layers.flash_attention_jnp); this is the port's own, the backward of
// csrc/flash_attention.cu.  q/dq (B,Hq,S,D), k/v/dk/dv (B,Hkv,T,D), o/do
// (B,Hq,S,D), all bf16 and contiguous; lse and delta (B,Hq,S) fp32.
// Four launches, none with atomics, so the result is deterministic:
//
// 1. delta[row] = sum_d dO[row,d] * O[row,d], one warp per query row.
// 2. dK/dV: one block per (batch, query head, 32-key tile).  It keeps its
//    keys' dK and dV in fp32 registers and walks the 64-query tiles of
//    its head that can see its keys, recomputing P = exp(s - lse) and
//    dS = P (dP - delta) for the tile: dV += P^T dO, dK += dS^T Q.  Each
//    query head writes its share to an fp32 scratch (B,Hq,T,D) per
//    output, so a kv head's g query heads run in parallel blocks.
// 3. GQA's sum: dK, dV of kv head hk = the shares of its g query heads,
//    added in head order by an elementwise pass (no atomics).
// 4. dQ: one block per (batch, query head, 32-query tile), walking the key
//    tiles in its causal/window horizon: dQ += dS K.
//
// s = scale q.k, capped as softcap tanh(s / softcap) when a softcap is
// given, whose derivative 1 - tanh^2 multiplies dS.  A row with no visible
// key (lse = -inf) has P = 0 at every key, so its gradients are zero, as
// the reference model's attention gives; no exp of -inf - -inf is formed.
// The math is fp32 on CUDA cores from shared memory, as in the forward:
// about 2.5x the forward's FLOPs plus the recomputed scores and dP of the
// second pass, so it is bound by the FP32 rate of a small grid, not by its
// bytes; tensor-core products are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;
constexpr int TPR = 4;                 // lanes per owned row
constexpr int DQ_BQ = THREADS / TPR;   // dQ: 32 query rows per block
constexpr int DQ_BKV = 64;             //     64-key tiles
constexpr int KV_BK = THREADS / TPR;   // dK/dV: 32 keys per block
constexpr int KV_BQ = 64;              //     64-query tiles

__device__ __forceinline__ bool visible(int j, int qpos, int T, int causal,
                                        int window) {
  bool ok = j < T;
  if (causal) ok = ok && (j <= qpos);
  if (window > 0) ok = ok && (j > qpos - window);
  return ok;
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

template <int D>
constexpr size_t dq_smem() {
  // Qs, dOs (BQ x D+1) + Ks, Vs (BKV x D+1) + dSs (BQ x BKV+1), fp32
  return sizeof(float) * (2 * DQ_BQ * (D + 1) + 2 * DQ_BKV * (D + 1) +
                          DQ_BQ * (DQ_BKV + 1));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int Hq, int Hkv, int S, int T, int causal, int window,
                   float softcap, float scale, int q_offset) {
  constexpr int DP = D + 1;
  constexpr int PP = DQ_BKV + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + DQ_BQ * DP;
  float* Ks = dOs + DQ_BQ * DP;
  float* Vs = Ks + DQ_BKV * DP;
  float* dSs = Vs + DQ_BKV * DP;

  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int hk = (bh % Hq) / (Hq / Hkv);
  const int q0 = blockIdx.x * DQ_BQ;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int sub = tid % TPR;

  const bf16* qb = q + (size_t)bh * S * D;
  const bf16* dob = dout + (size_t)bh * S * D;
  const bf16* kb = k + (size_t)(b * Hkv + hk) * T * D;
  const bf16* vb = v + (size_t)(b * Hkv + hk) * T * D;

  for (int idx = tid; idx < DQ_BQ * D; idx += THREADS) {
    const int rr = idx / D;
    const int d = idx % D;
    const int qi = q0 + rr;
    const bool in = qi < S;
    Qs[rr * DP + d] =
        in ? __bfloat162float(qb[(size_t)qi * D + d]) * scale : 0.0f;
    dOs[rr * DP + d] = in ? __bfloat162float(dob[(size_t)qi * D + d]) : 0.0f;
  }
  const int qi = q0 + r;
  const int qpos = q_offset + qi;
  const float row_lse = qi < S ? lse[(size_t)bh * S + qi] : 0.0f;
  const float row_delta = qi < S ? delta[(size_t)bh * S + qi] : 0.0f;

  const int q_last = min(S, q0 + DQ_BQ) - 1;
  int kv_end = T;
  if (causal) kv_end = min(T, q_offset + q_last + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q_offset + q0 - window + 1);
  kv_begin = (kv_begin / DQ_BKV) * DQ_BKV;

  float acc[D / TPR];
#pragma unroll
  for (int e = 0; e < D / TPR; ++e) acc[e] = 0.0f;

  for (int j0 = kv_begin; j0 < kv_end; j0 += DQ_BKV) {
    __syncthreads();           // Qs/dOs written / last tile's readers done
    for (int idx = tid; idx < DQ_BKV * D; idx += THREADS) {
      const int jj = idx / D;
      const int d = idx % D;
      const int j = j0 + jj;
      float kx = 0.0f, vx = 0.0f;
      if (j < T) {
        kx = __bfloat162float(kb[(size_t)j * D + d]);
        vx = __bfloat162float(vb[(size_t)j * D + d]);
      }
      Ks[jj * DP + d] = kx;
      Vs[jj * DP + d] = vx;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < DQ_BKV / TPR; ++c) {
      const int jj = c * TPR + sub;
      const int j = j0 + jj;
      float s = 0.0f, dp = 0.0f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s += Qs[r * DP + d] * Ks[jj * DP + d];
        dp += dOs[r * DP + d] * Vs[jj * DP + d];
      }
      float dcap = 1.0f;
      if (softcap > 0.0f) {
        const float t = tanhf(s / softcap);
        s = softcap * t;
        dcap = 1.0f - t * t;
      }
      const bool ok = (qi < S) && visible(j, qpos, T, causal, window);
      const float p = ok ? expf(s - row_lse) : 0.0f;
      dSs[r * PP + jj] = p * (dp - row_delta) * dcap;
    }
    __syncwarp();              // the row's dS entries come from its 4 lanes

#pragma unroll
    for (int e = 0; e < D / TPR; ++e) {
      const int d = e * TPR + sub;
      float a = acc[e];
#pragma unroll 16
      for (int jj = 0; jj < DQ_BKV; ++jj)
        a += dSs[r * PP + jj] * Ks[jj * DP + d];
      acc[e] = a;
    }
  }

  if (qi < S) {
    bf16* out = dq + ((size_t)bh * S + qi) * D;
#pragma unroll
    for (int e = 0; e < D / TPR; ++e)
      out[e * TPR + sub] = __float2bfloat16(acc[e] * scale);
  }
}

template <int D>
constexpr size_t dkdv_smem() {
  // Ks, Vs (BK x D+1) + Qs, dOs (BQ x D+1) + Ps, dSs (BK x BQ+1)
  // + lse, delta (BQ), fp32
  return sizeof(float) * (2 * KV_BK * (D + 1) + 2 * KV_BQ * (D + 1) +
                          2 * KV_BK * (KV_BQ + 1) + 2 * KV_BQ);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ part_k, float* __restrict__ part_v,
                     int Hq, int Hkv, int S, int T, int causal, int window,
                     float softcap, float scale, int q_offset) {
  constexpr int DP = D + 1;
  constexpr int PP = KV_BQ + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + KV_BK * DP;
  float* Qs = Vs + KV_BK * DP;
  float* dOs = Qs + KV_BQ * DP;
  float* Ps = dOs + KV_BQ * DP;
  float* dSs = Ps + KV_BK * PP;
  float* lse_s = dSs + KV_BK * PP;
  float* delta_s = lse_s + KV_BQ;

  const int bh = blockIdx.y;                  // b * Hq + h
  const int b = bh / Hq;
  const int bkv = b * Hkv + (bh % Hq) / (Hq / Hkv);
  const int j0 = blockIdx.x * KV_BK;
  const int tid = threadIdx.x;
  const int kr = tid / TPR;
  const int sub = tid % TPR;
  const int j = j0 + kr;

  const bf16* kb = k + (size_t)bkv * T * D;
  const bf16* vb = v + (size_t)bkv * T * D;
  for (int idx = tid; idx < KV_BK * D; idx += THREADS) {
    const int jj = idx / D;
    const int d = idx % D;
    const bool in = j0 + jj < T;
    Ks[jj * DP + d] = in ? __bfloat162float(kb[(size_t)(j0 + jj) * D + d])
                         : 0.0f;
    Vs[jj * DP + d] = in ? __bfloat162float(vb[(size_t)(j0 + jj) * D + d])
                         : 0.0f;
  }

  // The query rows that can see a key of this tile: causal needs
  // qpos >= j0, a window qpos < j_last + window.
  const int j_last = min(T, j0 + KV_BK) - 1;
  int qi_begin = causal ? max(0, j0 - q_offset) : 0;
  qi_begin = (qi_begin / KV_BQ) * KV_BQ;
  int qi_end = S;
  if (window > 0) qi_end = max(0, min(S, j_last + window - q_offset));

  float acc_k[D / TPR], acc_v[D / TPR];
#pragma unroll
  for (int e = 0; e < D / TPR; ++e) acc_k[e] = acc_v[e] = 0.0f;

  const bf16* qb = q + (size_t)bh * S * D;
  const bf16* dob = dout + (size_t)bh * S * D;
  for (int i0 = qi_begin; i0 < qi_end; i0 += KV_BQ) {
    __syncthreads();         // K/V written / last tile's readers done
    for (int idx = tid; idx < KV_BQ * D; idx += THREADS) {
      const int ii = idx / D;
      const int d = idx % D;
      const int qi = i0 + ii;
      const bool in = qi < S;
      Qs[ii * DP + d] =
          in ? __bfloat162float(qb[(size_t)qi * D + d]) * scale : 0.0f;
      dOs[ii * DP + d] =
          in ? __bfloat162float(dob[(size_t)qi * D + d]) : 0.0f;
    }
    for (int ii = tid; ii < KV_BQ; ii += THREADS) {
      const int qi = i0 + ii;
      lse_s[ii] = qi < S ? lse[(size_t)bh * S + qi] : 0.0f;
      delta_s[ii] = qi < S ? delta[(size_t)bh * S + qi] : 0.0f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < KV_BQ / TPR; ++c) {
      const int ii = c * TPR + sub;
      const int qi = i0 + ii;
      float s = 0.0f, dp = 0.0f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s += Qs[ii * DP + d] * Ks[kr * DP + d];
        dp += dOs[ii * DP + d] * Vs[kr * DP + d];
      }
      float dcap = 1.0f;
      if (softcap > 0.0f) {
        const float t = tanhf(s / softcap);
        s = softcap * t;
        dcap = 1.0f - t * t;
      }
      const bool ok =
          (qi < S) && visible(j, q_offset + qi, T, causal, window);
      const float p = ok ? expf(s - lse_s[ii]) : 0.0f;
      Ps[kr * PP + ii] = p;
      dSs[kr * PP + ii] = p * (dp - delta_s[ii]) * dcap;
    }
    __syncwarp();            // the key's P/dS entries come from 4 lanes

#pragma unroll
    for (int e = 0; e < D / TPR; ++e) {
      const int d = e * TPR + sub;
      float ak = acc_k[e], av = acc_v[e];
#pragma unroll 16
      for (int ii = 0; ii < KV_BQ; ++ii) {
        av += Ps[kr * PP + ii] * dOs[ii * DP + d];
        ak += dSs[kr * PP + ii] * Qs[ii * DP + d];
      }
      acc_k[e] = ak;
      acc_v[e] = av;
    }
  }

  if (j < T) {
    float* pk = part_k + ((size_t)bh * T + j) * D;
    float* pv = part_v + ((size_t)bh * T + j) * D;
#pragma unroll
    for (int e = 0; e < D / TPR; ++e) {
      pk[e * TPR + sub] = acc_k[e];
      pv[e * TPR + sub] = acc_v[e];
    }
  }
}

// dK, dV (B,Hkv,T,D) bf16 = the sum over each kv head's g query heads of
// their fp32 shares (B,Hq,T,D), in head order.
__global__ void attn_bwd_gqa_sum_kernel(const float* __restrict__ part_k,
                                        const float* __restrict__ part_v,
                                        bf16* __restrict__ dk,
                                        bf16* __restrict__ dv, int Hq,
                                        int Hkv, size_t per_head,
                                        size_t n) {
  const int g = Hq / Hkv;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t bkv = i / per_head;
    const size_t rest = i % per_head;
    const size_t h0 = (bkv / Hkv) * Hq + (bkv % Hkv) * g;
    float sk = 0.0f, sv = 0.0f;
    for (int hh = 0; hh < g; ++hh) {
      sk += part_k[(h0 + hh) * per_head + rest];
      sv += part_v[(h0 + hh) * per_head + rest];
    }
    dk[i] = __float2bfloat16(sk);
    dv[i] = __float2bfloat16(sv);
  }
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

  constexpr size_t kv_bytes = dkdv_smem<D>();
  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t per_head = (size_t)T * D;
  float* part_k = static_cast<float*>(part);
  float* part_v = part_k + (size_t)B * Hq * per_head;
  attn_bwd_dkdv_kernel<D><<<dim3((T + KV_BK - 1) / KV_BK, B * Hq), THREADS,
                            kv_bytes, s>>>(
      Q, K, V, dO, L, Dl, part_k, part_v, Hq, Hkv, S, T, causal, window,
      softcap, scale, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = (size_t)B * Hkv * per_head;
  const int sum_blocks = static_cast<int>(
      n / 256 + 1 < 132 * 16 ? n / 256 + 1 : 132 * 16);
  attn_bwd_gqa_sum_kernel<<<sum_blocks, 256, 0, s>>>(
      part_k, part_v, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Hq, Hkv,
      per_head, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t q_bytes = dq_smem<D>();
  err = cudaFuncSetAttribute(attn_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_kernel<D><<<dim3((S + DQ_BQ - 1) / DQ_BQ, B * Hq), THREADS,
                          q_bytes, s>>>(
      Q, K, V, dO, L, Dl, static_cast<bf16*>(dq), Hq, Hkv, S, T, causal,
      window, softcap, scale, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// window <= 0 means no sliding window; softcap <= 0 means no softcap.
// The caller allocates the fp32 scratch: delta (B,Hq,S) and part, the
// query heads' dK and dV shares, 2 x (B,Hq,T,D).
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
