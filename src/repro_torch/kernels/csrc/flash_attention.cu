// Online-softmax (flash) attention: GQA, causal, sliding window, logit
// softcap and a query offset, all as runtime arguments.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::attention
// (_attn_kernel).  q (B,Hq,S,D), k/v (B,Hkv,T,D), out (B,Hq,S,D), all bf16
// and contiguous.  One block per (batch, query head, 32-query tile); query
// head h reads kv head h / (Hq/Hkv) straight from the index, so K/V are
// never repeated.  K/V stream through shared memory in 64-key tiles; each
// query row is owned by 4 neighbouring lanes that split the tile's keys
// for the scores and the head dimension for P@V, with the running max,
// denominator and accumulator kept in fp32 registers.  Key tiles wholly
// outside the causal/window horizon of the query tile are skipped.  A row
// with no visible key writes zeros.  When the caller asks for it (training),
// each row's log-sum-exp of its scaled, capped scores is written too, fp32
// (B,Hq,S), -inf on a row with no visible key: the backward kernel
// (flash_attention_bwd.cu) recomputes the probabilities from it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 32;
constexpr int BKV = 64;
constexpr int THREADS = 128;
constexpr int TPR = THREADS / BQ;   // lanes per query row

template <int D>
constexpr size_t smem_bytes() {
  // Qs (BQ x D+1) + Ks (BKV x D+1) + Vs (BKV x D) + Ps (BQ x BKV+1), fp32
  return sizeof(float) *
         (BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       float* __restrict__ lse, int Hq, int Hkv, int S,
                       int T, int causal, int window, float softcap,
                       float scale, int q_offset) {
  constexpr int DP = D + 1;
  constexpr int PP = BKV + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BKV * DP;
  float* Ps = Vs + BKV * D;

  const int bh = blockIdx.y;                 // b * Hq + h
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int sub = tid % TPR;

  const bf16* qb = q + (size_t)bh * S * D;
  const bf16* kb = k + (size_t)(b * Hkv + hk) * T * D;
  const bf16* vb = v + (size_t)(b * Hkv + hk) * T * D;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int rr = idx / D;
    const int d = idx % D;
    const int qi = q0 + rr;
    Qs[rr * DP + d] =
        qi < S ? __bfloat162float(qb[(size_t)qi * D + d]) * scale : 0.0f;
  }

  const int qi = q0 + r;
  const int qpos = q_offset + qi;
  const int q_last = min(S, q0 + BQ) - 1;
  int kv_end = T;
  if (causal) kv_end = min(T, q_offset + q_last + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q_offset + q0 - window + 1);
  kv_begin = (kv_begin / BKV) * BKV;

  float m = -INFINITY;
  float l = 0.0f;
  float acc[D / TPR];
#pragma unroll
  for (int e = 0; e < D / TPR; ++e) acc[e] = 0.0f;

  for (int j0 = kv_begin; j0 < kv_end; j0 += BKV) {
    __syncthreads();            // Qs written / last tile's readers done
    for (int idx = tid; idx < BKV * D; idx += THREADS) {
      const int jj = idx / D;
      const int d = idx % D;
      const int j = j0 + jj;
      float kx = 0.0f, vx = 0.0f;
      if (j < T) {
        kx = __bfloat162float(kb[(size_t)j * D + d]);
        vx = __bfloat162float(vb[(size_t)j * D + d]);
      }
      Ks[jj * DP + d] = kx;
      Vs[jj * D + d] = vx;
    }
    __syncthreads();

    // Scores for keys jj = c * TPR + sub (lanes of a row on adjacent keys).
    float s[BKV / TPR];
    float tmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < BKV / TPR; ++c) {
      const int jj = c * TPR + sub;
      const int j = j0 + jj;
      float dot = 0.0f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += Qs[r * DP + d] * Ks[jj * DP + d];
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
    for (int c = 0; c < BKV / TPR; ++c) {
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
    for (int e = 0; e < D / TPR; ++e) {
      const int d = e * TPR + sub;
      float a = acc[e] * alpha;
#pragma unroll 16
      for (int jj = 0; jj < BKV; ++jj) a += Ps[r * PP + jj] * Vs[jj * D + d];
      acc[e] = a;
    }
  }

  if (qi < S) {
    const float inv = l > 0.0f ? 1.0f / l : 0.0f;
    bf16* ob = o + ((size_t)bh * S + qi) * D;
#pragma unroll
    for (int e = 0; e < D / TPR; ++e)
      ob[e * TPR + sub] = __float2bfloat16(acc[e] * inv);
    if (lse != nullptr && sub == 0)
      lse[(size_t)bh * S + qi] = l > 0.0f ? m + logf(l) : -INFINITY;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Hq, int Hkv, int S, int T, int causal, int window,
           float softcap, float scale, int q_offset, cudaStream_t s) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, B * Hq);
  flash_attention_kernel<D><<<grid, THREADS, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), Hq, Hkv, S, T,
      causal, window, softcap, scale, q_offset);
  return static_cast<int>(cudaGetLastError());
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, o, lse, B, Hq, Hkv, S, T, causal, window,
                        softcap, scale, q_offset, s);
    case 64:
      return launch<64>(q, k, v, o, lse, B, Hq, Hkv, S, T, causal, window,
                        softcap, scale, q_offset, s);
    case 128:
      return launch<128>(q, k, v, o, lse, B, Hq, Hkv, S, T, causal, window,
                         softcap, scale, q_offset, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
