// Paged decode attention: one query token per sequence against a paged KV
// pool, masking positions at or past seq_lens[b].
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_decode_attention (_paged_decode_kernel).  q (B,Hq,hd), pages
// (P,page,Hkv,hd) bf16, block_table (B,n_pages) int32, seq_lens (B,) int32,
// out (B,Hq,hd) bf16.  One block per (sequence, kv head); the g = Hq/Hkv
// query heads that share the kv head are rows of the block.  The block
// reads its own table row and walks only the live positions
// [0, seq_lens[b]) in 64-key tiles, resolving each key's physical page
// through the table, so pages past the sequence's end are never read (the
// TPU kernel streams them and masks them to exact zeros: same result).
// Online softmax in fp32 across tiles.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 64;          // key positions per tile
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAXG = 16;        // query heads per kv head
constexpr int RG = THREADS / NT;   // row groups for scores and P@V

template <int HD>
constexpr size_t smem_bytes() {
  // Qs (MAXG x HD) + Ks (NT x HD+1) + Vs (NT x HD) + Ps (MAXG x NT+1)
  // + alpha (MAXG) + l (MAXG), fp32; + the tile's physical pages, int
  return sizeof(float) * (MAXG * HD + NT * (HD + 1) + NT * HD +
                          MAXG * (NT + 1) + 2 * MAXG) +
         sizeof(int) * NT;
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                    const bf16* __restrict__ vp,
                    const int* __restrict__ table,
                    const int* __restrict__ lens, bf16* __restrict__ o,
                    int Hq, int Hkv, int page, int n_pages, float scale) {
  constexpr int HDP = HD + 1;
  constexpr int PP = NT + 1;
  constexpr int DCOLS = (HD + NT - 1) / NT;     // head-dim columns a thread owns
  constexpr int ROWS = MAXG / RG;               // query rows a thread owns
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + MAXG * HD;
  float* Vs = Ks + NT * HDP;
  float* Ps = Vs + NT * HD;
  float* alpha_s = Ps + MAXG * PP;
  float* l_s = alpha_s + MAXG;
  int* phys_s = reinterpret_cast<int*>(l_s + MAXG);

  const int b = blockIdx.x;
  const int hk = blockIdx.y;
  const int g = Hq / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int col = tid % NT;       // key position (scores) / head-dim column
  const int rg = tid / NT;        // row group
  const int n = min(lens[b], n_pages * page);

  const bf16* qb = q + ((size_t)b * Hq + (size_t)hk * g) * HD;
  for (int idx = tid; idx < g * HD; idx += THREADS)
    Qs[idx] = __bfloat162float(qb[idx]) * scale;

  float m_r[MAXG / WARPS];
  float l_r[MAXG / WARPS];
#pragma unroll
  for (int i = 0; i < MAXG / WARPS; ++i) {
    m_r[i] = -INFINITY;
    l_r[i] = 0.0f;
  }
  float acc[ROWS][DCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < DCOLS; ++c) acc[i][c] = 0.0f;

  for (int p0 = 0; p0 < n; p0 += NT) {
    __syncthreads();            // Qs written / last tile's readers done
    if (tid < NT) {
      const int p = p0 + tid;
      phys_s[tid] = p < n ? table[(size_t)b * n_pages + p / page] : -1;
    }
    __syncthreads();
    for (int idx = tid; idx < NT * HD; idx += THREADS) {
      const int jj = idx / HD;
      const int d = idx % HD;
      const int ph = phys_s[jj];
      float kx = 0.0f, vx = 0.0f;
      if (ph >= 0) {
        const size_t off =
            (((size_t)ph * page + (p0 + jj) % page) * Hkv + hk) * HD + d;
        kx = __bfloat162float(kp[off]);
        vx = __bfloat162float(vp[off]);
      }
      Ks[jj * HDP + d] = kx;
      Vs[jj * HD + d] = vx;
    }
    __syncthreads();

    // Scores: thread (rg, col) scores key col for rows rg, rg + RG, ...
    {
      const bool live = phys_s[col] >= 0;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int r = rg + i * RG;
        if (r < g) {
          float dot = 0.0f;
#pragma unroll 16
          for (int d = 0; d < HD; ++d) dot += Qs[r * HD + d] * Ks[col * HDP + d];
          Ps[r * PP + col] = live ? dot : -INFINITY;
        }
      }
    }
    __syncthreads();

    // Softmax: warp w updates rows w, w + WARPS, ...; a lane holds 2 keys.
#pragma unroll
    for (int i = 0; i < MAXG / WARPS; ++i) {
      const int r = warp + i * WARPS;
      if (r < g) {
        const float s0 = Ps[r * PP + lane];
        const float s1 = Ps[r * PP + lane + 32];
        float tmax = fmaxf(s0, s1);
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
        const float m_new = fmaxf(m_r[i], tmax);
        const float m_use = (m_new == -INFINITY) ? 0.0f : m_new;
        const float a = expf(m_r[i] - m_use);
        const float e0 = (s0 == -INFINITY) ? 0.0f : expf(s0 - m_use);
        const float e1 = (s1 == -INFINITY) ? 0.0f : expf(s1 - m_use);
        Ps[r * PP + lane] = e0;
        Ps[r * PP + lane + 32] = e1;
        float psum = e0 + e1;
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        l_r[i] = l_r[i] * a + psum;
        m_r[i] = m_new;
        if (lane == 0) alpha_s[r] = a;
      }
    }
    __syncthreads();

    // P@V: thread (rg, col) owns head-dim columns col, col + NT, ...
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = rg + i * RG;
      if (r < g) {
        const float a = alpha_s[r];
#pragma unroll
        for (int c = 0; c < DCOLS; ++c) {
          const int d = col + c * NT;
          if (d < HD) {
            float x = acc[i][c] * a;
#pragma unroll 16
            for (int jj = 0; jj < NT; ++jj) x += Ps[r * PP + jj] * Vs[jj * HD + d];
            acc[i][c] = x;
          }
        }
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < MAXG / WARPS; ++i) {
      const int r = warp + i * WARPS;
      if (r < g) l_s[r] = l_r[i];
    }
  }
  __syncthreads();
  bf16* ob = o + ((size_t)b * Hq + (size_t)hk * g) * HD;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = rg + i * RG;
    if (r < g) {
      const float inv = l_s[r] > 0.0f ? 1.0f / l_s[r] : 0.0f;
#pragma unroll
      for (int c = 0; c < DCOLS; ++c) {
        const int d = col + c * NT;
        if (d < HD) ob[r * HD + d] = __float2bfloat16(acc[i][c] * inv);
      }
    }
  }
}

template <int HD>
int launch(const void* q, const void* kp, const void* vp, const void* table,
           const void* lens, void* o, int B, int Hq, int Hkv, int page,
           int n_pages, float scale, cudaStream_t s) {
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, Hkv);
  paged_decode_kernel<HD><<<grid, THREADS, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(lens), static_cast<bf16*>(o), Hq, Hkv, page,
      n_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dmath_paged_decode_bf16(const void* q, const void* kp,
                                       const void* vp, const void* table,
                                       const void* lens, void* o, int B,
                                       int Hq, int Hkv, int hd, int page,
                                       int n_pages, float scale,
                                       void* stream) {
  if (Hq % Hkv != 0 || Hq / Hkv > MAXG)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(q, kp, vp, table, lens, o, B, Hq, Hkv, page, n_pages,
                        scale, s);
    case 64:
      return launch<64>(q, kp, vp, table, lens, o, B, Hq, Hkv, page, n_pages,
                        scale, s);
    case 128:
      return launch<128>(q, kp, vp, table, lens, o, B, Hq, Hkv, page, n_pages,
                         scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
