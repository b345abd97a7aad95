// What the SSD scan's forward (ssd_scan.cu) and backward (ssd_scan_bwd.cu)
// kernels share: the chunk's decay cumsum, so that both recompute the same
// a bit for bit, and the TF32 products on mma.sync m16n8k8 (3xTF32 for
// fp32 inputs, one TF32 product for bf16).
#pragma once

#include <stdint.h>

#include "hopper.cuh"

namespace ssd {

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// a = inclusive cumsum of dt A over the chunk (steps past ``valid``: dt =
// 0) and dt itself, by one warp: two steps a lane, the lanes' pairs
// scanned in order.  Both chunk passes call it, so their a agree bitwise.
__device__ __forceinline__ void chunk_decay(const float* dt, int H, float Ah,
                                            int valid, float* a,
                                            float* dts) {
  const int lane = threadIdx.x % 32, j = 2 * lane;
  const float d0 = j < valid ? dt[(size_t)j * H] : 0.0f;
  const float d1 = j + 1 < valid ? dt[(size_t)(j + 1) * H] : 0.0f;
  const float v0 = d0 * Ah, v1 = d1 * Ah;
  float s = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += u;
  }
  float before = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) before = 0.0f;
  a[j] = before + v0;
  a[j + 1] = a[j] + v1;
  dts[j] = d0;
  dts[j + 1] = d1;
}

// fp32 -> tf32: the mantissa rounded to 10 bits, to nearest with ties away
// from zero (cvt.rna's rounding) by two integer operations, not a
// conversion instruction.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// TF32 head and tail of four (A) or two (B) fragment values: the head
// rounded, the tail the exact remainder rounded.
template <int K, bool SPLIT>
__device__ __forceinline__ void split(const float* v, uint32_t* hi,
                                      uint32_t* lo) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    hi[i] = tf32_rna(v[i]);
    if (SPLIT) lo[i] = tf32_rna(v[i] - __uint_as_float(hi[i]));
  }
}

// d += a b: 3xTF32 (small terms first) or one TF32 product.
template <bool SPLIT>
__device__ __forceinline__ void mma3(float* d, const uint32_t* ahi,
                                     const uint32_t* alo, const uint32_t* bhi,
                                     const uint32_t* blo) {
  if (SPLIT) {
    mma_tf32_1688(d, alo, bhi);
    mma_tf32_1688(d, ahi, blo);
  }
  mma_tf32_1688(d, ahi, bhi);
}

}  // namespace ssd
