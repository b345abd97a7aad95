// q = clip(round(x / scale), -127, 127) -> int8 against a group-agreed
// fp32 scale: the int8 gradient wire's one remaining pass.
//
// Replaces the TPU kernel repro/kernels/fused.py::quantize_int8
// (_q_kernel).  x is one contiguous fp32 gradient bucket of any length n;
// scale is a 0-d fp32 tensor on the card, read by every thread, so the
// host never waits for it.  The pass reads 4 bytes and writes 1 per
// element and does three operations on it, so it is bound by device
// memory (5 n bytes over 3.35 TB/s).  Each thread handles groups of four
// elements with one 16-byte load and one 4-byte store, grid-striding over
// the bucket; the ragged tail (n not a multiple of 4, or a misaligned
// pointer) takes a scalar path in the same launch, so no caller pads.
//
// Bit-exact to the reference: the division is IEEE fp32 (__fdiv_rn, never a
// reciprocal multiply) and the rounding half-to-even (rintf, as
// jnp.round), both independent of the compiler's fast-math flags.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ signed char quantize(float x, float s) {
  const float r = rintf(__fdiv_rn(x, s));
  return static_cast<signed char>(fminf(fmaxf(r, -127.0f), 127.0f));
}

__global__ void __launch_bounds__(THREADS)
quantize_int8_kernel(const float* __restrict__ x,
                     const float* __restrict__ scale,
                     signed char* __restrict__ q, int64_t n, bool vec) {
  const float s = *scale;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  int64_t head = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    char4* q4 = reinterpret_cast<char4*>(q);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 v = x4[i];
      q4[i] = make_char4(quantize(v.x, s), quantize(v.y, s),
                         quantize(v.z, s), quantize(v.w, s));
    }
    head = n4 * 4;
  }
  for (int64_t i = head + tid; i < n; i += stride) q[i] = quantize(x[i], s);
}

}  // namespace

extern "C" int dmath_quantize_int8(const void* x, const void* scale, void* q,
                                   long long n, void* stream) {
  if (n <= 0) return 0;
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(q) % 4 == 0);
  // 8 blocks of 256 threads per SM (132 SMs) keep enough loads in flight;
  // each thread strides over the rest.
  const long long per_block = 4LL * THREADS;
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 132 * 8) blocks = 132 * 8;
  quantize_int8_kernel<<<static_cast<int>(blocks), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<signed char*>(q), static_cast<int64_t>(n), vec);
  return static_cast<int>(cudaGetLastError());
}
