// The int8 format's two kernels:
//
// quantize_int8: q = clip(round(x / scale), -127, 127) -> int8 against a
// group-agreed fp32 scale: the int8 gradient wire's one remaining pass.
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
// quantize_compress: the same format with the scale taken from the
// tensor itself, scale = fmaf(max|x|, fl32(1/127), fl32(1e-12)), as the
// reference computes absmax / 127 + 1e-12 under jit.  Replaces the TPU
// kernel repro/kernels/fused.py::quantize_compress (_qc_kernel), whose
// sequential grid (2, n_blocks) carries max|x| from phase 0 to phase 1 in
// an SMEM scalar.  Blocks here run in no order, so the phases are two
// launches on one stream: the first folds each thread's max|x| into one
// device word with atomicMax on the float's bits (zeroed by
// cudaMemsetAsync on the same stream just before; the bits of
// non-negative floats order as their values, and NaN's exceed inf's, so
// a NaN wins as in jnp.max), the second reads that word, computes the
// scale with __fmaf_rn, quantizes, and writes the scale to a 0-d device
// tensor.  It reads x twice and writes int8 once: 9 bytes per fp32
// element (5 per bf16), bound by device memory.  fp32 and bf16 inputs
// (bf16 widened on load, exactly); 16-byte loads and a ragged tail in the
// kernel, where the TPU kernel pads to 4,096.
//
// Both are bit-exact to the reference: the division is IEEE fp32
// (__fdiv_rn, never a reciprocal multiply) and the rounding half-to-even
// (rintf, as jnp.round), both independent of the compiler's fast-math
// flags.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// eight int8 in one 8-byte store
struct __align__(8) char2x4 {
  char4 lo, hi;
};

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

// Up to 8 elements of one 16-byte load, widened to fp32: four fp32 or
// eight bf16 (a bf16 is the top half of the fp32 with the same value).
template <bool BF16>
struct Pack {
  static constexpr int N = BF16 ? 8 : 4;
  __device__ __forceinline__ static void unpack(uint4 raw, float* f) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (BF16) {
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      } else {
        f[i] = __uint_as_float(w[i]);
      }
    }
  }
  __device__ __forceinline__ static float at(const void* x, int64_t i) {
    if constexpr (BF16) {
      const unsigned short h = static_cast<const unsigned short*>(x)[i];
      return __uint_as_float(static_cast<unsigned>(h) << 16);
    }
    return static_cast<const float*>(x)[i];
  }
};

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(fabsf(v));
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
absmax_kernel(const void* __restrict__ x, unsigned* __restrict__ amax,
              int64_t n, bool vec) {
  using P = Pack<BF16>;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  unsigned m = 0;
  int64_t head = 0;
  if (vec) {
    const int64_t nv = n / P::N;
    const uint4* xv = static_cast<const uint4*>(x);
    for (int64_t i = tid; i < nv; i += stride) {
      float f[P::N];
      P::unpack(xv[i], f);
#pragma unroll
      for (int e = 0; e < P::N; ++e) m = max(m, abs_bits(f[e]));
    }
    head = nv * P::N;
  }
  for (int64_t i = head + tid; i < n; i += stride)
    m = max(m, abs_bits(P::at(x, i)));
  // one atomic per block: the warp's max, then the block's
  __shared__ unsigned warp_max[THREADS / 32];
  m = __reduce_max_sync(0xffffffffu, m);
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < THREADS / 32 ? warp_max[threadIdx.x] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (threadIdx.x == 0) atomicMax(amax, m);
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
compress_kernel(const void* __restrict__ x, const unsigned* __restrict__ amax,
                signed char* __restrict__ q, float* __restrict__ scale,
                int64_t n, bool vec) {
  using P = Pack<BF16>;
  // fl32(1/127) and fl32(1e-12), the constants of XLA's fused scale
  const float s = __fmaf_rn(__uint_as_float(*amax), 0x1.020408p-7f,
                            0x1.197998p-40f);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale = s;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  int64_t head = 0;
  if (vec) {
    const int64_t nv = n / P::N;
    const uint4* xv = static_cast<const uint4*>(x);
    for (int64_t i = tid; i < nv; i += stride) {
      float f[P::N];
      P::unpack(xv[i], f);
      const char4 lo = make_char4(quantize(f[0], s), quantize(f[1], s),
                                  quantize(f[2], s), quantize(f[3], s));
      if constexpr (BF16) {
        const char4 hi = make_char4(quantize(f[4], s), quantize(f[5], s),
                                    quantize(f[6], s), quantize(f[7], s));
        reinterpret_cast<char2x4*>(q)[i] = char2x4{lo, hi};
      } else {
        reinterpret_cast<char4*>(q)[i] = lo;
      }
    }
    head = nv * P::N;
  }
  for (int64_t i = head + tid; i < n; i += stride)
    q[i] = quantize(P::at(x, i), s);
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

extern "C" int dmath_quantize_compress(const void* x, int bf16, void* amax,
                                       void* q, void* scale, long long n,
                                       void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_load = bf16 ? 8 : 4;
  // a 16-byte load per thread needs x on a 16-byte boundary, the store of
  // its 4 or 8 int8 q on a 4- or 8-byte one
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(q) % per_load == 0);
  const long long per_block = static_cast<long long>(per_load) * THREADS;
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 132 * 8) blocks = 132 * 8;
  const int grid = static_cast<int>(blocks);
  unsigned* amax_bits = static_cast<unsigned*>(amax);
  cudaError_t err = cudaMemsetAsync(amax_bits, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  signed char* qp = static_cast<signed char*>(q);
  float* sp = static_cast<float*>(scale);
  const int64_t len = static_cast<int64_t>(n);
  if (bf16) {
    absmax_kernel<true><<<grid, THREADS, 0, st>>>(x, amax_bits, len, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    compress_kernel<true><<<grid, THREADS, 0, st>>>(x, amax_bits, qp, sp,
                                                     len, vec);
  } else {
    absmax_kernel<false><<<grid, THREADS, 0, st>>>(x, amax_bits, len, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    compress_kernel<false><<<grid, THREADS, 0, st>>>(x, amax_bits, qp, sp,
                                                      len, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
