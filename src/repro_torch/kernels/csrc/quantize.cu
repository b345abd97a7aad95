// The int8 format's kernels:
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
// tensor itself, scale = fmaf(max|v|, fl32(1/127), fl32(1e-12)), as the
// reference computes absmax / 127 + 1e-12 under jit.  Replaces the TPU
// kernel repro/kernels/fused.py::quantize_compress (_qc_kernel), whose
// sequential grid (2, n_blocks) carries max|x| from phase 0 to phase 1 in
// an SMEM scalar.  One templated pair of passes serves two forms:
//
// - plain: v = x (fp32 or bf16, widened exactly) -> (q int8, scale);
// - error feedback (EF), the compressed SGD step's whole quantizer,
//   v = g + err (bf16 or fp32 g, fp32 err, __fadd_rn as torch's
//   g.float() + err) -> (deq = q * s, new_err = fma(-q, s, v), scale),
//   the reference's jitted fusion (train/compression.py): q never
//   reaches device memory, and the residual rounds once.
//
// Blocks run in no order, so the phases are two launches.  Pass 1 folds
// max|v| per block (the bits of non-negative floats order as their
// values, and NaN's exceed inf's, so a NaN wins as in jnp.max) and writes
// each block's maximum to its own word of a scratch array: nothing needs
// zeroing first.  Pass 2 is a programmatic dependent launch (its blocks
// are scheduled while pass 1's last blocks run); after
// griddepcontrol.wait every block folds the scratch's maxima (a max, so
// the order does not matter), computes the scale with __fmaf_rn and
// quantizes; block 0 writes the scale to a 0-d device tensor.  Pass 2
// walks the input from its end, so the lines pass 1 read last (up to the
// 50 MB L2) are read again from the cache.
//
// What bounds it: device memory.  Per element the plain form reads x
// twice and writes int8 (9 bytes for fp32 x, 5 for bf16); the EF form
// reads g and err twice and writes deq and new_err (20 bytes for bf16 g,
// 24 for fp32).  Each thread keeps four vectors of 4 elements in flight
// per iteration (for EF: four loads of g and four 16-byte loads of err),
// neighbouring threads on neighbouring vectors, so every access of a warp
// is one contiguous span; the EF form's pass 2 reads and writes
// evict-first (the last use of its input; its outputs are not read again
// in this call).  The
// grid is one wave of as many 256-thread blocks as the SMs hold.
//
// All are bit-exact to the reference: the division is IEEE fp32
// (__fdiv_rn, never a reciprocal multiply), the rounding half-to-even
// (rintf, as jnp.round), the products and adds explicitly rounded
// intrinsics, all independent of the compiler's fast-math flags.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;       // elements per vector access
constexpr int UNROLL = 4;    // vectors a thread loads before it uses them

// fl32(1/127) and fl32(1e-12), the constants of XLA's fused scale
constexpr float INV127 = 0x1.020408p-7f;
constexpr float EPS = 0x1.197998p-40f;

__device__ __forceinline__ float clip_round(float v, float s) {
  return fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.0f), 127.0f);
}

// q as the reference holds it, an int8 widened to fp32: a -0.0 from
// rintf becomes +0.0, so deq = q * s is +0.0 there too
__device__ __forceinline__ float int8_value(float v, float s) {
  const float r = clip_round(v, s);
  return r == 0.0f ? 0.0f : r;
}

__device__ __forceinline__ signed char quantize(float x, float s) {
  return static_cast<signed char>(clip_round(x, s));
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

// ---- quantize_compress: the two passes --------------------------------------

// The input of either form: x (fp32 if !BF16, else bf16) and, for EF, the
// fp32 error state.  ``vec`` reads the 4 values of vector c widened to
// fp32 (a 16-byte load of fp32 x or an 8-byte one of bf16 x, a 16-byte
// one of err; neighbouring threads read neighbouring vectors); ``at`` one
// value.  LAST: the error-feedback form's last read of its input (pass
// 2), evict-first.
template <bool BF16, bool EF>
struct Input {
  const void* x;
  const float* err;

  template <bool LAST>
  __device__ __forceinline__ void vec(int64_t c, float* v) const {
    if constexpr (BF16) {
      const uint2* p = reinterpret_cast<const uint2*>(x) + c;
      const uint2 r = LAST && EF ? __ldcs(p) : *p;
      // a bf16 is the top half of the fp32 of the same value
      v[0] = __uint_as_float(r.x << 16);
      v[1] = __uint_as_float(r.x & 0xffff0000u);
      v[2] = __uint_as_float(r.y << 16);
      v[3] = __uint_as_float(r.y & 0xffff0000u);
    } else {
      const float4* p = reinterpret_cast<const float4*>(x) + c;
      const float4 a = LAST && EF ? __ldcs(p) : *p;
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    }
    if constexpr (EF) {
      const float4* p = reinterpret_cast<const float4*>(err) + c;
      const float4 e = LAST ? __ldcs(p) : *p;
      v[0] = __fadd_rn(v[0], e.x);
      v[1] = __fadd_rn(v[1], e.y);
      v[2] = __fadd_rn(v[2], e.z);
      v[3] = __fadd_rn(v[3], e.w);
    }
  }

  __device__ __forceinline__ float at(int64_t i) const {
    float v;
    if constexpr (BF16) {
      const unsigned short h = static_cast<const unsigned short*>(x)[i];
      v = __uint_as_float(static_cast<unsigned>(h) << 16);
    } else {
      v = static_cast<const float*>(x)[i];
    }
    if constexpr (EF) v = __fadd_rn(v, err[i]);
    return v;
  }
};

// The outputs: q (plain) or deq and new_err (EF, stored evict-first).
template <bool EF>
struct Output {
  signed char* q;
  float* deq;
  float* new_err;

  __device__ __forceinline__ void vec(int64_t c, const float* v,
                                      float s) const {
    if constexpr (EF) {
      float d[VEC], r[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float qf = int8_value(v[i], s);
        d[i] = __fmul_rn(qf, s);
        r[i] = __fmaf_rn(-qf, s, v[i]);
      }
      __stcs(reinterpret_cast<float4*>(deq) + c,
             make_float4(d[0], d[1], d[2], d[3]));
      __stcs(reinterpret_cast<float4*>(new_err) + c,
             make_float4(r[0], r[1], r[2], r[3]));
    } else {
      reinterpret_cast<char4*>(q)[c] =
          make_char4(quantize(v[0], s), quantize(v[1], s),
                     quantize(v[2], s), quantize(v[3], s));
    }
  }

  __device__ __forceinline__ void at(int64_t i, float v, float s) const {
    if constexpr (EF) {
      const float qf = int8_value(v, s);
      deq[i] = __fmul_rn(qf, s);
      new_err[i] = __fmaf_rn(-qf, s, v);
    } else {
      q[i] = quantize(v, s);
    }
  }
};

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(fabsf(v));
}

// The block's maximum of ``m``, returned to every thread.
__device__ __forceinline__ unsigned block_max(unsigned m) {
  __shared__ unsigned warp_max[THREADS / 32];
  m = __reduce_max_sync(0xffffffffu, m);
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  m = threadIdx.x % 32 < THREADS / 32 ? warp_max[threadIdx.x % 32] : 0u;
  return __reduce_max_sync(0xffffffffu, m);
}

// Pass 1: block b's max|v| (as bits) -> maxima[b].  The nv whole vectors
// (0 when the pointers are not aligned for vector access) grid-stride,
// UNROLL loads in flight per thread; the elements past them one at a
// time.
template <bool BF16, bool EF>
__global__ void __launch_bounds__(THREADS)
absmax_kernel(Input<BF16, EF> in, unsigned* __restrict__ maxima, int64_t n,
              int64_t nv) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  int64_t c = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  unsigned m = 0;
  for (; c + (UNROLL - 1) * stride < nv; c += UNROLL * stride) {
    float v[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      in.template vec<false>(c + u * stride, v[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int i = 0; i < VEC; ++i) m = max(m, abs_bits(v[u][i]));
  }
  for (; c < nv; c += stride) {
    float v[VEC];
    in.template vec<false>(c, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) m = max(m, abs_bits(v[i]));
  }
  for (int64_t i = nv * VEC + (int64_t)blockIdx.x * THREADS + threadIdx.x;
       i < n; i += stride)
    m = max(m, abs_bits(in.at(i)));
  grid_launch_dependents();            // pass 2 may start its launch
  m = block_max(m);
  if (threadIdx.x == 0) maxima[blockIdx.x] = m;
}

// Pass 2: the scale from pass 1's ``blocks`` maxima, then every element,
// the vectors walked from the end (vector nv - 1 - c for the c pass 1
// read at the same step).
template <bool BF16, bool EF>
__global__ void __launch_bounds__(THREADS)
quantize_pass_kernel(Input<BF16, EF> in, Output<EF> out,
                     const unsigned* maxima, int blocks,
                     float* __restrict__ scale, int64_t n, int64_t nv) {
  grid_dependency_wait();              // pass 1's maxima are written
  unsigned m = 0;
  for (int b = threadIdx.x; b < blocks; b += THREADS)
    m = max(m, __ldcg(maxima + b));
  m = block_max(m);
  const float s = __fmaf_rn(__uint_as_float(m), INV127, EPS);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale = s;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  int64_t c = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  for (; c + (UNROLL - 1) * stride < nv; c += UNROLL * stride) {
    float v[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      in.template vec<true>(nv - 1 - (c + u * stride), v[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      out.vec(nv - 1 - (c + u * stride), v[u], s);
  }
  for (; c < nv; c += stride) {
    float v[VEC];
    in.template vec<true>(nv - 1 - c, v);
    out.vec(nv - 1 - c, v, s);
  }
  for (int64_t i = nv * VEC + (int64_t)blockIdx.x * THREADS + threadIdx.x;
       i < n; i += stride)
    out.at(i, in.at(i), s);
}

// One wave: the blocks the SMs hold of ``kernel``, at most ``cap``, and no
// more than n needs (UNROLL vectors a thread).
template <typename Kernel>
int wave(Kernel kernel, int64_t n, int cap) {
  static int per_sm = 0;
  if (per_sm == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    THREADS, 0) != cudaSuccess)
    per_sm = 1;
  const int64_t need =
      (n + (int64_t)THREADS * VEC * UNROLL - 1) / (THREADS * VEC * UNROLL);
  return static_cast<int>(std::max<int64_t>(
      1, std::min<int64_t>({need, (int64_t)sm_count() * std::max(per_sm, 1),
                            (int64_t)cap})));
}

template <bool BF16, bool EF>
cudaError_t compress(Input<BF16, EF> in, Output<EF> out, unsigned* maxima,
                     int max_blocks, float* scale, int64_t n, bool vec,
                     cudaStream_t st) {
  const int64_t nv = vec ? n / VEC : 0;
  const int g1 = wave(absmax_kernel<BF16, EF>, n, max_blocks);
  absmax_kernel<BF16, EF><<<g1, THREADS, 0, st>>>(in, maxima, n, nv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int g2 = wave(quantize_pass_kernel<BF16, EF>, n, 1 << 30);
  return launch_dependent(quantize_pass_kernel<BF16, EF>, dim3(g2),
                          dim3(THREADS), 0, st, in, out,
                          static_cast<const unsigned*>(maxima), g1, scale, n,
                          nv);
}

bool aligned(const void* p, uintptr_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
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

// The plain form: (q, scale) of x (fp32, or bf16 when ``bf16``).
// ``maxima`` is scratch of ``max_blocks`` words (pass 1's grid is capped
// there).  Returns the launches' cudaGetLastError().
extern "C" int dmath_quantize_compress(const void* x, int bf16, void* maxima,
                                       int max_blocks, void* q, void* scale,
                                       long long n, void* stream) {
  if (n <= 0 || max_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // a vector is a 16-byte load of fp32 x (8-byte of bf16) and a 4-byte
  // store of q
  const bool vec = aligned(x, bf16 ? 8 : 16) && aligned(q, 4);
  Output<false> out{static_cast<signed char*>(q), nullptr, nullptr};
  unsigned* mx = static_cast<unsigned*>(maxima);
  float* sp = static_cast<float*>(scale);
  const cudaError_t e =
      bf16 ? compress(Input<true, false>{x, nullptr}, out, mx, max_blocks, sp,
                      n, vec, st)
           : compress(Input<false, false>{x, nullptr}, out, mx, max_blocks,
                      sp, n, vec, st);
  return static_cast<int>(e);
}

// The error-feedback form: (deq, new_err, scale) of v = g + err, g fp32
// (or bf16 when ``bf16``), err, deq and new_err fp32 of n elements.
extern "C" int dmath_quantize_compress_ef(const void* g, int bf16,
                                          const void* err, void* maxima,
                                          int max_blocks, void* deq,
                                          void* new_err, void* scale,
                                          long long n, void* stream) {
  if (n <= 0 || max_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = aligned(g, bf16 ? 8 : 16) && aligned(err, 16) &&
                   aligned(deq, 16) && aligned(new_err, 16);
  const float* e = static_cast<const float*>(err);
  Output<true> out{nullptr, static_cast<float*>(deq),
                   static_cast<float*>(new_err)};
  unsigned* mx = static_cast<unsigned*>(maxima);
  float* sp = static_cast<float*>(scale);
  const cudaError_t rc =
      bf16 ? compress(Input<true, true>{g, e}, out, mx, max_blocks, sp, n,
                      vec, st)
           : compress(Input<false, true>{g, e}, out, mx, max_blocks, sp, n,
                      vec, st);
  return static_cast<int>(rc);
}
