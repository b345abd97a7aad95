// Mamba2 SSD (state-space duality) chunked scan:
//   h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,   y_t = C_t^T h_t   (per head)
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd (_ssd_kernel).
// x (B,S,H,P), B and C (B,S,G,N), all three bf16 or all fp32; dt (B,S,H)
// and A (H,) fp32; optional initial state (B,H,P,N) fp32.  Writes y
// (B,S,H,P) in x's dtype and the final state (B,H,P,N) fp32.  Head h reads
// group h / (H/G).  The math is fp32 throughout.
//
// Design.  The TPU kernel carries the state across a sequential grid axis;
// here one block owns one (batch, head) and a slice of PS state columns
// (column p of the state needs only x[:, p] and the shared B, C and dt, so
// the slices are independent), and walks the chunks in order in a loop,
// keeping its (N x PS) fp32 state slice in shared memory.  At the serve
// path's B = 1, H = 48, P = 64 that is 192 blocks on 132 SMs.  Per chunk
// of Q = 64 steps (the kernel's own chunk; the result does not depend on
// it): a = cumsum(dt A) by a warp scan, then
//   y   = ((C B^T) o L)(dt x) + (C o exp(a)) h,   L_ij = exp(a_i - a_j), j <= i
//   h'  = exp(a_Q) h + (B o exp(a_Q - a))^T (dt x)
// The score entries above the diagonal are set to 0 without evaluating
// the exponent, which is large and positive there (never a 0/1 mask
// multiply, which would give inf * 0 = NaN).  Steps past S (the ragged
// tail) load as dt = 0, x = B = C = 0: an identity on the state; their y
// rows are not stored.
//
// Bound on the H100 at the serve shapes (S = 512, fp32 inputs): ~15 MB of
// device memory (4.4 us at 3.35 TB/s) against ~1.1 GFLOP of the dual form
// (17 us at the 67 TFLOP/s fp32 CUDA-core peak), so operations bound it.
// This first version runs the three products as fp32 FMAs on CUDA cores
// from shared memory, and recomputes C B^T in each of a head's P slices;
// mma/wgmma for the products and TMA-fed chunk stages are left to a later
// change.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int Q = 64;          // chunk length the kernel walks
constexpr int PS = 16;         // state columns (of P) per block
constexpr int THREADS = 256;
constexpr int LDK = Q + 4;     // row stride of the transposed B and C tiles
constexpr int LDS = Q + 1;     // row stride of the score tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

size_t smem_bytes(int N) {
  // Bt, Ct (N x LDK) + scores (Q x LDS) + dt*x (Q x PS) + state (N x PS)
  // + a and exp(a_Q - a) (Q each), fp32.  Every float4-read array starts
  // at a multiple of 4 floats.
  return sizeof(float) * (2 * N * LDK + Q * LDS + Q * PS + N * PS + 2 * Q);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ init,
                T* __restrict__ y, float* __restrict__ state, int S, int H,
                int G, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  float* Bt = smem;              // [N][LDK] the chunk's B, transposed
  float* Ct = Bt + N * LDK;      // [N][LDK] the chunk's C, transposed
  float* Sm = Ct + N * LDK;      // [Q][LDS] decayed causal scores
  float* xdt = Sm + Q * LDS;     // [Q][PS] dt * x, this block's columns
  float* hs = xdt + Q * PS;      // [N][PS] the carried state slice
  float* a = hs + N * PS;        // [Q] inclusive cumsum of dt * A
  float* w = a + Q;              // [Q] exp(a_{Q-1} - a_j)

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int g = h / (H / G);
  const int p0 = blockIdx.y * PS;
  const int tid = threadIdx.x;
  const float Ah = A[h];

  for (int i = tid; i < N * PS; i += THREADS) {
    const int n = i % N, p = i / N;
    float v = 0.0f;
    if (init != nullptr && p0 + p < P)
      v = init[((size_t)bh * P + p0 + p) * N + n];
    hs[n * PS + p] = v;
  }

  const int n_chunks = (S + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    if (tid < 32) {            // a = cumsum(dt * A): two steps a lane
      const int j = 2 * tid;
      const size_t row = (size_t)b * S + t0 + j;
      const float v0 = t0 + j < S ? dt[row * H + h] * Ah : 0.0f;
      const float v1 = t0 + j + 1 < S ? dt[(row + 1) * H + h] * Ah : 0.0f;
      float s = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, s, o);
        if (tid >= o) s += u;
      }
      a[j] = s - v1;
      a[j + 1] = s;
    }
    for (int i = tid; i < Q * N; i += THREADS) {
      const int j = i / N, n = i % N;
      float bv = 0.0f, cv = 0.0f;
      if (t0 + j < S) {
        const size_t off = (((size_t)b * S + t0 + j) * G + g) * N + n;
        bv = to_f(Bm[off]);
        cv = to_f(Cm[off]);
      }
      Bt[n * LDK + j] = bv;
      Ct[n * LDK + j] = cv;
    }
    for (int i = tid; i < Q * PS; i += THREADS) {
      const int j = i / PS, p = i % PS;
      float v = 0.0f;
      if (t0 + j < S && p0 + p < P) {
        const size_t row = (size_t)b * S + t0 + j;
        v = to_f(x[(row * H + h) * P + p0 + p]) * dt[row * H + h];
      }
      xdt[i] = v;
    }
    __syncthreads();

    // scores: a 4x4 tile of (C B^T) per thread, lower triangle only
    {
      const int ti = tid / 16, tj = tid % 16;
      float acc[4][4] = {};
      if (tj <= ti) {
        for (int n = 0; n < N; ++n) {
          const float4 cv =
              *reinterpret_cast<const float4*>(Ct + n * LDK + 4 * ti);
          const float4 bv =
              *reinterpret_cast<const float4*>(Bt + n * LDK + 4 * tj);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] += cr[r] * br[q];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ti + r;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = 4 * tj + q;
          Sm[i * LDS + j] = j <= i ? acc[r][q] * expf(a[i] - a[j]) : 0.0f;
        }
      }
    }
    if (tid < Q) w[tid] = expf(a[Q - 1] - a[tid]);
    __syncthreads();

    // y = scores (dt x) + exp(a) (C h): 4 columns of one row per thread
    {
      const int i = tid / 4, pc = 4 * (tid % 4);
      float acc[4] = {}, off[4] = {};
      for (int j = 0; j <= i; ++j) {
        const float s = Sm[i * LDS + j];
        const float4 xv = *reinterpret_cast<const float4*>(xdt + j * PS + pc);
        acc[0] += s * xv.x;
        acc[1] += s * xv.y;
        acc[2] += s * xv.z;
        acc[3] += s * xv.w;
      }
      for (int n = 0; n < N; ++n) {
        const float cv = Ct[n * LDK + i];
        const float4 hv = *reinterpret_cast<const float4*>(hs + n * PS + pc);
        off[0] += cv * hv.x;
        off[1] += cv * hv.y;
        off[2] += cv * hv.z;
        off[3] += cv * hv.w;
      }
      if (t0 + i < S) {
        const float ea = expf(a[i]);
        T* yr = y + (((size_t)b * S + t0 + i) * H + h) * P + p0 + pc;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (p0 + pc + q < P) store(yr + q, acc[q] + ea * off[q]);
      }
    }
    __syncthreads();

    // h' = exp(a_Q) h + (B o exp(a_Q - a))^T (dt x): 8 columns of a row
    {
      const float et = expf(a[Q - 1]);
      const int pc = 8 * (tid % 2);
      for (int n = tid / 2; n < N; n += THREADS / 2) {
        float acc[8] = {};
        for (int j = 0; j < Q; ++j) {
          const float bv = Bt[n * LDK + j] * w[j];
          const float4 x0 =
              *reinterpret_cast<const float4*>(xdt + j * PS + pc);
          const float4 x1 =
              *reinterpret_cast<const float4*>(xdt + j * PS + pc + 4);
          acc[0] += bv * x0.x;
          acc[1] += bv * x0.y;
          acc[2] += bv * x0.z;
          acc[3] += bv * x0.w;
          acc[4] += bv * x1.x;
          acc[5] += bv * x1.y;
          acc[6] += bv * x1.z;
          acc[7] += bv * x1.w;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q)
          hs[n * PS + pc + q] = et * hs[n * PS + pc + q] + acc[q];
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < N * PS; i += THREADS) {
    const int n = i % N, p = i / N;
    if (p0 + p < P) state[((size_t)bh * P + p0 + p) * N + n] = hs[n * PS + p];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* init, void* y, void* state, int B,
           int S, int H, int G, int P, int N, cudaStream_t s) {
  const size_t bytes = smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (P + PS - 1) / PS);
  ssd_scan_kernel<T><<<grid, THREADS, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(init),
      static_cast<T*>(y), static_cast<float*>(state), S, H, G, P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// init may be null (a zero initial state).  bf16_in selects bf16 x, B, C
// and y; otherwise all four are fp32.
extern "C" int dmath_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm,
                              const void* init, void* y, void* state, int B,
                              int S, int H, int G, int P, int N, int bf16_in,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_in)
    return launch<bf16>(x, dt, A, Bm, Cm, init, y, state, B, S, H, G, P, N,
                        s);
  return launch<float>(x, dt, A, Bm, Cm, init, y, state, B, S, H, G, P, N, s);
}
