// C[M,N] = (A[M,K] @ B_q[K,N]) * scale[N]: int8 weights widened in the
// kernel, fp32 accumulator, the per-column scale in the epilogue, one
// cast to fp32 or bf16.
//
// Replaces the TPU kernel repro/kernels/gemm.py::matmul_dequant
// (_matmul_dequant_kernel), which widens the int8 tile to the activation
// dtype in VMEM, dots it into an fp32 scratch and scales the accumulator
// once per output tile; the dequantized B never exists in device memory.
// At decode-sized M the product does a few operations per weight byte, so
// it is bound by the int8 bytes of B over 3.35 TB/s: half the bytes of
// the bf16 GEMM's.
//
// Two kernels, by the activations' type:
// - bf16 A: the structure of csrc/gemm.cu.  Each block owns a 64x64
//   output tile and walks K in 32-deep steps; the B tile arrives as int8
//   (16-byte loads) and is widened to bf16 while it is staged to shared
//   memory (exact: |q| <= 127), then four warps run bf16 WMMA into fp32.
// - fp32 A: fp32 FMAs on CUDA cores (TF32 tensor cores would keep 10
//   mantissa bits and miss the reference's fp32 tolerance of 2e-5).  Each
//   of 256 threads owns a 4x4 block of a 64x64 tile; A and the widened B
//   go through shared memory in 16-deep steps, and each step's partial
//   sums are added to the accumulator once, which keeps the fp32 rounding
//   of long K sums closer to a blocked sum's.
// Ragged M, N and K edges are masked in both (out-of-range loads read
// zeros, out-of-range stores are skipped), so no caller pads.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int BM = 64;
constexpr int BN = 64;

__device__ __forceinline__ void store(void* C, size_t i, float v,
                                      bool out_f32) {
  if (out_f32)
    static_cast<float*>(C)[i] = v;
  else
    static_cast<bf16*>(C)[i] = __float2bfloat16(v);
}

// ---- bf16 activations: WMMA ----------------------------------------------

constexpr int BK = 32;
constexpr int WMMA_THREADS = 128;   // 4 warps as a 2x2 grid of 32x32 tiles
constexpr int A_LD = BK + 8;        // padded rows, as in csrc/gemm.cu
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;

__global__ void __launch_bounds__(WMMA_THREADS)
dequant_wmma_kernel(const bf16* __restrict__ A,
                    const signed char* __restrict__ Bq,
                    const float* __restrict__ scale, void* __restrict__ C,
                    int M, int N, int K, bool vec_a, bool vec_b,
                    bool out_f32) {
  __shared__ __align__(128) bf16 As[BM * A_LD];
  __shared__ __align__(128) bf16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const bf16 zero = __float2bfloat16(0.0f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile (BM x BK) in chunks of 8 bf16, as csrc/gemm.cu loads it.
    for (int c = tid; c < BM * BK / 8; c += WMMA_THREADS) {
      const int r = c / (BK / 8);
      const int kc = (c % (BK / 8)) * 8;
      const int gm = m0 + r;
      const int gk = k0 + kc;
      bf16* dst = &As[r * A_LD + kc];
      if (vec_a && gm < M && gk + 8 <= K) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(&A[(size_t)gm * K + gk]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gm < M && gk + e < K) ? A[(size_t)gm * K + gk + e] : zero;
      }
    }
    // B tile (BK x BN) as int8, 16 per 16-byte load, widened to bf16.
    for (int c = tid; c < BK * BN / 16; c += WMMA_THREADS) {
      const int r = c / (BN / 16);
      const int nc = (c % (BN / 16)) * 16;
      const int gk = k0 + r;
      const int gn = n0 + nc;
      bf16* dst = &Bs[r * B_LD + nc];
      if (vec_b && gk < K && gn + 16 <= N) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(&Bq[(size_t)gk * N + gn]);
        const signed char* b = reinterpret_cast<const signed char*>(&raw);
#pragma unroll
        for (int e = 0; e < 16; ++e)
          dst[e] = __float2bfloat16(static_cast<float>(b[e]));
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          dst[e] = (gk < K && gn + e < N)
                       ? __float2bfloat16(static_cast<float>(
                             Bq[(size_t)gk * N + gn + e]))
                       : zero;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[(wm * 32 + i * 16) * A_LD + kk],
                               A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[kk * B_LD + wn * 32 + j * 16],
                               B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: stage the fp32 tile, scale each column, cast once.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * C_LD + wn * 32 + j * 16],
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int c = tid; c < BM * BN; c += WMMA_THREADS) {
    const int r = c / BN;
    const int col = c % BN;
    const int gm = m0 + r;
    const int gn = n0 + col;
    if (gm < M && gn < N)
      store(C, (size_t)gm * N + gn, Cs[r * C_LD + col] * scale[gn], out_f32);
  }
}

// ---- fp32 activations: CUDA-core FMAs --------------------------------------

constexpr int FK = 16;              // K depth of one shared-memory step
constexpr int F_THREADS = 256;      // 16 x 16 threads, 4x4 outputs each

__global__ void __launch_bounds__(F_THREADS)
dequant_f32_kernel(const float* __restrict__ A,
                   const signed char* __restrict__ Bq,
                   const float* __restrict__ scale, void* __restrict__ C,
                   int M, int N, int K, bool out_f32) {
  // As is stored k-major so a thread's four rows are one 16-byte read
  __shared__ __align__(16) float As[FK][BM];
  __shared__ __align__(16) float Bs[FK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;          // columns tx*4 .. tx*4+3
  const int ty = tid / 16;          // rows ty*4 .. ty*4+3
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
    // A tile (BM x FK): consecutive threads read consecutive k of a row.
    for (int c = tid; c < BM * FK; c += F_THREADS) {
      const int r = c / FK;
      const int kk = c % FK;
      const int gm = m0 + r;
      const int gk = k0 + kk;
      As[kk][r] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.0f;
    }
    // B tile (FK x BN): consecutive threads read consecutive columns.
    for (int c = tid; c < FK * BN; c += F_THREADS) {
      const int kk = c / BN;
      const int col = c % BN;
      const int gk = k0 + kk;
      const int gn = n0 + col;
      Bs[kk][col] = (gk < K && gn < N)
                        ? static_cast<float>(Bq[(size_t)gk * N + gn])
                        : 0.0f;
    }
    __syncthreads();
    float part[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          part[i][j] = __fmaf_rn(av[i], bv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gm < M && gn < N)
        store(C, (size_t)gm * N + gn, acc[i][j] * scale[gn], out_f32);
    }
  }
}

}  // namespace

extern "C" int dmath_gemm_dequant(const void* a, int a_f32, const void* bq,
                                  const void* scale, void* c, int M, int N,
                                  int K, int out_f32, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const signed char* B = static_cast<const signed char*>(bq);
  const float* sc = static_cast<const float*>(scale);
  if (a_f32) {
    dequant_f32_kernel<<<grid, F_THREADS, 0, s>>>(
        static_cast<const float*>(a), B, sc, c, M, N, K, out_f32 != 0);
  } else {
    const bool vec_a =
        (K % 8 == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0);
    const bool vec_b =
        (N % 16 == 0) && (reinterpret_cast<uintptr_t>(bq) % 16 == 0);
    dequant_wmma_kernel<<<grid, WMMA_THREADS, 0, s>>>(
        static_cast<const bf16*>(a), B, sc, c, M, N, K, vec_a, vec_b,
        out_f32 != 0);
  }
  return static_cast<int>(cudaGetLastError());
}
