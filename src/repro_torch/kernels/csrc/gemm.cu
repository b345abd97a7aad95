// C[M,N] = A[M,K] @ B[K,N]: bf16 operands, fp32 accumulator, one downcast.
//
// Replaces the TPU kernel repro/kernels/gemm.py::matmul (_matmul_kernel).
// Both operands are row-major and contiguous.  Each block owns a 64x64
// output tile and walks K in 32-deep steps through shared memory; its four
// warps each hold a 32x32 fp32 accumulator as 2x2 WMMA bf16 fragments
// (tensor cores, mma.sync underneath).  Ragged M, N and K edges are masked
// inside the kernel: out-of-range loads read zeros and out-of-range stores
// are skipped, so no caller pads.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;     // 4 warps as a 2x2 grid of 32x32 sub-tiles
// Row strides padded by 8 bf16 / 4 fp32: rows stay 32-byte aligned for the
// WMMA loads and stores, and neighbouring rows start in different banks.
constexpr int A_LD = BK + 8;
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;

template <bool OUT_F32>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
            void* __restrict__ C, int M, int N, int K, bool vec_a,
            bool vec_b) {
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
    // A tile (BM x BK) in chunks of 8 bf16: a 16-byte load where the
    // chunk is whole and aligned, element by element at the ragged edge.
    for (int c = tid; c < BM * BK / 8; c += THREADS) {
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
    // B tile (BK x BN), the same way.
    for (int c = tid; c < BK * BN / 8; c += THREADS) {
      const int r = c / (BN / 8);
      const int nc = (c % (BN / 8)) * 8;
      const int gk = k0 + r;
      const int gn = n0 + nc;
      bf16* dst = &Bs[r * B_LD + nc];
      if (vec_b && gk < K && gn + 8 <= N) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(&B[(size_t)gk * N + gn]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gk < K && gn + e < N) ? B[(size_t)gk * N + gn + e] : zero;
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

  // Stage the fp32 tile through shared memory, then store the in-range
  // part row by row (neighbouring threads on neighbouring columns).
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * C_LD + wn * 32 + j * 16],
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int c = tid; c < BM * BN; c += THREADS) {
    const int r = c / BN;
    const int col = c % BN;
    const int gm = m0 + r;
    const int gn = n0 + col;
    if (gm < M && gn < N) {
      const float v = Cs[r * C_LD + col];
      if (OUT_F32)
        static_cast<float*>(C)[(size_t)gm * N + gn] = v;
      else
        static_cast<bf16*>(C)[(size_t)gm * N + gn] = __float2bfloat16(v);
    }
  }
}

}  // namespace

extern "C" int dmath_gemm_bf16(const void* a, const void* b, void* c, int M,
                               int N, int K, int out_f32, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const bool vec_a = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0);
  const bool vec_b = (N % 8 == 0) && (reinterpret_cast<uintptr_t>(b) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* B = static_cast<const bf16*>(b);
  if (out_f32)
    gemm_kernel<true><<<grid, THREADS, 0, s>>>(A, B, c, M, N, K, vec_a, vec_b);
  else
    gemm_kernel<false><<<grid, THREADS, 0, s>>>(A, B, c, M, N, K, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dmath_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
