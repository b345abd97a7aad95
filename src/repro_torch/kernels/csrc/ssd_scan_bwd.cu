// Mamba2 SSD chunked scan, backward: the gradients of
//   (y, final state) = ssd(x, dt, A, B, C, init_state)      (ssd_scan.cu)
// for the cotangents dy (B,S,H,P, x's dtype) and d_state (B,H,P,N fp32, or
// none): dx in x's dtype, ddt (B,S,H) and dA (H,) fp32, dB and dC
// (B,S,G,N) in their dtype, each summed over its group's heads, and
// d init_state (B,H,P,N) fp32 when the forward had an initial state.
//
// Replaces no TPU kernel: the reference's Pallas SSD kernel has no
// backward, and the reference model trains through ssd_chunked under JAX
// autodiff (repro/models/ssm.py).  This is that gradient on the card, in
// the order of work of ref.ssd_backward_chunks, which the CPU tests hold
// against autograd.
//
// Per chunk of Q = 64 steps and head h, with a the inclusive cumsum of
// dt A, u = dt x, L_ij = exp(a_i - a_j) on j <= i, H_c the state entering
// the chunk (the forward's pass-2 scratch, which the wrapper keeps for the
// backward: B * ceil(S/64) * H * (P*N + 1) floats) and w_j = exp(a_Q - a_j):
//
// 1. ssd_bwd_out_kernel, a block per (chunk, head, batch), every chunk at
//    once: CB = (C B^T) o L, DU = dy u^T, E = dy H_c, then
//      dC = exp(a) o E + (DU o L) B        du = CB^T dy
//      dB = (DU o L)^T C                   dH_c = (dy o exp(a))^T C
//      da_i = sum_j M_ij - sum_k M_ki + exp(a_i) C_i . E_i,  M = CB o DU
//    (dB, dC per head into fp32 scratch; du, da, dH_c into scratch).
// 2. ssd_bwd_state_kernel, elementwise over (batch, head, P * N), the
//    chunks in reverse from G = d_state: dS_c = G (in place of dH_c),
//    G <- dH_c + exp(a_Q,c) G, d init = G; the total decay's gradient
//    sum(G exp(a_Q,c) H_c) as one partial sum per block.
// 3. ssd_bwd_in_kernel, a block per (chunk, head, batch): T = B dS^T,
//      du += w o T,  dB += (w o u) dS,  r_j = w_j u_j . T_j,
//      da_j -= r_j,  da_{Q-1} += sum_j r_j + the partials of pass 2,
//    then d(dt A) as the reverse cumsum of da, ddt = d(dt A) A + du . x,
//    dx = du dt, and dA's partial sum of the chunk.
// 4. ssd_bwd_reduce_kernel: dB and dC summed over each group's heads in
//    head order, dA over the chunks in order, cast to the outputs' types.
//
// Nothing is summed across blocks except through scratch in a fixed
// order, and there are no atomics: a run gives the same bits as the last.
// The entries of L above the diagonal are written as 0 without evaluating
// their exponent.  Products are mma.sync m16n8k8 on the tensor cores
// (ssd_scan.cuh: 3xTF32 for fp32 inputs, one TF32 product for bf16) on
// fp32 tiles in shared memory, each a 16 x 8 output tile per warp in turn.
//
// What bounds it: at mamba2-780m's train shape (B 2, S 512, H 48, P 64,
// N 128) the products are ~6.4 GFLOP a call (x3 for fp32's 3xTF32) over
// ~0.1 GB of inputs, outputs and scratch, so operations bound it.  This
// first version is simple: every product reads its operands from shared
// memory with generic strides (some two-way bank conflicts), the four
// passes are plain launches, and a block walks P in tiles of 64 in series.
// N is at most 128 (the outputs' pass holds eight fp32 tiles of 64 rows).
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ssd_scan.cuh"

namespace {

using namespace ssd;

constexpr int Q = 64;              // the forward's chunk
constexpr int PT = 64;             // a tile of P
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int PASS_THREADS = 256;
constexpr int MAX_N = 128;
constexpr int LDQ = Q + 4;         // Q x Q tiles read along their rows
constexpr int LDQC = Q + 8;        // ... and down their columns
constexpr int LDP = PT + 4;        // Q x PT tiles

// Row strides of the N-wide tiles: read along rows (4 mod 32 floats) or
// down columns (8 mod 32), so a fragment's loads hit distinct banks.
__host__ __device__ constexpr int ld_rows(int np) { return round_up(np, 32) + 4; }
__host__ __device__ constexpr int ld_cols(int np) { return round_up(np, 32) + 8; }

size_t out_smem(int np) {
  return sizeof(float) * (2 * Q * ld_cols(np) + 2 * Q * ld_rows(np) +
                          Q * LDQC + Q * LDQ + 2 * Q * LDP + 4 * Q);
}
size_t in_smem(int np) {
  return sizeof(float) * (3 * Q * ld_rows(np) + 2 * Q * LDP + 5 * Q);
}

// rows x cols of a row-major global array into an fp32 tile (row stride
// ld), zeros at rows >= n_rows and columns >= n_cols.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          size_t stride, int rows,
                                          int n_rows, int cols, int n_cols) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i % cols;
    dst[r * ld + c] =
        r < n_rows && c < n_cols ? to_f(src[r * stride + c]) : 0.0f;
  }
}

__device__ __forceinline__ void fill(float* dst, int n, float v) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = v;
}

// The block's M x Nn product sum_k a(i, k) b(k, j) over K (M a multiple of
// 16, Nn of 8, K of 8), each warp taking 16 x 8 output tiles in turn;
// epi(i, j, v) receives every element once, from one thread.
template <bool SPLIT, typename FA, typename FB, typename FE>
__device__ __forceinline__ void block_mma(int M, int Nn, int K, const FA& fa,
                                          const FB& fb, const FE& epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tq = lane % 4;
  const int tn = Nn / 8, tiles = (M / 16) * tn;
  for (int t = warp; t < tiles; t += WARPS) {
    const int m0 = (t / tn) * 16, n0 = (t % tn) * 8;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < K; k0 += 8) {
      const float av[4] = {fa(m0 + gr, k0 + tq), fa(m0 + gr + 8, k0 + tq),
                           fa(m0 + gr, k0 + tq + 4),
                           fa(m0 + gr + 8, k0 + tq + 4)};
      const float bv[2] = {fb(k0 + tq, n0 + gr), fb(k0 + tq + 4, n0 + gr)};
      uint32_t ah[4], al[4], bh[2], bl[2];
      split<4, SPLIT>(av, ah, al);
      split<2, SPLIT>(bv, bh, bl);
      mma3<SPLIT>(acc, ah, al, bh, bl);
    }
    epi(m0 + gr, n0 + 2 * tq, acc[0]);
    epi(m0 + gr, n0 + 2 * tq + 1, acc[1]);
    epi(m0 + gr + 8, n0 + 2 * tq, acc[2]);
    epi(m0 + gr + 8, n0 + 2 * tq + 1, acc[3]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pass 1 of the backward (the outputs'): see the note at the top.  du, dBh
// and dCh are (B, nc * Q, H, P or N) fp32, da (B, nc, H, Q), dH the
// forward's (B, nc, H, P, N) layout.
template <typename T, bool SPLIT>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, const T* __restrict__ dy,
                   const float* __restrict__ Hin, float* __restrict__ dH,
                   float* __restrict__ du, float* __restrict__ dBh,
                   float* __restrict__ dCh, float* __restrict__ da_out,
                   int S, int H, int G, int P, int N, int nc) {
  const int NP = round_up(N, 8), LDC = ld_cols(NP), LDB = ld_rows(NP);
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                  // [Q][LDC]
  float* Hs = Cs + Q * LDC;          // [PT][LDC] H_c's rows p0 ..
  float* Bs = Hs + PT * LDC;         // [Q][LDB]
  float* Es = Bs + Q * LDB;          // [Q][LDB] E = dy H_c
  float* Scb = Es + Q * LDB;         // [Q][LDQC] (C B^T) o L
  float* Sdu = Scb + Q * LDQC;       // [Q][LDQ] dy u^T, then o L
  float* dys = Sdu + Q * LDQ;        // [Q][LDP]
  float* us = dys + Q * LDP;         // [Q][LDP]
  float* a = us + Q * LDP;           // [Q]
  float* ea = a + Q;                 // [Q] exp(a)
  float* dts = ea + Q;               // [Q]
  float* dav = dts + Q;              // [Q]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (H / G);
  const int t0 = c * Q, valid = min(Q, S - t0);
  const size_t row0 = (size_t)b * S + t0;          // rows of the inputs
  const size_t rowp = (size_t)b * nc * Q + t0;     // rows of the scratch
  const size_t bch = ((size_t)b * nc + c) * H + h;
  const int tid = threadIdx.x;

  load_rows(Cs, LDC, Cm + (row0 * G + grp) * N, (size_t)G * N, Q, valid, NP,
            N);
  load_rows(Bs, LDB, Bm + (row0 * G + grp) * N, (size_t)G * N, Q, valid, NP,
            N);
  fill(Es, Q * LDB, 0.0f);
  fill(Sdu, Q * LDQ, 0.0f);
  if (tid < 32) chunk_decay(dt + row0 * H + h, H, A[h], valid, a, dts);
  __syncthreads();
  if (tid < Q) ea[tid] = expf(a[tid]);
  block_mma<SPLIT>(
      Q, Q, NP, [&](int i, int k) { return Cs[i * LDC + k]; },
      [&](int k, int j) { return Bs[j * LDB + k]; },
      [&](int i, int j, float v) {
        Scb[i * LDQC + j] = j <= i ? v * expf(a[i] - a[j]) : 0.0f;
      });
  __syncthreads();

  for (int p0 = 0; p0 < P; p0 += PT) {
    const int pw = min(PT, P - p0);
    load_rows(dys, LDP, dy + (row0 * H + h) * P + p0, (size_t)H * P, Q,
              valid, PT, pw);
    load_rows(us, LDP, x + (row0 * H + h) * P + p0, (size_t)H * P, Q, valid,
              PT, pw);
    load_rows(Hs, LDC, Hin + (bch * P + p0) * N, N, PT, pw, NP, N);
    __syncthreads();
    for (int i = tid; i < Q * PT; i += THREADS)
      us[(i / PT) * LDP + i % PT] *= dts[i / PT];
    __syncthreads();
    // DU += dy u^T, E += dy H_c
    block_mma<SPLIT>(
        Q, Q, PT, [&](int i, int k) { return dys[i * LDP + k]; },
        [&](int k, int j) { return us[j * LDP + k]; },
        [&](int i, int j, float v) { Sdu[i * LDQ + j] += v; });
    block_mma<SPLIT>(
        Q, NP, PT, [&](int i, int k) { return dys[i * LDP + k]; },
        [&](int k, int n) { return Hs[k * LDC + n]; },
        [&](int i, int n, float v) { Es[i * LDB + n] += v; });
    // du = CB^T dy
    block_mma<SPLIT>(
        Q, PT, Q, [&](int j, int i) { return Scb[i * LDQC + j]; },
        [&](int i, int p) { return dys[i * LDP + p]; },
        [&](int j, int p, float v) {
          if (p < pw) du[((rowp + j) * H + h) * P + p0 + p] = v;
        });
    // dH_c = (dy o exp(a))^T C
    block_mma<SPLIT>(
        PT, NP, Q, [&](int p, int i) { return dys[i * LDP + p] * ea[i]; },
        [&](int i, int n) { return Cs[i * LDC + n]; },
        [&](int p, int n, float v) {
          if (p < pw && n < N) dH[(bch * P + p0 + p) * N + n] = v;
        });
    __syncthreads();
  }

  if (tid < Q) {
    const int i = tid;
    float s = 0.0f, ce = 0.0f;
    for (int j = 0; j < Q; ++j) s += Scb[i * LDQC + j] * Sdu[i * LDQ + j];
    for (int k = 0; k < Q; ++k) s -= Scb[k * LDQC + i] * Sdu[k * LDQ + i];
    for (int n = 0; n < NP; ++n) ce += Cs[i * LDC + n] * Es[i * LDB + n];
    dav[i] = s + ea[i] * ce;
  }
  __syncthreads();
  for (int e = tid; e < Q * Q; e += THREADS) {
    const int i = e / Q, j = e % Q;
    Sdu[i * LDQ + j] = j <= i ? Sdu[i * LDQ + j] * expf(a[i] - a[j]) : 0.0f;
  }
  __syncthreads();
  // dC = exp(a) o E + (DU o L) B;  dB = (DU o L)^T C
  block_mma<SPLIT>(
      Q, NP, Q, [&](int i, int j) { return Sdu[i * LDQ + j]; },
      [&](int j, int n) { return Bs[j * LDB + n]; },
      [&](int i, int n, float v) {
        if (n < N)
          dCh[((rowp + i) * H + h) * N + n] = ea[i] * Es[i * LDB + n] + v;
      });
  block_mma<SPLIT>(
      Q, NP, Q, [&](int j, int i) { return Sdu[i * LDQ + j]; },
      [&](int i, int n) { return Cs[i * LDC + n]; },
      [&](int j, int n, float v) {
        if (n < N) dBh[((rowp + j) * H + h) * N + n] = v;
      });
  if (tid < Q) da_out[bch * Q + tid] = dav[tid];
}

// Pass 2 of the backward (the states'): in place of dH_c (from y) the
// gradient of the chunk's own state; each block's partial sum of the total
// decays' gradients per chunk; d init.
__global__ void __launch_bounds__(PASS_THREADS)
ssd_bwd_state_kernel(float* __restrict__ dH, const float* __restrict__ Hin,
                     const float* __restrict__ decay,
                     const float* __restrict__ dstate,
                     float* __restrict__ dinit, float* __restrict__ daq_part,
                     int H, int PN, int nc) {
  __shared__ float red[PASS_THREADS / 32];
  const int e = blockIdx.x * PASS_THREADS + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool ok = e < PN;
  const size_t bh = (size_t)b * H + h;
  float g = ok && dstate != nullptr ? dstate[bh * PN + e] : 0.0f;
  for (int c = nc - 1; c >= 0; --c) {
    const size_t bc = ((size_t)b * nc + c) * H + h;
    const float f = decay[bc];
    float v = 0.0f, dhy = 0.0f;
    if (ok) {
      v = g * f * Hin[bc * PN + e];
      dhy = dH[bc * PN + e];
      dH[bc * PN + e] = g;
    }
    g = dhy + f * g;
    v = warp_sum(v);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.0f;
      for (int w = 0; w < PASS_THREADS / 32; ++w) s += red[w];
      daq_part[bc * gridDim.x + blockIdx.x] = s;
    }
    __syncthreads();
  }
  if (ok && dinit != nullptr) dinit[bh * PN + e] = g;
}

// Pass 3 of the backward (the chunk states' and the chunk's scalars): see
// the note at the top.  dBh gains the state's share of dB.
template <typename T, bool SPLIT>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_in_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const float* __restrict__ dS,
                  const float* __restrict__ daq_part,
                  const float* __restrict__ da_in,
                  const float* __restrict__ du, float* __restrict__ dBh,
                  T* __restrict__ dx, float* __restrict__ ddt,
                  float* __restrict__ dA_part, int S, int H, int G, int P,
                  int N, int nc, int nbx) {
  const int NP = round_up(N, 8), LDB = ld_rows(NP);
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;                  // [Q][LDB]
  float* dSs = Bs + Q * LDB;         // [PT][LDB] dS's rows p0 ..
  float* SdB = dSs + PT * LDB;       // [Q][LDB] the state's share of dB
  float* xs = SdB + Q * LDB;         // [Q][LDP]
  float* Ts = xs + Q * LDP;          // [Q][LDP] B dS^T
  float* a = Ts + Q * LDP;           // [Q]
  float* dts = a + Q;                // [Q]
  float* w = dts + Q;                // [Q] exp(a_Q - a)
  float* rsum = w + Q;               // [Q] x . T
  float* xsum = rsum + Q;            // [Q] du . x

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (H / G);
  const int t0 = c * Q, valid = min(Q, S - t0);
  const size_t row0 = (size_t)b * S + t0;
  const size_t rowp = (size_t)b * nc * Q + t0;
  const size_t bch = ((size_t)b * nc + c) * H + h;
  const int tid = threadIdx.x, lane = tid % 32;

  load_rows(Bs, LDB, Bm + (row0 * G + grp) * N, (size_t)G * N, Q, valid, NP,
            N);
  fill(SdB, Q * LDB, 0.0f);
  fill(rsum, 2 * Q, 0.0f);
  if (tid < 32) chunk_decay(dt + row0 * H + h, H, A[h], valid, a, dts);
  __syncthreads();
  if (tid < Q) w[tid] = expf(a[Q - 1] - a[tid]);
  __syncthreads();

  for (int p0 = 0; p0 < P; p0 += PT) {
    const int pw = min(PT, P - p0);
    load_rows(xs, LDP, x + (row0 * H + h) * P + p0, (size_t)H * P, Q, valid,
              PT, pw);
    load_rows(dSs, LDB, dS + (bch * P + p0) * N, N, PT, pw, NP, N);
    __syncthreads();
    // T = B dS^T;  dB += (w dt x) dS
    block_mma<SPLIT>(
        Q, PT, NP, [&](int j, int n) { return Bs[j * LDB + n]; },
        [&](int n, int p) { return dSs[p * LDB + n]; },
        [&](int j, int p, float v) { Ts[j * LDP + p] = v; });
    block_mma<SPLIT>(
        Q, NP, PT,
        [&](int j, int p) { return w[j] * dts[j] * xs[j * LDP + p]; },
        [&](int p, int n) { return dSs[p * LDB + n]; },
        [&](int j, int n, float v) { SdB[j * LDB + n] += v; });
    __syncthreads();
    // four threads a row: du = du (from y) + w T, dx = du dt, and the
    // rows' sums x . T and du . x
    {
      const int j = tid / 4, q = tid % 4;
      float rs = 0.0f, xd = 0.0f;
      for (int p = q; p < pw; p += 4) {
        const size_t gi = ((rowp + j) * H + h) * P + p0 + p;
        const float t = Ts[j * LDP + p], xv = xs[j * LDP + p];
        const float d = du[gi] + w[j] * t;
        rs += xv * t;
        xd += d * xv;
        if (j < valid) store(dx + (row0 + j) * H * P + (size_t)h * P + p0 + p,
                             d * dts[j]);
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      xd += __shfl_xor_sync(0xffffffffu, xd, 1);
      xd += __shfl_xor_sync(0xffffffffu, xd, 2);
      if (q == 0) {
        rsum[j] += rs;
        xsum[j] += xd;
      }
    }
    __syncthreads();
  }

  if (tid < 32) {
    // da -= r, r_j = w_j dt_j x_j . T_j; the total decay's gradient goes to
    // a_{Q-1}; then d(dt A) is the reverse cumsum of da
    const int j = 2 * lane;
    const float r0 = w[j] * dts[j] * rsum[j];
    const float r1 = w[j + 1] * dts[j + 1] * rsum[j + 1];
    float d0 = da_in[bch * Q + j] - r0, d1 = da_in[bch * Q + j + 1] - r1;
    const float rtot = warp_sum(r0 + r1);
    if (lane == 31) {
      float q = rtot;
      for (int k = 0; k < nbx; ++k) q += daq_part[bch * nbx + k];
      d1 += q;
    }
    float s = d0 + d1;                 // suffix sums over the lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_down_sync(0xffffffffu, s, o);
      if (lane + o < 32) s += v;
    }
    float after = __shfl_down_sync(0xffffffffu, s, 1);
    if (lane == 31) after = 0.0f;
    const float g1 = after + d1, g0 = g1 + d0;
    const float Ah = A[h];
    if (j < valid) ddt[(row0 + j) * H + h] = g0 * Ah + xsum[j];
    if (j + 1 < valid) ddt[(row0 + j + 1) * H + h] = g1 * Ah + xsum[j + 1];
    const float part = warp_sum(g0 * dts[j] + g1 * dts[j + 1]);
    if (lane == 0) dA_part[bch] = part;
  }
  for (int e = tid; e < Q * N; e += THREADS) {
    const int j = e / N, n = e % N;
    dBh[((rowp + j) * H + h) * N + n] += SdB[j * LDB + n];
  }
}

// Pass 4: dB, dC over each group's heads and dA over the chunks, in order.
template <typename T>
__global__ void __launch_bounds__(PASS_THREADS)
ssd_bwd_reduce_kernel(const float* __restrict__ dBh,
                      const float* __restrict__ dCh,
                      const float* __restrict__ dA_part, T* __restrict__ dB,
                      T* __restrict__ dC, float* __restrict__ dA, int B,
                      int S, int H, int G, int N, int nc) {
  const size_t e = (size_t)blockIdx.x * PASS_THREADS + threadIdx.x;
  const size_t total = (size_t)B * S * G * N;
  if (e < total) {
    const int n = e % N, g = (e / N) % G;
    const size_t bs = e / ((size_t)N * G);
    const int s = bs % S;
    const size_t b = bs / S;
    const int rep = H / G;
    const size_t base = ((b * nc * Q + s) * H + (size_t)g * rep) * N + n;
    float sb = 0.0f, sc = 0.0f;
    for (int k = 0; k < rep; ++k) {
      sb += dBh[base + (size_t)k * N];
      sc += dCh[base + (size_t)k * N];
    }
    store(dB + e, sb);
    store(dC + e, sc);
  }
  if (e < (size_t)H) {
    float s = 0.0f;
    for (int bc = 0; bc < B * nc; ++bc) s += dA_part[(size_t)bc * H + e];
    dA[e] = s;
  }
}

template <typename T, bool SPLIT>
int launch_bwd(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* dy, const void* dstate,
               const void* hin, void* dx, void* ddt, void* dA, void* dB,
               void* dC, void* dinit, void* work, int B, int S, int H, int G,
               int P, int N, cudaStream_t s) {
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_out_kernel<T, SPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(out_smem(MAX_N)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_bwd_in_kernel<T, SPLIT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(in_smem(MAX_N)));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const int nc = (S + Q - 1) / Q, NP = round_up(N, 8), PN = P * N;
  const int nbx = (PN + PASS_THREADS - 1) / PASS_THREADS;
  const size_t chunks_h = (size_t)B * nc * H;
  const float* Hin = static_cast<const float*>(hin);
  const float* decay = Hin + chunks_h * PN;
  float* dH = static_cast<float*>(work);
  float* du = dH + chunks_h * PN;
  float* dBh = du + chunks_h * Q * P;
  float* dCh = dBh + chunks_h * Q * N;
  float* da = dCh + chunks_h * Q * N;
  float* daq = da + chunks_h * Q;
  float* dAp = daq + chunks_h * nbx;
  const dim3 chunks(nc, H, B);
  ssd_bwd_out_kernel<T, SPLIT><<<chunks, THREADS, out_smem(NP), s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const T*>(dy), Hin, dH, du, dBh,
      dCh, da, S, H, G, P, N, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_state_kernel<<<dim3(nbx, H, B), PASS_THREADS, 0, s>>>(
      dH, Hin, decay, static_cast<const float*>(dstate),
      static_cast<float*>(dinit), daq, H, PN, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_in_kernel<T, SPLIT><<<chunks, THREADS, in_smem(NP), s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm), dH, daq, da,
      du, dBh, static_cast<T*>(dx), static_cast<float*>(ddt), dAp, S, H, G,
      P, N, nc, nbx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = (size_t)B * S * G * N;
  const size_t n = total > (size_t)H ? total : (size_t)H;
  ssd_bwd_reduce_kernel<T>
      <<<(unsigned)((n + PASS_THREADS - 1) / PASS_THREADS), PASS_THREADS, 0,
         s>>>(dBh, dCh, dAp, static_cast<T*>(dB), static_cast<T*>(dC),
              static_cast<float*>(dA), B, S, H, G, N, nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hin: the forward's scratch after the call (the states entering each chunk,
// then the chunks' total decays).  dstate and dinit may be null (a zero
// final-state cotangent; no initial state).  work: scratch of
// B * ceil(S / 64) * H * (P*N + 64 (P + 2 N + 1) + ceil(P*N / 256) + 1)
// fp32, not initialised.  bf16_in selects bf16 x, B, C, dy, dx, dB and dC;
// otherwise all are fp32.
extern "C" int dmath_ssd_scan_bwd(const void* x, const void* dt,
                                  const void* A, const void* Bm,
                                  const void* Cm, const void* dy,
                                  const void* dstate, const void* hin,
                                  void* dx, void* ddt, void* dA, void* dB,
                                  void* dC, void* dinit, void* work, int B,
                                  int S, int H, int G, int P, int N,
                                  int bf16_in, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      N <= 0 || N > MAX_N)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_in)
    return launch_bwd<bf16, false>(x, dt, A, Bm, Cm, dy, dstate, hin, dx,
                                   ddt, dA, dB, dC, dinit, work, B, S, H, G,
                                   P, N, s);
  return launch_bwd<float, true>(x, dt, A, Bm, Cm, dy, dstate, hin, dx, ddt,
                                 dA, dB, dC, dinit, work, B, S, H, G, P, N,
                                 s);
}
