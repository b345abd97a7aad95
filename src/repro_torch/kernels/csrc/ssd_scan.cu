// Mamba2 SSD (state-space duality) chunked scan:
//   h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,   y_t = C_t^T h_t   (per head)
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd (_ssd_kernel).
// x (B,S,H,P), B and C (B,S,G,N), all three bf16 or all fp32; dt (B,S,H)
// and A (H,) fp32; optional initial state (B,H,P,N) fp32.  Writes y
// (B,S,H,P) in x's dtype and the final state (B,H,P,N) fp32.  Head h reads
// group h / (H/G).
//
// What bounds it: at the serve path's prefill (S = 512, H = 48, P = 64,
// N = 128, fp32) the dual form is ~1.1 GFLOP over ~15 MB, so operations
// bound it (0.0166 ms at the 67 TFLOP/s fp32 CUDA-core peak; 0.0044 ms
// at TF32's 495).  A block per (batch, head) walking its chunks in series
// leaves the card a chain of dependent chunks.  The design follows the
// chunked decomposition (ssd_scan.py's ssd_plain), in which only the
// (P, N) states need the chunk order, as three passes over chunks of
// Q = 64 steps (the kernel's own chunk; the result does not depend on it):
//
// 1. ssd_chunk_state_kernel, one block per (chunk, head, batch and slice
//    of 64 state columns), all chunks at once: a = cumsum(dt A) over the
//    chunk, and the chunk's own state
//      dH = (B o dt exp(a_Q - a))^T x      (written (P, N), fp32 scratch)
//    and its total decay exp(a_Q).
// 2. ssd_state_pass_kernel, elementwise over (batch, head, P * N): the
//    recurrence H_c = exp(a_Q,c) H_{c-1} + dH_c in chunk order from the
//    initial state, overwriting each dH_c with the state entering chunk c
//    and writing the final state.  8 steps at S = 512.
// 3. ssd_chunk_out_kernel, one block per (chunk, head, batch and slice),
//    all chunks at once:
//      y = ((C B^T) o L o dt) x + (C o exp(a)) H_{c-1}^T,
//    L_ij = exp(a_i - a_j) for j <= i.  The entries above the diagonal are
//    set to 0 without evaluating the exponent, which is large and positive
//    there; whole tiles above it are never computed.
//
// So a call runs three kernels; nothing is summed across blocks, no
// atomics, and a run gives the same bits as the last.  Passes 2 and 3 are
// launched as programmatic dependents of the pass before them (Hopper's
// griddepcontrol): they may start while it runs, and wait for its writes
// only where they read them, so pass 3 loads its tiles and computes its
// masked scores before it waits for the states.  Pass 3's state term
// folds into the diagonal product's accumulator; B's shared-memory tile
// takes H_{c-1} once C B^T has read it.
//
// Products: mma.sync m16n8k8 on the tensor cores, fp32 accumulate.  Tiles
// are staged in shared memory as fp32 (bf16 widened on load), padded so
// that each fragment load hits 32 distinct banks.  fp32 inputs take
// 3xTF32: each operand split into a TF32 head (rounded to nearest) and a
// tail (the exact remainder, rounded), and a*b = a_tail*b_head +
// a_head*b_tail + a_head*b_head, which keeps ~fp32 accuracy (plain TF32
// keeps ~3 decimal digits, short of the 2e-4 the fp32 path is held to).
// The rounding is two integer operations (cvt.rna took 7-10% more time
// on an H100).  Cutting the bits instead took 10-13% less time but moves
// every head and tail toward zero: of 16 seeds of
// mamba2's prefill-then-decode state comparison
// (scripts/prefill_decode_seeds.py) it left 4 past the 1% tolerance,
// rounding none.  bf16 inputs take one TF32 product: bf16 values are
// exact in TF32, and the fp32 intermediates (dt x, the masked scores, the
// states) keep TF32's 10 bits, more than bf16's 7.  In pass 3 each of the
// 8 warps owns two 16-row strips, one from each end of the causal
// triangle, and every fourth 8-column tile, so the warps do near-equal
// work on the triangle; in pass 1 each of 4 warps owns a 16-row strip of
// P, and its piece of dH leaves through shared memory in 16-byte rows.
// Loads are 16-byte cp.async for fp32 (bf16: 16-byte loads widened in
// registers), masked at the ragged tail: steps past S load as dt = 0,
// x = B = C = 0, an identity on the state; their y rows are not stored.
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ssd_scan.cuh"

namespace {

using namespace ssd;

constexpr int Q = 64;          // chunk length
constexpr int PT = 64;         // state columns (of P) per block
constexpr int STATE_WARPS = 4;  // pass 1: a 16-row strip of P per warp
constexpr int OUT_WARPS = 8;    // pass 3: two strips, a quarter of P
constexpr int LDO = 64 + 8;     // a warp's staged 16 x 64 piece of dH
constexpr int LDX = PT + 8;    // x tile: read down its columns
constexpr int LDS = Q + 4;     // masked score tile: read along its rows
constexpr int MAX_N = 256;
constexpr int PASS_THREADS = 256;

// Row strides of the B, C and state tiles: along rows (A operand, or B
// operand read along k) a stride of 4 mod 32 floats, down columns 8 mod 32.
__host__ __device__ constexpr int ld_rows(int np) { return round_up(np, 32) + 4; }
__host__ __device__ constexpr int ld_cols(int np) { return round_up(np, 32) + 8; }

size_t state_smem(int np) {
  return sizeof(float) *
         (Q * LDX + Q * ld_cols(np) + 2 * Q + STATE_WARPS * 16 * LDO);
}
size_t out_smem(int np) {
  return sizeof(float) * (2 * Q * ld_rows(np) + Q * LDX + Q * LDS + 2 * Q);
}

// rows x cols_pad of a row-major global array into an fp32 tile (row
// stride ld), zeros at rows >= n_rows and columns >= n_cols.  ``vec``: the
// rows start 16-byte aligned and n_cols fills whole 16-byte chunks, so
// fp32 moves by cp.async (committed by the caller) and bf16 by 16-byte
// loads widened in registers; otherwise element by element.  A row's
// pieces go to a power-of-two group of lanes, so a warp covers several
// short rows at once (no division by a runtime width).
template <typename T, int WARPS>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          size_t stride, int rows,
                                          int n_rows, int n_cols,
                                          int cols_pad, bool vec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int E = vec ? 16 / sizeof(T) : 1;      // elements per piece
  const int pieces = cols_pad / E;
  const int lpr = pieces >= 32 ? 32 : 1 << (32 - __clz(pieces - 1));
  const int r0 = warp * (32 / lpr) + lane / lpr, dr = WARPS * (32 / lpr);
  const int c0 = (lane % lpr) * E, dc = lpr * E;
  if (vec) {
    for (int r = r0; r < rows; r += dr)
    for (int c = c0; c < cols_pad; c += dc) {
      const bool ok = r < n_rows && c < n_cols;
      if constexpr (sizeof(T) == 4) {
        cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
      } else {
        uint4 u = make_uint4(0, 0, 0, 0);
        if (ok) u = __ldg(reinterpret_cast<const uint4*>(src + r * stride + c));
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
        const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
        const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
        *reinterpret_cast<float4*>(dst + r * ld + c) =
            make_float4(f0.x, f0.y, f1.x, f1.y);
        *reinterpret_cast<float4*>(dst + r * ld + c + 4) =
            make_float4(f2.x, f2.y, f3.x, f3.y);
      }
    }
    return;
  }
  for (int r = r0; r < rows; r += dr)
    for (int c = c0; c < cols_pad; c += dc)
      dst[r * ld + c] =
          r < n_rows && c < n_cols ? to_f(src[r * stride + c]) : 0.0f;
}

// Pass 1: dH[p][n] = sum_j x[j][p] dt_j exp(a_Q - a_j) B[j][n].  Warp w owns
// rows p of strip w and every column, 64 at a time.
template <typename T, bool SPLIT>
__global__ void __launch_bounds__(32 * STATE_WARPS)
ssd_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const T* __restrict__ Bm,
                       float* __restrict__ dH, float* __restrict__ decay,
                       int S, int H, int G, int P, int N, int nc, int vec_x,
                       int vec_bc, int vec_h) {
  const int NP = round_up(N, 8), LDB = ld_cols(NP);
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // [Q][LDX]
  float* Bs = xs + Q * LDX;          // [Q][LDB]
  float* a = Bs + Q * LDB;           // [Q]
  float* sw = a + Q;                 // [Q] dt, then dt exp(a_Q - a)
  float* stage = sw + Q;             // [STATE_WARPS][16][LDO]

  const int c = blockIdx.x, h = blockIdx.y;
  const int ps = (P + PT - 1) / PT;
  const int b = blockIdx.z / ps, p0 = (blockIdx.z % ps) * PT;
  const int grp = h / (H / G);
  const int t0 = c * Q, valid = min(Q, S - t0);
  const size_t row0 = (size_t)b * S + t0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;
  grid_launch_dependents();

  load_tile<T, STATE_WARPS>(xs, LDX, x + (row0 * H + h) * P + p0,
                            (size_t)H * P, Q, valid, min(PT, P - p0), PT,
                            vec_x);
  load_tile<T, STATE_WARPS>(Bs, LDB, Bm + (row0 * G + grp) * N,
                            (size_t)G * N, Q, valid, N, NP, vec_bc);
  cp_async_commit();
  if (warp == 0) chunk_decay(dt + row0 * H + h, H, A[h], valid, a, sw);
  cp_async_wait<0>();
  __syncthreads();
  if (tid < Q) sw[tid] *= expf(a[Q - 1] - a[tid]);
  if (tid == 0 && p0 == 0) decay[((size_t)b * nc + c) * H + h] = expf(a[Q - 1]);
  __syncthreads();

  float* out = dH + (((size_t)b * nc + c) * H + h) * P * N;
  float* st = stage + warp * 16 * LDO;
  const int m0 = warp * 16;
  for (int ng = 0; ng < NP; ng += 64) {
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll 4
    for (int k0 = 0; k0 < Q; k0 += 8) {
      const float s0 = sw[k0 + tq], s1 = sw[k0 + tq + 4];
      const float* x0 = xs + (k0 + tq) * LDX + m0 + gr;
      const float* x1 = x0 + 4 * LDX;
      const float av[4] = {x0[0] * s0, x0[8] * s0, x1[0] * s1, x1[8] * s1};
      uint32_t ah[4], al[4];
      split<4, SPLIT>(av, ah, al);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n0 = ng + nt * 8;
        if (n0 < NP) {
          const float bv[2] = {Bs[(k0 + tq) * LDB + n0 + gr],
                               Bs[(k0 + tq + 4) * LDB + n0 + gr]};
          uint32_t bh[2], bl[2];
          split<2, SPLIT>(bv, bh, bl);
          mma3<SPLIT>(acc[nt], ah, al, bh, bl);
        }
      }
    }
    // through the warp's staging tile, so rows leave in 16-byte pieces
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<float2*>(st + gr * LDO + nt * 8 + 2 * tq) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(st + (gr + 8) * LDO + nt * 8 + 2 * tq) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
    __syncwarp();
    if (vec_h) {                       // N % 4 == 0: rows of float4
      for (int i = lane; i < 16 * 16; i += 32) {
        const int r = i / 16, n = ng + 4 * (i % 16), p = p0 + m0 + r;
        if (p < P && n < N)
          *reinterpret_cast<float4*>(out + (size_t)p * N + n) =
              *reinterpret_cast<const float4*>(st + r * LDO + n - ng);
      }
    } else {
      for (int i = lane; i < 16 * 64; i += 32) {
        const int r = i / 64, n = ng + i % 64, p = p0 + m0 + r;
        if (p < P && n < N) out[(size_t)p * N + n] = st[r * LDO + n - ng];
      }
    }
    __syncwarp();
  }
}

// Pass 2: the states entering each chunk, in chunk order, in place of the
// chunks' own states; the final state.
__global__ void __launch_bounds__(PASS_THREADS)
ssd_state_pass_kernel(float* __restrict__ dH,
                      const float* __restrict__ decay,
                      const float* __restrict__ init,
                      float* __restrict__ state, int H, int PN, int nc) {
  const int e = blockIdx.x * PASS_THREADS + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  const size_t bh = (size_t)b * H + h;
  grid_launch_dependents();
  float hv = init != nullptr ? init[bh * PN + e] : 0.0f;
  grid_dependency_wait();              // the chunks' own states
  for (int c0 = 0; c0 < nc; c0 += 8) {
    float d[8], f[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const size_t bc = ((size_t)b * nc + c0 + k) * H + h;
      d[k] = c0 + k < nc ? dH[bc * PN + e] : 0.0f;
      f[k] = c0 + k < nc ? decay[bc] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c0 + k < nc) {
        dH[(((size_t)b * nc + c0 + k) * H + h) * PN + e] = hv;
        hv = f[k] * hv + d[k];
      }
  }
  state[bh * PN + e] = hv;
}

// Pass 3: y = ((C B^T) o L o dt) x + (C o exp(a)) H_in^T.  Warp w owns the
// 16-row strips w / 4 and 3 - w / 4 and the 8-column tiles w % 4 and
// w % 4 + 4.
template <typename T, bool SPLIT>
__global__ void __launch_bounds__(32 * OUT_WARPS)
ssd_chunk_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const float* __restrict__ Hin,
                     T* __restrict__ y, int S, int H, int G, int P, int N,
                     int nc, int has_init, int vec_x, int vec_bc,
                     int vec_h) {
  const int NP = round_up(N, 8), LDN = ld_rows(NP);
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                  // [Q][LDN]
  float* Bs = Cs + Q * LDN;          // [Q][LDN] B, then H_in (PT rows)
  float* xs = Bs + Q * LDN;          // [Q][LDX]
  float* Ss = xs + Q * LDX;          // [Q][LDS]
  float* a = Ss + Q * LDS;           // [Q]
  float* dts = a + Q;                // [Q]

  const int c = blockIdx.x, h = blockIdx.y;
  const int ps = (P + PT - 1) / PT;
  const int b = blockIdx.z / ps, p0 = (blockIdx.z % ps) * PT;
  const int pw = min(PT, P - p0);
  const int grp = h / (H / G);
  const int t0 = c * Q, valid = min(Q, S - t0);
  const size_t row0 = (size_t)b * S + t0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;
  const int pr = warp >> 2, cq = warp & 3;
  const int strip[2] = {pr, 3 - pr};

  load_tile<T, OUT_WARPS>(Cs, LDN, Cm + (row0 * G + grp) * N, (size_t)G * N,
                          Q, valid, N, NP, vec_bc);
  load_tile<T, OUT_WARPS>(Bs, LDN, Bm + (row0 * G + grp) * N, (size_t)G * N,
                          Q, valid, N, NP, vec_bc);
  load_tile<T, OUT_WARPS>(xs, LDX, x + (row0 * H + h) * P + p0,
                          (size_t)H * P, Q, valid, pw, PT, vec_x);
  cp_async_commit();
  if (warp == 0) chunk_decay(dt + row0 * H + h, H, A[h], valid, a, dts);
  cp_async_wait<0>();
  __syncthreads();

  // S' = (C B^T) o L o dt on the tiles on or below the diagonal
#pragma unroll
  for (int si = 0; si < 2; ++si) {
    const int m0 = 16 * strip[si];
    const int ntn = 2 * strip[si] + 2;      // column tiles touching j <= i
    float acc[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
#pragma unroll 4
    for (int k0 = 0; k0 < NP; k0 += 8) {
      const float* c0 = Cs + (m0 + gr) * LDN + k0 + tq;
      const float av[4] = {c0[0], c0[8 * LDN], c0[4], c0[8 * LDN + 4]};
      uint32_t ah[4], al[4];
      split<4, SPLIT>(av, ah, al);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int nt = cq + 4 * q;
        if (nt < ntn) {
          const float* b0 = Bs + (nt * 8 + gr) * LDN + k0 + tq;
          const float bv[2] = {b0[0], b0[4]};
          uint32_t bh[2], bl[2];
          split<2, SPLIT>(bv, bh, bl);
          mma3<SPLIT>(acc[q], ah, al, bh, bl);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int nt = cq + 4 * q;
      if (nt < ntn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = m0 + gr + 8 * (e / 2);
          const int j = nt * 8 + 2 * tq + (e & 1);
          Ss[i * LDS + j] =
              j <= i ? acc[q][e] * expf(a[i] - a[j]) * dts[j] : 0.0f;
        }
      }
    }
  }
  __syncthreads();                   // S' written; B's tile no longer read

  const bool has_state = c > 0 || has_init;
  grid_dependency_wait();              // the states entering each chunk
  if (has_state)
    load_tile<float, OUT_WARPS>(
        Bs, LDN, Hin + ((((size_t)b * nc + c) * H + h) * P + p0) * N, N, PT,
        pw, N, NP, vec_h);
  cp_async_commit();

  // y = S' x: strip s reads its scores up to column 16 s + 15
  float yacc[2][2][4];
#pragma unroll
  for (int si = 0; si < 2; ++si)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[si][q][e] = 0.0f;
  const int kmax = 16 * strip[1] + 16;      // strip[1] >= strip[0]
#pragma unroll 4
  for (int k0 = 0; k0 < kmax; k0 += 8) {
    uint32_t bh[2][2], bl[2][2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float* x0 = xs + (k0 + tq) * LDX + (cq + 4 * q) * 8 + gr;
      const float bv[2] = {x0[0], x0[4 * LDX]};
      split<2, SPLIT>(bv, bh[q], bl[q]);
    }
#pragma unroll
    for (int si = 0; si < 2; ++si) {
      if (k0 < 16 * strip[si] + 16) {
        const float* s0 = Ss + (16 * strip[si] + gr) * LDS + k0 + tq;
        const float av[4] = {s0[0], s0[8 * LDS], s0[4], s0[8 * LDS + 4]};
        uint32_t ah[4], al[4];
        split<4, SPLIT>(av, ah, al);
#pragma unroll
        for (int q = 0; q < 2; ++q)
          mma3<SPLIT>(yacc[si][q], ah, al, bh[q], bl[q]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // y += (C o exp(a)) H_in^T
  if (has_state) {
    float ea[2][2];
#pragma unroll
    for (int si = 0; si < 2; ++si) {
      ea[si][0] = expf(a[16 * strip[si] + gr]);
      ea[si][1] = expf(a[16 * strip[si] + gr + 8]);
    }
#pragma unroll 4
    for (int k0 = 0; k0 < NP; k0 += 8) {
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float* h0 = Bs + ((cq + 4 * q) * 8 + gr) * LDN + k0 + tq;
        const float bv[2] = {h0[0], h0[4]};
        split<2, SPLIT>(bv, bh[q], bl[q]);
      }
#pragma unroll
      for (int si = 0; si < 2; ++si) {
        const float* c0 = Cs + (16 * strip[si] + gr) * LDN + k0 + tq;
        const float av[4] = {c0[0] * ea[si][0], c0[8 * LDN] * ea[si][1],
                             c0[4] * ea[si][0], c0[8 * LDN + 4] * ea[si][1]};
        uint32_t ah[4], al[4];
        split<4, SPLIT>(av, ah, al);
#pragma unroll
        for (int q = 0; q < 2; ++q)
          mma3<SPLIT>(yacc[si][q], ah, al, bh[q], bl[q]);
      }
    }
  }

#pragma unroll
  for (int si = 0; si < 2; ++si)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * strip[si] + gr + 8 * (e / 2);
        const int p = (cq + 4 * q) * 8 + 2 * tq + (e & 1);
        if (i < valid && p < pw)
          store(y + ((row0 + i) * H + h) * P + p0 + p, yacc[si][q][e]);
      }
}

template <typename T, bool SPLIT>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* init, void* y, void* state,
           void* scratch, int B, int S, int H, int G, int P, int N,
           int vec_x, int vec_bc, int vec_h, cudaStream_t s) {
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_state_kernel<T, SPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(state_smem(MAX_N)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_chunk_out_kernel<T, SPLIT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(out_smem(MAX_N)));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const int nc = (S + Q - 1) / Q, ps = (P + PT - 1) / PT;
  const int NP = round_up(N, 8);
  float* dH = static_cast<float*>(scratch);
  float* decay = dH + (size_t)B * nc * H * P * N;
  const dim3 chunks(nc, H, B * ps);
  ssd_chunk_state_kernel<T, SPLIT>
      <<<chunks, 32 * STATE_WARPS, state_smem(NP), s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm), dH, decay, S,
      H, G, P, N, nc, vec_x, vec_bc, vec_h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_dependent(
      ssd_state_pass_kernel,
      dim3((P * N + PASS_THREADS - 1) / PASS_THREADS, H, B),
      dim3(PASS_THREADS), 0, s, dH, decay, static_cast<const float*>(init),
      static_cast<float*>(state), H, P * N, nc);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dependent(
      ssd_chunk_out_kernel<T, SPLIT>, chunks, dim3(32 * OUT_WARPS),
      out_smem(NP), s, static_cast<const T*>(x),
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(dH), static_cast<T*>(y), S, H, G, P, N, nc,
      static_cast<int>(init != nullptr), vec_x, vec_bc, vec_h));
}

}  // namespace

// init may be null (a zero initial state).  bf16_in selects bf16 x, B, C
// and y; otherwise all four are fp32.  scratch: B * ceil(S / 64) * H *
// (P * N + 1) fp32, not initialised.  vec_x, vec_bc, vec_h: the rows of x,
// of B and C, and of the fp32 states may move in 16-byte pieces.
extern "C" int dmath_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm,
                              const void* init, void* y, void* state,
                              void* scratch, int B, int S, int H, int G,
                              int P, int N, int bf16_in, int vec_x,
                              int vec_bc, int vec_h, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      N <= 0 || N > MAX_N)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_in)
    return launch<bf16, false>(x, dt, A, Bm, Cm, init, y, state, scratch, B,
                               S, H, G, P, N, vec_x, vec_bc, vec_h, s);
  return launch<float, true>(x, dt, A, Bm, Cm, init, y, state, scratch, B, S,
                             H, G, P, N, vec_x, vec_bc, vec_h, s);
}
