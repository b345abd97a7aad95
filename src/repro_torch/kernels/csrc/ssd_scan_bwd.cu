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
// 1. ssd_bwd_state_kernel, a block (one warpgroup) per (half of N, tile
//    of 64 of P, head, batch), the chunks in reverse: the state's
//    gradient from y, dH_c = (dy o exp(a))^T C, as one product a chunk,
//    and in the product's registers the recurrence from G = d_state:
//    dS_c = G (written, the only (P, N) scratch), the total decay's
//    gradient sum(G exp(a_Q,c) H_c) as one partial sum per warp (no
//    block-wide sum), G <- dH_c + exp(a_Q,c) G; d init = G.
// 2. ssd_bwd_chunk_kernel, a block (two warpgroups) per (slice of heads,
//    chunk, batch and group), every chunk at once.  C, B and C B^T are
//    staged once a block; then per head of the slice, in head order:
//      DU = dy u^T, E = dy H_c; M = (C B^T) o L o DU;
//      da_i = sum_j M_ij - sum_k M_ki + exp(a_i) C_i . E_i
//      dC = exp(a) o E + (DU o L) B          (summed over the slice)
//      dB = (DU o L)^T C + w o (u dS^T)^T   (summed over the slice)
//      T = B dS^T;  r_j = w_j u_j . T_j;  du = w o T + ((C B^T) o L)^T dy
//      dx = du dt;  da_j -= r_j;  da_{Q-1} += sum_j r_j + pass 1's partials
//    then d(dt A) as the reverse cumsum of da, ddt = d(dt A) A + du . x,
//    and dA's partial sum of the chunk.  du, the per-head dB and dC, L
//    and the scores never leave the block.  A slice is 3 heads
//    (ssd_scan.py's BWD_HEADS) whatever the call: a call on a mesh rank's
//    half of the heads sums them as the whole call does its first half.
//    At the train shape below, 256 blocks (two waves of 132 SMs); at 24
//    heads, one wave.
// 3. ssd_bwd_sum_kernel: dB and dC over the slices in order, dA over the
//    chunks in order, cast to the outputs' types.
// Passes 2 and 3 are programmatic dependents of the pass before them
// (griddepcontrol): pass 2 stages C, B, C B^T and runs its first head's
// products up to dS before it waits for pass 1.
//
// Nothing is summed across blocks except through scratch in a fixed
// order, and there are no atomics: a run gives the same bits as the last.
// The entries of L above the diagonal are written as 0 without evaluating
// their exponent; each L entry is evaluated once per head.
//
// Products: wgmma m64nNk8 tf32 (hopper.cuh), A from registers (read from
// shared memory in any orientation, so that the operands stored (i, n)
// serve as C and C^T alike) and B from 128-byte-swizzled K-major tiles
// (tf32 has no transposed wgmma operand: a tile needed the other way is
// staged transposed).  fp32 inputs take 3xTF32: a staged B tile holds the
// TF32 head of each value and, beside it, its tail, split once when it
// is staged; an A fragment is split in registers, or read as head and
// tail from such a tile.  bf16 inputs take one TF32 product (bf16 is exact
// in TF32; the fp32 intermediates keep TF32's 10 bits).  The k8 steps of
// a product are pipelined one deep.
//
// Loads: every tile a block reads arrives by TMA (a tensor map for the
// strided dy, x and C tiles, a bulk copy for the contiguous states) on an
// mbarrier while the stage before it computes, issued by one thread;
// threads that issue their own copies (cp.async) stall on the memory
// system's back-pressure, which took ~15% of pass 2 and ~12% of pass 1
// on an H100.  The tiles land as loaded and are converted (tf32 heads
// and tails, transposes, u = dt x) in 16-byte pieces.
//
// What bounds it: at mamba2-780m's train shape (B 2, S 512, H 48, P 64,
// N 128) the kernel executes 5.91 GFLOP of products in full 64-row
// squares (C B^T once per chunk and slice of 3 heads; 6.44 with it once
// per head), x3 for fp32's 3xTF32; roofline.ssd_backward_cost
// counts 4.86 GFLOP, the products on the causal triangle, and the bound
// divides that.  It moves ~0.1 GB of inputs and outputs and ~0.13 GB of
// scratch (dS written and read, H_c read by both passes, the slices' dB
// and dC).  Neither bounds it yet: pass 1 is a chain of 8 dependent chunks
// per block, and pass 2's time is spread over its stages' conversions,
// small products (N of 16 to 64) and barriers.
// N is at most 128, held as 128 with zeros past N (a state of 64 does the
// work of 128); P is at most 512.
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ssd_scan.cuh"

// Phase marks for scripts/ssd_bwd_phases.py, compiled in only with
// -DSSD_BWD_PHASES (they are empty otherwise): thread 0 of each block adds
// the cycles since its last mark to the phase PHASE(k) closes, per kernel
// K (0 the chunk pass, 1 the state pass), read back by dmath_phase_read.
#ifdef SSD_BWD_PHASES
__device__ unsigned long long g_phase[2][4096][32];
#define PHASE_INIT(K)                                                 \
  unsigned long long _pt = clock64();                                \
  const int _K = K;                                                   \
  const int _bid =                                                    \
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
#define PHASE(k)                                                      \
  if (threadIdx.x == 0) {                                             \
    unsigned long long _n = clock64();                                \
    g_phase[_K][_bid & 4095][k] += _n - _pt;                          \
    _pt = _n;                                                         \
  }
extern "C" int dmath_phase_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_phase, sizeof(g_phase));
}
extern "C" int dmath_phase_zero() {
  static unsigned long long z[2][4096][32];
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
}
#else
#define PHASE_INIT(K)
#define PHASE(k)
#endif

namespace {

using namespace ssd;

constexpr int Q = 64;              // the forward's chunk
constexpr int PT = 32;             // pass 2's tile of P
constexpr int SPT = 64;            // pass 1's tile of P (its products' M)
constexpr int THREADS = 256;       // pass 2: two warpgroups
constexpr int STATE_THREADS = 128;  // pass 1: one warpgroup
constexpr int PASS_THREADS = 256;
constexpr int MAX_N = 128;
constexpr int NP = MAX_N;          // N as the kernels hold it, zero-padded
constexpr int LDQ = Q + 4;         // 64 x 64 fp32 tiles
constexpr int LDY = SPT + 8;       // pass 1's dy tile, read down its columns
constexpr int LDX = PT + 4;        // pass 2's x tile
constexpr int REGION = 65536;      // pass 2's staged operands (bytes)
constexpr int MAX_PART = 64;       // pass 1's partial sums of a chunk

// A K-major tile of tf32 operands as wgmma reads B: rows of 32 values
// (128 bytes), 128-byte swizzled, in boxes of 32 columns ``box`` bytes
// apart (rows * 128), the tails (3xTF32) ``lo`` bytes after the heads.
struct KTile {
  char* base;
  int box, lo;

  __device__ __forceinline__ int off(int r, int k) const {
    return (k >> 5) * box + swz128(r, (k & 31) >> 2) + (k & 3) * 4;
  }
  template <bool SPLIT>
  __device__ __forceinline__ void put(int r, int k, float v) const {
    char* p = base + off(r, k);
    const uint32_t h = tf32_rna(v);
    *reinterpret_cast<uint32_t*>(p) = h;
    if (SPLIT)
      *reinterpret_cast<uint32_t*>(p + lo) =
          tf32_rna(v - __uint_as_float(h));
  }
  // four values at k .. k + 3 (k a multiple of 4): one 16-byte store each
  // of the heads and the tails
  template <bool SPLIT>
  __device__ __forceinline__ void put4(int r, int k, float4 v) const {
    char* p = base + off(r, k);
    const uint4 h = make_uint4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z),
                               tf32_rna(v.w));
    *reinterpret_cast<uint4*>(p) = h;
    if (SPLIT)
      *reinterpret_cast<uint4*>(p + lo) = make_uint4(
          tf32_rna(v.x - __uint_as_float(h.x)),
          tf32_rna(v.y - __uint_as_float(h.y)),
          tf32_rna(v.z - __uint_as_float(h.z)),
          tf32_rna(v.w - __uint_as_float(h.w)));
  }
  template <bool SPLIT>
  __device__ __forceinline__ void get(int r, int k, uint32_t& h,
                                      uint32_t& l) const {
    const char* p = base + off(r, k);
    h = *reinterpret_cast<const uint32_t*>(p);
    if (SPLIT) l = *reinterpret_cast<const uint32_t*>(p + lo);
  }
  // the descriptor of rows row0.. (a multiple of 8) at the k8 step kk
  __device__ __forceinline__ uint64_t desc(int row0, int kk, bool tail) const {
    return make_desc(base + (tail ? lo : 0) + (kk >> 2) * box + row0 * 128 +
                         (kk & 3) * 32,
                     16, 1024);
  }
};

// four consecutive values of a 16-byte-aligned (fp32) or 8-byte-aligned
// (bf16) run in shared memory, as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

template <bool SPLIT>
__device__ __forceinline__ void tf32_split(float v, uint32_t& h,
                                           uint32_t& l) {
  h = tf32_rna(v);
  if (SPLIT) l = tf32_rna(v - __uint_as_float(h));
}

// The warpgroup's acc (NT / 2 per thread) = [acc +] A B: A the 64 x 8 KS
// rows of this warpgroup's product, A(r, k) from fa(r, k, head, tail); B
// the 8 KS x NT operand at rows brow.. of the K-major tile b.  The k8
// steps are pipelined one deep (a step's fragments are loaded while the
// step before it runs); the call returns with every product finished.
template <int NT, int KS, bool SPLIT, typename FA>
__device__ __forceinline__ void wg_mma(float* acc, const FA& fa,
                                       const KTile& b, int brow, bool zero) {
  const int lane = threadIdx.x & 31;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2), c = lane & 3;
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int s = kk & 1, k = 8 * kk + c;
    fa(r, k, ah[s][0], al[s][0]);
    fa(r + 8, k, ah[s][1], al[s][1]);
    fa(r, k + 4, ah[s][2], al[s][2]);
    fa(r + 8, k + 4, ah[s][3], al[s][3]);
    const int sc = zero && kk == 0 ? 0 : 1;
    wg_fence();
    if constexpr (SPLIT) {
      wgmma_tf32<NT>(acc, al[s], b.desc(brow, kk, false), sc);
      wgmma_tf32<NT>(acc, ah[s], b.desc(brow, kk, true), 1);
      wgmma_tf32<NT>(acc, ah[s], b.desc(brow, kk, false), 1);
    } else {
      wgmma_tf32<NT>(acc, ah[s], b.desc(brow, kk, false), sc);
    }
    wg_commit();
    if (kk > 0) {
      wg_wait_one();
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        fence_u32(ah[s ^ 1][e]);
        if (SPLIT) fence_u32(al[s ^ 1][e]);
      }
    }
  }
  wg_wait_all();
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    fence_u32(ah[(KS - 1) & 1][e]);
    if (SPLIT) fence_u32(al[(KS - 1) & 1][e]);
  }
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) fence_reg(acc[i]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum over the 8 lanes of a quad column (same lane % 4)
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// sum over the 4 lanes of a quad (same lane / 4)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

template <typename T>
__device__ __forceinline__ T zero_of() {
  if constexpr (sizeof(T) == 4) return 0.0f;
  else return __float2bfloat16(0.0f);
}

// ROWS x COLS of a row-major global array (row stride ``stride``) into
// shared memory (row stride ``ld``) in the source's type, zeros at rows
// >= n_rows and columns >= n_cols.  ``vec``: 16-byte cp.async (rows
// 16-byte aligned, n_cols whole 16-byte pieces), committed by the caller;
// otherwise element by element, at once.
template <typename T, int ROWS, int COLS, int NT>
__device__ __forceinline__ void stage_raw(T* dst, int ld, const T* src,
                                          size_t stride, int n_rows,
                                          int n_cols, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T), PR = COLS / E;
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * PR; i += NT) {
      const int r = i / PR, c = (i % PR) * E;
      const bool ok = r < n_rows && c < n_cols;
      cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS;
      dst[r * ld + c] =
          r < n_rows && c < n_cols ? src[r * stride + c] : zero_of<T>();
    }
  }
}

// The chunk's dt (stride H) into shared memory, zeros past ``valid``, by
// the threads of warp ``warp``, two steps a lane.
__device__ __forceinline__ void stage_dt(float* dst, const float* src,
                                         int H, int valid, int warp) {
  if (static_cast<int>(threadIdx.x) >> 5 == warp)
    for (int j = threadIdx.x & 31; j < Q; j += 32)
      cp_async4(dst + j, j < valid ? src + (size_t)j * H : src, j < valid);
}

// a (the inclusive cumsum of dt A), dt, exp(a) and exp(a_Q - a) of the
// chunk, by one warp from its dt in shared memory.
__device__ __forceinline__ void decays(const float* rdt, float Ah, int valid,
                                       float* a, float* dts, float* ea,
                                       float* w) {
  chunk_decay(rdt, 1, Ah, valid, a, dts);
  __syncwarp();
  const float aq = a[Q - 1];
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int j = 2 * lane + k;
    ea[j] = expf(a[j]);
    w[j] = expf(aq - a[j]);
  }
}

// pass 1's buffer of a chunk's dy, C and dt as they land
template <typename T>
constexpr int STATE_RAW = sizeof(T) * Q * (LDY + NP / 2) + sizeof(float) * Q;

template <typename T>
constexpr size_t STATE_SMEM =
    1024 + 4 * (NP / 2) * 128 + sizeof(float) * 3 * Q + 2 * STATE_RAW<T>;

template <typename T>
constexpr size_t CHUNK_SMEM =
    1024 + REGION +
    sizeof(float) * (2 * Q * (NP + 4) + 2 * Q * LDQ + 27 * Q + Q * LDX +
                     MAX_PART + PT * NP) +
    sizeof(T) * 2 * Q * PT;

// Pass 1 (the states'): see the note at the top.  dS has the forward's
// (B, nc, H, P, N) layout; daq_part (B, nc, H, 4 gridDim.x).  A chunk's
// dy and C tiles arrive by TMA into one of two buffers (dt by cp.async)
// while the chunk before it computes, and the product reads dy where it
// landed; its entering state is read into registers a chunk ahead.
template <typename T, bool SPLIT>
__global__ void __launch_bounds__(STATE_THREADS)
ssd_bwd_state_kernel(const __grid_constant__ CUtensorMap map_dy,
                     const __grid_constant__ CUtensorMap map_c,
                     const T* __restrict__ dy, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Cm,
                     const float* __restrict__ Hin,
                     const float* __restrict__ decay,
                     const float* __restrict__ dstate,
                     float* __restrict__ dS, float* __restrict__ dinit,
                     float* __restrict__ daq_part, int S, int H, int G,
                     int P, int N, int nc, int tma) {
  constexpr int NH = NP / 2;          // the block's columns of N
  constexpr int RAW = STATE_RAW<T>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar[2];
  uint8_t* sm = align1024(smem_raw);
  const KTile ct{reinterpret_cast<char*>(sm), NH * 128, 2 * NH * 128};
  float* a = reinterpret_cast<float*>(sm + 4 * NH * 128);
  float* dts = a + Q;
  float* ea = dts + Q;
  uint8_t* raw = reinterpret_cast<uint8_t*>(ea + Q);  // [2][RAW]: a chunk's
                                                      // dy [Q][LDY], C
                                                      // [Q][NH], dt [Q]
  auto rdy = [&](int c) { return reinterpret_cast<T*>(raw + (c & 1) * RAW); };
  auto rc = [&](int c) { return rdy(c) + Q * LDY; };
  auto rdt = [&](int c) { return reinterpret_cast<float*>(rc(c) + Q * NH); };

  const int n0 = (blockIdx.x & 1) * NH, p0 = (blockIdx.x >> 1) * SPT;
  const int h = blockIdx.y, b = blockIdx.z, grp = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int pw = min(SPT, P - p0), nw = min(NH, N - n0);
  const size_t PN = (size_t)P * N, bh = (size_t)b * H + h;
  const int npart = 4 * gridDim.x;
  uint32_t phase[2] = {0, 0};
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  grid_launch_dependents();
  PHASE_INIT(1)

  auto issue = [&](int c) {
    const int t0 = c * Q, valid = min(Q, S - t0);
    const size_t row0 = (size_t)b * S + t0;
    if (tma) {
      if (tid == 0) {
        mbar_expect_tx(&bar[c & 1], sizeof(T) * Q * (LDY + NH));
        tma_load_2d(rdy(c), &map_dy, &bar[c & 1], h * P + p0, (int)row0);
        tma_load_2d(rc(c), &map_c, &bar[c & 1], grp * N + n0, (int)row0);
      }
    } else {
      stage_raw<T, Q, SPT, STATE_THREADS>(
          rdy(c), LDY, dy + row0 * H * P + (size_t)h * P + p0,
          (size_t)H * P, valid, pw, false);
      stage_raw<T, Q, NH, STATE_THREADS>(
          rc(c), NH, Cm + row0 * G * N + (size_t)grp * N + n0,
          (size_t)G * N, valid, nw, false);
      if (tid == 0) mbar_expect_tx(&bar[c & 1], 0);
    }
    stage_dt(rdt(c), dt + row0 * H + h, H, valid, 0);
    cp_async_commit();
  };

  // pairs of columns (n, n + 1) of the thread's rows of a (P, N) array:
  // read, written (as 8 bytes where N is even)
  auto at = [&](int q, int r) {
    return (size_t)(p0 + 16 * warp + gq + 8 * r) * N + n0 + 8 * q + 2 * tq;
  };
  auto ok = [&](int q, int r, int k) {
    return p0 + 16 * warp + gq + 8 * r < P && n0 + 8 * q + 2 * tq + k < N;
  };
  auto read2 = [&](const float* src, int q, int r, float* v) {
    if (N % 2 == 0 && ok(q, r, 1)) {
      const float2 u = *reinterpret_cast<const float2*>(src + at(q, r));
      v[0] = u.x;
      v[1] = u.y;
    } else {
      v[0] = ok(q, r, 0) ? src[at(q, r)] : 0.0f;
      v[1] = ok(q, r, 1) ? src[at(q, r) + 1] : 0.0f;
    }
  };
  auto write2 = [&](float* dst, int q, int r, float v0, float v1) {
    if (N % 2 == 0 && ok(q, r, 1)) {
      *reinterpret_cast<float2*>(dst + at(q, r)) = make_float2(v0, v1);
    } else {
      if (ok(q, r, 0)) dst[at(q, r)] = v0;
      if (ok(q, r, 1)) dst[at(q, r) + 1] = v1;
    }
  };

  issue(nc - 1);
  // G in the accumulator's layout (rows p, columns n), and the entering
  // state and total decay of the chunk next in line
  float gacc[NH / 2], hv[NH / 2];
  float fn = decay[((size_t)b * nc + nc - 1) * H + h];
#pragma unroll
  for (int q = 0; q < NH / 8; ++q)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (dstate != nullptr) read2(dstate + bh * PN, q, r, gacc + 4 * q + 2 * r);
      else gacc[4 * q + 2 * r] = gacc[4 * q + 2 * r + 1] = 0.0f;
      read2(Hin + (((size_t)b * nc + nc - 1) * H + h) * PN, q, r,
            hv + 4 * q + 2 * r);
    }

  for (int c = nc - 1; c >= 0; --c) {
    const int valid = min(Q, S - c * Q);
    const size_t bch = ((size_t)b * nc + c) * H + h;
    const float f = fn;
    if (c > 0) fn = decay[bch - H];
    PHASE(1)
    mbar_wait(&bar[c & 1], phase[c & 1]);
    phase[c & 1] ^= 1;
    cp_async_wait<0>();
    T* cy = rdy(c);
    T* cc = rc(c);
    if (tma && (valid < Q || pw < SPT || nw < NH)) {
      // the boxes reach past the chunk, P or N: zeros there
      for (int e = tid; e < Q * LDY; e += STATE_THREADS)
        if (e / LDY >= valid || e % LDY >= pw) cy[e] = zero_of<T>();
      for (int e = tid; e < Q * NH; e += STATE_THREADS)
        if (e / NH >= valid || e % NH >= nw) cc[e] = zero_of<T>();
    }
    __syncthreads();                 // the chunk's inputs are in; the last
                                     // chunk's product is done
    for (int e = tid; e < NH * Q / 4; e += STATE_THREADS) {
      const int n = e % NH, i = 4 * (e / NH);
      ct.put4<SPLIT>(n, i, make_float4(to_f(cc[i * NH + n]),
                                       to_f(cc[(i + 1) * NH + n]),
                                       to_f(cc[(i + 2) * NH + n]),
                                       to_f(cc[(i + 3) * NH + n])));
    }
    if (warp == 0) {
      chunk_decay(rdt(c), 1, A[h], valid, a, dts);
      ea[2 * lane] = expf(a[2 * lane]);
      ea[2 * lane + 1] = expf(a[2 * lane + 1]);
    }
    fence_proxy_async();
    __syncthreads();
    PHASE(2)
    if (c > 0) issue(c - 1);
    PHASE(3)

    float acc[NH / 2];
    wg_mma<NH, Q / 8, SPLIT>(
        acc,
        [&](int p, int i, uint32_t& hi, uint32_t& lo) {
          tf32_split<SPLIT>(to_f(cy[i * LDY + p]) * ea[i], hi, lo);
        },
        ct, 0, true);
    PHASE(4)

    float v = 0.0f;
#pragma unroll
    for (int q = 0; q < NH / 8; ++q)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float* g = gacc + 4 * q + 2 * r;
        v += g[0] * f * hv[4 * q + 2 * r] + g[1] * f * hv[4 * q + 2 * r + 1];
        write2(dS + bch * PN, q, r, g[0], g[1]);
        g[0] = acc[4 * q + 2 * r] + f * g[0];
        g[1] = acc[4 * q + 2 * r + 1] + f * g[1];
        if (c > 0) read2(Hin + (bch - H) * PN, q, r, hv + 4 * q + 2 * r);
      }
    v = warp_sum(v);
    if (lane == 0) daq_part[bch * npart + 4 * blockIdx.x + warp] = v;
    PHASE(5)
  }
  if (dinit != nullptr) {
#pragma unroll
    for (int q = 0; q < NH / 8; ++q)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        write2(dinit + bh * PN, q, r, gacc[4 * q + 2 * r],
               gacc[4 * q + 2 * r + 1]);
  }
}

// Pass 2 (the chunks'): see the note at the top.  Warpgroup wg takes
// columns 32 wg.. of the (i, j) products, rows 16 wg.. of P's tile in the
// (j, p) ones, and rows 64 wg.. of N in the (n, .) ones (those of dB and
// dC, which it sums over the slice's heads in registers).  dBp and dCp
// are (slices, B, nc * Q, G, N) fp32, dA_part (B, nc, H).  A head's work
// runs in stages, one per 32 columns of P for its products with H_c (dy,
// x and H_c staged) and again for those with dS (dy, x and dS): four at
// P = 64.  Each stage's inputs arrive by TMA in one raw buffer while the
// stage before it computes.
template <typename T, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_chunk_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_dy,
                     const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const T* __restrict__ dy,
                     const float* __restrict__ Hin,
                     const float* __restrict__ dS,
                     const float* __restrict__ daq_part,
                     T* __restrict__ dx, float* __restrict__ ddt,
                     float* __restrict__ dA_part, float* __restrict__ dBp,
                     float* __restrict__ dCp, int Bsz, int S, int H, int G,
                     int P, int N, int nc, int hps, int npart, int vec_x,
                     int vec_bc, int vec_h) {
  constexpr int LDN = NP + 4;       // C and B, read along and down rows
  constexpr int LDH = NP + 8;       // H_c's tile, read down its columns
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  char* R = reinterpret_cast<char*>(sm);
  float* Cp = reinterpret_cast<float*>(sm + REGION);  // [Q][LDN]
  float* Bp = Cp + Q * LDN;          // [Q][LDN]
  float* CB = Bp + Q * LDN;          // [Q][LDQ] C B^T
  float* CBL = CB + Q * LDQ;         // [Q][LDQ] the head's (C B^T) o L
  float* vecs = CBL + Q * LDQ;       // [2][4][Q] two heads' a, dt,
                                     // exp(a), exp(a_Q - a)
  float* rowM = vecs + 8 * Q;        // [2][Q]
  float* colM = rowM + 2 * Q;        // [4][Q]
  float* ce = colM + 4 * Q;          // [8][Q] C_i . E_i by warp
  float* rp = ce + 8 * Q;            // [2][Q] x_j . T_j by warpgroup
  float* xd = rp + 2 * Q;            // [2][Q] du_j . x_j by warpgroup
  float* xs = xd + 2 * Q;            // [Q][LDX] x's tile, fp32
  float* rdt = xs + Q * LDX;         // raw: [Q] the next head's dt
  float* rdaq = rdt + Q;             // raw: [MAX_PART] pass 1's partials
  float* rbig = rdaq + MAX_PART;     // raw: [PT][NP] H_c's or dS's rows
  T* rdy = reinterpret_cast<T*>(rbig + PT * NP);  // raw: [Q][PT] dy
  T* rx = rdy + Q * PT;              // raw: [Q][PT] x

  // the staged operands in R, by phase
  const KTile Bt{R, 8192, NP * 256};              // B: rows j, K n
  const KTile dyk{R, 8192, 8192};                 // dy: rows i, K p
  const KTile uk{R + 16384, 8192, 8192};          // u: rows j, K p
  float* Hs = reinterpret_cast<float*>(R + 32768);  // [PT][LDH] H_c's rows
  const KTile DUL{R, 8192, 16384};                // DU o L: rows i, K j
  const KTile DULT{R + 32768, 8192, 16384};       // (DU o L)^T: rows j, K i
  const KTile dSk{R, 4096, NP * 128};             // dS: rows p, K n
  const KTile dyT{R + 32768, 4096, 8192};         // dy^T: rows p, K i
  const KTile uk2{R + 49152, 8192, 8192};         // w o u: rows j, K p

  const int slice = blockIdx.x, c = blockIdx.y;
  const int b = blockIdx.z / G, grp = blockIdx.z % G;
  const int rep = H / G, h0 = grp * rep + slice * hps;
  const int h1 = min(grp * rep + rep, h0 + hps);
  const int t0 = c * Q, valid = min(Q, S - t0);
  const size_t row0 = (size_t)b * S + t0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wq = warp & 3, gq = lane >> 2, tq = lane & 3;
  const int nw = 64 * wg;
  grid_launch_dependents();
  PHASE_INIT(0)

  // a stage's inputs into the raw buffer, completing on ``bar``: head h,
  // P's tile p0, H_c (the chunk states' stages) or dS and pass 1's partial
  // sums (the outputs' ones).  By TMA from one thread: dy's and x's tiles
  // through their tensor maps (rows past the chunk or columns past P, which
  // the box may cover, are zeroed once they land), the states' rows as one
  // bulk copy where N fills them (else a copy a row, the rest zeros);
  // without 16-byte rows, element by element.  The head's dt comes with
  // its first stage, by cp.async from warp 1.
  __shared__ uint64_t bar;
  uint32_t phase = 0;
  const bool bulk = vec_x && vec_h;
  if (tid == 0) {
    mbar_init(&bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int h, bool state, int p0) {
    const size_t bch = ((size_t)b * nc + c) * H + h;
    const size_t xo = row0 * H * P + (size_t)h * P + p0;
    const float* big = (state ? dS : Hin) + (bch * P + p0) * N;
    const int pw = min(PT, P - p0);
    if (bulk) {
      if (tid == 0) {
        mbar_expect_tx(&bar, 2 * Q * PT * sizeof(T) + 4 * pw * N +
                                 (state && p0 == 0 ? 4 * npart : 0));
        tma_load_2d(rdy, &map_dy, &bar, h * P + p0, (int)row0);
        tma_load_2d(rx, &map_x, &bar, h * P + p0, (int)row0);
        if (N == NP) bulk_load(rbig, big, 4 * pw * N, &bar);
        if (state && p0 == 0)
          bulk_load(rdaq, daq_part + bch * npart, 4 * npart, &bar);
      }
      if (N < NP && tid < pw)
        bulk_load(rbig + tid * NP, big + (size_t)tid * N, 4 * N, &bar);
      if (pw < PT || N < NP)
        for (int e = tid; e < PT * NP; e += THREADS)
          if (e / NP >= pw || e % NP >= N) rbig[e] = 0.0f;
    } else {
      stage_raw<T, Q, PT, THREADS>(rdy, PT, dy + xo, (size_t)H * P, valid,
                                   pw, false);
      stage_raw<T, Q, PT, THREADS>(rx, PT, x + xo, (size_t)H * P, valid, pw,
                                   false);
      stage_raw<float, PT, NP, THREADS>(rbig, NP, big, N, pw, N, false);
      if (state && p0 == 0)
        for (int k = tid; k < npart; k += THREADS)
          rdaq[k] = daq_part[bch * npart + k];
      if (tid == 0) mbar_expect_tx(&bar, 0);
    }
    if (!state && p0 == 0) stage_dt(rdt, dt + row0 * H + h, H, valid, 1);
    cp_async_commit();
  };
  // the next stage (of P's tile p0) is in and every thread is done with R
  // and the raw tiles
  auto landed = [&](int p0) {
    mbar_wait(&bar, phase);
    phase ^= 1;
    const int pw = min(PT, P - p0);
    if (bulk && (valid < Q || pw < PT))
      for (int e = tid; e < Q * PT; e += THREADS)
        if (e / PT >= valid || e % PT >= pw) rdy[e] = rx[e] = zero_of<T>();
    __syncthreads();
  };

  // C and B through R, as the source's type; the first stage meanwhile
  {
    T* rC = reinterpret_cast<T*>(R);
    T* rB = rC + Q * NP;
    const size_t go = row0 * G * N + (size_t)grp * N;
    stage_raw<T, Q, NP, THREADS>(rC, NP, Cm + go, (size_t)G * N, valid, N,
                                 vec_bc);
    stage_raw<T, Q, NP, THREADS>(rB, NP, Bm + go, (size_t)G * N, valid, N,
                                 vec_bc);
    cp_async_commit();
    issue(h0, false, 0);
    cp_async_wait<1>();
    __syncthreads();
    for (int e = tid; e < Q * NP; e += THREADS) {
      const int i = e / NP, n = e % NP;
      Cp[i * LDN + n] = to_f(rC[e]);
      Bp[i * LDN + n] = to_f(rB[e]);
    }
    if (warp == 1) {                 // the first head's decays
      cp_async_wait<0>();
      __syncwarp();
      decays(rdt, A[h0], valid, vecs, vecs + Q, vecs + 2 * Q, vecs + 3 * Q);
    }
    __syncthreads();
  }
  for (int e = tid; e < Q * NP / 4; e += THREADS) {
    const int j = e / (NP / 4), n = 4 * (e % (NP / 4));
    Bt.put4<SPLIT>(j, n, load4(Bp + j * LDN + n));
  }
  fence_proxy_async();
  __syncthreads();
  {  // C B^T, columns 32 wg..
    float acc[16];
    wg_mma<32, NP / 8, SPLIT>(
        acc,
        [&](int i, int n, uint32_t& hi, uint32_t& lo) {
          tf32_split<SPLIT>(Cp[i * LDN + n], hi, lo);
        },
        Bt, 32 * wg, true);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        CB[(16 * wq + gq + 8 * (e >> 1)) * LDQ + 32 * wg + 8 * q + 2 * tq +
           (e & 1)] = acc[4 * q + e];
  }

  PHASE(1)
  float dCs[32], dBs[32];            // the slice's sums: rows n, columns i/j
#pragma unroll
  for (int i = 0; i < 32; ++i) dCs[i] = dBs[i] = 0.0f;

  for (int h = h0; h < h1; ++h) {
    const size_t bch = ((size_t)b * nc + c) * H + h;
    float* a = vecs + ((h - h0) & 1) * 4 * Q;  // this head's decays
    float* dts = a + Q;
    float* ea = dts + Q;
    float* w = ea + Q;
    landed(0);                       // the first stage is in; R is free
    PHASE(2)

    // ---- DU = dy u^T and E^T = H_c^T dy^T over P's tiles ----
    float du_acc[16], e_acc[32];
    for (int p0 = 0; p0 < P; p0 += PT) {
      if (p0 > 0) landed(p0);
      for (int e = tid; e < Q * PT / 4; e += THREADS) {
        const int i = e / (PT / 4), kp = 4 * (e % (PT / 4));
        dyk.put4<SPLIT>(i, kp, load4(rdy + i * PT + kp));
        uk.put4<SPLIT>(i, kp, scale4(load4(rx + i * PT + kp), dts[i]));
      }
      for (int e = tid; e < PT * NP / 4; e += THREADS) {
        const int kp = e / (NP / 4), n = 4 * (e % (NP / 4));
        *reinterpret_cast<float4*>(Hs + kp * LDH + n) =
            load4(rbig + kp * NP + n);
      }
      fence_proxy_async();
      __syncthreads();
      PHASE(3)
      if (p0 + PT < P) issue(h, false, p0 + PT);
      PHASE(4)
      wg_mma<32, PT / 8, SPLIT>(
          du_acc,
          [&](int i, int kp, uint32_t& hi, uint32_t& lo) {
            dyk.get<SPLIT>(i, kp, hi, lo);
          },
          uk, 32 * wg, p0 == 0);
      wg_mma<64, PT / 8, SPLIT>(
          e_acc,
          [&](int n, int kp, uint32_t& hi, uint32_t& lo) {
            tf32_split<SPLIT>(Hs[kp * LDH + nw + n], hi, lo);
          },
          dyk, 0, p0 == 0);
    }
    PHASE(5)
    __syncthreads();                 // R: DU o L and its transpose next

    // ---- C_i . E_i ----
    {
      float part[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) part[i] = 0.0f;
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = nw + 16 * wq + gq + 8 * (e >> 1);
          const int i = 8 * q + 2 * tq + (e & 1);
          part[2 * q + (e & 1)] += Cp[i * LDN + n] * e_acc[4 * q + e];
        }
#pragma unroll
      for (int i = 0; i < 16; ++i) part[i] = col_sum(part[i]);
      if (gq == 0)
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int k = 0; k < 2; ++k)
            ce[warp * Q + 8 * q + 2 * tq + k] = part[2 * q + k];
    }
    // ---- L once: (C B^T) o L, DU o L (both ways), M's sums ----
    {
      float rs[2] = {0.0f, 0.0f}, cs[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) cs[i] = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * wq + gq + 8 * (e >> 1);
          const int j = 32 * wg + 8 * q + 2 * tq + (e & 1);
          float cbl = 0.0f, dul = 0.0f;
          if (j <= i) {
            const float l = expf(a[i] - a[j]);
            cbl = CB[i * LDQ + j] * l;
            dul = du_acc[4 * q + e] * l;
          }
          const float m = cbl * du_acc[4 * q + e];
          CBL[i * LDQ + j] = cbl;
          DUL.put<SPLIT>(i, j, dul);
          DULT.put<SPLIT>(j, i, dul);
          rs[e >> 1] += m;
          cs[2 * q + (e & 1)] += m;
        }
      rs[0] = quad_sum(rs[0]);
      rs[1] = quad_sum(rs[1]);
#pragma unroll
      for (int i = 0; i < 8; ++i) cs[i] = col_sum(cs[i]);
      if (tq == 0) {
        rowM[wg * Q + 16 * wq + gq] = rs[0];
        rowM[wg * Q + 16 * wq + gq + 8] = rs[1];
      }
      if (gq == 0)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int k = 0; k < 2; ++k)
            colM[wq * Q + 32 * wg + 8 * q + 2 * tq + k] = cs[2 * q + k];
    }
    PHASE(6)
    fence_proxy_async();
    __syncthreads();
    grid_dependency_wait();          // pass 1's dS and partial sums
    issue(h, true, 0);
    PHASE(7)

    // ---- dC^T = exp(a) o E^T + B^T (DU o L)^T;  dB^T = C^T (DU o L) ----
    float b_acc[32];
    wg_mma<64, Q / 8, SPLIT>(
        b_acc,
        [&](int n, int j, uint32_t& hi, uint32_t& lo) {
          tf32_split<SPLIT>(Bp[j * LDN + nw + n], hi, lo);
        },
        DUL, 0, true);
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dCs[4 * q + e] += ea[8 * q + 2 * tq + (e & 1)] * e_acc[4 * q + e] +
                          b_acc[4 * q + e];
    wg_mma<64, Q / 8, SPLIT>(
        b_acc,
        [&](int n, int i, uint32_t& hi, uint32_t& lo) {
          tf32_split<SPLIT>(Cp[i * LDN + nw + n], hi, lo);
        },
        DULT, 0, true);

    PHASE(8)
    // ---- T = B dS^T, du, dx; dB^T's state term, over P's tiles ----
    float rpart[2] = {0.0f, 0.0f}, xpart[2] = {0.0f, 0.0f};
    for (int p0 = 0; p0 < P; p0 += PT) {
      landed(p0);                    // the stage is in; R is free
      PHASE(9)
      for (int e = tid; e < PT * NP / 4; e += THREADS) {
        const int kp = e / (NP / 4), n = 4 * (e % (NP / 4));
        dSk.put4<SPLIT>(kp, n, load4(rbig + kp * NP + n));
      }
      for (int e = tid; e < Q * PT / 4; e += THREADS) {
        const int i = e / (PT / 4), kp = 4 * (e % (PT / 4));
        const float4 xv = load4(rx + i * PT + kp);
        uk2.put4<SPLIT>(i, kp, scale4(xv, w[i] * dts[i]));
        *reinterpret_cast<float4*>(xs + i * LDX + kp) = xv;
      }
      for (int e = tid; e < Q * PT / 4; e += THREADS) {
        const int kp = e % PT, i = 4 * (e / PT);
        dyT.put4<SPLIT>(kp, i, make_float4(to_f(rdy[i * PT + kp]),
                                           to_f(rdy[(i + 1) * PT + kp]),
                                           to_f(rdy[(i + 2) * PT + kp]),
                                           to_f(rdy[(i + 3) * PT + kp])));
      }
      fence_proxy_async();
      __syncthreads();
      PHASE(10)
      if (p0 + PT < P) issue(h, true, p0 + PT);
      else if (h + 1 < h1) issue(h + 1, false, 0);
      PHASE(11)
      float t_acc[8], u_acc[8];      // T and du's term from y
      wg_mma<16, NP / 8, SPLIT>(
          t_acc,
          [&](int j, int n, uint32_t& hi, uint32_t& lo) {
            tf32_split<SPLIT>(Bp[j * LDN + n], hi, lo);
          },
          dSk, 16 * wg, true);
      PHASE(12)
      wg_mma<16, Q / 8, SPLIT>(
          u_acc,
          [&](int j, int i, uint32_t& hi, uint32_t& lo) {
            tf32_split<SPLIT>(CBL[i * LDQ + j], hi, lo);
          },
          dyT, 16 * wg, true);
      PHASE(13)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 16 * wq + gq + 8 * (e >> 1);
          const int p = 16 * wg + 8 * q + 2 * tq + (e & 1);
          const float xv = xs[j * LDX + p], t = t_acc[4 * q + e];
          const float d = u_acc[4 * q + e] + w[j] * t;
          rpart[e >> 1] += xv * t;
          xpart[e >> 1] += d * xv;
          if (j < valid && p0 + p < P)
            store(dx + (row0 + j) * H * P + (size_t)h * P + p0 + p,
                  d * dts[j]);
        }
      wg_mma<64, PT / 8, SPLIT>(
          b_acc,
          [&](int n, int kp, uint32_t& hi, uint32_t& lo) {
            dSk.get<SPLIT>(kp, nw + n, hi, lo);
          },
          uk2, 0, false);
      PHASE(14)
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) dBs[i] += b_acc[i];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      rpart[k] = quad_sum(rpart[k]);
      xpart[k] = quad_sum(xpart[k]);
    }
    if (tq == 0)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        rp[wg * Q + 16 * wq + gq + 8 * k] = rpart[k];
        xd[wg * Q + 16 * wq + gq + 8 * k] = xpart[k];
      }
    __syncthreads();

    PHASE(15)
    // ---- da, its reverse cumsum, ddt and dA's partial (one warp); the
    // next head's decays (another) ----
    if (warp == 1 && h + 1 < h1) {
      cp_async_wait<0>();
      __syncwarp();
      float* an = vecs + ((h + 1 - h0) & 1) * 4 * Q;
      decays(rdt, A[h + 1], valid, an, an + Q, an + 2 * Q, an + 3 * Q);
    }
    if (warp == 0) {
      float d[2], r[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int j = 2 * lane + k;
        float cm = 0.0f, cv = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) cm += colM[q * Q + j];
#pragma unroll
        for (int q = 0; q < 8; ++q) cv += ce[q * Q + j];
        r[k] = w[j] * dts[j] * (rp[j] + rp[Q + j]);
        d[k] = rowM[j] + rowM[Q + j] - cm + ea[j] * cv - r[k];
      }
      const float rtot = warp_sum(r[0] + r[1]);
      if (lane == 31) {
        float qs = rtot;
        for (int k = 0; k < npart; ++k) qs += rdaq[k];
        d[1] += qs;
      }
      float s = d[0] + d[1];           // suffix sums over the lanes
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, s, o);
        if (lane + o < 32) s += v;
      }
      float after = __shfl_down_sync(0xffffffffu, s, 1);
      if (lane == 31) after = 0.0f;
      const float g1 = after + d[1], g0 = g1 + d[0];
      const float Ah = A[h];
      const int j = 2 * lane;
      if (j < valid)
        ddt[(row0 + j) * H + h] = g0 * Ah + xd[j] + xd[Q + j];
      if (j + 1 < valid)
        ddt[(row0 + j + 1) * H + h] = g1 * Ah + xd[j + 1] + xd[Q + j + 1];
      const float part = warp_sum(g0 * dts[j] + g1 * dts[j + 1]);
      if (lane == 0) dA_part[bch] = part;
    }
    PHASE(16)
  }

#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = nw + 16 * wq + gq + 8 * (e >> 1);
      const int i = 8 * q + 2 * tq + (e & 1);
      if (n < N) {
        const size_t o =
            ((((size_t)slice * Bsz + b) * nc * Q + t0 + i) * G + grp) * N +
            n;
        dCp[o] = dCs[4 * q + e];
        dBp[o] = dBs[4 * q + e];
      }
    }
}

// Pass 3: dB, dC over the slices and dA over the chunks, in order.
template <typename T>
__global__ void __launch_bounds__(PASS_THREADS)
ssd_bwd_sum_kernel(const float* __restrict__ dBp,
                   const float* __restrict__ dCp,
                   const float* __restrict__ dA_part, T* __restrict__ dB,
                   T* __restrict__ dC, float* __restrict__ dA, int B, int S,
                   int H, int G, int N, int nc, int slices) {
  grid_dependency_wait();
  const size_t e = (size_t)blockIdx.x * PASS_THREADS + threadIdx.x;
  const size_t total = (size_t)B * S * G * N;
  if (e < total) {
    const size_t gn = (size_t)G * N;
    const size_t bs = e / gn;
    const int s = bs % S;
    const size_t b = bs / S;
    const size_t stride = (size_t)B * nc * Q * gn;
    const size_t base = (b * nc * Q + s) * gn + e % gn;
    float sb = 0.0f, sc = 0.0f;
    for (int k = 0; k < slices; ++k) {
      sb += dBp[base + k * stride];
      sc += dCp[base + k * stride];
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

// A 2-D tensor map over a row-major (outer, inner) array of T, read in
// unswizzled boxes of (box_outer, box_inner); out-of-range elements read
// as zeros.
template <typename T>
bool tile_map(CUtensorMap* map, const void* ptr, size_t inner, size_t outer,
              int box_inner, int box_outer) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)(inner * sizeof(T))};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map,
            sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, bool SPLIT>
int launch_bwd(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* dy, const void* dstate,
               const void* hin, void* dx, void* ddt, void* dA, void* dB,
               void* dC, void* dinit, void* work, int B, int S, int H, int G,
               int P, int N, int hps, cudaStream_t s) {
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_state_kernel<T, SPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(STATE_SMEM<T>));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T, SPLIT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(CHUNK_SMEM<T>));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const int nc = (S + Q - 1) / Q, PN = P * N, rep = H / G;
  const int sx = 2 * ((P + SPT - 1) / SPT), npart = 4 * sx;
  const int slices = (rep + hps - 1) / hps;
  const size_t chunks_h = (size_t)B * nc * H;
  const float* Hin = static_cast<const float*>(hin);
  const float* decay = Hin + chunks_h * PN;
  float* dS = static_cast<float*>(work);
  float* daq = dS + chunks_h * PN;
  float* dAp = daq + chunks_h * npart;
  float* dBp = dAp + chunks_h;
  float* dCp = dBp + (size_t)slices * B * nc * Q * G * N;
  // 16-byte copies where every row starts 16-byte aligned and holds whole
  // 16-byte pieces
  const int per16 = 16 / sizeof(T);
  auto al16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_x = al16(x) && al16(dy) && P % per16 == 0;
  const int vec_bc = al16(Bm) && al16(Cm) && N % per16 == 0;
  const int vec_h = al16(hin) && al16(work) && N % 4 == 0;
  const int tma = vec_x && vec_bc;
  // zero maps (never read) where the rows do not start 16-byte aligned
  CUtensorMap map_x = {}, map_dy = {};
  if (vec_x && vec_h &&
      !(tile_map<T>(&map_x, x, (size_t)H * P, (size_t)B * S, PT, Q) &&
        tile_map<T>(&map_dy, dy, (size_t)H * P, (size_t)B * S, PT, Q)))
    return static_cast<int>(cudaErrorNotSupported);
  // dy and C as (B S, H P) and (B S, G N) arrays, read in boxes of 64
  // rows: (72, ...) and (NP / 2, ...) in pass 1, (32, ...) in pass 2
  CUtensorMap map_dy1 = {}, map_c = {};
  if (tma &&
      !(tile_map<T>(&map_dy1, dy, (size_t)H * P, (size_t)B * S, LDY, Q) &&
        tile_map<T>(&map_c, Cm, (size_t)G * N, (size_t)B * S, NP / 2, Q)))
    return static_cast<int>(cudaErrorNotSupported);
  ssd_bwd_state_kernel<T, SPLIT>
      <<<dim3(sx, H, B), STATE_THREADS, STATE_SMEM<T>, s>>>(
          map_dy1, map_c, static_cast<const T*>(dy),
          static_cast<const float*>(dt),
          static_cast<const float*>(A), static_cast<const T*>(Cm), Hin, decay,
          static_cast<const float*>(dstate), dS, static_cast<float*>(dinit),
          daq, S, H, G, P, N, nc, tma);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_dependent(
      ssd_bwd_chunk_kernel<T, SPLIT>, dim3(slices, nc, B * G),
      dim3(THREADS), CHUNK_SMEM<T>, s, map_x, map_dy,
      static_cast<const T*>(x),
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const T*>(dy), Hin, static_cast<const float*>(dS),
      static_cast<const float*>(daq), static_cast<T*>(dx),
      static_cast<float*>(ddt), dAp, dBp, dCp, B, S, H, G, P, N, nc, hps,
      npart, vec_x, vec_bc, vec_h);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = (size_t)B * S * G * N;
  const size_t n = total > (size_t)H ? total : (size_t)H;
  return static_cast<int>(launch_dependent(
      ssd_bwd_sum_kernel<T>,
      dim3((unsigned)((n + PASS_THREADS - 1) / PASS_THREADS)),
      dim3(PASS_THREADS), 0, s, static_cast<const float*>(dBp),
      static_cast<const float*>(dCp), static_cast<const float*>(dAp),
      static_cast<T*>(dB), static_cast<T*>(dC), static_cast<float*>(dA), B,
      S, H, G, N, nc, slices));
}

}  // namespace

// hin: the forward's scratch after the call (the states entering each chunk,
// then the chunks' total decays).  dstate and dinit may be null (a zero
// final-state cotangent; no initial state).  hps: heads per block of the
// chunk pass (slices = ceil((H / G) / hps) of each group).  work: scratch
// of B * ceil(S / 64) * H * (P*N + 8 ceil(P / 64) + 1) + 2 slices * B *
// ceil(S / 64) * 64 * G * N fp32, not initialised.  bf16_in selects bf16
// x, B, C, dy, dx, dB and dC; otherwise all are fp32.
extern "C" int dmath_ssd_scan_bwd(const void* x, const void* dt,
                                  const void* A, const void* Bm,
                                  const void* Cm, const void* dy,
                                  const void* dstate, const void* hin,
                                  void* dx, void* ddt, void* dA, void* dB,
                                  void* dC, void* dinit, void* work, int B,
                                  int S, int H, int G, int P, int N, int hps,
                                  int bf16_in, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      N <= 0 || N > MAX_N || hps <= 0 || 8 * ((P + SPT - 1) / SPT) > MAX_PART)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_in)
    return launch_bwd<bf16, false>(x, dt, A, Bm, Cm, dy, dstate, hin, dx,
                                   ddt, dA, dB, dC, dinit, work, B, S, H, G,
                                   P, N, hps, s);
  return launch_bwd<float, true>(x, dt, A, Bm, Cm, dy, dstate, hin, dx, ddt,
                                 dA, dB, dC, dinit, work, B, S, H, G, P, N,
                                 hps, s);
}
