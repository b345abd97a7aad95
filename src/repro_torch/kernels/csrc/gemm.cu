// C[M,N] = A[M,K] @ B[K,N] on Hopper (sm_90a): fp32 accumulator, one
// downcast to fp32 or bf16.
//
// Replaces the TPU kernel repro/kernels/gemm.py::matmul (_matmul_kernel).
//
// What bounds it: at decode (M = 8 slots) every product reads its weights
// once and does 2·M FLOPs per weight element, far below the card's ~295
// bf16 FLOP/byte ridge, so B's bytes over 3.35 TB/s bound it; at prefill
// and train shapes (M = 128 .. 1,024) the large products are bound by
// tensor-core operations.  The design serves both with one arithmetic:
//
// - The product runs transposed, Cᵀ = Bᵀ·Aᵀ: the weights sit on wgmma's
//   64-row side and the tokens on its narrow n side (n = 8 .. 128), so at
//   M = 8 no MMA row is padding.  Every regime uses this form.
// - Deterministic, row-invariant sums.  K is cut into groups of depth KG
//   (256, or a larger multiple of 256 that keeps K to at most 32 groups: a
//   function of K alone, from the wrapper); each group is summed from zero
//   on the tensor cores (fp32), and the group sums are added in group
//   order into an fp32 total.  A split-K launch gives each block one group
//   and writes its sum to fp32 scratch, and a second pass adds them in
//   group order; the unsplit kernel does the same adds in registers.  No
//   atomics in any sum: two runs give the same bits, and row i of C
//   depends on A[i], B, K and N only (never on M, the tile or the
//   split).
// - A ring of shared-memory stages fed by TMA (128-byte swizzle, one
//   producer warp, mbarrier full/empty pairs) and consumed by one (a tile
//   of 64 weight columns by 8 .. 64 tokens) or two (128 columns by 64 or
//   128 tokens) consumer warpgroups running wgmma from shared memory into
//   fp32 registers, one k-step's wgmmas in flight while the next issue.
//   Blocks are persistent (one wave), so the producer's ring runs on into
//   the next tile while the consumers store the last one.  Dynamic shared
//   memory above 48 KB is set with cudaFuncSetAttribute.
// - Either operand may be stored transposed: A as (M,K) or (K,M), B as
//   (K,N) or (N,K).  The tensor map reads the layout as stored and wgmma's
//   transpose flags take K- or MN-major tiles, so the backward's dA = dC·Bᵀ
//   and dB = Aᵀ·dC need no copies, and give the bits of the same product
//   on contiguous copies.
// - TMA needs 16-byte global strides: a stored row length that is not a
//   multiple of 8 elements (or an unaligned base) takes the same kernel
//   with its producer warp loading elements into the same swizzled layout
//   (masked at every edge), so the consumer and its bits are the same.
//   TMA zero-fills ragged M, N and K edges; stores are masked.  No caller
//   pads.
// - fp32 operands run on CUDA-core FMAs (TF32 would keep 10 mantissa bits
//   and miss the reference's fp32 tolerance), with the same K groups, the
//   same split scratch and the same order of adds.
// - The split's second pass is a programmatic dependent launch: its blocks
//   are scheduled while the first pass runs and wait for its sums.
//
// Batched mode (the expert banks of the moe family): C[e] = A[e] @ B[e]
// for e < batch, A (batch, M, K), B (batch, K, N), each slice stored as a
// 2-D operand is (either layout), slices packed one after another.  One
// launch: the persistent tile index runs over the experts too (the expert
// slowest, then the split, the N tiles and the M tiles), the tensor maps
// are 3-D (inner, outer, expert) so TMA zero-fills each slice's own edges,
// and the split's scratch and second pass hold one set of group sums per
// expert.  Every expert's tiles run the 2-D plan's K groups in the same
// order, so slice e of C is bitwise the 2-D kernel on (A[e], B[e]).  A
// 2-D product is batch 1 of the same code.
//
// matmul_dequant (replaces repro/kernels/gemm.py::matmul_dequant,
// _matmul_dequant_kernel): C = (A @ B_q) * scale[N] with B_q int8, stored
// (K, N), on the same kernels and the same plan.  bf16 A: the producer
// warp TMA-loads the int8 tile (64 k rows of 64 bytes, 4 KB, unswizzled)
// into a third part of the stage beside the activations; each consumer
// warpgroup widens its tile exactly into the bf16 tile it reads (the
// swizzled MN-major layout TMA writes for a (K, N) bf16 B) while its
// wgmmas of the k-step before run, fences the writes to the async proxy,
// syncs its 128 threads and runs the unchanged wgmma code.  fp32 A: the
// CUDA-core kernel widens B on its shared-memory load.  The scale
// multiplies the finished fp32 sum (in the epilogue, or in the split's
// second pass) before the one cast, so C is bitwise matmul(A, B_q
// widened, fp32) * scale[None, :], cast once.  At decode the product is
// bound by the int8 bytes, half the bf16 GEMM's; the widening (three
// integer and one fp32 instruction per element) hides beside them.
//
// cuTensorMapEncodeTiled is looked up with cudaGetDriverEntryPoint, so the
// library links against the CUDA runtime only (no -lcuda).  A tensor map
// is a pure function of (base, shape, row pitch, box), so the host keeps
// the encoded maps in a small direct-mapped cache: the weights' maps are
// encoded once, not on every call.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;               // K per stage: one 128-byte swizzle row
constexpr int BOX = 64 * BK * 2;     // one 64 x 64 bf16 box: 8 KB
constexpr int RAW = 64 * BK;         // one 64 x 64 int8 box: 4 KB

__device__ __forceinline__ void store_out(void* out, size_t i, float v,
                                          int out_f32) {
  if (out_f32)
    static_cast<float*>(out)[i] = v;
  else
    static_cast<bf16*>(out)[i] = __float2bfloat16(v);
}

struct Params {
  const bf16* x;        // A as stored: (M,K) row-major, or (K,M) if TB
  const bf16* w;        // B as stored: (K,N) row-major if TA, else (N,K)
  const signed char* wq;  // int8 B, (K,N) row-major (matmul_dequant)
  const float* scale;   // (N,) fp32 column scales (matmul_dequant), or null
  void* out;            // (M,N) row-major, fp32 or bf16
  float* scratch;       // (groups, M, N) group sums when split, else null
  int batch;            // products in the launch (1: a 2-D product)
  int M, N, K;
  int kg;               // K group depth: a multiple of 256
  int groups;           // ceil(K / kg)
  int groups_per_block; // 1 when split, else all of them
  int splits;           // blocks along K: 1, or one per group
  int out_f32;
  int tma;              // 1: TMA producer; 0: element loads (ragged)
};

// Four int8 (one word, element 0 in the low byte) -> four bf16 (two
// words), exactly: byte b offset to b + 128 is the low mantissa byte of
// the fp32 2^23 + b + 128; less 2^23 + 128 that is b, an integer whose
// bf16 is the fp32's top half.
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr float MAGIC = 8388736.0f;          // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - MAGIC;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - MAGIC;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - MAGIC;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - MAGIC;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// One (row, col) of a 128-byte-swizzled tile of 64 bf16 per row: the
// layout TMA's 128-byte swizzle writes, for the element-load producer.
__device__ __forceinline__ int swz(int row, int col) {
  return row * 64 + ((((col >> 3) ^ (row & 7)) << 3) | (col & 7));
}

// One output tile of the persistent loop: tile t counts M tiles fastest,
// then N tiles, then the split, then the expert (batch slice), so the
// blocks working at one time share their weight tiles (read from HBM
// once) and the activations (small) come from L2.
struct Tile {
  int m0, n0, g0, g1, e;
};

__device__ __forceinline__ Tile tile_of(int t, int mt, int nt, int bt,
                                        int bn, const Params& p) {
  Tile r;
  r.m0 = (t % mt) * bt;
  t /= mt;
  r.n0 = (t % nt) * bn;
  t /= nt;
  r.g0 = (t % p.splits) * p.groups_per_block;
  r.e = t / p.splits;
  r.g1 = min(p.groups, r.g0 + p.groups_per_block);
  return r;
}

// Threads: NWG consumer warpgroups, then one producer warpgroup.  Each
// block walks tiles blockIdx.x, + gridDim.x, ...: the producer's ring runs
// on from one tile into the next while the consumers store the last one.
// With two consumers, setmaxnreg gives them 232 registers each (the
// accumulator and the running total of a 64 x 128 fragment) and the
// producer 40.  WQ (int8 B, TA only): with TMA a stage also holds the
// int8 tiles, which TMA completes on raw_full together with the
// activations; each consumer warpgroup widens its own tile into the bf16
// tile it reads (while its wgmmas of the k-step before run), fences it to
// the async proxy and syncs its 128 threads before its wgmmas.
template <int NWG, int BT, int TA, int TB, bool WQ>
__global__ void __launch_bounds__(NWG * 128 + 128, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_w,
                  const __grid_constant__ CUtensorMap map_x, Params p) {
  constexpr int STAGES = NWG == 2 ? 5 : 6;
  constexpr int X_BYTES = BT * BK * 2;
  constexpr int RAW_BYTES = WQ ? NWG * RAW : 0;
  constexpr int STAGE_BYTES = NWG * BOX + X_BYTES + RAW_BYTES;
  constexpr int NREG = BT / 2;
  constexpr int BN = 64 * NWG;
  static_assert(STAGE_BYTES % 1024 == 0, "stages stay 1024-byte aligned");
  static_assert(TB == 0 || BT % 64 == 0, "MN-major A tiles are whole boxes");
  static_assert(!WQ || (TA == 1 && TB == 0), "int8 B is stored (K, N)");

  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  __shared__ __align__(8) uint64_t raw_full[STAGES];     // WQ with TMA
  extern __shared__ uint8_t dyn[];
  uint8_t* base = dyn + ((1024 - (smem_u32(dyn) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int mt = (p.M + BT - 1) / BT;
  const int nt = (p.N + BN - 1) / BN;
  const int total = mt * nt * p.splits * p.batch;
  const int nsteps = (p.K + BK - 1) / BK;
  const int spg = p.kg / BK;               // k-steps per K group

  grid_launch_dependents();    // the split's second pass may start its launch
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);     // one arrival per consumer warp
      if (WQ) mbar_init(&raw_full[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NWG * 128) {
    // ---- producer warpgroup ----
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int ptid = tid - NWG * 128;
    if (p.tma && ptid != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const Tile tl = tile_of(t, mt, nt, BT, BN, p);
      const int ks1 = min(nsteps, tl.g1 * spg);
      for (int ks = tl.g0 * spg; ks < ks1; ++ks, ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        uint8_t* st = base + s * STAGE_BYTES;
        const int k0 = ks * BK;
        if (WQ && p.tma) {
          // the int8 tiles and the activations, completing on raw_full
          uint8_t* raw = st + NWG * BOX + X_BYTES;
          mbar_expect_tx(&raw_full[s], RAW_BYTES + X_BYTES);
          for (int w = 0; w < NWG; ++w)
            tma_load_3d(raw + w * RAW, &map_w, &raw_full[s], tl.n0 + 64 * w,
                        k0, tl.e);
          tma_load_3d(st + NWG * BOX, &map_x, &raw_full[s], k0, tl.m0, tl.e);
        } else if (p.tma) {
          mbar_expect_tx(&full[s], STAGE_BYTES);
          for (int w = 0; w < NWG; ++w) {
            if (TA)
              tma_load_3d(st + w * BOX, &map_w, &full[s], tl.n0 + 64 * w,
                          k0, tl.e);
            else
              tma_load_3d(st + w * BOX, &map_w, &full[s], k0,
                          tl.n0 + 64 * w, tl.e);
          }
          uint8_t* xs = st + NWG * BOX;
          if (TB == 0) {
            tma_load_3d(xs, &map_x, &full[s], k0, tl.m0, tl.e);
          } else {
            for (int c = 0; c < BT / 64; ++c)
              tma_load_3d(xs + c * BOX, &map_x, &full[s], tl.m0 + 64 * c,
                          k0, tl.e);
          }
        } else {
          bf16* ws = reinterpret_cast<bf16*>(st);
          bf16* xs = reinterpret_cast<bf16*>(st + NWG * BOX);
          const bf16 zero = __float2bfloat16(0.0f);
          const size_t wo = (size_t)tl.e * p.K * p.N;   // this expert's B
          const bf16* xe = p.x + (size_t)tl.e * p.M * p.K;
          // weights: per consumer, a 64 x 64 tile (rows k if TA, else n)
          for (int e = ptid; e < NWG * 64 * 64; e += 128) {
            const int w = e / 4096, r = (e / 64) % 64, c = e % 64;
            const int k = k0 + (TA ? r : c);
            const int n = tl.n0 + 64 * w + (TA ? c : r);
            bf16 v = zero;
            if (k < p.K && n < p.N) {
              if constexpr (WQ)
                v = __float2bfloat16(
                    static_cast<float>(p.wq[wo + (size_t)k * p.N + n]));
              else
                v = TA ? p.w[wo + (size_t)k * p.N + n]
                       : p.w[wo + (size_t)n * p.K + k];
            }
            ws[w * 4096 + swz(r, c)] = v;
          }
          // activations: BT rows of 64 k (K-major), or per 64 tokens a
          // 64 x 64 tile of rows k (MN-major)
          for (int e = ptid; e < BT * 64; e += 128) {
            int r, c, m, k, off;
            if (TB == 0) {
              r = e / 64; c = e % 64; m = tl.m0 + r; k = k0 + c; off = 0;
            } else {
              const int chunk = e / 4096;
              r = (e / 64) % 64; c = e % 64;
              k = k0 + r; m = tl.m0 + 64 * chunk + c; off = chunk * 4096;
            }
            bf16 v = zero;
            if (k < p.K && m < p.M)
              v = TB ? xe[(size_t)k * p.M + m] : xe[(size_t)m * p.K + k];
            xs[off + swz(r, c)] = v;
          }
          // generic-proxy writes, read by wgmma through the async proxy
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile("bar.sync 1, 128;\n" ::: "memory");
          if (ptid == 0) mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: weight columns [n0 + 64 wg, + 64) ----
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    float acc[NREG], tot[NREG];
#pragma unroll
    for (int i = 0; i < NREG; ++i) acc[i] = tot[i] = 0.0f;

    int it = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const Tile tl = tile_of(t, mt, nt, BT, BN, p);
      const int ks1 = min(nsteps, tl.g1 * spg);
      for (int g = tl.g0; g < tl.g1; ++g) {
        // One k-step's wgmmas stay in flight while the next k-step's
        // issue; its stage is released once wgmma.wait_group 1 has seen
        // it complete.  A group ends with wait_group 0 before its sum is
        // read.
        const int ka = g * spg;
        const int kb = min(ks1, ka + spg);
        int prev = -1;
        for (int ks = ka; ks < kb; ++ks, ++it) {
          const int s = it % STAGES;
          if (WQ && p.tma) {
            // widen this warpgroup's int8 tile: each thread takes 16 int8
            // of one k row at a time (a 16-byte read) and writes their 16
            // bf16 as two swizzled 16-byte chunks of that row
            mbar_wait(&raw_full[s], (it / STAGES) & 1);
            uint8_t* wide = base + s * STAGE_BYTES + wg * BOX;
            const uint8_t* raw = base + s * STAGE_BYTES + NWG * BOX +
                                 X_BYTES + wg * RAW;
#pragma unroll
            for (int c = tid % 128; c < 256; c += 128) {
              const int k = c >> 2, seg = c & 3;
              const uint4 r =
                  *reinterpret_cast<const uint4*>(raw + k * 64 + seg * 16);
              uint4 a, b;
              widen4(r.x, a.x, a.y);
              widen4(r.y, a.z, a.w);
              widen4(r.z, b.x, b.y);
              widen4(r.w, b.z, b.w);
              *reinterpret_cast<uint4*>(wide + swz128(k, 2 * seg)) = a;
              *reinterpret_cast<uint4*>(wide + swz128(k, 2 * seg + 1)) = b;
            }
            // generic-proxy writes, read by wgmma through the async proxy
            fence_proxy_async();
            asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
          } else {
            mbar_wait(&full[s], (it / STAGES) & 1);
          }
          const uint8_t* wt = base + s * STAGE_BYTES + wg * BOX;
          const uint8_t* xt = base + s * STAGE_BYTES + NWG * BOX;
#pragma unroll
          for (int i = 0; i < NREG; ++i) fence_reg(acc[i]);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            // K-major: the next 16 k are 32 bytes along the swizzled row;
            // MN-major: 16 rows of 128 bytes further.  SBO: 8 rows (1 KB);
            // LBO: the next 64-wide MN box (MN-major) or unused (K-major).
            const uint64_t da = TA ? make_desc(wt + kk * 2048, BOX, 1024)
                                   : make_desc(wt + kk * 32, 16, 1024);
            const uint64_t db = TB ? make_desc(xt + kk * 2048, BOX, 1024)
                                   : make_desc(xt + kk * 32, 16, 1024);
            wgmma<BT, TA, TB>(acc, da, db, (ks > ka || kk > 0) ? 1 : 0);
          }
          wg_commit();
          if (prev >= 0) {
            wg_wait_one();
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[prev]);
          }
          prev = s;
        }
        wg_wait_all();
#pragma unroll
        for (int i = 0; i < NREG; ++i) fence_reg(acc[i]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[prev]);
        if (p.scratch) {
          // split: this group's sum, for the ordered second pass
          float* sg =
              p.scratch + ((size_t)tl.e * p.groups + g) * p.M * p.N;
#pragma unroll
          for (int i = 0; i < NREG; ++i) {
            const int row = 16 * warp + lane / 4 + ((i & 2) ? 8 : 0);
            const int col = 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
            const int n = tl.n0 + 64 * wg + row, m = tl.m0 + col;
            if (m < p.M && n < p.N) sg[(size_t)m * p.N + n] = acc[i];
          }
        } else {
#pragma unroll
          for (int i = 0; i < NREG; ++i)
            tot[i] = g == tl.g0 ? acc[i] : tot[i] + acc[i];
        }
      }
      if (p.scratch) continue;
      // wgmma's fragment: register i holds D[row][col], row a weight
      // column and col a token, as below
      const size_t oe = (size_t)tl.e * p.M * p.N;     // this expert's C
#pragma unroll
      for (int i = 0; i < NREG; ++i) {
        const int row = 16 * warp + lane / 4 + ((i & 2) ? 8 : 0);
        const int col = 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
        const int n = tl.n0 + 64 * wg + row, m = tl.m0 + col;
        if (m < p.M && n < p.N)
          store_out(p.out, oe + (size_t)m * p.N + n,
                    WQ ? __fmul_rn(tot[i], __ldg(p.scale + n)) : tot[i],
                    p.out_f32);
      }
    }
  }
}

// ---- fp32 operands: CUDA-core FMAs -----------------------------------------
// A 64 x 64 output tile per block of 16 x 16 threads, each thread 4 x 4
// outputs (rows ty + 16 i, columns tx + 16 j); K in 16-deep steps through
// shared memory, every K group summed from zero with fmaf in k order.
// WQ: W is int8 (K, N), widened to fp32 (exactly) as it is staged, and
// the sums are scaled by p.scale[n] before the store.

constexpr int F_TILE = 64;
constexpr int F_BK = 16;

// Batched: blockIdx.z is expert * splits + split.
template <bool WQ>
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ X, int x_t,
                const void* __restrict__ Wv, int w_t, Params p) {
  const int e = blockIdx.z / p.splits;
  X += (size_t)e * p.M * p.K;
  const float* W = static_cast<const float*>(Wv) + (size_t)e * p.K * p.N;
  const signed char* Wq = static_cast<const signed char*>(Wv);
  __shared__ float xs[F_BK][F_TILE + 1];
  __shared__ float ws[F_BK][F_TILE + 1];
  grid_launch_dependents();    // the split's second pass may start its launch
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * F_TILE, m0 = blockIdx.y * F_TILE;
  const int g0 = (blockIdx.z % p.splits) * p.groups_per_block;
  const size_t oe = (size_t)e * p.M * p.N;        // this expert's C
  const int g1 = min(p.groups, g0 + p.groups_per_block);
  float acc[4][4], tot[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = tot[i][j] = 0.0f;

  for (int g = g0; g < g1; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    const int kend = min(p.K, (g + 1) * p.kg);
    for (int k0 = g * p.kg; k0 < kend; k0 += F_BK) {
      for (int e = threadIdx.x; e < F_BK * F_TILE; e += 256) {
        const int kk = x_t ? e / F_TILE : e % F_BK;
        const int mm = x_t ? e % F_TILE : e / F_BK;
        const int k = k0 + kk, m = m0 + mm;
        xs[kk][mm] = (k < kend && m < p.M)
                         ? (x_t ? X[(size_t)k * p.M + m] : X[(size_t)m * p.K + k])
                         : 0.0f;
        const int kw = w_t ? e % F_BK : e / F_TILE;
        const int nn = w_t ? e / F_BK : e % F_TILE;
        const int k2 = k0 + kw, n = n0 + nn;
        float wv = 0.0f;
        if (k2 < kend && n < p.N) {
          if constexpr (WQ)
            wv = static_cast<float>(Wq[(size_t)k2 * p.N + n]);
          else
            wv = w_t ? W[(size_t)n * p.K + k2] : W[(size_t)k2 * p.N + n];
        }
        ws[kw][nn] = wv;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < F_BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
        if (p.scratch) {
          if (m < p.M && n < p.N)
            p.scratch[(((size_t)e * p.groups + g) * p.M + m) * p.N + n] =
                acc[i][j];
        } else {
          tot[i][j] = g == g0 ? acc[i][j] : tot[i][j] + acc[i][j];
        }
      }
  }
  if (p.scratch) return;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < p.M && n < p.N)
        store_out(p.out, oe + (size_t)m * p.N + n,
                  WQ ? __fmul_rn(tot[i][j], __ldg(p.scale + n)) : tot[i][j],
                  p.out_f32);
    }
}

// The split's second pass: C = ((s_0 + s_1) + s_2) + ..., group order,
// times scale[n] where a scale is given (matmul_dequant); batched, each
// expert's own sums.  A programmatic dependent launch: its blocks wait for
// the first pass's sums.
__global__ void reduce_groups_kernel(const float* __restrict__ s, void* out,
                                     int out_f32, size_t MN, size_t total,
                                     int groups,
                                     const float* __restrict__ scale, int N) {
  grid_dependency_wait();
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const size_t e = i / MN, j = i - e * MN;
  s += e * groups * MN + j;
  float t = s[0];
  for (int g = 1; g < groups; ++g) t += s[(size_t)g * MN];
  if (scale != nullptr) t = __fmul_rn(t, scale[j % N]);
  store_out(out, i, t, out_f32);
}

// ---- host side ---------------------------------------------------------------

// The encoded maps, keyed by everything an encoding reads.
struct MapSlot {
  CUtensorMap map;
  const void* ptr;
  int inner, outer, ld, box_outer, int8, batch;
};
constexpr int MAP_SLOTS_LOG2 = 10;
MapSlot map_cache[1 << MAP_SLOTS_LOG2];     // ptr == nullptr: empty
std::mutex map_mutex;

// A 3-D tensor map over ``batch`` row-major (outer, inner) arrays, one
// after another, whose rows are ``ld`` elements apart, read in boxes of
// (1, box_outer, 64): bf16 with the 128-byte swizzle, or (int8) bytes
// unswizzled; out-of-range elements of each array read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int inner, int outer,
              int ld, int box_outer, int int8 = 0, int batch = 1) {
  uint64_t h = reinterpret_cast<uintptr_t>(ptr) ^ ((uint64_t)inner << 44) ^
               ((uint64_t)outer << 24) ^ ((uint64_t)ld << 4) ^ box_outer ^
               ((uint64_t)int8 << 63) ^ ((uint64_t)batch << 54);
  MapSlot& slot =
      map_cache[(h * 0x9E3779B97F4A7C15ull) >> (64 - MAP_SLOTS_LOG2)];
  std::lock_guard<std::mutex> lock(map_mutex);
  if (slot.ptr == ptr && slot.inner == inner && slot.outer == outer &&
      slot.ld == ld && slot.box_outer == box_outer && slot.int8 == int8 &&
      slot.batch == batch) {
    *map = slot.map;
    return true;
  }
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t es = int8 ? 1 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * es,
                                 (cuuint64_t)ld * outer * es};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_outer, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (fn(map,
         int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
         3, const_cast<void*>(ptr), dims, strides, box, elem,
         CU_TENSOR_MAP_INTERLEAVE_NONE,
         int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  slot = MapSlot{*map, ptr, inner, outer, ld, box_outer, int8, batch};
  return true;
}

template <int NWG, int BT, int TA, int TB, bool WQ>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  constexpr int STAGES = NWG == 2 ? 5 : 6;
  constexpr int SMEM =
      STAGES * (NWG * BOX + BT * BK * 2 + (WQ ? NWG * RAW : 0)) + 1024;
  constexpr int THREADS = NWG * 128 + 128;
  static int per_sm = 0;                 // resident blocks per SM
  if (per_sm == 0) {
    auto kernel = gemm_wgmma_kernel<NWG, BT, TA, TB, WQ>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, SMEM);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  CUtensorMap map_w, map_x;
  if (p.tma) {
    const int nb = p.batch;
    const bool ok =
        (WQ ? make_map(&map_w, p.wq, p.N, p.K, p.N, 64, 1, nb)
         : TA ? make_map(&map_w, p.w, p.N, p.K, p.N, 64, 0, nb)
              : make_map(&map_w, p.w, p.K, p.N, p.K, 64, 0, nb)) &&
        (TB ? make_map(&map_x, p.x, p.M, p.K, p.M, 64, 0, nb)
            : make_map(&map_x, p.x, p.K, p.M, p.K, BT, 0, nb));
    if (!ok) return cudaErrorInvalidValue;
  }
  const long tiles = (long)((p.M + BT - 1) / BT) *
                     ((p.N + 64 * NWG - 1) / (64 * NWG)) * p.splits *
                     p.batch;
  const int grid = (int)std::min<long>(tiles, (long)sm_count() * per_sm);
  gemm_wgmma_kernel<NWG, BT, TA, TB, WQ>
      <<<grid, THREADS, SMEM, stream>>>(map_w, map_x, p);
  return cudaGetLastError();
}

template <int TA, int TB, bool WQ = false>
cudaError_t launch_bt(const Params& p, int bt, int nwg, cudaStream_t s) {
  if (nwg == 2) {
    if (bt == 128) return launch_wgmma<2, 128, TA, TB, WQ>(p, s);
    if (bt == 64) return launch_wgmma<2, 64, TA, TB, WQ>(p, s);
    return cudaErrorInvalidValue;
  }
  if constexpr (TB == 0) {
    switch (bt) {
      case 8: return launch_wgmma<1, 8, TA, 0, WQ>(p, s);
      case 16: return launch_wgmma<1, 16, TA, 0, WQ>(p, s);
      case 32: return launch_wgmma<1, 32, TA, 0, WQ>(p, s);
      case 64: return launch_wgmma<1, 64, TA, 0, WQ>(p, s);
    }
  }
  return cudaErrorInvalidValue;
}

// The plan's common part of both entries; p.x, p.w or p.wq, p.out and
// p.scale are set by the caller.
bool set_plan(Params& p, void* scratch, int batch, int M, int N, int K,
              int kg, int split, int out_f32, int tma) {
  p.scratch = split > 1 ? static_cast<float*>(scratch) : nullptr;
  if (batch < 1) return false;
  p.batch = batch;
  p.M = M;
  p.N = N;
  p.K = K;
  p.kg = kg;
  p.groups = (K + kg - 1) / kg;
  if (kg % 256 != 0 || (split > 1 && split != p.groups)) return false;
  p.groups_per_block = split > 1 ? 1 : p.groups;
  p.splits = split > 1 ? p.groups : 1;
  p.out_f32 = out_f32;
  p.tma = tma;
  return true;
}

// The split's second pass, when there is a split.
cudaError_t finish(const Params& p, cudaError_t e, int split,
                   cudaStream_t s) {
  if (e != cudaSuccess || split <= 1) return e;
  const size_t MN = (size_t)p.M * p.N, total = MN * p.batch;
  return launch_dependent(reduce_groups_kernel,
                          dim3((unsigned)((total + 255) / 256)), dim3(256), 0,
                          s, static_cast<const float*>(p.scratch), p.out,
                          p.out_f32, MN, total, p.groups, p.scale, p.N);
}

}  // namespace

// C[e] = A[e] @ B[e] for e < batch, one launch (and the split's second
// pass).  Each slice of ``a`` is (M,K), or (K,M) stored when a_t; of ``b``
// (K,N), or (N,K) stored when b_t; slices packed one after another, both
// bf16 (f32 = 0) or both fp32 (f32 = 1); ``c`` is (batch, M, N).  The plan
// comes from the wrapper, the 2-D plan of one slice: the K group depth
// ``kg``, the consumer warpgroups ``nwg`` (1: tiles of 64 columns by
// ``bt`` = 8, 16, 32 or 64 tokens; 2: 128 columns by ``bt`` = 64 or 128),
// ``split`` (1, or one block per group), ``tma``; ``scratch`` holds
// batch·ceil(K/kg)·M·N fp32 when split > 1.  Returns the launches'
// cudaGetLastError().
extern "C" int dmath_gemm_batched(const void* a, int a_t, const void* b,
                                  int b_t, void* c, int out_f32,
                                  void* scratch, int batch, int M, int N,
                                  int K, int f32, int kg, int bt, int nwg,
                                  int split, int tma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p = {};
  p.x = static_cast<const bf16*>(a);
  p.w = static_cast<const bf16*>(b);
  p.out = c;
  if (!set_plan(p, scratch, batch, M, N, K, kg, split, out_f32, tma))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (f32) {
    const dim3 grid((N + F_TILE - 1) / F_TILE, (M + F_TILE - 1) / F_TILE,
                    p.splits * batch);
    gemm_f32_kernel<false><<<grid, 256, 0, s>>>(static_cast<const float*>(a),
                                                a_t, b, b_t, p);
    e = cudaGetLastError();
  } else if (b_t) {
    e = a_t ? launch_bt<0, 1>(p, bt, nwg, s) : launch_bt<0, 0>(p, bt, nwg, s);
  } else {
    e = a_t ? launch_bt<1, 1>(p, bt, nwg, s) : launch_bt<1, 0>(p, bt, nwg, s);
  }
  return static_cast<int>(finish(p, e, split, s));
}

// C = A @ B: batch 1 of dmath_gemm_batched.
extern "C" int dmath_gemm(const void* a, int a_t, const void* b, int b_t,
                          void* c, int out_f32, void* scratch, int M, int N,
                          int K, int f32, int kg, int bt, int nwg, int split,
                          int tma, void* stream) {
  return dmath_gemm_batched(a, a_t, b, b_t, c, out_f32, scratch, 1, M, N, K,
                            f32, kg, bt, nwg, split, tma, stream);
}

// C = (A @ B_q) * scale[None, :].  ``a`` is (M,K) row-major, bf16 (f32 = 0)
// or fp32 (f32 = 1); ``bq`` is int8 (K,N) row-major; ``scale`` (N,) fp32.
// The plan's arguments are dmath_gemm's for the same (M, K, N, f32), so
// C is bitwise that of dmath_gemm on B_q widened to A's type, times the
// scale, cast once.
extern "C" int dmath_gemm_dequant(const void* a, const void* bq,
                                  const void* scale, void* c, int out_f32,
                                  void* scratch, int M, int N, int K,
                                  int f32, int kg, int bt, int nwg,
                                  int split, int tma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p = {};
  p.x = static_cast<const bf16*>(a);
  p.wq = static_cast<const signed char*>(bq);
  p.scale = static_cast<const float*>(scale);
  p.out = c;
  if (!set_plan(p, scratch, 1, M, N, K, kg, split, out_f32, tma))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (f32) {
    const dim3 grid((N + F_TILE - 1) / F_TILE, (M + F_TILE - 1) / F_TILE,
                    p.splits);
    gemm_f32_kernel<true><<<grid, 256, 0, s>>>(static_cast<const float*>(a),
                                               0, bq, 0, p);
    e = cudaGetLastError();
  } else {
    e = launch_bt<1, 0, true>(p, bt, nwg, s);
  }
  return static_cast<int>(finish(p, e, split, s));
}

extern "C" const char* dmath_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
