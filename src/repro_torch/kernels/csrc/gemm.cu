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

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;               // K per stage: one 128-byte swizzle row
constexpr int BOX = 64 * BK * 2;     // one 64 x 64 bf16 box: 8 KB

// ---- PTX helpers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity ``parity`` has completed.  A pipeline
// that stays stuck for 10 s traps (a launch error), rather than hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t spin = 0; !mbar_try(bar, parity); ++spin) {
    if ((spin & 1023) == 1023) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (t0 == 0) t0 = now;
      else if (now - t0 > 10000000000ull) __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (all in 16-byte units).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;       // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator reads across wgmma's
// asynchronous writes.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// ---- wgmma m64nNk16, bf16 x bf16 -> fp32 ------------------------------------
// d (N/2 fp32 per thread) = A (64 x 16, descriptor da) * B (16 x N, db)
// (+ d when acc != 0); TA / TB: 0 = K-major tile, 1 = MN-major tile.

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n8(float* d, uint64_t da,
    uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3},\n"
      " %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n16(float* d, uint64_t da,
    uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},\n"
      " %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float* d, uint64_t da,
    uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15},\n"
      " %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da,
    uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31},\n"
      " %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da,
    uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31,\n"
      "%32, %33, %34, %35, %36, %37, %38, %39,\n"
      "%40, %41, %42, %43, %44, %45, %46, %47,\n"
      "%48, %49, %50, %51, %52, %53, %54, %55,\n"
      "%56, %57, %58, %59, %60, %61, %62, %63},\n"
      " %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int BT, int TA, int TB>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db,
                                      int acc) {
  if constexpr (BT == 8) wgmma_n8<TA, TB>(d, da, db, acc);
  else if constexpr (BT == 16) wgmma_n16<TA, TB>(d, da, db, acc);
  else if constexpr (BT == 32) wgmma_n32<TA, TB>(d, da, db, acc);
  else if constexpr (BT == 64) wgmma_n64<TA, TB>(d, da, db, acc);
  else wgmma_n128<TA, TB>(d, da, db, acc);
}

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
  void* out;            // (M,N) row-major, fp32 or bf16
  float* scratch;       // (groups, M, N) group sums when split, else null
  int M, N, K;
  int kg;               // K group depth: a multiple of 256
  int groups;           // ceil(K / kg)
  int groups_per_block; // 1 when split, else all of them
  int splits;           // blocks along K: 1, or one per group
  int out_f32;
  int tma;              // 1: TMA producer; 0: element loads (ragged)
};

// One (row, col) of a 128-byte-swizzled tile of 64 bf16 per row: the
// layout TMA's 128-byte swizzle writes, for the element-load producer.
__device__ __forceinline__ int swz(int row, int col) {
  return row * 64 + ((((col >> 3) ^ (row & 7)) << 3) | (col & 7));
}

// One output tile of the persistent loop: tile t counts M tiles fastest,
// then N tiles, then the split, so the blocks working at one time share
// their weight tiles (read from HBM once) and the activations (small)
// come from L2.
struct Tile {
  int m0, n0, g0, g1;
};

__device__ __forceinline__ Tile tile_of(int t, int mt, int nt, int bt,
                                        int bn, const Params& p) {
  Tile r;
  r.m0 = (t % mt) * bt;
  t /= mt;
  r.n0 = (t % nt) * bn;
  r.g0 = (t / nt) * p.groups_per_block;
  r.g1 = min(p.groups, r.g0 + p.groups_per_block);
  return r;
}

// Threads: NWG consumer warpgroups, then one producer warpgroup.  Each
// block walks tiles blockIdx.x, + gridDim.x, ...: the producer's ring runs
// on from one tile into the next while the consumers store the last one.
// With two consumers, setmaxnreg gives them 232 registers each (the
// accumulator and the running total of a 64 x 128 fragment) and the
// producer 40.
template <int NWG, int BT, int TA, int TB>
__global__ void __launch_bounds__(NWG * 128 + 128, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_w,
                  const __grid_constant__ CUtensorMap map_x, Params p) {
  constexpr int STAGES = NWG == 2 ? 5 : 6;
  constexpr int X_BYTES = BT * BK * 2;
  constexpr int STAGE_BYTES = NWG * BOX + X_BYTES;
  constexpr int NREG = BT / 2;
  constexpr int BN = 64 * NWG;
  static_assert(STAGE_BYTES % 1024 == 0, "stages stay 1024-byte aligned");
  static_assert(TB == 0 || BT % 64 == 0, "MN-major A tiles are whole boxes");

  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  extern __shared__ uint8_t dyn[];
  uint8_t* base = dyn + ((1024 - (smem_u32(dyn) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int mt = (p.M + BT - 1) / BT;
  const int nt = (p.N + BN - 1) / BN;
  const int total = mt * nt * p.splits;
  const int nsteps = (p.K + BK - 1) / BK;
  const int spg = p.kg / BK;               // k-steps per K group

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);     // one arrival per consumer warp
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
        if (p.tma) {
          mbar_expect_tx(&full[s], STAGE_BYTES);
          for (int w = 0; w < NWG; ++w) {
            if (TA)
              tma_load_2d(st + w * BOX, &map_w, &full[s], tl.n0 + 64 * w,
                          k0);
            else
              tma_load_2d(st + w * BOX, &map_w, &full[s], k0,
                          tl.n0 + 64 * w);
          }
          uint8_t* xs = st + NWG * BOX;
          if (TB == 0) {
            tma_load_2d(xs, &map_x, &full[s], k0, tl.m0);
          } else {
            for (int c = 0; c < BT / 64; ++c)
              tma_load_2d(xs + c * BOX, &map_x, &full[s], tl.m0 + 64 * c,
                          k0);
          }
        } else {
          bf16* ws = reinterpret_cast<bf16*>(st);
          bf16* xs = reinterpret_cast<bf16*>(st + NWG * BOX);
          const bf16 zero = __float2bfloat16(0.0f);
          // weights: per consumer, a 64 x 64 tile (rows k if TA, else n)
          for (int e = ptid; e < NWG * 64 * 64; e += 128) {
            const int w = e / 4096, r = (e / 64) % 64, c = e % 64;
            const int k = k0 + (TA ? r : c);
            const int n = tl.n0 + 64 * w + (TA ? c : r);
            bf16 v = zero;
            if (k < p.K && n < p.N)
              v = TA ? p.w[(size_t)k * p.N + n] : p.w[(size_t)n * p.K + k];
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
              v = TB ? p.x[(size_t)k * p.M + m] : p.x[(size_t)m * p.K + k];
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
          mbar_wait(&full[s], (it / STAGES) & 1);
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
          float* sg = p.scratch + (size_t)g * p.M * p.N;
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
#pragma unroll
      for (int i = 0; i < NREG; ++i) {
        const int row = 16 * warp + lane / 4 + ((i & 2) ? 8 : 0);
        const int col = 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
        const int n = tl.n0 + 64 * wg + row, m = tl.m0 + col;
        if (m < p.M && n < p.N)
          store_out(p.out, (size_t)m * p.N + n, tot[i], p.out_f32);
      }
    }
  }
}

// ---- fp32 operands: CUDA-core FMAs -----------------------------------------
// A 64 x 64 output tile per block of 16 x 16 threads, each thread 4 x 4
// outputs (rows ty + 16 i, columns tx + 16 j); K in 16-deep steps through
// shared memory, every K group summed from zero with fmaf in k order.

constexpr int F_TILE = 64;
constexpr int F_BK = 16;

__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ X, int x_t,
                const float* __restrict__ W, int w_t, Params p) {
  __shared__ float xs[F_BK][F_TILE + 1];
  __shared__ float ws[F_BK][F_TILE + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * F_TILE, m0 = blockIdx.y * F_TILE;
  const int g0 = blockIdx.z * p.groups_per_block;
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
        ws[kw][nn] = (k2 < kend && n < p.N)
                         ? (w_t ? W[(size_t)n * p.K + k2] : W[(size_t)k2 * p.N + n])
                         : 0.0f;
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
            p.scratch[((size_t)g * p.M + m) * p.N + n] = acc[i][j];
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
        store_out(p.out, (size_t)m * p.N + n, tot[i][j], p.out_f32);
    }
}

// The split's second pass: C = ((s_0 + s_1) + s_2) + ..., group order.
__global__ void reduce_groups_kernel(const float* __restrict__ s, void* out,
                                     int out_f32, size_t MN, int groups) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float t = s[i];
  for (int g = 1; g < groups; ++g) t += s[(size_t)g * MN + i];
  store_out(out, i, t, out_f32);
}

// ---- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The encoded maps, keyed by everything an encoding reads.
struct MapSlot {
  CUtensorMap map;
  const void* ptr;
  int inner, outer, ld, box_outer;
};
constexpr int MAP_SLOTS_LOG2 = 10;
MapSlot map_cache[1 << MAP_SLOTS_LOG2];     // ptr == nullptr: empty
std::mutex map_mutex;

// A 2-D bf16 tensor map over a row-major (outer, inner) array whose rows
// are ``ld`` elements apart, read in boxes of (box_outer, 64) with the
// 128-byte swizzle; out-of-range elements read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int inner, int outer,
              int ld, int box_outer) {
  uint64_t h = reinterpret_cast<uintptr_t>(ptr) ^ ((uint64_t)inner << 44) ^
               ((uint64_t)outer << 24) ^ ((uint64_t)ld << 4) ^ box_outer;
  MapSlot& slot =
      map_cache[(h * 0x9E3779B97F4A7C15ull) >> (64 - MAP_SLOTS_LOG2)];
  std::lock_guard<std::mutex> lock(map_mutex);
  if (slot.ptr == ptr && slot.inner == inner && slot.outer == outer &&
      slot.ld == ld && slot.box_outer == box_outer) {
    *map = slot.map;
    return true;
  }
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  slot = MapSlot{*map, ptr, inner, outer, ld, box_outer};
  return true;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <int NWG, int BT, int TA, int TB>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  constexpr int STAGES = NWG == 2 ? 5 : 6;
  constexpr int SMEM = STAGES * (NWG * BOX + BT * BK * 2) + 1024;
  constexpr int THREADS = NWG * 128 + 128;
  static int per_sm = 0;                 // resident blocks per SM
  if (per_sm == 0) {
    auto kernel = gemm_wgmma_kernel<NWG, BT, TA, TB>;
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
    const bool ok =
        (TA ? make_map(&map_w, p.w, p.N, p.K, p.N, 64)
            : make_map(&map_w, p.w, p.K, p.N, p.K, 64)) &&
        (TB ? make_map(&map_x, p.x, p.M, p.K, p.M, 64)
            : make_map(&map_x, p.x, p.K, p.M, p.K, BT));
    if (!ok) return cudaErrorInvalidValue;
  }
  const long tiles = (long)((p.M + BT - 1) / BT) *
                     ((p.N + 64 * NWG - 1) / (64 * NWG)) * p.splits;
  const int grid = (int)std::min<long>(tiles, (long)sm_count() * per_sm);
  gemm_wgmma_kernel<NWG, BT, TA, TB>
      <<<grid, THREADS, SMEM, stream>>>(map_w, map_x, p);
  return cudaGetLastError();
}

template <int TA, int TB>
cudaError_t launch_bt(const Params& p, int bt, int nwg, cudaStream_t s) {
  if (nwg == 2) {
    if (bt == 128) return launch_wgmma<2, 128, TA, TB>(p, s);
    if (bt == 64) return launch_wgmma<2, 64, TA, TB>(p, s);
    return cudaErrorInvalidValue;
  }
  if constexpr (TB == 0) {
    switch (bt) {
      case 8: return launch_wgmma<1, 8, TA, 0>(p, s);
      case 16: return launch_wgmma<1, 16, TA, 0>(p, s);
      case 32: return launch_wgmma<1, 32, TA, 0>(p, s);
      case 64: return launch_wgmma<1, 64, TA, 0>(p, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C = A @ B.  ``a`` is (M,K), or (K,M) stored when a_t; ``b`` is (K,N), or
// (N,K) stored when b_t; both bf16 (f32 = 0) or both fp32 (f32 = 1).  The
// plan comes from the wrapper: the K group depth ``kg``, the consumer
// warpgroups ``nwg`` (1: tiles of 64 columns by ``bt`` = 8, 16, 32 or 64
// tokens; 2: 128 columns by ``bt`` = 64 or 128), ``split`` (1, or one
// block per group), ``tma``; ``scratch`` holds ceil(K/kg)·M·N fp32 when
// split > 1.  Returns the launches' cudaGetLastError().
extern "C" int dmath_gemm(const void* a, int a_t, const void* b, int b_t,
                          void* c, int out_f32, void* scratch, int M, int N,
                          int K, int f32, int kg, int bt, int nwg, int split,
                          int tma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p;
  p.x = static_cast<const bf16*>(a);
  p.w = static_cast<const bf16*>(b);
  p.out = c;
  p.scratch = split > 1 ? static_cast<float*>(scratch) : nullptr;
  p.M = M;
  p.N = N;
  p.K = K;
  p.kg = kg;
  p.groups = (K + kg - 1) / kg;
  if (kg % 256 != 0 || (split > 1 && split != p.groups))
    return static_cast<int>(cudaErrorInvalidValue);
  p.groups_per_block = split > 1 ? 1 : p.groups;
  p.splits = split > 1 ? p.groups : 1;
  p.out_f32 = out_f32;
  p.tma = tma;
  cudaError_t e;
  if (f32) {
    const dim3 grid((N + F_TILE - 1) / F_TILE, (M + F_TILE - 1) / F_TILE,
                    split);
    gemm_f32_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(a), a_t,
                                         static_cast<const float*>(b), b_t, p);
    e = cudaGetLastError();
  } else if (b_t) {
    e = a_t ? launch_bt<0, 1>(p, bt, nwg, s) : launch_bt<0, 0>(p, bt, nwg, s);
  } else {
    e = a_t ? launch_bt<1, 1>(p, bt, nwg, s) : launch_bt<1, 0>(p, bt, nwg, s);
  }
  if (e != cudaSuccess || split <= 1) return static_cast<int>(e);
  const size_t MN = (size_t)M * N;
  reduce_groups_kernel<<<(unsigned)((MN + 255) / 256), 256, 0, s>>>(
      p.scratch, c, out_f32, MN, p.groups);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dmath_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
