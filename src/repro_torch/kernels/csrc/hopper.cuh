// Hopper (sm_90a) building blocks shared by the kernels: shared-memory
// addresses, mbarriers, TMA (tiled and bulk) and cp.async copies, wgmma
// descriptors of 128-byte-swizzled tiles, wgmma products with B from shared
// memory and A from shared memory or from registers (bf16, and tf32 with A
// from registers), and the warp-level mma.sync and ldmatrix of the
// small-tile kernels (paged decode, the SSD scan's forward).
//
// A tile here is 64 rows of 64 bf16 (128 bytes a row), 128-byte swizzled,
// 8 KB, 1024-byte aligned; a wider row is cut into such boxes placed 8 KB
// apart.  K-major operand (K contiguous): the k16 step kk starts kk * 32
// bytes into the row, SBO 1024 (8 rows).  MN-major operand (rows are k,
// each row 64 of M or N): the step starts kk * 2048 bytes in (16 rows),
// SBO 1024, LBO 8192 (the next 64-wide box along M or N).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// A box of a 3-D tensor map at (c0, c1, c2): the GEMM's operands are
// (batch, outer, inner) arrays, a 2-D product being batch 1.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// ``bytes`` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory by the TMA engine, completing on ``bar`` as transaction
// bytes: no tensor map, one instruction from one thread.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
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

// ---- wgmma m64nNk16 with A from registers, bf16 x bf16 -> fp32 --------------
// d (N/2 fp32 per thread) = A (64 x 16: four bf16 pairs per thread, in the
// accumulator layout of an m64n16 product) * B (16 x N, descriptor db)
// (+ d when acc != 0); TB: 0 = K-major tile, 1 = MN-major tile.  The
// registers of ``a`` are read asynchronously: keep them live (fence_u32)
// until the wait.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31},\n"
      " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31,\n"
      "%32, %33, %34, %35, %36, %37, %38, %39,\n"
      "%40, %41, %42, %43, %44, %45, %46, %47,\n"
      "%48, %49, %50, %51, %52, %53, %54, %55,\n"
      "%56, %57, %58, %59, %60, %61, %62, %63},\n"
      " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
        "n"(TB));
}

// N = 256 (head dim 256) as two m64n128k16 products on the same A: an
// MN-major B's 64-wide column blocks lie the descriptor's leading byte
// offset apart, so the second half starts two blocks on; d's second 64
// registers are its columns 128..255 in the accumulator layout of one
// m64n256 product.  Each output sums over k as one product would.
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db, int acc) {
  static_assert(N == 64 || N == 128 || (N == 256 && TB == 1),
                "wgmma_rs: N is 64, 128 or 256 (MN-major B)");
  if constexpr (N == 64) {
    wgmma_rs_n64<TB>(d, a, db, acc);
  } else if constexpr (N == 128) {
    wgmma_rs_n128<TB>(d, a, db, acc);
  } else {
    const uint64_t lbo = (db >> 16) & 0x3FFF;   // 16-byte units
    wgmma_rs_n128<TB>(d, a, db, acc);
    wgmma_rs_n128<TB>(d + 64, a, db + 2 * lbo, acc);
  }
}

__device__ __forceinline__ void fence_u32(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// ---- wgmma m64nNk8 with A from registers, tf32 x tf32 -> fp32 ---------------
// d (N/2 fp32 per thread) = A (64 x 8: four tf32 values per thread, the
// m16n8k8 A fragment of the thread's warp, rows 16 (warp % 4) ..) * B
// (8 x N, descriptor db of a K-major tile: tf32 has no transposed form)
// (+ d when acc != 0).  A tf32 operand is an fp32 bit pattern whose low
// 13 mantissa bits the tensor cores ignore.  Keep ``a`` live (fence_u32)
// until the wait, as for wgmma_rs.

__device__ __forceinline__ void wgmma_tf32_n16(float* d, const uint32_t* a,
                                               uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},\n"
      " {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_n32(float* d, const uint32_t* a,
                                               uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15},\n"
      " {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_n64(float* d, const uint32_t* a,
                                               uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31},\n"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t db, int acc) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma_tf32: N 16, 32, 64");
  if constexpr (N == 16) wgmma_tf32_n16(d, a, db, acc);
  else if constexpr (N == 32) wgmma_tf32_n32(d, a, db, acc);
  else wgmma_tf32_n64(d, a, db, acc);
}

// Two fp32 values as one register of two bf16 (round to nearest even),
// ``lo`` in the low half: one pair of an A fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- mma.sync and ldmatrix (warp-level tensor-core tiles) -------------------
// Fragments of m16n8k16 (bf16) and m16n8k8 (tf32), with g = lane / 4 and
// t = lane % 4: the accumulator holds (g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1); the A operand of k16 holds (g, 2t..2t+1), (g+8, 2t..2t+1),
// (g, 2t+8..2t+9), (g+8, 2t+8..2t+9) as bf16 pairs, of k8 (g, t), (g+8, t),
// (g, t+4), (g+8, t+4); the B operand of k16 holds (k 2t..2t+1, n g) and
// (k 2t+8..2t+9, n g), of k8 (k t, n g) and (k t+4, n g).

// d += a (16 x 16 bf16) * b (16 x 8 bf16), fp32 accumulate.
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a (16 x 8 tf32) * b (8 x 8 tf32), fp32 accumulate.
__device__ __forceinline__ void mma_tf32_1688(float* d, const uint32_t* a,
                                              const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 bf16 matrices from shared memory: lane i gives the address
// of row i % 8 of matrix i / 8; register j receives matrix j's fragment
// (row lane / 4, columns 2 (lane % 4) and +1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, transposed: register j receives rows 2 (lane % 4) and +1 of
// column lane / 4 of matrix j.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// ---- programmatic dependent launch --------------------------------------------
// A kernel launched by launch_dependent() may start while the kernel
// before it on the stream still runs (once every block of that kernel has
// called grid_launch_dependents() or exited); grid_dependency_wait()
// blocks until that kernel has completed and its writes are visible.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid,
                             dim3 block, size_t smem, cudaStream_t s,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// cuTensorMapEncodeTiled, looked up through the runtime (no link against
// the driver library); null where the driver lacks it.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
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

// The card's streaming multiprocessors (looked up once), for grids of one
// wave.
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// ---- cp.async ---------------------------------------------------------------

// 16 bytes global -> shared; zeros when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; zeros when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Eight bf16 at columns [c, c + 8) of one row of D into 16 bytes of shared
// memory, columns at or past D (and the whole chunk when !row_ok) as zeros:
// one cp.async when D is a multiple of 8 (every chunk 16-byte aligned), else
// element by element (a synchronous store, ordered by the same barriers).
__device__ __forceinline__ void load_chunk8(void* dst,
                                            const __nv_bfloat16* row, int c,
                                            int D, bool row_ok) {
  if ((D & 7) == 0) {
    const bool ok = row_ok && c < D;
    cp_async16(dst, ok ? row + c : row, ok);
    return;
  }
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = c + 2 * e;
    const uint32_t lo = row_ok && j < D ? r[j] : 0u;
    const uint32_t hi = row_ok && j + 1 < D ? r[j + 1] : 0u;
    w[e] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's generic-proxy shared-memory writes (stores,
// cp.async) before later async-proxy reads (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk ``chunk`` (0..7) of row ``row`` in a
// 128-byte-swizzled tile of 64 bf16 per row: the layout TMA's 128-byte
// swizzle writes and make_desc describes.
__device__ __forceinline__ int swz128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

}  // namespace
