// Paged decode attention as split-sequence flash-decoding: one query token
// per sequence against a paged KV pool, masking positions at or past
// seq_lens[b].
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_decode_attention (_paged_decode_kernel).  q (B,Hq,hd), pages
// (P,page,Hkv,hd) bf16, block_table (B,n_pages) int32, seq_lens (B,) int32,
// out (B,Hq,hd) bf16; hd 32, 64, 128 or 256, g = Hq/Hkv <= 16 query heads
// per kv head.  fp32 softmax and accumulators.
//
// What bounds it: a decode step's call at the serve shape (8 sequences,
// ~2,000 live keys, 2 kv heads of 64) reads ~1 MB of K/V and does ~8
// MFLOP, a 0.3 us bound by bytes; so it is bound by latency, and the
// design is about how many dependent steps a block takes.  A block per
// (sequence, kv head) walking its keys in series gives 16 blocks on 132
// SMs, each a chain of tiles.  Here:
//
// - Each sequence's keys are cut into splits of KS = 128 at fixed
//   positions, [s KS, (s+1) KS), aligned at key 0.  The grid is (splits,
//   Hkv, B), the number of splits from the table's width (n_pages * page),
//   never from seq_lens (reading device lengths on the host would stall
//   the stream); a block whose split starts at or past the length exits at
//   once, so pages past the length are never read.
// - A block resolves its split's pages through the table itself and loads
//   its 128 keys of K and of V with 16-byte cp.async (zero fill past the
//   length): one key's hd values at (page, offset, kv head) are contiguous.
//   V's copies are in flight while Q·Kᵀ runs.
// - Both products run on the tensor cores as mma.sync m16n8k16 (bf16 in,
//   fp32 accumulate): the g <= 16 query heads of the kv head are the 16
//   rows of one m16 tile (rows past g are zeros).  wgmma's 64-row tile
//   would be 57/64 padding at qwen2's g = 7, and its warpgroup-wide issue
//   buys nothing for a 16 x 128 product.  Each of the 4 warps takes 32 of
//   the split's keys: S = Q·Kᵀ (B fragments by ldmatrix from the padded K
//   rows), the online softmax in registers (a row lives in the 4 lanes of
//   a quad), P rounded to bf16 in the accumulator layout, which is the A
//   fragment of P·V (B by ldmatrix.trans from V).  q enters the product as
//   the bf16 it is; the scale (times log2 e) multiplies the fp32 score
//   after the product.
// - The 4 warps' (m, l, acc) are joined in warp order through shared
//   memory, and the split writes its (m, l, acc) in fp32 to scratch the
//   wrapper allocates.  A second kernel adds each (sequence, query head)'s
//   splits in split order, reading only the splits below
//   ceil(seq_lens[b] / KS), each of which holds a live key (an unwritten
//   split is never read, and a warp with no live key contributes an exact
//   0 with weight 0, never a NaN).  No atomics.
//
// So a call runs two kernels; the combine is launched as a programmatic
// dependent of the splits (Hopper's griddepcontrol), so its launch overlaps
// them and it waits for their writes.  (The last split to arrive doing the
// combine itself, found by a counter, took 7.6 us a call on an H100,
// against 3.3 + 2.3 us for the two kernels: dropped.)  A sequence's bits
// depend only on its q, its K/V values and its length: not on the batch,
// the other lengths, the physical pages or the run.
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int KS = 128;             // keys per split, aligned at key 0
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int KW = KS / WARPS;      // keys per warp
constexpr int MAXG = 16;            // query heads per kv head: one m16 tile
constexpr int COMBINE_THREADS = 64;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(THREADS == KS, "one table lookup per thread");

// Shared memory: Q (16 rows), K and V (KS rows each), bf16 rows padded by
// 16 bytes so that ldmatrix's 8 rows fall in 8 distinct bank groups; each
// key's element offset in the pool; the warps' m, l and weights.  The
// warps' fp32 partial outputs, (WARPS x 16) rows of hd + 8, reuse K's
// space (exactly its size).
template <int HD>
struct Layout {
  static constexpr int LD = HD + 8;
  static constexpr int CH = HD / 8;          // 16-byte chunks per row
  static constexpr int LDR = HD + 8;
  static constexpr size_t Q_BYTES = sizeof(bf16) * MAXG * LD;
  static constexpr size_t TILE_BYTES = sizeof(bf16) * KS * LD;
  static constexpr size_t BYTES = Q_BYTES + 2 * TILE_BYTES +
                                  sizeof(long long) * KS +
                                  sizeof(float) * (3 * WARPS + 2) * MAXG;
  static_assert(sizeof(float) * WARPS * MAXG * LDR <= TILE_BYTES,
                "the partials fit in K's space");
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                   const bf16* __restrict__ vp,
                   const int* __restrict__ table,
                   const int* __restrict__ lens, float* __restrict__ part_o,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   int Hq, int Hkv, int page, int n_pages, int n_splits,
                   float scale_log2) {
  using L = Layout<HD>;
  constexpr int LD = L::LD, CH = L::CH, LDR = L::LDR;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + MAXG * LD;
  bf16* Vs = Ks + KS * LD;
  long long* row_off = reinterpret_cast<long long*>(Vs + KS * LD);
  float* mw = reinterpret_cast<float*>(row_off + KS);   // [WARPS][MAXG]
  float* lw = mw + WARPS * MAXG;                         // [WARPS][MAXG]
  float* fw = lw + WARPS * MAXG;                         // [WARPS][MAXG]
  float* Ms = fw + WARPS * MAXG;                         // [MAXG]
  float* Ls = Ms + MAXG;                                 // [MAXG]
  float* red = reinterpret_cast<float*>(Ks);             // [WARPS][MAXG][LDR]

  grid_launch_dependents();            // the combine may start its launch
  const int s = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int g = Hq / Hkv;
  const int n = min(lens[b], n_pages * page);
  const int k0 = s * KS;
  if (k0 >= n) return;                 // a split wholly past the length
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;

  // Q's g rows (the rest zero), and each key's row in the pool (-1 past n)
  const bf16* qb = q + ((size_t)b * Hq + (size_t)hk * g) * HD;
  for (int i = tid; i < MAXG * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    cp_async16(Qs + r * LD + c * 8, qb + (r < g ? r * HD + c * 8 : 0),
               r < g);
  }
  {
    const int p = k0 + tid;
    long long off = -1;
    if (p < n) {
      const int ph = table[(size_t)b * n_pages + p / page];
      off = (((long long)ph * page + p % page) * Hkv + hk) * HD;
    }
    row_off[tid] = off;
  }
  __syncthreads();
#pragma unroll 4
  for (int i = tid; i < KS * CH; i += THREADS) {
    const long long off = row_off[i / CH];
    const int c = (i % CH) * 8;
    cp_async16(Ks + (i / CH) * LD + c, kp + (off >= 0 ? off + c : 0),
               off >= 0);
  }
  cp_async_commit();                   // group: Q and K
#pragma unroll 4
  for (int i = tid; i < KS * CH; i += THREADS) {
    const long long off = row_off[i / CH];
    const int c = (i % CH) * 8;
    cp_async16(Vs + (i / CH) * LD + c, vp + (off >= 0 ? off + c : 0),
               off >= 0);
  }
  cp_async_commit();                   // group: V
  cp_async_wait<1>();
  __syncthreads();

  // S = Q Kᵀ over this warp's 32 keys: 4 n-tiles of 8 keys
  const int kw0 = warp * KW;
  float sc[KW / 8][4];
#pragma unroll
  for (int nt = 0; nt < KW / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, Qs + ((lane % 8) + 8 * ((lane / 8) % 2)) * LD + kk * 16 +
                       8 * (lane / 16));
#pragma unroll
    for (int np = 0; np < KW / 16; ++np) {
      uint32_t bk[4];
      ldmatrix_x4(bk, Ks + (kw0 + np * 16 + (lane % 8) + 8 * (lane / 16)) *
                               LD +
                          kk * 16 + 8 * ((lane / 8) % 2));
      mma_bf16_16816(sc[2 * np], a, bk);
      mma_bf16_16816(sc[2 * np + 1], a, bk + 2);
    }
  }

  // scale after the product, mask past the length, softmax in log2 units
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < KW / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + kw0 + nt * 8 + 2 * tq + (e & 1);
      const float v = key < n ? sc[nt][e] * scale_log2 : -INFINITY;
      sc[nt][e] = v;
      mx[e / 2] = fmaxf(mx[e / 2], v);
    }
  float ls[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
  const float mu[2] = {mx[0] == -INFINITY ? 0.0f : mx[0],
                       mx[1] == -INFINITY ? 0.0f : mx[1]};
#pragma unroll
  for (int nt = 0; nt < KW / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(sc[nt][e] - mu[e / 2]);   // masked: 2^-inf = 0
      sc[nt][e] = p;
      ls[e / 2] += p;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 1);
    ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 2);
  }

  // O = P V over the same keys: P's accumulator is P V's A fragment
  cp_async_wait<0>();
  __syncthreads();                     // V landed; every warp is past K
  float acc[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
  for (int t = 0; t < KW / 16; ++t) {
    const uint32_t a[4] = {pack_bf16(sc[2 * t][0], sc[2 * t][1]),
                           pack_bf16(sc[2 * t][2], sc[2 * t][3]),
                           pack_bf16(sc[2 * t + 1][0], sc[2 * t + 1][1]),
                           pack_bf16(sc[2 * t + 1][2], sc[2 * t + 1][3])};
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t bv[4];
      ldmatrix_x4_trans(
          bv, Vs + (kw0 + t * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * LD +
                  np * 16 + 8 * (lane / 16));
      mma_bf16_16816(acc[2 * np], a, bv);
      mma_bf16_16816(acc[2 * np + 1], a, bv + 2);
    }
  }

  // join the warps in warp order: M = max m_w, f_w = 2^(m_w - M)
  if (tq == 0) {
    mw[warp * MAXG + gr] = mx[0];
    mw[warp * MAXG + gr + 8] = mx[1];
    lw[warp * MAXG + gr] = ls[0];
    lw[warp * MAXG + gr + 8] = ls[1];
  }
  __syncthreads();
  if (tid < MAXG) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, mw[w * MAXG + tid]);
    float l = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float m = mw[w * MAXG + tid];
      const float f = m == -INFINITY ? 0.0f : exp2f(m - M);
      fw[w * MAXG + tid] = f;
      l += f * lw[w * MAXG + tid];
    }
    Ms[tid] = M;
    Ls[tid] = l;
  }
  __syncthreads();
  {
    const float f0 = fw[warp * MAXG + gr], f1 = fw[warp * MAXG + gr + 8];
    float* rw = red + warp * MAXG * LDR;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const int col = nt * 8 + 2 * tq;
      *reinterpret_cast<float2*>(rw + gr * LDR + col) =
          make_float2(acc[nt][0] * f0, acc[nt][1] * f0);
      *reinterpret_cast<float2*>(rw + (gr + 8) * LDR + col) =
          make_float2(acc[nt][2] * f1, acc[nt][3] * f1);
    }
  }
  __syncthreads();
  const size_t row0 = (size_t)b * Hq + (size_t)hk * g;
  for (int i = tid; i < g * (HD / 4); i += THREADS) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
    float4 v = *reinterpret_cast<const float4*>(red + r * LDR + c);
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      const float4 u =
          *reinterpret_cast<const float4*>(red + (w * MAXG + r) * LDR + c);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    *reinterpret_cast<float4*>(part_o + ((row0 + r) * n_splits + s) * HD +
                               c) = v;
  }
  if (tid < g) {
    part_m[(row0 + tid) * n_splits + s] = Ms[tid];
    part_l[(row0 + tid) * n_splits + s] = Ls[tid];
  }
}

// One block per (query head, sequence): the live splits added in split
// order, rescaled to their common max.
__global__ void __launch_bounds__(COMBINE_THREADS)
paged_combine_kernel(const float* __restrict__ part_o,
                     const float* __restrict__ part_m,
                     const float* __restrict__ part_l,
                     const int* __restrict__ lens, bf16* __restrict__ o,
                     int Hq, int hd, int n_max, int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int n = min(lens[b], n_max);
  const int ns = n > 0 ? (n + KS - 1) / KS : 0;
  const size_t row = (size_t)b * Hq + h;
  grid_dependency_wait();              // the splits are written
  const float* pm = part_m + row * n_splits;
  const float* pl = part_l + row * n_splits;
  float M = -INFINITY;
  for (int s = 0; s < ns; ++s) M = fmaxf(M, pm[s]);
  float l = 0.0f;
  for (int s = 0; s < ns; ++s) l += pl[s] * exp2f(pm[s] - M);
  const float inv = l > 0.0f ? 1.0f / l : 0.0f;
  for (int d = threadIdx.x; d < hd; d += COMBINE_THREADS) {
    float acc = 0.0f;
    for (int s = 0; s < ns; ++s)
      acc += part_o[(row * n_splits + s) * hd + d] * exp2f(pm[s] - M);
    o[row * hd + d] = __float2bfloat16(acc * inv);
  }
}

template <int HD>
int launch(const bf16* q, const bf16* kp, const bf16* vp, const int* table,
           const int* lens, float* scratch, bf16* o, int B, int Hq, int Hkv,
           int page, int n_pages, float scale, cudaStream_t s) {
  using L = Layout<HD>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_split_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const int n_max = n_pages * page;
  const int n_splits = (n_max + KS - 1) / KS;
  const size_t rows = (size_t)B * Hq * n_splits;
  float* part_o = scratch;
  float* part_m = part_o + rows * HD;
  float* part_l = part_m + rows;
  paged_split_kernel<HD><<<dim3(n_splits, Hkv, B), THREADS, L::BYTES, s>>>(
      q, kp, vp, table, lens, part_o, part_m, part_l, Hq, Hkv, page,
      n_pages, n_splits, scale * LOG2E);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dependent(
      paged_combine_kernel, dim3(Hq, B), dim3(COMBINE_THREADS), 0, s,
      part_o, part_m, part_l, lens, o, Hq, HD, n_max, n_splits));
}

}  // namespace

// scratch: B * Hq * ceil(n_pages * page / 128) * (hd + 2) fp32, not
// initialised.
extern "C" int dmath_paged_decode_bf16(const void* q, const void* kp,
                                       const void* vp, const void* table,
                                       const void* lens, void* scratch,
                                       void* o, int B, int Hq, int Hkv,
                                       int hd, int page, int n_pages,
                                       float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > MAXG || n_pages <= 0 ||
      page <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(kp);
  const bf16* vb = static_cast<const bf16*>(vp);
  const int* tb = static_cast<const int*>(table);
  const int* lb = static_cast<const int*>(lens);
  float* sc = static_cast<float*>(scratch);
  bf16* ob = static_cast<bf16*>(o);
  switch (hd) {
    case 32:
      return launch<32>(qb, kb, vb, tb, lb, sc, ob, B, Hq, Hkv, page,
                        n_pages, scale, s);
    case 64:
      return launch<64>(qb, kb, vb, tb, lb, sc, ob, B, Hq, Hkv, page,
                        n_pages, scale, s);
    case 128:
      return launch<128>(qb, kb, vb, tb, lb, sc, ob, B, Hq, Hkv, page,
                         n_pages, scale, s);
    case 256:
      return launch<256>(qb, kb, vb, tb, lb, sc, ob, B, Hq, Hkv, page,
                         n_pages, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
