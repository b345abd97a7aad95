// Paged decode attention as split-sequence flash-decoding: one query token
// per sequence against a paged KV pool, masking positions at or past
// seq_lens[b].
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_decode_attention (_paged_decode_kernel).  q (B,Hq,hd), pages
// (P,page,Hkv,hd) bf16, block_table (B,n_pages) int32, seq_lens (B,) int32,
// out (B,Hq,hd) bf16; any hd <= 256 (on the tile of the next width DT of
// 32, 64, 128, 256: columns past hd load as zeros and are not stored; an
// hd that is not a multiple of 8 loads element by element), g = Hq/Hkv <=
// 16 query heads per kv head.  fp32 softmax and accumulators.
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
// Shard mode (serving on a mesh, the KV cache sharded on the sequence): a
// table entry < 0 marks a page this rank does not hold, whose keys are
// masked, and seq_lens are the caller's (a shard of a dense row passes its
// live length clipped to the shard).  The split kernel alone runs, every
// split writing its (acc, m, l): the caller's partials
// (dmath_paged_partials).  A split with no live key on this rank (past
// the length, or on pages held elsewhere) loads nothing and writes only m
// = -inf and l = 0; its acc is left unwritten, and no reader of the
// partials reads acc where l = 0.  The ranks all-gather them in rank
// order and the combine kernel adds n ranks' partials, rank by rank and
// split by split, skipping those with l = 0 (dmath_paged_combine_ranks);
// the one-rank call is its n = 1 case, which reads the live splits
// alone, known from the lengths.  A row sharded at multiples of KS gives
// each split to one rank, so the ranks' partials are the one-rank call's
// splits and the combine's sums are the one-rank call's, bit for bit.
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
struct Layout {                      // HD: the tile's width (DT)
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

template <int HD, bool EXACT>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                   const bf16* __restrict__ vp,
                   const int* __restrict__ table,
                   const int* __restrict__ lens, float* __restrict__ part_o,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   int Hq, int Hkv, int d_arg, int page, int n_pages,
                   int n_splits, float scale_log2, int shard) {
  const int D = EXACT ? HD : d_arg;    // a tile's own width: constant
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
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;
  const size_t row0 = (size_t)b * Hq + (size_t)hk * g;
  if (k0 >= n && !shard) return;       // the one-rank combine skips it

  // each key's row in the pool: -1 past n and on a page this rank does
  // not hold
  long long key_off = -1;
  {
    const int p = k0 + tid;
    if (p < n) {
      const int ph = table[(size_t)b * n_pages + p / page];
      if (ph >= 0)
        key_off = (((long long)ph * page + p % page) * Hkv + hk) * D;
    }
    row_off[tid] = key_off;
  }
  // a split with no live key (shard mode only: on one rank key k0 is
  // live) writes m = -inf and l = 0 and no o, which the combine never
  // reads where l = 0
  if (!__syncthreads_or(key_off >= 0)) {
    if (tid < g) {
      part_m[(row0 + tid) * n_splits + s] = -INFINITY;
      part_l[(row0 + tid) * n_splits + s] = 0.0f;
    }
    return;
  }

  // Q's g rows (the rest zero)
  const bf16* qb = q + row0 * D;
  for (int i = tid; i < MAXG * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    load_chunk8(Qs + r * LD + c * 8, qb + (size_t)(r < g ? r : 0) * D, c * 8,
                D, r < g);
  }
#pragma unroll 4
  for (int i = tid; i < KS * CH; i += THREADS) {
    const long long off = row_off[i / CH];
    const int c = (i % CH) * 8;
    load_chunk8(Ks + (i / CH) * LD + c, kp + (off >= 0 ? off : 0), c, D,
                off >= 0);
  }
  cp_async_commit();                   // group: Q and K
#pragma unroll 4
  for (int i = tid; i < KS * CH; i += THREADS) {
    const long long off = row_off[i / CH];
    const int c = (i % CH) * 8;
    load_chunk8(Vs + (i / CH) * LD + c, vp + (off >= 0 ? off : 0), c, D,
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

  // scale after the product, mask the keys with no row (past the length,
  // or not on this rank), softmax in log2 units
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < KW / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kw0 + nt * 8 + 2 * tq + (e & 1);
      const float v =
          row_off[key] >= 0 ? sc[nt][e] * scale_log2 : -INFINITY;
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
  for (int i = tid; i < g * (HD / 4); i += THREADS) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
    if (c >= D) continue;
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
    float* dst = part_o + ((row0 + r) * n_splits + s) * D + c;
    if ((D & 3) == 0) {                // 16-byte aligned
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < D) dst[j] = e[j];
    }
  }
  if (tid < g) {
    part_m[(row0 + tid) * n_splits + s] = Ms[tid];
    part_l[(row0 + tid) * n_splits + s] = Ls[tid];
  }
}

// One block per (query head, sequence): n ranks' partials added rank by
// rank, each rank's splits in split order, rescaled to their common max.
// parts holds n blocks of (o (rows, n_splits, hd), m (rows, n_splits), l
// (rows, n_splits)), rows = B * Hq.  With ``lens`` (the one-rank call, n
// = 1) only the splits below ceil(lens[b] / KS) are read, the others
// never written; without, every split's m and l are, and a split with l
// = 0 (no live key, its o unwritten) is skipped.  Both add a live
// split's terms alike, so the shards of a row cut at multiples of KS
// combine to the one-rank call's bits.
__global__ void __launch_bounds__(COMBINE_THREADS)
paged_combine_kernel(const float* __restrict__ parts,
                     const int* __restrict__ lens, bf16* __restrict__ o,
                     int n, int rows, int hd, int n_splits, int n_max) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int Hq = gridDim.x;
  const size_t row = (size_t)b * Hq + h;
  const size_t per = (size_t)rows * n_splits;      // entries of one rank
  const size_t stride = per * (hd + 2);            // one rank's block
  int ns = n_splits;
  if (lens != nullptr) {
    const int len = min(lens[b], n_max);
    ns = len > 0 ? (len + KS - 1) / KS : 0;
  }
  grid_dependency_wait();              // the splits are written
  float M = -INFINITY;
  for (int r = 0; r < n; ++r) {
    const float* pm = parts + r * stride + per * hd + row * n_splits;
    for (int s = 0; s < ns; ++s) M = fmaxf(M, pm[s]);
  }
  float l = 0.0f;
  for (int r = 0; r < n; ++r) {
    const float* pm = parts + r * stride + per * hd + row * n_splits;
    const float* pl = pm + per;
    for (int s = 0; s < ns; ++s)
      if (pl[s] > 0.0f) l += pl[s] * exp2f(pm[s] - M);
  }
  const float inv = l > 0.0f ? 1.0f / l : 0.0f;
  for (int d = threadIdx.x; d < hd; d += COMBINE_THREADS) {
    float acc = 0.0f;
    for (int r = 0; r < n; ++r) {
      const float* po = parts + r * stride + row * n_splits * hd;
      const float* pm = parts + r * stride + per * hd + row * n_splits;
      const float* pl = pm + per;
      for (int s = 0; s < ns; ++s)
        if (pl[s] > 0.0f) acc += po[s * hd + d] * exp2f(pm[s] - M);
    }
    o[row * hd + d] = __float2bfloat16(acc * inv);
  }
}

template <int HD, bool EXACT>
int launch_splits(const bf16* q, const bf16* kp, const bf16* vp,
                  const int* table, const int* lens, float* part, int B,
                  int Hq, int Hkv, int D, int page, int n_pages, float scale,
                  int shard, cudaStream_t s) {
  using L = Layout<HD>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_split_kernel<HD, EXACT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const int n_splits = (n_pages * page + KS - 1) / KS;
  const size_t rows = (size_t)B * Hq * n_splits;
  float* part_o = part;
  float* part_m = part_o + rows * D;
  float* part_l = part_m + rows;
  paged_split_kernel<HD, EXACT>
      <<<dim3(n_splits, Hkv, B), THREADS, L::BYTES, s>>>(
      q, kp, vp, table, lens, part_o, part_m, part_l, Hq, Hkv, D, page,
      n_pages, n_splits, scale * LOG2E, shard);
  return static_cast<int>(cudaGetLastError());
}

typedef int (*SplitLaunch)(const bf16*, const bf16*, const bf16*, const int*,
                           const int*, float*, int, int, int, int, int, int,
                           float, int, cudaStream_t);

// a power-of-two hd on its own tile, hd a compile-time constant; any
// other hd <= 256 on the tile of the next width, columns past hd masked
SplitLaunch split_launch(int hd) {
  return hd <= 0      ? nullptr
         : hd == 32   ? launch_splits<32, true>
         : hd < 32    ? launch_splits<32, false>
         : hd == 64   ? launch_splits<64, true>
         : hd < 64    ? launch_splits<64, false>
         : hd == 128  ? launch_splits<128, true>
         : hd < 128   ? launch_splits<128, false>
         : hd == 256  ? launch_splits<256, true>
         : hd < 256   ? launch_splits<256, false>
                      : nullptr;
}

bool bad_shape(int Hq, int Hkv, int page, int n_pages) {
  return Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > MAXG || n_pages <= 0 ||
         page <= 0;
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
  const SplitLaunch fn = split_launch(hd);
  if (fn == nullptr || bad_shape(Hq, Hkv, page, n_pages))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  const int rc = fn(static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
                    static_cast<const bf16*>(vp),
                    static_cast<const int*>(table),
                    static_cast<const int*>(lens), part, B, Hq, Hkv, hd,
                    page, n_pages, scale, 0, s);
  if (rc != 0) return rc;
  const int n_splits = (n_pages * page + KS - 1) / KS;
  return static_cast<int>(launch_dependent(
      paged_combine_kernel, dim3(Hq, B), dim3(COMBINE_THREADS), 0, s,
      static_cast<const float*>(part), static_cast<const int*>(lens),
      static_cast<bf16*>(o), 1, B * Hq, hd, n_splits, n_pages * page));
}

// Shard mode: the split kernel alone, its partials (the scratch layout
// above) written to ``part``; table entries < 0 are pages this rank does
// not hold.
extern "C" int dmath_paged_partials_bf16(const void* q, const void* kp,
                                         const void* vp, const void* table,
                                         const void* lens, void* part, int B,
                                         int Hq, int Hkv, int hd, int page,
                                         int n_pages, float scale,
                                         void* stream) {
  const SplitLaunch fn = split_launch(hd);
  if (fn == nullptr || bad_shape(Hq, Hkv, page, n_pages))
    return static_cast<int>(cudaErrorInvalidValue);
  return fn(static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
            static_cast<const bf16*>(vp), static_cast<const int*>(table),
            static_cast<const int*>(lens), static_cast<float*>(part), B, Hq,
            Hkv, hd, page, n_pages, scale, 1,
            static_cast<cudaStream_t>(stream));
}

// The combine of n ranks' partials, gathered in rank order: parts (n, B *
// Hq * n_splits * (hd + 2)) fp32, o (B, Hq, hd) bf16.
extern "C" int dmath_paged_combine_ranks_bf16(const void* parts, void* o,
                                              int n, int B, int Hq, int hd,
                                              int n_splits, void* stream) {
  if (n <= 0 || B <= 0 || Hq <= 0 || hd <= 0 || hd > 256 || n_splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  paged_combine_kernel<<<dim3(Hq, B), COMBINE_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(parts), nullptr, static_cast<bf16*>(o), n,
      B * Hq, hd, n_splits, 0);
  return static_cast<int>(cudaGetLastError());
}
