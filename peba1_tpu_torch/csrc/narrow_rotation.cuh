// Device and host code of the narrow step of kernels 1 and 2: the instances
// that cmux_step_gen_narrow.cu and blind_rotate_gen_full_narrow.cu compile,
// which ops/cuda_kernels.py launches for a call of NARROW_MAX_ROWS rows or
// fewer.  They compute what gen_rotation.cuh's instances compute; the two
// share whole_rotation.cuh's digit phase, grid barrier and accumulator
// set-up, and nothing of the ring.
//
// Why a second design: at 32 rows or fewer gen_rotation's 128-row digit
// tile is mostly zeros, and what bounds a stage is its producer warpgroup
// expanding the Toeplitz weight tile into shared memory, 8 KB a limb for a
// stage that each weight byte is read from once (PERF.md §5-6).  Here the
// weights never pass through shared memory: the MMA's A operand is output
// coefficients x 32 contraction bytes of the Toeplitz matrix, built in
// registers from the generator window with funnel shifts, and its B operand
// is the digits of N = 8 NT batch rows (NT = 1, 2 or 4) in shared
// memory as TMA lands them; so a call pays for its rows rounded up to 8,
// not to 128.  Every warp computes: there is no producer role and no ring.
// Each warp runs mma.sync.m16n8k32 on items of its own (64 coefficients as
// four m16 tiles, whose Toeplitz words overlap); the H100 measured it faster
// than wgmma at 16 rows or fewer and within 0.4 us a step of it at 32
// (PERF.md §6).
//
// A step: thread 0 starts the bulk copies of the block's generator windows
// (they depend only on the key, so they land under the digit phase); the
// digit phase; grid barrier 1; thread 0 loads the block's digit tiles by
// TMA; each warp runs its items (below) and adds its sums, each limb
// shifted into place, into the block's sums in shared memory; the block adds each
// output it touched into acc once; grid barrier 2.
//
// The split over the grid: a span is (output tile of 64 coefficients of
// polynomial o, digit polynomial g, 128 contraction bytes kt), in the order
// (tile, g, kt); a step's spans are cut into gridDim.x contiguous ranges,
// the first (spans mod grid) one longer, and a block takes every limb of
// each of its spans.  Its items, (span, limb m), are listed by (tile, m,
// span) and cut into contiguous ranges, one a warp, which keeps its sums
// across the items of one (tile, m) and adds them into the block's sums
// when that changes.  cuda_kernels.NarrowPlan mirrors this walk.
//
// Inside a span the contraction's bytes are permuted, the same permutation
// for the digits (B) and the weights (A), so the sum is the same: the
// MMA's k-group (t, h) of chunk cc (its bytes 4t.. for h = 0, 16 + 4t.. for
// h = 1, t a lane's index in its quad) is the span's bytes 32t + 8cc + 4h..
// of the digits in reversed order.  With the digits in reversed order the
// weight of output coefficient x and contraction byte k is window byte
// 1 + x + k (gen_rotation.cuh).  So a lane (quad g, index t) holds as its A
// registers the words S[j] = window bytes Q + 4j.. (Q = 1 + g + 32t from
// the span's first byte): register (m16 tile u, cc, h, row g or g+8) is
// S[4u + 2cc + h (+2)], 22 words shifted from 23 aligned ones for 16 MMAs
// of a span.  The lanes load their digits themselves, a lane's 32 bytes of
// row g as they lie (digit_phase<false>).  Each limb's int32 sums are exact
// and the limbs recombine mod 2^32 as add_tile does, so the result is the
// same bits whatever the order in which the adds land.

#pragma once

#include "whole_rotation.cuh"

namespace peba1 {
namespace rot {

constexpr int NARROW_WARPS = THREADS / 32;     // runners: every warp
constexpr int WIN_TAIL = 80;                   // window bytes past a run's spans
constexpr int SUM_STRIDE = BN + 4;             // words between rows of the block's sums

// Row groups of 8 of a narrow call of B rows (a power of two), 0 above 32.
__host__ __device__ __forceinline__ int narrow_groups(int B) {
  return B <= 8 ? 1 : B <= 16 ? 2 : B <= 32 ? 4 : 0;
}

// The layout of a block's dynamic shared memory (byte offsets from its
// first 1024-aligned byte) and its bounds, set by the launcher (narrow_plan)
// for a grid of at least `grid` blocks: the digit tiles (one a span, np rows
// of 128 bytes, TMA's 128-byte swizzle), the block's sums (a slot of np rows
// of SUM_STRIDE words for each output tile it touches), the generator
// windows, two mbarriers (windows, digits), a header (spans, runs, slots,
// items, window bytes), then the tables of spans, runs, slots and items.
struct NarrowPlan {
  int np;
  int max_spans, max_slots, max_runs, max_items;
  int sums, win, bars, head, spans, runs, slots, items;
  int smem;   // bytes to request (the base's alignment included)
};

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void red_shared(uint32_t addr, uint32_t v) {
  asm volatile("red.shared.add.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// Bulk copy (the async proxy) of `bytes` bytes, completing on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// d += A x B over 16 rows x 32 contraction bytes x 8 columns, int8 in and
// int32 sums (the m16n8k32 fragments: a0 rows g, a1 rows g+8 at bytes 4t..;
// a2, a3 the same at 16+4t..; b0, b1 column g at 4t.. and 16+4t..; d0, d1
// row g, columns 2t, 2t+1, d2, d3 row g+8).
__device__ __forceinline__ void mma_s8(int32_t (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// This block's spans [x, y) of a step's SP.
__device__ __forceinline__ int2 narrow_spans(int SP) {
  const int W = gridDim.x, b = blockIdx.x, q = SP / W, rem = SP % W;
  const int lo = b * q + min(b, rem);
  return make_int2(lo, lo + q + (b < rem ? 1 : 0));
}

// Thread 0, once a launch: the block's tables.  A run is the block's spans
// of one (tile, g), whose windows (one a limb, from the run's first
// contraction byte, 128 a span and WIN_TAIL more, cut at the generator
// row's end) are one bulk copy each: its entry is the limb-0 window's
// offset in a step's key, the bytes copied, its offset in shared memory,
// and nl | window size << 4.  A span's entry: its limb-0 window's address,
// the window size (the stride between limbs), its digits' column, and its
// slot | nl << 8.  A slot's: o and the tile's first coefficient.  An item:
// span | m << 16 | (nl - 1) << 18 | slot << 20; its key, item >> 16.
__device__ __forceinline__ void narrow_tables(uint32_t base, const Args& a, const NarrowPlan& p) {
  const int N = a.N, KT = N / BK, TJ = N / BN, C = a.k * a.mask_limbs + a.body_limbs;
  const int P = (a.k + 1) * a.l * KT;
  const int2 r = narrow_spans((a.k + 1) * TJ * P);
  const int n_sp = r.y - r.x, tile0 = r.x / P;
  int n_runs = 0, woff = 0, wbytes = 0;
  for (int i = 0; i < n_sp;) {
    const int s = r.x + i, tile = s / P, g = s % P / KT, kt = s % KT, o = tile / TJ;
    const int len = min(n_sp - i, KT - kt), start = tile % TJ * BN + kt * BK;
    const int nl = o < a.k ? a.mask_limbs : a.body_limbs, wsz = BK * len + WIN_TAIL;
    const int bytes = min(wsz, 2 * N - start);
    sts128(base + p.runs + 16 * n_runs, (g * C + o * a.mask_limbs) * 2 * N + start, bytes,
           p.win + woff, nl | wsz << 4);
    for (int e = 0; e < len; ++e)
      sts128(base + p.spans + 16 * (i + e), base + p.win + woff + BK * e, wsz,
             g * N + BK * (kt + e), (tile - tile0) | nl << 8);
    woff += nl * wsz;
    wbytes += nl * bytes;
    ++n_runs;
    i += len;
  }
  const int n_slots = n_sp > 0 ? (r.y - 1) / P - tile0 + 1 : 0;
  int n_items = 0;
  for (int slot = 0; slot < n_slots; ++slot) {
    const int tile = tile0 + slot, o = tile / TJ;
    const int nl = o < a.k ? a.mask_limbs : a.body_limbs;
    const int i0 = max(tile * P - r.x, 0), i1 = min((tile + 1) * P - r.x, n_sp);
    sts32(base + p.slots + 8 * slot, o);
    sts32(base + p.slots + 8 * slot + 4, tile % TJ * BN);
    for (int m = 0; m < nl; ++m)
      for (int i = i0; i < i1; ++i)
        sts32(base + p.items + 4 * n_items++, i | m << 16 | (nl - 1) << 18 | slot << 20);
  }
  sts128(base + p.head, n_sp, n_runs, n_slots, n_items);
  sts32(base + p.head + 16, wbytes);
}

// Thread 0 at a step's start: the bulk copies of the block's windows of
// step key vv_s.  The last step's reads of them ended before barrier 2.
__device__ __forceinline__ void narrow_fetch(uint32_t base, const NarrowPlan& p,
                                             const int8_t* vv_s, int n_runs, int wbytes, int N) {
  fence_proxy_async_shared();
  const uint32_t bar = base + p.bars;
  mbar_arrive_expect_tx(bar, wbytes);
  for (int i = 0; i < n_runs; ++i) {
    const uint4 run = lds128(base + p.runs + 16 * i);
    const int nl = run.w & 15, wsz = run.w >> 4;
    for (int m = 0; m < nl; ++m)
      bulk_copy(base + run.z + m * wsz, vv_s + run.x + (size_t)m * 2 * N, run.y, bar);
  }
}

// Thread 0 after barrier 1: the digit tile of each span (np rows from row 0;
// rows past the batch read as zeros), after the proxy fence that lets TMA
// see the digit phase's stores.
__device__ __forceinline__ void narrow_digits(uint32_t base, const NarrowPlan& p,
                                              const CUtensorMap* map, int n_sp) {
  fence_proxy_async_global();
  const uint32_t bar = base + p.bars + 8;
  mbar_arrive_expect_tx(bar, n_sp * p.np * BK);
  for (int i = 0; i < n_sp; ++i)
    tma_load_2d(base + i * p.np * BK, map, bar, (int)lds32(base + p.spans + 16 * i + 8), 0);
}

__device__ __forceinline__ uint32_t slot_sums(uint32_t base, const NarrowPlan& p, uint32_t key) {
  return base + p.sums + (key >> 4) * p.np * SUM_STRIDE * 4;
}

__device__ __forceinline__ int limb_shift(uint32_t key) {
  return 8 * (4 - ((key >> 2 & 3) + 1) + (key & 3));
}

// A warp's sums of one (slot, m) into the block's sums: limb m's
// shift as add_tile's, rows past the batch left out.
template <int U, int NT>
__device__ __forceinline__ void narrow_fold(uint32_t base, const NarrowPlan& p,
                                            int32_t (&d)[U][NT][4], uint32_t key, int B) {
  const int lane = thread_idx() & 31, gq = lane >> 2, t = lane & 3;
  const int shift = limb_shift(key);
  const uint32_t sums = slot_sums(base, p, key);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int x = 16 * u + gq;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = 8 * nt + 2 * t;
      const uint32_t at = sums + 4 * (n * SUM_STRIDE + x);
      if (n < B) {
        red_shared(at, (uint32_t)d[u][nt][0] << shift);
        red_shared(at + 32, (uint32_t)d[u][nt][2] << shift);
      }
      if (n + 1 < B) {
        red_shared(at + 4 * SUM_STRIDE, (uint32_t)d[u][nt][1] << shift);
        red_shared(at + 4 * SUM_STRIDE + 32, (uint32_t)d[u][nt][3] << shift);
      }
    }
  }
}

template <int U, int NT>
__device__ __forceinline__ void narrow_zero(int32_t (&d)[U][NT][4]) {
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[u][nt][e] = 0;
}

// A warp's items of a step (its range of the block's list), each 4 m16
// tiles x 4 chunks of 32 bytes x NT row groups, the sums kept across the
// items of one (slot, m).
template <int NT>
__device__ __forceinline__ void narrow_gemm(uint32_t base, const NarrowPlan& p, int n_items,
                                            int B) {
  constexpr int U = 4, NS = 4 * U + 6;
  const int lane = thread_idx() & 31, warp = thread_idx() >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int lo = n_items * warp / NARROW_WARPS, hi = n_items * (warp + 1) / NARROW_WARPS;
  int32_t d[U][NT][4];
  narrow_zero(d);
  uint32_t key = ~0u;
  for (int it = lo; it < hi; ++it) {
    const uint32_t item = lds32(base + p.items + 4 * it);
    if (item >> 16 != key) {
      if (it > lo) {
        narrow_fold(base, p, d, key, B);
        narrow_zero(d);
      }
      key = item >> 16;
    }
    const uint4 span = lds128(base + p.spans + 16 * (item & 0xFFFFu));
    const uint32_t q = span.x + (key & 3) * span.y + 1 + gq + 32 * t;
    const uint32_t qa = q & ~3u, sh = 8 * (q & 3);
    uint32_t w[NS + 1], s[NS];
#pragma unroll
    for (int j = 0; j <= NS; ++j) w[j] = lds32(qa + 4 * j);
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = __funnelshift_r(w[j], w[j + 1], sh);
    // Row 8nt + gq of the span's digit tile: its bytes 32t.. are 16-byte
    // chunks 2t and 2t+1, swizzled by the row's place in its 8 (gq).
    const uint32_t row = base + (item & 0xFFFFu) * p.np * BK + gq * BK;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint4 b0 = lds128(row + nt * 8 * BK + (((2 * t) ^ gq) << 4));
      const uint4 b1 = lds128(row + nt * 8 * BK + (((2 * t + 1) ^ gq) << 4));
      const uint32_t b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int u = 0; u < U; ++u)
          mma_s8(d[u][nt], s[4 * u + 2 * cc], s[4 * u + 2 * cc + 2], s[4 * u + 2 * cc + 1],
                 s[4 * u + 2 * cc + 3], b[2 * cc], b[2 * cc + 1]);
    }
  }
  if (hi > lo) narrow_fold(base, p, d, key, B);
}

// The block's sums of a step added into acc, each output it touched once,
// and cleared for the next step.
__device__ __forceinline__ void narrow_add(uint32_t base, const NarrowPlan& p, uint32_t* acc,
                                           int n_slots, const Args& a) {
  const int k1 = a.k + 1;
  for (int slot = 0; slot < n_slots; ++slot) {
    const int o = (int)lds32(base + p.slots + 8 * slot);
    const int j0 = (int)lds32(base + p.slots + 8 * slot + 4);
    const uint32_t sums = base + p.sums + slot * p.np * SUM_STRIDE * 4;
    for (int idx = thread_idx(); idx < BN * a.B; idx += THREADS) {
      const int x = idx & (BN - 1), n = idx / BN;
      const uint32_t at = sums + 4 * (n * SUM_STRIDE + x);
      const uint32_t v = lds32(at);
      if (v != 0) {
        atomicAdd(acc + ((size_t)n * k1 + o) * a.N + j0 + x, v);
        sts32(at, 0);
      }
    }
  }
}

// The body of both narrow kernels; INIT, amt, vv, digits and acc as in
// gen_rotation.  NT: row groups of 8 (narrow_groups(a.B)).  Step s's digit
// phase reads acc only after barrier 2 of step s-1, and its adds land only
// after its barrier 1, as in gen_rotation.
template <bool INIT, int NT>
__device__ __forceinline__ void narrow_rotation(const CUtensorMap* digits_map, uint32_t* acc,
                                                const int32_t* amt, const int8_t* vv,
                                                int8_t* digits, unsigned int* grid_bar,
                                                const Args& a, const NarrowPlan& p) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  if (thread_idx() == 0) {
    mbar_init(base + p.bars, 1);
    mbar_init(base + p.bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    narrow_tables(base, a, p);
  }
  for (int i = thread_idx(); i < p.max_slots * p.np * SUM_STRIDE; i += THREADS)
    sts32(base + p.sums + 4 * i, 0);
  __syncthreads();
  const uint4 head = lds128(base + p.head);
  const int n_sp = head.x, n_runs = head.y, n_slots = head.z, n_items = head.w;
  const int wbytes = (int)lds32(base + p.head + 16);
  if constexpr (INIT) init_accumulator(acc, amt, a.B, a.N, a.k, a.mu);
  const int G = (a.k + 1) * a.l, C = a.k * a.mask_limbs + a.body_limbs;
  const size_t vv_step = (size_t)G * C * 2 * a.N;
  unsigned int bar = 0;
  if constexpr (INIT) grid_sync(grid_bar, bar);  // the initial acc exists
  for (int s = 0; s < a.n_steps; ++s) {
    if (thread_idx() == 0 && n_sp > 0)
      narrow_fetch(base, p, vv + s * vv_step, n_runs, wbytes, a.N);
    digit_phase<false>(acc, amt + (size_t)(s + INIT) * a.B, digits, a);
    grid_sync(grid_bar, bar);  // every digit of the step exists
    if (n_sp > 0) {
      if (thread_idx() == 0) narrow_digits(base, p, digits_map, n_sp);
      mbar_wait(base + p.bars, s & 1);
      mbar_wait(base + p.bars + 8, s & 1);
      narrow_gemm<NT>(base, p, n_items, a.B);
    }
    __syncthreads();
    narrow_add(base, p, acc, n_slots, a);
    grid_sync(grid_bar, bar);  // every add of the step has landed
  }
}

// The layout for a grid of `grid` blocks or more at NT row groups (the
// bounds hold for any block: a contiguous range of max_spans spans touches
// at most max_slots output tiles and max_runs (tile, g) runs).
inline NarrowPlan narrow_plan(const Args& a, int nt, int grid) {
  NarrowPlan p{};
  const int KT = a.N / BK, P = (a.k + 1) * a.l * KT, SP = (a.k + 1) * (a.N / BN) * P;
  p.np = 8 * nt;
  p.max_spans = (SP + grid - 1) / grid;
  p.max_slots = (p.max_spans + P - 2) / P + 1;
  p.max_runs = (p.max_spans + KT - 2) / KT + 1;
  p.max_items = p.max_spans * 4;
  int off = p.max_spans * p.np * BK;  // the digit tiles, from 0
  p.sums = off;
  off += p.max_slots * p.np * SUM_STRIDE * 4;
  p.win = off;
  off += 4 * (BK * p.max_spans + WIN_TAIL * p.max_runs);
  p.bars = off;
  off += 16;
  p.head = off;
  off += 32;
  p.spans = off;
  off += 16 * p.max_spans;
  p.runs = off;
  off += 16 * p.max_runs;
  p.slots = off;
  off += 8 * p.max_slots;
  p.items = off;
  off += 4 * p.max_items;
  p.smem = 1024 + off;
  return p;
}

// Launches `kernel` (a narrow_rotation<INIT, nt> wrapper taking digits_map,
// acc, amt, vv, digits, grid_bar, a and its NarrowPlan) cooperatively on
// one block an SM.  Requires N % 128 == 0 and a.B <= 8 * nt.  Returns the
// first CUDA error (0 on success).
template <typename Kernel>
inline int launch_narrow(Kernel kernel, int nt, void* acc, const void* amt, const void* vv,
                         void* digits, void* grid_bar, Args a, void* stream) {
  if (a.N % BK || nt < 1 || a.B > 8 * nt) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const NarrowPlan plan = narrow_plan(a, nt, sms);
  if (plan.smem > limit) return (int)cudaErrorInvalidConfiguration;
  int blocks = 0;
  err = resident_blocks(kernel, plan.smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap digits_map{};
  err = encode_map(&digits_map, digits, (uint64_t)a.B, (uint64_t)(a.k + 1) * a.l * a.N, plan.np);
  if (err != cudaSuccess) return (int)err;
  uint32_t* acc_p = static_cast<uint32_t*>(acc);
  const int32_t* amt_p = static_cast<const int32_t*>(amt);
  const int8_t* vv_p = static_cast<const int8_t*>(vv);
  int8_t* digits_p = static_cast<int8_t*>(digits);
  unsigned int* bar_p = static_cast<unsigned int*>(grid_bar);
  void* args[] = {&digits_map, &acc_p, &amt_p, &vv_p, &digits_p, &bar_p, &a, (void*)&plan};
  return (int)launch_cooperative_on(kernel, sms, plan.smem, args,
                                    static_cast<cudaStream_t>(stream));
}

}  // namespace rot
}  // namespace peba1
