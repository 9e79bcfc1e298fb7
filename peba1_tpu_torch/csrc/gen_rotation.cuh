// Device code of the two kernels that form each CMUX step's negacyclic
// Toeplitz weights on the fly from the small doubled generator bk_tp:
// blind_rotate_gen_full.cu (the whole rotation, acc set up in the kernel)
// and cmux_step_gen.cu (S steps on an acc that comes in and is updated in
// place).  Both run whole_rotation.cuh's skeleton; they differ only in
// gen_rotation's INIT.
//
// Toeplitz direction: with the digits in reversed coefficient order
// (k = N-1-t), the weight is W'[k, j] = vv[1+k+j], so the K-major bytes of
// column j over contraction bytes k0..k0+127 are the contiguous window
// vv[1+j+k0 : 1+j+k0+128].  The producer warpgroup fetches the window of
// generator bytes a work item reads (N + 80 bytes a limb) into shared memory
// by cp.async, one unit ahead, and builds each 16-byte chunk of a column
// from aligned 32-bit reads with funnel shifts (two reads a chunk: columns
// four apart share words), stored at its 128-byte-swizzled place.  The
// digit tile comes by TMA.  An item is the whole contraction (the entry
// points set a.split = 1), and a step's items are walked by stage
// (whole_rotation.cuh's piece_at).  The walk below still divides by
// a.split: with it folded away, the same walk compiled to code up to 2%
// slower on the H100 (PERF.md §6).

#pragma once

#include "whole_rotation.cuh"

namespace peba1 {
namespace rot {

// Registers a producer thread keeps (the consumers get (504 - 104) / 2 =
// 200); at 88 kernel 2's producer spills with the walk by stage.
constexpr int PRODUCER_REGS = 104;

// Bytes of one limb's generator window in shared memory: vv[j0 + y] for
// y < N + 80, which covers every byte a tile reads (y <= N + 62) and the
// next aligned word.
__host__ __device__ __forceinline__ int window_bytes(int N) { return N + 80; }

// Starts the asynchronous copy of the generator windows of the nl limb rows
// at vv_rows (2N bytes apart) into win: 16-byte cp.async chunks, zeros past
// the row's end.  The caller waits with cp.async.wait_all.
__device__ __forceinline__ void fetch_window(uint32_t win, const int8_t* vv_rows, int nl,
                                             int j0, int N, int ptid) {
  const int chunks = window_bytes(N) / 16;
  for (int idx = ptid; idx < nl * chunks; idx += 128) {
    const int m = idx / chunks, c = idx - m * chunks;
    const uint32_t dst = win + m * window_bytes(N) + 16 * c;
    if (j0 + 16 * c < 2 * N) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                   "l"(vv_rows + (size_t)m * 2 * N + j0 + 16 * c)
                   : "memory");
    } else {
      sts128(dst, 0, 0, 0, 0);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The weight tile of contraction bytes h*128.. of polynomial g: chunk q of
// limb m's column x is vv[1+j0+x+h*128+16q : +16], the five aligned window
// words from byte (1+x+h*128+16q) & ~3 funnel-shifted by 8*((1+x) & 3),
// stored at row x, chunk q ^ (x & 7).  Columns x, x+4, x+8, x+12 share that
// shift and read overlapping words (the tile is Toeplitz), so a thread
// builds those four chunks of one q from eight words.  Thread bits: [1:0]
// x & 3, [2] q / 4, [4:3] which 16 columns, [6:5] q % 4; the 8 threads of a
// store phase hit 8 different 16-byte bank groups.
__device__ __forceinline__ void expand_tile(uint32_t b_tile, uint32_t win, int nl, int h,
                                            int N, int ptid) {
  const int x0 = (ptid & 3) + 16 * ((ptid >> 3) & 3);
  const int q = ((ptid >> 5) & 3) + 4 * ((ptid >> 2) & 1);
  const int p = 1 + x0 + h * BK + 16 * q, sh = 8 * (p & 3);
  for (int m = 0; m < nl; ++m) {
    const uint32_t w = win + m * window_bytes(N) + (p & ~3);
    uint32_t v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = lds32(w + 4 * i);
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int x = x0 + 4 * d;
      sts128(b_tile + m * LIMB_BYTES + x * BK + ((q ^ (x & 7)) << 4),
             __funnelshift_r(v[d], v[d + 1], sh), __funnelshift_r(v[d + 1], v[d + 2], sh),
             __funnelshift_r(v[d + 2], v[d + 3], sh), __funnelshift_r(v[d + 3], v[d + 4], sh));
    }
  }
}

// A unit of the producer: stages [h0, h1) of digit polynomial gl (within
// its split) of work item idx.
struct Unit {
  int idx, gl, h0, h1;
};

// Unit u of this block in a step walked by stage (whole_rotation.cuh's
// piece_at, cut further at the polynomials' boundaries): the units of its
// full-wave items whole, then those of its tail range.  A polynomial is
// hs = N / BK stages and an item per_split polynomials, so the tail's run
// of stages is also a run of units.  Past the last, an empty unit
// (h0 >= h1), so that no count stays live.
__device__ __forceinline__ Unit unit_at(int u, int per_split, const Args& a) {
  const int W = gridDim.x, hs = a.N / BK, n_full = a.full_waves * per_split;
  if (u < n_full) return {(int)blockIdx.x + u / per_split * W, u % per_split, 0, hs};
  const int2 t = tail_range(a);
  const int v = t.x / hs + (u - n_full);  // the unit's place in the tail's run
  return {a.full_waves * W + v / per_split, v % per_split, max(t.x - v * hs, 0),
          min(t.y - v * hs, hs)};
}

// The producer warpgroup in one step: every stage of the block's pieces.
// The units run in order; each unit's generator windows are fetched into
// one of two buffers while the unit before it is expanded.
__device__ __forceinline__ void produce_step(Ring& r, const CUtensorMap* digits_map,
                                             const int8_t* vv_s, uint32_t win, const Args& a) {
  const int ptid = thread_idx() - 2 * 128;
  const int G = (a.k + 1) * a.l, C = a.k * a.mask_limbs + a.body_limbs;
  const int per_split = G / a.split;
  auto fetch = [&](const Unit& un, int unit) {
    const Item it = item_at(un.idx, a);
    const int g = it.split * per_split + un.gl;
    fetch_window(win + (unit & 1) * 4 * window_bytes(a.N),
                 vv_s + ((size_t)g * C + it.c0) * 2 * a.N, it.nl, it.j0, a.N, ptid);
  };
  const Unit first = unit_at(0, per_split, a);
  if (first.h0 < first.h1) fetch(first, 0);
  for (int unit = 0;; ++unit) {
    const Unit un = unit_at(unit, per_split, a);
    if (un.h0 >= un.h1) break;
    const Item it = item_at(un.idx, a);
    const int g = it.split * per_split + un.gl;
    asm volatile("cp.async.wait_all;" ::: "memory");
    producer_sync();  // this unit's windows have landed; the other buffer is free
    const Unit next = unit_at(unit + 1, per_split, a);
    if (next.h0 < next.h1) fetch(next, unit + 1);
    const uint32_t w = win + (unit & 1) * 4 * window_bytes(a.N);
    for (int h = un.h0; h < un.h1; ++h) {
      r.wait_empty();
      if (ptid == 0) {
        mbar_expect_tx(r.full(r.stage), A_BYTES);
        tma_load_2d(r.a_tile(), digits_map, r.full(r.stage), g * a.N + h * BK, it.m0);
      }
      expand_tile(r.b_tile(), w, it.nl, h, a.N, ptid);
      fence_proxy_async_shared();  // the generic stores, before wgmma reads them
      mbar_arrive(r.full(r.stage));
      r.advance();
    }
  }
}

// The body of both kernels.  INIT (kernel 2): amt is (n_steps+1, B), row 0
// the initial body rotation; acc is written as [0 | X^amt[0] * mu] first and
// row s+1 is step s's rotation.  Otherwise (kernel 1): amt is (n_steps, B),
// row s step s's rotation, and acc comes in.  vv is (n_steps, G, C, 2N);
// digits_map views the (B, G*N) digits.  Step s's digit phase reads acc
// only after the grid barrier that ends step s-1's adds, and its GEMM phase
// adds into acc only after the grid barrier that ends its digit phase: no
// digit of a step is read after an acc element of that step is written.
template <bool INIT>
__device__ __forceinline__ void gen_rotation(const CUtensorMap* digits_map, uint32_t* acc,
                                             const int32_t* amt, const int8_t* vv,
                                             int8_t* digits, unsigned int* grid_bar,
                                             const Args& a) {
  extern __shared__ uint8_t smem[];
  Ring r = make_ring(smem, a.stages, 128);  // every producer thread arrives
  __syncthreads();
  if constexpr (INIT) init_accumulator(acc, amt, a.B, a.N, a.k, a.mu);
  const int G = (a.k + 1) * a.l, C = a.k * a.mask_limbs + a.body_limbs;
  const int n_st = G / a.split * (a.N / BK);
  const size_t vv_step = (size_t)G * C * 2 * a.N;
  unsigned int bar = 0;
  if (warpgroup() == 2) {
    producer_registers<PRODUCER_REGS>();
    if constexpr (INIT) grid_sync(grid_bar, bar);  // the initial acc exists
    for (int s = 0; s < a.n_steps; ++s) {
      digit_phase<false>(acc, amt + (size_t)(s + INIT) * a.B, digits, a);
      grid_sync(grid_bar, bar);  // every digit of the step exists
      fence_proxy_async_global();
      produce_step(r, digits_map, vv + s * vv_step, r.extra, a);
      grid_sync(grid_bar, bar);  // every acc add of the step has landed
    }
  } else {  // consumer warpgroups 0 and 1
    consumer_registers<PRODUCER_REGS>();
    if constexpr (INIT) grid_sync(grid_bar, bar);
    for (int s = 0; s < a.n_steps; ++s) {
      digit_phase<false>(acc, amt + (size_t)(s + INIT) * a.B, digits, a);
      grid_sync(grid_bar, bar);
      consume_step_by_stage(r, acc, n_st, a);
      grid_sync(grid_bar, bar);
    }
  }
}

// Launches `kernel` (a gen_rotation<INIT> wrapper taking digits_map, acc,
// amt, vv, digits, grid_bar, a) cooperatively; a.stages and the walk's
// shares are set here, a.split must be 1.  Requires N % 128 == 0.  Returns
// the first CUDA error (0 on success).
template <typename Kernel>
inline int launch_gen_rotation(Kernel kernel, void* acc, const void* amt, const void* vv,
                               void* digits, void* grid_bar, Args a, void* stream) {
  const int G = (a.k + 1) * a.l;
  if (a.N % BK) return (int)cudaErrorInvalidValue;
  const int extra = 2 * 4 * window_bytes(a.N);  // two buffers of up to four limbs
  a.stages = ring_stages(extra);
  if (a.stages == 0) return (int)cudaErrorInvalidConfiguration;
  const int smem = ring_smem(a.stages, extra);
  int blocks = 0;
  cudaError_t err = resident_blocks(kernel, smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  // The walk by stage on this grid: U items of P stages a step.
  const int U = (a.B + BM - 1) / BM * (a.k + 1) * (a.N / BN);  // items_per_step
  const int tail = U % blocks * (G * (a.N / BK));
  a.full_waves = U / blocks;
  a.tail_len = tail / blocks;
  a.tail_longer = tail % blocks;
  CUtensorMap digits_map{};
  err = encode_map(&digits_map, digits, (uint64_t)a.B, (uint64_t)G * a.N, BM);
  if (err != cudaSuccess) return (int)err;
  uint32_t* acc_p = static_cast<uint32_t*>(acc);
  const int32_t* amt_p = static_cast<const int32_t*>(amt);
  const int8_t* vv_p = static_cast<const int8_t*>(vv);
  int8_t* digits_p = static_cast<int8_t*>(digits);
  unsigned int* bar_p = static_cast<unsigned int*>(grid_bar);
  void* args[] = {&digits_map, &acc_p, &amt_p, &vv_p, &digits_p, &bar_p, &a};
  return (int)launch_cooperative_on(kernel, blocks, smem, args,
                                    static_cast<cudaStream_t>(stream));
}

}  // namespace rot
}  // namespace peba1
