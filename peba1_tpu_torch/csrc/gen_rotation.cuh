// Device code of the two kernels that form each CMUX step's negacyclic
// Toeplitz weights on the fly from the small doubled generator bk_tp:
// blind_rotate_gen_full.cu (the whole rotation, acc set up in the kernel)
// and cmux_step_gen.cu (S steps on an acc that comes in and is updated in
// place).  Both run whole_rotation.cuh's skeleton; they differ only in
// gen_rotation's INIT.  Their recording instances (*_phases.cu) compile the
// same body with PHASES (below).
//
// Toeplitz direction: with the digits in reversed coefficient order
// (k = N-1-t), the weight is W'[k, j] = vv[1+k+j], so the K-major bytes of
// column j over contraction bytes k0..k0+127 are the contiguous window
// vv[1+j+k0 : 1+j+k0+128].  The producer warpgroup fetches the window of
// generator bytes a work item reads (N + 80 bytes a limb) into shared memory
// by bulk copy, one unit ahead (a step's first unit's as the step begins, so
// that they land under its digit phase), and builds each 16-byte chunk of a
// column from aligned 32-bit reads with funnel shifts (two reads a chunk:
// columns four apart share words), stored at its 128-byte-swizzled place;
// the ring's first weight tiles of a step are built inside barrier 1.  The
// digit tile comes by TMA, after the barrier.  An item is the whole contraction (the entry
// points set a.split = 1), and a step's items are walked by stage
// (whole_rotation.cuh's piece_at).  The walk below still divides by
// a.split: with it folded away, the same walk compiled to code up to 2%
// slower on the H100 (PERF.md §6).

#pragma once

#include "whole_rotation.cuh"

namespace peba1 {
namespace rot {

// --- the record of a step's phases (the PHASES instance) --------------------
//
// The instance of kernels 1 and 2 compiled with PHASES (sources of their own,
// blind_rotate_gen_full_phases.cu and cmux_step_gen_phases.cu, C entries
// peba1_*_phases; only the tools launch it) stores, for each step of a window
// [first, first + count) and each block, one record of REC_WORDS uint64
// words per role: thread 0 (consumer warpgroup 0), thread 128 (consumer
// warpgroup 1) and thread 256 (the producer), from word
//   REC_HEADER + (((step - first) * grid + block) * REC_ROLES + role) * REC_WORDS.
// Timer words (ns, %globaltimer, comparable across SMs) line the blocks up
// against each other; the cycle words (the SM's clock) time what happens
// inside one SM; nothing is stored per stage.  The header: the grid, the
// window, the first REC_TICKS steps by which block 0's thread 0 saw the
// timer advance, read in a loop after the last step, and the ns that
// REC_TIMER_READS stamps take in a row, each a read of the timer and a store
// that waits for it (what a stamp costs the thread).  Every word of the
// header and of the window's records is written, so the buffer needs no
// clearing.
// step_phases.py mirrors these numbers (tests/test_torch_phases.py checks it).
constexpr int REC_HEADER = 16;          // header words before the records
constexpr int REC_TICKS = 12;           // timer steps in the header, from word 3
constexpr int REC_TIMER_READS = 64;     // header word 15: ns of this many stamps in a row
constexpr int REC_ROLES = 3;            // consumer warpgroups 0, 1; producer
constexpr int REC_WORDS = 23;           // words of one record
constexpr int REC_T_START = 0;          // timer: the step starts
constexpr int REC_T_DIGITS = 1;         // timer: this thread's digit phase ends
constexpr int REC_T_BAR1_ARRIVE = 2;    // timer, thread 0: the block arrives at barrier 1
constexpr int REC_T_BAR1_SEEN = 3;      // timer, thread 0: it sees the last block's arrival
constexpr int REC_T_BAR1_EXIT = 4;      // timer: this thread leaves barrier 1
constexpr int REC_T_GEMM_END = 5;       // timer: this role's GEMM phase ends
constexpr int REC_T_BAR2_ARRIVE = 6;    // timer, thread 0: as at barrier 1
constexpr int REC_T_BAR2_SEEN = 7;
constexpr int REC_T_BAR2_EXIT = 8;
constexpr int REC_GEMM_CYCLES = 9;      // cycles from barrier 1's exit to the GEMM end
constexpr int REC_FILL = 10;            // Phases::fill, then wait, wait2, work, last, issue
constexpr int REC_WAIT = 11;
constexpr int REC_WAIT2 = 12;
constexpr int REC_WORK = 13;
constexpr int REC_LAST = 14;
constexpr int REC_ISSUE = 15;
constexpr int REC_STAGES = 16;          // stages this role's walk ran in the step
constexpr int REC_PIECES = 17;          // its pieces (consumers) or units (producer)
constexpr int REC_TAG = 18;             // step << 32 | block << 8 | (role + 1)
constexpr int REC_T_EARLY_END = 19;     // timer, producer: its work before barrier 1's end ends
constexpr int REC_EARLY_WAIT = 20;      // Early::wait, work, stages (producer; 0 for consumers)
constexpr int REC_EARLY_WORK = 21;
constexpr int REC_EARLY = 22;

// The record window, a kernel parameter of the PHASES instance.
struct PhaseRec {
  uint64_t* rec;
  int first, count;
};

// This thread's record of step s, or null: the step is outside the window,
// or the thread is not the first of its warpgroup.
__device__ __forceinline__ uint64_t* record_of(const PhaseRec& pr, int s) {
  const int t = thread_idx(), i = s - pr.first;
  if ((t & 127) != 0 || i < 0 || i >= pr.count) return nullptr;
  return pr.rec + REC_HEADER +
         (((size_t)i * gridDim.x + blockIdx.x) * REC_ROLES + (t >> 7)) * REC_WORDS;
}

__device__ __forceinline__ void stamp(uint64_t* rec, int word) {
  if (rec) rec[word] = global_ns();
}

// After barrier 1 of a step: its start and its digit phase's end, read
// before and stored only now (a store waits for its read, and the thread
// had the barrier to wait at anyway), then the barrier's exit.
__device__ __forceinline__ void record_bar1(uint64_t* rec, uint64_t t_start, uint64_t t_digits) {
  if (!rec) return;
  rec[REC_T_START] = t_start;
  rec[REC_T_DIGITS] = t_digits;
  rec[REC_T_BAR1_EXIT] = global_ns();
}

// The header: the grid, the window, the steps of the timer as block 0's
// thread 0 sees it advance (its resolution), each at most 2^22 reads apart,
// and the ns of REC_TIMER_READS stamps in a row.
__device__ __forceinline__ void record_header(const PhaseRec& pr) {
  if (blockIdx.x != 0 || thread_idx() != 0) return;
  pr.rec[0] = gridDim.x;
  pr.rec[1] = (uint64_t)pr.first;
  pr.rec[2] = (uint64_t)pr.count;
  volatile uint64_t* cost = pr.rec + 3 + REC_TICKS;
  const uint64_t t0 = global_ns();
  uint64_t t = t0;
  for (int i = 0; i < REC_TIMER_READS; ++i) *cost = t = global_ns();
  *cost = t - t0;
  uint64_t prev = global_ns();
  for (int i = 0; i < REC_TICKS; ++i) {
    uint64_t now = prev;
    for (int spin = 0; spin < (1 << 22) && now == prev; ++spin) now = global_ns();
    pr.rec[3 + i] = now - prev;
    prev = now;
  }
}

// Registers a producer thread keeps (the consumers get (504 - 104) / 2 =
// 200); at 88 kernel 2's producer spills with the walk by stage.
constexpr int PRODUCER_REGS = 104;

// Bytes of one limb's generator window in shared memory: vv[j0 + y] for
// y < N + 80, which covers every byte a tile reads (y <= N + 67: words from
// y <= N + 36, the bytes it keeps y <= N + 63).
__host__ __device__ __forceinline__ int window_bytes(int N) { return N + 80; }

// Starts the bulk copy (the async proxy, one thread) of the generator
// windows of nl limb rows at src (2N bytes apart) into win (window_bytes(N)
// apart), `bytes` a row, completing on the mbarrier wbar.  A row ends at
// 2N: where its window would pass the end, `bytes` stops there, and the
// words a tile reads past it hold no byte it keeps.
__device__ __forceinline__ void fetch_window(uint32_t win, uint32_t wbar, const int8_t* src,
                                             int nl, int bytes, int N) {
  mbar_arrive_expect_tx(wbar, nl * bytes);
  for (int m = 0; m < nl; ++m)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(win + m * window_bytes(N)), "l"(src + (size_t)m * 2 * N), "r"(bytes), "r"(wbar)
        : "memory");
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

// Named barrier of a block's arrival at barrier 1 of a step
// (whole_rotation.cuh's grid_sync<PHASES, BAR1_ARRIVE>); 1 is producer_sync's.
constexpr int BAR1_ARRIVE = 2;

// The producer warpgroup's part in barrier 1: it arrives with the block (a
// barrier.arrive orders its digit stores before thread 0's release as a
// barrier.sync does) and goes on without waiting for the grid; then, after
// its work that needs no digit, it joins the block barrier that follows
// thread 0's wait.
__device__ __forceinline__ void producer_arrive() {
  asm volatile("barrier.arrive %0, %1;" ::"n"(BAR1_ARRIVE), "n"(THREADS) : "memory");
}

__device__ __forceinline__ void producer_join() { asm volatile("barrier.sync 0;" ::: "memory"); }

// What the producer did before barrier 1's end in a recorded step (PHASES):
// the timer as it ended, the cycles until its first unit's windows had
// landed (and the second's fetch was issued), the cycles expanding, and the
// stages expanded.
struct Early {
  uint64_t end = 0;
  uint32_t wait = 0, work = 0, stages = 0;
};

// Where a unit's operands lie, the same in every step of a launch: its
// first limb's window in a step's key (((g * C + c0) * 2N + j0), the bytes
// of each limb's window (window_bytes(N), or to the row's end), its limbs,
// the digit tiles' column at stage 0 of its polynomial (g * N) and row (the
// item's m0), and its stages [h0, h1).
struct UnitRef {
  int key, bytes, nl, col, row, h0, h1, pad;
};

// The producer keeps the first UNIT_REFS units of its block's walk
// (unit_at, item_at) in shared memory, worked out once a launch; a walk
// longer than that (over about 10,000 rows at N = 1024) works out the rest
// as it goes.  The walk's index arithmetic, divisions by values known only
// at run time, took 0.5-0.7 µs a unit on the producer's path (PERF.md §6).
constexpr int UNIT_REFS = 128;

// Shared memory of kernels 1 and 2 past the ring's barriers: two buffers of
// generator windows (up to four limbs each), their two mbarriers, the refs.
__host__ __device__ __forceinline__ int gen_extra(int N) {
  return 2 * 4 * window_bytes(N) + 16 + UNIT_REFS * (int)sizeof(UnitRef);
}
__device__ __forceinline__ uint32_t window_bar(uint32_t win, int N, int b) {
  return win + 2 * 4 * window_bytes(N) + 8 * b;
}
__device__ __forceinline__ uint32_t refs_at(uint32_t win, int N) {
  return win + 2 * 4 * window_bytes(N) + 16;
}

__device__ __forceinline__ UnitRef unit_ref(int u, int per_split, const Args& a) {
  const Unit un = unit_at(u, per_split, a);
  const Item it = item_at(un.idx, a);
  const int g = it.split * per_split + un.gl, C = a.k * a.mask_limbs + a.body_limbs;
  return {(g * C + it.c0) * 2 * a.N + it.j0, min(window_bytes(a.N), 2 * a.N - it.j0), it.nl,
          g * a.N, it.m0, un.h0, un.h1, 0};
}

// Unit u's ref: from the table below UNIT_REFS, else worked out.
__device__ __forceinline__ UnitRef ref_of(int u, uint32_t win, const Args& a) {
  if (u >= UNIT_REFS) return unit_ref(u, (a.k + 1) * a.l / a.split, a);
  const uint32_t at = refs_at(win, a.N) + u * (int)sizeof(UnitRef);
  UnitRef ref;
  asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(ref.key), "=r"(ref.bytes), "=r"(ref.nl), "=r"(ref.col)
               : "r"(at) : "memory");
  asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(ref.row), "=r"(ref.h0), "=r"(ref.h1), "=r"(ref.pad)
               : "r"(at + 16) : "memory");
  return ref;
}

// The producer warpgroup, once a launch: the window buffers' mbarriers
// (thread 256) and the table of its block's first UNIT_REFS units.
__device__ __forceinline__ void set_up_units(uint32_t win, const Args& a) {
  const int ptid = thread_idx() - 2 * 128;
  if (ptid == 0) {
    mbar_init(window_bar(win, a.N, 0), 1);
    mbar_init(window_bar(win, a.N, 1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int u = ptid; u < UNIT_REFS; u += 128) {
    const UnitRef ref = unit_ref(u, (a.k + 1) * a.l / a.split, a);
    const uint32_t at = refs_at(win, a.N) + u * (int)sizeof(UnitRef);
    sts128(at, ref.key, ref.bytes, ref.nl, ref.col);
    sts128(at + 16, ref.row, ref.h0, ref.h1, ref.pad);
  }
  producer_sync();
}

// Starts the fetch of unit u's generator windows of step key vv_s into the
// window buffer of its parity, by thread 256, if the unit is not empty.
__device__ __forceinline__ void fetch_unit(int u, const int8_t* vv_s, uint32_t win,
                                           const Args& a) {
  if (thread_idx() != 2 * 128) return;
  const UnitRef ref = ref_of(u, win, a);
  if (ref.h0 >= ref.h1) return;
  fetch_window(win + (u & 1) * 4 * window_bytes(a.N), window_bar(win, a.N, u & 1),
               vv_s + ref.key, ref.nl, ref.bytes, a.N);
}

// Waits until unit u's windows have landed, then until the whole producer
// warpgroup has (the other buffer is then free).  wpar: bit b, the parity of
// buffer b's next fetch.
__device__ __forceinline__ void await_windows(int u, uint32_t win, int N, uint32_t& wpar) {
  mbar_wait(window_bar(win, N, u & 1), (wpar >> (u & 1)) & 1u);
  wpar ^= 1u << (u & 1);
  producer_sync();
}

// The producer warpgroup's work of a step that needs no digit, done while
// thread 0 waits in barrier 1: the first unit's windows (fetched as the
// step began) awaited and the second unit's fetched, then the weight tiles
// of the first unit's first stages expanded into the ring's next stages,
// which barrier 2 of the step before left empty.  As many as the ring's
// depth less one, so that after barrier 1 the producer expands the next
// stage while their digit tiles land instead of waiting on `empty`; one
// below a full row tile, whose digit tile comes later (mostly rows past the
// batch, filled with zeros): there the producer would wait on `empty` for
// the consumers' first stages (PERF.md §6).  r is a copy (produce_step
// advances the ring as it arrives).  Returns the stages expanded, 0 on an
// empty walk.
template <bool PHASES = false>
__device__ __forceinline__ int expand_early(Ring r, const int8_t* vv_s, uint32_t win,
                                            uint32_t& wpar, const Args& a, Early* e = nullptr) {
  const int ptid = thread_idx() - 2 * 128;
  const UnitRef first = ref_of(0, win, a);
  if (first.h0 >= first.h1) return 0;
  [[maybe_unused]] uint32_t c0 = 0;
  if constexpr (PHASES) c0 = sm_clock();
  await_windows(0, win, a.N, wpar);
  fetch_unit(1, vv_s, win, a);
  if constexpr (PHASES) {
    const uint32_t c1 = sm_clock();
    e->wait = c1 - c0;
    c0 = c1;
  }
  const int early = min(a.B < BM ? 1 : r.stages - 1, first.h1 - first.h0);
  for (int i = 0; i < early; ++i) {
    r.wait_empty();
    expand_tile(r.b_tile(), win, first.nl, first.h0 + i, a.N, ptid);
    fence_proxy_async_shared();  // the generic stores, before wgmma reads them
    r.advance();
  }
  if constexpr (PHASES) {
    e->work = sm_clock() - c0;
    e->stages = early;
  }
  return early;
}

// The producer warpgroup in one step, after barrier 1: every stage of the
// block's pieces.  The units run in order; each unit's generator windows
// are fetched into one of two buffers while the unit before it is expanded
// (the first unit's, and the fetch of the second's, before barrier 1).  The
// first unit's first `early` stages were expanded before barrier 1
// (expand_early): only their digit tiles are issued.  With PHASES, its
// waits and expansions are timed into *ph.
template <bool PHASES = false>
__device__ __forceinline__ void produce_step(Ring& r, const CUtensorMap* digits_map,
                                             const int8_t* vv_s, uint32_t win, uint32_t& wpar,
                                             const Args& a, int early, Phases* ph = nullptr) {
  const int ptid = thread_idx() - 2 * 128;
  [[maybe_unused]] uint32_t c0 = 0;
  for (int unit = 0;; ++unit) {
    const UnitRef un = ref_of(unit, win, a);
    if (un.h0 >= un.h1) break;
    if constexpr (PHASES) ph->walk += (un.h1 - un.h0) + (1u << WALK_PIECE);
    if (unit > 0) {
      if constexpr (PHASES) c0 = sm_clock();
      await_windows(unit, win, a.N, wpar);  // this unit's windows; the other buffer is free
      if constexpr (PHASES) {
        const uint32_t c1 = sm_clock();
        ph->wait2 += c1 - c0;
        if (ph->last == 0) ph->last = c1 - ph->start;
      }
      fetch_unit(unit + 1, vv_s, win, a);
    }
    const uint32_t w = win + (unit & 1) * 4 * window_bytes(a.N);
    int h = un.h0;
    for (; h < un.h0 + early; ++h) {  // expanded before barrier 1
      if constexpr (PHASES) c0 = sm_clock();
      if (ptid == 0) {
        mbar_expect_tx(r.full(r.stage), A_BYTES);
        tma_load_2d(r.a_tile(), digits_map, r.full(r.stage), un.col + h * BK, un.row);
      }
      if constexpr (PHASES) {
        const uint32_t c1 = sm_clock();
        ph->issue += c1 - c0;
        if (ph->fill == 0) ph->fill = c1 - ph->start;
      }
      mbar_arrive(r.full(r.stage));
      r.advance();
    }
    early = 0;
    for (; h < un.h1; ++h) {
      if constexpr (PHASES) c0 = sm_clock();
      r.wait_empty();
      if constexpr (PHASES) {
        const uint32_t c1 = sm_clock();
        ph->wait += c1 - c0;
        c0 = c1;
      }
      if (ptid == 0) {
        mbar_expect_tx(r.full(r.stage), A_BYTES);
        tma_load_2d(r.a_tile(), digits_map, r.full(r.stage), un.col + h * BK, un.row);
      }
      if constexpr (PHASES) {
        const uint32_t c1 = sm_clock();
        ph->issue += c1 - c0;
        c0 = c1;
      }
      expand_tile(r.b_tile(), w, un.nl, h, a.N, ptid);
      fence_proxy_async_shared();  // the generic stores, before wgmma reads them
      if constexpr (PHASES) {
        const uint32_t c1 = sm_clock();
        ph->work += c1 - c0;
        if (ph->fill == 0) ph->fill = c1 - ph->start;
      }
      mbar_arrive(r.full(r.stage));
      r.advance();
    }
  }
}

// The end of a recorded step's GEMM phase for this role: the timer, the
// cycle totals, the stages and pieces (or units) its walk ran, and the
// producer's work before barrier 1's end (zeros for the consumers).
__device__ __forceinline__ void record_gemm(uint64_t* rec, const Phases& ph, const Early& e,
                                            int s) {
  const uint32_t cycles = sm_clock() - ph.start;
  const uint64_t end = global_ns();  // stored last, once the read has landed
  rec[REC_GEMM_CYCLES] = cycles;
  rec[REC_FILL] = ph.fill;
  rec[REC_WAIT] = ph.wait;
  rec[REC_WAIT2] = ph.wait2;
  rec[REC_WORK] = ph.work;
  rec[REC_LAST] = ph.last;
  rec[REC_ISSUE] = ph.issue;
  rec[REC_STAGES] = ph.walk & ((1u << WALK_PIECE) - 1);
  rec[REC_PIECES] = ph.walk >> WALK_PIECE;
  rec[REC_TAG] =
      (uint64_t)s << 32 | (uint64_t)blockIdx.x << 8 | (uint64_t)((thread_idx() >> 7) + 1);
  rec[REC_T_EARLY_END] = e.end;
  rec[REC_EARLY_WAIT] = e.wait;
  rec[REC_EARLY_WORK] = e.work;
  rec[REC_EARLY] = e.stages;
  rec[REC_T_GEMM_END] = end;
}

// The recording instance's steps (PHASES): gen_rotation's loops after its
// set-up, with each step of pr's window recorded (see REC_*); the same
// digits, products and adds in the same order.
template <bool INIT>
__device__ __forceinline__ void record_steps(Ring& r, const CUtensorMap* digits_map,
                                             uint32_t* acc, const int32_t* amt,
                                             const int8_t* vv, int8_t* digits,
                                             unsigned int* grid_bar, const Args& a,
                                             const PhaseRec& pr, int n_st, size_t vv_step,
                                             unsigned int& bar) {
  uint64_t* rec = nullptr;
  uint64_t t_start = 0, t_digits = 0;
  Phases ph;
  Early e;
  if (warpgroup() == 2) {
    producer_registers<PRODUCER_REGS>();
    set_up_units(r.extra, a);
    uint32_t wpar = 0;
    if constexpr (INIT) grid_sync(grid_bar, bar);  // the initial acc exists
    for (int s = 0; s < a.n_steps; ++s) {
      rec = record_of(pr, s);
      if (rec) t_start = global_ns();
      const int8_t* vv_s = vv + s * vv_step;
      fetch_unit(0, vv_s, r.extra, a);
      digit_phase<false>(acc, amt + (size_t)(s + INIT) * a.B, digits, a);
      if (rec) t_digits = global_ns();
      producer_arrive();  // every digit of the step exists, once the grid has arrived
      e = Early{};
      const int early = expand_early<true>(r, vv_s, r.extra, wpar, a, &e);
      if (rec) e.end = global_ns();
      producer_join();
      fence_proxy_async_global();
      if (rec) rec[REC_T_BAR1_ARRIVE] = rec[REC_T_BAR1_SEEN] = 0;  // thread 0's stamps
      record_bar1(rec, t_start, t_digits);
      ph = Phases{};
      ph.start = sm_clock();
      produce_step<true>(r, digits_map, vv_s, r.extra, wpar, a, early, &ph);
      if (rec) record_gemm(rec, ph, e, s);
      // every acc add of the step has landed
      grid_sync<true>(grid_bar, bar, rec ? rec + REC_T_BAR2_ARRIVE : nullptr);
      stamp(rec, REC_T_BAR2_EXIT);
    }
  } else {  // consumer warpgroups 0 and 1
    consumer_registers<PRODUCER_REGS>();
    if constexpr (INIT) grid_sync(grid_bar, bar);
    for (int s = 0; s < a.n_steps; ++s) {
      rec = record_of(pr, s);
      if (rec) t_start = global_ns();
      digit_phase<false>(acc, amt + (size_t)(s + INIT) * a.B, digits, a);
      if (rec) t_digits = global_ns();
      grid_sync<true, BAR1_ARRIVE>(grid_bar, bar, rec ? rec + REC_T_BAR1_ARRIVE : nullptr);
      record_bar1(rec, t_start, t_digits);
      ph = Phases{};
      ph.start = sm_clock();
      consume_step_by_stage<true>(r, acc, n_st, a, &ph);
      if (rec) record_gemm(rec, ph, e, s);
      grid_sync<true>(grid_bar, bar, rec ? rec + REC_T_BAR2_ARRIVE : nullptr);
      stamp(rec, REC_T_BAR2_EXIT);
    }
  }
  record_header(pr);
}

// The body of both kernels.  INIT (kernel 2): amt is (n_steps+1, B), row 0
// the initial body rotation; acc is written as [0 | X^amt[0] * mu] first and
// row s+1 is step s's rotation.  Otherwise (kernel 1): amt is (n_steps, B),
// row s step s's rotation, and acc comes in.  vv is (n_steps, G, C, 2N);
// digits_map views the (B, G*N) digits.  Step s's digit phase reads acc
// only after the grid barrier that ends step s-1's adds, and its GEMM phase
// adds into acc only after the grid barrier that ends its digit phase: no
// digit of a step is read after an acc element of that step is written.
// The producer warpgroup starts the step's first generator windows before
// its digit phase and expands the ring's first weight tiles inside barrier
// 1 (expand_early); it issues their digit tiles only after the barrier.
// PHASES (the recording instance, *pr its window): the steps of
// record_steps.  The default instance's code holds nothing of the recorder:
// a trace of it there (a Phases on the stack) changed kernel 2's machine code.
template <bool INIT, bool PHASES = false>
__device__ __forceinline__ void gen_rotation(const CUtensorMap* digits_map, uint32_t* acc,
                                             const int32_t* amt, const int8_t* vv,
                                             int8_t* digits, unsigned int* grid_bar,
                                             const Args& a, const PhaseRec* pr = nullptr) {
  extern __shared__ uint8_t smem[];
  Ring r = make_ring(smem, a.stages, 128);  // every producer thread arrives
  __syncthreads();
  if constexpr (INIT) init_accumulator(acc, amt, a.B, a.N, a.k, a.mu);
  const int G = (a.k + 1) * a.l, C = a.k * a.mask_limbs + a.body_limbs;
  const int n_st = G / a.split * (a.N / BK);
  const size_t vv_step = (size_t)G * C * 2 * a.N;
  unsigned int bar = 0;
  if constexpr (PHASES) {
    record_steps<INIT>(r, digits_map, acc, amt, vv, digits, grid_bar, a, *pr, n_st, vv_step,
                       bar);
    return;
  }
  if (warpgroup() == 2) {
    producer_registers<PRODUCER_REGS>();
    set_up_units(r.extra, a);
    uint32_t wpar = 0;  // bit b: the parity of window buffer b's next fetch
    if constexpr (INIT) grid_sync(grid_bar, bar);  // the initial acc exists
    for (int s = 0; s < a.n_steps; ++s) {
      const int8_t* vv_s = vv + s * vv_step;
      fetch_unit(0, vv_s, r.extra, a);
      digit_phase<false>(acc, amt + (size_t)(s + INIT) * a.B, digits, a);
      producer_arrive();  // every digit of the step exists, once the grid has arrived
      const int early = expand_early(r, vv_s, r.extra, wpar, a);
      producer_join();
      fence_proxy_async_global();
      produce_step(r, digits_map, vv_s, r.extra, wpar, a, early);
      grid_sync(grid_bar, bar);  // every acc add of the step has landed
    }
  } else {  // consumer warpgroups 0 and 1
    consumer_registers<PRODUCER_REGS>();
    if constexpr (INIT) grid_sync(grid_bar, bar);
    for (int s = 0; s < a.n_steps; ++s) {
      digit_phase<false>(acc, amt + (size_t)(s + INIT) * a.B, digits, a);
      grid_sync<false, BAR1_ARRIVE>(grid_bar, bar);
      consume_step_by_stage(r, acc, n_st, a);
      grid_sync(grid_bar, bar);
    }
  }
}

// Launches `kernel` (a gen_rotation<INIT> wrapper taking digits_map, acc,
// amt, vv, digits, grid_bar, a, and in the PHASES instance a PhaseRec)
// cooperatively; a.stages and the walk's shares are set here, a.split must
// be 1.  Requires N % 128 == 0.  With `pr`, its buffer must hold the records
// of `rec_blocks` blocks or more.  Returns the first CUDA error (0 on
// success).
template <typename Kernel>
inline int launch_gen_rotation(Kernel kernel, void* acc, const void* amt, const void* vv,
                               void* digits, void* grid_bar, Args a, void* stream,
                               const PhaseRec* pr = nullptr, int rec_blocks = 0) {
  const int G = (a.k + 1) * a.l;
  if (a.N % BK) return (int)cudaErrorInvalidValue;
  const int extra = gen_extra(a.N);
  a.stages = ring_stages(extra);
  if (a.stages == 0) return (int)cudaErrorInvalidConfiguration;
  const int smem = ring_smem(a.stages, extra);
  int blocks = 0;
  cudaError_t err = resident_blocks(kernel, smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  if (pr && blocks > rec_blocks) return (int)cudaErrorInvalidValue;
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
  PhaseRec rec = pr ? *pr : PhaseRec{};
  void* args[] = {&digits_map, &acc_p, &amt_p, &vv_p, &digits_p, &bar_p, &a, &rec};
  return (int)launch_cooperative_on(kernel, blocks, smem, args,
                                    static_cast<cudaStream_t>(stream));
}

}  // namespace rot
}  // namespace peba1
