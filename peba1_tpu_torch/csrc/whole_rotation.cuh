// Device code of the kernels that run CMUX steps and their GEMMs:
// fused_blind_rotate.cu (kernel 6) and cmux_step.cu (kernels 4 and 5)
// directly, blind_rotate_gen_full.cu and cmux_step_gen.cu (kernels 2 and 1)
// through gen_rotation.cuh.  Kernel 5 (extprod_recombine) is one step's GEMM
// phase alone, a plain launch that stores its tiles.
//
// One launch runs CMUX steps (a whole blind rotation, or S steps of kernels
// 1 and 4) on a persistent cooperative grid of one 384-thread block per SM.
// Per CMUX step: a digit phase over every (row, polynomial) pair, a grid
// barrier, a GEMM phase over every work item, a second grid barrier.  A work
// item is BM = 128 batch rows x one output polynomial o x 64 coefficients x
// the whole contraction in kernels 1 and 2, one split of it in kernels 4-6.
//
// GEMM phase, warp-specialized (no __syncthreads between the roles):
//   * warpgroup 2, the producer, fills a ring of shared-memory stages.  A
//     stage is 128 contraction bytes of the item: the digit tile (128 rows,
//     by TMA) and the weight tile (nl*64 columns, by TMA in kernels 4-6,
//     expanded from the generator in kernels 1 and 2), both K-major with the
//     128-byte swizzle.  An mbarrier pair per stage (full: bytes and the
//     producers' arrivals; empty: one arrival per consumer warp) orders it.
//   * warpgroups 0 and 1, the consumers, own 64 rows each and run
//     wgmma.m64n(nl*64)k32.s32.s8.s8 on the stage, keeping one wgmma group in
//     flight, then recombine the nl limb sums in registers and add the
//     uint32 delta into acc with red.global.add.u32.
// setmaxnreg moves registers from the producer to the consumers (an
// m64n256 s32 accumulator is 128 registers a thread); each kernel sets the
// producer's share.
//
// Split-K, kernels 4-6 only: an item covers 1/S of the contraction
// (Python's cuda_kernels.tile_plan picks S from the batch, the shapes and the
// SM count).  Each split adds its recombined delta into acc with a red; the
// recombination is a sum mod 2^32, so the result is bit-equal whatever the
// order in which the adds land.
//
// The walk of a step's items: kernels 4 and 6 hand them out round-robin
// (item blockIdx.x + w * gridDim.x), so a step whose U items are not a
// multiple of the grid W lasts ceil(U/W) items on the blocks that take one
// more.  Kernels 1 and 2 walk by stage (consume_step_by_stage): the full
// waves round-robin as before, then the U mod W items left as one run of
// stages cut evenly over the W blocks (tail_range), a step lasting
// floor(U/W) * P + ceil((U mod W) * P / W) stages for items of P stages.
// That walk covers each stage once and fills the grid at every batch, so
// kernels 1 and 2 take no split (their entry points set split = 1).  A
// piece of an item adds a delta over a subset of the item's terms, so its
// int32 sums stay in the same bound and the result is bit-equal, as for
// split-K.
//
// Memory ordering across blocks: acc is read with ld.global.cg (L2) and
// written with st.global.cg or red; the digits are written with st.global.cg
// by the generic proxy and read by TMA through the async proxy, so the
// writers and the TMA-issuing thread both execute fence.proxy.async.global
// around the grid barrier.  Without that fence stale digits appear above one
// tile.

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace peba1 {
namespace rot {

constexpr int THREADS = 384;          // consumer warpgroups 0, 1; producer 2
constexpr int BM = 128;               // batch rows per work item
constexpr int BN = 64;                // coefficients per work item
constexpr int BK = 128;               // contraction bytes per stage
constexpr int A_BYTES = BM * BK;      // digit tile of a stage
constexpr int LIMB_BYTES = BN * BK;   // one limb's weight tile of a stage
constexpr int STAGE_BYTES = A_BYTES + 4 * LIMB_BYTES;
constexpr int MAX_STAGES = 4;
constexpr int CONSUMER_WARPS = 8;     // arrivals that free a stage

struct Args {
  int B, n_steps, N, k, l, bgbit;
  uint32_t offset;
  int mask_limbs, body_limbs;
  int K;        // A-matrix fine block (kernel 6); 0 in kernels 1 and 2
  int split;    // S: splits of the contraction (kernels 4-6; 1 in kernels 1 and 2)
  int stages;   // ring depth
  uint32_t mu;
  // The walk by stage (kernels 1 and 2; 0 elsewhere), set by the launcher
  // from the grid it launches: full_waves = U / W for U items a step on W
  // blocks; the tail's (U mod W) * P stages are tail_len a block, and one
  // more on the first tail_longer blocks.
  int full_waves, tail_len, tail_longer;
};

// --- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// threadIdx.x, read again at each use: kept live across the kernel, it is
// the one value ptxas would spill (the consumers' registers are full).
__device__ __forceinline__ int thread_idx() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                       uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(a), "r"(b), "r"(c),
               "r"(d)
               : "memory");
}

// Shared memory is addressed by 32-bit shared-window addresses throughout
// (a 64-bit generic pointer to it costs registers the consumers need).
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Raises the phase's expected bytes without arriving.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// A wait that has spun for 20 s is a fault (a refused copy, a lost
// arrival): trap, so that the launch fails instead of hanging the card.
struct SpinGuard {
  uint32_t spins = 0;
  uint64_t start = 0;
  __device__ __forceinline__ void tick() {
    if ((++spins & 0xFFFFu) != 0) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (start == 0) start = now;
    else if (now - start > 20000000000ull) __trap();
  }
};

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t addr, uint32_t parity) {
  uint32_t done = 0;
  SpinGuard guard;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    guard.tick();
  }
}

// 2-D TMA load of one box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c_inner, int c_outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c_inner), "r"(c_outer)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart.  Adding 2 advances the start by 32 contraction bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// This thread's warpgroup, as a value the compiler knows to be uniform
// across the warp (a wgmma in code it cannot prove uniform is serialized).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xFFFFFFFFu, (int)(thread_idx() >> 7), 0);
}

// Hands registers from the producer warpgroup to the consumers: at launch
// every thread has 168 (65,536 / 384), and 2 * CONSUMER + PRODUCER must
// stay 504.
template <int PRODUCER>
__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER));
}

template <int PRODUCER>
__device__ __forceinline__ void consumer_registers() {
  static_assert(PRODUCER % 8 == 0 && (504 - PRODUCER) % 16 == 0, "setmaxnreg counts");
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"((504 - PRODUCER) / 2));
}

// Barrier over the 128 threads of the producer warpgroup.
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

// D (+)= A x B over 32 contraction bytes: A 64 rows, B NL*64 columns, both
// K-major in shared memory; D is int32 in the wgmma accumulator layout
// (register 4*c + 2*i + e holds row 16*warp + lane/4 + 8i, column
// 8c + 2*(lane%4) + e).  scale_d == 0 overwrites D.
template <int NL>
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[32 * NL], uint64_t da, uint64_t db,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<1>(int32_t (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<2>(int32_t (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<3>(int32_t (&d)[96], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<4>(int32_t (&d)[128], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// --- grid barrier ----------------------------------------------------------

// Every block of the cooperative grid arrives once; `counter` starts at 0
// (the wrapper zeroes it) and only grows, `target` is this thread's count
// of barriers so far times the grid.  Thread 0 arrives with a release add
// and waits with acquire loads (the block's writes, ordered before it by
// the block barrier, are released with it; no full fence is needed).
// barrier.sync 0 (not the aligned __syncthreads) because the producer and
// consumers call it from different branches.
__device__ __forceinline__ void grid_sync(unsigned int* counter, unsigned int& target) {
  target += gridDim.x;
  asm volatile("barrier.sync 0;" ::: "memory");
  if (thread_idx() == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(counter) : "memory");
    unsigned int seen;
    SpinGuard guard;
    while (true) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(counter) : "memory");
      if (seen >= target) break;
      guard.tick();
    }
  }
  asm volatile("barrier.sync 0;" ::: "memory");
}

// --- phases ----------------------------------------------------------------

// acc = [0 | X^amt0[b] * (mu, ..., mu)] for every row b, through L2.
__device__ __forceinline__ void init_accumulator(uint32_t* acc, const int32_t* amt0, int B,
                                                 int N, int k, uint32_t mu) {
  const int k1 = k + 1;
  const size_t acc_len = (size_t)B * k1 * N;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + thread_idx(); idx < acc_len;
       idx += stride) {
    const int t = (int)(idx % N);
    const size_t bu = idx / N;
    uint32_t v = 0;
    if ((int)(bu % k1) == k) {
      const uint32_t i = ((uint32_t)t - (uint32_t)amt0[bu / k1]) & (uint32_t)(2 * N - 1);
      v = i < (uint32_t)N ? mu : 0u - mu;
    }
    __stcg(acc + idx, v);
  }
}

// The gadget digits of X^amt_s[b] * acc[b, u] - acc[b, u] for every pair
// (b, u), four coefficients a lane: digit q of coefficient
// t at digits[b, (u*l+q)*N + t] (NATURAL, kernel 6) or + N-1-t (kernel 2's
// reversed order).  acc through L2, digits stored through L2, then the
// proxy fence that lets the next GEMM phase's TMA read them.
template <bool NATURAL>
__device__ __forceinline__ void digit_phase(const uint32_t* acc, const int32_t* amt_s,
                                            int8_t* digits, const Args& a) {
  const int lane = thread_idx() & 31, warps = blockDim.x >> 5;
  const int N = a.N, k1 = a.k + 1, l = a.l;
  const uint32_t bg_mask = (1u << a.bgbit) - 1u;
  const int half_bg = 1 << (a.bgbit - 1);
  const uint32_t wrap = (uint32_t)(2 * N - 1);
  // A warp takes a part of a pair: the whole pair when the pairs alone keep
  // every warp busy (fewer index computations, one row a warp), else as many
  // parts (a power of two, at least 128 coefficients each) as it takes for
  // that, so that a small batch is not a few warps each walking a chain of
  // L2 loads.
  const int pairs = a.B * k1, total_warps = gridDim.x * warps;
  int parts = 1;
  while (parts < N / 128 && pairs * parts < total_warps) parts *= 2;
  const int len = N / parts;
  for (int item = blockIdx.x * warps + (thread_idx() >> 5); item < pairs * parts;
       item += total_warps) {
    const int pair = item / parts, t0 = (item - pair * parts) * len;
    const int b = pair / k1, u = pair - b * k1;
    const uint32_t rot = (uint32_t)__ldg(amt_s + b);
    const uint32_t* row = acc + (size_t)pair * N;
    int8_t* dst = digits + ((size_t)b * k1 + u) * l * N;
    for (int t = t0 + 4 * lane; t < t0 + len; t += 128) {
      const uint4 cur = __ldcg(reinterpret_cast<const uint4*>(row + t));
      const uint32_t c[4] = {cur.x, cur.y, cur.z, cur.w};
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // (X^a p)[t] = p[i] if i < N else -p[i-N], with i = (t - a) mod 2N.
        const uint32_t i = ((uint32_t)(t + e) - rot) & wrap;
        const uint32_t p = __ldcg(row + (i & (uint32_t)(N - 1)));
        v[e] = (i < (uint32_t)N ? p : 0u - p) - c[e] + a.offset;
      }
      for (int q = 0; q < l; ++q) {
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = (int)((v[e] >> (32 - (q + 1) * a.bgbit)) & bg_mask) - half_bg;
          word |= ((uint32_t)d & 0xFFu) << (8 * (NATURAL ? e : 3 - e));
        }
        __stcg(reinterpret_cast<uint32_t*>(dst + (size_t)q * N + (NATURAL ? t : N - 4 - t)),
               word);
      }
    }
  }
  fence_proxy_async_global();
}

// --- work items and the ring -----------------------------------------------

struct Item {
  int split, j0, o, m0, nl, c0;
};

__device__ __forceinline__ int items_per_step(const Args& a) {
  return ((a.B + BM - 1) / BM) * (a.k + 1) * (a.N / BN) * a.split;
}

// Split fastest, then the column tile, the output polynomial, the row tile.
__device__ __forceinline__ Item item_at(int idx, const Args& a) {
  Item it;
  it.split = idx % a.split;
  idx /= a.split;
  const int tiles_j = a.N / BN;
  it.j0 = (idx % tiles_j) * BN;
  idx /= tiles_j;
  it.o = idx % (a.k + 1);
  it.m0 = (idx / (a.k + 1)) * BM;
  it.nl = it.o < a.k ? a.mask_limbs : a.body_limbs;
  it.c0 = it.o * a.mask_limbs;  // limb columns are output-major
  return it;
}

// The stages [lo, hi) that this block takes of a step's tail: the U mod W
// items left after the full waves of U items of P stages over the grid's W
// blocks, as one run of stages in the order (item, stage), cut into W
// contiguous ranges, the first (tail stages mod W) of them one stage longer.
// The launcher puts the grid's shares in Args, which the kernel reads from
// its parameter space; cuda_kernels.TilePlan.tail_range mirrors it.
__device__ __forceinline__ int2 tail_range(const Args& a) {
  const int b = blockIdx.x, lo = b * a.tail_len + min(b, a.tail_longer);
  return make_int2(lo, lo + a.tail_len + (b < a.tail_longer ? 1 : 0));
}

// Stages [first, end) of work item idx.
struct Piece {
  int idx, first, end;
};

// Piece i of this block in a step of items of P stages, walked by stage:
// its items of the full waves whole, then its tail range cut at the items'
// boundaries (at most two pieces: a range is at most P stages long); past
// the last, an empty piece (first >= end), so that no count stays live.
__device__ __forceinline__ Piece piece_at(int i, int P, const Args& a) {
  const int W = gridDim.x, full = a.full_waves;
  if (i < full) return {(int)blockIdx.x + i * W, 0, P};
  const int2 t = tail_range(a);
  const int r = t.x / P + (i - full), s0 = r * P;  // r: the item's place in the tail
  return {full * W + r, max(t.x - s0, 0), min(t.y - s0, P)};
}

struct Ring {
  uint32_t base;     // stage s at base + s * STAGE_BYTES, 1024-aligned
  uint32_t bars;     // full[s] at bars + 8s, empty[s] at bars + 8(stages + s)
  uint32_t extra;    // shared memory past the barriers
  int stages;
  int stage = 0;
  uint32_t phase = 0;

  __device__ __forceinline__ uint32_t a_tile() const { return base + stage * STAGE_BYTES; }
  __device__ __forceinline__ uint32_t b_tile() const { return a_tile() + A_BYTES; }
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return bars + 8 * (stages + s); }
  __device__ __forceinline__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
  // Producer side: wait until the consumers have freed the current stage.
  __device__ __forceinline__ void wait_empty() { mbar_wait(empty(stage), phase ^ 1u); }
};

// Carves the dynamic shared memory: the ring, then its barriers, then the
// extra bytes (the generator windows of kernels 1 and 2).  A full barrier completes on
// `producers` arrivals and its transaction bytes.  Thread 0 initializes the
// barriers; the caller synchronizes the block before using them.
__device__ __forceinline__ Ring make_ring(uint8_t* smem_raw, int stages, int producers) {
  Ring r;
  r.base = (smem_u32(smem_raw) + 1023) & ~1023u;
  r.bars = r.base + stages * STAGE_BYTES;
  r.extra = r.bars + 16 * stages;
  r.stages = stages;
  if (thread_idx() == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(r.full(s), producers);
      mbar_init(r.empty(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  return r;
}

// Bytes of dynamic shared memory for `stages` stages and `extra` bytes.
inline int ring_smem(int stages, int extra) {
  return 1024 + stages * STAGE_BYTES + 2 * stages * 8 + extra;
}

// --- consumers -------------------------------------------------------------

__device__ __forceinline__ void release(Ring& r, int stage) {
  __syncwarp();
  if ((thread_idx() & 31) == 0) mbar_arrive(r.empty(stage));
}

// One work item of warpgroup wg: n_st stages into d, one wgmma group kept in
// flight, each stage freed once the group after it is issued.  Every
// warpgroup computes, even one whose rows lie past the batch (their digits
// read as zeros): a wgmma under a branch is serialized by the compiler.
template <int NL>
__device__ __forceinline__ void consume(Ring& r, int n_st, int wg, int32_t (&d)[32 * NL]) {
  int prev = -1;
  for (int t = 0; t < n_st; ++t) {
    mbar_wait(r.full(r.stage), r.phase);
    const uint64_t da = smem_desc(r.a_tile() + wg * (A_BYTES / 2));
    const uint64_t db = smem_desc(r.b_tile());
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      wgmma_s8<NL>(d, da + 2 * kk, db + 2 * kk, (t | kk) != 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0) release(r, prev);
    prev = r.stage;
    r.advance();
  }
  wgmma_wait<0>();
  release(r, prev);
}

// Epilogue: delta = sum_m d_m << (8(4-NL) + 8m) mod 2^32 for the warp's 16
// rows x 64 columns (limb m's column x sits in register 32m + 4(x/8) + ...,
// the same thread as its other limbs), added into acc[row, o, j0 + x].
template <int NL>
__device__ __forceinline__ void add_tile(uint32_t* acc, const int32_t (&d)[32 * NL], int B,
                                         int N, int k1, int o, int row0, int j0) {
  const int lane = thread_idx() & 31, warp = (thread_idx() >> 5) & 3;
  const int shift0 = 8 * (4 - NL);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 16 * warp + (lane >> 2) + 8 * i;
    if (row < B) {
      uint32_t* p = acc + ((size_t)row * k1 + o) * N + j0 + 2 * (lane & 3);
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          uint32_t delta = 0;
#pragma unroll
          for (int m = 0; m < NL; ++m)
            delta += (uint32_t)d[32 * m + 4 * c + 2 * i + e] << (shift0 + 8 * m);
          atomicAdd(p + 8 * c + e, delta);
        }
    }
  }
}

// A consumer warpgroup's work item with its limb count as a template argument.
template <int NL>
__device__ __forceinline__ void consume_item(Ring& r, uint32_t* acc, const Item& it, int n_st,
                                             int wg, const Args& a) {
  int32_t d[32 * NL];
#pragma unroll
  for (int i = 0; i < 32 * NL; ++i) d[i] = 0;
  consume<NL>(r, n_st, wg, d);
  add_tile<NL>(acc, d, a.B, a.N, a.k + 1, it.o, it.m0 + wg * (BM / 2), it.j0);
}

__device__ __forceinline__ void consume_any(Ring& r, uint32_t* acc, const Item& it, int n_st,
                                            int wg, const Args& a) {
  switch (it.nl) {
    case 1: consume_item<1>(r, acc, it, n_st, wg, a); break;
    case 2: consume_item<2>(r, acc, it, n_st, wg, a); break;
    case 3: consume_item<3>(r, acc, it, n_st, wg, a); break;
    default: consume_item<4>(r, acc, it, n_st, wg, a); break;
  }
}

// The consumers' step, items of n_st stages round-robin (kernels 4 and 6).
__device__ __forceinline__ void consume_step(Ring& r, uint32_t* acc, int n_st, const Args& a) {
  const int wg = warpgroup();
  const int n_items = items_per_step(a);
  for (int idx = blockIdx.x; idx < n_items; idx += gridDim.x)
    consume_any(r, acc, item_at(idx, a), n_st, wg, a);
}

// The consumers' step walked by stage (kernels 1 and 2): piece_at's pieces,
// each consumed and added into acc on its own.
__device__ __forceinline__ void consume_step_by_stage(Ring& r, uint32_t* acc, int n_st,
                                                      const Args& a) {
  const int wg = warpgroup();
  for (int i = 0;; ++i) {
    const Piece pc = piece_at(i, n_st, a);
    if (pc.end <= pc.first) break;
    consume_any(r, acc, item_at(pc.idx, a), pc.end - pc.first, wg, a);
  }
}

// --- host side -------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A 2-D int8 tensor map over (rows, cols) row-major bytes at `ptr`, boxes of
// (box_rows, 128) with the 128-byte swizzle that smem_desc describes; rows
// past the end read as zeros.  cuTensorMapEncodeTiled is reached through the
// runtime's entry-point query, so no library beyond cudart is linked.
inline cudaError_t encode_map(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols,
                              uint32_t box_rows) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !fn) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols};
  const cuuint32_t box[2] = {(cuuint32_t)BK, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Ring depth that fits the card's shared memory next to `extra` bytes
// (at most MAX_STAGES; 0 if not even two fit).
inline int ring_stages(int extra) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return 0;
  for (int s = MAX_STAGES; s >= 2; --s)
    if (ring_smem(s, extra) <= limit) return s;
  return 0;
}

// The blocks of `kernel` (THREADS threads, `smem` bytes) that fit on the
// current device at once, after setting its dynamic shared-memory limit to
// `smem`.
template <typename Kernel>
inline cudaError_t resident_blocks(Kernel kernel, int smem, int* blocks) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

// Launches `kernel` (THREADS threads, `smem` bytes) cooperatively on
// `blocks` blocks.
template <typename Kernel>
inline cudaError_t launch_cooperative_on(Kernel kernel, int blocks, int smem, void** args,
                                         cudaStream_t stream) {
  cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(blocks),
                                                dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Launches `kernel` (THREADS threads, `smem` bytes) cooperatively with one
// block for each that fits on the card at once.
template <typename Kernel>
inline cudaError_t launch_cooperative(Kernel kernel, int smem, void** args,
                                      cudaStream_t stream) {
  int blocks = 0;
  cudaError_t err = resident_blocks(kernel, smem, &blocks);
  if (err != cudaSuccess) return err;
  return launch_cooperative_on(kernel, blocks, smem, args, stream);
}

}  // namespace rot
}  // namespace peba1
