// Rotate, difference and gadget decomposition of the accumulator, for Hopper
// (sm_90a).  Built by peba1_tpu_torch/ops/cuda_kernels.py with nvcc into a
// shared library with a plain C interface, bound with ctypes.
//
// peba1_rotate_decompose replaces peba1_tpu/ops/pallas_kernels.py
// rotate_decompose (_rot_dec_kernel): the digits of X^amt[b]*acc[b] - acc[b]
// in natural order, digits[b, (u*l+q)*N + t].  It feeds kernel 5
// (extprod_recombine, cmux_step.cu) and the plain external products of the
// scan of steps.
//
// What bounds it: bytes, one read of acc (4(k+1)N bytes a row) and one write
// of the digits ((k+1)lN bytes a row), a few operations a coefficient.  So
// the design keeps copies in flight and leaves the threads only arithmetic
// on shared memory:
//   * a persistent grid (cuda_kernels.rotdec_plan: blocks per SM from the
//     shared memory below, capped at B); block x takes the whole rows
//     b = x, x + grid, ...;
//   * loads: one thread starts a 1-D bulk copy (cp.async.bulk) of a whole
//     acc row into a ring of `stages` shared-memory stages, and a 4-byte
//     cp.async of amt[b] beside it; both complete on the stage's mbarrier
//     (one arrival from the expect_tx, one from the cp.async), so a block
//     keeps `stages` rows in flight while it computes on the oldest;
//   * arithmetic: lanes take consecutive coefficients t, so the plain read
//     acc[b,u][t] and the rotated read at i = (t - a) mod 2N are consecutive
//     words (no bank conflict); the negation applies where i >= N; digit q
//     goes as a byte into a staging copy of the digit row, double-buffered.
//     At the presets' shapes (k+1, N, l, Bg) = (3, 512, 2, 2^8) and
//     (2, 1024, 2, 2^8) the shapes are template constants, so the loops
//     unroll with constant shifts (with them at run time the arithmetic, not
//     the copies, set the pace); other shapes take their values at run time;
//   * stores: after fence.proxy.async.shared::cta and the block barrier, the
//     same thread starts one bulk copy of the digit row to device memory
//     (cp.async.bulk ... bulk_group); before that barrier it waits until the
//     previous row's copy has read its buffer, which the next row writes.
// Bulk copies need 16-byte-aligned addresses and sizes that are multiples of
// 16: the wrapper requires N % 64 == 0 and raises on an unaligned acc.
//
// All arithmetic on torus values is uint32 (signed overflow is undefined in
// C++).

#include <cstdint>
#include <cuda_runtime.h>

#include "whole_rotation.cuh"

namespace {

using peba1::rot::fence_proxy_async_shared;
using peba1::rot::mbar_arrive_expect_tx;
using peba1::rot::mbar_init;
using peba1::rot::mbar_wait;
using peba1::rot::smem_u32;

constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 4;  // resident a SM (cuda_kernels.ROTDEC_BLOCKS_PER_SM)

// Dynamic shared memory of a block, in this order: `stages` acc rows, two
// digit rows, `stages` amt words (padded to 16 bytes), `stages` mbarriers.
// cuda_kernels.rotdec_plan computes the same sum.
__host__ __device__ constexpr uint32_t amt_offset(int stages, uint32_t row, uint32_t drow) {
  return stages * row + 2 * drow;
}
__host__ __device__ constexpr uint32_t bar_offset(int stages, uint32_t row, uint32_t drow) {
  return amt_offset(stages, row, drow) + 16 * ((stages + 3) / 4);
}
__host__ __device__ constexpr uint32_t smem_bytes(int stages, uint32_t row, uint32_t drow) {
  return bar_offset(stages, row, drow) + 8 * stages;
}

// Thread 0: row j of this block (b = blockIdx.x + j*gridDim.x) into stage s.
__device__ __forceinline__ void load_row(const uint32_t* acc, const int32_t* amt, int b,
                                         uint32_t row_bytes, uint32_t stage, uint32_t amt_slot,
                                         uint32_t bar) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(amt_slot), "l"(amt + b)
               : "memory");
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
  mbar_arrive_expect_tx(bar, row_bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(stage),
      "l"(reinterpret_cast<const uint8_t*>(acc) + (size_t)b * row_bytes), "r"(row_bytes),
      "r"(bar)
      : "memory");
}

// One block: its rows b = blockIdx.x + j*gridDim.x through the ring.
// K1 = k+1, LOG_N = log2 N, L and BGBIT are compile-time in the shapes the
// presets run (the arithmetic then unrolls, with constant shifts and
// offsets); 0 takes the argument instead.
template <int K1, int LOG_N, int L, int BGBIT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    rotate_decompose_kernel(const uint32_t* __restrict__ acc, const int32_t* __restrict__ amt,
                            int8_t* __restrict__ digits, int B, int log_n_arg, int k1_arg,
                            int l_arg, int bgbit_arg, uint32_t offset, int stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int k1 = K1 ? K1 : k1_arg, log_n = LOG_N ? LOG_N : log_n_arg;
  const int l = L ? L : l_arg, bgbit = BGBIT ? BGBIT : bgbit_arg;
  const int tid = threadIdx.x;
  const int N = 1 << log_n;
  const uint32_t row_bytes = 4u * k1 * N, drow = (uint32_t)(k1 * l * N);
  const uint32_t base = smem_u32(smem);
  const uint32_t amt_slots = base + amt_offset(stages, row_bytes, drow);
  const uint32_t bars = base + bar_offset(stages, row_bytes, drow);
  const int32_t* amt_s =
      reinterpret_cast<const int32_t*>(smem + amt_offset(stages, row_bytes, drow));
  const int rows = (B - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + 8 * s, 2);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < rows && j < stages; ++j)
      load_row(acc, amt, blockIdx.x + j * gridDim.x, row_bytes, base + j * row_bytes,
               amt_slots + 4 * j, bars + 8 * j);
  }
  __syncthreads();

  const uint32_t n_mask = (uint32_t)N - 1u, wrap = 2u * N - 1u;
  const uint32_t bg_mask = (1u << bgbit) - 1u;
  const int half_bg = 1 << (bgbit - 1);
  int s = 0;
  uint32_t parity = 0;
  for (int j = 0; j < rows; ++j) {
    const int b = blockIdx.x + j * gridDim.x;
    mbar_wait(bars + 8 * s, parity);
    const uint32_t a = (uint32_t)amt_s[s];
    const uint32_t* row = reinterpret_cast<const uint32_t*>(smem + s * row_bytes);
    int8_t* out = reinterpret_cast<int8_t*>(smem + stages * row_bytes + (j & 1) * drow);
#pragma unroll
    for (int u = 0; u < k1; ++u) {
      const uint32_t* p = row + u * N;
      int8_t* dst = out + u * l * N;
#pragma unroll 4
      for (int t = tid; t < N; t += THREADS) {
        // (X^a p)[t] = p[i] if i < N else -p[i-N], with i = (t - a) mod 2N.
        const uint32_t i = ((uint32_t)t - a) & wrap;
        const uint32_t x = p[i & n_mask];
        const uint32_t v = (i < (uint32_t)N ? x : 0u - x) - p[t] + offset;
#pragma unroll
        for (int q = 0; q < l; ++q)
          dst[q * N + t] = (int8_t)((int)((v >> (32 - (q + 1) * bgbit)) & bg_mask) - half_bg);
      }
    }
    fence_proxy_async_shared();
    // The previous row's store has read the buffer the next row writes.
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
                       digits + (size_t)b * drow),
                   "r"(smem_u32(out)), "r"(drow)
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      if (j + stages < rows)
        load_row(acc, amt, b + stages * gridDim.x, row_bytes, base + s * row_bytes,
                 amt_slots + 4 * s, bars + 8 * s);
    }
    if (++s == stages) {
      s = 0;
      parity ^= 1u;
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace

// digits (B, (k+1)*l*N) int8 of acc (B, (k+1)*N) int32 rotated by amt (B,)
// int32, on `blocks` persistent blocks with `stages` ring stages and `smem`
// bytes of dynamic shared memory (cuda_kernels.rotdec_plan; any other smem
// is refused).  Returns the CUDA error of the launch (0 on success).
extern "C" int peba1_rotate_decompose(const void* acc, const void* amt, void* digits, int B,
                                      int log_n, int k, int l, int bgbit, unsigned int offset,
                                      int blocks, int stages, int smem, void* stream) {
  const uint32_t kn = (uint32_t)(k + 1) << log_n;
  if ((uint32_t)smem != smem_bytes(stages, 4 * kn, kn * l)) return (int)cudaErrorInvalidValue;
  // peba1_128_t2's and peba1_128_fast's shapes as constants; any other at run time.
  auto kernel = rotate_decompose_kernel<0, 0, 0, 0>;
  if (l == 2 && bgbit == 8 && k == 2 && log_n == 9) kernel = rotate_decompose_kernel<3, 9, 2, 8>;
  if (l == 2 && bgbit == 8 && k == 1 && log_n == 10) kernel = rotate_decompose_kernel<2, 10, 2, 8>;
  // The attribute is set at every call that needs it and remembered nowhere:
  // it belongs to the kernel, not to a size.
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(acc), static_cast<const int32_t*>(amt),
      static_cast<int8_t*>(digits), B, log_n, k + 1, l, bgbit, offset, stages);
  return (int)cudaGetLastError();
}
