// The whole blind rotation against the precomputed A-matrix key, for Hopper
// (sm_90a).  Built by peba1_tpu_torch/ops/cuda_kernels.py with nvcc into a
// shared library with a plain C interface, bound with ctypes.
//
// peba1_fused_blind_rotate replaces peba1_tpu/ops/pallas_kernels.py
// fused_blind_rotate (_fused_cmux_kernel): acc = [0 | X^amt0 * mu], then for
// every step s < n, with d the gadget digits of X^amt[s+1]*acc - acc,
//   acc[o] += sum_m (sum_{g,u,kappa} d[g, u*K+kappa] * A[s, c0(o)+m, g,
//                     j + (U-1-u)K, kappa]) << (8(4-nl) + 8m),
// in one launch.  The int8 products accumulate exactly in int32 because
// TfheParams bounds (k+1)*l*N*128*128 < 2^31.
//
// What bounds it: the int8 GEMM of each step, (B, G*N) x (G*N, C*N)
// ((B, 4096) x (4096, 7168) at peba1_128_fast), and at small batch the
// weight tiles' traffic from L2 into shared memory, C*N*G*N bytes a step
// for every 128-row tile (one step's A-matrix, 6.88 MB at K=128, stays in
// the 50 MB L2).  The TPU kernel keeps one batch tile's accumulator in VMEM
// over all n steps; an SM cannot, so the skeleton is whole_rotation.cuh's:
// a persistent cooperative grid, a digit phase and a GEMM phase a step.
//
// The GEMM phase: the port keeps bk_amat as (n, C, G, span, K), so for a
// fixed (s, c, g, u) the 64 weight columns j0..j0+63 of coarse block u are
// 64 consecutive K-byte rows, A[s, c, g, j0 + (U-1-u)K + x, :].  One tensor
// map views bk_amat as (n*C*G*span, K) bytes; a stage's weight tile is nl
// boxes of 64 rows x 128 bytes (two stages per block at K=256), and its
// digit tile one box of 128 batch rows x 128 bytes of the (B, G*N) digits,
// natural order.  Split-K runs over the G*U (g, u) blocks of the contraction.

#include "whole_rotation.cuh"

using namespace peba1::rot;

namespace {

constexpr int PRODUCER_REGS = 72;  // registers a producer thread keeps

// The producer thread of one step: every stage of the block's work items.
__device__ __forceinline__ void produce_step(Ring& r, const CUtensorMap* digits_map,
                                             const CUtensorMap* amat_map, int s,
                                             const Args& a) {
  const int G = (a.k + 1) * a.l, C = a.k * a.mask_limbs + a.body_limbs;
  const int U = a.N / a.K, span = a.N + (U - 1) * a.K;
  const int per_split = G * U / a.split, halves = a.K / BK;
  const int n_items = items_per_step(a);
  for (int idx = blockIdx.x; idx < n_items; idx += gridDim.x) {
    const Item it = item_at(idx, a);
    for (int blk = it.split * per_split; blk < (it.split + 1) * per_split; ++blk) {
      const int g = blk / U, u = blk - g * U;
      // Row of A[s, c0, g, j0 + (U-1-u)K] in the (n*C*G*span, K) view.
      const int row = ((s * C + it.c0) * G + g) * span + it.j0 + (U - 1 - u) * a.K;
      for (int h = 0; h < halves; ++h) {
        r.wait_empty();
        mbar_arrive_expect_tx(r.full(r.stage), A_BYTES + it.nl * LIMB_BYTES);
        tma_load_2d(r.a_tile(), digits_map, r.full(r.stage), g * a.N + u * a.K + h * BK,
                    it.m0);
        for (int m = 0; m < it.nl; ++m)
          tma_load_2d(r.b_tile() + m * LIMB_BYTES, amat_map, r.full(r.stage), h * BK,
                      row + m * G * span);
        r.advance();
      }
    }
  }
}

// amt is (n_steps+1, B): row 0 the initial body rotation, row s+1 step s's
// rotation.  digits_map views the (B, G*N) digits, amat_map the A-matrix.
__global__ void __launch_bounds__(THREADS, 1)
    fused_blind_rotate_kernel(const __grid_constant__ CUtensorMap digits_map,
                              const __grid_constant__ CUtensorMap amat_map, uint32_t* acc,
                              const int32_t* __restrict__ amt, int8_t* digits,
                              unsigned int* grid_bar, const Args a) {
  extern __shared__ uint8_t smem[];
  Ring r = make_ring(smem, a.stages, 1);  // the producer thread arrives
  __syncthreads();
  init_accumulator(acc, amt, a.B, a.N, a.k, a.mu);
  const int G = (a.k + 1) * a.l, U = a.N / a.K;
  const int n_st = G * U / a.split * (a.K / BK);
  unsigned int bar = 0;
  if (warpgroup() == 2) {
    producer_registers<PRODUCER_REGS>();
    grid_sync(grid_bar, bar);
    for (int s = 0; s < a.n_steps; ++s) {
      digit_phase<true>(acc, amt + (size_t)(s + 1) * a.B, digits, a);
      grid_sync(grid_bar, bar);  // every digit of the step exists
      if (thread_idx() == 2 * 128) {
        fence_proxy_async_global();
        produce_step(r, &digits_map, &amat_map, s, a);
      }
      grid_sync(grid_bar, bar);  // every acc add of the step has landed
    }
  } else {  // consumer warpgroups 0 and 1
    consumer_registers<PRODUCER_REGS>();
    grid_sync(grid_bar, bar);
    for (int s = 0; s < a.n_steps; ++s) {
      digit_phase<true>(acc, amt + (size_t)(s + 1) * a.B, digits, a);
      grid_sync(grid_bar, bar);
      consume_step(r, acc, n_st, a);
      grid_sync(grid_bar, bar);
    }
  }
}

}  // namespace

// The whole blind rotation in one cooperative launch: acc (B, (k+1)*N) int32
// is written (not read) as [0 | X^amt[0] * mu], then n_steps CMUX steps run on
// it against amat (n_steps, C, G, span, K) int8, span = N + (N/K - 1)*K.  amt
// is (n_steps+1, B) int32, digits is (B, G*N) int8 scratch, grid_bar one
// zeroed uint32.  `split` must divide G*N/K.  Requires N % 128 == 0,
// K % 128 == 0 and N % K == 0.  Returns the first CUDA error (0 on success).
extern "C" int peba1_fused_blind_rotate(void* acc, const void* amt, const void* amat,
                                        void* digits, void* grid_bar, int B, int n_steps,
                                        int N, int k, int l, int bgbit, unsigned int offset,
                                        int mask_limbs, int body_limbs, int K, int split,
                                        unsigned int mu, void* stream) {
  const int G = (k + 1) * l, C = k * mask_limbs + body_limbs;
  const int U = N / K, span = N + (U - 1) * K;
  if (N % BK || K % BK || N % K || split < 1 || (G * U) % split) return (int)cudaErrorInvalidValue;
  Args a{B, n_steps, N, k, l, bgbit, offset, mask_limbs, body_limbs, K, split,
         ring_stages(0), mu};
  if (a.stages == 0) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap digits_map{}, amat_map{};
  cudaError_t err = encode_map(&digits_map, digits, (uint64_t)B, (uint64_t)G * N, BM);
  if (err == cudaSuccess && n_steps > 0)
    err = encode_map(&amat_map, amat, (uint64_t)n_steps * C * G * span, (uint64_t)K, BN);
  if (err != cudaSuccess) return (int)err;
  uint32_t* acc_p = static_cast<uint32_t*>(acc);
  const int32_t* amt_p = static_cast<const int32_t*>(amt);
  int8_t* digits_p = static_cast<int8_t*>(digits);
  unsigned int* bar_p = static_cast<unsigned int*>(grid_bar);
  void* args[] = {&digits_map, &amat_map, &acc_p, &amt_p, &digits_p, &bar_p, &a};
  return (int)launch_cooperative(fused_blind_rotate_kernel, ring_smem(a.stages, 0), args,
                                 static_cast<cudaStream_t>(stream));
}
