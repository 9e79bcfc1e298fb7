// CMUX steps and the external product against the precomputed Toeplitz
// weights W (bk_w), for Hopper (sm_90a).  Built by
// peba1_tpu_torch/ops/cuda_kernels.py with nvcc into a shared library with a
// plain C interface, bound with ctypes.  Two entry points, replacing two
// kernels of peba1_tpu/ops/pallas_kernels.py:
//
//   peba1_cmux_step          cmux_step (_cmux_step_kernel): for every step s,
//                            batch row b and output polynomial o, with d the
//                            gadget digits of X^amt[s,b]*acc[b] - acc[b],
//                            acc[b, o] += sum_m (d . Wt[s, c0(o)+m]) << (8(4-nl)+8m),
//                            all S steps of a call in one cooperative launch;
//   peba1_extprod_recombine  extprod_recombine (_extprod_rec_kernel): the
//                            same product of given digits and one step's Wt,
//                            recombined and stored, in one launch.
//
// The int8 products accumulate exactly in int32 because TfheParams bounds
// (k+1)*l*N*128*128 < 2^31.
//
// Layout of W: the port keeps W transposed, Wt = (C*N, G*N) per step, with
// Wt[c*N + j, g*N + t] = vv[g, c, N - t + j] (keys.CloudKey.bk_w), so the
// contraction runs along a row: K-major, as wgmma takes an int8 B operand.
// One tensor map views bk_w as (S*C*N, G*N) bytes.  A stage's weight tile is
// nl boxes of 64 rows x 128 bytes, limb m of output polynomial o at row
// (s*C + c0 + m)*N + j0 and column g*N + h*128 (c0 = o*mask_limbs); its digit
// tile is one box of 128 batch rows x 128 bytes of the (B, G*N) digits,
// natural order, at the same column.  Split-K runs over the G digit
// polynomials.
//
// What bounds it: the int8 GEMM of each step, (B, G*N) x (G*N, C*N)
// ((B, 3072) x (3072, 5632) at peba1_128_t2), and at small batch each step's
// W (17.3 MB at peba1_128_t2, 29.4 MB at peba1_128_fast): read from HBM once
// a step, then from L2 into shared memory once per 128-row tile.  The design
// is whole_rotation.cuh's, as in kernel 6 (fused_blind_rotate.cu) with
// another weight map: one 384-thread block per SM, a producer thread keeping
// TMA loads in flight on a 4-stage mbarrier ring, two consumer warpgroups
// running wgmma and recombining the limbs in registers, and split-K from
// cuda_kernels.tile_plan to fill the card at small batch.
//
// cmux_step updates acc in place.  Step s's digit phase reads acc only after
// the grid barrier that ends step s-1's adds, and its GEMM phase adds into
// acc only after the grid barrier that ends its digit phase: every digit of
// a step exists before any acc element of that step is written (the
// contract of pallas_kernels.py:310-313, 335-337).
//
// extprod_recombine stores its recombined tile when the contraction is not
// split; when it is, the wrapper zeroes the output and every split adds its
// delta with red.global.add (the sum is mod 2^32, so the order does not
// matter).

#include "whole_rotation.cuh"

using namespace peba1::rot;

namespace {

constexpr int PRODUCER_REGS = 72;  // registers a producer thread keeps

// The producer thread: every stage of the block's work items against step
// s of the weight map.
__device__ __forceinline__ void produce_w(Ring& r, const CUtensorMap* digits_map,
                                          const CUtensorMap* w_map, int s, const Args& a) {
  const int G = (a.k + 1) * a.l, C = a.k * a.mask_limbs + a.body_limbs;
  const int per_split = G / a.split, halves = a.N / BK;
  const int n_items = items_per_step(a);
  for (int idx = blockIdx.x; idx < n_items; idx += gridDim.x) {
    const Item it = item_at(idx, a);
    // Row of Wt[s, c0*N + j0] in the (S*C*N, G*N) view.
    const int row = (s * C + it.c0) * a.N + it.j0;
    for (int g = it.split * per_split; g < (it.split + 1) * per_split; ++g) {
      for (int h = 0; h < halves; ++h) {
        const int col = g * a.N + h * BK;
        r.wait_empty();
        mbar_arrive_expect_tx(r.full(r.stage), A_BYTES + it.nl * LIMB_BYTES);
        tma_load_2d(r.a_tile(), digits_map, r.full(r.stage), col, it.m0);
        for (int m = 0; m < it.nl; ++m)
          tma_load_2d(r.b_tile() + m * LIMB_BYTES, w_map, r.full(r.stage), col,
                      row + m * a.N);
        r.advance();
      }
    }
  }
}

// amt is (n_steps, B), row s step s's rotation; digits_map views the (B, G*N)
// digits, w_map the (n_steps*C*N, G*N) weights.
__global__ void __launch_bounds__(THREADS, 1)
    cmux_step_kernel(const __grid_constant__ CUtensorMap digits_map,
                     const __grid_constant__ CUtensorMap w_map, uint32_t* acc,
                     const int32_t* __restrict__ amt, int8_t* digits,
                     unsigned int* grid_bar, const Args a) {
  extern __shared__ uint8_t smem[];
  Ring r = make_ring(smem, a.stages, 1);  // the producer thread arrives
  __syncthreads();
  const int n_st = (a.k + 1) * a.l / a.split * (a.N / BK);
  unsigned int bar = 0;
  if (warpgroup() == 2) {
    producer_registers<PRODUCER_REGS>();
    for (int s = 0; s < a.n_steps; ++s) {
      digit_phase<true>(acc, amt + (size_t)s * a.B, digits, a);
      grid_sync(grid_bar, bar);  // every digit of the step exists
      if (thread_idx() == 2 * 128) {
        fence_proxy_async_global();
        produce_w(r, &digits_map, &w_map, s, a);
      }
      grid_sync(grid_bar, bar);  // every acc add of the step has landed
    }
  } else {  // consumer warpgroups 0 and 1
    consumer_registers<PRODUCER_REGS>();
    for (int s = 0; s < a.n_steps; ++s) {
      digit_phase<true>(acc, amt + (size_t)s * a.B, digits, a);
      grid_sync(grid_bar, bar);
      consume_step(r, acc, n_st, a);
      grid_sync(grid_bar, bar);
    }
  }
}

// Epilogue of extprod_recombine: the recombined delta of the warp's 16 rows x
// 64 columns (add_tile's register layout), stored two columns at a time, or
// with `add` added into the zeroed output.
template <int NL>
__device__ __forceinline__ void store_tile(uint32_t* out, const int32_t (&d)[32 * NL], int B,
                                           int N, int k1, int o, int row0, int j0, bool add) {
  const int lane = thread_idx() & 31, warp = (thread_idx() >> 5) & 3;
  const int shift0 = 8 * (4 - NL);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 16 * warp + (lane >> 2) + 8 * i;
    if (row < B) {
      uint32_t* p = out + ((size_t)row * k1 + o) * N + j0 + 2 * (lane & 3);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        uint32_t v[2] = {0u, 0u};
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int m = 0; m < NL; ++m)
            v[e] += (uint32_t)d[32 * m + 4 * c + 2 * i + e] << (shift0 + 8 * m);
        if (add) {
          atomicAdd(p + 8 * c, v[0]);
          atomicAdd(p + 8 * c + 1, v[1]);
        } else {
          *reinterpret_cast<uint2*>(p + 8 * c) = make_uint2(v[0], v[1]);
        }
      }
    }
  }
}

template <int NL>
__device__ __forceinline__ void store_item(Ring& r, uint32_t* out, const Item& it, int n_st,
                                           int wg, const Args& a) {
  int32_t d[32 * NL];
#pragma unroll
  for (int i = 0; i < 32 * NL; ++i) d[i] = 0;
  consume<NL>(r, n_st, wg, d);
  store_tile<NL>(out, d, a.B, a.N, a.k + 1, it.o, it.m0 + wg * (BM / 2), it.j0, a.split > 1);
}

// digits_map views the (B, G*N) digits, w_map one step's (C*N, G*N) weights.
// A persistent grid: block i takes work items i, i + gridDim.x, ...
__global__ void __launch_bounds__(THREADS, 1)
    extprod_recombine_kernel(const __grid_constant__ CUtensorMap digits_map,
                             const __grid_constant__ CUtensorMap w_map, uint32_t* out,
                             const Args a) {
  extern __shared__ uint8_t smem[];
  Ring r = make_ring(smem, a.stages, 1);  // the producer thread arrives
  __syncthreads();
  if (warpgroup() == 2) {
    producer_registers<PRODUCER_REGS>();
    if (thread_idx() == 2 * 128) produce_w(r, &digits_map, &w_map, 0, a);
  } else {  // consumer warpgroups 0 and 1
    consumer_registers<PRODUCER_REGS>();
    const int wg = warpgroup();
    const int n_st = (a.k + 1) * a.l / a.split * (a.N / BK);
    const int n_items = items_per_step(a);
    for (int idx = blockIdx.x; idx < n_items; idx += gridDim.x) {
      const Item it = item_at(idx, a);
      switch (it.nl) {
        case 1: store_item<1>(r, out, it, n_st, wg, a); break;
        case 2: store_item<2>(r, out, it, n_st, wg, a); break;
        case 3: store_item<3>(r, out, it, n_st, wg, a); break;
        default: store_item<4>(r, out, it, n_st, wg, a); break;
      }
    }
  }
}

// The two tensor maps of a call: the (B, G*N) digits in boxes of BM rows and
// `steps` steps of Wt as (steps*C*N, G*N) bytes in boxes of BN rows.  Row
// coordinates are int32 (3.5 M rows at peba1_128_t2, 4.5 M at
// peba1_128_fast).
cudaError_t encode_maps(CUtensorMap* digits_map, CUtensorMap* w_map, const void* digits,
                        const void* wt, int B, int steps, const Args& a) {
  const int G = (a.k + 1) * a.l, C = a.k * a.mask_limbs + a.body_limbs;
  const int64_t w_rows = (int64_t)steps * C * a.N;
  if (a.N % BK || a.split < 1 || G % a.split || w_rows > INT32_MAX)
    return cudaErrorInvalidValue;
  if (a.stages == 0) return cudaErrorInvalidConfiguration;
  cudaError_t err = encode_map(digits_map, digits, (uint64_t)B, (uint64_t)G * a.N, BM);
  if (err != cudaSuccess) return err;
  return encode_map(w_map, wt, (uint64_t)w_rows, (uint64_t)G * a.N, BN);
}

}  // namespace

// n_steps CMUX steps on acc (B, (k+1)*N) int32, in place, in one cooperative
// launch.  amt is (n_steps, B) int32, wt is (n_steps, C*N, G*N) int8, digits
// is (B, G*N) int8 scratch, grid_bar one zeroed uint32.  `split` must divide
// G.  Requires N % 128 == 0.  Returns the first CUDA error (0 on success).
extern "C" int peba1_cmux_step(void* acc, const void* amt, const void* wt, void* digits,
                               void* grid_bar, int B, int n_steps, int N, int k, int l,
                               int bgbit, unsigned int offset, int mask_limbs, int body_limbs,
                               int split, void* stream) {
  Args a{B, n_steps, N, k, l, bgbit, offset, mask_limbs, body_limbs, 0, split,
         ring_stages(0), 0u};
  CUtensorMap digits_map{}, w_map{};
  const cudaError_t err = encode_maps(&digits_map, &w_map, digits, wt, B, n_steps, a);
  if (err != cudaSuccess) return (int)err;
  uint32_t* acc_p = static_cast<uint32_t*>(acc);
  const int32_t* amt_p = static_cast<const int32_t*>(amt);
  int8_t* digits_p = static_cast<int8_t*>(digits);
  unsigned int* bar_p = static_cast<unsigned int*>(grid_bar);
  void* args[] = {&digits_map, &w_map, &acc_p, &amt_p, &digits_p, &bar_p, &a};
  return (int)launch_cooperative(cmux_step_kernel, ring_smem(a.stages, 0), args,
                                 static_cast<cudaStream_t>(stream));
}

// out (B, (k+1)*N) int32 = digits (B, G*N) int8 x Wt (C*N, G*N) int8,
// recombined.  With split > 1 (which must divide G) out must be zeroed.
// Requires N % 128 == 0.  Returns the CUDA error of the launch (0 on success).
extern "C" int peba1_extprod_recombine(void* out, const void* digits, const void* wt, int B,
                                       int N, int k, int l, int mask_limbs, int body_limbs,
                                       int split, void* stream) {
  const Args a{B, 1, N, k, l, 0, 0u, mask_limbs, body_limbs, 0, split, ring_stages(0), 0u};
  CUtensorMap digits_map{}, w_map{};
  cudaError_t err = encode_maps(&digits_map, &w_map, digits, wt, B, 1, a);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  const int smem = ring_smem(a.stages, 0);
  if ((err = resident_blocks(extprod_recombine_kernel, smem, &blocks)) != cudaSuccess)
    return (int)err;
  const int items = (B + BM - 1) / BM * (k + 1) * (N / BN) * split;  // items_per_step
  extprod_recombine_kernel<<<items < blocks ? items : blocks, THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      digits_map, w_map, static_cast<uint32_t*>(out), a);
  return (int)cudaGetLastError();
}
