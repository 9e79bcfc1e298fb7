// The whole blind rotation against the precomputed A-matrix key, for Hopper
// (sm_90a).  Built by peba1_tpu_torch/ops/cuda_kernels.py with nvcc into a
// shared library with a plain C interface, bound with ctypes.
//
// peba1_fused_blind_rotate replaces peba1_tpu/ops/pallas_kernels.py
// fused_blind_rotate (_fused_cmux_kernel): acc = [0 | X^amt0 * mu], then for
// every step s < n, with d the gadget digits of X^amt[s+1]*acc - acc,
//   acc[o] += sum_m (sum_{g,u,kappa} d[g, u*K+kappa] * A[s, c0(o)+m, g, kappa,
//                     j + (U-1-u)K]) << (8(4-nl) + 8m),
// in one launch.  The int8 products accumulate exactly in int32 because
// TfheParams bounds (k+1)*l*N*128*128 < 2^31.
//
// What bounds it: the int8 GEMM of each step, (B, G*N) x (G*N, C*N)
// ((B, 4096) x (4096, 7168) at peba1_128_fast), run on the tensor cores with
// mma.sync.m16n8k32.s8; one step's A-matrix (6.88 MB at K=128) stays in the
// 50 MB L2 across the batch's row tiles.  The TPU kernel keeps the
// accumulator of one batch tile resident in VMEM over all n steps and
// streams the A-matrix past it, once per tile.  An SM cannot hold that, so
// the design is kernel 2's (blind_rotate_gen_full_kernel, cmux_step_gen.cu):
// one persistent cooperative grid, each step a digit phase over all
// (row, polynomial) pairs, a grid barrier, a GEMM phase over all
// (row tile, output polynomial, column tile) tiles, and a second grid
// barrier.  The GEMM tile is kernel 4's (cmux_step.cu w_gemm_tile) with
// the A-matrix's row addresses: the port keeps bk_amat as
// (n, C, G, span, K), the transpose of JAX's last two axes, so the K
// contraction bytes of output column (c, j) in coarse block u are one
// contiguous row, A[s, c, g, j + (U-1-u)K, 0:K], and the B tile loads like
// the A tile.  The contraction then runs forwards in t = u*K + kappa, so the
// digits are written in natural order (as kernel 4 reads them).
//
// Grid-wide ordering: other blocks write acc and the digits between a
// block's reads, so both go through L2 only (ld/st.global.cg, the SHARED
// flag of common.cuh).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace peba1;

namespace {

// One GEMM tile of a step against its A-matrix a (C, G, span, K): rows
// [m0, m0+BM) x output polynomial o x coefficients [j0, j0+BN), all NL limb
// columns c0.. of o at once, added into acc.  Each BK stage copies the digit
// rows (natural order) and the NL*BN A-matrix rows into shared memory with
// 16-byte loads, then runs mma.sync over them.  acc and the digits are
// written by other blocks of the launch, so they go through L2 only.
template <int NL>
__device__ __forceinline__ void amat_gemm_tile(uint32_t* acc, const int8_t* digits,
                                               const int8_t* a, int B, int N, int G,
                                               int K, int U, int span, int c0, int o,
                                               int k1, int m0, int j0, int8_t* a_s,
                                               int8_t* b_s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int GN = G * N;

  int32_t accum[NL][2][4][4];
#pragma unroll
  for (int m = 0; m < NL; ++m)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) accum[m][mt][nt][i] = 0;

  for (int k0 = 0; k0 < GN; k0 += BK) {
    for (int idx = tid; idx < BM * BK / 16; idx += THREADS) {
      const int r = idx >> 2, chunk = idx & 3;
      const int row = m0 + r;
      int4 v = make_int4(0, 0, 0, 0);
      if (row < B)
        v = load<true>(reinterpret_cast<const int4*>(digits + (size_t)row * GN + k0 +
                                                     chunk * 16));
      *reinterpret_cast<int4*>(a_s + r * A_STRIDE + chunk * 16) = v;
    }
    // Contraction k0 = g*N + u*K + kappa0 (BK divides K): the stage's bytes
    // of output column (c, j) are A[c, g, j + (U-1-u)K, kappa0 : kappa0+BK].
    const int g = k0 / N, rem = k0 - g * N, u = rem / K;
    const int8_t* stage = a + ((size_t)g * span + (size_t)(U - 1 - u) * K) * K + (rem - u * K);
    for (int idx = tid; idx < NL * BN * BK / 16; idx += THREADS) {
      const int r = idx >> 2, chunk = idx & 3;
      const int m = r / BN, x = r - m * BN;
      const int8_t* src = stage + ((size_t)(c0 + m) * G * span + j0 + x) * K + chunk * 16;
      *reinterpret_cast<int4*>(b_s + r * A_STRIDE + chunk * 16) =
          __ldg(reinterpret_cast<const int4*>(src));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* ar = a_s + (wm * 32 + mt * 16 + grp) * A_STRIDE + kk + tig * 4;
        af[mt][0] = ld32(ar);
        af[mt][1] = ld32(ar + 8 * A_STRIDE);
        af[mt][2] = ld32(ar + 16);
        af[mt][3] = ld32(ar + 8 * A_STRIDE + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int m = 0; m < NL; ++m) {
          // B[k][n] for k = kk+tig*4+{0..3} (and +16), n = grp of this 8-wide slice.
          const int8_t* br = b_s + (m * BN + wn * 32 + nt * 8 + grp) * A_STRIDE + kk + tig * 4;
          const uint32_t b0 = ld32(br), b1 = ld32(br + 16);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_s8(accum[m][mt][nt], af[mt], b0, b1);
        }
      }
    }
    __syncthreads();
  }
  store_tile<NL, true, true>(acc, accum, B, N, k1, o, m0, j0);
}

// The tile of output polynomial o with its limb count as a template argument.
__device__ __forceinline__ void amat_gemm_tile_any(uint32_t* acc, const int8_t* digits,
                                                   const int8_t* a, int B, int N, int k,
                                                   int l, int K, int mask_limbs,
                                                   int body_limbs, int o, int m0, int j0,
                                                   int8_t* smem) {
  const int nl = o < k ? mask_limbs : body_limbs;
  const int c0 = o * mask_limbs;  // limb columns are output-major
  const int G = (k + 1) * l, U = N / K, span = N + (U - 1) * K;
  int8_t* a_s = smem;
  int8_t* b_s = smem + BM * A_STRIDE;
  switch (nl) {
    case 1: amat_gemm_tile<1>(acc, digits, a, B, N, G, K, U, span, c0, o, k + 1, m0, j0, a_s, b_s); break;
    case 2: amat_gemm_tile<2>(acc, digits, a, B, N, G, K, U, span, c0, o, k + 1, m0, j0, a_s, b_s); break;
    case 3: amat_gemm_tile<3>(acc, digits, a, B, N, G, K, U, span, c0, o, k + 1, m0, j0, a_s, b_s); break;
    default: amat_gemm_tile<4>(acc, digits, a, B, N, G, K, U, span, c0, o, k + 1, m0, j0, a_s, b_s); break;
  }
}

// Shared memory of an amat_gemm_tile: the digit tile and MAX_LIMBS weight tiles.
constexpr int TILE_SMEM = (BM + MAX_LIMBS * BN) * A_STRIDE;

// amt is (n_steps+1, B): row 0 the initial body rotation, row s+1 step s's
// rotation.  amat is (n_steps, C, G, span, K).
__global__ void __launch_bounds__(THREADS)
    fused_blind_rotate_kernel(uint32_t* acc, const int32_t* __restrict__ amt,
                              const int8_t* __restrict__ amat, int8_t* digits, int B,
                              int n_steps, int N, int k, int l, int bgbit,
                              uint32_t offset, int mask_limbs, int body_limbs, int K,
                              uint32_t mu) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) int8_t smem[];
  const int k1 = k + 1, G = k1 * l, C = k * mask_limbs + body_limbs;
  const int U = N / K, span = N + (U - 1) * K;

  init_accumulator(acc, amt, B, N, k, mu);
  grid.sync();

  const int tiles_j = N / BN, tiles_m = (B + BM - 1) / BM;
  const int n_tiles = tiles_j * tiles_m * k1;
  const size_t a_step = (size_t)C * G * span * K;
  for (int s = 0; s < n_steps; ++s) {
    const int32_t* amt_s = amt + (size_t)(s + 1) * B;
    for (int item = blockIdx.x; item < B * k1; item += gridDim.x) {
      const int b = item / k1;
      rotate_decompose_row<true, true>(acc, (uint32_t)amt_s[b], digits, b, item - b * k1,
                                       N, k1, l, bgbit, offset,
                                       reinterpret_cast<uint32_t*>(smem));
      __syncthreads();  // smem is free for the block's next row
    }
    grid.sync();  // every digit of the step exists before any acc write
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int jt = tile % tiles_j, rest = tile / tiles_j;
      amat_gemm_tile_any(acc, digits, amat + s * a_step, B, N, k, l, K, mask_limbs,
                         body_limbs, rest / tiles_m, (rest % tiles_m) * BM, jt * BN, smem);
    }
    grid.sync();  // every acc write of the step lands before the next reads
  }
}

}  // namespace

// The whole blind rotation in one cooperative launch: acc (B, (k+1)*N) int32
// is written (not read) as [0 | X^amt[0] * mu], then n_steps CMUX steps run on
// it against amat (n_steps, C, G, span, K) int8, span = N + (N/K - 1)*K.  amt
// is (n_steps+1, B) int32, digits is (B, G*N) int8 scratch.  The grid is the
// number of blocks that fit on the card at once, capped by the work.
// Requires N % 64 == 0, K % 64 == 0 and N % K == 0.  Returns the first CUDA
// error (0 on success).
extern "C" int peba1_fused_blind_rotate(void* acc, const void* amt, const void* amat,
                                        void* digits, int B, int n_steps, int N, int k,
                                        int l, int bgbit, unsigned int offset,
                                        int mask_limbs, int body_limbs, int K,
                                        unsigned int mu, void* stream) {
  const int k1 = k + 1;
  const int smem = TILE_SMEM > N * 4 ? TILE_SMEM : N * 4;
  const int n_tiles = (N / BN) * ((B + BM - 1) / BM) * k1;
  int grid = 0;
  cudaError_t err = cooperative_grid(fused_blind_rotate_kernel, smem,
                                     n_tiles > B * k1 ? n_tiles : B * k1, &grid);
  if (err != cudaSuccess) return (int)err;
  uint32_t* acc_p = static_cast<uint32_t*>(acc);
  const int32_t* amt_p = static_cast<const int32_t*>(amt);
  const int8_t* amat_p = static_cast<const int8_t*>(amat);
  int8_t* digits_p = static_cast<int8_t*>(digits);
  uint32_t offset_v = offset, mu_v = mu;
  void* args[] = {&acc_p, &amt_p, &amat_p, &digits_p, &B, &n_steps, &N, &k, &l,
                  &bgbit, &offset_v, &mask_limbs, &body_limbs, &K, &mu_v};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_blind_rotate_kernel),
                                    dim3(grid), dim3(THREADS), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
