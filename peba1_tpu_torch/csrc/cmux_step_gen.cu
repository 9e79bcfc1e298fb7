// CMUX steps of blind rotation with each step's negacyclic Toeplitz weights
// formed on the fly from the small doubled generator, for Hopper (sm_90a).
// Built by peba1_tpu_torch/ops/cuda_kernels.py with nvcc into a shared
// library with a plain C interface, bound with ctypes.
//
// peba1_cmux_step_gen replaces peba1_tpu/ops/pallas_kernels.py cmux_step_gen
// (_cmux_step_gen_kernel): for every batch row b and output polynomial o,
//   acc[b, o] += sum_m (sum_{g,t} d[b,g,t] * vv[g, c0(o)+m, N-t+j]) << (8(4-nl)+8m)
// where d are the gadget digits of X^amt[b]*acc[b] - acc[b].  The int8
// products accumulate exactly in int32 because TfheParams bounds
// (k+1)*l*N*128*128 < 2^31.  (The whole rotation on the same key,
// blind_rotate_gen_full, is blind_rotate_gen_full.cu.)
//
// What bounds a step: the int8 GEMM, (B, G*N) x (G*N, C*N)
// ((B,3072)x(3072,5632) at peba1_128_t2_gen), run on the tensor cores with
// mma.sync.m16n8k32.s8.  The TPU kernel stages the whole assembled weight
// matrix (7.6 MB at t2) in VMEM; an SM has 227 KB.  So each GEMM tile is BM
// batch rows x one output polynomial x BN coefficients and keeps only the
// generator rows of that polynomial's nl limb columns, for one digit
// polynomial g at a time, in shared memory (N+BN bytes per limb), with the
// nl limb accumulators in registers.  W is never formed anywhere.
//
// Toeplitz direction: with the digits written in reversed coefficient order
// (k = N-1-t), the weight is W'[k, j] = vv[1+k+j], increasing in k, so four
// consecutive k of one column are four consecutive generator bytes.  Their
// start 1+k+j has the alignment of j; the generator is kept in four
// byte-shifted copies so each B fragment register is one aligned 32-bit
// shared-memory load.
//
// Aliasing: no acc element is written before every digit of the step has
// been produced (the contract of pallas_kernels.py:442-445).  A step is two
// launches, digits to a scratch buffer, then the GEMM that adds into acc;
// the host loop over the steps runs here, so a bootstrap is one ctypes call.

#include "common.cuh"

using namespace peba1;

namespace {

// One GEMM tile against the generator: rows [m0, m0+BM) x output polynomial
// o x coefficients [j0, j0+BN), all NL limb columns of o at once, added into
// acc.  digits are in reversed coefficient order.
template <int NL>
__device__ __forceinline__ void gen_gemm_tile(uint32_t* acc, const int8_t* digits,
                                              const int8_t* vv, int B, int N,
                                              int G, int C, int c0, int o, int k1,
                                              int m0, int j0, int8_t* a_s,
                                              int8_t* gen_s, int gen_stride) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int GN = G * N;
  const int two_n = 2 * N;
  const int gen_len = N + BN + 4;
  // Copy r of a generator row holds byte x = vv[1 + j0 + x + r].  Lane
  // (grp, tig) always reads copy grp & 3 at a 4-byte-aligned offset.
  const int r_copy = grp & 3;

  int32_t accum[NL][2][4][4];
#pragma unroll
  for (int m = 0; m < NL; ++m)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) accum[m][mt][nt][i] = 0;

  for (int g = 0; g < G; ++g) {
    __syncthreads();  // every warp is done reading the previous rows
    for (int m = 0; m < NL; ++m) {
      const int8_t* src = vv + ((size_t)g * C + c0 + m) * two_n;
      int8_t* dst = gen_s + m * 4 * gen_stride;
      for (int idx = tid; idx < 4 * gen_len; idx += THREADS) {
        const int r = idx / gen_len, x = idx - r * gen_len;
        const int pos = 1 + j0 + x + r;
        dst[r * gen_stride + x] = pos < two_n ? __ldg(src + pos) : (int8_t)0;
      }
    }
    for (int k0 = 0; k0 < N; k0 += BK) {
      for (int idx = tid; idx < BM * BK / 16; idx += THREADS) {
        const int r = idx >> 2, chunk = idx & 3;
        const int row = m0 + r;
        int4 v = make_int4(0, 0, 0, 0);
        if (row < B)
          v = __ldg(reinterpret_cast<const int4*>(digits + (size_t)row * GN +
                                                  g * N + k0 + chunk * 16));
        *reinterpret_cast<int4*>(a_s + r * A_STRIDE + chunk * 16) = v;
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
          // B[k][n] for k = k0+kk+tig*4+{0..3} (and +16), n = grp:
          // vv[1 + k + j0 + wn*32 + nt*8 + grp] = copy r_copy at `off`.
          const int off = k0 + kk + tig * 4 + wn * 32 + nt * 8 + grp - r_copy;
#pragma unroll
          for (int m = 0; m < NL; ++m) {
            const int8_t* br = gen_s + (m * 4 + r_copy) * gen_stride + off;
            const uint32_t b0 = ld32(br), b1 = ld32(br + 16);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) mma_s8(accum[m][mt][nt], af[mt], b0, b1);
          }
        }
      }
      __syncthreads();
    }
  }
  store_tile<NL, true>(acc, accum, B, N, k1, o, m0, j0);
}

// The tile of output polynomial o with its limb count as a template argument.
__device__ __forceinline__ void gen_gemm_tile_any(uint32_t* acc, const int8_t* digits,
                                                  const int8_t* vv, int B, int N, int k,
                                                  int l, int mask_limbs, int body_limbs,
                                                  int o, int m0, int j0, int8_t* smem,
                                                  int gen_stride) {
  const int nl = o < k ? mask_limbs : body_limbs;
  const int c0 = o * mask_limbs;  // limb columns are output-major
  const int C = k * mask_limbs + body_limbs;
  const int G = (k + 1) * l;
  int8_t* a_s = smem;
  int8_t* gen_s = smem + BM * A_STRIDE;
  switch (nl) {
    case 1: gen_gemm_tile<1>(acc, digits, vv, B, N, G, C, c0, o, k + 1, m0, j0, a_s, gen_s, gen_stride); break;
    case 2: gen_gemm_tile<2>(acc, digits, vv, B, N, G, C, c0, o, k + 1, m0, j0, a_s, gen_s, gen_stride); break;
    case 3: gen_gemm_tile<3>(acc, digits, vv, B, N, G, C, c0, o, k + 1, m0, j0, a_s, gen_s, gen_stride); break;
    default: gen_gemm_tile<4>(acc, digits, vv, B, N, G, C, c0, o, k + 1, m0, j0, a_s, gen_s, gen_stride); break;
  }
}

// Launch 1 of a step: one block per (batch row b, polynomial u).
__global__ void rotate_decompose_kernel(const uint32_t* acc, const int32_t* __restrict__ amt,
                                        int8_t* digits, int N, int k1, int l,
                                        int bgbit, uint32_t offset) {
  extern __shared__ uint32_t row[];
  rotate_decompose_row<false>(acc, (uint32_t)amt[blockIdx.x], digits, blockIdx.x,
                              blockIdx.y, N, k1, l, bgbit, offset, row);
}

// Launch 2 of a step: grid (N/BN, ceil(B/BM), k+1).
__global__ void __launch_bounds__(THREADS)
    extprod_gen_kernel(uint32_t* acc, const int8_t* digits,
                       const int8_t* __restrict__ vv, int B, int N, int k,
                       int l, int mask_limbs, int body_limbs, int gen_stride) {
  extern __shared__ __align__(16) int8_t smem[];
  gen_gemm_tile_any(acc, digits, vv, B, N, k, l, mask_limbs, body_limbs, blockIdx.z,
                    blockIdx.y * BM, blockIdx.x * BN, smem, gen_stride);
}

int gen_stride_for(int N) { return ((N + BN + 4 + 127) / 128) * 128 + 32; }

int gemm_smem(int N) { return BM * A_STRIDE + MAX_LIMBS * 4 * gen_stride_for(N); }

}  // namespace

// n_steps CMUX steps on acc (B, (k+1)*N) int32, in place.  amt is (n_steps, B)
// int32, vv is (n_steps, G, C, 2N) int8, digits is (B, G*N) int8 scratch.
// Requires N % 64 == 0.  Returns the first CUDA error (0 on success).
extern "C" int peba1_cmux_step_gen(void* acc, const void* amt, const void* vv,
                                   void* digits, int B, int n_steps, int N,
                                   int k, int l, int bgbit,
                                   unsigned int offset, int mask_limbs,
                                   int body_limbs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int k1 = k + 1, G = k1 * l, C = k * mask_limbs + body_limbs;
  const int gen_stride = gen_stride_for(N);
  const int smem = gemm_smem(N);
  cudaError_t err = cudaFuncSetAttribute(
      extprod_gen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 rd_grid(B, k1);
  const dim3 mm_grid(N / BN, (B + BM - 1) / BM, k1);
  const size_t vv_step = (size_t)G * C * 2 * N;
  for (int s = 0; s < n_steps; ++s) {
    rotate_decompose_kernel<<<rd_grid, 256, N * sizeof(uint32_t), st>>>(
        static_cast<const uint32_t*>(acc), static_cast<const int32_t*>(amt) + (size_t)s * B,
        static_cast<int8_t*>(digits), N, k1, l, bgbit, offset);
    extprod_gen_kernel<<<mm_grid, THREADS, smem, st>>>(
        static_cast<uint32_t*>(acc), static_cast<const int8_t*>(digits),
        static_cast<const int8_t*>(vv) + s * vv_step, B, N, k, l, mask_limbs,
        body_limbs, gen_stride);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
