// Rotate/decompose and the external product against precomputed Toeplitz
// weights W, for Hopper (sm_90a).  Built by peba1_tpu_torch/ops/cuda_kernels.py
// with nvcc into a shared library with a plain C interface, bound with ctypes.
// Three entry points, replacing three kernels of peba1_tpu/ops/pallas_kernels.py:
//
//   peba1_rotate_decompose   rotate_decompose (_rot_dec_kernel): digits of
//                            X^amt[b]*acc[b] - acc[b] in natural order,
//                            digits[b, (u*l+q)*N + t];
//   peba1_extprod_recombine  extprod_recombine (_extprod_rec_kernel):
//                            out[b, o] = sum_m (d[b] . W[:, c0(o)+m]) << (8(4-nl)+8m),
//                            stored;
//   peba1_cmux_step          cmux_step (_cmux_step_kernel): the two above per
//                            step, the product added into acc, for n steps.
//
// Layout of W: the port keeps W transposed, Wt = (C*N, G*N) per step, with
// Wt[c*N + j, g*N + t] = vv[g, c, N - t + j] (keys.CloudKey.bk_w).  A column
// of W, the four consecutive contraction bytes that one mma.sync B-fragment
// register holds, is then four consecutive bytes of a row of Wt, so the B
// tile is copied like the A tile: 16-byte loads along the contraction.  In
// JAX's (G*N, C*N) layout they would be C*N bytes apart.
//
// What bounds it: the int8 GEMM (B, G*N) x (G*N, C*N) on the tensor cores
// (mma.sync.m16n8k32.s8), and the weight stream: 17.3 MB of W a step at
// peba1_128_t2, read once per 64-row tile of the batch (from L2 after the
// first).  Each block owns BM batch rows x one output polynomial o x BN
// coefficients, walks the whole contraction in BK-byte stages of the digits
// and of o's nl limb rows of Wt in shared memory, and keeps the nl limb sums
// in registers; the limb recombination is the epilogue.  The int8 products
// accumulate exactly in int32 (TfheParams bounds (k+1)*l*N*128*128 < 2^31).
//
// Aliasing in cmux_step: a step is two launches, all digits to a scratch
// buffer, then the GEMM that adds into acc, so no acc element is written
// before every digit exists (the contract of pallas_kernels.py:310-313).

#include "common.cuh"

using namespace peba1;

namespace {

// rows [m0, m0+BM) x output polynomial o x coefficients [j0, j0+BN).
template <int NL, bool ADD>
__device__ __forceinline__ void w_gemm_tile(uint32_t* out, const int8_t* digits,
                                            const int8_t* wt, int B, int N, int GN,
                                            int c0, int o, int k1, int m0, int j0,
                                            int8_t* a_s, int8_t* b_s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;

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
        v = __ldg(reinterpret_cast<const int4*>(digits + (size_t)row * GN + k0 +
                                                chunk * 16));
      *reinterpret_cast<int4*>(a_s + r * A_STRIDE + chunk * 16) = v;
    }
    // Row r = m*BN + x of the B tile is row (c0+m)*N + j0 + x of Wt.
    for (int idx = tid; idx < NL * BN * BK / 16; idx += THREADS) {
      const int r = idx >> 2, chunk = idx & 3;
      const int m = r / BN, x = r - m * BN;
      const int8_t* src = wt + ((size_t)(c0 + m) * N + j0 + x) * GN + k0 + chunk * 16;
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
  store_tile<NL, ADD>(out, accum, B, N, k1, o, m0, j0);
}

// grid (N/BN, ceil(B/BM), k+1); blockIdx.z is the output polynomial o.
template <bool ADD>
__global__ void __launch_bounds__(THREADS)
    w_gemm_kernel(uint32_t* out, const int8_t* digits, const int8_t* __restrict__ wt,
                  int B, int N, int k, int l, int mask_limbs, int body_limbs) {
  __shared__ __align__(16) int8_t a_s[BM * A_STRIDE];
  __shared__ __align__(16) int8_t b_s[MAX_LIMBS * BN * A_STRIDE];
  const int o = blockIdx.z;
  const int nl = o < k ? mask_limbs : body_limbs;
  const int c0 = o * mask_limbs;  // limb columns are output-major
  const int GN = (k + 1) * l * N;
  const int m0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  switch (nl) {
    case 1: w_gemm_tile<1, ADD>(out, digits, wt, B, N, GN, c0, o, k + 1, m0, j0, a_s, b_s); break;
    case 2: w_gemm_tile<2, ADD>(out, digits, wt, B, N, GN, c0, o, k + 1, m0, j0, a_s, b_s); break;
    case 3: w_gemm_tile<3, ADD>(out, digits, wt, B, N, GN, c0, o, k + 1, m0, j0, a_s, b_s); break;
    default: w_gemm_tile<4, ADD>(out, digits, wt, B, N, GN, c0, o, k + 1, m0, j0, a_s, b_s); break;
  }
}

// One block per (batch row b, polynomial u).
__global__ void rotate_decompose_kernel(const uint32_t* acc, const int32_t* __restrict__ amt,
                                        int8_t* digits, int N, int k1, int l,
                                        int bgbit, uint32_t offset) {
  extern __shared__ uint32_t row[];
  rotate_decompose_row(acc, (uint32_t)amt[blockIdx.x], digits, blockIdx.x,
                       blockIdx.y, N, k1, l, bgbit, offset, row);
}

void launch_rotate_decompose(const void* acc, const int32_t* amt, void* digits, int B,
                             int N, int k, int l, int bgbit, uint32_t offset,
                             cudaStream_t st) {
  rotate_decompose_kernel<<<dim3(B, k + 1), 256, N * sizeof(uint32_t), st>>>(
      static_cast<const uint32_t*>(acc), amt, static_cast<int8_t*>(digits), N, k + 1,
      l, bgbit, offset);
}

}  // namespace

// digits (B, (k+1)*l*N) int8 of acc (B, (k+1)*N) int32 rotated by amt (B,)
// int32.  Returns the CUDA error of the launch (0 on success).
extern "C" int peba1_rotate_decompose(const void* acc, const void* amt, void* digits,
                                      int B, int N, int k, int l, int bgbit,
                                      unsigned int offset, void* stream) {
  launch_rotate_decompose(acc, static_cast<const int32_t*>(amt), digits, B, N, k, l,
                          bgbit, offset, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// out (B, (k+1)*N) int32 = digits (B, G*N) int8 x Wt (C*N, G*N) int8,
// recombined.  Requires N % 64 == 0.
extern "C" int peba1_extprod_recombine(void* out, const void* digits, const void* wt,
                                       int B, int N, int k, int l, int mask_limbs,
                                       int body_limbs, void* stream) {
  const dim3 grid(N / BN, (B + BM - 1) / BM, k + 1);
  w_gemm_kernel<false><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), static_cast<const int8_t*>(digits),
      static_cast<const int8_t*>(wt), B, N, k, l, mask_limbs, body_limbs);
  return (int)cudaGetLastError();
}

// n_steps CMUX steps on acc (B, (k+1)*N) int32, in place.  amt is (n_steps, B)
// int32, wt is (n_steps, C*N, G*N) int8, digits is (B, G*N) int8 scratch.
// Requires N % 64 == 0.  Returns the first CUDA error (0 on success).
extern "C" int peba1_cmux_step(void* acc, const void* amt, const void* wt,
                               void* digits, int B, int n_steps, int N, int k,
                               int l, int bgbit, unsigned int offset,
                               int mask_limbs, int body_limbs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int C = k * mask_limbs + body_limbs;
  const size_t w_step = (size_t)C * N * (k + 1) * l * N;
  const dim3 grid(N / BN, (B + BM - 1) / BM, k + 1);
  for (int s = 0; s < n_steps; ++s) {
    launch_rotate_decompose(acc, static_cast<const int32_t*>(amt) + (size_t)s * B,
                            digits, B, N, k, l, bgbit, offset, st);
    w_gemm_kernel<true><<<grid, THREADS, 0, st>>>(
        static_cast<uint32_t*>(acc), static_cast<const int8_t*>(digits),
        static_cast<const int8_t*>(wt) + s * w_step, B, N, k, l, mask_limbs,
        body_limbs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
