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
// What bounds it: bytes, one read of acc and one write of the digits.  One
// block per (row, polynomial) pair stages the polynomial in shared memory,
// so the rotated gather reads shared memory, not device memory.
//
// All arithmetic on torus values is uint32 (signed overflow is undefined in
// C++).  No block writes what another block reads, so acc is read through
// the read-only path (ld.global.nc).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Gadget digits of polynomial u of accumulator row b, rotated by a:
// digit q of (X^a * acc[b,u])[t] - acc[b,u][t], at digits[b, (u*l+q)*N + t]
// (the layout of pallas_kernels.rotate_decompose).  Every thread of the
// block calls it; `row` is N uint32 of shared memory.
__device__ __forceinline__ void rotate_decompose_row(
    const uint32_t* acc, uint32_t a, int8_t* digits, int b, int u, int N,
    int k1, int l, int bgbit, uint32_t offset, uint32_t* row) {
  const uint32_t* src = acc + ((size_t)b * k1 + u) * N;
  for (int t = threadIdx.x; t < N; t += blockDim.x) row[t] = __ldg(src + t);
  __syncthreads();
  const uint32_t bg_mask = (1u << bgbit) - 1u;
  const int half_bg = 1 << (bgbit - 1);
  int8_t* dst = digits + (size_t)b * k1 * l * N;
  for (int t = threadIdx.x; t < N; t += blockDim.x) {
    // (X^a p)[t] = p[i] if i < N else -p[i-N], with i = (t - a) mod 2N.
    const uint32_t i = ((uint32_t)t - a) & (uint32_t)(2 * N - 1);
    const uint32_t rot = i < (uint32_t)N ? row[i] : 0u - row[i - N];
    const uint32_t v = rot - row[t] + offset;
    for (int q = 0; q < l; ++q) {
      const int d = (int)((v >> (32 - (q + 1) * bgbit)) & bg_mask) - half_bg;
      dst[(size_t)(u * l + q) * N + t] = (int8_t)d;
    }
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

}  // namespace

// digits (B, (k+1)*l*N) int8 of acc (B, (k+1)*N) int32 rotated by amt (B,)
// int32.  Returns the CUDA error of the launch (0 on success).
extern "C" int peba1_rotate_decompose(const void* acc, const void* amt, void* digits,
                                      int B, int N, int k, int l, int bgbit,
                                      unsigned int offset, void* stream) {
  rotate_decompose_kernel<<<dim3(B, k + 1), 256, N * sizeof(uint32_t),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(acc), static_cast<const int32_t*>(amt),
      static_cast<int8_t*>(digits), N, k + 1, l, bgbit, offset);
  return (int)cudaGetLastError();
}
