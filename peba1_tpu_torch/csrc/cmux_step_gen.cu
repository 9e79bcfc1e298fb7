// CMUX steps of blind rotation with each step's negacyclic Toeplitz weights
// formed on the fly from the small doubled generator, for Hopper (sm_90a).
// Built by peba1_tpu_torch/ops/cuda_kernels.py with nvcc into a shared
// library with a plain C interface, bound with ctypes.
//
// peba1_cmux_step_gen replaces peba1_tpu/ops/pallas_kernels.py cmux_step_gen
// (_cmux_step_gen_kernel), scanned over the steps: for every step s, batch
// row b and output polynomial o,
//   acc[b, o] += sum_m (sum_{g,t} d[b,g,t] * vv[s, g, c0(o)+m, N-t+j]) << (8(4-nl)+8m)
// where d are the gadget digits of X^amt[s,b]*acc[b] - acc[b].  The int8
// products accumulate exactly in int32 because TfheParams bounds
// (k+1)*l*N*128*128 < 2^31.
//
// What bounds a step: the int8 GEMM, (B, G*N) x (G*N, C*N)
// ((B, 3072) x (3072, 5632) at peba1_128_t2_gen).  The TPU kernel assembles
// the whole weight matrix in VMEM; an SM has 227 KB.  This is the
// whole-rotation kernel blind_rotate_gen_full.cu without the accumulator
// set-up: all S steps of a call in one cooperative launch on
// whole_rotation.cuh's skeleton (a digit phase, a grid barrier, a wgmma
// GEMM phase fed by a producer warpgroup that expands the generator into a
// shared-memory ring, a grid barrier), a step's work items walked by stage
// (gen_rotation.cuh): whole waves, then the last partial wave cut evenly
// over the grid, each stage once and no split of the contraction.
//
// Aliasing: acc is updated in place, and no acc element of a step is
// written before every digit of the step exists (the contract of
// pallas_kernels.py:442-445): the grid barrier between the two phases.

#include "gen_rotation.cuh"

using namespace peba1::rot;

namespace {

// amt is (n_steps, B), row s step s's rotation; vv is (n_steps, G, C, 2N);
// digits_map views the (B, G*N) digits.
__global__ void __launch_bounds__(THREADS, 1)
    cmux_step_gen_kernel(const __grid_constant__ CUtensorMap digits_map, uint32_t* acc,
                         const int32_t* __restrict__ amt, const int8_t* __restrict__ vv,
                         int8_t* digits, unsigned int* grid_bar, const Args a) {
  gen_rotation<false>(&digits_map, acc, amt, vv, digits, grid_bar, a);
}

}  // namespace

// n_steps CMUX steps on acc (B, (k+1)*N) int32, in place, in one cooperative
// launch.  amt is (n_steps, B) int32, vv is (n_steps, G, C, 2N) int8, digits
// is (B, G*N) int8 scratch, grid_bar one zeroed uint32.  Requires
// N % 128 == 0.  Returns the first CUDA error (0 on success).
extern "C" int peba1_cmux_step_gen(void* acc, const void* amt, const void* vv, void* digits,
                                   void* grid_bar, int B, int n_steps, int N, int k, int l,
                                   int bgbit, unsigned int offset, int mask_limbs,
                                   int body_limbs, void* stream) {
  const Args a{B, n_steps, N, k, l, bgbit, offset, mask_limbs, body_limbs, 0, 1, 0, 0u};
  return launch_gen_rotation(cmux_step_gen_kernel, acc, amt, vv, digits, grid_bar, a, stream);
}
