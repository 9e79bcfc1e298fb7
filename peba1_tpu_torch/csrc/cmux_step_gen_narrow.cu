// The narrow instance of cmux_step_gen.cu's kernel (kernel 1, S CMUX steps
// on an acc that comes in) for Hopper (sm_90a): narrow_rotation.cuh's step,
// which builds each step's Toeplitz weights in registers as the MMA's A
// operand with the batch rows as its N operand, for calls of 32 rows or
// fewer (ops/cuda_kernels.py picks it below NARROW_MAX_ROWS).  The same acc
// as cmux_step_gen.cu, updated in place.  A source of its own, so that the
// wide kernel's compilation unit holds nothing but that kernel.

#include "narrow_rotation.cuh"

using namespace peba1::rot;

namespace {

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
    cmux_step_gen_narrow_kernel(const __grid_constant__ CUtensorMap digits_map, uint32_t* acc,
                                const int32_t* __restrict__ amt, const int8_t* __restrict__ vv,
                                int8_t* digits, unsigned int* grid_bar, const Args a,
                                const NarrowPlan plan) {
  narrow_rotation<false, NT>(&digits_map, acc, amt, vv, digits, grid_bar, a, plan);
}

}  // namespace

// peba1_cmux_step_gen's arguments, at B <= 32.
extern "C" int peba1_cmux_step_gen_narrow(void* acc, const void* amt, const void* vv,
                                          void* digits, void* grid_bar, int B, int n_steps,
                                          int N, int k, int l, int bgbit, unsigned int offset,
                                          int mask_limbs, int body_limbs, void* stream) {
  const Args a{B, n_steps, N, k, l, bgbit, offset, mask_limbs, body_limbs, 0, 1, 0, 0u};
  switch (narrow_groups(B)) {
    case 1: return launch_narrow(cmux_step_gen_narrow_kernel<1>, 1, acc, amt, vv, digits,
                                 grid_bar, a, stream);
    case 2: return launch_narrow(cmux_step_gen_narrow_kernel<2>, 2, acc, amt, vv, digits,
                                 grid_bar, a, stream);
    case 4: return launch_narrow(cmux_step_gen_narrow_kernel<4>, 4, acc, amt, vv, digits,
                                 grid_bar, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
