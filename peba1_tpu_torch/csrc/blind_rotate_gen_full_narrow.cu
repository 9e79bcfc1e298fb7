// The narrow instance of blind_rotate_gen_full.cu's kernel (kernel 2, the
// whole blind rotation) for Hopper (sm_90a): narrow_rotation.cuh's step,
// which builds each step's Toeplitz weights in registers as the MMA's A
// operand with the batch rows as its N operand, for calls of 32 rows or
// fewer (ops/cuda_kernels.py picks it below NARROW_MAX_ROWS).  The same acc
// as blind_rotate_gen_full.cu.  A source of its own, so that the wide
// kernel's compilation unit holds nothing but that kernel.

#include "narrow_rotation.cuh"

using namespace peba1::rot;

namespace {

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
    blind_rotate_gen_full_narrow_kernel(const __grid_constant__ CUtensorMap digits_map,
                                        uint32_t* acc, const int32_t* __restrict__ amt,
                                        const int8_t* __restrict__ vv, int8_t* digits,
                                        unsigned int* grid_bar, const Args a,
                                        const NarrowPlan plan) {
  narrow_rotation<true, NT>(&digits_map, acc, amt, vv, digits, grid_bar, a, plan);
}

}  // namespace

// peba1_blind_rotate_gen_full's arguments, at B <= 32.
extern "C" int peba1_blind_rotate_gen_full_narrow(void* acc, const void* amt, const void* vv,
                                                  void* digits, void* grid_bar, int B,
                                                  int n_steps, int N, int k, int l, int bgbit,
                                                  unsigned int offset, int mask_limbs,
                                                  int body_limbs, unsigned int mu,
                                                  void* stream) {
  const Args a{B, n_steps, N, k, l, bgbit, offset, mask_limbs, body_limbs, 0, 1, 0, mu};
  switch (narrow_groups(B)) {
    case 1: return launch_narrow(blind_rotate_gen_full_narrow_kernel<1>, 1, acc, amt, vv,
                                 digits, grid_bar, a, stream);
    case 2: return launch_narrow(blind_rotate_gen_full_narrow_kernel<2>, 2, acc, amt, vv,
                                 digits, grid_bar, a, stream);
    case 4: return launch_narrow(blind_rotate_gen_full_narrow_kernel<4>, 4, acc, amt, vv,
                                 digits, grid_bar, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
