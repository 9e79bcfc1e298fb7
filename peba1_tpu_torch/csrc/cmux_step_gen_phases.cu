// The instance of cmux_step_gen.cu's kernel (kernel 1, S CMUX steps on an
// incoming acc) that records each step's phases, for Hopper (sm_90a):
// gen_rotation.cuh compiled with PHASES, which stamps every step of a window
// with the card's timer and the SM's clock (gen_rotation.cuh's REC_* layout)
// and otherwise computes the same acc.  Only the tools launch it
// (ops/cuda_kernels.record_phases; peba1_tpu_torch/step_phases.py reads the
// records); the program runs cmux_step_gen.cu.  It has a source of its own
// so that the default kernel's compilation unit holds nothing but that
// kernel, and compiles to the same machine code as before.

#include "gen_rotation.cuh"

using namespace peba1::rot;

namespace {

__global__ void __launch_bounds__(THREADS, 1)
    cmux_step_gen_phases_kernel(const __grid_constant__ CUtensorMap digits_map, uint32_t* acc,
                                const int32_t* __restrict__ amt,
                                const int8_t* __restrict__ vv, int8_t* digits,
                                unsigned int* grid_bar, const Args a, const PhaseRec pr) {
  gen_rotation<false, true>(&digits_map, acc, amt, vv, digits, grid_bar, a, &pr);
}

}  // namespace

// peba1_cmux_step_gen, recording steps [rec_first, rec_first + rec_count)
// into rec (uint64, room for rec_blocks blocks; the kernel writes every word
// of the header and of the window's records).
extern "C" int peba1_cmux_step_gen_phases(void* acc, const void* amt, const void* vv,
                                          void* digits, void* grid_bar, int B, int n_steps,
                                          int N, int k, int l, int bgbit, unsigned int offset,
                                          int mask_limbs, int body_limbs, void* rec,
                                          int rec_blocks, int rec_first, int rec_count,
                                          void* stream) {
  const Args a{B, n_steps, N, k, l, bgbit, offset, mask_limbs, body_limbs, 0, 1, 0, 0u};
  const PhaseRec pr{static_cast<uint64_t*>(rec), rec_first, rec_count};
  return launch_gen_rotation(cmux_step_gen_phases_kernel, acc, amt, vv, digits, grid_bar, a,
                             stream, &pr, rec_blocks);
}
