// The whole blind rotation with each step's negacyclic Toeplitz weights
// formed on the fly from the small doubled generator, for Hopper (sm_90a).
// Built by peba1_tpu_torch/ops/cuda_kernels.py with nvcc into a shared
// library with a plain C interface, bound with ctypes.
//
// peba1_blind_rotate_gen_full replaces peba1_tpu/ops/pallas_kernels.py
// blind_rotate_gen_full (_gen_full_kernel): acc = [0 | X^amt0 * mu], then for
// every step s < n, with d the gadget digits of X^amt[s+1]*acc - acc,
//   acc[o] += sum_m (sum_{g,t} d[g,t] * vv[s, g, c0(o)+m, N-t+j]) << (8(4-nl)+8m),
// in one launch.  The int8 products accumulate exactly in int32 because
// TfheParams bounds (k+1)*l*N*128*128 < 2^31.
//
// What bounds it: the int8 GEMM of each step, (B, G*N) x (G*N, C*N)
// ((B, 4096) x (4096, 7168) at peba1_128_fast_genf).  W is never formed in
// device memory: the TPU kernel assembles it in VMEM from the generator
// key (36-43 MB, which here streams from L2); an SM has 227 KB, so the
// skeleton is whole_rotation.cuh's, and each stage's weight tile is
// expanded into the ring from the item's generator rows in shared memory
// (gen_rotation.cuh, shared with cmux_step_gen.cu).  A step's work items are
// walked by stage: whole waves, then the last partial wave cut evenly over
// the grid, each stage once and no split of the contraction.

#include "gen_rotation.cuh"

using namespace peba1::rot;

namespace {

// amt is (n_steps+1, B): row 0 the initial body rotation, row s+1 step s's
// rotation; vv is (n_steps, G, C, 2N); digits_map views the (B, G*N) digits.
__global__ void __launch_bounds__(THREADS, 1)
    blind_rotate_gen_full_kernel(const __grid_constant__ CUtensorMap digits_map, uint32_t* acc,
                                 const int32_t* __restrict__ amt,
                                 const int8_t* __restrict__ vv, int8_t* digits,
                                 unsigned int* grid_bar, const Args a) {
  gen_rotation<true>(&digits_map, acc, amt, vv, digits, grid_bar, a);
}

}  // namespace

// The whole blind rotation in one cooperative launch: acc (B, (k+1)*N) int32
// is written (not read) as [0 | X^amt[0] * mu], then n_steps CMUX steps run on
// it.  amt is (n_steps+1, B) int32, vv is (n_steps, G, C, 2N) int8, digits is
// (B, G*N) int8 scratch, grid_bar one zeroed uint32.  Requires
// N % 128 == 0.  Returns the first CUDA error (0 on success).
extern "C" int peba1_blind_rotate_gen_full(void* acc, const void* amt, const void* vv,
                                           void* digits, void* grid_bar, int B, int n_steps,
                                           int N, int k, int l, int bgbit,
                                           unsigned int offset, int mask_limbs,
                                           int body_limbs, unsigned int mu, void* stream) {
  const Args a{B, n_steps, N, k, l, bgbit, offset, mask_limbs, body_limbs, 0, 1, 0, mu};
  return launch_gen_rotation(blind_rotate_gen_full_kernel, acc, amt, vv, digits, grid_bar, a,
                             stream);
}
