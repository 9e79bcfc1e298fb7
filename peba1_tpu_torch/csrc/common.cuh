// Device code shared by the kernel families of csrc/ (cmux_step_gen.cu,
// cmux_step.cu and fused_blind_rotate.cu): the tile constants, the int8
// tensor-core product, one row of rotate + difference + gadget
// decomposition, the limb-recombining epilogue of a GEMM tile, and the
// accumulator set-up and grid size of the whole-rotation kernels.  Each
// family keeps its GEMM tile in its own source: made a template shared with
// the A-matrix tile, cmux_step.cu's W tile measured 7-19% slower on an H100
// (PERF.md, kernel 6's findings).
//
// All arithmetic on torus values is uint32 (signed overflow is undefined in
// C++).  The accumulator and the digit scratch are read and written through
// `load`/`store`, whose SHARED flag says whether other blocks of the same
// launch write them: in the whole-rotation kernels they do, so there they go
// through L2 only (ld/st.global.cg), since L1 is not coherent across SMs.
// A launch that only reads them uses the read-only path (ld.global.nc).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace peba1 {

constexpr int BM = 64;             // batch rows per GEMM tile
constexpr int BN = 64;             // output coefficients per GEMM tile
constexpr int BK = 64;             // contraction bytes per shared-memory stage
constexpr int A_STRIDE = BK + 16;  // 80-byte rows: fragment loads hit 32 banks
constexpr int THREADS = 128;       // 4 warps, 2 x 2 over the 64 x 64 tile
constexpr int MAX_LIMBS = 4;

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <bool SHARED, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (SHARED) return __ldcg(p);
  else return __ldg(p);
}

template <bool SHARED, typename T>
__device__ __forceinline__ void store(T* p, T v) {
  if constexpr (SHARED) __stcg(p, v);
  else *p = v;
}

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Gadget digits of polynomial u of accumulator row b, rotated by a:
// digit q of (X^a * acc[b,u])[t] - acc[b,u][t].  NATURAL order puts it at
// digits[b, (u*l+q)*N + t] (the layout of pallas_kernels.rotate_decompose);
// otherwise at (u*l+q)*N + N-1-t (the generator GEMM's reversed order).
// Every thread of the block calls it; `row` is N uint32 of shared memory,
// which the caller must not reuse before a __syncthreads().
template <bool NATURAL, bool SHARED>
__device__ __forceinline__ void rotate_decompose_row(
    const uint32_t* acc, uint32_t a, int8_t* digits, int b, int u, int N,
    int k1, int l, int bgbit, uint32_t offset, uint32_t* row) {
  const uint32_t* src = acc + ((size_t)b * k1 + u) * N;
  for (int t = threadIdx.x; t < N; t += blockDim.x) row[t] = load<SHARED>(src + t);
  __syncthreads();
  const uint32_t bg_mask = (1u << bgbit) - 1u;
  const int half_bg = 1 << (bgbit - 1);
  int8_t* dst = digits + (size_t)b * k1 * l * N;
  for (int t = threadIdx.x; t < N; t += blockDim.x) {
    // (X^a p)[t] = p[i] if i < N else -p[i-N], with i = (t - a) mod 2N.
    const uint32_t i = ((uint32_t)t - a) & (uint32_t)(2 * N - 1);
    const uint32_t rot = i < (uint32_t)N ? row[i] : 0u - row[i - N];
    const uint32_t v = rot - row[t] + offset;
    const int pos = NATURAL ? t : N - 1 - t;
    for (int q = 0; q < l; ++q) {
      const int d = (int)((v >> (32 - (q + 1) * bgbit)) & bg_mask) - half_bg;
      store<SHARED>(dst + (size_t)(u * l + q) * N + pos, (int8_t)d);
    }
  }
}

// Epilogue of a GEMM tile (rows [m0, m0+BM) x output polynomial o x
// coefficients [j0, j0+BN)): recombine the NL limb sums,
// delta = sum_m accum[m] << (8(4-NL) + 8m) mod 2^32, and add it into
// out[row, o, col] (ADD) or store it there.  Fragment layout of
// mma.m16n8k32 over the 2 x 2 warp grid.  Each element is read and written
// by one thread only.
template <int NL, bool ADD, bool SHARED>
__device__ __forceinline__ void store_tile(uint32_t* out,
                                           const int32_t (&accum)[NL][2][4][4],
                                           int B, int N, int k1, int o, int m0,
                                           int j0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int shift0 = 8 * (4 - NL);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + wm * 32 + mt * 16 + grp + (i >> 1) * 8;
        const int col = j0 + wn * 32 + nt * 8 + tig * 2 + (i & 1);
        if (row < B) {
          uint32_t delta = 0;
#pragma unroll
          for (int m = 0; m < NL; ++m)
            delta += (uint32_t)accum[m][mt][nt][i] << (shift0 + 8 * m);
          uint32_t* p = out + ((size_t)row * k1 + o) * N + col;
          if constexpr (ADD) {
            if constexpr (SHARED) delta += __ldcg(p);
            else delta += *p;
          }
          store<SHARED>(p, delta);
        }
      }
}

// First phase of a whole-rotation kernel, over the whole grid:
// acc = [0 | X^amt0[b] * (mu, ..., mu)] for every row b.  Written through
// L2 (other blocks read it after the caller's grid barrier).
__device__ __forceinline__ void init_accumulator(uint32_t* acc, const int32_t* amt0,
                                                 int B, int N, int k, uint32_t mu) {
  const int k1 = k + 1;
  const size_t acc_len = (size_t)B * k1 * N;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < acc_len;
       idx += stride) {
    const int t = (int)(idx % N);
    const size_t bu = idx / N;
    uint32_t v = 0;
    if ((int)(bu % k1) == k) {
      const uint32_t i = ((uint32_t)t - (uint32_t)amt0[bu / k1]) & (uint32_t)(2 * N - 1);
      v = i < (uint32_t)N ? mu : 0u - mu;
    }
    __stcg(acc + idx, v);
  }
}

// Grid of a cooperative launch of `kernel` with THREADS threads and `smem`
// bytes of dynamic shared memory: every block that fits on the card at once
// (occupancy x SMs), capped by `work`.  Also raises the kernel's dynamic
// shared-memory limit to `smem`.
template <typename Kernel>
inline cudaError_t cooperative_grid(Kernel kernel, int smem, int work, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                           smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *grid = per_sm * sms < work ? per_sm * sms : work;
  return cudaSuccess;
}

}  // namespace peba1
