// Device code of cmux_step.cu (kernels 3-5): the tile constants, the int8
// tensor-core product, one row of rotate + difference + gadget
// decomposition, and the limb-recombining epilogue of a GEMM tile.  Each
// family keeps its GEMM tile in its own source: made a template shared with
// the A-matrix tile, cmux_step.cu's W tile measured 7-19% slower on an H100
// (PERF.md, kernel 6's findings).  The kernels that run many steps a launch
// (1, 2 and 6) have their own header, whole_rotation.cuh.
//
// All arithmetic on torus values is uint32 (signed overflow is undefined in
// C++).  No block of a launch writes what another block of it reads, so the
// accumulator and the digits are read through the read-only path
// (ld.global.nc).

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

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Gadget digits of polynomial u of accumulator row b, rotated by a:
// digit q of (X^a * acc[b,u])[t] - acc[b,u][t], at digits[b, (u*l+q)*N + t]
// (the layout of pallas_kernels.rotate_decompose).  Every thread of the
// block calls it; `row` is N uint32 of shared memory, which the caller must
// not reuse before a __syncthreads().
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

// Epilogue of a GEMM tile (rows [m0, m0+BM) x output polynomial o x
// coefficients [j0, j0+BN)): recombine the NL limb sums,
// delta = sum_m accum[m] << (8(4-NL) + 8m) mod 2^32, and add it into
// out[row, o, col] (ADD) or store it there.  Fragment layout of
// mma.m16n8k32 over the 2 x 2 warp grid.  Each element is read and written
// by one thread only.
template <int NL, bool ADD>
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
          if constexpr (ADD) delta += *p;
          *p = delta;
        }
      }
}

}  // namespace peba1
