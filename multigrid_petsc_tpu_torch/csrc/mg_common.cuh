// Helpers shared by the package's CUDA sources (visit.cu, line.cu,
// coarse_tree.cu): the 9-point coefficient layout, the bilinear
// prolongation and a block sum.
#pragma once

#include <cuda_runtime.h>

namespace mg {

// A 9-point stencil's coefficients in device memory.  Coefficient q lives
// at p[q][gy * sy[q] + gx * sx[q]]: strides (nx, 1) for an (ny, nx) field,
// (1, 0) for an (ny, 1) column, (0, 1) for a (1, nx) row, (0, 0) for a
// scalar.  Order: csw, cs, cse, cw, cc, ce, cnw, cn, cne (the JAX
// package's Stencil9).
enum { CSW = 0, CS, CSE, CW, CC, CE, CNW, CN, CNE };

struct Coeffs9 {
  const float* p[9];
  int sy[9];
  int sx[9];
};

// 9-point coefficients from host arrays (the C entries' arguments): 9
// device pointers, then the 9 y-strides and the 9 x-strides.
inline Coeffs9 coeffs9(const unsigned long long* ptrs, const int* strides) {
  Coeffs9 c;
  for (int q = 0; q < 9; ++q) {
    c.p[q] = (const float*)ptrs[q];
    c.sy[q] = strides[q];
    c.sx[q] = strides[9 + q];
  }
  return c;
}

// Coefficient q at the domain point (gy, gx).
__device__ __forceinline__ float coef_at(const Coeffs9& c, int q, int gy,
                                         int gx) {
  return c.p[q][(size_t)gy * c.sy[q] + (size_t)gx * c.sx[q]];
}

// Bilinear prolongation of the coarse field e (nyc x nxc, zero ring) at
// fine point (gy, gx); same arithmetic as ops/transfer.prolong_bilinear.
__device__ __forceinline__ float prolong_at(const float* e, int gy, int gx,
                                            int nyc, int nxc) {
  auto at = [&](int I, int J) -> float {
    return (I >= 0 && I < nyc && J >= 0 && J < nxc)
               ? e[(size_t)I * nxc + J] : 0.f;
  };
  const int I = gy >> 1, J = gx >> 1;
  const bool oy = gy & 1, ox = gx & 1;
  if (oy && ox) return at(I, J);
  if (oy) return (at(I, J - 1) + at(I, J)) * 0.5f;
  if (ox) return (at(I - 1, J) + at(I, J)) * 0.5f;
  return (at(I - 1, J - 1) + at(I - 1, J) + at(I, J - 1) + at(I, J)) * 0.25f;
}

// Sum of v over a block of NT threads (NT a multiple of 32, at most 1024);
// red holds NT / 32 floats.  The result is valid in thread 0.
template <int NT>
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (NT == 32) return v;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    v = lane < NT / 32 ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

}  // namespace mg
