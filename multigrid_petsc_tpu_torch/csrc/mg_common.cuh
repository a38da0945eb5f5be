// Helpers shared by the package's CUDA sources (visit.cuh, line.cuh,
// coarse_tree.cu): storage/compute conversion, the 9-point coefficient
// layout, the bilinear prolongation and a block sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mg {

// Storage type T -> compute type: f32 and f64 compute in their own type;
// bf16 is storage only and computes in f32, as the JAX kernels do
// (ops/pallas/stencil_kernel.py _load_f32 / _store / _compute_dtype).
template <class T>
struct Compute {
  using type = T;
};
template <>
struct Compute<__nv_bfloat16> {
  using type = float;
};
template <class T>
using compute_t = typename Compute<T>::type;

// A stored value in its compute type.
__device__ __forceinline__ float to_c(float x) { return x; }
__device__ __forceinline__ double to_c(double x) { return x; }
__device__ __forceinline__ float to_c(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Store a computed value: the one rounding point of a bf16 output
// (round to nearest even, as torch's .to(torch.bfloat16)).
__device__ __forceinline__ void put(float* p, size_t i, float x) { p[i] = x; }
__device__ __forceinline__ void put(double* p, size_t i, double x) {
  p[i] = x;
}
__device__ __forceinline__ void put(__nv_bfloat16* p, size_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

// A computed value as storage type T holds it, in the compute type (bf16:
// rounded once, as put stores it; f32 and f64: unchanged).
template <class T>
__device__ __forceinline__ compute_t<T> round_to(compute_t<T> x) {
  if constexpr (sizeof(T) == 2)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

// A 9-point stencil's coefficients in device memory.  Coefficient q lives
// at p[q][(gy - oy) * sy[q] + (gx - ox) * sx[q]]: strides (w, 1) for a
// field of w columns, (1, 0) for an (ny, 1) column, (0, 1) for a row, (0,
// 0) for a scalar; oy (ox) is the first global row (column) the
// coefficients that vary with y (x) hold (0 for a whole grid; a block of a
// partitioned level holds only the rows and columns around its own).
// Order: csw, cs, cse, cw, cc, ce, cnw, cn, cne (the JAX package's
// Stencil9).
enum { CSW = 0, CS, CSE, CW, CC, CE, CNW, CN, CNE };

template <class T>
struct Coeffs9 {
  const T* p[9];
  int sy[9];
  int sx[9];
  int oy = 0;
  int ox = 0;
};

// 9-point coefficients from host arrays (the C entries' arguments): 9
// device pointers, then the 9 y-strides and the 9 x-strides.
template <class T>
inline Coeffs9<T> coeffs9(const unsigned long long* ptrs, const int* strides) {
  Coeffs9<T> c;
  for (int q = 0; q < 9; ++q) {
    c.p[q] = (const T*)ptrs[q];
    c.sy[q] = strides[q];
    c.sx[q] = strides[9 + q];
  }
  return c;
}

// Coefficient q at the domain point (gy, gx), in the compute type.
template <class T>
__device__ __forceinline__ compute_t<T> coef_at(const Coeffs9<T>& c, int q,
                                                int gy, int gx) {
  return to_c(c.p[q][(size_t)(gy - c.oy) * c.sy[q] +
                      (size_t)(gx - c.ox) * c.sx[q]]);
}

// Bilinear prolongation of the coarse field e (nyc x nxc, zero ring) at
// fine point (gy, gx), in the compute type; same arithmetic as
// ops/transfer.prolong_bilinear.
template <class T>
__device__ __forceinline__ compute_t<T> prolong_at(const T* e, int gy, int gx,
                                                   int nyc, int nxc) {
  using C = compute_t<T>;
  auto at = [&](int I, int J) -> C {
    return (I >= 0 && I < nyc && J >= 0 && J < nxc)
               ? to_c(e[(size_t)I * nxc + J]) : C(0);
  };
  const int I = gy >> 1, J = gx >> 1;
  const bool oy = gy & 1, ox = gx & 1;
  if (oy && ox) return at(I, J);
  if (oy) return (at(I, J - 1) + at(I, J)) * C(0.5);
  if (ox) return (at(I - 1, J) + at(I, J)) * C(0.5);
  return (at(I - 1, J - 1) + at(I - 1, J) + at(I, J - 1) + at(I, J)) *
         C(0.25);
}

// Sum of v over a block of NT threads (NT a multiple of 32, at most 1024);
// red holds NT / 32 values.  The result is valid in thread 0.
template <int NT, class C>
__device__ C block_sum(C v, C* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (NT == 32) return v;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    v = lane < NT / 32 ? red[lane] : C(0);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

}  // namespace mg
