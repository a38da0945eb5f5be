// K16: SpMV of a matrix in DIA (diagonal) storage over a flat vector, for
// Hopper (sm_90a), bound through a plain C interface (ctypes).
//
//   y[r] = sum_k vals[k, r] * x[r + offsets[k]]   (x outside [0, n) is 0)
//
// Replaces multigrid_petsc_tpu/ops/pallas/spmv_dia.py dia_spmv_pallas: the
// banded operators of the explicit sparse backend that are not one grid's
// stencil, above all the grid-diagonal A1 of a merged level (5 + 2(G - 1)
// diagonals), which the E-cycle and the delayed cycles apply every sweep.
//
// What bounds it on the H100: bytes, (K + 2) * n * 4 (each diagonal, x and
// y once) against 2K flops per row.  The TPU kernel views the vector as
// (rows, 512) lanes and builds each shift from rolls and selects; here one
// thread owns one row: it reads vals[k, r] (neighbouring threads,
// neighbouring addresses) and x[r + d] (the same, shifted), so each load
// is coalesced and nothing is staged.  The kernel is instantiated for each
// count K of diagonals and unrolled, so a thread issues all 2K loads before
// it sums: a loop over a runtime K waited for each pair in turn and kept
// too few bytes in flight (0.67 TB/s effective at 8193^2, H100).  The
// shifted reads of x overlap between diagonals and come from L1/L2 for the
// most part.  The offsets (at most 16) travel in the kernel's parameter
// block.  A read of x outside [0, n) is not made; its term is vals * 0,
// as in the plain version (vals are zero there).  Terms are summed in the
// order of the offsets, as the TPU kernel sums them.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_DIAGS = 16;
constexpr int NTHREADS = 256;

struct Offsets {
  long long d[MAX_DIAGS];
};

template <int K>
__global__ void __launch_bounds__(NTHREADS)
dia_spmv_kernel(const float* __restrict__ vals, const float* __restrict__ x,
                float* __restrict__ y, long long n, Offsets off) {
  const long long r = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (r >= n) return;
  float v[K], xv[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const long long c = r + off.d[q];
    v[q] = vals[(size_t)q * n + r];
    xv[q] = (c >= 0 && c < n) ? x[c] : 0.f;
  }
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < K; ++q) acc += v[q] * xv[q];
  y[r] = acc;
}

}  // namespace

extern "C" {

// y = A x for A in DIA form: vals (k, n) f32 in device memory, row-major;
// offsets: k host ints (1 <= k <= 16).
int mg_dia_spmv(const float* vals, const float* x, float* y, long long n,
                const int* offsets, int k, void* stream) {
  if (k < 1 || k > MAX_DIAGS || n < 1 || (n + NTHREADS - 1) / NTHREADS >=
      (1LL << 31)) return (int)cudaErrorInvalidValue;
  Offsets off{};
  for (int q = 0; q < k; ++q) off.d[q] = offsets[q];
  const unsigned blocks = (unsigned)((n + NTHREADS - 1) / NTHREADS);
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
#define MG_DIA_CASE(K)                                              \
  case K:                                                           \
    dia_spmv_kernel<K><<<blocks, NTHREADS, 0, s>>>(vals, x, y, n, off); \
    break;
    MG_DIA_CASE(1) MG_DIA_CASE(2) MG_DIA_CASE(3) MG_DIA_CASE(4)
    MG_DIA_CASE(5) MG_DIA_CASE(6) MG_DIA_CASE(7) MG_DIA_CASE(8)
    MG_DIA_CASE(9) MG_DIA_CASE(10) MG_DIA_CASE(11) MG_DIA_CASE(12)
    MG_DIA_CASE(13) MG_DIA_CASE(14) MG_DIA_CASE(15) MG_DIA_CASE(16)
#undef MG_DIA_CASE
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
