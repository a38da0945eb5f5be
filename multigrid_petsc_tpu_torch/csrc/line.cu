// The y-line smoother's level visit (K15) for Hopper (sm_90a), bound
// through a plain C interface (ctypes), for f32 (mg_line_*) and f64
// (mg_line_*_f64) levels; the arithmetic runs in the storage type.
//
// Replaces multigrid_petsc_tpu/ops/pallas/line_kernel.py
// (line_visit9_pallas): k damped y-line Jacobi sweeps on a 9-point
// stencil -- each moves the off-line terms (w, e and the four corners) to
// the right-hand side from the previous iterate, solves the tridiagonal
// (cs, cc, cn) system of every column and blends
// u <- (1 - omega) u + omega u_line -- then the residual and its
// full-weighting restriction, the residual alone, or <b, u>.  A coarse
// correction u + P e is applied while the first sweep reads u.
//
// What bounds it on the H100: latency.  The TPU kernel holds a whole level
// (up to ~1023^2) in VMEM and runs the visit in one call.  Here a sweep
// couples all of a column's rows (the tridiagonal solve) and its
// neighbouring columns (the off-line terms from the previous sweep), and
// a full column of an 8191^2 level does not fit a block's shared memory,
// so the design is one launch per sweep (plus one for the residual or
// restriction), with one thread per column: neighbouring threads take
// neighbouring columns, so every row's loads and stores are coalesced.
// The solve is Thomas's recurrence with the per-row factors
// (m_i = 1 / (d_i - a_i cp_{i-1}), cp_i = c_i m_i) computed once per level
// on the host in f64; they are columns, or full fields where the line
// coefficients vary with x.  The forward pass stores dp in the output
// buffer and the backward pass overwrites it with the blended iterate
// (each thread touches only its own column there).  Only nx threads run,
// each walking ny rows in order, so the card is far from busy at 8191^2:
// a kernel that is right first; a split of the columns (PCR across a
// block) is later work.

#include <cuda_runtime.h>

#include "mg_common.cuh"

namespace {

using mg::Coeffs9;
using mg::coef_at;
using mg::prolong_at;

constexpr int LT = 32;  // columns (threads) per block of the sweep
constexpr int FT = 256;  // threads per block of the residual pass

// Thomas factors of the line systems: m (1 / pivot) and cp (the
// eliminated super-diagonal), each an (ny, 1) column (sx = 0) or an
// (ny, nx) field (sx = 1).
template <class T>
struct LineFactor {
  const T* m;
  const T* cp;
  int sx;
};

// The sweep's input iterate at (y, x): u (or zero) plus the prolonged
// correction, zero outside the domain.
template <bool GUESS, bool CORRECT, class T>
__device__ __forceinline__ T iterate_at(const T* u, const T* e, int y, int x,
                                        int ny, int nx) {
  if (y < 0 || y >= ny || x < 0 || x >= nx) return T(0);
  T v = GUESS ? u[(size_t)y * nx + x] : T(0);
  if (CORRECT) v += prolong_at(e, y, x, (ny - 1) / 2, (nx - 1) / 2);
  return v;
}

// One sweep on column j = blockIdx.x * LT + threadIdx.x.  u_out must not
// alias u: neighbouring columns read u while this one is written.
template <class T, bool GUESS, bool CORRECT, bool DOT>
__global__ void __launch_bounds__(LT)
line_sweep_kernel(Coeffs9<T> c, LineFactor<T> f, const T* __restrict__ b,
                  const T* __restrict__ u, const T* __restrict__ e,
                  T* __restrict__ u_out, T* __restrict__ part, int ny, int nx,
                  T omega, T one_minus_omega) {
  const int j = blockIdx.x * LT + threadIdx.x;
  T acc = T(0);
  if (j < nx) {
    auto U = [&](int y, int x) {
      return iterate_at<GUESS, CORRECT>(u, e, y, x, ny, nx);
    };
    T dp = T(0);
    for (int i = 0; i < ny; ++i) {
      // Off-line terms in the JAX package's order: w, e, sw, se, nw, ne.
      const T off =
          coef_at(c, mg::CW, i, j) * U(i, j - 1) +
          coef_at(c, mg::CE, i, j) * U(i, j + 1) +
          coef_at(c, mg::CSW, i, j) * U(i - 1, j - 1) +
          coef_at(c, mg::CSE, i, j) * U(i - 1, j + 1) +
          coef_at(c, mg::CNW, i, j) * U(i + 1, j - 1) +
          coef_at(c, mg::CNE, i, j) * U(i + 1, j + 1);
      const size_t g = (size_t)i * nx + j;
      const size_t fi = (size_t)i * (f.sx ? nx : 1) + (f.sx ? j : 0);
      dp = (b[g] - off - coef_at(c, mg::CS, i, j) * dp) * f.m[fi];
      u_out[g] = dp;
    }
    T x = T(0);
    for (int i = ny - 1; i >= 0; --i) {
      const size_t g = (size_t)i * nx + j;
      const size_t fi = (size_t)i * (f.sx ? nx : 1) + (f.sx ? j : 0);
      x = u_out[g] - f.cp[fi] * x;
      const T un = one_minus_omega * U(i, j) + omega * x;
      u_out[g] = un;
      if (DOT) acc += b[g] * un;
    }
  }
  if (DOT) {
    const T s = mg::block_sum<LT, T>(acc, nullptr);
    if (threadIdx.x == 0) part[blockIdx.x] = s;
  }
}

// 9-point (A u) at the domain point (y, x), zero outside; the JAX
// package's term order.
template <class T>
__device__ __forceinline__ T apply9(const Coeffs9<T>& c, const T* u, int y,
                                    int x, int ny, int nx) {
  auto U = [&](int yy, int xx) {
    return (yy >= 0 && yy < ny && xx >= 0 && xx < nx)
               ? u[(size_t)yy * nx + xx] : T(0);
  };
  return coef_at(c, mg::CC, y, x) * U(y, x) +
         coef_at(c, mg::CS, y, x) * U(y - 1, x) +
         coef_at(c, mg::CN, y, x) * U(y + 1, x) +
         coef_at(c, mg::CW, y, x) * U(y, x - 1) +
         coef_at(c, mg::CE, y, x) * U(y, x + 1) +
         coef_at(c, mg::CSW, y, x) * U(y - 1, x - 1) +
         coef_at(c, mg::CSE, y, x) * U(y - 1, x + 1) +
         coef_at(c, mg::CNW, y, x) * U(y + 1, x - 1) +
         coef_at(c, mg::CNE, y, x) * U(y + 1, x + 1);
}

// After the sweeps: r = b - A u (RC = false, one thread per fine point) or
// rc = R (b - A u) (RC = true, one thread per coarse point; full
// weighting, y pass first, as ops/transfer.restrict_fw).
template <class T, bool RC>
__global__ void __launch_bounds__(FT)
line_residual_kernel(Coeffs9<T> c, const T* __restrict__ b,
                     const T* __restrict__ u, T* __restrict__ out, int ny,
                     int nx) {
  const int oy = RC ? (ny - 1) / 2 : ny, ox = RC ? (nx - 1) / 2 : nx;
  const size_t t = (size_t)blockIdx.x * FT + threadIdx.x;
  if (t >= (size_t)oy * ox) return;
  const int I = (int)(t / ox), J = (int)(t - (t / ox) * ox);
  if constexpr (!RC) {
    out[t] = b[t] - apply9(c, u, I, J, ny, nx);
  } else {
    T ycol[3];
    for (int d = 0; d < 3; ++d) {
      const int x = 2 * J + d;
      T r[3];
      for (int q = 0; q < 3; ++q) {
        const int y = 2 * I + q;
        r[q] = b[(size_t)y * nx + x] - apply9(c, u, y, x, ny, nx);
      }
      ycol[d] = r[0] + T(2) * r[1] + r[2];
    }
    out[t] = T(0.0625) * (ycol[0] + T(2) * ycol[1] + ycol[2]);
  }
}

template <class T>
using SweepFn = void (*)(Coeffs9<T>, LineFactor<T>, const T*, const T*,
                         const T*, T*, T*, int, int, T, T);

template <class T, bool GUESS, bool CORRECT>
SweepFn<T> pick_dot(bool dot) {
  return dot ? line_sweep_kernel<T, GUESS, CORRECT, true>
             : line_sweep_kernel<T, GUESS, CORRECT, false>;
}

template <class T>
int line_sweep(const unsigned long long* cptrs, const int* cstrides,
               const T* m, const T* cp, int fsx, const T* b, const T* u,
               const T* e, T* u_out, T* part, int ny, int nx, T omega,
               T one_minus_omega, void* stream) {
  const Coeffs9<T> c = mg::coeffs9<T>(cptrs, cstrides);
  if (u == nullptr && e != nullptr) return (int)cudaErrorInvalidValue;
  const bool dot = part != nullptr;
  SweepFn<T> kern = u == nullptr ? pick_dot<T, false, false>(dot)
                    : e == nullptr ? pick_dot<T, true, false>(dot)
                                   : pick_dot<T, true, true>(dot);
  kern<<<(nx + LT - 1) / LT, LT, 0, (cudaStream_t)stream>>>(
      c, LineFactor<T>{m, cp, fsx}, b, u, e, u_out, part, ny, nx, omega,
      one_minus_omega);
  return (int)cudaGetLastError();
}

template <class T>
int line_residual(const unsigned long long* cptrs, const int* cstrides,
                  const T* b, const T* u, T* out, int ny, int nx, int rc,
                  void* stream) {
  const Coeffs9<T> c = mg::coeffs9<T>(cptrs, cstrides);
  const size_t n = rc ? (size_t)((ny - 1) / 2) * ((nx - 1) / 2)
                      : (size_t)ny * nx;
  const unsigned blocks = (unsigned)((n + FT - 1) / FT);
  if (rc)
    line_residual_kernel<T, true><<<blocks, FT, 0, (cudaStream_t)stream>>>(
        c, b, u, out, ny, nx);
  else
    line_residual_kernel<T, false><<<blocks, FT, 0, (cudaStream_t)stream>>>(
        c, b, u, out, ny, nx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of per-block partials the dot-emitting sweep writes.
int mg_line_blocks(int nx) { return (nx + LT - 1) / LT; }

// One y-line sweep.  cptrs/cstrides: the 9-point coefficients as in
// mg_common.cuh's coeffs9(); m, cp: the Thomas factors, columns (fsx = 0) or
// fields (fsx = 1); u null: the zero guess; e non-null: correct u + P e
// first; part non-null: the <b, u_out> partials.
int mg_line_sweep(const unsigned long long* cptrs, const int* cstrides,
                  const float* m, const float* cp, int fsx, const float* b,
                  const float* u, const float* e, float* u_out, float* part,
                  int ny, int nx, float omega, float one_minus_omega,
                  void* stream) {
  return line_sweep<float>(cptrs, cstrides, m, cp, fsx, b, u, e, u_out, part,
                           ny, nx, omega, one_minus_omega, stream);
}

int mg_line_sweep_f64(const unsigned long long* cptrs, const int* cstrides,
                      const double* m, const double* cp, int fsx,
                      const double* b, const double* u, const double* e,
                      double* u_out, double* part, int ny, int nx,
                      double omega, double one_minus_omega, void* stream) {
  return line_sweep<double>(cptrs, cstrides, m, cp, fsx, b, u, e, u_out,
                            part, ny, nx, omega, one_minus_omega, stream);
}

// The visit's last pass: r = b - A u (rc == 0) or its restriction.
int mg_line_residual(const unsigned long long* cptrs, const int* cstrides,
                     const float* b, const float* u, float* out, int ny,
                     int nx, int rc, void* stream) {
  return line_residual<float>(cptrs, cstrides, b, u, out, ny, nx, rc, stream);
}

int mg_line_residual_f64(const unsigned long long* cptrs, const int* cstrides,
                         const double* b, const double* u, double* out,
                         int ny, int nx, int rc, void* stream) {
  return line_residual<double>(cptrs, cstrides, b, u, out, ny, nx, rc,
                               stream);
}

}  // extern "C"
